// Fused score matmul + 128-row bucket max for bf16 operands, built for
// Hopper: wgmma with a warp-specialised, persistent pipeline (sm_90a). K1's
// and K6's bf16 kernel, in two variants that differ only in the producer:
// TMA for rows that TMA can describe, cp.async for the others.
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:144
// (_scores_bmax_kernel, launched by scores_with_bucket_max :177, :205) for
// bf16 queries [q, d] and a bf16 corpus chunk [n, d]:
// - d % 8 == 0 and 16-byte-aligned base pointers (TMA's stride and address
//   rule): the TMA producer of sm90_tma.cuh (sss_scores_bmax_sm90);
// - other even d with 4-byte-aligned bases (the 250-bit sign and ITQ codes:
//   a 500-byte row stride): the cp.async producer of sm90_cp_async.cuh
//   (sss_scores_bmax_cp_sm90).
// scores_bmax.cu keeps f32 rows TMA cannot describe, odd-d bf16 rows and
// bf16 rows at 2-byte-aligned bases (ops/mips.py k1_variant chooses). The
// contract is scores_bmax.cu's:
//   scores[i, r] = <queries[i], corpus[r]>, accumulated in f32, set to -inf
//                  for r >= valid_count, then plus penalty[r]; stored as f32
//                  or bf16;
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken before rounding.
// Ragged q, n and d are masked (either producer zero-fills rows and depth
// past the edge; the epilogue skips rows >= q and columns >= n).
//
// The same kernel with the store-only epilogue (BMAX = false) replaces the
// TPU kernel pallas_mips.py:247 (_scores_kernel, launched by scores_matmul
// :259, :273) for the same bf16 operands: scores = queries @ corpus.T in
// f32, no mask, no penalty, no bucket max (sss_scores_matmul_sm90, and
// sss_scores_matmul_cp_sm90 on the cp.async producer). f32 operands that
// TMA can describe run scores_bmax_f32_sm90.cu, other rows scores_matmul.cu.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 the call is 3.4
// TFLOP against 3.4 GB of corpus and 2.1 GB of bf16 scores (4.3 GB of f32
// scores for K6): the tensor cores (3.47 ms at 989 TFLOP/s). At a few
// queries the corpus read bounds it (1.0 ms). At d=250 and 256 the 2 GiB of
// bf16 scores bound it (0.81 ms).
//
// Design:
// - The ring and the persistent grid are sm90_tma.cuh's: 128 x 256 output
//   tiles, 64-deep bf16 K slices; 4 slots for bf16 scores, 3 for f32
//   scores, whose staging tile is twice as large. Queries are the wgmma M
//   side, corpus rows the N side.
// - The producer warpgroup (setmaxnreg 40) is the kernel's template
//   parameter: TmaOperands, one thread starting TMA copies (full barriers count
//   bytes), or PtrOperands, all 128 threads starting 4-byte cp.async into
//   the same swizzled slots (full barriers count the 128 threads' noinc
//   arrivals; the consumers fence for the async proxy after the wait). The
//   consumers and the epilogue are otherwise one code for both.
// - Two consumer warpgroups, 64 query rows each, run wgmma m64n256k16 with
//   the f32 accumulator (128 registers a thread) in registers. The
//   producer runs ahead into the next tile's K slices while the consumers
//   run the epilogue.
// - Epilogue (sm90_common.cuh bucket_epilogue): a query row's 128 columns
//   of one bucket lie in one quad of lanes, so the bucket max is a register
//   max and two shuffles; the scores go out through shared memory in
//   16-byte streaming stores. A warpgroup whose 64 rows all lie past q
//   skips its products and its epilogue.
// The tensor maps need the chunk's base pointer, so they are encoded on the
// host per call and passed as a __grid_constant__.

#include <type_traits>

#include "sm90_cp_async.cuh"
#include "sm90_tma.cuh"

namespace {

using namespace sm90;

// the TMA producer's source: one tensor map per operand
struct TmaOperands {
  static constexpr bool TMA = true;
  CUtensorMap q, c;
};

template <typename S, bool BMAX, typename Ops>
__global__ void __launch_bounds__(THREADS, 1)
scores_bmax_sm90_kernel(const __grid_constant__ Ops ops, const float* __restrict__ penalty,
                        S* __restrict__ scores, float* __restrict__ bmax, int q, int n, int d,
                        int valid_count) {
  constexpr int ST = stages<S>();
  constexpr int BK = K_BYTES / 2;  // bf16 depth per ring slot
  extern __shared__ __align__(1024) unsigned char smem[];
  S* staging = reinterpret_cast<S*>(smem + ST * SLOT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SLOT_BYTES + 2 * staging_bytes<S>());
  uint64_t* empty = full + ST;

  const int q_tiles = (q + BM - 1) / BM;
  const int tiles = q_tiles * ((n + BN - 1) / BN);
  const int k_steps = (d + BK - 1) / BK;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;
  const int wg = threadIdx.x / WG;
  ring_init<ST>(smem, full, empty, Ops::TMA ? 1 : WG);

  if (wg == 2) {
    // ---- producer: one thread starting TMA copies, or the warpgroup's cp.async ----
    reg_dealloc<40>();
    if constexpr (Ops::TMA) {
      if (threadIdx.x == 2 * WG)
        produce<ST, 2>(smem, full, empty, &ops.q, &ops.c, q_tiles, tiles, k_steps);
    } else {
      produce_cp<ST>(smem, full, empty, ops.q, ops.c, q, n, d, q_tiles, tiles, k_steps);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. wg * 64 + 63 ----
    reg_alloc<232>();
    const int lane = threadIdx.x % 32;
    S* stage = staging + wg * 64 * STAGE_LD;
    Ring ring;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t / q_tiles) * BN;
      const int wq0 = (t % q_tiles) * BM + wg * 64;
      const bool active = wq0 < q;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[ring.slot], ring.phase);
        // cp.async wrote the slot through the generic proxy; wgmma reads
        // it through the async proxy
        if constexpr (!Ops::TMA) fence_proxy_async();
        if (active) {
          const unsigned char* slot = smem + ring.slot * SLOT_BYTES;
          const uint64_t da = desc_sw128(slot + wg * 64 * K_BYTES);
          const uint64_t db = desc_sw128(slot + A_BYTES);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n256k16_bf16(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ring.slot]);
        ring.advance(ST);
      }
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (n0 + h * BUCKET < n)
            bucket_epilogue<S, BMAX>(*reinterpret_cast<float(*)[64]>(acc + h * 64), stage,
                                     1 + wg, penalty, scores, bmax, wq0, q, n0 + h * BUCKET, n,
                                     valid_count, n_buckets);
        }
      }
    }
  }
}

// Returns a cudaError_t (>= 0), or minus the CUresult of a failed encode.
// The operands: queries and corpus as TMA tensor maps, or, with CP, as the
// cp.async producer's pointers.
template <typename S, bool BMAX, bool CP = false>
int launch(const void* queries, const void* corpus, const void* penalty, void* scores,
           void* bmax, int q, int n, int d, int valid_count, cudaStream_t stream) {
  using Ops = typename std::conditional<CP, PtrOperands, TmaOperands>::type;
  Ops ops;
  if constexpr (CP) {
    ops.q = static_cast<const __nv_bfloat16*>(queries);
    ops.c = static_cast<const __nv_bfloat16*>(corpus);
  } else {
    const int res = encode_operands<2>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, queries, corpus, q,
                                       n, d, &ops.q, &ops.c);
    if (res != 0) return res;
  }
  constexpr int bytes = smem_bytes<S>();
  int grid = 0;
  const cudaError_t err =
      persistent_grid(scores_bmax_sm90_kernel<S, BMAX, Ops>, bytes, q, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  scores_bmax_sm90_kernel<S, BMAX, Ops><<<grid, THREADS, bytes, stream>>>(
      ops, static_cast<const float*>(penalty), static_cast<S*>(scores),
      static_cast<float*>(bmax), q, n, d, valid_count);
  return static_cast<int>(cudaGetLastError());
}

// what TMA can take: bf16 rows of d % 8 == 0 at 16-byte-aligned bases
bool tma_rows(const void* queries, const void* corpus, int d) {
  return d > 0 && d % 8 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
}

// what the cp.async producer can take: bf16 rows of even d at 4-byte-aligned
// bases (every row's 4-byte words aligned), TMA's rows among them
bool cp_rows(const void* queries, const void* corpus, int d) {
  return d > 0 && d % 2 == 0 && reinterpret_cast<uintptr_t>(queries) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(corpus) % 4 == 0;
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; queries [q, d] and corpus [n, d] bf16 with d % 8 == 0 and
// 16-byte-aligned bases; penalty may be null; out_bf16 selects the score
// dtype (1 = bf16, 0 = f32). Launches on `stream` and does not
// synchronize. Returns 0 on success, a cudaError_t, or minus the CUresult
// of a failed cuTensorMapEncodeTiled.
extern "C" int sss_scores_bmax_sm90(const void* queries, const void* corpus,
                                    const void* penalty, void* scores, void* bmax, int q, int n,
                                    int d, int valid_count, int out_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!tma_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16, true>(queries, corpus, penalty, scores, bmax, q, n, d,
                                                valid_count, s)
                  : launch<float, true>(queries, corpus, penalty, scores, bmax, q, n, d,
                                        valid_count, s);
}

// K6: scores [q, n] f32 = queries [q, d] @ corpus [n, d].T for the same
// bf16 operands. Same return codes.
extern "C" int sss_scores_matmul_sm90(const void* queries, const void* corpus, void* scores,
                                      int q, int n, int d, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!tma_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false>(queries, corpus, nullptr, scores, nullptr, q, n, d, n,
                              static_cast<cudaStream_t>(stream));
}

// The same two entries on the cp.async producer (sm90_cp_async.cuh), for
// bf16 rows of even d at 4-byte-aligned bases, those TMA takes included (so
// the two producers can be timed on the same rows). Same arguments and
// return codes; no tensor map is encoded.
extern "C" int sss_scores_bmax_cp_sm90(const void* queries, const void* corpus,
                                       const void* penalty, void* scores, void* bmax, int q,
                                       int n, int d, int valid_count, int out_bf16,
                                       void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!cp_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16, true, true>(queries, corpus, penalty, scores, bmax,
                                                      q, n, d, valid_count, s)
                  : launch<float, true, true>(queries, corpus, penalty, scores, bmax, q, n, d,
                                              valid_count, s);
}

extern "C" int sss_scores_matmul_cp_sm90(const void* queries, const void* corpus,
                                         void* scores, int q, int n, int d, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!cp_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false, true>(queries, corpus, nullptr, scores, nullptr, q, n, d, n,
                                    static_cast<cudaStream_t>(stream));
}
