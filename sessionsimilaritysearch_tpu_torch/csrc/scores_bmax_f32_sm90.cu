// Fused score matmul + 128-row bucket max for f32 operands, built for
// Hopper: the error-compensated 3xTF32 split on the tensor cores, fed by
// the TMA ring of sm90_tma.cuh (sm_90a). K1's and K6's variant for f32 rows
// that TMA can describe: the default f32 DenseIndex and engine.
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:144
// (_scores_bmax_kernel, launched by scores_with_bucket_max :177, :205) for
// f32 queries [q, d] and an f32 corpus chunk [n, d] with d % 4 == 0 and
// 16-byte-aligned base pointers (TMA's stride and address rule). Its
// contract is scores_bmax.cu's, which keeps the f32 rows TMA cannot describe
// (ops/mips.py k1_variant chooses):
//   scores[i, r] = <queries[i], corpus[r]> in f32, set to -inf for
//                  r >= valid_count, then plus penalty[r]; stored as f32 or
//                  bf16;
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken before rounding.
// With the store-only epilogue (BMAX = false) it replaces
// pallas_mips.py:247 (_scores_kernel, launched by scores_matmul :259, :273)
// for the same operands: scores = queries @ corpus.T in f32, no mask
// (sss_scores_matmul_f32_sm90).
//
// The split. An f32 product cannot run on the tensor cores as it is: tf32
// keeps 10 of f32's 23 mantissa bits. Each operand x is split into
//   big   = x with its low 13 bits cleared (round toward zero): what the
//           tensor core reads of a raw f32 word, so the tiles TMA lands are
//           the big parts as they are;
//   small = tf32(x - big), x - big exact in f32, rounded half away from
//           zero (sm90_common.cuh tf32_small);
// and <a, b> = sum of a_small * b_big + a_big * b_small + a_big * b_big,
// small * small dropped (CUTLASS's 3xTF32, the Hopper counterpart of the
// TPU's multi-pass bf16 f32 dot). Per product the dropped terms are below
// 2^-19 |a| |b|: |small| < 2^-10 |x|, |x - big - small| <= 2^-21 |x|. The
// tensor core's own f32 accumulation does not round to nearest, so one
// chain of wgmma spans one 32-deep K slice only (12 wgmma: the eight small
// terms first, then the four big ones, as CUTLASS orders them), and each
// slice's chain is added into a register sum with round-to-nearest f32 adds
// (kernel_ablation.py copy no_promote: one chain over the whole depth).
// The accuracy gate (chip_smoke.py phase 4c): the largest |score - f64| at
// most 2x cuBLAS SGEMM's on the same inputs.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 the function is
// 3.44 TFLOP of f32 products, 6.9 ms at 495 TFLOP/s (tf32, the card's
// fastest rate for f32 operands), against 6.7 GB of f32 corpus and 4.3 GB of
// f32 scores (3.3 ms at 3.35 TB/s): the operations. This design does three
// tf32 passes of it, so it can take no less than 20.8 ms.
//
// Design:
// - sm90_tma.cuh's ring, producer and persistent grid with an f32 tensor
//   map: 128 x 128 output tiles (one bucket), 32-deep K slices (at d = 1600
//   exactly 50; TMA zero-fills a tail, and zero splits into zeros). A tf32
//   K step of 8 is 32 bytes: +2 on the descriptor, as for bf16 k16.
// - The corpus slice's small parts are made by the producer warpgroup's
//   three idle warps, element for element into the same swizzled layout
//   beside the slice (wgmma reads B only from shared memory); each thread
//   fences its stores for the async proxy and arrives on the slot's split
//   barrier, which the consumers wait on beside the full one.
// - Two consumer warpgroups, 64 query rows each. A warpgroup loads its A
//   values into registers in the wgmma A-fragment layout (16 a thread per
//   slice, read from the swizzled tile without bank conflicts), splits them
//   there, and issues per K step of 8 A_small x B_big, A_big x B_small and
//   A_big x B_big, all three with A from registers (m64n128k8 into float
//   acc[64]): wgmma then reads only B from shared memory, whose bandwidth
//   the three passes, TMA and the split share (kernel_ablation.py copy
//   a_in_smem reads A_big from shared memory). float sum[64] holds the
//   slices' sum, the float[64] bucket_epilogue takes (mask, penalty, bucket
//   max from registers, 16-byte streaming stores through the staging tile).
// Shared memory (bytes): a slot is A 16,384 + B 16,384 + B_small 16,384 =
// 49,152; f32 scores: 3 slots 147,456 + staging 2 x 34,816 + barriers 72 =
// 217,160; bf16 scores: 4 slots 196,608 + 2 x 17,408 + 96 = 231,520; of
// 232,448.

#include "sm90_tma.cuh"

namespace {

using namespace sm90;

constexpr int TN = BUCKET;                 // corpus rows per tile
constexpr int TB = TN * K_BYTES;           // a corpus slice: 16 KB
constexpr int SLOT = A_BYTES + 2 * TB;     // queries, corpus, corpus small parts
constexpr int BK = K_BYTES / 4;            // f32 depth per slice
constexpr int SPLITTERS = WG - 32;         // the producer warpgroup's warps 1..3

template <typename S> __host__ __device__ constexpr int f32_smem_bytes() {
  return stages<S>() * SLOT + 2 * staging_bytes<S>() + 3 * stages<S>() * 8;
}
static_assert(f32_smem_bytes<__nv_bfloat16>() <= MAX_SMEM, "bf16-score ring too large");
static_assert(f32_smem_bytes<float>() <= MAX_SMEM, "f32-score ring too large");

// The splitter warps: each slot's corpus slice, once TMA has landed it,
// into its small parts beside it. st: this thread's index, 0 .. SPLITTERS-1.
template <int ST>
__device__ __forceinline__ void split_corpus(unsigned char* smem, uint64_t* full, uint64_t* split,
                                             int st, int tiles, int k_steps) {
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&full[ring.slot], ring.phase);
      unsigned char* slot = smem + ring.slot * SLOT;
      const float4* b = reinterpret_cast<const float4*>(slot + A_BYTES);
      uint4* small = reinterpret_cast<uint4*>(slot + A_BYTES + TB);
      for (int i = st; i < TB / 16; i += SPLITTERS) {
        const float4 v = b[i];
        small[i] = make_uint4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z), tf32_small(v.w));
      }
      fence_proxy_async();
      mbar_arrive(&split[ring.slot]);
      ring.advance(ST);
    }
  }
}

// This thread's A fragments of one slice (a: its first row in the slot's
// query tile, g = lane / 4, tq = lane % 4), loaded and split: ab the big
// parts, as the small ones, one [4] per K step of 8 in the register layout
// wgmma_m64n128k8_tf32_rs takes. The row's 16-byte chunk c sits at c ^ g.
__device__ __forceinline__ void split_a(const unsigned char* a, int g, int tq,
                                        uint32_t (&ab)[BK / 8][4], uint32_t (&as)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int c0 = (((2 * kk) ^ g) << 4) + tq * 4;
    const int c1 = (((2 * kk + 1) ^ g) << 4) + tq * 4;
    const float x[4] = {*reinterpret_cast<const float*>(a + c0),
                        *reinterpret_cast<const float*>(a + 8 * K_BYTES + c0),
                        *reinterpret_cast<const float*>(a + c1),
                        *reinterpret_cast<const float*>(a + 8 * K_BYTES + c1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ab[kk][e] = __float_as_uint(x[e]) & 0xffffe000u;
      as[kk][e] = tf32_small(x[e]);
    }
  }
}

// One slice's products into acc, overwriting it: A_small x B_big,
// A_big x B_small, then A_big x B_big, per K step of 8, A from registers;
// db and ds describe the slice's corpus tile and its small parts.
__device__ __forceinline__ void products(float (&acc)[64], const uint32_t (&ab)[BK / 8][4],
                                         const uint32_t (&as)[BK / 8][4], uint64_t db,
                                         uint64_t ds) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_m64n128k8_tf32_rs(acc, as[kk], db + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32_rs(acc, ab[kk], ds + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32_rs(acc, ab[kk], db + 2 * kk, 1);
}

// Keeps A's parts in their registers up to this point (the wgmma read them
// asynchronously until its wait).
__device__ __forceinline__ void fence_a(uint32_t (&ab)[BK / 8][4], uint32_t (&as)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    fence_regs(ab[kk]);
    fence_regs(as[kk]);
  }
}

template <typename S, bool BMAX>
__global__ void __launch_bounds__(THREADS, 1)
scores_bmax_f32_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap cmap,
                            const float* __restrict__ penalty, S* __restrict__ scores,
                            float* __restrict__ bmax, int q, int n, int d, int valid_count) {
  constexpr int ST = stages<S>();
  extern __shared__ __align__(1024) unsigned char smem[];
  S* staging = reinterpret_cast<S*>(smem + ST * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SLOT + 2 * staging_bytes<S>());
  uint64_t* empty = full + ST;
  uint64_t* split = empty + ST;

  const int q_tiles = (q + BM - 1) / BM;
  const int tiles = q_tiles * ((n + TN - 1) / TN);
  const int k_steps = (d + BK - 1) / BK;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0)
    for (int s = 0; s < ST; ++s) mbar_init(&split[s], SPLITTERS);
  ring_init<ST>(smem, full, empty);  // its fence and block barrier cover split

  if (wg == 2) {
    // ---- producer warpgroup: one TMA thread, three splitter warps ----
    reg_dealloc<40>();
    const int pt = threadIdx.x - 2 * WG;
    if (pt == 0)
      produce<ST, 4, TN, SLOT>(smem, full, empty, &qmap, &cmap, q_tiles, tiles, k_steps);
    else if (pt >= 32)
      split_corpus<ST>(smem, full, split, pt - 32, tiles, k_steps);
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. wg * 64 + 63 ----
    reg_alloc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, tq = lane % 4;
    // this thread's A-fragment rows warp * 16 + g and + 8 in the slot's
    // query tile (row % 8 = g)
    const int a_row = (wg * 64 + warp * 16 + g) * K_BYTES;
    S* stage = staging + wg * 64 * STAGE_LD;
    Ring ring;
    float acc[64], sum[64];
    uint32_t ab[BK / 8][4], as[BK / 8][4];  // A's big and small parts
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t / q_tiles) * TN;
      const int wq0 = (t % q_tiles) * BM + wg * 64;
      const bool active = wq0 < q;
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[ring.slot], ring.phase);
        mbar_wait(&split[ring.slot], ring.phase);
        if (active) {
          const unsigned char* slot = smem + ring.slot * SLOT;
          split_a(slot + a_row, g, tq, ab, as);
          fence_a(ab, as);
          fence_regs(acc);
          wgmma_fence();
          products(acc, ab, as, desc_sw128(slot + A_BYTES), desc_sw128(slot + A_BYTES + TB));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_a(ab, as);
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ring.slot]);
        ring.advance(ST);
      }
      if (active)
        bucket_epilogue<S, BMAX>(sum, stage, 1 + wg, penalty, scores, bmax, wq0, q, n0, n,
                                 valid_count, n_buckets);
    }
  }
}

// Returns a cudaError_t (>= 0), or minus the CUresult of a failed encode.
template <typename S, bool BMAX>
int launch(const void* queries, const void* corpus, const void* penalty, void* scores,
           void* bmax, int q, int n, int d, int valid_count, cudaStream_t stream) {
  CUtensorMap qmap, cmap;
  const int res = encode_operands<4, TN>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, queries, corpus, q, n,
                                         d, &qmap, &cmap);
  if (res != 0) return res;
  constexpr int bytes = f32_smem_bytes<S>();
  int grid = 0;
  const cudaError_t err =
      persistent_grid<TN>(scores_bmax_f32_sm90_kernel<S, BMAX>, bytes, q, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  scores_bmax_f32_sm90_kernel<S, BMAX><<<grid, THREADS, bytes, stream>>>(
      qmap, cmap, static_cast<const float*>(penalty), static_cast<S*>(scores),
      static_cast<float*>(bmax), q, n, d, valid_count);
  return static_cast<int>(cudaGetLastError());
}

// what TMA can take: f32 rows of d % 4 == 0 at 16-byte-aligned bases
bool tma_rows(const void* queries, const void* corpus, int d) {
  return d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; queries [q, d] and corpus [n, d] f32 with d % 4 == 0 and
// 16-byte-aligned bases; penalty may be null; out_bf16 selects the score
// dtype (1 = bf16, 0 = f32). Launches on `stream` and does not
// synchronize. Returns 0 on success, a cudaError_t, or minus the CUresult
// of a failed cuTensorMapEncodeTiled.
extern "C" int sss_scores_bmax_f32_sm90(const void* queries, const void* corpus,
                                        const void* penalty, void* scores, void* bmax, int q,
                                        int n, int d, int valid_count, int out_bf16,
                                        void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!tma_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16, true>(queries, corpus, penalty, scores, bmax, q, n, d,
                                                valid_count, s)
                  : launch<float, true>(queries, corpus, penalty, scores, bmax, q, n, d,
                                        valid_count, s);
}

// K6: scores [q, n] f32 = queries [q, d] @ corpus [n, d].T for the same f32
// operands. Same return codes.
extern "C" int sss_scores_matmul_f32_sm90(const void* queries, const void* corpus, void* scores,
                                          int q, int n, int d, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (!tma_rows(queries, corpus, d)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false>(queries, corpus, nullptr, scores, nullptr, q, n, d, n,
                              static_cast<cudaStream_t>(stream));
}
