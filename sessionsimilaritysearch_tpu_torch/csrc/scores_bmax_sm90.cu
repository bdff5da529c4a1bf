// Fused score matmul + 128-row bucket max for bf16 operands, built for
// Hopper: TMA-fed wgmma with a warp-specialised, persistent pipeline
// (sm_90a). K1's variant for bf16 rows that TMA can describe.
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:144
// (_scores_bmax_kernel, launched by scores_with_bucket_max :177, :205) for
// bf16 queries [q, d] and a bf16 corpus chunk [n, d] with d % 8 == 0 and
// 16-byte-aligned base pointers (TMA's stride and address rule). Its
// contract is scores_bmax.cu's, which keeps f32 operands and bf16 rows TMA
// cannot describe (ops/mips.py k1_variant chooses):
//   scores[i, r] = <queries[i], corpus[r]>, accumulated in f32, set to -inf
//                  for r >= valid_count, then plus penalty[r]; stored as f32
//                  or bf16;
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken before rounding.
// Ragged q, n and d are masked (TMA zero-fills rows and depth past the
// edge; the epilogue skips rows >= q and columns >= n).
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 the call is 3.4
// TFLOP against 3.4 GB of corpus and 2.1 GB of bf16 scores: the tensor
// cores (3.47 ms at 989 TFLOP/s). At a few queries the corpus read bounds
// it (1.0 ms).
//
// Design (hopper-kernels guide section 1):
// - Output tile 128 queries x 256 corpus rows (two buckets). Queries are
//   the wgmma M side, corpus rows the N side.
// - One producer warp (its warpgroup gives up registers with setmaxnreg)
//   issues TMA loads of 64-deep K slices, 128-byte swizzled, into a ring:
//   a slot is 16 KB of queries + 32 KB of corpus rows; 4 slots (192 KB)
//   for bf16 scores, 3 for f32 scores, whose staging tile is twice as
//   large. Full barriers count the TMA bytes; empty barriers count the 8
//   consumer warps.
// - Two consumer warpgroups, 64 query rows each, run wgmma m64n256k16 with
//   the f32 accumulator (128 registers a thread) in registers.
// - Persistent: one block per SM walks the tiles, the query tile fastest,
//   so the blocks that share a corpus tile run together and it comes from
//   HBM once. The producer runs ahead into the next tile's K slices while
//   the consumers run the epilogue.
// - Epilogue (sm90_common.cuh bucket_epilogue): a query row's 128 columns
//   of one bucket lie in one quad of lanes, so the bucket max is a register
//   max and two shuffles; the scores go out through shared memory in
//   16-byte streaming stores. A warpgroup whose 64 rows all lie past q
//   skips its products and its epilogue.
// The tensor map needs the chunk's base pointer, so it is encoded on the
// host per call (cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point: no -lcuda) and passed as a __grid_constant__.

#include <cuda.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                       // queries per tile
constexpr int BN = 256;                       // corpus rows per tile (two buckets)
constexpr int BK = 64;                        // depth per ring slot: 128 bytes of bf16
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BN * BK * 2;          // 32 KB
constexpr int SLOT_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 3 * WG;               // two consumer warpgroups, one producer
constexpr int MAX_SMEM = 232448;

template <typename S> __host__ __device__ constexpr int stages() { return sizeof(S) == 2 ? 4 : 3; }
template <typename S> __host__ __device__ constexpr int smem_bytes() {
  return stages<S>() * SLOT_BYTES + 2 * staging_bytes<S>() + 2 * stages<S>() * 8;
}
static_assert(smem_bytes<__nv_bfloat16>() <= MAX_SMEM, "bf16 ring too large");
static_assert(smem_bytes<float>() <= MAX_SMEM, "f32 ring too large");

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

template <typename S>
__global__ void __launch_bounds__(THREADS, 1)
scores_bmax_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap cmap,
                        const float* __restrict__ penalty, S* __restrict__ scores,
                        float* __restrict__ bmax, int q, int n, int d, int valid_count) {
  constexpr int ST = stages<S>();
  extern __shared__ __align__(1024) unsigned char smem[];
  S* staging = reinterpret_cast<S*>(smem + ST * SLOT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SLOT_BYTES + 2 * staging_bytes<S>());
  uint64_t* empty = full + ST;

  const int q_tiles = (q + BM - 1) / BM;
  const int tiles = q_tiles * ((n + BN - 1) / BN);
  const int k_steps = (d + BK - 1) / BK;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();  // the 128-byte swizzle needs it
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    reg_dealloc<40>();
    if (threadIdx.x == 2 * WG) {
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (t % q_tiles) * BM, n0 = (t / q_tiles) * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[ring.slot], ring.phase ^ 1);
          unsigned char* slot = smem + ring.slot * SLOT_BYTES;
          mbar_arrive_expect_tx(&full[ring.slot], SLOT_BYTES);
          tma_load_2d(slot, &qmap, ks * BK, q0, &full[ring.slot]);
          tma_load_2d(slot + A_BYTES, &cmap, ks * BK, n0, &full[ring.slot]);
          ring.advance(ST);
        }
      }
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
        if (active) {
          const unsigned char* slot = smem + ring.slot * SLOT_BYTES;
          const uint64_t da = desc_sw128(slot + wg * 64 * 128);
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
            bucket_epilogue<S>(*reinterpret_cast<float(*)[64]>(acc + h * 64), stage, 1 + wg,
                               penalty, scores, bmax, wq0, q, n0 + h * BUCKET, n, valid_count,
                               n_buckets);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda. Errors come back as cudaError_t.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err != cudaSuccess) return err;
    if (res != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A [rows, d] bf16 row-major operand in boxes of BK x box_rows, 128-byte
// swizzled; reads past the edges fill zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int d,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns a cudaError_t (>= 0), or minus the CUresult of a failed encode.
template <typename S>
int launch(const void* queries, const void* corpus, const void* penalty, void* scores,
           void* bmax, int q, int n, int d, int valid_count, cudaStream_t stream) {
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap, cmap;
  CUresult res = encode(fn, &qmap, queries, q, d, BM);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  res = encode(fn, &cmap, corpus, n, d, BN);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  constexpr int bytes = smem_bytes<S>();
  err = cudaFuncSetAttribute(scores_bmax_sm90_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)((q + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = (int)(tiles < sms ? tiles : sms);
  scores_bmax_sm90_kernel<S><<<grid, THREADS, bytes, stream>>>(
      qmap, cmap, static_cast<const float*>(penalty), static_cast<S*>(scores),
      static_cast<float*>(bmax), q, n, d, valid_count);
  return static_cast<int>(cudaGetLastError());
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
  if (d <= 0 || d % 8 != 0 || reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(corpus) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(queries, corpus, penalty, scores, bmax, q, n, d,
                                          valid_count, s)
                  : launch<float>(queries, corpus, penalty, scores, bmax, q, n, d, valid_count,
                                  s);
}
