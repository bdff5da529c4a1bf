// Fused score matmul + 128-row bucket max for exact top-k search (sm_90a).
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:144
// (_scores_bmax_kernel, launched by scores_with_bucket_max :177). For
// queries [q, d] and a corpus chunk [n, d] of the same dtype (f32 or bf16) it
// writes
//   scores[i, r] = <queries[i], corpus[r]>, accumulated in f32, set to -inf
//                  for r >= valid_count, then plus penalty[r] (0 live, -inf
//                  filtered) when a penalty is given; stored in the score
//                  dtype (f32 or bf16);
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken BEFORE rounding to the score dtype.
// The bucket maxes let the selection (ops/mips.py) pick the top-k buckets
// and re-rank only their k * 128 scores, so no pass re-reads the whole score
// matrix.
//
// Layout: contiguous 128-row buckets, the layout the JAX DenseIndex runs
// (ops/topk.py:130 _chunk_topk_bucketed). The TPU kernel used strided
// buckets only because Mosaic cannot store blocks narrower than 128 lanes.
// Here one thread block owns one whole bucket for 64 queries, so the fold is
// a row max over the block's own tile: no cross-block pass, no atomics.
// Ragged q and n are masked in the kernel, with no divisibility constraint.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 in bf16 the call is
// 3.4 TFLOP against ~3.4 GB of corpus reads and ~2.1 GB of bf16 score writes,
// so it is compute-bound; at a few queries it is bound by the corpus read.
// This first version is simple on purpose: bf16 runs on the tensor cores
// through WMMA (mma.sync) fed by a two-stage cp.async pipeline; f32 runs an
// exact f32 FMA loop (no TF32) on the same pipeline. Queries are the fastest
// grid dimension, so the blocks that share a corpus tile run together and the
// tile comes from HBM once and from L2 after. wgmma, TMA and persistent
// blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per block: exactly one bucket
constexpr int THREADS = 256;  // 8 warps
constexpr int LDC = BN + 4;   // f32 epilogue tile stride (floats)

// Depth per pipeline stage and shared-memory row stride (elements). Rows are
// 80 bytes for both types: a multiple of 16 (cp.async, WMMA ldm) that skews
// banks between neighbouring rows.
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int LDS = 20;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32;
  static constexpr int LDS = 40;
};

template <typename T>
__host__ __device__ constexpr int stage_elems() { return (BM + BN) * Cfg<T>::LDS; }

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  // two operand stages, reused for the f32 epilogue tile after the K loop
  return 2 * stage_elems<T>() * (int)sizeof(T) > BM * LDC * (int)sizeof(float)
             ? 2 * stage_elems<T>() * (int)sizeof(T)
             : BM * LDC * (int)sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename S> __device__ __forceinline__ S to_score(float v);
template <> __device__ __forceinline__ float to_score<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_score<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// One 16-byte chunk of an operand row into shared memory: cp.async when the
// chunk lies inside the row and is aligned, element loads with zero fill at
// the ragged edges (rows past the end, depth past d).
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* base, int row, int rows,
                                           int k, int d, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  if (row < rows && vec_ok && k + VEC <= d) {
    cp_async16(dst, base + (size_t)row * d + k);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      dst[e] = (row < rows && k + e < d) ? base[(size_t)row * d + k + e] : zero<T>();
  }
}

// Start the loads of one K stage: the block's 64 query rows and 128 corpus
// rows, depth [k0, k0 + BK).
template <typename T>
__device__ __forceinline__ void load_stage(T* stage, const T* queries, const T* corpus,
                                           int q0, int q, int n0, int n, int d, int k0,
                                           bool vec_ok) {
  constexpr int BK = Cfg<T>::BK, LDS = Cfg<T>::LDS;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = BK / VEC;  // chunks per row
  T* a = stage;
  T* b = stage + BM * LDS;
  for (int c = threadIdx.x; c < (BM + BN) * CPR; c += THREADS) {
    const int r = c / CPR, kc = (c % CPR) * VEC;
    if (r < BM)
      load_chunk(a + r * LDS + kc, queries, q0 + r, q, k0 + kc, d, vec_ok);
    else
      load_chunk(b + (r - BM) * LDS + kc, corpus, n0 + r - BM, n, k0 + kc, d, vec_ok);
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
scores_bmax_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                   const float* __restrict__ penalty, S* __restrict__ scores,
                   float* __restrict__ bmax, int q, int n, int d, int valid_count,
                   int q_tiles, int n_buckets, bool vec_ok) {
  constexpr int BK = Cfg<T>::BK, LDS = Cfg<T>::LDS;
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<T>()];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* tile = reinterpret_cast<float*>(smem_raw);  // epilogue, after the K loop

  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bucket = blockIdx.x / q_tiles;
  const int n0 = bucket * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_tiles = (d + BK - 1) / BK;

  load_stage(stages, queries, corpus, q0, q, n0, n, d, 0, vec_ok);
  cp_async_commit();

  if constexpr (sizeof(T) == 2) {
    // tensor cores: 8 warps as 2 x 4, each a 32 x 32 patch of 2 x 2 fragments
    using namespace nvcuda;
    const int wm = warp / 4, wn = warp % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles)
        load_stage(stages + ((kt + 1) & 1) * stage_elems<T>(), queries, corpus, q0, q,
                   n0, n, d, (kt + 1) * BK, vec_ok);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* a = stages + (kt & 1) * stage_elems<T>();
      const T* b = a + BM * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], b + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();  // the next iteration overwrites this stage
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(tile + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
    // exact f32: 16 x 16 threads, each 4 query rows x 8 corpus rows
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles)
        load_stage(stages + ((kt + 1) & 1) * stage_elems<T>(), queries, corpus, q0, q,
                   n0, n, d, (kt + 1) * BK, vec_ok);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* a = stages + (kt & 1) * stage_elems<T>();
      const T* b = a + BM * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LDS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = b[(tx + 16 * j) * LDS + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: each warp takes whole query rows of the tile; mask, add the
  // penalty, store the scores and fold the f32 values into the bucket max
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= q) break;
    S* srow = scores + (size_t)qi * n;
    float m = -INFINITY;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int col = n0 + c;
      if (col < n) {
        float v = col < valid_count ? tile[r * LDC + c] : -INFINITY;
        if (penalty != nullptr) v += penalty[col];
        srow[col] = to_score<S>(v);
        m = fmaxf(m, v);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) bmax[(size_t)qi * n_buckets + bucket] = m;
  }
}

template <typename T, typename S>
cudaError_t launch(const void* queries, const void* corpus, const void* penalty,
                   void* scores, void* bmax, int q, int n, int d, int valid_count,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = d % VEC == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  const int q_tiles = (q + BM - 1) / BM;
  const int n_buckets = (n + BN - 1) / BN;
  const long long blocks = (long long)q_tiles * n_buckets;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  scores_bmax_kernel<T, S><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<const float*>(penalty), static_cast<S*>(scores),
      static_cast<float*>(bmax), q, n, d, valid_count, q_tiles, n_buckets, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty may be null. in_bf16 / out_bf16 select the operand and
// score dtypes (0 = f32, 1 = bf16). Launches on `stream` and returns the
// launch's cudaError_t (0 = success); it does not synchronize.
extern "C" int sss_scores_bmax(const void* queries, const void* corpus, const void* penalty,
                               void* scores, void* bmax, int q, int n, int d,
                               int valid_count, int in_bf16, int out_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;  // nothing to compute
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(queries, corpus, penalty, scores,
                                                           bmax, q, n, d, valid_count, s)
                   : launch<__nv_bfloat16, float>(queries, corpus, penalty, scores, bmax,
                                                  q, n, d, valid_count, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(queries, corpus, penalty, scores, bmax,
                                                  q, n, d, valid_count, s)
                   : launch<float, float>(queries, corpus, penalty, scores, bmax, q, n, d,
                                          valid_count, s);
  }
  return static_cast<int>(err);
}
