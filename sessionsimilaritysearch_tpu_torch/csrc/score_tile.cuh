// The score tile shared by the dense scan kernels (sm_90a): K1
// scores_bmax.cu, K2 scores_bmax_int8.cu, K3 bucket_max.cu and K6
// scores_matmul.cu.
//
// One thread block computes the [BM x BN] tile of <queries[q0 + r],
// corpus[n0 + c]> for 64 queries and 128 corpus rows (one contiguous
// bucket), over the whole depth d, staged through shared memory by a
// two-stage cp.async pipeline. Each kernel then runs its own epilogue on
// the tile. Ragged q, n and d are zero-filled at the edges, so no shape has
// a divisibility constraint.
//
// score_tile<T> is the float path: bf16 on the tensor cores through WMMA
// (mma.sync, f32 accumulation), f32 as an exact FMA loop (no TF32). The
// int8 path (K2) shares the staging and runs its own s8 mma.sync loop.
// K1 and K6 run it only on rows that neither Hopper producer takes: f32
// rows TMA cannot describe (d % 4 != 0 or bases not 16-byte aligned), and
// bf16 rows of odd d or at 2-byte-aligned bases. Other bf16 rows run
// scores_bmax_sm90.cu, fed by TMA (sm90_tma.cuh: d % 8 == 0, 16-byte-aligned
// bases) or by cp.async (sm90_cp_async.cuh: even d, 4-byte-aligned bases,
// such as the 250-bit sign codes); other f32 rows scores_bmax_f32_sm90.cu.
// K3 runs it on every row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per block: exactly one bucket
constexpr int THREADS = 256;  // 8 warps
constexpr int LDC = BN + 4;   // epilogue tile stride (4-byte elements)

// Depth per pipeline stage and shared-memory row stride (elements). Rows are
// 80 bytes for every type: a multiple of 16 (cp.async, WMMA ldm) that skews
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
template <> struct Cfg<int8_t> {
  static constexpr int BK = 64;
  static constexpr int LDS = 80;
};

template <typename T>
__host__ __device__ constexpr int stage_elems() { return (BM + BN) * Cfg<T>::LDS; }

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  // two operand stages, reused for the 4-byte epilogue tile after the K loop
  return 2 * stage_elems<T>() * (int)sizeof(T) > BM * LDC * 4
             ? 2 * stage_elems<T>() * (int)sizeof(T)
             : BM * LDC * 4;
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

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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

// True when every row of both operands can move as 16-byte chunks.
template <typename T>
inline bool rows_vectorizable(const void* queries, const void* corpus, int d) {
  constexpr int VEC = 16 / sizeof(T);
  return d % VEC == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
}

// The f32 score tile of the block (float or bf16 operands) into `tile`
// (shared memory, [BM][LDC] floats, overlaying the operand stages). Ends
// with a __syncthreads(): the tile is ready for the epilogue.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ queries,
                                           const T* __restrict__ corpus, int q0, int q,
                                           int n0, int n, int d, bool vec_ok,
                                           unsigned char* smem_raw) {
  constexpr int BK = Cfg<T>::BK, LDS = Cfg<T>::LDS;
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* tile = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5;
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
}

// An f32 score in the score dtype (f32 or bf16).
template <typename S> __device__ __forceinline__ S to_score(float v);
template <> __device__ __forceinline__ float to_score<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_score<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Warp-wide max of one value per lane.
__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

}  // namespace
