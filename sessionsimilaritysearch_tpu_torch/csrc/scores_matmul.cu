// Plain tiled score matmul (sm_90a): scores = queries @ corpus.T in f32.
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:247
// (_scores_kernel, launched by scores_matmul :259), the hand-written GEMM
// that the kernel bench holds against the library's matmul. For queries
// [q, d] and a corpus [n, d] of the same dtype (f32 or bf16) it writes
//   scores[i, r] = <queries[i], corpus[r]>, accumulated and stored in f32.
// Ragged q, n and d are masked: unlike the TPU kernel it has no
// q % block_q or n % block_c constraint.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 in bf16 the call is
// 3.44 TFLOP (3.47 ms at 989 TFLOP/s) against 7.65 GB moved (3.36 GB of
// corpus read, 4.3 GB of f32 scores written: 2.28 ms at 3.35 TB/s), so it is
// compute-bound. The design is K1's tile loop (score_tile.cuh) with a plain
// store epilogue: 64 x 128 tiles, WMMA mma.sync for bf16 and an exact FMA
// loop for f32. K6's tile variant: rows that a Hopper producer takes run
// K1's Hopper kernels with a store-only epilogue (bf16: scores_bmax_sm90.cu
// sss_scores_matmul_sm90, or sss_scores_matmul_cp_sm90 for even d at
// 4-byte-aligned bases; f32: scores_bmax_f32_sm90.cu
// sss_scores_matmul_f32_sm90; ops/mips.py k6_variant).

#include "score_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
scores_matmul_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                     float* __restrict__ scores, int q, int n, int d, int q_tiles,
                     bool vec_ok) {
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<T>()];
  const float* tile = reinterpret_cast<const float*>(smem_raw);
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int n0 = (blockIdx.x / q_tiles) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  score_tile(queries, corpus, q0, q, n0, n, d, vec_ok, smem_raw);

  // epilogue: each warp stores whole query rows of the tile
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= q) break;
    float* srow = scores + (size_t)qi * n;
#pragma unroll
    for (int c = lane; c < BN; c += 32)
      if (n0 + c < n) srow[n0 + c] = tile[r * LDC + c];
  }
}

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, void* scores, int q, int n,
                   int d, cudaStream_t stream) {
  const bool vec_ok = rows_vectorizable<T>(queries, corpus, d);
  const int q_tiles = (q + BM - 1) / BM;
  const long long blocks = (long long)q_tiles * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  scores_matmul_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<float*>(scores), q, n, d, q_tiles, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; in_bf16 selects the operand dtype (0 = f32, 1 = bf16). Launches
// on `stream` and returns the launch's cudaError_t; it does not synchronize.
extern "C" int sss_scores_matmul(const void* queries, const void* corpus, void* scores,
                                 int q, int n, int d, int in_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;  // nothing to compute
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = in_bf16
                              ? launch<__nv_bfloat16>(queries, corpus, scores, q, n, d, s)
                              : launch<float>(queries, corpus, scores, q, n, d, s);
  return static_cast<int>(err);
}
