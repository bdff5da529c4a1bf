// Fused score matmul + 128-row bucket max, bucket maxes only (sm_90a).
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:56
// (_bucket_max_kernel, launched by scores_bucket_max :88). For queries
// [q, d] and a corpus [n, d] of the same dtype (f32 or bf16) it writes
//   bmax[i, b] = max over r in [128 b, 128 b + 127], r < n, of
//                <queries[i], corpus[r]> accumulated in f32, where rows
//                r >= valid_count score -inf.
// The score matrix never reaches device memory: the exact re-rank
// (ops/mips.py bucketed_topk) recomputes the dots of the top-k buckets' rows.
// Buckets are 128 contiguous rows, as in K1 (scores_bmax.cu).
//
// What bounds it on an H100: it serves small batches. At q=8 or 64,
// n=2^20, d=1600 in bf16 the call reads 3.36 GB of corpus for 27-215 GFLOP,
// so the corpus read bounds it (~1.0 ms at 3.35 TB/s). The design shares K1's
// tile loop (score_tile.cuh): one block per bucket and 64 queries, so each
// corpus row is read from HBM once when q <= 64; the query tile past q is
// zero-filled, which costs tensor-core work that the memory bound hides.

#include <math.h>

#include "score_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
bucket_max_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                  float* __restrict__ bmax, int q, int n, int d, int valid_count,
                  int q_tiles, int n_buckets, bool vec_ok) {
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<T>()];
  const float* tile = reinterpret_cast<const float*>(smem_raw);
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bucket = blockIdx.x / q_tiles;
  const int n0 = bucket * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  score_tile(queries, corpus, q0, q, n0, n, d, vec_ok, smem_raw);

  // epilogue: each warp folds whole query rows of the tile
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= q) break;
    float m = -INFINITY;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int col = n0 + c;
      if (col < n && col < valid_count) m = fmaxf(m, tile[r * LDC + c]);
    }
    m = warp_max(m);
    if (lane == 0) bmax[(size_t)qi * n_buckets + bucket] = m;
  }
}

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, void* bmax, int q, int n,
                   int d, int valid_count, cudaStream_t stream) {
  const bool vec_ok = rows_vectorizable<T>(queries, corpus, d);
  const int q_tiles = (q + BM - 1) / BM;
  const int n_buckets = (n + BN - 1) / BN;
  const long long blocks = (long long)q_tiles * n_buckets;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bucket_max_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<float*>(bmax), q, n, d, valid_count, q_tiles, n_buckets, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; in_bf16 selects the operand dtype (0 = f32, 1 = bf16). Launches
// on `stream` and returns the launch's cudaError_t; it does not synchronize.
extern "C" int sss_bucket_max(const void* queries, const void* corpus, void* bmax, int q,
                              int n, int d, int valid_count, int in_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;  // nothing to compute
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(queries, corpus, bmax, q, n, d, valid_count, s)
              : launch<float>(queries, corpus, bmax, q, n, d, valid_count, s);
  return static_cast<int>(err);
}
