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
// The tile loop of score_tile.cuh (bf16 on the tensor cores through WMMA,
// fed by a two-stage cp.async pipeline; f32 as an exact FMA loop, no TF32).
// Queries are the fastest grid dimension, so the blocks that share a corpus
// tile run together and the tile comes from HBM once and from L2 after.
// This kernel serves the rows that neither Hopper producer takes: f32 rows
// TMA cannot describe (d % 4 != 0 or bases not 16-byte aligned), and bf16
// rows of odd d or at 2-byte-aligned bases. Other rows run the wgmma
// kernels: scores_bmax_sm90.cu for bf16, fed by TMA (d % 8 == 0,
// 16-byte-aligned bases) or by cp.async (other even d at 4-byte-aligned
// bases: the 250-bit sign and ITQ codes, sm90_cp_async.cuh), and
// scores_bmax_f32_sm90.cu for f32 (the 3xTF32 split) (ops/mips.py
// k1_variant chooses). A dispatch, not a fallback.

#include <math.h>

#include "score_tile.cuh"

namespace {

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
scores_bmax_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                   const float* __restrict__ penalty, S* __restrict__ scores,
                   float* __restrict__ bmax, int q, int n, int d, int valid_count,
                   int q_tiles, int n_buckets, bool vec_ok) {
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<T>()];
  const float* tile = reinterpret_cast<const float*>(smem_raw);
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bucket = blockIdx.x / q_tiles;
  const int n0 = bucket * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  score_tile(queries, corpus, q0, q, n0, n, d, vec_ok, smem_raw);

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
    m = warp_max(m);
    if (lane == 0) bmax[(size_t)qi * n_buckets + bucket] = m;
  }
}

template <typename T, typename S>
cudaError_t launch(const void* queries, const void* corpus, const void* penalty,
                   void* scores, void* bmax, int q, int n, int d, int valid_count,
                   cudaStream_t stream) {
  const bool vec_ok = rows_vectorizable<T>(queries, corpus, d);
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
