// Fused int8 x int8 score scan + 128-row bucket max (sm_90a).
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:428
// (_scores_bmax_int8_kernel, launched by scores_with_bucket_max_int8 :465),
// the scan of DenseIndex(quantize='int8x8'). For int8 query codes [q, d],
// int8 corpus codes [n, d] and per-row corpus scales [n] f32 it writes
//   scores[i, r] = f32(<qcodes[i], ccodes[r]>) * scales[r], the dot summed
//                  exactly in int32 (|dot| <= d * 127^2 stays far inside
//                  int32 at d = 1600), set to -inf for r >= valid_count,
//                  then plus penalty[r] (0 live, -inf filtered) when a
//                  penalty is given; stored in f32 or bf16;
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken BEFORE rounding to the score dtype.
// The int32 product matrix never reaches device memory. The query scales
// are left to the caller (ops/mips_int8.py int8_exact_topk multiplies the
// final [q, k] values): a positive factor on a whole row changes no ranking.
// Unlike the TPU kernel, which zeroed the scale of rows past valid_count
// (score 0) and masked their ids afterwards, invalid and filtered rows score
// -inf as in K1, so the selection of ops/mips.py applies unchanged.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 the call is 3.44e12
// int8 operations (1.74 ms at 1,979 TOP/s) against 1.68 GB of corpus codes
// plus 2.15 GB of bf16 scores (1.16 ms at 3.35 TB/s) or 4.3 GB of f32 scores
// (1.79 ms). The design is K1's block shape and cp.async staging
// (score_tile.cuh: one block per contiguous bucket and 64 queries, 80-byte
// shared-memory rows) with the s8 tensor-core instruction mma.sync
// m16n8k32 (s32 accumulate) fed by 32-bit shared-memory loads, which are
// free of bank conflicts at that row stride. It is K2's tile variant: rows
// that TMA can describe (d % 16 == 0, 16-byte-aligned bases) run the s8
// wgmma kernel scores_bmax_int8_sm90.cu (ops/mips_int8.py k2_variant).

#include <math.h>

#include "score_tile.cuh"

namespace {

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
scores_bmax_int8_kernel(const int8_t* __restrict__ queries, const int8_t* __restrict__ corpus,
                        const float* __restrict__ scales, const float* __restrict__ penalty,
                        S* __restrict__ scores, float* __restrict__ bmax, int q, int n, int d,
                        int valid_count, int q_tiles, int n_buckets, bool vec_ok) {
  using T = int8_t;
  constexpr int BK = Cfg<T>::BK, LDS = Cfg<T>::LDS;
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<T>()];
  T* stages = reinterpret_cast<T*>(smem_raw);
  int* tile = reinterpret_cast<int*>(smem_raw);  // epilogue, after the K loop

  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bucket = blockIdx.x / q_tiles;
  const int n0 = bucket * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;      // mma fragment row / column group
  const int wm = warp / 4, wn = warp % 4;     // a 32 x 32 patch: 2 x 4 mma tiles
  const int k_tiles = (d + BK - 1) / BK;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(stages, queries, corpus, q0, q, n0, n, d, 0, vec_ok);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles)
      load_stage(stages + ((kt + 1) & 1) * stage_elems<T>(), queries, corpus, q0, q, n0, n,
                 d, (kt + 1) * BK, vec_ok);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* a = stages + (kt & 1) * stage_elems<T>();
    const T* b = a + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* p = a + (wm * 32 + i * 16 + g) * LDS + kk + t * 4;
        fa[i][0] = ld32(p);
        fa[i][1] = ld32(p + 8 * LDS);
        fa[i][2] = ld32(p + 16);
        fa[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* p = b + (wn * 32 + j * 8 + g) * LDS + kk + t * 4;
        fb[j][0] = ld32(p);
        fb[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();  // the next iteration overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g, c = wn * 32 + j * 8 + t * 2;
      tile[r * LDC + c] = acc[i][j][0];
      tile[r * LDC + c + 1] = acc[i][j][1];
      tile[(r + 8) * LDC + c] = acc[i][j][2];
      tile[(r + 8) * LDC + c + 1] = acc[i][j][3];
    }
  __syncthreads();

  // epilogue: each warp takes whole query rows of the tile; dequantize by
  // the row scale (int32 -> f32 and the product each rounded to nearest),
  // mask, add the penalty, store and fold the f32 values into the bucket max
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= q) break;
    S* srow = scores + (size_t)qi * n;
    float m = -INFINITY;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int col = n0 + c;
      if (col < n) {
        float v = col < valid_count ? __fmul_rn(__int2float_rn(tile[r * LDC + c]), scales[col])
                                    : -INFINITY;
        if (penalty != nullptr) v += penalty[col];
        srow[col] = to_score<S>(v);
        m = fmaxf(m, v);
      }
    }
    m = warp_max(m);
    if (lane == 0) bmax[(size_t)qi * n_buckets + bucket] = m;
  }
}

template <typename S>
cudaError_t launch(const void* queries, const void* corpus, const void* scales,
                   const void* penalty, void* scores, void* bmax, int q, int n, int d,
                   int valid_count, cudaStream_t stream) {
  const bool vec_ok = rows_vectorizable<int8_t>(queries, corpus, d);
  const int q_tiles = (q + BM - 1) / BM;
  const int n_buckets = (n + BN - 1) / BN;
  const long long blocks = (long long)q_tiles * n_buckets;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  scores_bmax_int8_kernel<S><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(corpus),
      static_cast<const float*>(scales), static_cast<const float*>(penalty),
      static_cast<S*>(scores), static_cast<float*>(bmax), q, n, d, valid_count, q_tiles,
      n_buckets, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty may be null. out_bf16 selects the score dtype (0 = f32,
// 1 = bf16). Launches on `stream` and returns the launch's cudaError_t
// (0 = success); it does not synchronize.
extern "C" int sss_scores_bmax_int8(const void* queries, const void* corpus,
                                    const void* scales, const void* penalty, void* scores,
                                    void* bmax, int q, int n, int d, int valid_count,
                                    int out_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;  // nothing to compute
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(queries, corpus, scales, penalty, scores, bmax, q, n,
                                       d, valid_count, s)
               : launch<float>(queries, corpus, scales, penalty, scores, bmax, q, n, d,
                               valid_count, s);
  return static_cast<int>(err);
}
