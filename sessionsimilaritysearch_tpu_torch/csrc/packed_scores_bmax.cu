// Packed sign-code scan: unpack -> +-1 bf16 product -> 128-row bucket max (sm_90a).
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:863
// (_packed_scores_bmax_kernel, launched by packed_scores_with_bucket_max
// :902). The corpus is binary sign codes packed 1 bit per bit in the
// transposed layout of ops/hamming.py pack_bits_t: 2048-slot pack blocks of
// 64 packed rows, where slot ii of a block is bit j = ii / 64 of packed row
// s = ii % 64, and each packed row holds `bits` int32 words (one per code
// bit). For +-1 bf16 queries [q, bits] (columns past the true code width are
// ZERO, so corpus pad bits, which unpack to -1, add nothing) it writes
//   scores[i, r] = <queries[i], unpack(corpus)[r]>, exact in f32 (integers of
//                  magnitude <= bits), -inf for r >= valid_count, plus
//                  penalty[r] (0 live, -inf filtered) when one is given;
//                  stored as f32 or bf16 (bf16 is exact for codes <= 256 bits);
//   bmax[i, b]   = max of scores[i, 128 b .. 128 b + 127] in f32.
// Hamming distance is (n_bits - score) / 2 (ops/packed.py packed_topk).
//
// Layout problem: one contiguous 128-row bucket b' of a pack block is bits
// 2b' and 2b'+1 of all 64 packed rows, so a block that owned one bucket would
// read every packed word 16 times. Here one thread block owns a whole pack
// block (16 buckets) for 64 queries: it copies the block's 64 x bits words
// into shared memory once (when they fit: codes up to 512 bits), then for
// each bucket unpacks two bits of every word into a [128, 64-bit] +-1 bf16
// tile in shared memory and runs it through the tensor cores (WMMA
// mma.sync, f32 accumulation), as K1 (csrc/scores_bmax.cu) does. Wider codes
// read the words from L2 per bucket instead. Bit 31 of an int32 word is its
// sign bit: words are shifted as unsigned.
//
// What bounds it on an H100: at q=1024, n=2^20, 256 bits the call is 0.55
// TFLOP of +-1 products against 32 MB of packed corpus (it stays in the 50 MB
// L2) and 2 GB of bf16 score writes, so the tensor cores and the score store
// bound it. This first version is simple on purpose: no pipelining between
// the unpack and the products, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                   // queries per block
constexpr int PACK_ROWS = 64;            // packed rows per pack block
constexpr int BUCKET = 128;              // corpus rows per bucket
constexpr int SLOTS = PACK_ROWS * 32;    // 2048 corpus rows per pack block
constexpr int BUCKETS = SLOTS / BUCKET;  // 16
constexpr int THREADS = 256;             // 8 warps
constexpr int BK = 64;                   // code bits unpacked per step
constexpr int LDB = BK + 8;              // bf16 stride of the unpacked tile
constexpr int LDC = BUCKET + 4;          // f32 stride of the epilogue tile
constexpr int MAX_SMEM = 232448;         // 227 KB, the most a block can use
// the unpacked tile and the epilogue tile share one region
constexpr int TILE_BYTES = BUCKET * LDB * 2 > BM * LDC * 4 ? BUCKET * LDB * 2
                                                           : BM * LDC * 4;

struct Smem {
  int words_off;  // byte offset of the staged words (0 = not staged)
  int tile_off;   // byte offset of the shared unpack / epilogue tile
  int bytes;      // dynamic shared memory of one block
};

__host__ Smem smem_layout(int bits) {
  const int qs_bytes = BM * (bits + 8) * 2;  // a multiple of 128 for bits % 128 == 0
  const int words_bytes = PACK_ROWS * bits * 4;
  Smem s;
  if (qs_bytes + words_bytes + TILE_BYTES <= MAX_SMEM) {
    s.words_off = qs_bytes;
    s.tile_off = qs_bytes + words_bytes;
  } else {
    s.words_off = 0;
    s.tile_off = qs_bytes;
  }
  s.bytes = s.tile_off + TILE_BYTES;
  return s;
}

template <typename S> __device__ __forceinline__ S to_score(float v);
template <> __device__ __forceinline__ float to_score<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_score<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
packed_scores_bmax_kernel(const __nv_bfloat16* __restrict__ queries,
                          const int32_t* __restrict__ words,
                          const float* __restrict__ penalty, S* __restrict__ scores,
                          float* __restrict__ bmax, int q, int n, int bits,
                          int valid_count, int q_tiles, int words_off, int tile_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + tile_off);
  float* tile = reinterpret_cast<float*>(smem + tile_off);
  const int ldq = bits + 8;

  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int pb = blockIdx.x / q_tiles;  // pack block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_buckets = n / BUCKET;

  // the query tile, 16 bytes at a time; rows past q are zero
  const int qchunks = bits / 8;
  for (int c = threadIdx.x; c < BM * qchunks; c += THREADS) {
    const int r = c / qchunks, k = (c % qchunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < q)
      v = __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * bits + k));
    *reinterpret_cast<uint4*>(qs + r * ldq + k) = v;
  }
  // the pack block's words, read from device memory once
  const int32_t* wsrc = words + (size_t)pb * PACK_ROWS * bits;
  if (words_off != 0) {
    int32_t* ws = reinterpret_cast<int32_t*>(smem + words_off);
    const int n4 = PACK_ROWS * bits / 4;
    for (int c = threadIdx.x; c < n4; c += THREADS)
      reinterpret_cast<int4*>(ws)[c] = __ldg(reinterpret_cast<const int4*>(wsrc) + c);
    wsrc = ws;
  }
  __syncthreads();

  using namespace nvcuda;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 32 x 32 each
  for (int b = 0; b < BUCKETS; ++b) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < bits; k0 += BK) {
      // unpack: bucket row h * 64 + s is bit 2b + h of packed row s; a
      // thread turns two neighbouring words into two bf16 pairs
      for (int c = threadIdx.x; c < PACK_ROWS * BK / 2; c += THREADS) {
        const int s = c / (BK / 2), k = (c % (BK / 2)) * 2;
        const int2 w = *reinterpret_cast<const int2*>(wsrc + s * bits + k0 + k);
        const unsigned w0 = static_cast<unsigned>(w.x), w1 = static_cast<unsigned>(w.y);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned j = 2u * b + h;
          // bf16 -1 is 0xBF80, +1 is 0x3F80: a set bit clears the sign
          const unsigned lo = 0xBF80u ^ (((w0 >> j) & 1u) << 15);
          const unsigned hi = 0xBF80u ^ (((w1 >> j) & 1u) << 15);
          *reinterpret_cast<unsigned*>(bs + (h * PACK_ROWS + s) * LDB + k) = lo | (hi << 16);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], qs + (wm * 32 + i * 16) * ldq + k0 + kk, ldq);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();  // the next step (or the epilogue) overwrites the tile
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(tile + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    // epilogue: mask, add the penalty, store, fold the bucket max
    const int n0 = pb * SLOTS + b * BUCKET;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int qi = q0 + r;
      if (qi >= q) break;
      S* srow = scores + (size_t)qi * n;
      float m = -INFINITY;
#pragma unroll
      for (int c = lane; c < BUCKET; c += 32) {
        const int col = n0 + c;
        float v = col < valid_count ? tile[r * LDC + c] : -INFINITY;
        if (penalty != nullptr) v += penalty[col];
        srow[col] = to_score<S>(v);
        m = fmaxf(m, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) bmax[(size_t)qi * n_buckets + n0 / BUCKET] = m;
    }
    __syncthreads();  // the next bucket's unpack overwrites the tile
  }
}

template <typename S>
cudaError_t launch(const void* queries, const void* words, const void* penalty, void* scores,
                   void* bmax, int q, int n, int bits, int valid_count, cudaStream_t stream) {
  const Smem sm = smem_layout(bits);
  if (sm.bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_scores_bmax_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sm.bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (q + BM - 1) / BM;
  const long long blocks = (long long)q_tiles * (n / SLOTS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  packed_scores_bmax_kernel<S><<<(unsigned)blocks, THREADS, sm.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(queries), static_cast<const int32_t*>(words),
      static_cast<const float*>(penalty), static_cast<S*>(scores), static_cast<float*>(bmax),
      q, n, bits, valid_count, q_tiles, sm.words_off, sm.tile_off);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty may be null. queries: [q, bits] bf16; words: [n / 32,
// bits] int32 with n a multiple of 2048 and bits a multiple of 128 (at most
// 1536); scores: [q, n] (out_bf16: 1 = bf16, 0 = f32); bmax: [q, n / 128]
// f32. Launches on `stream`, returns the launch's cudaError_t (0 = success)
// and does not synchronize.
extern "C" int sss_packed_scores_bmax(const void* queries, const void* words,
                                      const void* penalty, void* scores, void* bmax, int q,
                                      int n, int bits, int valid_count, int out_bf16,
                                      void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (n % SLOTS != 0 || bits % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(queries, words, penalty, scores, bmax, q, n, bits,
                                       valid_count, s)
               : launch<float>(queries, words, penalty, scores, bmax, q, n, bits,
                               valid_count, s);
  return static_cast<int>(err);
}
