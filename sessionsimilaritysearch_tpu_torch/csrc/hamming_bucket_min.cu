// XOR + popcount Hamming distances folded to 128-row bucket minima (sm_90a):
// the `popc` variant of K5.
//
// Replaces the TPU kernels sessionsimilaritysearch_tpu/ops/pallas_mips.py:619
// (_hamming_bucket_min_kernel) and :651 (_hamming_bucket_min_pen_kernel),
// launched by hamming_bucket_min :683. For query codes [q, words] and corpus
// codes [n, words], both row-major packed int32 (bit j of word w = code bit
// 32 w + j, ops/hamming.py pack_bits), it writes
//   bmin[i, b] = min over rows r of bucket b (rows 128 b .. 128 b + 127 below
//                n) of  sum_w popc(q[i, w] ^ c[r, w])  +  penalty[r]
// where the optional int32 penalty is 0 for a live row and 2^20 for a row
// past the corpus fill or filtered out. The selection (ops/popcount.py)
// re-ranks the rows of the best buckets exactly. ops/popcount.py k5_variant
// runs it for codes whose bases are not 16-byte aligned (a view such as
// c[5:]); aligned codes run the wgmma variant, hamming_bucket_min_sm90.cu.
//
// Buckets are contiguous 128-row runs; the TPU kernel's strided buckets were
// a Mosaic store constraint. One thread block owns 64 queries and 8 buckets
// (1024 rows); each warp owns one bucket, each lane four of its rows. The
// block stages its rows word-major in shared memory (stride 1025 words, so
// the lanes' reads of neighbouring rows are free of bank conflicts) and its
// queries row-major (read as broadcasts). A warp takes the minimum
// over its bucket with one __reduce_min_sync per query. Codes wider than
// one staging holds (W > 53) run the chunked kernel below: the words in
// chunks of 8, 16 queries a block, each partial distance in registers.
//
// Bounds on an H100. The work's: the same distances are 2 q n 32 W +-1
// products (hamming_bucket_min_sm90.cu), 0.278 ms at the s8 rate at q=1024,
// n=2^20, 256 bits. This design's own: one popcount per (query, row, word),
// 8.6e9 at that shape; at 16 popcounts per clock per SM that is about 2.2
// ms. The corpus (32 MB at that shape) stays in L2.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                 // 8 warps
constexpr int BUCKET = 128;
constexpr int ROWS_PER_LANE = BUCKET / 32;   // 4
constexpr int BLOCK_ROWS = (THREADS / 32) * BUCKET;  // one bucket per warp: 1024
constexpr int TQ = 64;                       // queries per block
constexpr int LDW = BLOCK_ROWS + 1;          // word-major stride of the rows
constexpr int MAX_SMEM = 232448;             // 227 KB, the most a block can use

__host__ int smem_bytes(int words) { return (words * LDW + TQ * words) * 4; }

__global__ void __launch_bounds__(THREADS)
hamming_bucket_min_kernel(const uint32_t* __restrict__ q_codes,
                          const uint32_t* __restrict__ c_codes,
                          const int32_t* __restrict__ penalty, int32_t* __restrict__ bmin,
                          int q, int n, int words, int q_tiles) {
  extern __shared__ uint32_t smem[];
  uint32_t* cs = smem;                 // [words][LDW]
  uint32_t* qs = smem + words * LDW;   // [TQ][words]
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int r0 = (blockIdx.x / q_tiles) * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;

  for (int i = threadIdx.x; i < BLOCK_ROWS * words; i += THREADS) {
    const int rr = i / words, w = i % words;
    cs[w * LDW + rr] = r0 + rr < n ? __ldg(c_codes + (size_t)r0 * words + i) : 0u;
  }
  for (int i = threadIdx.x; i < TQ * words; i += THREADS)
    qs[i] = q0 + i / words < q ? __ldg(q_codes + (size_t)q0 * words + i) : 0u;
  __syncthreads();

  const int bucket = r0 / BUCKET + warp;
  if (bucket >= n_buckets) return;  // no barrier follows
  const int rb = warp * BUCKET + lane;  // this lane's rows: rb + 32 i
  bool live[ROWS_PER_LANE];
  int pen[ROWS_PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const int row = r0 + rb + 32 * i;
    live[i] = row < n;
    pen[i] = live[i] && penalty != nullptr ? penalty[row] : 0;
  }
  for (int t = 0; t < TQ; ++t) {
    const int qi = q0 + t;
    if (qi >= q) break;
    int d[ROWS_PER_LANE] = {0, 0, 0, 0};
    for (int w = 0; w < words; ++w) {
      const uint32_t qw = qs[t * words + w];
#pragma unroll
      for (int i = 0; i < ROWS_PER_LANE; ++i) d[i] += __popc(qw ^ cs[w * LDW + rb + 32 * i]);
    }
    int m = INT_MAX;
#pragma unroll
    for (int i = 0; i < ROWS_PER_LANE; ++i)
      if (live[i]) m = min(m, d[i] + pen[i]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (lane == 0) bmin[(size_t)qi * n_buckets + bucket] = m;
  }
}

// The same minima for codes too wide for one staging (W > 53 words): the
// block's rows and queries come in chunks of CW words, each (query, row)
// partial distance stays in registers across the chunks, and the block
// takes TQW queries, not TQ. Staging (static): CW x 1025 +
// TQW x CW words, 33,312 bytes.
constexpr int CW = 8;    // words per chunk
constexpr int TQW = 16;  // queries per block

__global__ void __launch_bounds__(THREADS)
hamming_bucket_min_chunked_kernel(const uint32_t* __restrict__ q_codes,
                                  const uint32_t* __restrict__ c_codes,
                                  const int32_t* __restrict__ penalty,
                                  int32_t* __restrict__ bmin, int q, int n, int words,
                                  int q_tiles) {
  __shared__ uint32_t cs[CW * LDW];  // [CW][LDW]
  __shared__ uint32_t qs[TQW * CW];  // [TQW][CW]
  const int q0 = (blockIdx.x % q_tiles) * TQW;
  const int r0 = (blockIdx.x / q_tiles) * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;
  const int rb = warp * BUCKET + lane;  // this lane's rows: rb + 32 i

  int d[TQW][ROWS_PER_LANE];
#pragma unroll
  for (int t = 0; t < TQW; ++t)
#pragma unroll
    for (int i = 0; i < ROWS_PER_LANE; ++i) d[t][i] = 0;
  for (int w0 = 0; w0 < words; w0 += CW) {
    const int cw = min(CW, words - w0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = threadIdx.x; i < BLOCK_ROWS * cw; i += THREADS) {
      const int rr = i / cw, w = i % cw;
      cs[w * LDW + rr] =
          r0 + rr < n ? __ldg(c_codes + (size_t)(r0 + rr) * words + w0 + w) : 0u;
    }
    for (int i = threadIdx.x; i < TQW * CW; i += THREADS) {
      const int t = i / CW, w = i % CW;
      qs[i] = w < cw && q0 + t < q ? __ldg(q_codes + (size_t)(q0 + t) * words + w0 + w) : 0u;
    }
    __syncthreads();
    // words past the chunk's last are zero on both sides: they add nothing
    for (int w = 0; w < cw; ++w) {
      uint32_t c[ROWS_PER_LANE];
#pragma unroll
      for (int i = 0; i < ROWS_PER_LANE; ++i) c[i] = cs[w * LDW + rb + 32 * i];
#pragma unroll
      for (int t = 0; t < TQW; ++t) {
        const uint32_t qw = qs[t * CW + w];
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) d[t][i] += __popc(qw ^ c[i]);
      }
    }
  }

  const int bucket = r0 / BUCKET + warp;
  if (bucket >= n_buckets) return;  // no barrier follows
  bool live[ROWS_PER_LANE];
  int pen[ROWS_PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const int row = r0 + rb + 32 * i;
    live[i] = row < n;
    pen[i] = live[i] && penalty != nullptr ? penalty[row] : 0;
  }
#pragma unroll
  for (int t = 0; t < TQW; ++t) {
    int m = INT_MAX;
#pragma unroll
    for (int i = 0; i < ROWS_PER_LANE; ++i)
      if (live[i]) m = min(m, d[t][i] + pen[i]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (lane == 0 && q0 + t < q) bmin[(size_t)(q0 + t) * n_buckets + bucket] = m;
  }
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty ([n] int32) may be null. q_codes: [q, words] int32;
// c_codes: [n, words] int32, any words >= 1; bmin: [q, ceil(n / 128)] int32. Launches on
// `stream`, returns the launch's cudaError_t (0 = success) and does not
// synchronize.
extern "C" int sss_hamming_bucket_min(const void* q_codes, const void* c_codes,
                                      const void* penalty, void* bmin, int q, int n,
                                      int words, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (words <= 0 || words > INT_MAX / 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qc = static_cast<const uint32_t*>(q_codes);
  const auto* cc = static_cast<const uint32_t*>(c_codes);
  const auto* pen = static_cast<const int32_t*>(penalty);
  auto* out = static_cast<int32_t*>(bmin);
  const long long row_blocks = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
  if (words > MAX_SMEM / (4 * (LDW + TQ))) {  // one staging cannot hold the codes
    const int q_tiles = (q + TQW - 1) / TQW;
    if (q_tiles * row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    hamming_bucket_min_chunked_kernel<<<(unsigned)(q_tiles * row_blocks), THREADS, 0, s>>>(
        qc, cc, pen, out, q, n, words, q_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = smem_bytes(words);
  cudaError_t err = cudaFuncSetAttribute(
      hamming_bucket_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (q + TQ - 1) / TQ;
  const long long blocks = (long long)q_tiles * row_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  hamming_bucket_min_kernel<<<(unsigned)blocks, THREADS, bytes, s>>>(qc, cc, pen, out, q, n,
                                                                      words, q_tiles);
  return static_cast<int>(cudaGetLastError());
}
