// XOR + popcount Hamming distances folded to 128-row bucket minima (sm_90a).
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
// re-ranks the rows of the best buckets exactly.
//
// Buckets are contiguous 128-row runs; the TPU kernel's strided buckets were
// a Mosaic store constraint. One thread block owns 64 queries and 8 buckets
// (1024 rows); each warp owns one bucket, each lane four of its rows. The
// block stages its rows word-major in shared memory (stride 1025 words, so
// the lanes' reads of neighbouring rows are free of bank conflicts) and its
// queries row-major (read as broadcasts). A warp takes the minimum
// over its bucket with one __reduce_min_sync per query.
//
// What bounds it on an H100: one popcount per (query, row, word), 8.6e9 at
// q=1024, n=2^20, 256 bits; at 16 popcounts per clock per SM that is about
// 2.2 ms. The corpus (32 MB at that shape) stays in L2.

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

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty ([n] int32) may be null. q_codes: [q, words] int32;
// c_codes: [n, words] int32; bmin: [q, ceil(n / 128)] int32. Launches on
// `stream`, returns the launch's cudaError_t (0 = success) and does not
// synchronize.
extern "C" int sss_hamming_bucket_min(const void* q_codes, const void* c_codes,
                                      const void* penalty, void* bmin, int q, int n,
                                      int words, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  const int bytes = smem_bytes(words);
  if (words <= 0 || bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      hamming_bucket_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (q + TQ - 1) / TQ;
  const long long blocks = (long long)q_tiles * ((n + BLOCK_ROWS - 1) / BLOCK_ROWS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  hamming_bucket_min_kernel<<<(unsigned)blocks, THREADS, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_codes), static_cast<const uint32_t*>(c_codes),
      static_cast<const int32_t*>(penalty), static_cast<int32_t*>(bmin), q, n, words,
      q_tiles);
  return static_cast<int>(cudaGetLastError());
}
