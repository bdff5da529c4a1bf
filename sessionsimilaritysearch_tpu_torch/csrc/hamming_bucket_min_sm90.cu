// Hamming bucket minimum as a +-1 s8 wgmma scan with a min-only epilogue
// (sm_90a): the `wgmma` variant of K5.
//
// Replaces the TPU kernels sessionsimilaritysearch_tpu/ops/pallas_mips.py:619
// (_hamming_bucket_min_kernel) and :651 (_hamming_bucket_min_pen_kernel),
// launched by hamming_bucket_min :683 (called at :736), as
// hamming_bucket_min.cu (the `popc` variant) does, with the same contract:
// for query codes [q, words] and corpus codes [n, words], both row-major
// packed int32 (bit j of word w = code bit 32 w + j, ops/hamming.py
// pack_bits), and an optional int32 penalty [n],
//   bmin[i, b] = min over rows r of bucket b (rows 128 b .. 128 b + 127
//                below n) of  hamming(q[i], c[r]) + penalty[r],
// equal bit for bit to ops/popcount.py hamming_bucket_min_ref (the penalty
// add wraps as int32 addition does there).
//
// Arithmetic. Over the 32 W bits of W words, the +-1 vectors of two codes
// (one s8 value a bit) have <a, b> = (bits equal) - (bits differing) =
// 32 W - 2 h, so h = (32 W - dot) / 2 = 16 W - dot / 2, with dot summed in
// s32 (exact). The zero pad bits of the last word are equal in query and row
// and add 0 to h, so the identity takes 32 W, not the code's bit count. K
// slices past the last word are zero in both operands and add nothing. The
// unpack (store_unpacked) puts a word's 32 bits in an order of its own and
// writes a set bit as -1, a clear one as +1: queries and rows share both,
// so every product, and the dot, is that of bit 1 -> +1, bit 0 -> -1 in bit
// order. It is two ALU instructions per 4 bits (prmt's sign replication of
// w << (7 - g), then OR 0x01010101) and a shift.
//
// What bounds it on an H100: the same work is 2 q n 32 W +-1 products,
// 5.50e14 at q=1024, n=2^20, 256 bits (W=8), 0.278 ms at the s8 rate of
// 1,979 TOP/s; its bytes, (q + n) 4 W + q ceil(n / 128) 4 = 67 MB, take
// 0.020 ms. So the products bound it. K4 (packed_scores_bmax.cu) runs the
// same products but also stores every score, and that store bounds it; here
// only the bucket minima leave the chip, 1/128 of the scores.
//
// Design.
// - Persistent blocks, one per SM, walk (query tile, bucket) tiles, buckets
//   fastest (Walk steps them without a division): the corpus (32 MB at the
//   bench point) stays in the 50 MB L2 across the query tiles, and the query
//   tile stays resident in shared memory, unpacked once per tile change.
// - A bucket's 128 rows are 512 W contiguous bytes. Each producer warp owns
//   32 of them: one cp.async.bulk per warp and bucket (no tensor map, any W)
//   brings its rows, and their 128 bytes of penalty, into one of two raw
//   buffers on the warp's own mbarrier, one bucket ahead of its unpack, so
//   that no producer warp waits for another. The ragged last bucket (n % 128
//   != 0) may not be a multiple of 16 bytes: its warps copy it with their
//   own loads, zero-filled.
// - One producer warpgroup (setmaxnreg down to 72 registers with two
//   consumers) unpacks each K slice of 4 words (128 bits: 128 s8 bytes a
//   row) straight into the 128-byte-swizzled K-major layout the wgmma B
//   descriptor reads, into a ring of up to 4 slots of 16 KB, each lane its 4
//   words loaded before any store, and fences its generic stores for the
//   async proxy before its warp arrives on the slot's full barrier (one
//   arrival per warp). With the bucket's last slice it writes 16 W +
//   penalty of the bucket's rows beside the slot.
// - Consumer warpgroups (setmaxnreg up to 216) of two accumulators, 128
//   queries each where the query tile fits (one, 64 queries, where not),
//   unpack their query rows into the A layout once per query tile and run
//   wgmma m64n128k32 s8 over the bucket's slices, one group queued behind
//   the running one; a slot is released once the group after it is issued.
//   No wgmma sits on a divergent path (ptxas would serialize them all): a
//   warpgroup past q multiplies zero rows.
// - Epilogue, from registers: without a penalty, the max of each query
//   row's 32 dots in the thread (a tree of depth 5), then across the quad of
//   lanes that holds the row's 128 columns, then 16 W - max / 2; with one,
//   the min of (16 W + penalty) - dot / 2 likewise; one int32 store per
//   (query, bucket). No score leaves the registers.
// Shared memory (bytes): ring STAGES x 16,384; query tile ceil(W / 4) x BQ
// x 128 for BQ queries; raw buffers 2 x 512 (W + 1); the penalty beside the
// ring STAGES x 512; barriers (2 STAGES + 8) x 8. The query tile is the
// largest of 256 (two consumer warpgroups of two accumulators; W <= 16), 128
// (of one; W <= 32) and 64 (one warpgroup; W <= 53) that fits beside a ring
// of at least 3 slots (2 for 64), and the ring takes up to 4. At W = 8: 256
// queries, 4 slots, 65,536 + 65,536 + 9,216 + 2,048 + 128 = 142,464. At
// W = 53: 64 queries, 3 slots, 49,152 + 114,688 + 55,296 + 1,536 + 112 =
// 220,784 (of 232,448).

#include <climits>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int KS = 128;                      // code bits per K slice: 128 s8 bytes a row
constexpr int SLICE_WORDS = KS / 32;         // 4
constexpr int SLOT_BYTES = BUCKET * KS;      // one unpacked [128 rows x 128] s8 slice
constexpr int MAX_STAGES = 4;
constexpr int RAW_BUFS = 2;                  // buckets of codes in flight to the producer
constexpr int MAX_WORDS = 53;
constexpr int MAX_SMEM = 232448;

// one raw buffer: a bucket's codes [128][words] int32, then its penalty [128]
__host__ __device__ constexpr int raw_bytes(int words) { return BUCKET * 4 * (words + 1); }

struct Layout {
  int a_off, raw_off, pen_off, bar_off, bytes;
};

// rows: the query rows resident in shared memory (the query tile)
__host__ __device__ Layout layout(int rows, int words, int stages) {
  const int k_slices = (words + SLICE_WORDS - 1) / SLICE_WORDS;
  Layout l;
  l.a_off = stages * SLOT_BYTES;
  l.raw_off = l.a_off + k_slices * rows * KS;
  l.pen_off = l.raw_off + RAW_BUFS * raw_bytes(words);
  l.bar_off = l.pen_off + stages * BUCKET * 4;
  l.bytes = l.bar_off + (2 * stages + 4 * RAW_BUFS) * 8;  // full, empty, raw_full
  return l;
}

// Each byte of y: 0xFF where its top bit is set, else 0x00 (prmt's sign
// replication, one instruction).
__device__ __forceinline__ uint32_t top_bits_to_bytes(uint32_t y) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(0u), "r"(0xBA98u));
  return r;
}

// One code word as the 32 s8 values of its bits, -1 for a set bit and +1
// for a clear one, stored as the two 16-byte chunks of word `wi` of a K
// slice's 128-byte row `r` (`row` points at it), at their positions in the
// 128-byte swizzle. Value 4 g + k of the word's 32 is bit g + 8 k: shifted
// left by 7 - g, bits g, g + 8, g + 16 and g + 24 of w are the top bits of
// its four bytes. Queries and rows share the order and the signs, so each
// product, and the dot, is that of bit 1 -> +1, bit 0 -> -1 in bit order.
__device__ __forceinline__ void store_unpacked(unsigned char* row, int r, int wi, uint32_t w) {
  uint32_t o[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) o[g] = top_bits_to_bytes(w << (7 - g)) | 0x01010101u;
  *reinterpret_cast<uint4*>(row + (((2 * wi) ^ (r & 7)) << 4)) =
      make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(row + (((2 * wi + 1) ^ (r & 7)) << 4)) =
      make_uint4(o[4], o[5], o[6], o[7]);
}

// 32 zero bytes in place of word `wi`: K past the code's last word.
__device__ __forceinline__ void store_zero(unsigned char* row, int r, int wi) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<uint4*>(row + (((2 * wi) ^ (r & 7)) << 4)) = z;
  *reinterpret_cast<uint4*>(row + (((2 * wi + 1) ^ (r & 7)) << 4)) = z;
}

// int32 addition and subtraction that wrap, as torch's int32 ops do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// The max (min) of v[h], v[h + 1], v[h + 4], v[h + 5], ... (32 values: one
// accumulator row's columns), as a tree of depth 5. The halving steps are
// written out so that every index is a constant (registers, no stack).
template <bool MAX> __device__ __forceinline__ int pick(int a, int b) {
  return MAX ? max(a, b) : min(a, b);
}
template <bool MAX> __device__ __forceinline__ int tree(const int32_t (&v)[64], int h) {
  int t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = pick<MAX>(v[4 * i + h], v[4 * i + h + 1]);
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = pick<MAX>(t[i], t[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = pick<MAX>(t[i], t[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) t[i] = pick<MAX>(t[i], t[i + 2]);
  return pick<MAX>(t[0], t[1]);
}

// One bucket's minimum for a consumer thread's two query rows (r0 and
// r0 + 8 of its warpgroup's accumulator) from its 64 s32 dots: acc[j] is row
// r0 + 8 ((j / 2) % 2), column (j / 4) * 8 + (lane % 4) * 2 + j % 2.
// Columns at or past `valid` (the rows past n of a ragged last bucket) drop
// out. Without a penalty: the largest dot d of the row, then 16 W - d / 2
// (`half` = 16 W); with one, pcol[c] = 16 W + penalty of column c and the
// least pcol - dot / 2, wrapping as int32 addition does. acc is overwritten.
template <bool PEN>
__device__ __forceinline__ void bucket_min(int32_t (&acc)[64], const int32_t (&pcol)[32],
                                           int valid, int half, int lane, int& m0, int& m1) {
  if constexpr (!PEN) {
    if (valid < BUCKET) {
#pragma unroll
      for (int j = 0; j < 64; ++j)
        if ((j / 4) * 8 + (lane % 4) * 2 + j % 2 >= valid) acc[j] = INT_MIN;
    }
    // a tree over the thread's 32 columns (column 0 is always a row, so the
    // result is a dot), then across the quad of lanes that holds the row
    m0 = tree<true>(acc, 0);
    m1 = tree<true>(acc, 2);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    m0 = half - (m0 >> 1);
    m1 = half - (m1 >> 1);
  } else {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      acc[j] = wrap_sub(pcol[(j / 4) * 2 + j % 2], acc[j] >> 1);
      if (valid < BUCKET && (j / 4) * 8 + (lane % 4) * 2 + j % 2 >= valid) acc[j] = INT_MAX;
    }
    m0 = tree<false>(acc, 0);
    m1 = tree<false>(acc, 2);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = min(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = min(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
  }
}

// The tiles t = t0, t0 + stride, ... of a block, as (query tile qt, bucket
// b) = (t / n_buckets, t % n_buckets), stepped without a division.
struct Walk {
  int t, qt, b;
  __device__ Walk(int t0, int n_buckets) : t(t0), qt(t0 / n_buckets), b(t0 % n_buckets) {}
  // dq, db: stride / n_buckets, stride % n_buckets
  __device__ __forceinline__ void next(int stride, int dq, int db, int n_buckets) {
    t += stride;
    qt += dq;
    b += db;
    if (b >= n_buckets) {
      b -= n_buckets;
      ++qt;
    }
  }
};

// C consumer warpgroups of M accumulators (64 query rows each)
template <int C, int M>
__global__ void __launch_bounds__((C + 1) * WG, 1)
hamming_bucket_min_sm90_kernel(const uint32_t* __restrict__ q_codes,
                               const uint32_t* __restrict__ c_codes,
                               const int32_t* __restrict__ penalty, int32_t* __restrict__ bmin,
                               int q, int n, int words, int stages) {
  constexpr int WQ = 64 * M;  // queries per warpgroup
  constexpr int BQ = C * WQ;  // queries per tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout(BQ, words, stages);
  unsigned char* slots = smem;         // the ring of unpacked slices
  unsigned char* qa = smem + l.a_off;  // [k_slices][BQ rows][128 bytes], swizzled
  unsigned char* raw = smem + l.raw_off;
  int32_t* pen_slots = reinterpret_cast<int32_t*>(smem + l.pen_off);  // [stages][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bar_off);
  uint64_t* empty = full + stages;
  uint64_t* raw_full = empty + stages;

  const int full_buckets = n / BUCKET;
  const int n_buckets = full_buckets + (n % BUCKET != 0);
  const int tiles = (int)(((long long)q + BQ - 1) / BQ * n_buckets);  // < 2^30 (host)
  const int k_slices = (words + SLICE_WORDS - 1) / SLICE_WORDS;
  const int half = 16 * words;  // h = 16 W - dot / 2
  const bool has_pen = penalty != nullptr;
  const int wg = threadIdx.x / WG;
  const int stride = gridDim.x, dq = stride / n_buckets, db = stride % n_buckets;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();  // the 128-byte swizzle needs it
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 4);  // one arrival per producer warp
      mbar_init(&empty[s], 4 * C);
    }
    for (int i = 0; i < 4 * RAW_BUFS; ++i) mbar_init(&raw_full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {
    // ---- producer: bucket codes in, unpacked slices out ----
    if constexpr (C == 2) reg_dealloc<72>();
    const int pt = threadIdx.x - C * WG, pw = pt / 32, lane = pt % 32;
    // warp pw owns the bucket's rows 32 pw .. 32 pw + 31: it copies them in
    // and unpacks them, apart from the other producer warps. Lane: word
    // lane % 4 of each slice, rows 32 pw + lane / 4 + 8 m.
    const int wi = lane % SLICE_WORDS, r_lo = 32 * pw + lane / SLICE_WORDS;
    const uint32_t quarter_bytes = 32 * 4 * words;  // the warp's rows of one bucket
    // lane 0: one bulk copy of the warp's rows of bucket b (and their
    // penalty) into raw buffer `buf`; full buckets only
    auto fetch = [&](int b, int buf) {
      if (b >= full_buckets) return;
      unsigned char* dst = raw + buf * raw_bytes(words);
      uint64_t* bar = &raw_full[buf * 4 + pw];
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, quarter_bytes + (has_pen ? 32 * 4 : 0));
      bulk_load(dst + pw * quarter_bytes,
                c_codes + ((size_t)b * BUCKET + 32 * pw) * words, quarter_bytes, bar);
      if (has_pen)
        bulk_load(dst + BUCKET * 4 * words + pw * 32 * 4, penalty + (size_t)b * BUCKET + 32 * pw,
                  32 * 4, bar);
    };
    Walk tw(blockIdx.x, n_buckets), fw(blockIdx.x, n_buckets);  // this tile, the next fetch
    for (int i = 0; i < RAW_BUFS; ++i, fw.next(stride, dq, db, n_buckets))
      if (lane == 0 && fw.t < tiles) fetch(fw.b, i);
    Ring ring;
    uint32_t raw_phase = 0;  // bit i: parity of raw buffer i
    int buf = 0;
    for (; tw.t < tiles; tw.next(stride, dq, db, n_buckets), fw.next(stride, dq, db, n_buckets),
                         buf = buf + 1 == RAW_BUFS ? 0 : buf + 1) {
      const int b = tw.b;
      uint32_t* codes = reinterpret_cast<uint32_t*>(raw + buf * raw_bytes(words));
      int32_t* pen = reinterpret_cast<int32_t*>(codes + BUCKET * words);
      if (b < full_buckets) {
        mbar_wait(&raw_full[buf * 4 + pw], (raw_phase >> buf) & 1u);
        raw_phase ^= 1u << buf;
      } else {
        // the ragged last bucket, by the warp's own loads; rows past n are
        // zero (the epilogue leaves them out)
        const int valid = n - b * BUCKET;
        for (int i = 32 * pw * words + lane; i < 32 * (pw + 1) * words; i += 32)
          codes[i] = i < valid * words ? __ldg(c_codes + (size_t)b * BUCKET * words + i) : 0u;
        if (has_pen) pen[pt] = pt < valid ? __ldg(penalty + b * BUCKET + pt) : 0;
        __syncwarp();
      }
      for (int ks = 0; ks < k_slices; ++ks) {
        const int w = ks * SLICE_WORDS + wi;
        uint32_t v[BUCKET / 32];  // this lane's 4 words, loaded before any store
#pragma unroll
        for (int m = 0; m < BUCKET / 32; ++m)
          v[m] = w < words ? codes[(r_lo + 8 * m) * words + w] : 0u;
        mbar_wait(&empty[ring.slot], ring.phase ^ 1);
        unsigned char* dst = slots + ring.slot * SLOT_BYTES;
        if (w < words) {
#pragma unroll
          for (int m = 0; m < BUCKET / 32; ++m) {
            const int r = r_lo + 8 * m;
            store_unpacked(dst + r * KS, r, wi, v[m]);
          }
        } else {
#pragma unroll
          for (int m = 0; m < BUCKET / 32; ++m) store_zero(dst + (r_lo + 8 * m) * KS, r_lo, wi);
        }
        if (has_pen && ks == k_slices - 1)
          pen_slots[ring.slot * BUCKET + pt] = wrap_add(half, pen[pt]);
        fence_proxy_async();  // each thread's stores before the wgmma reads
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[ring.slot]);
        ring.advance(stages);
      }
      // the warp is done with its rows of buffer buf: refill them
      if (lane == 0 && fw.t < tiles) fetch(fw.b, buf);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * WQ .. wg * WQ + WQ - 1,
    // accumulator h the 64 of them from wg * WQ + 64 h ----
    if constexpr (C == 2) reg_alloc<216>();
    const int tid = threadIdx.x % WG, lane = threadIdx.x % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    Ring ring;
    int cur_qt = -1;
    int32_t acc[M][64];
#pragma unroll
    for (int h = 0; h < M; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;
    int32_t pcol[32];  // 16 W + penalty of this thread's 32 columns
#pragma unroll
    for (int i = 0; i < 32; ++i) pcol[i] = half;
    for (Walk tw(blockIdx.x, n_buckets); tw.t < tiles; tw.next(stride, dq, db, n_buckets)) {
      const int qt = tw.qt, b = tw.b;
      const int wq0 = qt * BQ + wg * WQ;
      const bool active = wq0 < q;
      if (qt != cur_qt) {
        // the warpgroup's query rows as +-1 s8, resident until the query
        // tile changes; rows past q and words past `words` are zero
        cur_qt = qt;
        const int wpr = k_slices * SLICE_WORDS;
        for (int i = tid; active && i < WQ * wpr; i += WG) {
          const int r = i / wpr, w = i % wpr;
          unsigned char* row = qa + (w / SLICE_WORDS) * (BQ * KS) + (wg * WQ + r) * KS;
          if (w < words && wq0 + r < q)
            store_unpacked(row, r, w % SLICE_WORDS,
                           __ldg(q_codes + (size_t)(wq0 + r) * words + w));
          else
            store_zero(row, r, w % SLICE_WORDS);
        }
        fence_proxy_async();
        named_sync(1 + wg, WG);
      }
      // the slices' products back to back: each slot is released once the
      // group after it is issued and its own has retired (one group queued).
      // A warpgroup past q multiplies zero rows rather than branch around
      // the wgmma (a divergent path would serialize every wgmma).
      int held = -1;
      for (int ks = 0; ks < k_slices; ++ks) {
        mbar_wait(&full[ring.slot], ring.phase);
        const uint64_t a_desc = desc_sw128(qa + ks * (BQ * KS) + wg * WQ * KS);
        const uint64_t b_desc = desc_sw128(slots + ring.slot * SLOT_BYTES);
#pragma unroll
        for (int h = 0; h < M; ++h) fence_regs(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 32; ++kk)
#pragma unroll
          for (int h = 0; h < M; ++h)  // a step of 64 rows is 8 KB: 512 descriptor units
            wgmma_m64n128k32_s8(acc[h], a_desc + 512 * h + 2 * kk, b_desc + 2 * kk,
                                ks > 0 || kk > 0);
        wgmma_commit();
        if (has_pen && ks == k_slices - 1) {
          const int32_t* ps = pen_slots + ring.slot * BUCKET + (lane % 4) * 2;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int2 p = *reinterpret_cast<const int2*>(ps + j * 8);
            pcol[2 * j] = p.x;
            pcol[2 * j + 1] = p.y;
          }
        }
        wgmma_wait<1>();
        if (held >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[held]);
        }
        held = ring.slot;
        ring.advance(stages);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < M; ++h) fence_regs(acc[h]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[held]);
      if (!active) continue;
      const int valid = min(BUCKET, n - b * BUCKET);
#pragma unroll
      for (int h = 0; h < M; ++h) {
        int m0, m1;
        if (has_pen)
          bucket_min<true>(acc[h], pcol, valid, half, lane, m0, m1);
        else
          bucket_min<false>(acc[h], pcol, valid, half, lane, m0, m1);
        const int row = wq0 + 64 * h + r0;
        if (lane % 4 == 0) {
          if (row < q) bmin[(size_t)row * n_buckets + b] = m0;
          if (row + 8 < q) bmin[(size_t)(row + 8) * n_buckets + b] = m1;
        }
      }
    }
  }
}

template <int C, int M>
cudaError_t launch(const void* q_codes, const void* c_codes, const void* penalty, void* bmin,
                   int q, int n, int words, int stages, cudaStream_t stream) {
  const int bytes = layout(C * 64 * M, words, stages).bytes;
  cudaError_t err = cudaFuncSetAttribute(hamming_bucket_min_sm90_kernel<C, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)q + C * 64 * M - 1) / (C * 64 * M) * (((long long)n + BUCKET - 1) / BUCKET);
  if (tiles > INT_MAX / 2) return cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < sms ? tiles : sms);
  hamming_bucket_min_sm90_kernel<C, M><<<grid, (C + 1) * WG, bytes, stream>>>(
      static_cast<const uint32_t*>(q_codes), static_cast<const uint32_t*>(c_codes),
      static_cast<const int32_t*>(penalty), static_cast<int32_t*>(bmin), q, n, words, stages);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers, each 16-byte aligned; penalty ([n] int32) may be null. q_codes:
// [q, words] int32; c_codes: [n, words] int32, 1 <= words <= 53; bmin:
// [q, ceil(n / 128)] int32. Launches on `stream`, returns the launch's
// cudaError_t (0 = success) and does not synchronize.
extern "C" int sss_hamming_bucket_min_sm90(const void* q_codes, const void* c_codes,
                                           const void* penalty, void* bmin, int q, int n,
                                           int words, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (words <= 0 || words > MAX_WORDS || reinterpret_cast<uintptr_t>(q_codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c_codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(penalty) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest query tile that fits beside a ring of at least 3 slots: two
  // consumer warpgroups of two accumulators (256 queries), of one (128), then
  // one warpgroup of one (64, beside at least 2 slots); the ring as deep as
  // fits, up to MAX_STAGES
  for (int st = MAX_STAGES; st >= 3; --st)
    if (layout(256, words, st).bytes <= MAX_SMEM)
      return static_cast<int>(launch<2, 2>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
  for (int st = MAX_STAGES; st >= 3; --st)
    if (layout(128, words, st).bytes <= MAX_SMEM)
      return static_cast<int>(launch<2, 1>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
  for (int st = MAX_STAGES; st >= 2; --st)
    if (layout(64, words, st).bytes <= MAX_SMEM)
      return static_cast<int>(launch<1, 1>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
