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
// - Two consumer warpgroups (setmaxnreg up to 216) of two accumulators, 128
//   queries each where the query tile fits (one, 64 queries each, where not),
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
// larger of 256 (two accumulators a consumer warpgroup; W <= 16) and 128
// (one; W <= 32) that fits beside a ring of at least 3 slots, and the ring
// takes up to 4. At W = 8: 256 queries, 4 slots, 65,536 + 65,536 + 9,216 +
// 2,048 + 128 = 142,464. At W = 32: 128 queries, 3 slots, 215,664 (of
// 232,448).
// - Codes of any wider width run hamming_bucket_min_stream_kernel: the same
//   tiles of 256 queries, products and epilogue, with nothing of a tile
//   resident across its K slices. The producer loads its lanes' words of
//   each slice from device memory (L2), two slices ahead, with no raw
//   buffers; each consumer warpgroup unpacks its own rows' query slice (4
//   words a row) into a ring of 3 A buffers, one slice ahead of the
//   products, and its accumulators add up all ceil(W / 4) slices of the
//   bucket before the min (32 W < 2^31: exact). No partial distance leaves
//   the registers. Shared memory: ring 4 x 16,384, A buffers 3 x 32,768,
//   penalty 4 x 512, barriers 64: 165,952 at every width. (A resident tile
//   of 64 queries, one consumer warpgroup, holds up to W = 64 but ran 1.5x
//   the streamed kernel's time at W = 53 and 64 on an H100: PERF.md.)

#include <climits>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int KS = 128;                      // code bits per K slice: 128 s8 bytes a row
constexpr int SLICE_WORDS = KS / 32;         // 4
constexpr int SLOT_BYTES = BUCKET * KS;      // one unpacked [128 rows x 128] s8 slice
constexpr int MAX_STAGES = 4;
constexpr int RAW_BUFS = 2;                  // buckets of codes in flight to the producer
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

// The M accumulators' bucket minima of a consumer thread's query rows
// (row0 + 64 h and row0 + 64 h + 8 for accumulator h; the quad's lane 0
// stores), written to out[row * n_buckets]: `valid` columns are rows.
template <int M>
__device__ __forceinline__ void store_bucket_min(int32_t (&acc)[M][64], const int32_t (&pcol)[32],
                                                 bool has_pen, int valid, int half, int lane,
                                                 int row0, int q, int32_t* __restrict__ out,
                                                 int n_buckets) {
#pragma unroll
  for (int h = 0; h < M; ++h) {
    int m0, m1;
    if (has_pen)
      bucket_min<true>(acc[h], pcol, valid, half, lane, m0, m1);
    else
      bucket_min<false>(acc[h], pcol, valid, half, lane, m0, m1);
    const int row = row0 + 64 * h;
    if (lane % 4 == 0) {
      if (row < q) out[(size_t)row * n_buckets] = m0;
      if (row + 8 < q) out[(size_t)(row + 8) * n_buckets] = m1;
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
      store_bucket_min<M>(acc, pcol, has_pen, min(BUCKET, n - b * BUCKET), half, lane,
                          wq0 + r0, q, bmin + b, n_buckets);
    }
  }
}

// ---- the streamed layout: codes whose query tile does not fit ----

constexpr int A_BUFS = 3;  // query slices in flight per consumer warpgroup

struct StreamLayout {
  int a_off, pen_off, bar_off, bytes;
};

// rows: the query rows of a tile; the ring, then A_BUFS query slices
__host__ __device__ StreamLayout stream_layout(int rows, int stages) {
  StreamLayout l;
  l.a_off = stages * SLOT_BYTES;
  l.pen_off = l.a_off + A_BUFS * rows * KS;
  l.bar_off = l.pen_off + stages * BUCKET * 4;
  l.bytes = l.bar_off + 2 * stages * 8;  // full, empty
  return l;
}

// The same tiles, products and epilogue as hamming_bucket_min_sm90_kernel,
// for codes of any width: nothing of a tile stays resident across its K
// slices. The producer loads each lane's 4 words of a slice straight from
// device memory (two slices ahead of its unpack) and unpacks them into the
// ring as the resident kernel does. Each consumer warpgroup unpacks its own
// query rows' K slice (4 words a row) into a ring of A_BUFS buffers, one
// slice ahead of the products; the accumulators add up every slice of the
// bucket before the epilogue. A buffer is rewritten two slices after the
// products that read it were issued: every warp of the warpgroup has
// passed wgmma_wait<1> for them before the named barrier that follows the
// last unpack.
template <int C, int M>
__global__ void __launch_bounds__((C + 1) * WG, 1)
hamming_bucket_min_stream_kernel(const uint32_t* __restrict__ q_codes,
                                 const uint32_t* __restrict__ c_codes,
                                 const int32_t* __restrict__ penalty,
                                 int32_t* __restrict__ bmin, int q, int n, int words,
                                 int stages) {
  constexpr int WQ = 64 * M;                   // queries per warpgroup
  constexpr int BQ = C * WQ;                   // queries per tile
  constexpr int QW = WQ * SLICE_WORDS / WG;    // query words a consumer thread unpacks a slice
  extern __shared__ __align__(1024) unsigned char smem[];
  const StreamLayout l = stream_layout(BQ, stages);
  unsigned char* slots = smem;         // the ring of unpacked slices
  unsigned char* qa = smem + l.a_off;  // [A_BUFS][BQ rows][128 bytes], swizzled
  int32_t* pen_slots = reinterpret_cast<int32_t*>(smem + l.pen_off);  // [stages][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bar_off);
  uint64_t* empty = full + stages;

  const int n_buckets = n / BUCKET + (n % BUCKET != 0);
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
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {
    // ---- producer: corpus words in, unpacked slices out ----
    if constexpr (C == 2) reg_dealloc<72>();
    const int pt = threadIdx.x - C * WG, pw = pt / 32, lane = pt % 32;
    // lane: word lane % 4 of each slice, rows 32 pw + lane / 4 + 8 m
    const int wi = lane % SLICE_WORDS, r_lo = 32 * pw + lane / SLICE_WORDS;
    // the lane's words of slice ks of bucket b; zero past n and past W
    auto load = [&](int b, int ks, uint32_t (&v)[BUCKET / 32]) {
      const int w = ks * SLICE_WORDS + wi;
#pragma unroll
      for (int m = 0; m < BUCKET / 32; ++m) {
        const int row = b * BUCKET + r_lo + 8 * m;
        v[m] = w < words && row < n ? __ldg(c_codes + (size_t)row * words + w) : 0u;
      }
    };
    // the words of this slice (v), the next (v1) and the one after (v2, of
    // the tile `aw`, slice aks): loads two slices ahead of their unpack
    Walk tw(blockIdx.x, n_buckets), aw = tw;
    int aks = 0;
    auto step = [&] {
      if (++aks == k_slices) {
        aks = 0;
        aw.next(stride, dq, db, n_buckets);
      }
    };
    uint32_t v[BUCKET / 32], v1[BUCKET / 32];
    load(tw.b, 0, v);
    step();
    load(aw.t < tiles ? aw.b : 0, aks, v1);
    step();
    Ring ring;
    for (; tw.t < tiles; tw.next(stride, dq, db, n_buckets)) {
      const int b = tw.b;
      const int prow = b * BUCKET + pt;
      const int pv = has_pen && prow < n ? __ldg(penalty + prow) : 0;
      for (int ks = 0; ks < k_slices; ++ks) {
        uint32_t v2[BUCKET / 32];
        load(aw.t < tiles ? aw.b : 0, aks, v2);
        step();
        mbar_wait(&empty[ring.slot], ring.phase ^ 1);
        unsigned char* dst = slots + ring.slot * SLOT_BYTES;
        if (ks * SLICE_WORDS + wi < words) {
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
          pen_slots[ring.slot * BUCKET + pt] = wrap_add(half, pv);
        fence_proxy_async();  // each thread's stores before the wgmma reads
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[ring.slot]);
        ring.advance(stages);
#pragma unroll
        for (int m = 0; m < BUCKET / 32; ++m) {
          v[m] = v1[m];
          v1[m] = v2[m];
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * WQ .. wg * WQ + WQ - 1,
    // accumulator h the 64 of them from wg * WQ + 64 h ----
    if constexpr (C == 2) reg_alloc<216>();
    const int tid = threadIdx.x % WG, lane = threadIdx.x % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    // the thread's query words of a slice: word tid % 4 of the warpgroup's
    // rows tid / 4 + 32 j
    const int qwi = tid % SLICE_WORDS, qr = tid / SLICE_WORDS;
    auto load_q = [&](int qt, int ks, uint32_t (&p)[QW]) {
      const int w = ks * SLICE_WORDS + qwi;
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        const int row = qt * BQ + wg * WQ + qr + 32 * j;
        p[j] = w < words && row < q ? __ldg(q_codes + (size_t)row * words + w) : 0u;
      }
    };
    // slice ks of the warpgroup's query rows into A buffer `a`; rows past q
    // hold +1s (their minima are not stored), words past W zeros
    auto stage_q = [&](int a, int ks, const uint32_t (&p)[QW]) {
      const bool real = ks * SLICE_WORDS + qwi < words;
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        const int r = qr + 32 * j;
        unsigned char* row = qa + a * (BQ * KS) + (wg * WQ + r) * KS;
        if (real)
          store_unpacked(row, r, qwi, p[j]);
        else
          store_zero(row, r, qwi);
      }
      fence_proxy_async();
      named_sync(1 + wg, WG);
    };
    Ring ring;
    int32_t acc[M][64];
#pragma unroll
    for (int h = 0; h < M; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;
    int32_t pcol[32];  // 16 W + penalty of this thread's 32 columns
#pragma unroll
    for (int i = 0; i < 32; ++i) pcol[i] = half;
    Walk tw(blockIdx.x, n_buckets), nw = tw;  // this slice's tile, the next slice's
    int nks = 0, a = 0;
    uint32_t p[QW];
    if (tw.t < tiles) {
      load_q(tw.qt, 0, p);
      stage_q(0, 0, p);
    }
    if (++nks == k_slices) {
      nks = 0;
      nw.next(stride, dq, db, n_buckets);
    }
    if (nw.t < tiles) load_q(nw.qt, nks, p);
    for (; tw.t < tiles; tw.next(stride, dq, db, n_buckets)) {
      const int wq0 = tw.qt * BQ + wg * WQ;
      const bool active = wq0 < q;
      // as in the resident kernel: one group queued, a warpgroup past q
      // multiplies rows it does not store rather than branch around the wgmma
      int held = -1;
      for (int ks = 0; ks < k_slices; ++ks) {
        mbar_wait(&full[ring.slot], ring.phase);
        const uint64_t a_desc = desc_sw128(qa + a * (BQ * KS) + wg * WQ * KS);
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
            const int2 pp = *reinterpret_cast<const int2*>(ps + j * 8);
            pcol[2 * j] = pp.x;
            pcol[2 * j + 1] = pp.y;
          }
        }
        wgmma_wait<1>();
        if (held >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[held]);
        }
        held = ring.slot;
        ring.advance(stages);
        // the next slice's queries into the next buffer, then the words of
        // the slice after it
        a = a + 1 == A_BUFS ? 0 : a + 1;
        if (nw.t < tiles) {
          stage_q(a, nks, p);
          if (++nks == k_slices) {
            nks = 0;
            nw.next(stride, dq, db, n_buckets);
          }
          if (nw.t < tiles) load_q(nw.qt, nks, p);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < M; ++h) fence_regs(acc[h]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[held]);
      if (!active) continue;
      store_bucket_min<M>(acc, pcol, has_pen, min(BUCKET, n - tw.b * BUCKET), half, lane,
                          wq0 + r0, q, bmin + tw.b, n_buckets);
    }
  }
}

// One launch of `kernel` (C consumer warpgroups of M accumulators) with
// `bytes` of dynamic shared memory: a persistent grid of one block per SM.
template <int C, int M>
cudaError_t launch(void (*kernel)(const uint32_t*, const uint32_t*, const int32_t*, int32_t*, int,
                                  int, int, int),
                   int bytes, const void* q_codes, const void* c_codes, const void* penalty,
                   void* bmin, int q, int n, int words, int stages, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      ((long long)q + C * 64 * M - 1) / (C * 64 * M) * (((long long)n + BUCKET - 1) / BUCKET);
  if (tiles > INT_MAX / 2) return cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, (C + 1) * WG, bytes, stream>>>(
      static_cast<const uint32_t*>(q_codes), static_cast<const uint32_t*>(c_codes),
      static_cast<const int32_t*>(penalty), static_cast<int32_t*>(bmin), q, n, words, stages);
  return cudaGetLastError();
}

template <int C, int M>
cudaError_t launch_resident(const void* q_codes, const void* c_codes, const void* penalty,
                            void* bmin, int q, int n, int words, int stages,
                            cudaStream_t stream) {
  return launch<C, M>(hamming_bucket_min_sm90_kernel<C, M>,
                      layout(C * 64 * M, words, stages).bytes, q_codes, c_codes, penalty, bmin,
                      q, n, words, stages, stream);
}

template <int C, int M>
cudaError_t launch_stream(const void* q_codes, const void* c_codes, const void* penalty,
                          void* bmin, int q, int n, int words, int stages, cudaStream_t stream) {
  return launch<C, M>(hamming_bucket_min_stream_kernel<C, M>,
                      stream_layout(C * 64 * M, stages).bytes, q_codes, c_codes, penalty, bmin,
                      q, n, words, stages, stream);
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers, each 16-byte aligned; penalty ([n] int32) may be null. q_codes:
// [q, words] int32; c_codes: [n, words] int32, any words >= 1; bmin:
// [q, ceil(n / 128)] int32. Launches on `stream`, returns the launch's
// cudaError_t (0 = success) and does not synchronize.
extern "C" int sss_hamming_bucket_min_sm90(const void* q_codes, const void* c_codes,
                                           const void* penalty, void* bmin, int q, int n,
                                           int words, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (words <= 0 || words > INT_MAX / 32 || reinterpret_cast<uintptr_t>(q_codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c_codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(penalty) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the larger resident query tile that fits beside a ring of at least 3
  // slots: two consumer warpgroups of two accumulators (256 queries) or of
  // one (128); the ring as deep as fits, up to MAX_STAGES. (No resident tile
  // of 128 queries holds more than MAX_SMEM / (128 KS) K slices: wider codes
  // skip the search.)
  if (words <= MAX_SMEM / (128 * KS) * SLICE_WORDS) {
    for (int st = MAX_STAGES; st >= 3; --st)
      if (layout(256, words, st).bytes <= MAX_SMEM)
        return static_cast<int>(
            launch_resident<2, 2>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
    for (int st = MAX_STAGES; st >= 3; --st)
      if (layout(128, words, st).bytes <= MAX_SMEM)
        return static_cast<int>(
            launch_resident<2, 1>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
  }
  // no resident query tile fits: 256 queries a tile, their K slices streamed
  for (int st = MAX_STAGES; st >= 2; --st)
    if (stream_layout(256, st).bytes <= MAX_SMEM)
      return static_cast<int>(
          launch_stream<2, 2>(q_codes, c_codes, penalty, bmin, q, n, words, st, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
