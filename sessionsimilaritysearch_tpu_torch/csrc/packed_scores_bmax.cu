// Packed sign-code scan: unpack -> +-1 s8 wgmma -> 128-row bucket max, with
// the unpack overlapped with the products (sm_90a).
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:863
// (_packed_scores_bmax_kernel, launched by packed_scores_with_bucket_max
// :902, :941). The corpus is binary sign codes packed 1 bit per bit in the
// transposed layout of ops/hamming.py pack_bits_t: 2048-slot pack blocks of
// 64 packed rows, where slot ii of a block is bit j = ii / 64 of packed row
// s = ii % 64, and each packed row holds `bits` int32 words (one per code
// bit). For +-1 bf16 queries [q, bits] (columns past the true code width are
// ZERO, so corpus pad bits, which unpack to -1, add nothing) it writes
//   scores[i, r] = <queries[i], unpack(corpus)[r]>, exact (integers of
//                  magnitude <= bits), -inf for r >= valid_count, plus
//                  penalty[r] (0 live, -inf filtered) when one is given;
//                  stored as f32 or bf16 (bf16 is exact for codes <= 256 bits);
//   bmax[i, b]   = max of scores[i, 128 b .. 128 b + 127] in f32.
// Hamming distance is (n_bits - score) / 2 (ops/packed.py packed_topk).
//
// What bounds it on an H100: at q=1024, n=2^20, 256 bits the call is 0.55
// TOP of +-1 products (0.28 ms at the s8 rate) against 32 MB of packed
// corpus and 2 GB of bf16 scores: the score store bounds it (0.66 ms).
//
// Design. Bucket b' of a pack block is bits 2b' and 2b'+1 of its 64
// packed rows (bucket row h * 64 + s is bit 2b' + h of packed row s), so
// every bucket reads all of the block's words.
// - Persistent blocks, one per SM, walk (query tile, pack block) tiles,
//   pack blocks fastest. The QUERY TILE STAYS RESIDENT in shared memory
//   while a block walks pack blocks (reloaded only when its query tile
//   changes), and each pack block is unpacked once per query tile of
//   C * 64 = 128 queries: 8 times at q=1024 (16 before).
// - Products in s8 wgmma (m64n128k32, s32 accumulate): exact for +-1 and 0,
//   half the unpacked bytes of bf16 and twice its rate. The consumers turn
//   their bf16 query rows into s8 inside the kernel; the input stays bf16.
// - One producer warpgroup (setmaxnreg down to 56 registers) unpacks
//   bucket b, K slice ks (128 code bits) straight into the 128-byte-swizzled
//   K-major layout the wgmma B descriptor reads, into a ring of 4 slots of
//   16 KB, while two consumer warpgroups (64 queries each, setmaxnreg up to
//   224) multiply the slots already full. Full barriers count the 128
//   producer threads (each fences its generic stores for the async proxy
//   first); empty barriers count the consumer warps. (Consumers that take
//   every other bucket for all 128 queries, so that one's epilogue runs
//   beside the other's products, measured slower on an H100: PERF.md.)
// - The pack block's words come into shared memory by one bulk copy
//   (cp.async.bulk on an mbarrier) per tile, not by the producer's loads.
// - Codes wider than 128 bits loop over 128-bit K slices inside a bucket;
//   the s32 accumulators add up every slice before the epilogue.
// - The epilogue (sm90_common.cuh bucket_epilogue) takes the bucket max
//   from registers and writes the scores through shared memory in 16-byte
//   streaming stores.
// Shared memory (bytes): ring 65,536; query tile 128 * bits; staging 2 *
// 17,408 (bf16 scores) or 2 * 34,816 (f32); the pack block's words 256 *
// bits; barriers 72. At 256 bits with bf16 scores: 65,536 + 32,768 +
// 34,816 + 65,536 + 72 = 198,728 of 232,448. That holds 128 bits, and 256
// with bf16 scores; every other width runs the streamed layout
// (packed_scores_bmax_stream_kernel below), since reading the block's words
// again for each of its 16 buckets (a layout that cannot stage them) took
// 86.5 ms at 1,536 bits on an H100 (PERF.md), the streamed layout 5.0.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int PACK_ROWS = 64;              // packed rows per pack block
constexpr int SLOTS = PACK_ROWS * 32;      // 2048 corpus rows per pack block
constexpr int BUCKETS = SLOTS / BUCKET;    // 16
constexpr int KS = 128;                    // code bits per K slice: 128 s8 bytes a row
constexpr int SLOT_BYTES = BUCKET * KS;    // one unpacked [128 rows x 128] s8 slice
constexpr int STAGES = 4;
constexpr int PRODUCER_BAR = 3;            // named barrier of the producer warpgroup
constexpr int MAX_SMEM = 232448;

struct Layout {
  int a_off, stage_off, words_off, bar_off, bytes;
};

template <typename S>
__host__ __device__ Layout layout(int consumers, int bits) {
  Layout l;
  l.a_off = STAGES * SLOT_BYTES;
  l.stage_off = l.a_off + consumers * 64 * bits;
  l.words_off = l.stage_off + consumers * staging_bytes<S>();
  l.bar_off = l.words_off + PACK_ROWS * bits * 4;
  l.bytes = l.bar_off + (2 * STAGES + 1) * 8;  // full, empty, words
  return l;
}

// Four bf16 values (+-1 or 0), two per word, as four s8 bytes.
__device__ __forceinline__ unsigned s8x4(unsigned a, unsigned b) {
  const int v0 = __float2int_rn(__uint_as_float(a << 16));
  const int v1 = __float2int_rn(__uint_as_float(a & 0xffff0000u));
  const int v2 = __float2int_rn(__uint_as_float(b << 16));
  const int v3 = __float2int_rn(__uint_as_float(b & 0xffff0000u));
  return (unsigned)(v0 & 0xff) | (unsigned)(v1 & 0xff) << 8 | (unsigned)(v2 & 0xff) << 16 |
         (unsigned)(v3 & 0xff) << 24;
}

template <int C, typename S>
__global__ void __launch_bounds__((C + 1) * WG, 1)
packed_scores_bmax_kernel(const __nv_bfloat16* __restrict__ queries,
                          const int32_t* __restrict__ words,
                          const float* __restrict__ penalty, S* __restrict__ scores,
                          float* __restrict__ bmax, int q, int n, int bits,
                          int valid_count) {
  constexpr int BQ = C * 64;  // queries per tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout<S>(C, bits);
  unsigned char* slots = smem;  // the ring of unpacked slices
  unsigned char* qa = smem + l.a_off;  // [bits / 128][BQ rows][128 bytes], swizzled
  S* staging = reinterpret_cast<S*>(smem + l.stage_off);
  int32_t* ws = reinterpret_cast<int32_t*>(smem + l.words_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* words_ready = empty + STAGES;

  const int n_pb = n / SLOTS;
  const int tiles = (q + BQ - 1) / BQ * n_pb;
  const int k_slices = bits / KS;
  const int n_buckets = n / BUCKET;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();  // the 128-byte swizzle needs it
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], WG);
      mbar_init(&empty[s], 4 * C);
    }
    mbar_init(words_ready, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {
    // ---- producer: unpack into the ring ----
    if constexpr (C == 2) reg_dealloc<56>();
    const int pt = threadIdx.x - C * WG, pw = pt / 32, lane = pt % 32;
    // lane's 4 bytes of a 128-byte row: 16-byte chunk lane / 4, swizzled by row
    const int lane_byte = (lane & 3) * 4;
    Ring ring;
    uint32_t words_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int pb = t % n_pb;
      // one bulk copy of the pack block's words, once the last tile's
      // unpack is done with them
      named_sync(PRODUCER_BAR, WG);
      if (pt == 0) {
        const uint32_t bytes = PACK_ROWS * bits * 4;
        fence_proxy_async();
        mbar_arrive_expect_tx(words_ready, bytes);
        bulk_load(ws, words + (size_t)pb * PACK_ROWS * bits, bytes, words_ready);
      }
      mbar_wait(words_ready, words_phase);
      words_phase ^= 1;
      for (int b = 0; b < BUCKETS; ++b) {
        const unsigned j = 2u * b;
        for (int ks = 0; ks < k_slices; ++ks) {
          mbar_wait(&empty[ring.slot], ring.phase ^ 1);
          unsigned char* dst = slots + ring.slot * SLOT_BYTES;
          // warp pw: packed rows pw * 16 .. pw * 16 + 15; lane: 4 code bits
          const int32_t* wk = ws + ks * KS + lane * 4;
#pragma unroll 4
          for (int i = 0; i < 16; ++i) {
            const int s = pw * 16 + i;
            const int4 w = *reinterpret_cast<const int4*>(wk + (size_t)s * bits);
            // bits 2b' (h=0) and 2b'+1 (h=1) of four words, one byte each;
            // shifted as unsigned so bit 31 survives
            const unsigned x = ((unsigned)w.x >> j & 3u) | ((unsigned)w.y >> j & 3u) << 8 |
                               ((unsigned)w.z >> j & 3u) << 16 | ((unsigned)w.w >> j & 3u) << 24;
            // per byte: bit 1 -> 0x01 (+1), bit 0 -> 0xFF (-1)
            const unsigned lo = ~((x & 0x01010101u) * 0xFEu);
            const unsigned hi = ~((x >> 1 & 0x01010101u) * 0xFEu);
            const int off = (((lane >> 2) ^ (s & 7)) << 4) + lane_byte;
            *reinterpret_cast<unsigned*>(dst + s * KS + off) = lo;
            *reinterpret_cast<unsigned*>(dst + (PACK_ROWS + s) * KS + off) = hi;
          }
          fence_proxy_async();
          mbar_arrive(&full[ring.slot]);
          ring.advance(STAGES);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. wg * 64 + 63 ----
    if constexpr (C == 2) reg_alloc<224>();
    const int tid = threadIdx.x % WG, lane = threadIdx.x % 32;
    S* stage = staging + wg * 64 * STAGE_LD;
    Ring ring;
    int cur_qt = -1;
    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int qt = t / n_pb, pb = t % n_pb;
      const int wq0 = qt * BQ + wg * 64;
      const bool active = wq0 < q;
      if (qt != cur_qt) {
        // the warpgroup's query rows as s8, resident until the query tile
        // changes; rows past q are zero
        cur_qt = qt;
        const int cpr = bits / 16;  // 16-byte s8 chunks per row
        for (int i = tid; active && i < 64 * cpr; i += WG) {
          const int r = i / cpr, kc = (i % cpr) * 16;
          uint4 a = make_uint4(0u, 0u, 0u, 0u), c = a;
          if (wq0 + r < q) {
            const uint4* src =
                reinterpret_cast<const uint4*>(queries + (size_t)(wq0 + r) * bits + kc);
            a = __ldg(src);
            c = __ldg(src + 1);
          }
          const uint4 out = make_uint4(s8x4(a.x, a.y), s8x4(a.z, a.w), s8x4(c.x, c.y),
                                       s8x4(c.z, c.w));
          unsigned char* dst = qa + (kc / KS) * (BQ * KS) + (wg * 64 + r) * KS +
                               ((((kc % KS) >> 4) ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(dst) = out;
        }
        fence_proxy_async();
        named_sync(1 + wg, WG);
      }
      for (int b = 0; b < BUCKETS; ++b) {
        for (int ks = 0; ks < k_slices; ++ks) {
          mbar_wait(&full[ring.slot], ring.phase);
          if (active) {
            const uint64_t da = desc_sw128(qa + ks * (BQ * KS) + wg * 64 * KS);
            const uint64_t db = desc_sw128(slots + ring.slot * SLOT_BYTES);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS / 32; ++kk)
              wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[ring.slot]);
          ring.advance(STAGES);
        }
        if (active) {
          float v[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) v[i] = __int2float_rn(acc[i]);
          bucket_epilogue<S>(v, stage, 1 + wg, penalty, scores, bmax, wq0, q,
                             pb * SLOTS + b * BUCKET, n, valid_count, n_buckets);
        }
      }
    }
  }
}

// ---- the streamed layout: codes whose pack block the resident layout
// cannot stage ----
//
// A bucket's 128 rows need bits 2b' and 2b' + 1 of every word of their pack
// block, so a layout that cannot stage the block (256 bits words, 64 KB at
// 256 bits) reads all its words again for each of its 16 buckets. Instead,
// each call first writes the corpus row-major (K5's layout: word w of row r
// holds its bits 32 w .. 32 w + 31), so that a bucket's K slice is 16 bytes
// a row, and the queries as s8 tiles in the order and sign that
// store_unpacked gives the rows.

constexpr int RELAY_WORDS = 128;  // a packed row's words a relayout pass takes

// rm[r][w] = bits 32 w .. 32 w + 31 of corpus row r (bit t = code bit 32 w +
// t, set for +1). One block per packed row p = 64 G + s: its 32-word groups
// are 32 x 32 bit transposes (bit j of word 32 w + t is bit t of word w of
// row 2048 G + 64 j + s), one warp ballot per output word, staged in shared
// memory so that each output row's words are stored together.
__global__ void __launch_bounds__(256)
relayout_rows_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ rm, int bits) {
  __shared__ uint32_t t[32][RELAY_WORDS + 1];
  const int p = blockIdx.x, g = p / PACK_ROWS, s = p % PACK_ROWS;
  const int w_total = bits / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t* src = words + (size_t)p * bits;
  for (int w0 = 0; w0 < w_total; w0 += RELAY_WORDS) {
    const int cw = min(RELAY_WORDS, w_total - w0);
    for (int w = warp; w < cw; w += 8) {
      const uint32_t in = __ldg(src + (size_t)(w0 + w) * 32 + lane);
      uint32_t mine = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t b = __ballot_sync(0xffffffffu, (in >> j) & 1u);
        if (lane == j) mine = b;
      }
      t[lane][w] = mine;  // word w0 + w of row 64 lane + s of the block
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * cw; i += 256) {
      const int j = i / cw, w = i % cw;
      rm[((size_t)g * SLOTS + (size_t)j * PACK_ROWS + s) * w_total + w0 + w] = t[j][w];
    }
    __syncthreads();
  }
}

// The queries as s8 tiles in the layout of a ring slot's query slice:
// [tile][bits / 128][BQ rows][128 bytes], 128-byte swizzled, rows past q
// zero; negated, and within each 32 columns in store_unpacked's order (byte
// 4 g + k holds column g + 8 k), so that against the rows' unpack (a set
// bit -1) every product is that of the code's +-1 in column order. One
// thread per 32 columns.
template <int BQ>
__global__ void queries_to_s8_kernel(const __nv_bfloat16* __restrict__ queries,
                                     unsigned char* __restrict__ out, int q, int bits,
                                     long long groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int gpr = bits / 32;  // 32-column groups per row
  const int row = (int)(i / gpr), c0 = (int)(i % gpr) * 32;
  uint32_t o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (row < q) {
    const uint4* src = reinterpret_cast<const uint4*>(queries + (size_t)row * bits + c0);
    uint32_t h[16];  // the 32 bf16 values, two a word
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 a = __ldg(src + v);
      h[4 * v] = a.x;
      h[4 * v + 1] = a.y;
      h[4 * v + 2] = a.z;
      h[4 * v + 3] = a.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = g + 8 * k;  // bf16 c: the low half of word c / 2 when c is even
        const uint32_t bf = c % 2 ? h[c / 2] & 0xffff0000u : h[c / 2] << 16;
        o[g] |= (uint32_t)(-__float2int_rn(__uint_as_float(bf)) & 0xff) << (8 * k);
      }
  }
  const int qt = row / BQ, r = row % BQ, ks = c0 / KS, wi = (c0 % KS) / 32;
  unsigned char* dst = out + (((size_t)qt * (bits / KS) + ks) * BQ + r) * KS;
  *reinterpret_cast<uint4*>(dst + (((2 * wi) ^ (r & 7)) << 4)) =
      make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + (((2 * wi + 1) ^ (r & 7)) << 4)) =
      make_uint4(o[4], o[5], o[6], o[7]);
}

constexpr int RAW_SLICES = 8;  // corpus K slices in flight to the producer

struct StreamLayout {
  int a_off, raw_off, stage_off, bar_off, bytes;
};

// the ring of corpus slices, beside it one [C * 64 x 128] query slice a
// slot; the producer's raw words, [RAW_SLICES][128 rows][16 bytes]; the
// epilogue's staging; the barriers
template <typename S>
__host__ __device__ StreamLayout stream_layout(int consumers) {
  StreamLayout l;
  l.a_off = STAGES * SLOT_BYTES;
  l.raw_off = l.a_off + STAGES * consumers * 64 * KS;
  l.stage_off = l.raw_off + RAW_SLICES * BUCKET * 16;
  l.bar_off = l.stage_off + consumers * staging_bytes<S>();
  l.bytes = l.bar_off + 2 * STAGES * 8;  // full, empty
  return l;
}

// cp.async of 16 bytes, its groups and their wait (each producer thread
// copies, and later reads, only its own row's bytes: no barrier between)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slices of a block in the order producer and consumers take them:
// (tile t, bucket b, K slice ks), K slices fastest, tiles t0, t0 + stride.
struct Cursor {
  int t, b = 0, ks = 0;
  __device__ __forceinline__ void next(int k_slices, int stride) {
    if (++ks == k_slices) {
      ks = 0;
      if (++b == BUCKETS) {
        b = 0;
        t += stride;
      }
    }
  }
};

// The same tiles, scores and epilogue as packed_scores_bmax_kernel, from the
// row-major corpus `rm` and the s8 query tiles `q_tiles`. Each producer
// thread owns one row of the bucket: its 16 bytes of a K slice come from
// device memory by cp.async, 7 slices ahead of their unpack
// (store_unpacked, as K5's producer); with each corpus slice, producer thread 0 bulk-copies the
// tile's query slice into the same ring slot (one more arrival on the
// slot's full barrier, with the copy's bytes). Consumers run one wgmma
// group behind the next, as K5's do; the s32 accumulators add up every
// slice of the bucket before the epilogue.
template <int C, typename S>
__global__ void __launch_bounds__((C + 1) * WG, 1)
packed_scores_bmax_stream_kernel(const unsigned char* __restrict__ q_tiles,
                                 const uint4* __restrict__ rm, const float* __restrict__ penalty,
                                 S* __restrict__ scores, float* __restrict__ bmax, int q, int n,
                                 int bits, int valid_count) {
  constexpr int BQ = C * 64;  // queries per tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const StreamLayout l = stream_layout<S>(C);
  unsigned char* slots = smem;         // [STAGES][128 rows][128 bytes], swizzled
  unsigned char* qa = smem + l.a_off;  // [STAGES][BQ rows][128 bytes], swizzled
  S* staging = reinterpret_cast<S*>(smem + l.stage_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bar_off);
  uint64_t* empty = full + STAGES;

  const int n_pb = n / SLOTS;
  const int tiles = (q + BQ - 1) / BQ * n_pb;
  const int k_slices = bits / KS;  // also a row's 16-byte vectors in rm
  const int n_buckets = n / BUCKET;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();  // the 128-byte swizzle needs it
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], WG + 1);  // the producer threads and the query slice's copy
      mbar_init(&empty[s], 4 * C);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {
    // ---- producer: row pt of each bucket ----
    if constexpr (C == 2) reg_dealloc<56>();
    const int pt = threadIdx.x - C * WG;
    // the row's 16 bytes of a slice, RAW_SLICES - 1 slices ahead of their
    // unpack, by cp.async into the thread's own place of a raw slot (one
    // group a slice, empty past the last tile)
    const uint32_t raw = smem_u32(smem + l.raw_off) + pt * 16;
    const uint4* raw_row = reinterpret_cast<const uint4*>(smem + l.raw_off) + pt;
    auto fetch = [&](const Cursor& c, int slot) {
      if (c.t < tiles) {
        const size_t row = (size_t)(c.t % n_pb) * SLOTS + c.b * BUCKET + pt;
        cp_async16(raw + slot * BUCKET * 16, rm + row * k_slices + c.ks);
      }
      cp_async_commit();
    };
    Cursor cur{(int)blockIdx.x}, ahead = cur;
    for (int i = 0; i < RAW_SLICES - 1; ++i, ahead.next(k_slices, gridDim.x)) fetch(ahead, i);
    Ring ring;
    for (int rs = 0; cur.t < tiles;
         cur.next(k_slices, gridDim.x), rs = rs + 1 == RAW_SLICES ? 0 : rs + 1) {
      // refill the slot the last slice was read from, then wait for this one
      fetch(ahead, rs == 0 ? RAW_SLICES - 1 : rs - 1);
      ahead.next(k_slices, gridDim.x);
      cp_async_wait<RAW_SLICES - 1>();
      const uint4 v0 = raw_row[rs * BUCKET];
      mbar_wait(&empty[ring.slot], ring.phase ^ 1);
      if (pt == 0) {
        const unsigned char* src = q_tiles + ((size_t)(cur.t / n_pb) * k_slices + cur.ks) * BQ * KS;
        mbar_arrive_expect_tx(&full[ring.slot], BQ * KS);
        bulk_load(qa + ring.slot * BQ * KS, src, BQ * KS, &full[ring.slot]);
      }
      unsigned char* dst = slots + ring.slot * SLOT_BYTES + pt * KS;
      store_unpacked(dst, pt, 0, v0.x);
      store_unpacked(dst, pt, 1, v0.y);
      store_unpacked(dst, pt, 2, v0.z);
      store_unpacked(dst, pt, 3, v0.w);
      fence_proxy_async();  // the stores before the wgmma reads
      mbar_arrive(&full[ring.slot]);
      ring.advance(STAGES);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. wg * 64 + 63 ----
    if constexpr (C == 2) reg_alloc<224>();
    const int lane = threadIdx.x % 32;
    S* stage = staging + wg * 64 * STAGE_LD;
    Ring ring;
    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int pb = t % n_pb;
      const int wq0 = t / n_pb * BQ + wg * 64;
      for (int b = 0; b < BUCKETS; ++b) {
        // one group queued behind the running one; a warpgroup past q
        // multiplies the zero rows of its tile rather than branch around
        // the wgmma (a divergent path would serialize every wgmma)
        int held = -1;
        for (int ks = 0; ks < k_slices; ++ks) {
          mbar_wait(&full[ring.slot], ring.phase);
          const uint64_t da = desc_sw128(qa + ring.slot * BQ * KS + wg * 64 * KS);
          const uint64_t db = desc_sw128(slots + ring.slot * SLOT_BYTES);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS / 32; ++kk)
            wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (held >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[held]);
          }
          held = ring.slot;
          ring.advance(STAGES);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[held]);
        if (wq0 < q) {
          float v[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) v[i] = __int2float_rn(acc[i]);
          bucket_epilogue<S>(v, stage, 1 + wg, penalty, scores, bmax, wq0, q,
                             pb * SLOTS + b * BUCKET, n, valid_count, n_buckets);
        }
      }
    }
  }
}

template <int C, typename S>
cudaError_t launch(const void* queries, const void* words, const void* penalty, void* scores,
                   void* bmax, int q, int n, int bits, int valid_count, cudaStream_t stream) {
  const int bytes = layout<S>(C, bits).bytes;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_scores_bmax_kernel<C, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((q + C * 64 - 1) / (C * 64)) * (n / SLOTS);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < sms ? tiles : sms);
  packed_scores_bmax_kernel<C, S><<<grid, (C + 1) * WG, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(queries), static_cast<const int32_t*>(words),
      static_cast<const float*>(penalty), static_cast<S*>(scores), static_cast<float*>(bmax),
      q, n, bits, valid_count);
  return cudaGetLastError();
}

// The streamed kernel of C consumer warpgroups, behind its two passes: the
// row-major corpus (n bits / 8 bytes) and the s8 query tiles (ceil(q / 64
// C) * 64 C * bits bytes) in one stream-ordered scratch buffer, freed after
// the scan (268 MB and 2 MB at q=1024, n=2^20, 2,048 bits).
template <int C, typename S>
cudaError_t launch_stream(const void* queries, const void* words, const void* penalty,
                          void* scores, void* bmax, int q, int n, int bits, int valid_count,
                          cudaStream_t stream) {
  constexpr int BQ = C * 64;
  const int bytes = stream_layout<S>(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(packed_scores_bmax_stream_kernel<C, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((q + BQ - 1) / BQ) * (n / SLOTS);
  const long long groups = (long long)((q + BQ - 1) / BQ) * BQ * (bits / 32);
  if (tiles > 0x7fffffffLL || (groups + 255) / 256 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const size_t rm_bytes = (size_t)n * (bits / 8);  // a multiple of 16
  void* scratch = nullptr;
  err = cudaMallocAsync(&scratch, rm_bytes + (size_t)groups * 32, stream);
  if (err != cudaSuccess) return err;
  auto* rm = static_cast<uint32_t*>(scratch);
  auto* q_tiles = static_cast<unsigned char*>(scratch) + rm_bytes;
  relayout_rows_kernel<<<n / 32, 256, 0, stream>>>(static_cast<const uint32_t*>(words), rm,
                                                   bits);
  queries_to_s8_kernel<BQ><<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(queries), q_tiles, q, bits, groups);
  const int grid = (int)(tiles < sms ? tiles : sms);
  packed_scores_bmax_stream_kernel<C, S><<<grid, (C + 1) * WG, bytes, stream>>>(
      q_tiles, reinterpret_cast<const uint4*>(rm), static_cast<const float*>(penalty),
      static_cast<S*>(scores), static_cast<float*>(bmax), q, n, bits, valid_count);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(scratch, stream);
  return err != cudaSuccess ? err : freed;
}

template <typename S>
cudaError_t dispatch(const void* queries, const void* words, const void* penalty, void* scores,
                     void* bmax, int q, int n, int bits, int valid_count, cudaStream_t stream) {
  // the resident layout (128 queries) where the pack block's words fit
  // beside the query tile; every other width streams
  if (bits <= MAX_SMEM / (PACK_ROWS * 4) && layout<S>(2, bits).bytes <= MAX_SMEM)
    return launch<2, S>(queries, words, penalty, scores, bmax, q, n, bits, valid_count, stream);
  return launch_stream<2, S>(queries, words, penalty, scores, bmax, q, n, bits, valid_count,
                             stream);
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty may be null. queries: [q, bits] bf16; words: [n / 32,
// bits] int32 with n a multiple of 2048 and bits any positive multiple of
// 128, both 16-byte aligned; scores: [q, n] (out_bf16: 1 = bf16, 0 =
// f32); bmax: [q, n / 128] f32. Launches on `stream`, returns the launch's
// cudaError_t (0 = success) and does not synchronize.
extern "C" int sss_packed_scores_bmax(const void* queries, const void* words,
                                      const void* penalty, void* scores, void* bmax, int q,
                                      int n, int bits, int valid_count, int out_bf16,
                                      void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (n % SLOTS != 0 || bits % 128 != 0 || bits <= 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? dispatch<__nv_bfloat16>(queries, words, penalty, scores, bmax, q, n, bits,
                                         valid_count, s)
               : dispatch<float>(queries, words, penalty, scores, bmax, q, n, bits,
                                 valid_count, s);
  return static_cast<int>(err);
}
