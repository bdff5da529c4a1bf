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
//   all of 128..1536 bits work.
// - The epilogue (sm90_common.cuh bucket_epilogue) takes the bucket max
//   from registers and writes the scores through shared memory in 16-byte
//   streaming stores.
// Shared memory (bytes): ring 65,536; query tile C * 64 * bits; staging C *
// 17,408 (bf16 scores) or C * 34,816 (f32); the pack block's words
// 256 * bits when they still fit (read from device memory once per tile;
// otherwise every bucket reads them from L2); barriers 72. C = 2 where the
// query tile fits, else 1 (64 queries). At 256 bits with bf16 scores:
// 65,536 + 32,768 + 34,816 + 65,536 + 72 = 198,728 of 232,448.

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
__host__ __device__ Layout layout(int consumers, int bits, bool stage_words) {
  Layout l;
  l.a_off = STAGES * SLOT_BYTES;
  l.stage_off = l.a_off + consumers * 64 * bits;
  l.words_off = l.stage_off + consumers * staging_bytes<S>();
  l.bar_off = l.words_off + (stage_words ? PACK_ROWS * bits * 4 : 0);
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
                          float* __restrict__ bmax, int q, int n, int bits, int valid_count,
                          int stage_words) {
  constexpr int BQ = C * 64;  // queries per tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout<S>(C, bits, stage_words != 0);
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
      const int32_t* wsrc = words + (size_t)pb * PACK_ROWS * bits;
      if (stage_words) {
        // one bulk copy of the pack block's words, once the last tile's
        // unpack is done with them
        named_sync(PRODUCER_BAR, WG);
        if (pt == 0) {
          const uint32_t bytes = PACK_ROWS * bits * 4;
          fence_proxy_async();
          mbar_arrive_expect_tx(words_ready, bytes);
          bulk_load(ws, wsrc, bytes, words_ready);
        }
        mbar_wait(words_ready, words_phase);
        words_phase ^= 1;
        wsrc = ws;
      }
      for (int b = 0; b < BUCKETS; ++b) {
        const unsigned j = 2u * b;
        for (int ks = 0; ks < k_slices; ++ks) {
          mbar_wait(&empty[ring.slot], ring.phase ^ 1);
          unsigned char* dst = slots + ring.slot * SLOT_BYTES;
          // warp pw: packed rows pw * 16 .. pw * 16 + 15; lane: 4 code bits
          const int32_t* wk = wsrc + ks * KS + lane * 4;
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

template <int C, typename S>
cudaError_t launch(const void* queries, const void* words, const void* penalty, void* scores,
                   void* bmax, int q, int n, int bits, int valid_count, cudaStream_t stream) {
  const bool stage_words = layout<S>(C, bits, true).bytes <= MAX_SMEM;
  const int bytes = layout<S>(C, bits, stage_words).bytes;
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
      q, n, bits, valid_count, stage_words ? 1 : 0);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(const void* queries, const void* words, const void* penalty, void* scores,
                     void* bmax, int q, int n, int bits, int valid_count, cudaStream_t stream) {
  // two consumer warpgroups (128 queries) where their query tile fits
  if (layout<S>(2, bits, false).bytes <= MAX_SMEM)
    return launch<2, S>(queries, words, penalty, scores, bmax, q, n, bits, valid_count, stream);
  return launch<1, S>(queries, words, penalty, scores, bmax, q, n, bits, valid_count, stream);
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; penalty may be null. queries: [q, bits] bf16; words: [n / 32,
// bits] int32 with n a multiple of 2048 and bits a multiple of 128 (at most
// 1536), both 16-byte aligned; scores: [q, n] (out_bf16: 1 = bf16, 0 =
// f32); bmax: [q, n / 128] f32. Launches on `stream`, returns the launch's
// cudaError_t (0 = success) and does not synchronize.
extern "C" int sss_packed_scores_bmax(const void* queries, const void* words,
                                      const void* penalty, void* scores, void* bmax, int q,
                                      int n, int bits, int valid_count, int out_bf16,
                                      void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (n % SLOTS != 0 || bits % 128 != 0 || bits <= 0 || bits > 1536 ||
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
