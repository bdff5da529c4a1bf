// Hopper building blocks of the warp-specialised kernels (sm_90a): K1's
// bf16 variant and K6 (scores_bmax_sm90.cu), K1's and K6's f32 variant
// (scores_bmax_f32_sm90.cu), K2's int8 variant (scores_bmax_int8_sm90.cu)
// and K4 (packed_scores_bmax.cu). The TMA ring that all but K4 share is in
// sm90_tma.cuh, its cp.async producer in sm90_cp_async.cuh.
//
// - mbarriers and the ring position that producer and consumers walk;
// - wgmma (bf16 m64n256k16 and s8 m64n128k32 with both operands K-major
//   in shared memory, tf32 m64n128k8 with A from registers) and its
//   descriptor for the 128-byte swizzle, the layout TMA writes with
//   CU_TENSOR_MAP_SWIZZLE_128B; the small part of the 3xTF32 split;
// - the unpack of a 32-bit sign-code word into 32 s8 values of the 128-byte
//   swizzled layout (K5, K4's streamed layout);
// - the bucket epilogue both kernels run on a consumer warpgroup's f32
//   accumulator: the valid_count mask, the penalty, the 128-row bucket max
//   straight from registers (a quad of lanes holds a query row's columns),
//   and the score store through shared memory with 16-byte stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int BUCKET = 128;   // corpus rows per bucket
constexpr int WG = 128;       // threads per warpgroup
// epilogue staging of one bucket per consumer warpgroup: 64 rows x 128
// columns, rows padded to 136 elements (16-byte aligned; the accumulator's
// pair writes hit 32 distinct banks)
constexpr int STAGE_LD = BUCKET + 8;
template <typename S> __host__ __device__ constexpr int staging_bytes() { return 64 * STAGE_LD * (int)sizeof(S); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed. A wait
// of more than ~2^34 cycles (seconds) can only be a broken pipeline: it
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// One contiguous copy of `bytes` (a multiple of 16) from device memory into
// shared memory, counted on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Slot and phase parity of a ring of `stages` shared-memory slots. Full
// barriers are waited on with `phase`, empty ones with `phase ^ 1` (a fresh
// barrier counts as released).
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a K-major operand tile in the 128-byte swizzle: 128-byte
// rows, 8-row groups 1024 bytes apart (SBO), the tile 1024-byte aligned. A
// step of 32 bytes along K adds 2 to the descriptor (its address field
// counts 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, bf16 in, f32 accumulate.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128], uint64_t a, uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, s8 in, s32 accumulate
// (exact). scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
      "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The 64 f32 accumulator operands of an m64n128 wgmma, %0 .. %63.
#define SM90_ACC64_F32(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_ACC64_REGS                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 8] . B[128 x 8]^T, tf32 in (the tensor core reads
// an f32 word as tf32 by ignoring its low 13 bits: the word's value rounded
// toward zero), f32 accumulate; B in shared memory, A from registers: this
// thread's a[0..3] are A's elements (r, k), (r + 8, k), (r, k + 4),
// (r + 8, k + 4) for r = (warp % 4) * 16 + lane / 4 and k = lane % 4. The
// registers are read asynchronously: they must hold their values until the
// wgmma_wait that retires the group. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_ACC64_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SM90_ACC64_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The small part of the 3xTF32 split x = big + small + rest: big is x with
// its low 13 bits cleared (what the tensor core reads of x), x - big is
// exact in f32, and small is x - big rounded to tf32 by adding half a tf32
// ulp to its magnitude and clearing the low 13 bits (round half away from
// zero). |rest| <= 2^-11 |x - big| < 2^-21 |x|.
__device__ __forceinline__ uint32_t tf32_small(float x) {
  const float big = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return (__float_as_uint(__fsub_rn(x, big)) + 0x1000u) & 0xffffe000u;
}

// ---- sign codes as +-1 s8 (K5, and K4's streamed layout) -------------------

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
// product, and the dot, is that of bit 1 -> +1, bit 0 -> -1 in bit order
// (K5's rows and queries; K4's rows, against queries stored in the same
// order and negated).
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

// ---- the bucket epilogue ---------------------------------------------------

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // round to nearest even
}

// One bucket of a consumer warpgroup's tile: its 64 query rows q0 ..
// q0 + 63 against corpus rows c0 .. c0 + 127 (c0 < n, a multiple of 128).
// v holds this thread's 64 f32 values in the wgmma accumulator layout:
// v[j] is row (warp % 4) * 16 + lane / 4 + 8 * ((j / 2) % 2), column
// (j / 4) * 8 + (lane % 4) * 2 + j % 2. Columns at or past valid_count
// become -inf, the penalty is added, the f32 row max goes to
// bmax[row * n_buckets + c0 / 128], and the rounded scores go through the
// warpgroup's staging tile to device memory, 16 bytes a store (element
// stores where rows are not 16-byte aligned or run past n). All 128
// threads of the warpgroup call it; `bar_id` is the warpgroup's own named
// barrier. BMAX = false (K6) compiles to the score store alone: no mask,
// no penalty, no bucket max; penalty, bmax and valid_count are not read.
template <typename S, bool BMAX = true>
__device__ __forceinline__ void bucket_epilogue(float (&v)[64], S* stage, int bar_id,
                                                const float* __restrict__ penalty,
                                                S* __restrict__ scores, float* __restrict__ bmax,
                                                int q0, int q, int c0, int n, int valid_count,
                                                int n_buckets) {
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4;
  if constexpr (BMAX) {
    // a bucket wholly below valid_count with no penalty needs no mask
    const bool masked = penalty != nullptr || c0 + BUCKET > valid_count;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 64; j += 4) {
      const int c = (j / 4) * 8 + (lane % 4) * 2;
      if (masked) {
        const int col = c0 + c;
        float p0 = 0.f, p1 = 0.f;
        if (penalty != nullptr) {
          if (col < n) p0 = __ldg(penalty + col);
          if (col + 1 < n) p1 = __ldg(penalty + col + 1);
        }
        const bool ok0 = col < valid_count, ok1 = col + 1 < valid_count;
        v[j] = (ok0 ? v[j] : -INFINITY) + p0;
        v[j + 1] = (ok1 ? v[j + 1] : -INFINITY) + p1;
        v[j + 2] = (ok0 ? v[j + 2] : -INFINITY) + p0;
        v[j + 3] = (ok1 ? v[j + 3] : -INFINITY) + p1;
      }
      m0 = fmaxf(m0, fmaxf(v[j], v[j + 1]));
      m1 = fmaxf(m1, fmaxf(v[j + 2], v[j + 3]));
      store_pair(stage + r0 * STAGE_LD + c, v[j], v[j + 1]);
      store_pair(stage + (r0 + 8) * STAGE_LD + c, v[j + 2], v[j + 3]);
    }
    // the quad of lanes lane / 4 holds the row's 128 columns
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    if (lane % 4 == 0) {
      const int b = c0 / BUCKET;
      if (q0 + r0 < q) bmax[(size_t)(q0 + r0) * n_buckets + b] = m0;
      if (q0 + r0 + 8 < q) bmax[(size_t)(q0 + r0 + 8) * n_buckets + b] = m1;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 64; j += 4) {
      const int c = (j / 4) * 8 + (lane % 4) * 2;
      store_pair(stage + r0 * STAGE_LD + c, v[j], v[j + 1]);
      store_pair(stage + (r0 + 8) * STAGE_LD + c, v[j + 2], v[j + 3]);
    }
  }
  named_sync(bar_id, WG);

  // the staged bucket out, one row segment of 256 (bf16) or 512 (f32)
  // bytes per 16 or 32 lanes; streaming stores keep the scores from
  // evicting the operands from L2
  constexpr int VEC = 16 / (int)sizeof(S);
  constexpr int CPR = BUCKET / VEC;  // 16-byte chunks per row
  const bool vec = n % VEC == 0;     // every score row starts 16-byte aligned
  for (int i = t; i < 64 * CPR; i += WG) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    if (q0 + r >= q) break;
    const int col = c0 + c;
    S* dst = scores + (size_t)(q0 + r) * n + col;
    const S* src = stage + r * STAGE_LD + c;
    if (vec && col + VEC <= n) {
      __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col + e < n) dst[e] = src[e];
    }
  }
  named_sync(bar_id, WG);  // the staging tile is free again
}

}  // namespace sm90
