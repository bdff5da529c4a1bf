// The cp.async producer of K1's and K6's bf16 Hopper kernel for rows that
// TMA cannot describe (sm_90a): scores_bmax_sm90.cu's kernel with
// PtrOperands, launched by sss_scores_bmax_cp_sm90 and
// sss_scores_matmul_cp_sm90 (ops/mips.py k1_variant = 'cp_async').
//
// With that kernel's consumers and epilogue it replaces the TPU kernels
// sessionsimilaritysearch_tpu/ops/pallas_mips.py:144 (_scores_bmax_kernel,
// launched by scores_with_bucket_max :177, :205) and :247 (_scores_kernel,
// launched by scores_matmul :259, :273) for bf16 queries [q, d] and corpus
// [n, d] whose d is even and whose bases are 4-byte aligned, but which TMA
// cannot describe: TMA needs a row stride that is a multiple of 16 bytes
// and 16-byte-aligned bases. Those are the 250-bit sign codes of
// BinaryIndex(mode='sign') and the ITQ codes of the two-stage 'itq' tier at
// Config().code_len = 250: rows 500 bytes apart. The contract is K1's and
// K6's (scores_bmax_sm90.cu).
//
// What bounds it on an H100: at q=1024, n=2^20, d=250 with bf16 scores the
// call writes 2 GiB of scores and 32 MB of bucket maxes and reads 0.5 GB of
// codes: 0.808 ms at 3.35 TB/s, above its 0.54 TFLOP of products (0.54 ms
// at 989 TFLOP/s). The epilogue's 16-byte streaming stores are the TMA
// variant's; this file only changes how rows reach shared memory.
//
// The producer: the whole third warpgroup fills the ring that TMA fills in
// the other variant (sm90_tma.cuh: 128 x 256 tiles, 128-byte K slices, 4
// slots for bf16 scores, 3 for f32), walking the block's tiles in the same
// order. Each warp copies one row's 128-byte K slice per instruction: lane
// l takes bytes 4l .. 4l + 3 with a 4-byte cp.async (rows 500 bytes apart
// are only 4-byte aligned) and writes them to 16-byte chunk (l / 4) ^
// (row % 8) of the row's 128 bytes: the 128-byte swizzle that desc_sw128
// reads, the layout TMA writes. A slot is 128 query rows and 256 corpus
// rows, 96 instructions per warp. Rows past q or n and depth past d are
// zero-filled where TMA's out-of-bounds fill was: cp.async with src-size 0
// and the operand's base as the source address, so nothing is read past an
// allocation.
//
// Completion: after a slot's copies each thread executes
// cp.async.mbarrier.arrive.noinc on the slot's full barrier, which
// initialised to the warpgroup's 128 arrivals completes once every copy has
// landed; the producer never waits for its own copies and runs ahead as far
// as the ring's empty barriers let it. Each consumer thread runs
// fence.proxy.async after its full-barrier wait, before wgmma reads the
// slot through the async proxy. CUTLASS 4.5.0 hands cp.async-written shared
// memory to GMMA the same way, with cp.async-triggered mbarrier arrivals,
// and fences on neither side:
// cutlass/gemm/collective/sm90_mma_multistage_gmma_ss_warpspecialized.hpp,
// producer_commit(..., cutlass::arch::cpasync_barrier_arrive) at :291 and
// :310, consumer_wait then GMMA at :411. The noinc form is
// cutlass/arch/barrier.h:777 cpasync_barrier_arrive_noinc, which
// sm90_mma_tma_gmma_ss_warpspecialized_fp8_blockwise_scaling.hpp:698 passes
// to producer_commit the same way. The copies carry the .L2::128B prefetch hint. On an NVIDIA
// H100 80GB HBM3 at 700 W (kernel_ablation.py) the sign-mode call takes
// 2.04 ms this way, against 2.52 ms with the first design of the
// completion (one cp.async group per slot, cp.async.wait_group two slots
// back, then each writer's own fence and arrival; 2.20 ms one slot back).

#pragma once

#include "sm90_tma.cuh"

namespace sm90 {

// bf16 operands as plain device pointers: the cp.async producer's source
struct PtrOperands {
  static constexpr bool TMA = false;
  const __nv_bfloat16* q;
  const __nv_bfloat16* c;
};

// 4 bytes from device memory into shared memory; src_bytes 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// An arrival on `bar` once every cp.async this thread has started so far has
// landed; the barrier's expected count is not raised (noinc), so it counts
// as one of the arrivals the barrier was initialised with
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One K slice (bytes 128 ks .. 128 ks + 127 of each row: bf16 columns
// 64 ks .. 64 ks + 63) of operand rows row0 .. row0 + ROWS - 1 into `tile`
// (ROWS x 128 bytes at a shared address, 1024-byte aligned). Warp `warp` of
// the 4 takes rows warp, warp + 4, ...: rows warp + 8j share one swizzle
// phase, rows warp + 4 + 8j the other. Rows at or past `rows` and columns
// at or past d are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_slice(uint32_t tile, const __nv_bfloat16* base, int row0,
                                           int rows, int d, int ks, int warp, int lane) {
  const int col = ks * 64 + 2 * lane;
  // rows warp + 4i for i < live hold data
  int live = 0;
  if (col < d) live = max(0, min(ROWS / 4, (rows - row0 - warp + 3) / 4));
  const __nv_bfloat16* src = base + ((size_t)(row0 + warp) * d + col);
  const size_t step = (size_t)4 * d;
  const uint32_t chunk = lane >> 2, byte = (lane & 3) << 2;
  const uint32_t dst0 = tile + warp * K_BYTES + (((chunk ^ warp) << 4) | byte);
  const uint32_t dst1 = tile + (warp + 4) * K_BYTES + (((chunk ^ (warp + 4)) << 4) | byte);
#pragma unroll 4
  for (int i = 0; i < ROWS / 4; i += 2) {
    cp_async4(dst0 + i * 4 * K_BYTES, i < live ? src : base, i < live ? 4 : 0);
    cp_async4(dst1 + i * 4 * K_BYTES, i + 1 < live ? src + step : base, i + 1 < live ? 4 : 0);
    src += 2 * step;
  }
}

// The producer warpgroup (all 128 threads): for each tile t of this block,
// query tile t % q_tiles and corpus tile t / q_tiles, as sm90_tma.cuh's
// produce walks them, the k_steps K slices of both into the ring of ST
// slots at smem, each slot's full barrier arrived on by every thread's
// copies as they land. The consumers fence for the async proxy after their
// full-barrier wait.
template <int ST>
__device__ __forceinline__ void produce_cp(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                           const __nv_bfloat16* queries,
                                           const __nv_bfloat16* corpus, int q, int n, int d,
                                           int q_tiles, int tiles, int k_steps) {
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const uint32_t ring0 = smem_u32(smem);
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int q0 = (t % q_tiles) * BM, n0 = (t / q_tiles) * BN;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&empty[ring.slot], ring.phase ^ 1);
      const uint32_t slot = ring0 + ring.slot * SLOT_BYTES;
      copy_slice<BM>(slot, queries, q0, q, d, ks, warp, lane);
      copy_slice<BN>(slot + A_BYTES, corpus, n0, n, d, ks, warp, lane);
      cp_async_arrive_noinc(&full[ring.slot]);
      ring.advance(ST);
    }
  }
  cp_async_wait_all();  // no copy outlives its thread
}

}  // namespace sm90
