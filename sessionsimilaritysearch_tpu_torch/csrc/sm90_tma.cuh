// The TMA-fed mainloop of the Hopper score kernels (sm_90a), shared by K1's
// bf16 variant and K6 (scores_bmax_sm90.cu), K1's and K6's f32 variant
// (scores_bmax_f32_sm90.cu) and K2's int8 variant (scores_bmax_int8_sm90.cu).
// Each kernel brings its own wgmma and epilogue.
//
// - The tile is 128 queries x TN corpus rows: 256 (two 128-row buckets) for
//   bf16 and int8, 128 for f32. A ring slot holds one 128-byte K slice of
//   both, 16 KB + TN * 128 bytes, written by TMA in the 128-byte swizzle that
//   desc_sw128 describes: 32 f32, 64 bf16 or 128 int8 values a row; the f32
//   kernel's slot also holds room for the corpus slice's small parts. Reads
//   past q, n or d fill zeros, which add nothing to a dot; the full barrier
//   still counts the whole box.
// - The producer: one thread walks the block's tiles (persistent, one block
//   per SM, the query tile fastest, so the blocks that share a corpus tile
//   run together and it comes from HBM once) and keeps the ring full.
//   Full barriers count the TMA bytes; empty barriers count the 8 consumer
//   warps.
// - bf16 rows that TMA cannot describe (d % 8 != 0 or bases not 16-byte
//   aligned, but d even and bases 4-byte aligned) fill the same ring with
//   the cp.async producer of sm90_cp_async.cuh instead: the same slots,
//   layout and tile order, full barriers counting its 128 threads.
// - The host side: one tensor map per operand, encoded per call with
//   cuTensorMapEncodeTiled, reached through the runtime's driver entry point
//   (no -lcuda); the dynamic shared-memory attribute and the grid.

#pragma once

#include <cuda.h>

#include "sm90_common.cuh"

namespace sm90 {

constexpr int BM = 128;                       // queries per tile
constexpr int BN = 256;                       // corpus rows per tile (two buckets)
constexpr int K_BYTES = 128;                  // bytes of depth per ring slot
constexpr int A_BYTES = BM * K_BYTES;         // 16 KB
constexpr int B_BYTES = BN * K_BYTES;         // 32 KB
constexpr int SLOT_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 3 * WG;               // two consumer warpgroups, one producer
constexpr int MAX_SMEM = 232448;

// ring slots: 4 for bf16 scores, 3 for f32 scores, whose staging tile is
// twice as large
template <typename S> __host__ __device__ constexpr int stages() { return sizeof(S) == 2 ? 4 : 3; }
// the ring, the two consumers' staging tiles, then the full and empty barriers
template <typename S> __host__ __device__ constexpr int smem_bytes() {
  return stages<S>() * SLOT_BYTES + 2 * staging_bytes<S>() + 2 * stages<S>() * 8;
}
static_assert(smem_bytes<__nv_bfloat16>() <= MAX_SMEM, "bf16 ring too large");
static_assert(smem_bytes<float>() <= MAX_SMEM, "f32 ring too large");

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Thread 0 sets up the ring's barriers; the whole block waits for it. A
// full barrier counts `full_count` producer arrivals: 1 for the TMA
// producer (the bytes are counted as transactions), the warpgroup's 128
// threads for the cp.async producer (sm90_cp_async.cuh).
template <int ST>
__device__ __forceinline__ void ring_init(const unsigned char* smem, uint64_t* full,
                                          uint64_t* empty, uint32_t full_count = 1) {
  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();  // the 128-byte swizzle needs it
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The producer thread: for each tile t of this block, query tile
// t % q_tiles and corpus tile t / q_tiles, the k_steps K slices of both
// into the ring of ST slots at smem, SLOT bytes apart. ELEM is the
// operand's element size in bytes, TN the corpus rows of a tile.
template <int ST, int ELEM, int TN = BN, int SLOT = SLOT_BYTES>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* qmap, const CUtensorMap* cmap,
                                        int q_tiles, int tiles, int k_steps) {
  constexpr int BOX_K = K_BYTES / ELEM;
  constexpr int TX = A_BYTES + TN * K_BYTES;  // the bytes TMA lands in a slot
  static_assert(TX <= SLOT && SLOT % 1024 == 0, "slot layout");
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int q0 = (t % q_tiles) * BM, n0 = (t / q_tiles) * TN;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&empty[ring.slot], ring.phase ^ 1);
      unsigned char* slot = smem + ring.slot * SLOT;
      mbar_arrive_expect_tx(&full[ring.slot], TX);
      tma_load_2d(slot, qmap, ks * BOX_K, q0, &full[ring.slot]);
      tma_load_2d(slot + A_BYTES, cmap, ks * BOX_K, n0, &full[ring.slot]);
      ring.advance(ST);
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda. Errors come back as cudaError_t.
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err != cudaSuccess) return err;
    if (res != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A [rows, d] row-major operand of `type` (ELEM bytes an element; d * ELEM
// a multiple of 16) in boxes of 128 bytes x box_rows, 128-byte swizzled;
// reads past the edges fill zeros.
template <int ELEM>
CUresult encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, const void* base,
                int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * ELEM};
  const cuuint32_t box[2] = {(cuuint32_t)(K_BYTES / ELEM), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The tensor maps of queries [q, d] (boxes of BM rows) and corpus [n, d]
// (TN rows). Returns 0, a cudaError_t, or minus the CUresult of a failed
// encode.
template <int ELEM, int TN = BN>
int encode_operands(CUtensorMapDataType type, const void* queries, const void* corpus, int q,
                    int n, int d, CUtensorMap* qmap, CUtensorMap* cmap) {
  EncodeTiled fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUresult res = encode<ELEM>(fn, qmap, type, queries, q, d, BM);
  if (res == CUDA_SUCCESS) res = encode<ELEM>(fn, cmap, type, corpus, n, d, TN);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

// Gives `kernel` `bytes` of dynamic shared memory and sets *grid to one
// block per SM, or one per tile of BM x TN where there are fewer tiles than
// SMs.
template <int TN = BN, typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int bytes, int q, int n, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((q + BM - 1) / BM) * ((n + TN - 1) / TN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = (int)(tiles < sms ? tiles : sms);
  return cudaSuccess;
}

}  // namespace sm90
