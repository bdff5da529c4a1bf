// Fused int8 x int8 score scan + 128-row bucket max, built for Hopper:
// TMA-fed s8 wgmma on the warp-specialised, persistent pipeline of K1's
// bf16 variant (sm_90a). K2's variant for int8 rows that TMA can describe.
//
// Replaces the TPU kernel sessionsimilaritysearch_tpu/ops/pallas_mips.py:428
// (_scores_bmax_int8_kernel, launched by scores_with_bucket_max_int8 :465,
// :498), the scan of DenseIndex(quantize='int8x8'), for int8 query codes
// [q, d] and int8 corpus codes [n, d] with d % 16 == 0 and 16-byte-aligned
// query, corpus and scale bases (TMA's stride and address rule). Its
// contract is scores_bmax_int8.cu's, which keeps the rows TMA cannot
// describe (ops/mips_int8.py k2_variant chooses):
//   scores[i, r] = f32(<qcodes[i], ccodes[r]>) * scales[r], the dot summed
//                  exactly in int32, both roundings to nearest
//                  (__int2float_rn, then __fmul_rn); -inf for r >=
//                  valid_count, then plus penalty[r]; stored in f32 or bf16;
//   bmax[i, b]   = max of the f32 values of scores[i, 128 b .. 128 b + 127],
//                  taken before rounding to the score dtype.
//
// What bounds it on an H100: at q=1024, n=2^20, d=1600 the call is 3.44e12
// int8 operations (1.74 ms at 1,979 TOP/s) against 1.68 GB of corpus codes
// and 4.3 GB of f32 scores (1.79 ms at 3.35 TB/s); with bf16 scores the
// operations bound it.
//
// Design: sm90_tma.cuh's ring, producer and grid with an int8 tensor map
// (128-value K slices: at d = 1600, 12.5 of them, TMA zero-filling the last
// half slice, and zero codes add nothing to an int32 dot). Two consumer
// warpgroups of 64 queries each issue, per 32-byte K step, two wgmma
// m64n128k32 s8, one per 128-row bucket (the second bucket's B operand is
// 128 rows = 16 KB on), into int32_t acc[2][64]: 128 registers, as K1's
// f32 accumulator. A thread's 32 scales of each bucket are read through
// __ldg at the tile's start, so their latency hides behind the products
// (read in the epilogue, behind branches on n, they cost ~2 ms at the bench
// point on an H100: PERF.md). The epilogue dequantises one bucket at a time (the
// accumulator is zeroed at each tile's start, so a bucket's int32 values
// die as their f32 values are made and the registers are reused), then runs
// K1's bucket_epilogue: mask, penalty, bucket max from registers, 16-byte
// streaming stores.

#include "sm90_tma.cuh"

namespace {

using namespace sm90;

// This thread's scales of the tile's two buckets: sc[h][2i + e] is the
// scale of column i * 8 + (lane % 4) * 2 + e of bucket h, the columns of
// the wgmma accumulator layout. Branch-free, so all 64 loads are in flight
// together; a column at or past n reads scales[n - 1], and the epilogue
// masks that column to -inf whatever its value.
__device__ __forceinline__ void load_scales(float (&sc)[2][32], const float* __restrict__ scales,
                                            int n0, int n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + h * BUCKET + i * 8 + (lane % 4) * 2;
      sc[h][2 * i] = __ldg(scales + min(col, n - 1));
      sc[h][2 * i + 1] = __ldg(scales + min(col + 1, n - 1));
    }
}

// v[j] = f32(acc[j]) * the scale of its column, each rounded to nearest
// (acc[j] is column (j / 4) * 8 + (lane % 4) * 2 + j % 2 of the bucket).
__device__ __forceinline__ void dequantise(const int32_t (&acc)[64], const float (&sc)[32],
                                           float (&v)[64]) {
#pragma unroll
  for (int j = 0; j < 64; j += 4) {
    v[j] = __fmul_rn(__int2float_rn(acc[j]), sc[j / 2]);
    v[j + 1] = __fmul_rn(__int2float_rn(acc[j + 1]), sc[j / 2 + 1]);
    v[j + 2] = __fmul_rn(__int2float_rn(acc[j + 2]), sc[j / 2]);
    v[j + 3] = __fmul_rn(__int2float_rn(acc[j + 3]), sc[j / 2 + 1]);
  }
}

template <typename S>
__global__ void __launch_bounds__(THREADS, 1)
scores_bmax_int8_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap cmap,
                             const float* __restrict__ scales,
                             const float* __restrict__ penalty, S* __restrict__ scores,
                             float* __restrict__ bmax, int q, int n, int d, int valid_count) {
  constexpr int ST = stages<S>();
  extern __shared__ __align__(1024) unsigned char smem[];
  S* staging = reinterpret_cast<S*>(smem + ST * SLOT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SLOT_BYTES + 2 * staging_bytes<S>());
  uint64_t* empty = full + ST;

  const int q_tiles = (q + BM - 1) / BM;
  const int tiles = q_tiles * ((n + BN - 1) / BN);
  const int k_steps = (d + K_BYTES - 1) / K_BYTES;
  const int n_buckets = (n + BUCKET - 1) / BUCKET;
  const int wg = threadIdx.x / WG;
  ring_init<ST>(smem, full, empty);

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    reg_dealloc<40>();
    if (threadIdx.x == 2 * WG)
      produce<ST, 1>(smem, full, empty, &qmap, &cmap, q_tiles, tiles, k_steps);
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. wg * 64 + 63 ----
    reg_alloc<232>();
    const int lane = threadIdx.x % 32;
    S* stage = staging + wg * 64 * STAGE_LD;
    Ring ring;
    int32_t acc[2][64];
    float sc[2][32];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t / q_tiles) * BN;
      const int wq0 = (t % q_tiles) * BM + wg * 64;
      const bool active = wq0 < q;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
      // every warpgroup reads them, active or not: with the read under
      // `if (active)` ptxas spills 312 bytes of the f32 instantiation
      load_scales(sc, scales, n0, n);
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[ring.slot], ring.phase);
        if (active) {
          const unsigned char* slot = smem + ring.slot * SLOT_BYTES;
          const uint64_t da = desc_sw128(slot + wg * 64 * K_BYTES);
          const uint64_t db0 = desc_sw128(slot + A_BYTES);
          const uint64_t db1 = desc_sw128(slot + A_BYTES + BUCKET * K_BYTES);
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < K_BYTES / 32; ++kk) {
            wgmma_m64n128k32_s8(acc[0], da + 2 * kk, db0 + 2 * kk, 1);
            wgmma_m64n128k32_s8(acc[1], da + 2 * kk, db1 + 2 * kk, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ring.slot]);
        ring.advance(ST);
      }
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = n0 + h * BUCKET;
          if (c0 < n) {
            float v[64];
            dequantise(acc[h], sc[h], v);
            bucket_epilogue<S>(v, stage, 1 + wg, penalty, scores, bmax, wq0, q, c0, n,
                               valid_count, n_buckets);
          }
        }
      }
    }
  }
}

// Returns a cudaError_t (>= 0), or minus the CUresult of a failed encode.
template <typename S>
int launch(const void* queries, const void* corpus, const void* scales, const void* penalty,
           void* scores, void* bmax, int q, int n, int d, int valid_count, cudaStream_t stream) {
  CUtensorMap qmap, cmap;
  const int res = encode_operands<1>(CU_TENSOR_MAP_DATA_TYPE_UINT8, queries, corpus, q, n, d,
                                     &qmap, &cmap);
  if (res != 0) return res;
  constexpr int bytes = smem_bytes<S>();
  int grid = 0;
  const cudaError_t err = persistent_grid(scores_bmax_int8_sm90_kernel<S>, bytes, q, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  scores_bmax_int8_sm90_kernel<S><<<grid, THREADS, bytes, stream>>>(
      qmap, cmap, static_cast<const float*>(scales), static_cast<const float*>(penalty),
      static_cast<S*>(scores), static_cast<float*>(bmax), q, n, d, valid_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes (ops/_build.py). Pointers are device
// pointers; queries [q, d] and corpus [n, d] int8 with d % 16 == 0, scales
// [n] f32, all three 16-byte aligned; penalty may be null; out_bf16 selects
// the score dtype (1 = bf16, 0 = f32). Launches on `stream` and does not
// synchronize. Returns 0 on success, a cudaError_t, or minus the CUresult
// of a failed cuTensorMapEncodeTiled.
extern "C" int sss_scores_bmax_int8_sm90(const void* queries, const void* corpus,
                                         const void* scales, const void* penalty, void* scores,
                                         void* bmax, int q, int n, int d, int valid_count,
                                         int out_bf16, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (d <= 0 || d % 16 != 0 || reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(corpus) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scales) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(queries, corpus, scales, penalty, scores, bmax, q, n,
                                          d, valid_count, s)
                  : launch<float>(queries, corpus, scales, penalty, scores, bmax, q, n, d,
                                  valid_count, s);
}
