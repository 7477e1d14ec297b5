// LC-RWMD phase 2 on Hopper: the ELL SpMM D[i, j] = sum_p w[i, p] * Z[ids[i, p], j].
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py, spmm_ell_pallas
// (_spmm_blocked_kernel), where scalar prefetch steered one Z-row DMA per
// doc and slot.
//
// What bounds it: memory.  Each doc row reads h ids and h weights and
// writes B outputs; the Z rows it gathers are v_e*B*4 bytes in all (18.7 MB
// at v_e=73,123, B=64), which fit the H100's 50 MB L2, so the gathers hit
// L2 and the HBM floor is the ids/weights read plus the D write
// (~269 MB + ~179 MB at n=700,000, h=48, B=64).
//
// Design: one warp per doc row, 8 rows per CTA.  The warp loads the row's
// ids and weights once, 32 slots at a time (lane p holds slot p), and
// broadcasts them by shuffle; the lanes run over the B query columns, so
// each gathered Z row is read as consecutive 4-byte words by consecutive
// lanes.  A slot whose weight is 0 is skipped, which is exact because Z is
// finite.  Each lane keeps up to 4 columns in registers; wider batches loop
// over column chunks of 128.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 4;  // columns per lane per chunk

__global__ void __launch_bounds__(WARPS * 32)
spmm_ell_kernel(const int* __restrict__ ids,   // (n, h)
                const float* __restrict__ w,   // (n, h)
                const float* __restrict__ z,   // (v, B)
                float* __restrict__ out,       // (n, B)
                int n, int h, int b) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;
  const int* ir = ids + (size_t)row * h;
  const float* wr = w + (size_t)row * h;
  for (int c0 = 0; c0 < b; c0 += 32 * COLS) {
    float acc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[j] = 0.f;
    for (int p0 = 0; p0 < h; p0 += 32) {
      const int p = p0 + lane;
      const int my_id = p < h ? ir[p] : 0;
      const float my_w = p < h ? wr[p] : 0.f;
      const int np = min(32, h - p0);
      for (int pp = 0; pp < np; ++pp) {
        const float wv = __shfl_sync(0xffffffffu, my_w, pp);
        const int id = __shfl_sync(0xffffffffu, my_id, pp);
        if (wv == 0.f) continue;  // warp-uniform
        const float* zr = z + (size_t)id * b;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < b) acc[j] = fmaf(wv, zr[c], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < b) out[(size_t)row * b + c] = acc[j];
    }
  }
}

}  // namespace

extern "C" int launch_spmm_ell(const void* ids, const void* w, const void* z,
                               void* out, int n, int h, int b, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  spmm_ell_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                    (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, b);
  return (int)cudaGetLastError();
}
