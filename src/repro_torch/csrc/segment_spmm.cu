// GNN gather-scale-scatter on Hopper: out[n, :] = sum over the edges e with
// dst[e] = n of rad[e] * feat[src[e], :], edges sorted by dst.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py,
// segment_spmm_pallas (_seg_kernel).  Its grid walks the edges one per step:
// scalar prefetch steers the feat row to gather (src) and the output row to
// accumulate into (dst), and the first edge of a row initialises it.
//
// What bounds it: memory.  Each edge reads its src, its rad and one feat
// row; each output row is written once.  Counting each input once, that is
// 12 bytes per edge (src, dst, rad) plus feat and out; the feat rows
// gathered by edge are E * D * 4 bytes (24.7 GB at the ogbn-products cell),
// and a feat table of ~1 GB does not stay in the 50 MB L2, so the gathers
// run at the rate of scattered 400-byte reads from HBM.
//
// Design: the wrapper turns the sorted dst into row offsets (searchsorted),
// so the kernel never reads dst.  One warp per destination row; the lanes
// run over D (4 columns each per pass of 128).  The warp loads 32 edges'
// src and rad at once, one per lane, and broadcasts them by shuffle; the
// feat rows of 4 edges are loaded before they are added, so 4 gathers are
// in flight.  The sum runs in ascending edge order, the TPU grid's order,
// as out = out + rad * feat with a separately rounded multiply and add
// (__fmul_rn, __fadd_rn), from 0.  No atomics: the result is deterministic.
// A row with no edge is written 0.  A long row (a hub, or the sink row of
// the padding edges) is one warp's serial work: power-law degrees are the
// known weakness of this first design.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 4;    // columns per lane per pass
constexpr int UNROLL = 4;  // feat rows in flight per warp

__global__ void __launch_bounds__(WARPS * 32)
segment_spmm_kernel(const int* __restrict__ src,     // (E,)
                    const int* __restrict__ off,     // (n_out + 1,)
                    const float* __restrict__ feat,  // (N, D)
                    const float* __restrict__ rad,   // (E,)
                    float* __restrict__ out,         // (n_out, D)
                    int n_out, int d) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_out) return;
  const int e0 = off[row];
  const int e1 = off[row + 1];
  float* orow = out + (size_t)row * d;
  for (int c0 = 0; c0 < d; c0 += 32 * COLS) {
    float acc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[j] = 0.f;
    for (int b0 = e0; b0 < e1; b0 += 32) {
      const int e = b0 + lane;
      const int my_src = e < e1 ? src[e] : 0;
      const float my_rad = e < e1 ? rad[e] : 0.f;
      const int nb = min(32, e1 - b0);
      int p = 0;
      for (; p + UNROLL <= nb; p += UNROLL) {
        float r[UNROLL];
        float f[UNROLL][COLS];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int s = __shfl_sync(0xffffffffu, my_src, p + u);
          r[u] = __shfl_sync(0xffffffffu, my_rad, p + u);
          const float* fr = feat + (size_t)s * d;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int col = c0 + j * 32 + lane;
            f[u][j] = col < d ? fr[col] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(r[u], f[u][j]));
      }
      for (; p < nb; ++p) {
        const int s = __shfl_sync(0xffffffffu, my_src, p);
        const float rv = __shfl_sync(0xffffffffu, my_rad, p);
        const float* fr = feat + (size_t)s * d;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int col = c0 + j * 32 + lane;
          const float fv = col < d ? fr[col] : 0.f;
          acc[j] = __fadd_rn(acc[j], __fmul_rn(rv, fv));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = c0 + j * 32 + lane;
      if (col < d) orow[col] = acc[j];
    }
  }
}

}  // namespace

extern "C" int launch_segment_spmm(const void* src, const void* off,
                                   const void* feat, const void* rad, void* out,
                                   int n_out, int d, void* stream) {
  if (n_out <= 0 || d <= 0) return (int)cudaGetLastError();
  const int grid = (n_out + WARPS - 1) / WARPS;
  segment_spmm_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)off, (const float*)feat, (const float*)rad,
      (float*)out, n_out, d);
  return (int)cudaGetLastError();
}
