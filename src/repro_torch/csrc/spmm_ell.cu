// LC-RWMD phase 2 on Hopper: the ELL SpMM D[i, j] = sum_p w[i, p] * Z[ids[i, p], j],
// in the three formulations of the TPU kernels.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py, spmm_ell_pallas
// (_spmm_blocked_kernel), with spmm_ell_kernel (blocked, the default).  There
// scalar prefetch steered one Z-row DMA per doc and slot.
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
//
// spmm_ell_dense_kernel also replaces the TPU kernel
// src/repro/kernels/spmm_ell.py, spmm_ell_dense_pallas (_spmm_dense_kernel),
// which expanded each doc tile's ids into a one-hot A(bn, bv) per vocab
// subtile and ran A @ Z_tile on the matrix unit.  On Hopper the one-hot
// product becomes its sparse meaning: a CTA of 16 warps owns 256 doc rows
// and a 64-column chunk of B, stages Z one 512-row vocab subtile at a time
// in shared memory (128 KB), and each warp adds, for its 16 rows, the slots
// whose ids fall in the subtile (tiles::ell_row_accumulate; 32 register
// accumulators per lane).  Bound: the same bytes as the blocked kernel, but
// every CTA streams all of Z through shared memory (v*B*4 bytes per 256
// rows, 51 GB from L2 at the slice's shapes) and re-reads its rows' ids and
// weights once per subtile (from L1/L2): the dense formulation pays for the
// vocabulary size, as it does on the TPU.  Sums run subtile by subtile,
// slot order within a subtile.
//
// spmm_ell_naive_kernel also replaces the TPU kernel
// src/repro/kernels/spmm_ell.py, spmm_ell_naive_pallas (_spmm_naive_kernel),
// the seed kernel with one doc x one slot per grid step.  It stays naive on
// purpose, as the recorded baseline: one CTA per doc, the slots in sequence,
// the threads over the B columns, every slot (weight 0 or not) one fmaf.
// The result equals the blocked kernel's bit for bit: both take the fmaf
// chain in slot order from 0, and a zero-weight slot leaves it unchanged.

#include <cuda_runtime.h>

#include "tiles.cuh"

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

constexpr int DENSE_WARPS = 16;
constexpr int DENSE_ROWS = 16;  // rows per warp
constexpr int DENSE_BV = 512;   // vocab rows per shared-memory subtile
constexpr int DENSE_COLS = 64;  // columns per CTA (2 per lane)

struct SubtileRow {
  const float* zs;
  int lo;
  __device__ const float* operator()(int id) const {
    return zs + (size_t)(id - lo) * DENSE_COLS;
  }
};

__global__ void __launch_bounds__(DENSE_WARPS * 32)
spmm_ell_dense_kernel(const int* __restrict__ ids,   // (n, h)
                      const float* __restrict__ w,   // (n, h)
                      const float* __restrict__ z,   // (v, B)
                      float* __restrict__ out,       // (n, B)
                      int n, int h, int v, int b) {
  extern __shared__ __align__(16) float zs[];        // [DENSE_BV][DENSE_COLS]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * (DENSE_WARPS * DENSE_ROWS) + warp * DENSE_ROWS;
  const int c0 = blockIdx.y * DENSE_COLS;
  const int nc = min(DENSE_COLS, b - c0);
  float acc[DENSE_ROWS][2];
#pragma unroll
  for (int r = 0; r < DENSE_ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int lo = 0; lo < v; lo += DENSE_BV) {
    const int nv = min(DENSE_BV, v - lo);
    __syncthreads();  // the previous subtile is consumed
    for (int e = threadIdx.x; e < DENSE_BV * DENSE_COLS; e += blockDim.x) {
      const int r = e / DENSE_COLS, c = e % DENSE_COLS;
      zs[e] = (r < nv && c < nc) ? z[(size_t)(lo + r) * b + c0 + c] : 0.f;
    }
    __syncthreads();
    const SubtileRow zrow{zs, lo};
#pragma unroll
    for (int r = 0; r < DENSE_ROWS; ++r) {
      const int row = row0 + r;
      if (row < n)  // warp-uniform
        tiles::ell_row_accumulate<2>(ids + (size_t)row * h, w + (size_t)row * h,
                                     h, lo, nv, zrow, nc, lane, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < DENSE_ROWS; ++r) {
    const int row = row0 + r;
    if (row >= n) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = lane + 32 * c;
      if (col < nc) out[(size_t)row * b + c0 + col] = acc[r][c];
    }
  }
}

__global__ void spmm_ell_naive_kernel(const int* __restrict__ ids,   // (n, h)
                                      const float* __restrict__ w,   // (n, h)
                                      const float* __restrict__ z,   // (v, B)
                                      float* __restrict__ out,       // (n, B)
                                      int h, int b) {
  const int row = blockIdx.x;
  for (int c = threadIdx.x; c < b; c += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < h; ++p) {
      const float wv = w[(size_t)row * h + p];
      const int id = ids[(size_t)row * h + p];
      acc = fmaf(wv, z[(size_t)id * b + c], acc);
    }
    out[(size_t)row * b + c] = acc;
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

extern "C" int launch_spmm_ell_dense(const void* ids, const void* w,
                                     const void* z, void* out, int n, int h,
                                     int v, int b, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  const int smem = DENSE_BV * DENSE_COLS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_ell_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = DENSE_WARPS * DENSE_ROWS;
  dim3 grid((n + rows - 1) / rows, (b + DENSE_COLS - 1) / DENSE_COLS);
  spmm_ell_dense_kernel<<<grid, DENSE_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, v, b);
  return (int)cudaGetLastError();
}

extern "C" int launch_spmm_ell_naive(const void* ids, const void* w,
                                     const void* z, void* out, int n, int h,
                                     int b, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  spmm_ell_naive_kernel<<<n, min(b, 128), 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, h, b);
  return (int)cudaGetLastError();
}
