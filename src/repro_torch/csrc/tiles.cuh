// Device building blocks shared by several kernels of this directory.
//
// ell_row_accumulate: one warp adds one ELL row's slots into per-lane
//   column accumulators, reading each slot's Z row through a caller-given
//   lookup.  Only slots whose id falls in [lo, lo + nv) and whose weight is
//   non-zero contribute, in slot order.  The fused vocab chunk
//   (fused_chunk.cu, the chunk's Z spread over a thread-block cluster)
//   consumes its Z this way.  This is what the TPU kernel's one-hot
//   product A(bn, bv) @ Z_tile computes, less the multiplications by zero.
//
// gram_min_cols: rows resident in shared memory (transposed, [m][ldd])
//   against a range of "query word" columns read from device memory, in
//   tiles of 32 rows x 128 columns with a 4 x 4 register tile per thread
//   (256 threads).  Each squared distance max(|a|^2 + |b|^2 - 2ab, 0) is
//   folded by atomicMin (on the float's bits: all values are >= 0) into a
//   per-(row, query) minimum over the query's VALID words and, when asked,
//   a per-(doc, column) minimum over the doc's VALID rows.  Phase 1 of the
//   fused vocab chunk (the row minimum) and the quadratic RWMD (both
//   minima) are built on it.  The products run in IEEE float32 on the FMA
//   units (with bf16, on operands rounded to bf16; the norms stay float32);
//   the caller takes the sqrt (min and sqrt commute).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiles {

constexpr float BIG = 3.4e38f;  // finite sentinel of masked entries, as on the TPU
constexpr int TC = 128;         // columns per gram tile
constexpr int KC = 16;          // features per shared-memory stage
constexpr int TR = 32;          // rows per gram row tile
constexpr int GRAM_THREADS = 256;
constexpr int QS_LD = TC + 4;  // padded row of the staged columns (fewer bank conflicts)

__device__ __forceinline__ unsigned big_bits() { return __float_as_uint(BIG); }

// The products' operands rounded to bf16 (round to nearest even) and back
// when bf16 is set; a product of two bf16 values is exact in float32.
__device__ __forceinline__ float maybe_bf16(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// acc[c] += sum over the row's slots p with w != 0 and lo <= id < lo + nv of
// w[p] * zrow(id)[lane + 32 c], for lane + 32 c < ncols.  Returns whether
// any slot contributed (warp-uniform).
template <int CW, class ZRow>
__device__ __forceinline__ bool ell_row_accumulate(
    const int* __restrict__ ir, const float* __restrict__ wr, int h, int lo,
    int nv, ZRow zrow, int ncols, int lane, float (&acc)[CW]) {
  bool any = false;
  for (int p0 = 0; p0 < h; p0 += 32) {
    const int p = p0 + lane;
    const int id = p < h ? ir[p] : 0;
    const float w = p < h ? wr[p] : 0.f;
    unsigned hit = __ballot_sync(0xffffffffu,
                                 w != 0.f && id >= lo && id < lo + nv);
    any |= hit != 0u;
    while (hit) {
      const int src = __ffs(hit) - 1;
      hit &= hit - 1;
      const float wv = __shfl_sync(0xffffffffu, w, src);
      const int iv = __shfl_sync(0xffffffffu, id, src);
      const float* z = zrow(iv);
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int col = lane + 32 * c;
        if (col < ncols) acc[c] = fmaf(wv, z[col], acc[c]);
      }
    }
  }
  return any;
}

// Squared norms and validity of the tile's columns: two threads a column.
__device__ __forceinline__ void column_norms(
    const float* __restrict__ qtab, const int* __restrict__ qidx,
    const float* __restrict__ qval, int c0, int c_end, int m,
    float* b2s, float* vs) {
  const int c = threadIdx.x / 2, part = threadIdx.x % 2;
  const int col = c0 + c;
  float s = 0.f;
  if (col < c_end) {
    const float* row = qtab + (size_t)(qidx ? qidx[col] : col) * m;
    for (int k = part; k < m; k += 2) s = fmaf(row[k], row[k], s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (part == 0) {
    b2s[c] = s;
    vs[c] = (col < c_end && qval[col] > 0.f) ? 1.f : 0.f;
  }
}

// Rows 0..R-1 of ds ([m][ldd], ldd >= NRT * TR) against columns
// [col0, col0 + ncols).  Column col is query col / h2's word col % h2; its
// embedding row is qtab[qidx ? qidx[col] : col] and it is valid when
// qval[col] > 0.  Folds into
//   rowmin[r * ldr + col / h2 - qbase]           over valid columns,
//   colmin[(r / h1) * ldc + col - cbase]         over rows with rvalid[r] > 0
// (the second only when COLMIN).  Both hold float bits, initialised by the
// caller to big_bits().  qs: KC * QS_LD floats; b2s, vs: TC floats each.
// ldd is a multiple of 4 (float4 reads); NRT * TR + 4 avoids bank conflicts.
// Called by all GRAM_THREADS threads; ends synchronised.
template <int NRT, bool COLMIN>
__device__ void gram_min_cols(
    const float* ds, int ldd, const float* a2s, int R, int m,
    const float* __restrict__ qtab, const int* __restrict__ qidx,
    const float* __restrict__ qval, int col0, int ncols, int h2, int bf16,
    float* qs, float* b2s, float* vs,
    unsigned* rowmin, int ldr, int qbase,
    const float* rvalid, unsigned* colmin, int ldc, int h1, int cbase) {
  const int tid = threadIdx.x;
  const int tx = tid % 32;  // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / 32;  // rows ty*4 .. ty*4+3 of each 32-row tile
  const int c_end = col0 + ncols;
  for (int c0 = col0; c0 < c_end; c0 += TC) {
    column_norms(qtab, qidx, qval, c0, c_end, m, b2s, vs);
    float acc[NRT][4][4];
#pragma unroll
    for (int t = 0; t < NRT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

    for (int k0 = 0; k0 < m; k0 += KC) {
#pragma unroll
      for (int e = 0; e < (KC * TC) / GRAM_THREADS; ++e) {
        const int idx = tid + e * GRAM_THREADS;
        const int c = idx / KC, kk = idx % KC;
        const int col = c0 + c;
        float x = 0.f;
        if (col < c_end && k0 + kk < m)
          x = qtab[(size_t)(qidx ? qidx[col] : col) * m + k0 + kk];
        qs[kk * QS_LD + c] = maybe_bf16(x, bf16);
      }
      __syncthreads();
      const int kn = min(KC, m - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&qs[kk * QS_LD + tx * 4]);
        const float* drow = ds + (size_t)(k0 + kk) * ldd + ty * 4;
#pragma unroll
        for (int t = 0; t < NRT; ++t) {
          const float4 a = *reinterpret_cast<const float4*>(drow + t * TR);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[t][i][0] = fmaf(av[i], b.x, acc[t][i][0]);
            acc[t][i][1] = fmaf(av[i], b.y, acc[t][i][1]);
            acc[t][i][2] = fmaf(av[i], b.z, acc[t][i][2]);
            acc[t][i][3] = fmaf(av[i], b.w, acc[t][i][3]);
          }
        }
      }
      __syncthreads();
    }

    // Epilogue: fold the 4 x 4 tile into the minima, merging runs of equal
    // query (rows) or equal doc (columns) before each atomic.
#pragma unroll
    for (int t = 0; t < NRT; ++t) {
      float sq[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t * TR + ty * 4 + i;
        const float a2 = r < R ? a2s[r] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx * 4 + j;
          sq[i][j] = fmaxf(a2 + b2s[cl] - 2.f * acc[t][i][j], 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t * TR + ty * 4 + i;
        if (r >= R) continue;
        int cur_q = -1;
        float cur = BIG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx * 4 + j;
          const int col = c0 + cl;
          if (col >= c_end || vs[cl] == 0.f) continue;
          const int q = col / h2;
          if (q != cur_q) {
            if (cur_q >= 0)
              atomicMin(&rowmin[r * ldr + cur_q - qbase], __float_as_uint(cur));
            cur_q = q;
            cur = sq[i][j];
          } else {
            cur = fminf(cur, sq[i][j]);
          }
        }
        if (cur_q >= 0)
          atomicMin(&rowmin[r * ldr + cur_q - qbase], __float_as_uint(cur));
      }
      if (COLMIN) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx * 4 + j;
          const int col = c0 + cl;
          if (col >= c_end) continue;
          int cur_d = -1;
          float cur = BIG;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = t * TR + ty * 4 + i;
            if (r >= R || rvalid[r] == 0.f) continue;
            const int d = r / h1;
            if (d != cur_d) {
              if (cur_d >= 0)
                atomicMin(&colmin[cur_d * ldc + col - cbase], __float_as_uint(cur));
              cur_d = d;
              cur = sq[i][j];
            } else {
              cur = fminf(cur, sq[i][j]);
            }
          }
          if (cur_d >= 0)
            atomicMin(&colmin[cur_d * ldc + col - cbase], __float_as_uint(cur));
        }
      }
    }
    __syncthreads();  // b2s / vs are rewritten by the next tile
  }
}

// Load rows 0..R-1 (row r is tab[idx(r)]) transposed into ds[m][ldd]
// (rounded to bf16 when asked) with their float32 squared norms in a2s;
// rows R..ldd-1 are zero.  All threads; ends synchronised.
template <class RowIdx>
__device__ void load_rows_transposed(const float* __restrict__ tab, RowIdx idx,
                                     int R, int m, int bf16, float* ds,
                                     int ldd, float* a2s) {
  for (int e = threadIdx.x; e < ldd * m; e += blockDim.x) {
    const int r = e / m, k = e % m;
    ds[(size_t)k * ldd + r] =
        r < R ? maybe_bf16(tab[(size_t)idx(r) * m + k], bf16) : 0.f;
  }
  for (int r = threadIdx.x; r < ldd; r += blockDim.x) {
    float s = 0.f;
    if (r < R) {
      const float* row = tab + (size_t)idx(r) * m;
      for (int k = 0; k < m; ++k) s = fmaf(row[k], row[k], s);
    }
    a2s[r] = s;
  }
  __syncthreads();
}

}  // namespace tiles
