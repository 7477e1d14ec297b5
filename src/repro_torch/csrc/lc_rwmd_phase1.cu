// LC-RWMD phase 1 on Hopper: squared Z[w, j] = min over the valid words q
// of query j of ||E[w] - T[j, q]||^2, in gram form, clamped at 0.
//
// Replaces the TPU kernel src/repro/kernels/lc_rwmd_phase1.py,
// lc_rwmd_phase1_pallas (_phase1_kernel).
//
// What bounds it: arithmetic.  The dot products over the VALID query words
// cost 2*v*m*n_valid FLOP (7.7e10 at v=73,123, m=300 and the 1,760 valid
// words of a 64-query batch of mean h 27.5) against only (v + B*h)*m*4
// bytes of input and v*B*4 bytes of output, so the FP32 FMA rate is the
// limit.  The operands stay float32 and run on the FMA units, not the TF32
// tensor cores, so the result is IEEE float32 as the reference's is.
//
// Design: a register-tiled FP32 GEMM of the vocabulary against the valid
// (query, word) columns only, with the min folded in its epilogue.
//
// - Columns.  A first launch lists the flat (query * h + word) indices of
//   the valid words, in (query, word) order, with their count, on the
//   device (no host sync), and fills Z^2 with 3.4e38.  The GEMM's grid is
//   sized for B*h columns; a column tile that starts past the count exits
//   at once.  Padded words cost nothing.  (The same list built by torch ops
//   in the wrapper, kernels/lc_rwmd_phase1.py's valid_columns, takes
//   several launches.)
// - Tile.  One CTA computes 128 vocab rows x 128 columns with
//   tiles::g128::gemm (tiles.cuh): an 8 x 8 accumulator per thread,
//   16-byte cp.async stages, three in flight, transposed per thread, and
//   the norms |e|^2 and |t|^2 from the staged chunks.  (4-byte copies
//   straight into the transposed tiles were slower: one copy instruction a
//   word.)
// - Epilogue.  sq = max(|e|^2 + |t|^2 - 2*acc, 0) (never -0.0).  Each
//   thread walks its 8 rows over its 8 columns, merging runs of one query,
//   and lowers Z^2 once per run by a global atomicMin on the float's bits
//   (all values are >= 0), into Z^2 filled with 3.4e38 beforehand.  A query
//   whose columns several threads or tiles hold is folded by each; a query
//   with no valid word is touched by none and keeps 3.4e38, as on the TPU.
//
// The grid puts the column tile in x, so the CTAs that share an E tile run
// together and find it in L2.  The wrapper takes the sqrt.
//
// bf16: the GEMM operands are rounded to bf16 (round to nearest even) and
// back as they are transposed (after their squares enter the norms, which
// stay float32); a product of two bf16 values is exact in float32, which
// is what preferred_element_type=f32 gives on the TPU.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

namespace g = tiles::g128;
constexpr int BM = g::BM;     // vocab rows per CTA
constexpr int BN = g::BN;     // valid columns per CTA
constexpr int THREADS = g::THREADS;
constexpr float BIG = 3.4e38f;

struct Smem {
  g::Stages st;
  g::Tiles t;      // t.asrc: vocab rows; t.bsrc: flat (query * h + word) rows of T
  int colq[BN];    // query of each column, -1 past the count
};

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
phase1_kernel(const float* __restrict__ emb,    // (v, m)
              const float* __restrict__ t,      // (B * h, m)
              const int* __restrict__ cols,     // (B * h,) valid columns first
              const int* __restrict__ count,    // (1,) number of valid columns
              unsigned* __restrict__ out,       // (v, B) squared Z, as bits
              int v, int b, int h, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int n_cols = *count;
  const int c0 = blockIdx.x * BN;
  if (c0 >= n_cols) return;
  const int row0 = blockIdx.y * BM;
  const int tid = threadIdx.x;

  if (tid < BN) {
    const int c = c0 + tid;
    const int src = c < n_cols ? cols[c] : 0;
    s.colq[tid] = c < n_cols ? src / h : -1;
    s.t.bsrc[tid] = c < n_cols ? src : -1;
  } else {
    const int r = tid - BN;
    s.t.asrc[r] = row0 + r < v ? row0 + r : -1;
  }
  __syncthreads();

  float acc[8][8];
  g::gemm<BF16, VEC>(s.st, s.t, emb, t, m, acc);
  g::to_sq(s.t, acc);

  // Epilogue: squared distances, folded per (row, query) run.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + g::row_of(i);
    unsigned* orow = out + (size_t)row * b;
    int cur_q = -1;
    float cur = BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = s.colq[g::col_of(j)];
      if (q < 0) continue;
      if (q != cur_q) {
        if (cur_q >= 0 && row < v) atomicMin(&orow[cur_q], __float_as_uint(cur));
        cur_q = q;
        cur = acc[i][j];
      } else {
        cur = fminf(cur, acc[i][j]);
      }
    }
    if (cur_q >= 0 && row < v) atomicMin(&orow[cur_q], __float_as_uint(cur));
  }
}

// Before the GEMM, one launch: every CTA fills Z^2 with 3.4e38, and CTA 0
// lists the valid columns (valid[i] > 0), in order, with their count
// (tiles::list_positive).
constexpr int PREP_THREADS = 256;

__global__ void __launch_bounds__(PREP_THREADS)
phase1_prep_kernel(const float* __restrict__ valid, int n,
                   int* __restrict__ cols, int* __restrict__ count,
                   unsigned* __restrict__ out, size_t n_out) {
  for (size_t i = (size_t)blockIdx.x * PREP_THREADS + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * PREP_THREADS)
    out[i] = __float_as_uint(BIG);
  if (blockIdx.x != 0) return;
  const int n_cols = tiles::list_positive<PREP_THREADS>(valid, n, cols);
  if (threadIdx.x == 0) *count = n_cols;
}

}  // namespace

extern "C" int launch_lc_rwmd_phase1(const void* emb, const void* t,
                                     const void* valid, void* cols,
                                     void* count, void* out, int v, int b,
                                     int h, int m, int bf16, void* stream) {
  if (v <= 0 || b <= 0 || h <= 0) return (int)cudaGetLastError();
  const int row_tiles = (v + BM - 1) / BM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const long long n_cols = (long long)b * h;
  if (n_cols > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t n_out = (size_t)v * b;
  const size_t want = (n_out + PREP_THREADS * 4 - 1) / (PREP_THREADS * 4);
  const int prep_blocks = (int)(want < 1024 ? (want > 0 ? want : 1) : 1024);
  phase1_prep_kernel<<<prep_blocks, PREP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)valid, (int)n_cols, (int*)cols, (int*)count,
      (unsigned*)out, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n_cols + BN - 1) / BN), row_tiles);
  const int smem = (int)sizeof(Smem);
  const bool vec = g::vec_ok(emb, t, m);  // 16-byte copies: aligned rows
  auto kern = bf16 ? (vec ? phase1_kernel<true, true> : phase1_kernel<true, false>)
                   : (vec ? phase1_kernel<false, true> : phase1_kernel<false, false>);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)emb, (const float*)t, (const int*)cols,
      (const int*)count, (unsigned*)out, v, b, h, m);
  return (int)cudaGetLastError();
}
