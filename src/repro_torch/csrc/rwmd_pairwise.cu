// Quadratic RWMD on Hopper: for every resident doc i and query j,
//   c[p][q] = ||E[r_ids[i,p]] - E[q_ids[j,q]]||  (gram form, clamped at 0),
//   d12 = sum_p w1[p] * min_{q valid} c[p][q]  over valid p,
//   d21 = sum_q w2[q] * min_{p valid} c[p][q]  over valid q,
//   out[i, j] = max(d12, d21)             (FULL), or
//   out[i, j] = d21                       (the d21 mode).
// FULL counts a masked minimum over nothing as the finite sentinel 3.4e38,
// as on the TPU.  The d21 mode is the symmetric LC-RWMD's swapped
// direction, as core/lc_rwmd.py's plain fold computes it: an empty resident
// doc gives +inf against a query with a valid word, and 0 against an empty
// query; padded query words add nothing (never 0 * inf).
//
// Replaces the TPU kernel src/repro/kernels/rwmd_pairwise.py,
// rwmd_pairwise_pallas (_rwmd_kernel), which took the (n, h1, m) gather of
// the resident docs' word embeddings from its wrapper.  At 700,000 docs,
// h1 = 48 and m = 300 that gather is 40.3 GB; here the kernel reads the
// embedding rows by id.
//
// What bounds it: arithmetic.  2 * m FLOP per (valid doc word, valid query
// word) pair: 2.1e13 at n = 700,000 (mean h 27.5), B = 64, m = 300, against
// (v + ...) * m * 4 bytes of embedding rows and n * B * 4 bytes of output.
// The products run in IEEE float32 on the FMA units (with bf16, on operands
// rounded to bf16, as the TPU's bf16 matmul takes them).
//
// Design (the one phase 1 runs, lc_rwmd_phase1.cu, on both operands):
//
// - Lists.  Three prep launches, no host sync: the valid (doc, word) slots
//   counted per doc, an exclusive scan into each doc's first row
//   (doc_start, n + 1 entries), and the flat slots listed in (doc, word)
//   order; the scan's CTA also lists the valid (query, word) columns (by
//   tiles::list_positive, as phase 1 does) and the first column of each
//   group of QG queries.  Padding costs nothing.
// - Grid.  blockIdx.y is a group of QG queries; blockIdx.x a persistent CTA
//   that owns a contiguous range of whole docs holding about 1/gridDim.x of
//   the valid rows (a binary search in doc_start), so no doc spans two CTAs.
// - Tiles.  The CTA walks its rows in tiles of 128 rows (cut early so a
//   tile holds at most DMAX docs) and, for each, loops over the group's
//   column tiles of 128 valid columns: tiles::g128::gemm (an 8 x 8
//   accumulator per thread, 16-byte cp.async stages, three in flight,
//   transposed per thread, norms from the staged chunks).
// - Minima.  In each column tile's epilogue every thread folds its 8 x 8
//   squared distances over runs of one query along a row (FULL: into the
//   row minima rowmin[row][query], shared memory, kept over the column
//   tiles) and over runs of one doc along a column (into colmin[doc][col],
//   shared memory over the copy stages, which are idle then), one shared
//   atomicMin per run.
// - d21.  A column's term w2 * sqrt(colmin) is final once all of its doc's
//   rows are seen: for a doc inside the tile, at once, summed per (doc,
//   query) over the column tiles in column order.  A doc that continues
//   into the next tile of the same CTA keeps its column minima in the CTA's
//   own global carry (QG * h2 words), folded by min tile after tile; its
//   terms are summed in the tile where it ends.
// - d12 (FULL).  After the last column tile, per (doc, query): the tile's
//   rows of the doc in slot order, w1 * sqrt(rowmin), added to the doc's
//   running sum (carried in global memory across tiles for a continuing
//   doc).  Then out = max(d12, d21) for the docs that end in the tile.
// - Empty docs are written by the CTA that owns them, before its tiles.
//
// Shared memory: 93.5 KB in the d21 mode, 109.3 KB in FULL: two CTAs an
// SM in both.

#include <cuda_runtime.h>

#include <cstddef>

#include "tiles.cuh"

namespace {

namespace g = tiles::g128;
using tiles::BIG;
constexpr int BM = g::BM;          // doc word rows per tile
constexpr int BN = g::BN;          // query word columns per tile
constexpr int THREADS = g::THREADS;
// QG and DMAX are kernels/rwmd_pairwise.py's QUERY_GROUP and TILE_DOCS.
constexpr int QG = 32;             // queries per group (blockIdx.y)
constexpr int DMAX = 16;           // docs per row tile
constexpr int PREP_THREADS = 1024;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Smem {
  union {
    g::Stages st;                  // the GEMM's copies
    unsigned colmin[DMAX][BN];     // min over a doc's rows of each column (bits)
  } u;
  g::Tiles t;                      // t.asrc: doc word ids; t.bsrc: query word ids
  int rdoc[BM];                    // doc of each tile row, from the tile's first; -1 past
  float rw[BM];                    // weight of each tile row
  int cq[BN];                      // query of each tile column, in the group; -1 past
  float cw[BN];                    // weight of each tile column
  int dstart[DMAX + 1];            // tile rows of doc d: [dstart[d], dstart[d + 1])
  float empty[QG];                 // the value of an empty doc for each query
  float d21[DMAX][QG];             // d21 of the tile's docs
  // FULL only (the d21 mode allocates up to here):
  unsigned rowmin[BM][QG];         // min over a query's columns of each row (bits)
  float d12[DMAX][QG];             // d12 of the tile's docs
};

// First d in [0, n] with doc_start[d] >= target.
__device__ int first_doc_at(const int* __restrict__ doc_start, int n,
                            long long target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (doc_start[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First c in [0, nc) with cq[c] >= q.
__device__ __forceinline__ int first_col(const int* cq, int nc, int q) {
  int lo = 0, hi = nc;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (cq[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool FULL, bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
rwmd_kernel(const float* __restrict__ emb,        // (v, m)
            const int* __restrict__ r_ids,        // (n, h1)
            const float* __restrict__ r_w,        // (n, h1)
            const int* __restrict__ q_ids,        // (B, h2)
            const float* __restrict__ q_w,        // (B, h2)
            const int* __restrict__ rows,         // valid flat (doc, word) slots
            const int* __restrict__ doc_start,    // (n + 1,)
            const int* __restrict__ cols,         // valid flat (query, word) slots
            const int* __restrict__ gcol,         // (groups + 1,) first column of a group
            unsigned* __restrict__ carry_col,     // (groups * ctas, QG * h2)
            float* __restrict__ carry_d12,        // (groups * ctas, QG)
            float* __restrict__ out,              // (n, B)
            int n, int b, int h1, int h2, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int cta = blockIdx.x, n_ctas = gridDim.x, grp = blockIdx.y;
  const int qb = grp * QG, nqg = min(QG, b - qb);
  const int gc0 = gcol[grp], gc1 = gcol[grp + 1];
  const int n_ct = (gc1 - gc0 + BN - 1) / BN;
  const long long nr = doc_start[n];
  const int D0 = cta == 0 ? 0 : first_doc_at(doc_start, n, nr * cta / n_ctas);
  const int D1 = cta == n_ctas - 1 ? n
                                   : first_doc_at(doc_start, n, nr * (cta + 1) / n_ctas);
  if (D0 >= D1) return;
  const int R0 = doc_start[D0], R1 = doc_start[D1];
  const size_t slot = (size_t)grp * n_ctas + cta;
  unsigned* ccol = carry_col + slot * QG * h2;
  float* cd12 = carry_d12 + slot * QG;

  // --- empty docs: d12 = 0; d21 over nothing ---
  if (tid < nqg) {
    const float* w2 = q_w + (size_t)(qb + tid) * h2;
    float sum = 0.f;
    bool any = false;
    for (int c = 0; c < h2; ++c) {
      if (w2[c] > 0.f) {
        sum = fmaf(w2[c], BIG, sum);
        any = true;
      }
    }
    s.empty[tid] = FULL ? sum : (any ? inf_f() : 0.f);
  }
  __syncthreads();
  for (int e = tid; e < (D1 - D0) * nqg; e += THREADS) {
    const int d = D0 + e / nqg, q = e % nqg;
    if (doc_start[d + 1] == doc_start[d]) out[(size_t)d * b + qb + q] = s.empty[q];
  }

  for (int r0 = R0; r0 < R1;) {
    const int d0 = rows[r0] / h1;
    const int r1 = min(min(r0 + BM, R1), doc_start[min(d0 + DMAX, D1)]);
    const int dl = rows[r1 - 1] / h1;
    const int nd = dl - d0 + 1;
    const bool open_in = doc_start[d0] < r0;     // began in an earlier tile
    const bool open_out = doc_start[dl + 1] > r1; // goes on in the next tile

    if (tid < BM) {
      const int r = r0 + tid;
      if (r < r1) {
        const int slot_id = rows[r];
        s.t.asrc[tid] = r_ids[slot_id];
        s.rw[tid] = r_w[slot_id];
        s.rdoc[tid] = slot_id / h1 - d0;
      } else {
        s.t.asrc[tid] = -1;
        s.rw[tid] = 0.f;
        s.rdoc[tid] = -1;
      }
    } else if (tid - BM <= nd) {
      const int j = tid - BM;
      s.dstart[j] = min(max(doc_start[d0 + j], r0), r1) - r0;
    }
    for (int e = tid; e < DMAX * QG; e += THREADS) {
      const int d = e / QG, q = e % QG;
      (&s.d21[0][0])[e] = 0.f;
      if (FULL) s.d12[d][q] = d == 0 && open_in && q < nqg ? cd12[q] : 0.f;
    }
    if (FULL)
      for (int e = tid; e < BM * QG; e += THREADS)
        (&s.rowmin[0][0])[e] = tiles::big_bits();
    __syncthreads();

    for (int ct = 0; ct < n_ct; ++ct) {
      const int cbase = gc0 + ct * BN;          // position in cols
      const int ncl = min(BN, gc1 - cbase);
      unsigned* ccar = ccol + (cbase - gc0);    // the carry of these columns
      if (tid < BN) {
        if (tid < ncl) {
          const int fc = cols[cbase + tid];
          s.t.bsrc[tid] = q_ids[fc];
          s.cq[tid] = fc / h2 - qb;
          s.cw[tid] = q_w[fc];
        } else {
          s.t.bsrc[tid] = -1;
          s.cq[tid] = -1;
          s.cw[tid] = 0.f;
        }
      }
      __syncthreads();

      float acc[8][8];
      g::gemm<BF16, VEC>(s.u.st, s.t, emb, emb, m, acc);
      g::to_sq(s.t, acc);
      for (int e = tid; e < DMAX * BN; e += THREADS)
        (&s.u.colmin[0][0])[e] = tiles::big_bits();
      __syncthreads();

      if (FULL) {  // row minima, one atomic per run of one query
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = g::row_of(i);
          if (s.rdoc[row] < 0) continue;
          int cur_q = -1;
          float cur = BIG;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int q = s.cq[g::col_of(j)];
            if (q < 0) continue;
            if (q != cur_q) {
              if (cur_q >= 0) atomicMin(&s.rowmin[row][cur_q], __float_as_uint(cur));
              cur_q = q;
              cur = acc[i][j];
            } else {
              cur = fminf(cur, acc[i][j]);
            }
          }
          if (cur_q >= 0) atomicMin(&s.rowmin[row][cur_q], __float_as_uint(cur));
        }
      }
      // column minima, one atomic per run of one doc
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = g::col_of(j);
        if (s.cq[col] < 0) continue;
        int cur_d = -1;
        float cur = BIG;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = s.rdoc[g::row_of(i)];
          if (d < 0) continue;
          if (d != cur_d) {
            if (cur_d >= 0) atomicMin(&s.u.colmin[cur_d][col], __float_as_uint(cur));
            cur_d = d;
            cur = acc[i][j];
          } else {
            cur = fminf(cur, acc[i][j]);
          }
        }
        if (cur_d >= 0) atomicMin(&s.u.colmin[cur_d][col], __float_as_uint(cur));
      }
      __syncthreads();

      // d21 terms of the docs that end in this tile, per (doc, query)
      const int qa = s.cq[0], nqc = s.cq[ncl - 1] - qa + 1;
      for (int e = tid; e < nd * nqc; e += THREADS) {
        const int d = e / nqc, q = qa + e % nqc;
        if ((d == nd - 1 && open_out) || s.dstart[d] == s.dstart[d + 1]) continue;
        float sum = s.d21[d][q];
        for (int c = first_col(s.cq, ncl, q); c < ncl && s.cq[c] == q; ++c) {
          unsigned bits = s.u.colmin[d][c];
          if (d == 0 && open_in) bits = min(bits, ccar[c]);
          sum = fmaf(s.cw[c], sqrtf(__uint_as_float(bits)), sum);
        }
        s.d21[d][q] = sum;
      }
      __syncthreads();  // the carry was read above
      if (open_out) {   // the last doc goes on: its column minima so far
        for (int c = tid; c < ncl; c += THREADS) {
          unsigned bits = s.u.colmin[nd - 1][c];
          if (nd == 1 && open_in) bits = min(bits, ccar[c]);
          ccar[c] = bits;
        }
      }
      __syncthreads();  // colmin and the column lists are rewritten next
    }

    if (FULL) {  // d12: this tile's rows of each doc, in slot order
      for (int e = tid; e < nd * nqg; e += THREADS) {
        const int d = e / nqg, q = e % nqg;
        float sum = s.d12[d][q];
        for (int r = s.dstart[d]; r < s.dstart[d + 1]; ++r) {
          const unsigned bits = s.rowmin[r][q];
          const float mn = bits == tiles::big_bits() ? BIG : sqrtf(__uint_as_float(bits));
          sum = fmaf(s.rw[r], mn, sum);
        }
        s.d12[d][q] = sum;
      }
      __syncthreads();
    }
    for (int e = tid; e < nd * nqg; e += THREADS) {
      const int d = e / nqg, q = e % nqg;
      if (s.dstart[d] == s.dstart[d + 1]) continue;  // empty: written above
      if (d == nd - 1 && open_out) {
        if (FULL) cd12[q] = s.d12[d][q];
        continue;
      }
      out[(size_t)(d0 + d) * b + qb + q] =
          FULL ? fmaxf(s.d12[d][q], s.d21[d][q]) : s.d21[d][q];
    }
    __syncthreads();  // the tile's state is rewritten next
    r0 = r1;
  }
}

// --- prep: the lists of valid rows and columns ---

__global__ void count_rows_kernel(const float* __restrict__ r_w, int n, int h1,
                                  int* __restrict__ cnt) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  const float* w = r_w + (size_t)d * h1;
  int c = 0;
  for (int p = 0; p < h1; ++p) c += w[p] > 0.f;
  cnt[d] = c;
}

// Exclusive scan of a block's per-thread values (PREP_THREADS threads).
__device__ int block_exclusive_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, vi, o);
      if (lane >= o) vi += y;
    }
    warp_sums[lane] = vi - v;        // exclusive over warps
    if (lane == 31) warp_sums[32] = vi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - x;
  total = warp_sums[32];
  __syncthreads();
  return out;
}

// One CTA: doc_start = exclusive scan of cnt (n + 1 entries), and the valid
// (query, word) columns in order with the first column of each group.
__global__ void __launch_bounds__(PREP_THREADS)
scan_kernel(const int* __restrict__ cnt, int n, int* __restrict__ doc_start,
            const float* __restrict__ q_w, int n_slots, int h2, int groups,
            int* __restrict__ cols, int* __restrict__ gcol) {
  __shared__ int warp_sums[33];
  const int tid = threadIdx.x;
  const int per = (n + PREP_THREADS - 1) / PREP_THREADS;
  const int a = min(n, tid * per), z = min(n, a + per);
  int local = 0;
  for (int i = a; i < z; ++i) local += cnt[i];
  int total;
  int run = block_exclusive_scan(local, warp_sums, total);
  for (int i = a; i < z; ++i) {
    doc_start[i] = run;
    run += cnt[i];
  }
  if (tid == 0) doc_start[n] = total;

  const int n_cols = tiles::list_positive<PREP_THREADS>(q_w, n_slots, cols);
  for (int gi = tid; gi <= groups; gi += PREP_THREADS) {
    const long long first = (long long)gi * QG * h2;  // first slot of the group
    int lo = 0, hi = n_cols;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (cols[mid] < first) lo = mid + 1; else hi = mid;
    }
    gcol[gi] = gi == groups ? n_cols : lo;
  }
}

__global__ void list_rows_kernel(const float* __restrict__ r_w,
                                 const int* __restrict__ doc_start, int n,
                                 int h1, int* __restrict__ rows) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  const float* w = r_w + (size_t)d * h1;
  int at = doc_start[d];
  for (int p = 0; p < h1; ++p)
    if (w[p] > 0.f) rows[at++] = d * h1 + p;
}

template <bool FULL>
size_t smem_bytes() {
  return FULL ? sizeof(Smem) : offsetof(Smem, rowmin);
}

template <bool FULL, bool BF16, bool VEC>
int launch_main(dim3 grid, cudaStream_t stream, const float* emb,
                const int* r_ids, const float* r_w, const int* q_ids,
                const float* q_w, const int* rows, const int* doc_start,
                const int* cols, const int* gcol, unsigned* carry_col,
                float* carry_d12, float* out, int n, int b, int h1, int h2,
                int m) {
  auto kern = rwmd_kernel<FULL, BF16, VEC>;
  const int smem = (int)smem_bytes<FULL>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(emb, r_ids, r_w, q_ids, q_w, rows,
                                        doc_start, cols, gcol, carry_col,
                                        carry_d12, out, n, b, h1, h2, m);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch the caller allocates: cnt (n), doc_start (n + 1), rows (n * h1),
// cols (B * h2), gcol (groups + 1), carry_col (groups * ctas * QG * h2),
// carry_d12 (groups * ctas * QG); groups = ceil(B / QG).
extern "C" int launch_rwmd_pairwise(const void* emb, const void* r_ids,
                                    const void* r_w, const void* q_ids,
                                    const void* q_w, void* cnt,
                                    void* doc_start, void* rows, void* cols,
                                    void* gcol, void* carry_col,
                                    void* carry_d12, void* out, int n, int b,
                                    int h1, int h2, int m, int ctas, int full,
                                    int bf16, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  if ((long long)n * h1 > 0x7fffffffLL || (long long)b * h2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int groups = (b + QG - 1) / QG;
  if (groups > 65535 || ctas < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + 255) / 256;
  count_rows_kernel<<<blocks, 256, 0, s>>>((const float*)r_w, n, h1, (int*)cnt);
  scan_kernel<<<1, PREP_THREADS, 0, s>>>((const int*)cnt, n, (int*)doc_start,
                                         (const float*)q_w, b * h2, h2, groups,
                                         (int*)cols, (int*)gcol);
  list_rows_kernel<<<blocks, 256, 0, s>>>((const float*)r_w,
                                          (const int*)doc_start, n, h1,
                                          (int*)rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ctas, groups);
  const bool vec = tiles::g128::vec_ok(emb, emb, m);
  auto args = [&](auto launch) {
    return launch(grid, s, (const float*)emb, (const int*)r_ids,
                  (const float*)r_w, (const int*)q_ids, (const float*)q_w,
                  (const int*)rows, (const int*)doc_start, (const int*)cols,
                  (const int*)gcol, (unsigned*)carry_col, (float*)carry_d12,
                  (float*)out, n, b, h1, h2, m);
  };
  if (full) {
    if (bf16)
      return vec ? args(launch_main<true, true, true>)
                 : args(launch_main<true, true, false>);
    return vec ? args(launch_main<true, false, true>)
               : args(launch_main<true, false, false>);
  }
  if (bf16)
    return vec ? args(launch_main<false, true, true>)
               : args(launch_main<false, true, false>);
  return vec ? args(launch_main<false, false, true>)
             : args(launch_main<false, false, false>);
}
