// Quadratic RWMD on Hopper: for every resident doc i and query j,
//   c[p][q] = ||E[r_ids[i,p]] - E[q_ids[j,q]]||  (gram form, clamped at 0),
//   d12 = sum_p w1[p] * min_{q valid} c[p][q]  over valid p,
//   d21 = sum_q w2[q] * min_{p valid} c[p][q]  over valid q,
//   out[i, j] = max(d12, d21).
// A masked minimum over nothing is the finite sentinel 3.4e38, as on the TPU.
//
// Replaces the TPU kernel src/repro/kernels/rwmd_pairwise.py,
// rwmd_pairwise_pallas (_rwmd_kernel), which took the (n, h1, m) gather of
// the resident docs' word embeddings from its wrapper.  At 700,000 docs,
// h1 = 48 and m = 300 that gather is 40.3 GB; here the kernel reads the
// embedding rows by id, once per doc (once per query group for a doc of
// more than 128 words).
//
// What bounds it: arithmetic.  2 * m * h1 * h2 FLOP per (doc, query) pair
// (6.2e13 at n = 700,000, B = 64, h = 48, m = 300 counting padding slots)
// against (n * h1 + B * h2) * m * 4 bytes of embedding rows and n * B * 4
// bytes of output.  The products run in IEEE float32 on the FMA units (with
// bf16, on operands rounded to bf16, as the TPU's bf16 matmul takes them).
//
// Design: one CTA of 256 threads owns DT docs and keeps their word rows'
// embeddings in shared memory, transposed, in tiles of at most 128 rows
// (R = DT * h1 rows in one tile when h1 <= 128; a doc of more words is the
// CTA's only doc and its rows are taken 128 at a time).  It loops over the
// queries in groups whose words fill up to 1,024 columns.  For each group and
// row tile, tiles::gram_min_cols stages the query words 16 features at a time
// and computes 32 x 128 distance tiles with a 4 x 4 register tile per thread,
// folding every squared distance into the per-(doc word, query) minimum of
// the tile and the per-(doc, query word) minimum of the group in shared
// memory (atomicMin, so the row tiles of one doc fold into the same column
// minima).  After each row tile one thread per (doc, query) adds the tile's
// rows to d12 in slot order; after the last, it takes d21 and writes
// max(d12, d21).  Neither h is padded to 128.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::BIG;
constexpr int ROWS_MAX = 4 * tiles::TR;  // word rows of one tile

struct Idx {
  const int* ids;
  int base, n_rows;
  __device__ int operator()(int r) const { return r < n_rows ? ids[base + r] : 0; }
};

template <int NRT>
__global__ void __launch_bounds__(tiles::GRAM_THREADS)
rwmd_pairwise_kernel(const float* __restrict__ emb,   // (v, m)
                     const int* __restrict__ r_ids,   // (n, h1)
                     const float* __restrict__ r_w,   // (n, h1)
                     const int* __restrict__ q_ids,   // (B, h2)
                     const float* __restrict__ q_w,   // (B, h2)
                     float* __restrict__ out,         // (n, B)
                     int n, int b, int h1, int h2, int m, int dt, int qg,
                     int bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rt = NRT * tiles::TR;                             // rows per tile
  const int ldd = rt + 4;
  const int d0 = blockIdx.x * dt;
  const int nd = min(dt, n - d0);
  const int rows = nd * h1;                                   // this CTA's word rows
  const int ntiles = (rows + rt - 1) / rt;                    // > 1 only when dt == 1
  float* ds = reinterpret_cast<float*>(smem);                 // [m][ldd]
  float* a2s = ds + (size_t)m * ldd;                          // [ldd]
  float* rv = a2s + ldd;                                      // [ldd] validity
  float* w1s = rv + ldd;                                      // [ldd] weights
  float* qs = w1s + ldd;                                      // [KC][QS_LD]
  float* b2s = qs + tiles::KC * tiles::QS_LD;                 // [TC]
  float* vs = b2s + tiles::TC;                                // [TC]
  float* d12s = vs + tiles::TC;                               // [dt][qg]
  unsigned* rowmin = reinterpret_cast<unsigned*>(d12s + dt * qg);  // [ldd][qg]
  unsigned* colmin = rowmin + (size_t)ldd * qg;               // [dt][qg * h2]

  // Rows [t0, t0 + R) of the CTA's word rows into ds, a2s, w1s and rv.
  auto load_tile = [&](int t0, int R) {
    tiles::load_rows_transposed(emb, Idx{r_ids, d0 * h1 + t0, R}, R, m, bf16,
                                ds, ldd, a2s);
    for (int r = threadIdx.x; r < ldd; r += blockDim.x) {
      const float w = r < R ? r_w[(size_t)d0 * h1 + t0 + r] : 0.f;
      w1s[r] = w;
      rv[r] = w > 0.f ? 1.f : 0.f;
    }
  };
  if (ntiles == 1) load_tile(0, rows);

  const int ldc = qg * h2;
  for (int q0 = 0; q0 < b; q0 += qg) {
    const int nq = min(qg, b - q0);
    for (int e = threadIdx.x; e < dt * ldc; e += blockDim.x) colmin[e] = tiles::big_bits();
    for (int e = threadIdx.x; e < dt * qg; e += blockDim.x) d12s[e] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * rt;
      const int R = min(rt, rows - t0);
      if (ntiles > 1) load_tile(t0, R);
      for (int e = threadIdx.x; e < ldd * qg; e += blockDim.x) rowmin[e] = tiles::big_bits();
      __syncthreads();
      // A row's doc is r / h1: the CTA's own row when there is one tile, 0
      // (the only doc) when there are more.
      tiles::gram_min_cols<NRT, true>(
          ds, ldd, a2s, R, m, emb, q_ids, q_w, q0 * h2, nq * h2, h2, bf16, qs,
          b2s, vs, rowmin, qg, q0, rv, colmin, ldc, h1, q0 * h2);
      for (int e = threadIdx.x; e < nd * nq; e += blockDim.x) {
        const int d = e / nq, q = e % nq;
        const int g_end = min((d + 1) * h1, t0 + R);
        float d12 = d12s[d * qg + q];
        for (int g = max(d * h1, t0); g < g_end; ++g) {
          const int r = g - t0;
          const float w = w1s[r];
          if (w > 0.f) {
            const unsigned bits = rowmin[r * qg + q];
            const float mn = bits == tiles::big_bits() ? BIG : sqrtf(__uint_as_float(bits));
            d12 = fmaf(w, mn, d12);
          }
        }
        d12s[d * qg + q] = d12;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < nd * nq; e += blockDim.x) {
      const int d = e / nq, q = e % nq;
      float d21 = 0.f;
      const float* w2 = q_w + (size_t)(q0 + q) * h2;
      for (int c = 0; c < h2; ++c) {
        const float w = w2[c];
        if (w > 0.f) {
          const unsigned bits = colmin[d * ldc + q * h2 + c];
          const float mn = bits == tiles::big_bits() ? BIG : sqrtf(__uint_as_float(bits));
          d21 = fmaf(w, mn, d21);
        }
      }
      out[(size_t)(d0 + d) * b + q0 + q] = fmaxf(d12s[d * qg + q], d21);
    }
    __syncthreads();
  }
}

template <int NRT>
int launch(const void* emb, const void* r_ids, const void* r_w,
           const void* q_ids, const void* q_w, void* out, int n, int b, int h1,
           int h2, int m, int dt, int qg, int bf16, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rwmd_pairwise_kernel<NRT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwmd_pairwise_kernel<NRT><<<(n + dt - 1) / dt, tiles::GRAM_THREADS, smem,
                              stream>>>(
      (const float*)emb, (const int*)r_ids, (const float*)r_w,
      (const int*)q_ids, (const float*)q_w, (float*)out, n, b, h1, h2, m, dt,
      qg, bf16);
  return (int)cudaGetLastError();
}

// 32-row tiles in one row tile (the kernel's NRT), and the shared memory of
// one CTA in bytes (kernels/rwmd_pairwise.py checks the same sum against the
// card's limit before launching).
int row_tiles(int h1, int dt) {
  const int rows = dt * h1 < ROWS_MAX ? dt * h1 : ROWS_MAX;
  return (rows + tiles::TR - 1) / tiles::TR;
}

size_t smem_bytes(int h1, int h2, int m, int dt, int qg) {
  const size_t ldd = row_tiles(h1, dt) * tiles::TR + 4;
  return 4 * (m * ldd + 3 * ldd + tiles::KC * tiles::QS_LD + 2 * tiles::TC
              + (size_t)dt * qg + ldd * qg + (size_t)dt * qg * h2);
}

}  // namespace

extern "C" int launch_rwmd_pairwise(const void* emb, const void* r_ids,
                                    const void* r_w, const void* q_ids,
                                    const void* q_w, void* out, int n, int b,
                                    int h1, int h2, int m, int dt, int qg,
                                    int bf16, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  const int nrt = row_tiles(h1, dt);
  const size_t smem = smem_bytes(h1, h2, m, dt, qg);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nrt) {
    case 1: return launch<1>(emb, r_ids, r_w, q_ids, q_w, out, n, b, h1, h2, m, dt, qg, bf16, smem, s);
    case 2: return launch<2>(emb, r_ids, r_w, q_ids, q_w, out, n, b, h1, h2, m, dt, qg, bf16, smem, s);
    case 3: return launch<3>(emb, r_ids, r_w, q_ids, q_w, out, n, b, h1, h2, m, dt, qg, bf16, smem, s);
    case 4: return launch<4>(emb, r_ids, r_w, q_ids, q_w, out, n, b, h1, h2, m, dt, qg, bf16, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
