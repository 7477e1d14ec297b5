// LC-RWMD phase 2 folded into a streaming per-query top-k on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_stream.py,
// fused_lc_rwmd_topk_pallas (_fused_topk_kernel, _insert_candidates).  The
// TPU version holds all of Z in VMEM; Z (v_e x B, 18.7 MB at the slice's
// size) cannot fit 227 KB of shared memory, so phase 1 (lc_rwmd_phase1.cu)
// writes Z to HBM and this file does the rest:
//
//   fused_topk_partial: each CTA takes a contiguous range of doc rows and a
//     chunk of up to 64 queries.  A warp computes one row's D as the ELL
//     SpMM does (spmm_ell.cu), 8 rows per step, into shared memory; then
//     each warp folds those rows into the k-smallest carries of its queries,
//     which live in shared memory, ordered by (value, doc id).  Rows arrive
//     in ascending id, so a candidate goes before exactly the entries whose
//     value is <= its own; a candidate no smaller than the k-th entry is
//     dropped after one compare.  Rows >= n_real are dropped.  The CTA
//     writes its (B, k) partial.
//   topk_merge: merges pairs of sorted partial lists by rank (a binary
//     search of each element in the other list), in the same (value, id)
//     order, halving the number of lists per launch.  Empty slots are
//     (3.4e38, -1).
//
// No (n, B) tensor is written: the D rows live only in shared memory.
//
// What bounds it: memory, as for the SpMM: the ids/weights read (~269 MB at
// n=700,000, h=48) with the Z gathers served from L2; the output is only
// B*k pairs.  The carry insertions are a few shared-memory compares per
// (row, query) once the carries have filled.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;        // rows per step, one per warp
constexpr int QC = 64;          // queries per CTA (2 per lane)
constexpr int KMAX = 128;       // largest k this kernel takes
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(WARPS * 32)
fused_topk_partial_kernel(const int* __restrict__ ids,   // (n, h)
                          const float* __restrict__ w,   // (n, h)
                          const float* __restrict__ z,   // (v, B)
                          float* __restrict__ part_vals, // (n_ctas, B, k)
                          int* __restrict__ part_idx,    // (n_ctas, B, k)
                          int n, int n_real, int h, int b, int k,
                          int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cv = reinterpret_cast<float*>(smem);          // [QC][k]
  int* ci = reinterpret_cast<int*>(cv + QC * k);       // [QC][k]
  float* dt = reinterpret_cast<float*>(ci + QC * k);   // [WARPS][QC]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, b - q0);
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(min(n, n_real), r0 + rows_per_cta);

  for (int i = threadIdx.x; i < QC * k; i += blockDim.x) {
    cv[i] = BIG;
    ci[i] = -1;
  }
  __syncthreads();

  for (int tile = r0; tile < r1; tile += WARPS) {
    // --- phase 2: one doc row per warp, lanes over the query columns ---
    const int row = tile + warp;
    if (row < r1) {
      const int* ir = ids + (size_t)row * h;
      const float* wr = w + (size_t)row * h;
      float a0 = 0.f, a1 = 0.f;
      const int c0 = q0 + lane, c1 = q0 + lane + 32;
      for (int p0 = 0; p0 < h; p0 += 32) {
        const int p = p0 + lane;
        const int my_id = p < h ? ir[p] : 0;
        const float my_w = p < h ? wr[p] : 0.f;
        const int np = min(32, h - p0);
        for (int pp = 0; pp < np; ++pp) {
          const float wv = __shfl_sync(0xffffffffu, my_w, pp);
          const int id = __shfl_sync(0xffffffffu, my_id, pp);
          if (wv == 0.f) continue;  // warp-uniform; exact since Z is finite
          const float* zr = z + (size_t)id * b;
          if (c0 < b) a0 = fmaf(wv, zr[c0], a0);
          if (c1 < b) a1 = fmaf(wv, zr[c1], a1);
        }
      }
      dt[warp * QC + lane] = a0;
      dt[warp * QC + lane + 32] = a1;
    }
    __syncthreads();

    // --- fold the step's rows into the carries, one warp per query ---
    for (int c = warp; c < nq; c += WARPS) {
      float* cq = cv + c * k;
      int* iq = ci + c * k;
      for (int r = 0; r < WARPS; ++r) {
        const int gid = tile + r;
        if (gid >= r1) break;
        const float val = dt[r * QC + c];
        if (!(val < cq[k - 1])) continue;
        int rank = 0;
        for (int j0 = 0; j0 < k; j0 += 32) {
          const int j = j0 + lane;
          rank += __popc(__ballot_sync(0xffffffffu, j < k && cq[j] <= val));
        }
        float sv[KMAX / 32];
        int si[KMAX / 32];
#pragma unroll
        for (int t = 0; t < KMAX / 32; ++t) {
          const int j = rank + 1 + lane + 32 * t;
          if (j < k) { sv[t] = cq[j - 1]; si[t] = iq[j - 1]; }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < KMAX / 32; ++t) {
          const int j = rank + 1 + lane + 32 * t;
          if (j < k) { cq[j] = sv[t]; iq[j] = si[t]; }
        }
        if (lane == 0) { cq[rank] = val; iq[rank] = gid; }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nq * k; i += blockDim.x) {
    const int c = i / k, j = i % k;
    const size_t o = ((size_t)blockIdx.x * b + q0 + c) * k + j;
    part_vals[o] = cv[c * k + j];
    part_idx[o] = ci[c * k + j];
  }
}

__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

// Number of entries of the sorted list (v, ix) that go before (x, xi):
// strictly before when strict, else before or equal.
__device__ int rank_in(const float* v, const int* ix, int k, float x, int xi,
                       bool strict) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const bool before = strict ? lex_less(v[mid], ix[mid], x, xi)
                               : !lex_less(x, xi, v[mid], ix[mid]);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void topk_merge_kernel(const float* __restrict__ in_vals,  // (n_in, B, k)
                                  const int* __restrict__ in_idx,
                                  float* __restrict__ out_vals,       // (n_out, B, k)
                                  int* __restrict__ out_idx,
                                  int n_in, int b, int k) {
  const int pair = blockIdx.x, q = blockIdx.y;
  const int la = 2 * pair, lb = 2 * pair + 1;
  const float* av = in_vals + ((size_t)la * b + q) * k;
  const int* ai = in_idx + ((size_t)la * b + q) * k;
  float* ov = out_vals + ((size_t)pair * b + q) * k;
  int* oi = out_idx + ((size_t)pair * b + q) * k;
  if (lb >= n_in) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) { ov[j] = av[j]; oi[j] = ai[j]; }
    return;
  }
  const float* bv = in_vals + ((size_t)lb * b + q) * k;
  const int* bi = in_idx + ((size_t)lb * b + q) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int pa = j + rank_in(bv, bi, k, av[j], ai[j], true);
    if (pa < k) { ov[pa] = av[j]; oi[pa] = ai[j]; }
    const int pb = j + rank_in(av, ai, k, bv[j], bi[j], false);
    if (pb < k) { ov[pb] = bv[j]; oi[pb] = bi[j]; }
  }
}

}  // namespace

extern "C" int launch_fused_topk_partial(const void* ids, const void* w,
                                         const void* z, void* part_vals,
                                         void* part_idx, int n, int n_real,
                                         int h, int b, int k, int rows_per_cta,
                                         void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const int n_ctas = (n + rows_per_cta - 1) / rows_per_cta;
  if (n_ctas <= 0 || b <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)QC * k * (sizeof(float) + sizeof(int))
                      + (size_t)WARPS * QC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_ctas, (b + QC - 1) / QC);
  fused_topk_partial_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)part_vals,
      (int*)part_idx, n, n_real, h, b, k, rows_per_cta);
  return (int)cudaGetLastError();
}

extern "C" int launch_topk_merge(const void* in_vals, const void* in_idx,
                                 void* out_vals, void* out_idx, int n_in, int b,
                                 int k, void* stream) {
  if (n_in <= 0 || b <= 0) return (int)cudaGetLastError();
  dim3 grid((n_in + 1) / 2, b);
  topk_merge_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const float*)in_vals, (const int*)in_idx, (float*)out_vals,
      (int*)out_idx, n_in, b, k);
  return (int)cudaGetLastError();
}
