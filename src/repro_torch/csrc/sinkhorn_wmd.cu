// Batched Sinkhorn-WMD on Hopper: one log-domain, epsilon-scaled Sinkhorn
// solve per (candidate, query) pair, returning <P, C> per pair.
//
// Replaces the TPU kernel src/repro/kernels/sinkhorn_wmd.py,
// sinkhorn_wmd_pallas (_sinkhorn_kernel, _lse).
//
// What bounds it: operations, and of them the transcendentals.  Building
// the cost tile is h1*h2*m FMAs per pair; every Sinkhorn iteration then
// takes three passes over the (h1, h2) tile with one exp each (the f and g
// log-sum-exps and the row marginal), so iterations x 3*h1*h2 exps per
// pair dominate.  Inputs are small (the pairs' word embeddings, read once).
//
// Design: one CTA per pair.  The (h1, h2) cost tile sqrt(max(|a|^2 + |b|^2
// - 2ab, 0)) is built on chip in shared memory, with an odd row stride so
// that column passes are free of bank conflicts, and never leaves it; the
// potentials f and g live in shared memory too.  Row passes give each warp
// a row and reduce it with warp shuffles; column passes give each warp a
// column.  Each pair runs its own loop over the epsilon ladder (a small
// array from the wrapper) with max_iters and tol on the L1 error of the row
// marginal, which gives the same per-pair result as the TPU's block loop,
// where converged pairs are frozen.  The -1e30 log-domain sentinels, the
// +1e-38 inside the log-sum-exp and the normal-float 1e-30 division floor
// of the final Altschuler rounding are the reference's.  Built without
// --use_fast_math: expf/logf stay accurate and denormals are not flushed.
// Dynamic shared memory is sized from h1 and h2 (h <= 160, Table IV set 1,
// needs ~105 KB, above the 48 KB default, hence cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on the H100

__device__ __forceinline__ float maybe_bf16(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum over the block; every thread gets the result.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS)
sinkhorn_kernel(const float* __restrict__ t1,   // (P, h1, m)
                const float* __restrict__ w1,   // (P, h1)
                const float* __restrict__ t2,   // (P, h2, m)
                const float* __restrict__ w2,   // (P, h2)
                const float* __restrict__ levels,      // (L,) epsilon ladder
                const float* __restrict__ inv_levels,  // (L,) 1 / epsilon
                float* __restrict__ out,        // (P,)
                int* __restrict__ iters,        // (P,) iterations, all levels
                int h1, int h2, int m, int n_levels, int max_iters, float tol,
                int bf16) {
  extern __shared__ __align__(16) float sm[];
  const int ld = h2 | 1;  // odd stride: column passes hit 32 distinct banks
  float* cost = sm;                    // [h1][ld]
  float* f = cost + (size_t)h1 * ld;   // [h1]
  float* g = f + h1;                   // [h2]
  float* log_a = g + h2;               // [h1]
  float* log_b = log_a + h1;           // [h2]
  float* a = log_b + h2;               // [h1] row marginal (weights)
  float* a2 = a + h1;                  // [h1] |t1|^2
  float* b2 = a2 + h1;                 // [h2] |t2|^2
  float* red = b2 + h2;                // [WARPS]

  const int p = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* x1 = t1 + (size_t)p * h1 * m;
  const float* x2 = t2 + (size_t)p * h2 * m;

  for (int i = threadIdx.x; i < h1; i += THREADS) {
    const float wi = w1[(size_t)p * h1 + i];
    a[i] = wi;
    log_a[i] = wi > 0.f ? logf(fmaxf(wi, 1e-38f)) : NEG;
    f[i] = 0.f;
  }
  for (int j = threadIdx.x; j < h2; j += THREADS) {
    const float wj = w2[(size_t)p * h2 + j];
    log_b[j] = wj > 0.f ? logf(fmaxf(wj, 1e-38f)) : NEG;
    g[j] = 0.f;
  }
  // Squared norms, one warp per word.
  for (int r = warp; r < h1 + h2; r += WARPS) {
    const float* xr = r < h1 ? x1 + (size_t)r * m : x2 + (size_t)(r - h1) * m;
    float s = 0.f;
    for (int k = lane; k < m; k += 32) s = fmaf(xr[k], xr[k], s);
    s = warp_sum(s);
    if (lane == 0) { if (r < h1) a2[r] = s; else b2[r - h1] = s; }
  }
  __syncthreads();
  // The cost tile, one entry per thread at a time.
  for (int e = threadIdx.x; e < h1 * h2; e += THREADS) {
    const int i = e / h2, j = e % h2;
    const float* xi = x1 + (size_t)i * m;
    const float* xj = x2 + (size_t)j * m;
    float ab = 0.f;
    for (int k = 0; k < m; ++k)
      ab = fmaf(maybe_bf16(xi[k], bf16), maybe_bf16(xj[k], bf16), ab);
    cost[i * ld + j] = sqrtf(fmaxf(a2[i] + b2[j] - 2.f * ab, 0.f));
  }
  __syncthreads();

#define PAIR_OK(i, j) (log_a[i] > NEG && log_b[j] > NEG)

  int total_it = 0;
  for (int l = 0; l < n_levels; ++l) {
    const float eps = levels[l], inv = inv_levels[l];
    float err = 3.4e38f;
    for (int it = 0; it < max_iters && err > tol; ++it, ++total_it) {
      // f = eps * (log_a - LSE_j((g_j - C_ij) / eps)), one warp per row.
      for (int i = warp; i < h1; i += WARPS) {
        float mx = NEG;
        for (int j = lane; j < h2; j += 32)
          mx = fmaxf(mx, PAIR_OK(i, j) ? (g[j] - cost[i * ld + j]) * inv : NEG);
        mx = warp_max(mx);
        float s = 0.f;
        for (int j = lane; j < h2; j += 32)
          s += expf((PAIR_OK(i, j) ? (g[j] - cost[i * ld + j]) * inv : NEG) - mx);
        s = warp_sum(s);
        if (lane == 0)
          f[i] = log_a[i] > NEG ? eps * (log_a[i] - (mx + logf(s + 1e-38f))) : NEG;
      }
      __syncthreads();
      // g = eps * (log_b - LSE_i((f_i - C_ij) / eps)), one warp per column.
      for (int j = warp; j < h2; j += WARPS) {
        float mx = NEG;
        for (int i = lane; i < h1; i += 32)
          mx = fmaxf(mx, PAIR_OK(i, j) ? (f[i] - cost[i * ld + j]) * inv : NEG);
        mx = warp_max(mx);
        float s = 0.f;
        for (int i = lane; i < h1; i += 32)
          s += expf((PAIR_OK(i, j) ? (f[i] - cost[i * ld + j]) * inv : NEG) - mx);
        s = warp_sum(s);
        if (lane == 0)
          g[j] = log_b[j] > NEG ? eps * (log_b[j] - (mx + logf(s + 1e-38f))) : NEG;
      }
      __syncthreads();
      // L1 error of the row marginal under the new potentials.
      float e_part = 0.f;
      for (int i = warp; i < h1; i += WARPS) {
        float s = 0.f;
        for (int j = lane; j < h2; j += 32)
          s += expf(PAIR_OK(i, j) ? (f[i] + g[j] - cost[i * ld + j]) * inv : NEG);
        s = warp_sum(s);
        if (lane == 0) e_part += fabsf(s - a[i]);
      }
      err = block_sum(e_part, red);
    }
  }

  // Row-max-stabilised plan, Altschuler rounding to the row marginal, <P, C>.
  const float inv = inv_levels[n_levels - 1];
  float c_part = 0.f;
  for (int i = warp; i < h1; i += WARPS) {
    float mx = NEG;
    for (int j = lane; j < h2; j += 32)
      mx = fmaxf(mx, PAIR_OK(i, j) ? (f[i] + g[j] - cost[i * ld + j]) * inv : NEG);
    mx = warp_max(mx);
    mx = mx > -1e35f ? mx : 0.f;
    float row = 0.f;
    for (int j = lane; j < h2; j += 32)
      row += expf((PAIR_OK(i, j) ? (f[i] + g[j] - cost[i * ld + j]) * inv : NEG) - mx);
    row = warp_sum(row);
    const float scale = log_a[i] > NEG ? a[i] / fmaxf(row, 1e-30f) : 0.f;
    float s = 0.f;
    for (int j = lane; j < h2; j += 32) {
      if (!PAIR_OK(i, j)) continue;
      const float c = cost[i * ld + j];
      const float plan = expf((f[i] + g[j] - c) * inv - mx);
      s += (plan * scale) * c;
    }
    c_part += warp_sum(s);
  }
  if (lane != 0) c_part = 0.f;
  const float total = block_sum(c_part, red);
  if (threadIdx.x == 0) {
    out[p] = total;
    iters[p] = total_it;
  }
#undef PAIR_OK
}

}  // namespace

extern "C" int launch_sinkhorn_wmd(const void* t1, const void* w1,
                                   const void* t2, const void* w2,
                                   const void* levels, const void* inv_levels,
                                   void* out, void* iters, int p, int h1,
                                   int h2, int m,
                                   int n_levels, int max_iters, float tol,
                                   int bf16, void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (n_levels < 1 || h1 < 1 || h2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)h1 * (h2 | 1) + 4 * (size_t)h1 + 3 * (size_t)h2 + WARPS);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<<<p, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t1, (const float*)w1, (const float*)t2, (const float*)w2,
      (const float*)levels, (const float*)inv_levels, (float*)out,
      (int*)iters, h1, h2, m,
      n_levels, max_iters, tol, bf16);
  return (int)cudaGetLastError();
}
