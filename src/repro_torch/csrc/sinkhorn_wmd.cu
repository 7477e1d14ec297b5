// Batched Sinkhorn-WMD on Hopper: one log-domain, epsilon-scaled Sinkhorn
// solve per (candidate, query) pair, returning <P, C> per pair.
//
// Replaces the TPU kernel src/repro/kernels/sinkhorn_wmd.py,
// sinkhorn_wmd_pallas (_sinkhorn_kernel, _lse).
//
// What bounds it: operations, and of them the transcendentals.  Building
// the cost tile is n1*n2*m FMAs per pair (n1, n2: the pair's valid words);
// every Sinkhorn iteration then needs two exps per valid entry (below), so
// iterations x 2*n1*n2 exps on the SFUs dominate.  Inputs are small (the
// pairs' word embeddings, read once).
//
// Design.  A team of warps solves one pair: one warp per pair, four pairs
// a CTA, when both padded widths are <= 48 (the cascade's h = 48); else the
// CTA's 8 warps, for any widths whose tile fits shared memory (Table IV set
// 1's h = 160; up to about 230 a side when h1 = h2, and e.g. 400 x 32).
// sinkhorn_smem_bytes() gives the size; the launcher refuses what does not
// fit.  A team never waits on a block barrier for another pair, and pairs
// stop independently.
//
// - Valid words only.  Warp 0 of the team lists the pair's valid rows (w1 >
//   0) and columns (w2 > 0) by ballot into shared memory; everything after
//   runs over the n1 x n2 compact tile.  Masked entries of the reference
//   add exactly 0 and leave the order of the rest, so this is its result.
// - Cost tile sqrt(max(|a|^2 + |b|^2 - 2ab, 0)).  Rows are staged 8
//   features at a time through shared memory, two lanes a row, each lane a
//   16-byte load (a 32-byte sector a row; no lane reads a lone word of
//   another row) that fills the row's whole 128-byte line into L2 for the
//   next three chunks, while a prefetch asks for the line after (holding
//   the next chunk in registers instead was slower: 128 registers a thread
//   are the cap at 16 warps an SM), with the squared norms summed from the
//   staged values.  Thread t of the team then owns column t and keeps the
//   dot products of up to 48 rows in registers, four rows between exit
//   tests, reading each staged row as a broadcast float4.  The tile (odd
//   row stride: conflict-free by rows and by columns) never leaves shared
//   memory.
// - Iterations in base 2: with K = log2(e) / eps the potentials are held
//   as u = f K, v = g K, and every exp is one exp2f of an fmaf (no range
//   reduction, denormals kept: built without --use_fast_math).
// - Two sweeps per iteration, not three.  The row sweep of iteration k + 1
//   sums S_i = sum_j 2^(v_j - K C_ij + u_i - log2 a_i), which is both the
//   row marginal of iteration k divided by a_i (its L1 error decides the
//   stop) and, as u_i - log2 S_i, the next f update.  Its shift comes from
//   the current potentials, so the log-sum-exp takes one sweep; where S
//   leaves [2^-40, 2^64] (the potentials moved too far for that shift to be
//   safe) the row is summed again with its max as the shift, as the
//   reference does.  The column sweep is the same with v_j - log2 b_j.
// - The final plan is row-max stabilised and rescaled to the row marginal
//   only (the reference's rounding); <P, C> per row is its scale times the
//   sum of plan * cost.  The +1e-38 inside each log-sum-exp and the 1e-30
//   division floor are the reference's.
//
// The epsilon ladder (a few levels) comes by value in the launch's
// parameters: no device copy per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SMALL_H = 48;     // widest padded side of the warp-per-pair route
constexpr int SMALL_PAIRS = 4;  // pairs (warps) per CTA on that route
constexpr int LARGE_WARPS = 8;  // warps per pair on the CTA-per-pair route
constexpr int KC = 8;           // features per staged chunk of the cost tile
constexpr int RG = 48;          // tile rows per build pass (dot products a thread keeps)
constexpr int MAXL = 16;        // epsilon levels a launch takes
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on the H100
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  float k[MAXL];      // log2(e) / eps of each level
  float ratio[MAXL];  // k[l] / k[l - 1]: the potentials' rescale at level l
  int n;
};

// A team's shared memory, in floats from its base (s1 first and the total a
// multiple of 4, so every team's s1 is 16-byte aligned).
struct Layout {
  int s1, s2, tile, u, un, v, wa, la2, lb2, ridx, cidx, misc, total;
};

__host__ __device__ inline Layout layout(int h1, int h2, int w) {
  Layout L;
  L.s1 = 0;                               // [RG][KC] staged rows of t1
  L.s2 = L.s1 + RG * KC;                  // [32 w][KC + 1] staged rows of t2
  L.tile = L.s2 + 32 * w * (KC + 1);      // [h1][h2 | 1] cost tile
  L.u = L.tile + h1 * (h2 | 1);           // [h1] f * K (|t1|^2 while building)
  L.un = L.u + h1;                        // [h1] the row sweep's new u
  L.v = L.un + h1;                        // [h2] g * K (|t2|^2 while building)
  L.wa = L.v + h2;                        // [h1] valid row weights a
  L.la2 = L.wa + h1;                      // [h1] log2 a
  L.lb2 = L.la2 + h1;                     // [h2] log2 b
  L.ridx = L.lb2 + h2;                    // [h1] valid rows (int)
  L.cidx = L.ridx + h1;                   // [h2] valid columns (int)
  L.misc = L.cidx + h2;                   // n1, n2, err of the masked rows, [w] sums
  L.total = (L.misc + 3 + w + 3) & ~3;
  return L;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int W>
struct Team {
  static constexpr int T = 32 * W;
  __device__ static int tid() { return W == 1 ? (int)threadIdx.x % 32 : (int)threadIdx.x; }
  __device__ static void sync() {
    if (W == 1) __syncwarp(); else __syncthreads();
  }
  // Sum over the team; every thread gets it.  red: W floats.
  __device__ static float sum(float x, float* red) {
    x = warp_sum(x);
    if (W == 1) return x;
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) s += red[i];
    __syncthreads();
    return s;
  }
};

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum over k < n of exp2f(x(k)), in four interleaved partial sums (four
// independent chains of loads, exps and adds in flight)
template <class X>
__device__ __forceinline__ float sum_exp2(int n, X x) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
#pragma unroll 2
  for (; k + 3 < n; k += 4) {
    s0 += exp2f(x(k));
    s1 += exp2f(x(k + 1));
    s2 += exp2f(x(k + 2));
    s3 += exp2f(x(k + 3));
  }
  for (; k < n; ++k) s0 += exp2f(x(k));
  return (s0 + s1) + (s2 + s3);
}

template <class X>
__device__ __forceinline__ float max_of(int n, X x) {
  float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
  int k = 0;
  for (; k + 1 < n; k += 2) {
    m0 = fmaxf(m0, x(k));
    m1 = fmaxf(m1, x(k + 1));
  }
  if (k < n) m0 = fmaxf(m0, x(k));
  return fmaxf(m0, m1);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 16 bytes from global memory; a miss fills the whole 128-byte line into
// L2, so the next three 32-byte chunks of the row find it there.
__device__ __forceinline__ float4 load_line(const float* p) {
  float4 x;
  asm volatile("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "l"(p));
  return x;
}

// The potential update of one row (or column) from its shifted sum s of
// 2^(x(k) + shift), x(k) = v_j - K C_ij (or u_i - K C_ij), shift = pot -
// lw (lw = log2 of its weight): the new potential, and the marginal it had.
template <class X>
__device__ __forceinline__ float update(int n, X x, float pot, float lw,
                                        float wt, float& marginal) {
  const float s = sum_exp2(n, [&](int k) { return x(k) + (pot - lw); });
  if (s >= 0x1p-40f && s <= 0x1p64f) {
    marginal = wt * s;
    return pot - log2f(s + 1e-38f);
  }
  if (n == 0) {
    marginal = 0.f;
    return pot;
  }
  const float mx = max_of(n, x);
  const float s2 = sum_exp2(n, [&](int k) { return x(k) - mx; });
  marginal = exp2f(pot + mx) * s2;
  return lw - (mx + log2f(s2 + 1e-38f));
}

template <int W, bool BF16, bool VEC>
__global__ void __launch_bounds__(W == 1 ? 32 * SMALL_PAIRS : 32 * W, W == 1 ? 4 : 1)
sinkhorn_kernel(const float* __restrict__ t1,   // (P, h1, m)
                const float* __restrict__ w1,   // (P, h1)
                const float* __restrict__ t2,   // (P, h2, m)
                const float* __restrict__ w2,   // (P, h2)
                float* __restrict__ out,        // (P,)
                int* __restrict__ iters,        // (P,) iterations, all levels
                const Levels lev, int n_pairs, int h1, int h2, int m,
                int max_iters, float tol) {
  using TM = Team<W>;
  constexpr int T = TM::T;
  constexpr int EPT = ((RG + T) * (KC / 4) + T - 1) / T;  // float4s a thread stages
  extern __shared__ __align__(16) float sm[];
  const Layout L = layout(h1, h2, W);
  const int team = W == 1 ? (int)threadIdx.x / 32 : 0;
  const int p = W == 1 ? blockIdx.x * SMALL_PAIRS + team : blockIdx.x;
  if (p >= n_pairs) return;  // a whole warp (W == 1); never for W > 1
  float* base = sm + (size_t)team * L.total;
  float* s1 = base + L.s1;
  float* s2 = base + L.s2;
  float* tile = base + L.tile;
  float* u = base + L.u;
  float* un = base + L.un;
  float* v = base + L.v;
  float* wa = base + L.wa;
  float* la2 = base + L.la2;
  float* lb2 = base + L.lb2;
  int* ridx = reinterpret_cast<int*>(base + L.ridx);
  int* cidx = reinterpret_cast<int*>(base + L.cidx);
  int* cnt = reinterpret_cast<int*>(base + L.misc);  // [0] n1, [1] n2
  float* err_masked = base + L.misc + 2;
  float* red = base + L.misc + 3;
  const int tid = TM::tid(), lane = threadIdx.x % 32;

  // --- the valid rows and columns, listed by the team's first warp ---
  if (W == 1 || threadIdx.x < 32) {
    float masked = 0.f;  // sum of |w1| over the masked rows: their |0 - w1| terms
    int n = 0;
    for (int i0 = 0; i0 < h1; i0 += 32) {
      const int i = i0 + lane;
      const float x = i < h1 ? w1[(size_t)p * h1 + i] : 0.f;
      const bool f = x > 0.f;
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) {
        const int pos = n + __popc(bal & ((1u << lane) - 1u));
        ridx[pos] = i;
        wa[pos] = x;
        la2[pos] = log2f(fmaxf(x, 1e-38f));
      } else if (i < h1) {
        masked += fabsf(x);
      }
      n += __popc(bal);
    }
    int nc = 0;
    for (int j0 = 0; j0 < h2; j0 += 32) {
      const int j = j0 + lane;
      const float x = j < h2 ? w2[(size_t)p * h2 + j] : 0.f;
      const bool f = x > 0.f;
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) {
        const int pos = nc + __popc(bal & ((1u << lane) - 1u));
        cidx[pos] = j;
        lb2[pos] = log2f(fmaxf(x, 1e-38f));
      }
      nc += __popc(bal);
    }
    masked = warp_sum(masked);
    if (lane == 0) {
      cnt[0] = n;
      cnt[1] = nc;
      *err_masked = masked;
    }
  }
  TM::sync();
  const int n1 = cnt[0], n2 = cnt[1];
  const int ld = n2 | 1;

  // --- the cost tile over the valid words ---
  for (int rg = 0; rg < n1; rg += RG) {
    const int nr = min(RG, n1 - rg);
    for (int cg = 0; cg < n2; cg += T) {
      const int nc = min(T, n2 - cg);
      float acc[RG], nrm[EPT];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = 0.f;
      // element e of a chunk: row e / 2 of the stage (t1's nr rows, then
      // t2's nc), features k0 + 4 (e % 2) .. + 3; each thread's elements
      // are the same at every chunk
      const float* src[EPT];
#pragma unroll
      for (int s = 0; s < EPT; ++s) {
        nrm[s] = 0.f;
        const int r = (tid + s * T) >> 1;
        src[s] = r >= nr + nc ? nullptr
                 : r < nr ? t1 + ((size_t)p * h1 + ridx[rg + r]) * m
                          : t2 + ((size_t)p * h2 + cidx[cg + r - nr]) * m;
      }
      for (int k0 = 0; k0 < m; k0 += KC) {
        float4 x[EPT];  // this chunk: every load issued before any is used
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          const int k = k0 + 4 * ((tid + s * T) & 1);
          x[s] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (!src[s]) continue;
          // at a row's line start, ask L2 for its next line
          if (VEC && (k & 31) == 0 && k + 32 < m) prefetch_l2(src[s] + k + 32);
          if (VEC) {
            if (k < m) x[s] = load_line(src[s] + k);
          } else {
            x[s].x = k < m ? src[s][k] : 0.f;
            x[s].y = k + 1 < m ? src[s][k + 1] : 0.f;
            x[s].z = k + 2 < m ? src[s][k + 2] : 0.f;
            x[s].w = k + 3 < m ? src[s][k + 3] : 0.f;
          }
        }
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          const int e = tid + s * T, r = e >> 1;
          if (!src[s]) continue;
          float4 y = x[s];
          nrm[s] = fmaf(y.w, y.w, fmaf(y.z, y.z, fmaf(y.y, y.y, fmaf(y.x, y.x, nrm[s]))));
          if (BF16) {
            y.x = to_bf16(y.x); y.y = to_bf16(y.y); y.z = to_bf16(y.z); y.w = to_bf16(y.w);
          }
          if (r < nr) {
            *reinterpret_cast<float4*>(s1 + r * KC + 4 * (e & 1)) = y;
          } else {
            float* dst = s2 + (r - nr) * (KC + 1) + 4 * (e & 1);
            dst[0] = y.x; dst[1] = y.y; dst[2] = y.z; dst[3] = y.w;
          }
        }
        TM::sync();
        if (tid < nc) {
          float bv[KC];
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) bv[kk] = s2[tid * (KC + 1) + kk];
          // four rows at a time: four independent chains between the exits
          // (rows past nr read stale staging and are never written)
#pragma unroll
          for (int r0 = 0; r0 < RG; r0 += 4) {
            if (r0 >= nr) break;
#pragma unroll
            for (int r = r0; r < r0 + 4; ++r) {
              const float4 a0 = *reinterpret_cast<const float4*>(s1 + r * KC);
              const float4 a1 = *reinterpret_cast<const float4*>(s1 + r * KC + 4);
              float y = acc[r];
              y = fmaf(a0.x, bv[0], y); y = fmaf(a0.y, bv[1], y);
              y = fmaf(a0.z, bv[2], y); y = fmaf(a0.w, bv[3], y);
              y = fmaf(a1.x, bv[4], y); y = fmaf(a1.y, bv[5], y);
              y = fmaf(a1.z, bv[6], y); y = fmaf(a1.w, bv[7], y);
              acc[r] = y;
            }
          }
        }
        TM::sync();
      }
      // squared norms: element e's partner e ^ 1 is in lane ^ 1 (T is even)
#pragma unroll
      for (int s = 0; s < EPT; ++s) {
        const float tot = nrm[s] + __shfl_xor_sync(FULL, nrm[s], 1);
        const int e = tid + s * T, r = e >> 1;
        if (!(e & 1) && r < nr + nc) {
          if (r < nr) u[rg + r] = tot;
          else v[cg + r - nr] = tot;
        }
      }
      TM::sync();
      if (tid < nc) {
        const int j = cg + tid;
        const float b2 = v[j];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          if (r >= nr) break;
          tile[(rg + r) * ld + j] = sqrtf(fmaxf(u[rg + r] + b2 - 2.f * acc[r], 0.f));
        }
      }
      TM::sync();
    }
  }
  for (int i = tid; i < n1; i += T) u[i] = 0.f;
  for (int j = tid; j < n2; j += T) v[j] = 0.f;
  TM::sync();
  const float masked_err = *err_masked;

  // --- Sinkhorn over the epsilon ladder ---
  int total_it = 0;
  for (int l = 0; l < lev.n; ++l) {
    const float K = lev.k[l];
    if (l > 0) {
      const float ratio = lev.ratio[l];
      for (int i = tid; i < n1; i += T) u[i] *= ratio;
      for (int j = tid; j < n2; j += T) v[j] *= ratio;
      TM::sync();
    }
    int it = 0;
    for (; it < max_iters; ++it) {
      // rows: the last iteration's row marginal, and the f update into un
      // (u stays as it was if the stop check below ends the level)
      float e_part = 0.f;
      for (int i = tid; i < n1; i += T) {
        const float* crow = tile + i * ld;
        float marginal;
        un[i] = update(n2, [&](int j) { return fmaf(-crow[j], K, v[j]); },
                       u[i], la2[i], wa[i], marginal);
        e_part += fabsf(marginal - wa[i]);
      }
      if (it > 0) {
        const float err = TM::sum(e_part, red) + masked_err;
        if (!(err > tol)) break;  // team-uniform
      }
      float* const swap = u;  // the new u; the old buffer takes the next one
      u = un;
      un = swap;
      TM::sync();
      // columns: the g update (only thread j reads v[j] in this sweep)
      for (int j = tid; j < n2; j += T) {
        float marginal;
        v[j] = update(n1, [&](int i) { return fmaf(-tile[i * ld + j], K, u[i]); },
                      v[j], lb2[j], 1.f, marginal);
      }
      TM::sync();
    }
    total_it += it;
  }

  // --- the row-max-stabilised plan, rescaled to the row marginal; <P, C> ---
  const float K = lev.k[lev.n - 1];
  float c_part = 0.f;
  for (int i = tid; i < n1 && n2 > 0; i += T) {
    const float* crow = tile + i * ld;
    const float ui = u[i];
    auto x = [&](int j) { return fmaf(-crow[j], K, ui + v[j]); };
    const float mx = max_of(n2, x);
    float row = 0.f, pc = 0.f, row1 = 0.f, pc1 = 0.f;
    int j = 0;
    for (; j + 1 < n2; j += 2) {
      const float p0 = exp2f(x(j) - mx), p1 = exp2f(x(j + 1) - mx);
      row += p0;
      pc = fmaf(p0, crow[j], pc);
      row1 += p1;
      pc1 = fmaf(p1, crow[j + 1], pc1);
    }
    if (j < n2) {
      const float p0 = exp2f(x(j) - mx);
      row += p0;
      pc = fmaf(p0, crow[j], pc);
    }
    row += row1;
    pc += pc1;
    c_part += wa[i] / fmaxf(row, 1e-30f) * pc;
  }
  const float cost = TM::sum(c_part, red);
  if (tid == 0) {
    out[p] = cost;
    iters[p] = total_it;
  }
}

template <int W, bool BF16, bool VEC>
int launch(const float* t1, const float* w1, const float* t2, const float* w2,
           float* out, int* iters, const Levels& lev, int p, int h1, int h2,
           int m, int max_iters, float tol, size_t smem, cudaStream_t s) {
  auto kern = sinkhorn_kernel<W, BF16, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = W == 1 ? (p + SMALL_PAIRS - 1) / SMALL_PAIRS : p;
  const int threads = W == 1 ? 32 * SMALL_PAIRS : 32 * W;
  kern<<<grid, threads, smem, s>>>(t1, w1, t2, w2, out, iters, lev, p, h1, h2,
                                   m, max_iters, tol);
  return (int)cudaGetLastError();
}

template <int W>
int launch_w(const float* t1, const float* w1, const float* t2,
             const float* w2, float* out, int* iters, const Levels& lev,
             int p, int h1, int h2, int m, int max_iters, float tol, int bf16,
             size_t smem, cudaStream_t s) {
  const bool vec = m % 4 == 0 && (size_t)t1 % 16 == 0 && (size_t)t2 % 16 == 0;
  if (bf16)
    return vec ? launch<W, true, true>(t1, w1, t2, w2, out, iters, lev, p, h1, h2, m, max_iters, tol, smem, s)
               : launch<W, true, false>(t1, w1, t2, w2, out, iters, lev, p, h1, h2, m, max_iters, tol, smem, s);
  return vec ? launch<W, false, true>(t1, w1, t2, w2, out, iters, lev, p, h1, h2, m, max_iters, tol, smem, s)
             : launch<W, false, false>(t1, w1, t2, w2, out, iters, lev, p, h1, h2, m, max_iters, tol, smem, s);
}

// Dynamic shared memory of one CTA for (h1, h2) pairs on their route.
size_t smem_bytes(int h1, int h2) {
  // a tile alone over the limit (and no int overflow in the layout)
  if ((size_t)h1 * (size_t)(h2 | 1) > SMEM_LIMIT / sizeof(float)) return SMEM_LIMIT + 1;
  const bool small = h1 <= SMALL_H && h2 <= SMALL_H;
  return sizeof(float) * (size_t)layout(h1, h2, small ? 1 : LARGE_WARPS).total *
         (small ? SMALL_PAIRS : 1);
}

}  // namespace

// Bytes of shared memory one CTA of the kernel needs for (h1, h2) pairs;
// the launcher refuses more than 227 KB.
extern "C" int sinkhorn_smem_bytes(int h1, int h2) {
  return (int)smem_bytes(h1, h2);
}

// levels: n_levels host floats, log2(e) / eps of each level.
extern "C" int launch_sinkhorn_wmd(const void* t1, const void* w1,
                                   const void* t2, const void* w2, void* out,
                                   void* iters, const void* levels, int p,
                                   int h1, int h2, int m, int n_levels,
                                   int max_iters, float tol, int bf16,
                                   void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (n_levels < 1 || n_levels > MAXL || h1 < 1 || h2 < 1)
    return (int)cudaErrorInvalidValue;
  Levels lev;
  const float* k = (const float*)levels;
  for (int l = 0; l < n_levels; ++l) {
    lev.k[l] = k[l];
    lev.ratio[l] = l ? k[l] / k[l - 1] : 1.f;
  }
  lev.n = n_levels;
  const bool small = h1 <= SMALL_H && h2 <= SMALL_H;
  const size_t smem = smem_bytes(h1, h2);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)t1;
  const float* b = (const float*)t2;
  cudaStream_t s = (cudaStream_t)stream;
  if (small)
    return launch_w<1>(a, (const float*)w1, b, (const float*)w2, (float*)out,
                       (int*)iters, lev, p, h1, h2, m, max_iters, tol, bf16, smem, s);
  return launch_w<LARGE_WARPS>(a, (const float*)w1, b, (const float*)w2,
                               (float*)out, (int*)iters, lev, p, h1, h2, m,
                               max_iters, tol, bf16, smem, s);
}
