// Device building blocks shared by several kernels of this directory.
//
// list_positive: one CTA lists the indices of the positive entries of a
//   vector, in order, with their count (a warp ballot per 32 entries); a
//   caller may keep only a window of the list.  The prep launches of phase
//   1 (lc_rwmd_phase1.cu) and the quadratic RWMD (rwmd_pairwise.cu) list
//   their valid query words with it, and each Z CTA of the fused vocab
//   chunk (fused_chunk.cu) its own 128 valid columns.
//
// g128::gemm: a 128 x 128 register-tiled float32 GEMM of two operands whose
//   rows are gathered from device memory by index (phase 1,
//   lc_rwmd_phase1.cu, the fused vocab chunk's Z, fused_chunk.cu, and the
//   quadratic RWMD, rwmd_pairwise.cu, fold their minima in its epilogue).
//   256 threads each keep an 8 x 8
//   accumulator (two float4 groups of rows and of columns), so every 64
//   FMAs read four float4s from shared memory; a warp covers 32 rows x 64
//   columns.  Rows come in stages of 16 features by 16-byte cp.async (4
//   lanes a row, so a warp reads 8 rows' 64-byte runs), three stages in
//   flight; once its chunks land, each thread transposes them into
//   double-buffered [feature][row] tiles, one barrier a stage.  Rows whose
//   index is -1 and features past m are zero-filled; when m is not a
//   multiple of 4 the chunks go as 4-byte words.  The squared norms of
//   both operands come from the staged chunks (no extra pass).  bf16: the
//   operands are rounded to bf16 as they are transposed, after their
//   squares enter the norms.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiles {

constexpr float BIG = 3.4e38f;  // finite sentinel of masked entries, as on the TPU
__device__ __forceinline__ unsigned big_bits() { return __float_as_uint(BIG); }

// One CTA of NT threads lists the indices i < n with x[i] > 0, in order
// (a warp ballot per 32 entries, NT entries a step), and returns their
// count to every thread.  Entry pos of the list goes to out[pos - first]
// when first <= pos < first + cap: by default the whole list.  Ends
// synchronised.
template <int NT>
__device__ int list_positive(const float* __restrict__ x, int n,
                             int* __restrict__ out, int first = 0,
                             int cap = 0x7fffffff) {
  __shared__ int warp_n[NT / 32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += NT) {
    const int i = i0 + tid;
    const bool f = i < n && x[i] > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int off = base;
    for (int w = 0; w < warp; ++w) off += warp_n[w];
    const int pos = off + __popc(bal & ((1u << lane) - 1u)) - first;
    if (f && pos >= 0 && pos < cap) out[pos] = i;
    __syncthreads();  // everyone read base and warp_n
    if (tid == 0)
      for (int w = 0; w < NT / 32; ++w) base += warp_n[w];
    __syncthreads();
  }
  return base;
}

namespace g128 {

constexpr int BM = 128;      // rows of A per tile
constexpr int BN = 128;      // rows of B (columns of the product) per tile
constexpr int BK = 16;       // features per stage
constexpr int STAGES = 3;    // stages of copies in flight
constexpr int THREADS = 256;
constexpr int LD = BM + 4;   // padded row of a transposed tile; float4-aligned
constexpr int LDP = BM + 8;  // padded row of the norm partials
constexpr int CHUNKS = BM * BK / 4 / THREADS;  // 16-byte chunks a thread copies per operand

static_assert(BM == BN, "one layout serves both operands");

// The copies in flight.  A caller may reuse these bytes between GEMMs.
struct Stages {
  float a[STAGES][BM][BK];  // A rows as copied: [row][feature]
  float b[STAGES][BN][BK];  // B rows as copied: [row][feature]
};

struct Tiles {
  float a[2][BK][LD];       // transposed: [feature][row]
  float b[2][BK][LD];
  float a2p[BK / 4][LDP];   // partial |a|^2: [feature quarter][row]
  float b2p[BK / 4][LDP];
  float a2[BM];             // |a|^2 of each row, after gemm()
  float b2[BN];
  int asrc[BM];             // row of A (of B) each tile row reads; -1: zeros
  int bsrc[BN];
};

// Copy n bytes (4 or 16) from global to shared memory; with pred false
// nothing is read and the bytes are zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The (row, feature quarter) of chunk i of this thread: 4 consecutive
// lanes cover one row's 16 features, 8 rows a warp.
__device__ __forceinline__ void chunk_slot(int i, int& r, int& kq) {
  const int c = threadIdx.x + THREADS * i;
  r = c / 4;
  kq = c % 4;
}

// Start the copies of one stage: 16-byte chunks when VEC (m % 4 == 0 and
// aligned rows), else four 4-byte words a chunk.
template <bool VEC>
__device__ __forceinline__ void load_stage(Stages& s, const Tiles& t, int buf,
                                           int k0, const float* __restrict__ a,
                                           const float* __restrict__ b, int m) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int r, kq;
    chunk_slot(i, r, kq);
    const int k = k0 + kq * 4;
    const int ra = t.asrc[r], rb = t.bsrc[r];
    const float* pa = a + (size_t)(ra >= 0 ? ra : 0) * m;
    const float* pb = b + (size_t)(rb >= 0 ? rb : 0) * m;
    if (VEC) {
      cp_async<16>(&s.a[buf][r][kq * 4], pa + (k < m ? k : 0), ra >= 0 && k < m);
      cp_async<16>(&s.b[buf][r][kq * 4], pb + (k < m ? k : 0), rb >= 0 && k < m);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = k + u < m;
        cp_async<4>(&s.a[buf][r][kq * 4 + u], pa + (in ? k + u : 0), ra >= 0 && in);
        cp_async<4>(&s.b[buf][r][kq * 4 + u], pb + (in ? k + u : 0), rb >= 0 && in);
      }
    }
  }
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// This thread's landed chunks of one stage: their squares into its norm
// slots, then the chunks transposed into the compute tiles (rounded to
// bf16 under BF16).  Zero-filled chunks add 0.
template <bool BF16>
__device__ __forceinline__ void absorb_stage(const Stages& s, Tiles& t,
                                             int buf, int x) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int r, kq;
    chunk_slot(i, r, kq);
    const float4 e = *reinterpret_cast<const float4*>(&s.a[buf][r][kq * 4]);
    const float4 q = *reinterpret_cast<const float4*>(&s.b[buf][r][kq * 4]);
    t.a2p[kq][r] = fmaf(e.w, e.w, fmaf(e.z, e.z, fmaf(e.y, e.y, fmaf(e.x, e.x, t.a2p[kq][r]))));
    t.b2p[kq][r] = fmaf(q.w, q.w, fmaf(q.z, q.z, fmaf(q.y, q.y, fmaf(q.x, q.x, t.b2p[kq][r]))));
    const float ev[4] = {e.x, e.y, e.z, e.w}, tv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      t.a[x][kq * 4 + u][r] = BF16 ? to_bf16(ev[u]) : ev[u];
      t.b[x][kq * 4 + u][r] = BF16 ? to_bf16(tv[u]) : tv[u];
    }
  }
}

// This thread's rows and columns of the tile: row(i) for i < 8, col(j) for
// j < 8 (rows wm*32 + lr*4 + {0..3, 16..19}, columns
// wn*64 + lc*4 + {0..3, 32..35}).
__device__ __forceinline__ int row_of(int i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 2) * 32 + (lane / 8) * 4 + (i & 3) + 16 * (i >> 2);
}
__device__ __forceinline__ int col_of(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 2) * 64 + (lane % 8) * 4 + (j & 3) + 32 * (j >> 2);
}

// acc = A[asrc] . B[bsrc]^T over m features for this thread's 8 x 8, and
// t.a2 / t.b2 the rows' squared norms.  t.asrc and t.bsrc are set and
// synchronised by the caller.  All THREADS threads; ends synchronised,
// with no copy in flight (s may be reused).
template <bool BF16, bool VEC>
__device__ void gemm(Stages& s, Tiles& t, const float* __restrict__ a,
                     const float* __restrict__ b, int m, float (&acc)[8][8]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < BK / 4 * LDP; e += THREADS) {
    (&t.a2p[0][0])[e] = 0.f;
    (&t.b2p[0][0])[e] = 0.f;
  }
  __syncthreads();
  const int nk = (m + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<VEC>(s, t, st, st * BK, a, b, m);
    cp_async_commit();
  }
  const int ar = (warp / 2) * 32 + (lane / 8) * 4;
  const int bc = (warp % 2) * 64 + (lane % 8) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt landed
    const int x = kt & 1;
    absorb_stage<BF16>(s, t, kt % STAGES, x);
    __syncthreads();  // tile x complete; stage kt-1 consumed by all
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage<VEC>(s, t, nxt % STAGES, nxt * BK, a, b, m);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&t.a[x][kk][ar]);
      const float4 a1 = *reinterpret_cast<const float4*>(&t.a[x][kk][ar + 16]);
      const float4 b0 = *reinterpret_cast<const float4*>(&t.b[x][kk][bc]);
      const float4 b1 = *reinterpret_cast<const float4*>(&t.b[x][kk][bc + 32]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage's norm partials are in
  {
    float* dst = tid < BM ? t.a2 : t.b2;
    const float* src = tid < BM ? &t.a2p[0][0] : &t.b2p[0][0];
    const int r = tid % BM;
    float x = 0.f;
#pragma unroll
    for (int p = 0; p < BK / 4; ++p) x += src[p * LDP + r];
    dst[r] = x;
  }
  __syncthreads();
}

// acc[i][j] = max(|a|^2 + |b|^2 - 2 acc, 0): this thread's squared
// distances (+0.0 for -0.0 and below).
__device__ __forceinline__ void to_sq(const Tiles& t, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a2 = t.a2[row_of(i)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = a2 + t.b2[col_of(j)] - 2.f * acc[i][j];
      acc[i][j] = x > 0.f ? x : 0.f;
    }
  }
}

// Whether 16-byte copies may read rows of m floats from a and b.
inline bool vec_ok(const void* a, const void* b, int m) {
  return m % 4 == 0 && (size_t)a % 16 == 0 && (size_t)b % 16 == 0;
}

}  // namespace g128

}  // namespace tiles
