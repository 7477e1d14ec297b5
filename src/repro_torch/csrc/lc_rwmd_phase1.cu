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
// - Tile.  One CTA computes 128 vocab rows x 128 columns; its 256 threads
//   each keep an 8 x 8 accumulator (two float4 groups of rows and of
//   columns), so every 64 FMAs read four float4s from shared memory.  A
//   warp covers 32 rows x 64 columns.
// - Stages.  E rows and T columns come in stages of 16 features by 16-byte
//   cp.async (4 lanes a row, so a warp reads 8 rows' 64-byte runs), three
//   stages in flight.  Once its chunks land, each thread transposes them
//   into double-buffered [feature][row] tiles, from which the FMA loop
//   reads its rows and columns as float4s; one barrier a stage.  Rows past
//   v, columns past the count and features past m (m = 300 is ragged at
//   the last stage) are zero-filled.  (4-byte copies straight into the
//   transposed tiles were slower: one copy instruction a word.)  When m is
//   not a multiple of 4 the chunks go as 4-byte words.
// - Epilogue.  sq = max(|e|^2 + |t|^2 - 2*acc, 0) (never -0.0).  Each
//   thread walks its 8 rows over its 8 columns, merging runs of one query,
//   and lowers Z^2 once per run by a global atomicMin on the float's bits
//   (all values are >= 0), into Z^2 filled with 3.4e38 beforehand.  A query
//   whose columns several threads or tiles hold is folded by each; a query
//   with no valid word is touched by none and keeps 3.4e38, as on the TPU.
// - Norms.  |e|^2 and |t|^2 from the staged chunks: each thread adds the
//   squares of the chunks it copied into its own slot of a (4 x 128) table
//   per operand; the epilogue sums the 4 slots of each row and column.  No
//   extra pass over E or T.
//
// The grid puts the column tile in x, so the CTAs that share an E tile run
// together and find it in L2.  The wrapper takes the sqrt.
//
// bf16: the GEMM operands are rounded to bf16 (round to nearest even) and
// back as they are transposed (after their squares enter the norms, which
// stay float32); a product of two bf16 values is exact in float32, which
// is what preferred_element_type=f32 gives on the TPU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 128;       // vocab rows per CTA
constexpr int BN = 128;       // valid columns per CTA
constexpr int BK = 16;        // features per stage
constexpr int STAGES = 3;     // stages of copies in flight
constexpr int THREADS = 256;
constexpr int LD = BM + 4;    // padded row of a transposed tile; float4-aligned
constexpr int LDP = BM + 8;   // padded row of the norm partials
constexpr int CHUNKS = BM * BK / 4 / THREADS;  // 16-byte chunks a thread copies per operand
constexpr float BIG = 3.4e38f;

static_assert(BM == BN, "one layout serves both operands");

struct Smem {
  float se[STAGES][BM][BK];  // E rows as copied: [row][feature]
  float st[STAGES][BN][BK];  // T columns as copied: [column][feature]
  float e[2][BK][LD];        // transposed: [feature][row]
  float t[2][BK][LD];        // transposed: [feature][column]
  float e2p[BK / 4][LDP];    // partial |e|^2: [feature quarter][row]
  float t2p[BK / 4][LDP];    // partial |t|^2: [feature quarter][column]
  float e2[BM];
  float t2[BN];
  int colq[BN];    // query of each column, -1 past the count
  int colsrc[BN];  // flat (query * h + word) row of t
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

// The (row or column, feature quarter) of chunk i of this thread: 4
// consecutive lanes cover one row's 16 features, 8 rows a warp.
__device__ __forceinline__ void chunk_slot(int i, int& r, int& kq) {
  const int c = threadIdx.x + THREADS * i;
  r = c / 4;
  kq = c % 4;
}

// Issue the copies of one stage: 16-byte chunks when VEC (m % 4 == 0 and
// aligned rows), else four 4-byte words a chunk.  Rows past v, columns past
// the count and features past m are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_stage(Smem& s, int buf, int k0,
                                           const float* __restrict__ emb,
                                           const float* __restrict__ t,
                                           int row0, int v, int m) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int r, kq;
    chunk_slot(i, r, kq);
    const int k = k0 + kq * 4;
    const bool re = row0 + r < v, rt = s.colq[r] >= 0;
    const float* pe = emb + (size_t)(re ? row0 + r : 0) * m;
    const float* pt = t + (size_t)(rt ? s.colsrc[r] : 0) * m;
    if (VEC) {
      cp_async<16>(&s.se[buf][r][kq * 4], pe + (k < m ? k : 0), re && k < m);
      cp_async<16>(&s.st[buf][r][kq * 4], pt + (k < m ? k : 0), rt && k < m);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = k + u < m;
        cp_async<4>(&s.se[buf][r][kq * 4 + u], pe + (in ? k + u : 0), re && in);
        cp_async<4>(&s.st[buf][r][kq * 4 + u], pt + (in ? k + u : 0), rt && in);
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
__device__ __forceinline__ void absorb_stage(Smem& s, int buf, int x) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int r, kq;
    chunk_slot(i, r, kq);
    const float4 e = *reinterpret_cast<const float4*>(&s.se[buf][r][kq * 4]);
    const float4 q = *reinterpret_cast<const float4*>(&s.st[buf][r][kq * 4]);
    s.e2p[kq][r] = fmaf(e.w, e.w, fmaf(e.z, e.z, fmaf(e.y, e.y, fmaf(e.x, e.x, s.e2p[kq][r]))));
    s.t2p[kq][r] = fmaf(q.w, q.w, fmaf(q.z, q.z, fmaf(q.y, q.y, fmaf(q.x, q.x, s.t2p[kq][r]))));
    const float ev[4] = {e.x, e.y, e.z, e.w}, tv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s.e[x][kq * 4 + u][r] = BF16 ? to_bf16(ev[u]) : ev[u];
      s.t[x][kq * 4 + u][r] = BF16 ? to_bf16(tv[u]) : tv[u];
    }
  }
}

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
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid < BN) {
    const int c = c0 + tid;
    const int src = c < n_cols ? cols[c] : 0;
    s.colq[tid] = c < n_cols ? src / h : -1;
    s.colsrc[tid] = src;
  }
  for (int e = tid; e < BK / 4 * LDP; e += THREADS) {
    (&s.e2p[0][0])[e] = 0.f;
    (&s.t2p[0][0])[e] = 0.f;
  }
  __syncthreads();

  const int nk = (m + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<VEC>(s, st, st * BK, emb, t, row0, v, m);
    cp_async_commit();
  }

  // Thread tile: rows wm*32 + lr*4 + {0..3, 16..19}, columns
  // wn*64 + lc*4 + {0..3, 32..35}.
  const int wm = warp / 2, wn = warp % 2;
  const int lr = lane / 8, lc = lane % 8;
  const int ar = wm * 32 + lr * 4;
  const int bc = wn * 64 + lc * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt landed
    const int x = kt & 1;
    absorb_stage<BF16>(s, kt % STAGES, x);
    __syncthreads();  // tile x complete; stage kt-1 consumed by all
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage<VEC>(s, nxt % STAGES, nxt * BK, emb, t, row0, v, m);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.e[x][kk][ar]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.e[x][kk][ar + 16]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.t[x][kk][bc]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.t[x][kk][bc + 32]);
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
    float* dst = tid < BM ? s.e2 : s.t2;
    const float* src = tid < BM ? &s.e2p[0][0] : &s.t2p[0][0];
    const int r = tid % BM;
    float x = 0.f;
#pragma unroll
    for (int p = 0; p < BK / 4; ++p) x += src[p * LDP + r];
    dst[r] = x;
  }
  __syncthreads();

  // Epilogue: squared distances, folded per (row, query) run.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float e2 = s.e2[ar + (i & 3) + 16 * (i >> 2)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = e2 + s.t2[bc + (j & 3) + 32 * (j >> 2)] - 2.f * acc[i][j];
      acc[i][j] = x > 0.f ? x : 0.f;  // +0.0 for -0.0 and below
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ar + (i & 3) + 16 * (i >> 2);
    unsigned* orow = out + (size_t)row * b;
    int cur_q = -1;
    float cur = BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = s.colq[bc + (j & 3) + 32 * (j >> 2)];
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
// lists the valid columns (valid[i] > 0), in order, with their count: a
// block-wide running count over valid, 256 entries at a time.
constexpr int PREP_THREADS = 256;

__global__ void __launch_bounds__(PREP_THREADS)
phase1_prep_kernel(const float* __restrict__ valid, int n,
                   int* __restrict__ cols, int* __restrict__ count,
                   unsigned* __restrict__ out, size_t n_out) {
  for (size_t i = (size_t)blockIdx.x * PREP_THREADS + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * PREP_THREADS)
    out[i] = __float_as_uint(BIG);
  if (blockIdx.x != 0) return;
  __shared__ int warp_n[PREP_THREADS / 32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += PREP_THREADS) {
    const int i = i0 + tid;
    const bool f = i < n && valid[i] > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int off = base;
    for (int w = 0; w < warp; ++w) off += warp_n[w];
    if (f) cols[off + __popc(bal & ((1u << lane) - 1u))] = i;
    __syncthreads();  // everyone read base and warp_n
    if (tid == 0)
      for (int w = 0; w < PREP_THREADS / 32; ++w) base += warp_n[w];
    __syncthreads();
  }
  if (tid == 0) *count = base;
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
  // 16-byte copies need 16-byte aligned rows.
  const bool vec = m % 4 == 0 && (size_t)emb % 16 == 0 && (size_t)t % 16 == 0;
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
