// Fused LC-RWMD vocab chunk on Hopper: one chunk of the vocabulary's Z is
// made on chip and consumed at once into the running distances,
//   Z[w, j] = sqrt(min over the valid words q of query j of
//                  max(|E[w]|^2 + |T[j,q]|^2 - 2 E[w].T[j,q], 0))   (w in the chunk)
//   D[i, j] += sum over the slots p with lo <= ids[i, p] < lo + cv and
//              w[i, p] != 0 of w[i, p] * Z[ids[i, p] - lo, j]
// (lo: the chunk's first id), reading the resident ids and weights as they
// are.  That is the sum of the reference's chunk-relative, clipped ids and
// out-of-chunk zeroed weights, less the (n, h1) passes that make them and
// the products by zero.  A query with no valid word has Z = sqrt(3.4e38),
// as on the TPU.
//
// Replaces the TPU kernel src/repro/kernels/fused_stream.py,
// fused_lc_rwmd_chunk_pallas (_fused_kernel).  That kernel made the chunk's
// Z in VMEM during its first doc tile and let every later doc tile re-read
// it, which relies on the TPU's sequential grid.  Here Z is made once per
// chunk by one launch and read from on-chip memory by the next.
//
// What bounds it: bytes.  Every chunk must read the resident ids to find
// its slots (n * h1 * 4 bytes: 134 MB at the slice's n = 700,000 and h1 =
// 48), then the weights of the slots it finds and D of the rows they sit
// in.  Z itself is small: 0.54 GFLOP over the ~1,760 valid query words of
// a 64-query batch at cv = 512, m = 300.
//
// Design: a cudaMemsetAsync and two launches on the stream, per slab of up
// to 128 queries (one slab at the slice's B = 64).
//
// 1. Z (chunk_z_kernel): B1's GEMM (tiles::g128) of the chunk's rows
//    against the valid query columns only.  Each CTA of the grid (column
//    tiles x row tiles) lists its own window of 128 valid (query, word)
//    columns (tiles::list_positive) and exits when the window starts past
//    their count, so padded words cost nothing.  Its epilogue folds each
//    row's runs of one query into a (cv, nq) scratch of squared Z by
//    atomicMax on the complemented float bits: the scratch is zeroed by
//    the memset, and 0 decodes as 3.4e38 (no valid column yet).  56 CTAs
//    at the slice's shapes.
// 2. Consume (chunk_consume_kernel): one CTA of 1,024 threads per SM.  Each
//    CTA stages the chunk's Z into shared memory once (sqrt taken there)
//    when cv * nq floats fit (128 KB at cv = 512, B = 64); otherwise every
//    read goes to the scratch, which stays in the 50 MB L2.  Each warp owns
//    a contiguous range of doc rows and walks their ids 256 at a time as
//    16-byte vectors (the next step's loads in flight while it works on
//    this one's slots), loads the weights only of the vectors that hold an
//    in-chunk id, and adds the hits in slot order: per row a fmaf chain
//    from 0 over its slots, then one atomicAdd of the sum into each of
//    its D entries.  Only the warp that owns a row adds into it, so the
//    result is deterministic (D + the row's sum, as the plain version).
//
// Why two launches and not one cooperative launch: the GEMM wants 256
// threads a CTA with its 90 KB of stages, the consume wants 32 warps on
// every SM with Z beside them in shared memory; a grid barrier would tie
// both to one shape.  Z passes from the first to the second through the
// scratch, which the wrapper allocates and never returns.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

namespace g = tiles::g128;
constexpr int BM = g::BM;     // chunk rows per Z CTA
constexpr int BN = g::BN;     // valid columns per Z CTA
constexpr int Z_THREADS = g::THREADS;
constexpr int CONSUME_THREADS = 1024;
constexpr int CONSUME_WARPS = CONSUME_THREADS / 32;
constexpr int U = 2;          // 16-byte id vectors a lane loads per step
constexpr int STEP = 128 * U; // ids a warp walks per step
constexpr unsigned FULL = 0xffffffffu;

// Squared Z as complemented float bits: for x >= 0 they fall as x grows,
// so atomicMax keeps the minimum, and the memset's 0 means "none yet".
__device__ __forceinline__ unsigned enc(float x) { return ~__float_as_uint(x); }
__device__ __forceinline__ float z_of(unsigned s) {
  return sqrtf(s ? __uint_as_float(~s) : tiles::BIG);
}

struct ZSmem {
  g::Stages st;
  g::Tiles t;      // t.asrc: chunk rows; t.bsrc: flat (query * h + word) rows of T
  int colq[BN];    // query of each column, -1 past the count
};

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(Z_THREADS, 2)
chunk_z_kernel(const float* __restrict__ emb,     // (cv, m) the chunk's rows
               const float* __restrict__ t,       // (nq * h, m)
               const float* __restrict__ valid,   // (nq * h,) 0/1
               unsigned* __restrict__ zsq,        // (cv, nq) squared Z, encoded
               int cv, int nq, int h, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ZSmem& s = *reinterpret_cast<ZSmem*>(smem_raw);
  const int c0 = blockIdx.x * BN, row0 = blockIdx.y * BM, tid = threadIdx.x;

  if (tid < BN) s.t.bsrc[tid] = -1;  // ordered by list_positive's first barrier
  const int n_cols = tiles::list_positive<Z_THREADS>(valid, nq * h, s.t.bsrc, c0, BN);
  if (c0 >= n_cols) return;  // CTA-uniform
  if (tid < BN) {
    const int src = s.t.bsrc[tid];
    s.colq[tid] = src >= 0 ? src / h : -1;
  } else {
    const int r = tid - BN;
    s.t.asrc[r] = row0 + r < cv ? row0 + r : -1;
  }
  __syncthreads();

  float acc[8][8];
  g::gemm<BF16, VEC>(s.st, s.t, emb, t, m, acc);
  g::to_sq(s.t, acc);

  // Each thread walks its 8 rows over its 8 columns, merging runs of one
  // query, and lowers the scratch once per run.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + g::row_of(i);
    if (row >= cv) continue;
    unsigned* zrow = zsq + (size_t)row * nq;
    int cur_q = -1;
    float cur = tiles::BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = s.colq[g::col_of(j)];
      if (q < 0) continue;
      if (q != cur_q) {
        if (cur_q >= 0) atomicMax(&zrow[cur_q], enc(cur));
        cur_q = q;
        cur = acc[i][j];
      } else {
        cur = fminf(cur, acc[i][j]);
      }
    }
    if (cur_q >= 0) atomicMax(&zrow[cur_q], enc(cur));
  }
}

// One step of a warp: the ids [f0, f0 + STEP) of its flat range [fa, fb),
// lane L holding f0 + 128 u + 4 L + k (k < 4) in ids[u][k].
template <bool VEC>
__device__ __forceinline__ void load_ids(const int* __restrict__ ids, int f0,
                                         int fa, int fb, int lane,
                                         int (&v)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int base = f0 + 128 * u + 4 * lane;
    if (VEC) {
      // fa, fb and base are multiples of 4: a vector lies wholly inside or out
      int4 x = make_int4(0, 0, 0, 0);
      if (base < fb) x = __ldcs(reinterpret_cast<const int4*>(ids + base));
      v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = base + k;
        v[u][k] = f >= fa && f < fb ? __ldcs(ids + f) : 0;
      }
    }
  }
}

template <int CW, bool VEC, bool SMEM_Z>
__global__ void __launch_bounds__(CONSUME_THREADS, 1)
chunk_consume_kernel(const unsigned* __restrict__ zsq,  // (cv, nq) squared Z, encoded
                     const int* __restrict__ ids,       // (n, h1) vocab ids
                     const float* __restrict__ w,       // (n, h1)
                     float* __restrict__ d,             // row i at d + i * ldd, nq columns
                     int cv, int lo, int nq, int n, int h1, int ldd,
                     int rows_per_warp) {
  extern __shared__ __align__(16) float zs[];  // [cv][nq] when SMEM_Z
  if (SMEM_Z) {
    for (int e = threadIdx.x; e < cv * nq; e += CONSUME_THREADS) zs[e] = z_of(zsq[e]);
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * CONSUME_WARPS + threadIdx.x / 32;
  const long long r_a = (long long)warp * rows_per_warp;
  if (r_a >= n) return;
  const int r_b = (int)min((long long)n, r_a + rows_per_warp);
  const int fa = (int)r_a * h1, fb = r_b * h1;

  int cur_row = -1;
  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
  auto flush = [&]() {
    if (cur_row < 0) return;
    float* drow = d + (size_t)cur_row * ldd;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = lane + 32 * c;
      if (col < nq) atomicAdd(drow + col, acc[c]);
    }
  };

  int cur[U][4], nxt[U][4];
  const int f_first = fa & ~3;
  load_ids<VEC>(ids, f_first, fa, fb, lane, cur);
  for (int f0 = f_first; f0 < fb; f0 += STEP) {
    if (f0 + STEP < fb) load_ids<VEC>(ids, f0 + STEP, fa, fb, lane, nxt);
    // this lane's in-chunk slots, then their weights (only where one hit)
    unsigned hits[U];
    float wv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int base = f0 + 128 * u + 4 * lane;
      hits[u] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = base + k;
        const bool in = f >= fa && f < fb && (unsigned)cur[u][k] - (unsigned)lo < (unsigned)cv;
        hits[u] |= (unsigned)in << k;
        wv[u][k] = 0.f;
      }
      if (hits[u]) {
        if (VEC) {
          const float4 x = __ldcs(reinterpret_cast<const float4*>(w + base));
          wv[u][0] = x.x; wv[u][1] = x.y; wv[u][2] = x.z; wv[u][3] = x.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if ((hits[u] >> k) & 1u) wv[u][k] = w[base + k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wv[u][k] == 0.f) hits[u] &= ~(1u << k);
      }
    }
    // the hits in flat (row, slot) order: lanes in order, then k
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unsigned lanes = __ballot_sync(FULL, hits[u] != 0u);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const unsigned nib = __shfl_sync(FULL, hits[u], src);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!((nib >> k) & 1u)) continue;  // warp-uniform
          const float wk = __shfl_sync(FULL, wv[u][k], src);
          const int zr = (int)((unsigned)__shfl_sync(FULL, cur[u][k], src) - (unsigned)lo);
          const int row = (f0 + 128 * u + 4 * src + k) / h1;
          if (row != cur_row) {
            flush();
            cur_row = row;
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[c] = 0.f;
          }
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const int col = lane + 32 * c;
            if (col < nq) {
              const float z = SMEM_Z ? zs[zr * nq + col] : z_of(zsq[(size_t)zr * nq + col]);
              acc[c] = fmaf(wk, z, acc[c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) cur[u][k] = nxt[u][k];
  }
  flush();
}

template <int CW, bool VEC, bool SMEM_Z>
int launch_consume(const unsigned* zsq, const int* ids, const float* w,
                   float* d, int cv, int lo, int nq, int n, int h1, int ldd,
                   int n_sm, cudaStream_t stream) {
  auto kern = chunk_consume_kernel<CW, VEC, SMEM_Z>;
  const int smem = SMEM_Z ? (int)(sizeof(float) * (size_t)cv * nq) : 0;
  if (SMEM_Z) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps = (long long)n_sm * CONSUME_WARPS;
  const int rows_per_warp = (int)((n + warps - 1) / warps);
  kern<<<n_sm, CONSUME_THREADS, smem, stream>>>(zsq, ids, w, d, cv, lo, nq, n,
                                                 h1, ldd, rows_per_warp);
  return (int)cudaGetLastError();
}

template <bool VEC, bool SMEM_Z>
int consume_cw(const unsigned* zsq, const int* ids, const float* w, float* d,
               int cv, int lo, int nq, int n, int h1, int ldd, int n_sm,
               cudaStream_t s) {
  if (nq <= 32) return launch_consume<1, VEC, SMEM_Z>(zsq, ids, w, d, cv, lo, nq, n, h1, ldd, n_sm, s);
  if (nq <= 64) return launch_consume<2, VEC, SMEM_Z>(zsq, ids, w, d, cv, lo, nq, n, h1, ldd, n_sm, s);
  return launch_consume<4, VEC, SMEM_Z>(zsq, ids, w, d, cv, lo, nq, n, h1, ldd, n_sm, s);
}

}  // namespace

// One slab of nq <= 128 queries: the memset of the scratch, Z, the consume.
extern "C" int launch_fused_chunk(const void* emb, const void* t,
                                  const void* valid, const void* ids,
                                  const void* w, void* d, void* zsq, int cv,
                                  int lo, int m, int nq, int h, int n, int h1,
                                  int ldd, int bf16, void* stream) {
  if (cv <= 0 || nq <= 0 || n <= 0) return (int)cudaGetLastError();
  if (nq > 128 || h <= 0 || (long long)nq * h > 0x7fffffffLL ||
      (long long)n * h1 > 0x7fffffffLL || (long long)cv * nq > 0x7fffffffLL ||
      (cv + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(zsq, 0, sizeof(unsigned) * (size_t)cv * nq, s);
  if (err != cudaSuccess) return (int)err;

  const int n_cols = nq * h;
  dim3 grid((unsigned)((n_cols + BN - 1) / BN), (unsigned)((cv + BM - 1) / BM));
  const int zsmem = (int)sizeof(ZSmem);
  const bool zvec = g::vec_ok(emb, t, m);  // 16-byte copies: aligned rows
  auto zk = bf16 ? (zvec ? chunk_z_kernel<true, true> : chunk_z_kernel<true, false>)
                 : (zvec ? chunk_z_kernel<false, true> : chunk_z_kernel<false, false>);
  err = cudaFuncSetAttribute(zk, cudaFuncAttributeMaxDynamicSharedMemorySize, zsmem);
  if (err != cudaSuccess) return (int)err;
  zk<<<grid, Z_THREADS, zsmem, s>>>((const float*)emb, (const float*)t,
                                    (const float*)valid, (unsigned*)zsq, cv,
                                    nq, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const bool vec = h1 % 4 == 0 && (size_t)ids % 16 == 0 && (size_t)w % 16 == 0;
  const bool smem_z = sizeof(float) * (size_t)cv * nq <= 232448;  // 227 KB a CTA
  const unsigned* z = (const unsigned*)zsq;
  const int* ip = (const int*)ids;
  const float* wp = (const float*)w;
  float* dp = (float*)d;
  if (vec)
    return smem_z ? consume_cw<true, true>(z, ip, wp, dp, cv, lo, nq, n, h1, ldd, n_sm, s)
                  : consume_cw<true, false>(z, ip, wp, dp, cv, lo, nq, n, h1, ldd, n_sm, s);
  return smem_z ? consume_cw<false, true>(z, ip, wp, dp, cv, lo, nq, n, h1, ldd, n_sm, s)
                : consume_cw<false, false>(z, ip, wp, dp, cv, lo, nq, n, h1, ldd, n_sm, s);
}
