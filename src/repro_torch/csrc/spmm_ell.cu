// LC-RWMD phase 2 on Hopper: the ELL SpMM D[i, j] = sum_p w[i, p] * Z[ids[i, p], j],
// in the three formulations of the TPU kernels.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py, spmm_ell_pallas
// (_spmm_blocked_kernel), with spmm_ell_kernel (blocked, the default).  There
// scalar prefetch steered one Z-row DMA per doc and slot.
//
// What bounds it: each doc row reads h weights, the ids of its nonzero
// slots and writes B outputs from HBM (~134 MB + ~77 MB + ~179 MB at
// n=700,000, h=48, B=64: 0.12 ms at 3.35 TB/s); the Z rows it gathers,
// nnz*B*4 bytes (~4.9 GB there), come from a Z of v_e*B*4 bytes (18.7 MB)
// that stays in the 50 MB L2, the frequent words' rows also in L1.  The
// first design (a warp per row, one slot a step, a shuffle, test and
// branch for every slot, zero-weight or not) spent its time issuing
// instructions.  More Z rows in flight alone did not help: a warp that took
// the next 8 or 16 nonzero slots out of a ballot mask bit by bit (a serial
// chain of find-first-set and clear) ran slower than the first design, and
// slower the more it took at once.
//
// Design: one warp per doc row, 8 rows per CTA.  The warp loads 64 of the
// row's weights at a time, two a lane, lists the nonzero ones by
// __ballot_sync, and each lane writes its nonzero slots' (id, weight) at
// their rank into the warp's 512 bytes of shared memory: one pass, no
// serial chain, and ids are read only for nonzero slots (the vocabulary
// chunk calls, where most slots are zero-weight, read few ids).  Then it
// takes the list U = 4 at a time, each entry a broadcast shared-memory
// read: the U Z rows are gathered, each lane loading its CW adjacent
// columns as one 8- or 16-byte load where B allows (a Z row of B = 64 is
// one 256-byte load of the warp), and added to the columns' fmaf chains in
// slot order.  Zero-weight slots cost no step, which is exact because Z is
// finite.  Wider batches loop over column chunks of 128, wider rows over
// pieces of 64 slots; a row of at most 64 slots and 32 * CW columns (the
// main path's h = 48, B = 64) takes an instance without those loops, which
// the card ran faster.
//
// spmm_ell_dense_kernel also replaces the TPU kernel
// src/repro/kernels/spmm_ell.py, spmm_ell_dense_pallas (_spmm_dense_kernel),
// which expanded each doc tile's ids into a one-hot A(bn, bv) per vocab
// subtile and ran A @ Z_tile on the matrix unit, summing subtile by
// subtile.  What bounds it here: the same bytes as the blocked kernel (the
// ids and weights read once, D written once), and before them the gathers
// of the Z rows the slots name from L2.  Streaming all of Z through every
// doc tile, as the one-hot product does, costs v*B*4 bytes per tile and a
// test of every slot per subtile: matrix-unit work on the TPU, pure
// overhead on Hopper in IEEE float32.  So the kernel keeps the one-hot
// product's order and drops its zeros: one warp per doc row buckets the
// row's slots by (vocab subtile of 512 ids, the plain version's DENSE_BV;
// slot), by a bitonic sort of the keys subtile << 6 | slot across the
// warp's registers (rows wider than 64 slots rank theirs by counting in
// shared memory), so it visits only the row's non-empty subtiles, in
// ascending order.  A slot of weight 0, or whose id lies outside [0, v),
// gets no key: the one-hot product adds nothing for it either.  The lanes
// run over the B columns; each subtile's slots add into a partial sum in
// registers, in slot order, which is added to the row's sum when the
// subtile ends: the reference's out += A @ Z_tile, with no float atomics
// and an order fixed by the data.  Two slots a step keep two Z loads in
// flight per lane.  The Z traffic is the blocked kernel's nnz*B*4 and no
// longer grows with v.  (A variant that staged each doc tile's distinct Z
// rows once in shared memory, by cp.async in double-buffered batches, was
// slower than this: the synthetic corpus's 64-row tiles name mostly
// distinct ids, so staging saved little L2 traffic and its set-up and
// barriers cost more.)
//
// spmm_ell_naive_kernel also replaces the TPU kernel
// src/repro/kernels/spmm_ell.py, spmm_ell_naive_pallas (_spmm_naive_kernel),
// the seed kernel with one doc x one slot per grid step.  It stays naive on
// purpose, as the recorded baseline: one CTA per doc, the slots in sequence,
// the threads over the B columns, every slot (weight 0 or not) one fmaf.
// The result equals the blocked kernel's bit for bit: both take the fmaf
// chain in slot order from 0, and a zero-weight slot leaves it unchanged.

#include <cuda_runtime.h>
#include <limits.h>

constexpr unsigned FULL = 0xffffffffu;

namespace {

constexpr int WARPS = 8;   // warps (doc rows) per CTA of the blocked kernel
constexpr int SLOTS = 64;  // ELL slots a warp lists at once, two a lane
constexpr int U = 4;       // Z rows in flight per warp

// A lane's CW adjacent columns [col, col + CW) of a row: one CW-float load
// or store when VEC (B % CW == 0, aligned), else CW 4-byte ones.
template <int CW, bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int col,
                                          int b, float (&x)[CW]) {
  if constexpr (VEC && CW == 4) {
    const float4 t = col < b ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (VEC && CW == 2) {
    const float2 t = col < b ? __ldg(reinterpret_cast<const float2*>(p))
                             : make_float2(0.f, 0.f);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) x[j] = col + j < b ? __ldg(p + j) : 0.f;
  }
}

template <int CW, bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ p, int col,
                                           int b, const float (&x)[CW]) {
  if constexpr (VEC && CW == 4) {
    if (col < b) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC && CW == 2) {
    if (col < b) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (col + j < b) p[j] = x[j];
  }
}

// One warp per doc row; the row in pieces of SLOTS slots, two a lane, and
// in column chunks of 32 * CW.  ONE: a single piece and chunk (h <= SLOTS,
// B <= 32 * CW), the loops gone at compile time.
template <int CW, bool VEC, bool ONE>
__global__ void __launch_bounds__(WARPS * 32)
spmm_ell_kernel(const int* __restrict__ ids,   // (n, h)
                const float* __restrict__ w,   // (n, h)
                const float* __restrict__ z,   // (v, B)
                float* __restrict__ out,       // (n, B)
                int n, int h, int b) {
  __shared__ int2 listed[WARPS][SLOTS];  // (id, weight bits) by rank
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n) return;  // no CTA-wide barrier below
  const int* ir = ids + (size_t)row * h;
  const float* wr = w + (size_t)row * h;
  int2* buf = listed[warp];
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; ONE ? c0 == 0 : c0 < b; c0 += 32 * CW) {
    const int col = c0 + lane * CW;
    float acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = 0.f;
    for (int p0 = 0; ONE ? p0 == 0 : p0 < h; p0 += SLOTS) {
      const int pa = p0 + lane, pb = pa + 32;
      const float wa = pa < h ? __ldg(wr + pa) : 0.f;
      const float wb = pb < h ? __ldg(wr + pb) : 0.f;
      // both ids in flight before either is stored
      const int ia = wa != 0.f ? __ldg(ir + pa) : 0;
      const int ib = wb != 0.f ? __ldg(ir + pb) : 0;
      const unsigned ma = __ballot_sync(FULL, wa != 0.f);
      const unsigned mb = __ballot_sync(FULL, wb != 0.f);
      const int nz = __popc(ma) + __popc(mb);
      if (nz == 0) continue;  // warp-uniform
      // the nonzero slots, listed in slot order: rank = nonzero slots before
      if (wa != 0.f) buf[__popc(ma & below)] = make_int2(ia, __float_as_int(wa));
      if (wb != 0.f) buf[__popc(ma) + __popc(mb & below)] = make_int2(ib, __float_as_int(wb));
      __syncwarp();
      for (int g = 0; g < nz; g += U) {
        float wv[U], zv[U][CW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (g + u < nz) {  // warp-uniform
            const int2 e = buf[g + u];
            wv[u] = __int_as_float(e.y);
            load_cols<CW, VEC>(z + (size_t)e.x * b + col, col, b, zv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (g + u < nz)
#pragma unroll
            for (int j = 0; j < CW; ++j) acc[j] = fmaf(wv[u], zv[u][j], acc[j]);
      }
      __syncwarp();  // the list is read before the next piece writes it
    }
    store_cols<CW, VEC>(out + (size_t)row * b + col, col, b, acc);
  }
}

template <int CW, bool VEC>
cudaError_t launch_blocked(const void* ids, const void* w, const void* z,
                           void* out, int n, int h, int b,
                           cudaStream_t stream) {
  const int grid = (n + WARPS - 1) / WARPS;
  if (h <= SLOTS && b <= 32 * CW)
    spmm_ell_kernel<CW, VEC, true><<<grid, WARPS * 32, 0, stream>>>(
        (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, b);
  else
    spmm_ell_kernel<CW, VEC, false><<<grid, WARPS * 32, 0, stream>>>(
        (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, b);
  return cudaGetLastError();
}

constexpr int DENSE_WARPS = 8;        // doc rows per CTA, one warp each
constexpr int DENSE_BV_SHIFT = 9;     // vocab rows per subtile: 512
constexpr int DENSE_COLS = 4;         // columns per lane per chunk of 128
constexpr int DENSE_REG_H = 64;       // rows this wide sort in registers
constexpr int DENSE_MAX_H = 2048;

// Shared memory of one CTA for rows wider than DENSE_REG_H: per warp, its
// row's sort keys, then its nonzero slots' ids and weights, sorted.
int dense_smem(int h) { return h > DENSE_REG_H ? DENSE_WARPS * 3 * h * 4 : 0; }

// Whether a slot enters the sum: a nonzero weight and an id in [0, v).
__device__ __forceinline__ bool adds(int id, float wv, int v) {
  return wv != 0.f && (unsigned)id < (unsigned)v;
}

// out_row = sum over the row's nonzero slots in (subtile, slot) order, each
// subtile's partial sum added to the row's when the subtile ends (the
// reference's out += A @ Z_tile).  fetch(r, id, w) gives the r-th slot.
// Two slots a step, so each lane has two Z loads in flight; a missing
// second slot repeats the first with weight 0 (fma(0, z, x) is x).
template <int CW, class Fetch>
__device__ __forceinline__ void dense_row_cols(Fetch fetch, int nz,
                                          const float* __restrict__ z,
                                          float* __restrict__ orow, int b,
                                          int lane) {
  for (int c0 = 0; c0 < b; c0 += 32 * CW) {
    float acc[CW], part[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = part[j] = 0.f;
    int cur_s = -1;
    for (int r = 0; r < nz; r += 2) {
      int id[2];
      float wv[2], zv[2][CW];
      fetch(r, id[0], wv[0]);
      fetch(min(r + 1, nz - 1), id[1], wv[1]);
      if (r + 1 >= nz) wv[1] = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* zr = z + (size_t)id[u] * b + c0 + lane;
#pragma unroll
        for (int j = 0; j < CW; ++j)
          zv[u][j] = c0 + lane + 32 * j < b ? __ldg(zr + 32 * j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = id[u] >> DENSE_BV_SHIFT;
        if (s != cur_s) {  // warp-uniform: a subtile ends
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            acc[j] += part[j];
            part[j] = 0.f;
          }
          cur_s = s;
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) part[j] = fmaf(wv[u], zv[u][j], part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < b) orow[c] = acc[j] + part[j];
    }
  }
}

template <class Fetch>
__device__ __forceinline__ void dense_row(Fetch fetch, int nz,
                                          const float* __restrict__ z,
                                          float* __restrict__ orow, int b,
                                          int lane) {
  if (b <= 64) dense_row_cols<2>(fetch, nz, z, orow, b, lane);
  else dense_row_cols<DENSE_COLS>(fetch, nz, z, orow, b, lane);
}

__global__ void __launch_bounds__(DENSE_WARPS * 32)
spmm_ell_dense_kernel(const int* __restrict__ ids,   // (n, h)
                      const float* __restrict__ w,   // (n, h)
                      const float* __restrict__ z,   // (v, B)
                      float* __restrict__ out,       // (n, B)
                      int n, int h, int v, int b) {
  extern __shared__ __align__(16) int sm[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * DENSE_WARPS + warp;
  if (row >= n) return;  // no CTA-wide barrier below
  const int* ir = ids + (size_t)row * h;
  const float* wr = w + (size_t)row * h;
  float* orow = out + (size_t)row * b;

  if (h <= DENSE_REG_H) {
    // Slot p = lane + 32 i sits in this lane's register i.  A bitonic sort
    // of the keys (subtile << 6 | slot; INT_MAX for a slot that adds
    // nothing) across the warp puts the r-th smallest in lane r % 32,
    // register r / 32.
    int id[2], key[2];
    float wt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      id[i] = p < h ? ir[p] : 0;
      wt[i] = p < h ? wr[p] : 0.f;
      key[i] = adds(id[i], wt[i], v) ? (id[i] >> DENSE_BV_SHIFT) << 6 | p
                                     : INT_MAX;
    }
#pragma unroll
    for (int k = 2; k <= 64; k *= 2) {
#pragma unroll
      for (int j = k / 2; j > 0; j /= 2) {
        if (j == 32) {  // the pair is this lane's two registers (k = 64)
          const int lo = min(key[0], key[1]);
          key[1] = max(key[0], key[1]);
          key[0] = lo;
          continue;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * i;
          const int other = __shfl_xor_sync(FULL, key[i], j);
          const bool up = (e & k) == 0;
          const bool lower = (lane & j) == 0;
          key[i] = lower == up ? min(key[i], other) : max(key[i], other);
        }
      }
    }
    const int nz = __popc(__ballot_sync(FULL, key[0] != INT_MAX)) +
                   __popc(__ballot_sync(FULL, key[1] != INT_MAX));
    // lane r % 32, register r / 32 takes the id and weight of rank r
    int sid[2];
    float sw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = key[i] & 63;  // empty ranks fetch junk, never read
      const int a = __shfl_sync(FULL, id[0], p & 31);
      const int c = __shfl_sync(FULL, id[1], p & 31);
      const float x = __shfl_sync(FULL, wt[0], p & 31);
      const float y = __shfl_sync(FULL, wt[1], p & 31);
      sid[i] = p < 32 ? a : c;
      sw[i] = p < 32 ? x : y;
    }
    auto fetch = [&](int r, int& iv, float& wv) {
      iv = __shfl_sync(FULL, r < 32 ? sid[0] : sid[1], r & 31);
      wv = __shfl_sync(FULL, r < 32 ? sw[0] : sw[1], r & 31);
    };
    dense_row(fetch, nz, z, orow, b, lane);
    return;
  }

  // Wider rows: rank each slot by counting in shared memory.
  int* tk = sm + warp * 3 * h;   // sort key of each slot
  int* sid = tk + h;             // the row's nonzero slots, sorted
  float* sw = (float*)(sid + h);
  for (int p = lane; p < h; p += 32)
    tk[p] = adds(ir[p], wr[p], v) ? ir[p] >> DENSE_BV_SHIFT : INT_MAX;
  __syncwarp();
  int nz = 0;
  for (int p = lane; p < h; p += 32) {
    const int kp = tk[p];
    if (kp == INT_MAX) continue;
    int rank = 0;
    for (int q = 0; q < h; ++q) {
      const int kq = tk[q];
      rank += kq < kp || (kq == kp && q < p);
    }
    sid[rank] = ir[p];
    sw[rank] = wr[p];
    ++nz;
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) nz += __shfl_xor_sync(FULL, nz, d);
  __syncwarp();
  auto fetch = [&](int r, int& iv, float& wv) {
    iv = sid[r];
    wv = sw[r];
  };
  dense_row(fetch, nz, z, orow, b, lane);
}

__global__ void spmm_ell_naive_kernel(const int* __restrict__ ids,   // (n, h)
                                      const float* __restrict__ w,   // (n, h)
                                      const float* __restrict__ z,   // (v, B)
                                      float* __restrict__ out,       // (n, B)
                                      int h, int b) {
  const int row = blockIdx.x;
  for (int c = threadIdx.x; c < b; c += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < h; ++p) {
      const float wv = w[(size_t)row * h + p];
      const int id = ids[(size_t)row * h + p];
      acc = fmaf(wv, z[(size_t)id * b + c], acc);
    }
    out[(size_t)row * b + c] = acc;
  }
}

}  // namespace

// cw: adjacent columns a lane owns (1, 2 or 4; chunks of 32 * cw columns);
// vec: load and store them as one vector (B % cw == 0, z and out aligned).
extern "C" int launch_spmm_ell(const void* ids, const void* w, const void* z,
                               void* out, int n, int h, int b, int cw, int vec,
                               void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec && b % cw != 0) return (int)cudaErrorInvalidValue;
  if (cw == 1) return (int)launch_blocked<1, false>(ids, w, z, out, n, h, b, s);
  if (cw == 2)
    return (int)(vec ? launch_blocked<2, true>(ids, w, z, out, n, h, b, s)
                     : launch_blocked<2, false>(ids, w, z, out, n, h, b, s));
  if (cw == 4)
    return (int)(vec ? launch_blocked<4, true>(ids, w, z, out, n, h, b, s)
                     : launch_blocked<4, false>(ids, w, z, out, n, h, b, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" int launch_spmm_ell_dense(const void* ids, const void* w,
                                     const void* z, void* out, int n, int h,
                                     int v, int b, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  if (h < 1 || h > DENSE_MAX_H) return (int)cudaErrorInvalidValue;
  const int smem = dense_smem(h);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_ell_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  spmm_ell_dense_kernel<<<(n + DENSE_WARPS - 1) / DENSE_WARPS,
                          DENSE_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, v,
      b);
  return (int)cudaGetLastError();
}

extern "C" int launch_spmm_ell_naive(const void* ids, const void* w,
                                     const void* z, void* out, int n, int h,
                                     int b, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  spmm_ell_naive_kernel<<<n, min(b, 128), 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, h, b);
  return (int)cudaGetLastError();
}
