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
// the seed kernel with one doc x one slot per grid step, where scalar
// prefetch brought each slot's id ahead of its Z-row DMA.  What bounds it
// here: the blocked kernel's bytes (every weight, the ids of nonzero slots,
// Z and D once); the seed formulation's first port (a CTA per doc, every
// slot's weight and id loaded by all threads before its Z row, one fmaf
// chain) waited on HBM for each id and gathered a Z row for every
// zero-weight slot too.
//
// Design: persistent CTAs of NAIVE_WARPS consumer warps and one producer
// warp walk tiles of `rows` doc rows (a multiple of NAIVE_WARPS, so of 4;
// the wrapper's naive_tile_rows) in a static stride.  A tile's ids and
// weights are each one contiguous block of rows * h slots, which streams
// through a ring of NAIVE_STAGES stages of NAIVE_CAP slots.  The producer
// copies a stage's two blocks into shared memory by cp.async.bulk,
// completing on the stage's "full" mbarrier (lane 0 arrives with the byte
// count); the up to 3 slots before a block's first 16-byte boundary and
// after its last come by ordinary loads of other lanes, which arrive too.
// The consumers release a stage on its "empty" mbarrier (one arrival a
// warp), and the producer waits on it before refilling: the next stage's
// ids and weights land while this one's Z rows are gathered.  A consumer
// warp owns the tile's rows i with i % NAIVE_WARPS == warp: it lists a
// row's nonzero slots 64 at a time from shared memory (ballot and rank,
// each entry keyed by its Z row's offset), and gathers their Z rows
// NAIVE_U, then 4, at a time, each lane its CW adjacent columns (one 8- or
// 16-byte load where B allows), added to the columns' fmaf chains in slot
// order from +0.  A row wider than what is left of its stage goes on in
// the next stage: its partial sums wait in its D row, reloaded by the same
// lanes.  Skipping zero-weight slots is exact because Z is finite, so the
// result equals the blocked kernel's bit for bit; the load paths stay
// separate.  On the H100 the Z loads are not hidden: with every gather
// aimed at one cached row the kernel takes 0.72 of its time at the main
// path's shape (PERF.md), and it runs fewer warps an SM than the blocked
// kernel.  Staging costs every slot's id (the blocked
// kernel reads the nonzero slots' only).  A variant whose Z rows came by
// cp.async.bulk too, past L1, ran at about half the speed.
// tools/naive_probe.py times the NAIVE_* constants below, the 32-bit keys
// and the loop-free instance against their alternatives (PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int NAIVE_WARPS = 8;     // consumer warps a CTA, one row at a time
constexpr int NAIVE_STAGES = 2;    // ring stages of ids and weights
constexpr int NAIVE_CAP = 1024;    // slots a stage (a multiple of 4)
constexpr int NAIVE_PAD = NAIVE_CAP + 4;  // room for a block's misaligned head
constexpr int NAIVE_U = 8;         // Z rows in flight a warp
constexpr int NAIVE_THREADS = (NAIVE_WARPS + 1) * 32;
static_assert(NAIVE_U % 4 == 0 && NAIVE_CAP % 4 == 0, "pairs, then fours; aligned stages");

struct NaiveSmem {
  int ids[NAIVE_STAGES][NAIVE_PAD];
  float w[NAIVE_STAGES][NAIVE_PAD];
  int2 listed[NAIVE_WARPS][SLOTS];   // a warp's nonzero slots by rank (16-byte aligned)
  unsigned long long full[NAIVE_STAGES], empty[NAIVE_STAGES];
};
static_assert(offsetof(NaiveSmem, listed) % 16 == 0, "entries are read in pairs");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes),
               "r"(bar) : "memory");
}

// Orders this CTA's earlier shared-memory accesses before its next bulk
// copies into shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A block of cnt 4-byte slots at p, as staged: slot j lands at buf[shift +
// j], shift = p's 4-byte words past a 16-byte boundary, so the bulk copy's
// both ends are aligned.  The first `head` slots (up to 3, before p's next
// 16-byte boundary) and the last ones after `body` (a multiple of 4, the
// bulk copy) come by ordinary loads.
struct Block {
  int shift, head, body;
};

__device__ __forceinline__ Block block_of(const void* p, int cnt) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int head = min(cnt, (4 - shift) & 3);
  return {shift, head, (cnt - head) & ~3};
}

// Producer lane e (0..7 of the lanes given to this block) loads head slot
// e (e < 4) or tail slot e - 4 of the block, where there is one.
__device__ __forceinline__ void stage_edges(const int* __restrict__ src,
                                            int* buf, int cnt, Block k,
                                            int e) {
  if (e < 0 || e >= 8) return;
  const int j = e < 4 ? e : k.head + k.body + (e - 4);
  if (e < 4 ? e < k.head : j < cnt) buf[k.shift + j] = __ldg(src + j);
}

// The tiles of `rows` rows a CTA walks, and each tile's stages: calls
// visit(stage index, tile, its first slot in the tile, slots) in ring
// order.  A tile's slots (rows * h, under 2^31) stream in stages of
// NAIVE_CAP.
template <class Visit>
__device__ __forceinline__ void walk_stages(int n, int h, int rows, Visit visit) {
  const int n_tiles = (int)(((long long)n + rows - 1) / rows);
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int slots = min(rows, n - t * rows) * h;
    for (int l0 = 0; l0 < slots; l0 += NAIVE_CAP, ++it)
      visit(it, t, l0, min(NAIVE_CAP, slots - l0));
  }
}

// A listed slot's key: its Z row's offset id * B, which fits 32 bits
// unless WIDE (v * B >= 2^32), where it is the id.
template <bool WIDE>
__device__ __forceinline__ unsigned slot_key(int id, int b) {
  return WIDE ? (unsigned)id : (unsigned)id * (unsigned)b;
}

template <bool WIDE>
__device__ __forceinline__ const float* z_row(const float* z, unsigned key,
                                              int b) {
  return WIDE ? z + (size_t)key * b : z + key;
}

// The Z rows (zc: Z at the lane's first column) of cnt (1..NU) listed
// slots at e (16-byte aligned), all loads in flight before the first fmaf,
// added in list order; the entries read two at a time.  Past cnt a lane
// loads the last slot's row again and adds nothing: no branches.  cnt ==
// NU where the caller knows it, so the tests fold away.
template <int NU, int CW, bool VEC, bool WIDE>
__device__ __forceinline__ void gather_group(const int2* e, int cnt,
                                             const float* zc, int col, int b,
                                             float (&acc)[CW]) {
  float wv[NU], zv[NU][CW];
  const unsigned last = cnt < NU ? (unsigned)e[cnt - 1].x : 0u;
#pragma unroll
  for (int u = 0; u < NU; u += 2) {
    const int4 p = reinterpret_cast<const int4*>(e)[u / 2];
    wv[u] = __int_as_float(p.y);
    wv[u + 1] = __int_as_float(p.w);
    load_cols<CW, VEC>(z_row<WIDE>(zc, u < cnt ? (unsigned)p.x : last, b), col,
                       b, zv[u]);
    load_cols<CW, VEC>(z_row<WIDE>(zc, u + 1 < cnt ? (unsigned)p.z : last, b),
                       col, b, zv[u + 1]);
  }
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (u < cnt) acc[j] = fmaf(wv[u], zv[u][j], acc[j]);
}

// One piece of a row: len slots in slot order at si / sw in the stage; its
// D row's partial sums carried in orow when the row goes on from an
// earlier stage (!first).
template <int CW, bool VEC, bool ONE, bool WIDE>
__device__ __forceinline__ void naive_piece(
    const int* si, const float* sw, int len, bool first,
    const float* __restrict__ z, float* __restrict__ orow, int b, int lane,
    int2* buf) {
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; ONE ? c0 == 0 : c0 < b; c0 += 32 * CW) {
    const int col = c0 + lane * CW;
    float acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      acc[j] = first || col + j >= b ? 0.f : orow[col + j];
    for (int p0 = 0; ONE ? p0 == 0 : p0 < len; p0 += SLOTS) {
      const int pa = p0 + lane, pb = pa + 32;
      const float wa = pa < len ? sw[pa] : 0.f;
      const float wb = pb < len ? sw[pb] : 0.f;
      const unsigned ma = __ballot_sync(FULL, wa != 0.f);
      const unsigned mb = __ballot_sync(FULL, wb != 0.f);
      const int nz = __popc(ma) + __popc(mb);
      if (nz == 0) continue;  // warp-uniform
      if (wa != 0.f)
        buf[__popc(ma & below)] =
            make_int2(slot_key<WIDE>(si[pa], b), __float_as_int(wa));
      if (wb != 0.f)
        buf[__popc(ma) + __popc(mb & below)] =
            make_int2(slot_key<WIDE>(si[pb], b), __float_as_int(wb));
      __syncwarp();
      // whole groups of NAIVE_U, then of 4, then the last 1..3 slots
      const float* zc = z + col;
      int g = 0;
      for (; g + NAIVE_U <= nz; g += NAIVE_U)
        gather_group<NAIVE_U, CW, VEC, WIDE>(buf + g, NAIVE_U, zc, col, b, acc);
      for (; g + 4 <= nz; g += 4)
        gather_group<4, CW, VEC, WIDE>(buf + g, 4, zc, col, b, acc);
      if (g < nz) gather_group<4, CW, VEC, WIDE>(buf + g, nz - g, zc, col, b, acc);
      __syncwarp();  // the list is read before the next piece writes it
    }
    store_cols<CW, VEC>(orow + col, col, b, acc);
  }
}

// ONE: rows of at most SLOTS slots and 32 * CW columns (a row is then one
// piece of one stage), the loops gone at compile time; only where !WIDE.
template <int CW, bool VEC, bool ONE, bool WIDE>
__global__ void __launch_bounds__(NAIVE_THREADS)
spmm_ell_naive_kernel(const int* __restrict__ ids,   // (n, h)
                      const float* __restrict__ w,   // (n, h)
                      const float* __restrict__ z,   // (v, B)
                      float* __restrict__ out,       // (n, B)
                      int n, int h, int b, int rows) {
  extern __shared__ __align__(128) unsigned char naive_raw[];
  NaiveSmem& s = *reinterpret_cast<NaiveSmem*>(naive_raw);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NAIVE_STAGES; ++i) {
      mbar_init(smem_u32(&s.full[i]), 32);
      mbar_init(smem_u32(&s.empty[i]), NAIVE_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only CTA-wide barrier

  if (warp == NAIVE_WARPS) {  // the producer
    walk_stages(n, h, rows, [&](int it, int t, int l0, int cnt) {
      const int st = it % NAIVE_STAGES;
      mbar_wait(smem_u32(&s.empty[st]), ((it / NAIVE_STAGES) & 1) ^ 1);
      const size_t g0 = (size_t)t * rows * h + l0;
      const Block bi = block_of(ids + g0, cnt), bw = block_of(w + g0, cnt);
      const uint32_t full = smem_u32(&s.full[st]);
      if (lane == 0) {
        fence_proxy_async();
        mbar_arrive_tx(full, (uint32_t)(bi.body + bw.body) * 4);
        if (bi.body)
          bulk_g2s(smem_u32(&s.ids[st][bi.shift + bi.head]), ids + g0 + bi.head,
                   bi.body * 4, full);
        if (bw.body)
          bulk_g2s(smem_u32(&s.w[st][bw.shift + bw.head]), w + g0 + bw.head,
                   bw.body * 4, full);
      } else {
        stage_edges(ids + g0, s.ids[st], cnt, bi, lane - 1);
        stage_edges(reinterpret_cast<const int*>(w + g0),
                    reinterpret_cast<int*>(s.w[st]), cnt, bw, lane - 9);
        mbar_arrive(full);
      }
    });
    return;
  }

  walk_stages(n, h, rows, [&](int it, int t, int l0, int cnt) {
    const int st = it % NAIVE_STAGES;
    mbar_wait(smem_u32(&s.full[st]), (it / NAIVE_STAGES) & 1);
    const size_t g0 = (size_t)t * rows * h + l0;
    const int si0 = (int)((reinterpret_cast<uintptr_t>(ids + g0) >> 2) & 3);
    const int sw0 = (int)((reinterpret_cast<uintptr_t>(w + g0) >> 2) & 3);
    // the tile's rows in this stage (ONE: a tile is one stage)
    const int i0 = ONE ? 0 : l0 / h, i1 = ONE ? cnt / h - 1 : (l0 + cnt - 1) / h;
    for (int i = i0 + ((warp - i0 % NAIVE_WARPS) + NAIVE_WARPS) % NAIVE_WARPS;
         i <= i1; i += NAIVE_WARPS) {
      const int rs = i * h;                        // the row's first slot
      const int k0 = max(0, l0 - rs), k1 = min(h, l0 + cnt - rs);
      const int at = rs + k0 - l0;                 // slot k0's place in the stage
      naive_piece<CW, VEC, ONE, WIDE>(
          s.ids[st] + si0 + at, s.w[st] + sw0 + at, k1 - k0, ONE || k0 == 0,
          z, out + ((size_t)t * rows + i) * b, b, lane, s.listed[warp]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&s.empty[st]));
  });
}

template <int CW, bool VEC, bool ONE, bool WIDE>
cudaError_t launch_naive(const void* ids, const void* w, const void* z,
                         void* out, int n, int h, int b, int rows,
                         cudaStream_t stream) {
  auto kernel = spmm_ell_naive_kernel<CW, VEC, ONE, WIDE>;
  const int smem = (int)sizeof(NaiveSmem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NAIVE_THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)n + rows - 1) / rows;
  const int grid = (int)std::min(tiles, (long long)per_sm * sms);
  kernel<<<grid, NAIVE_THREADS, smem, stream>>>(
      (const int*)ids, (const float*)w, (const float*)z, (float*)out, n, h, b,
      rows);
  return cudaGetLastError();
}

// The instance for a shape: ONE where a row is one piece and one column
// chunk, WIDE where v * B >= 2^32.
template <int CW, bool VEC>
cudaError_t launch_naive_for(const void* ids, const void* w, const void* z,
                             void* out, int n, int h, int b, int rows,
                             bool wide, cudaStream_t s) {
  if (wide)
    return launch_naive<CW, VEC, false, true>(ids, w, z, out, n, h, b, rows, s);
  if (h <= SLOTS && b <= 32 * CW)
    return launch_naive<CW, VEC, true, false>(ids, w, z, out, n, h, b, rows, s);
  return launch_naive<CW, VEC, false, false>(ids, w, z, out, n, h, b, rows, s);
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

// rows: doc rows a tile (a multiple of NAIVE_WARPS, whose rows fill at
// most a stage unless rows == NAIVE_WARPS); cw, vec as for the blocked
// kernel.
extern "C" int launch_spmm_ell_naive(const void* ids, const void* w,
                                     const void* z, void* out, int n, int h,
                                     int v, int b, int rows, int cw, int vec,
                                     void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  if (h < 1 || v < 1 || rows < NAIVE_WARPS || rows % NAIVE_WARPS != 0 ||
      (rows > NAIVE_WARPS && (long long)rows * h > NAIVE_CAP) ||
      (long long)rows * h > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (vec && b % cw != 0) return (int)cudaErrorInvalidValue;
  const bool wide = (long long)v * b >= (1LL << 32);
  const cudaStream_t s = (cudaStream_t)stream;
#define NAIVE_ARGS ids, w, z, out, n, h, b, rows, wide, s
  if (cw == 1) return (int)launch_naive_for<1, false>(NAIVE_ARGS);
  if (cw == 2)
    return (int)(vec ? launch_naive_for<2, true>(NAIVE_ARGS)
                     : launch_naive_for<2, false>(NAIVE_ARGS));
  if (cw == 4)
    return (int)(vec ? launch_naive_for<4, true>(NAIVE_ARGS)
                     : launch_naive_for<4, false>(NAIVE_ARGS));
#undef NAIVE_ARGS
  return (int)cudaErrorInvalidValue;
}
