// GNN gather-scale-scatter on Hopper: out[n, :] = sum over the edges e with
// dst[e] = n of rad[e] * feat[src[e], :], edges sorted by dst.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py,
// segment_spmm_pallas (_seg_kernel).  Its grid walks the edges one per step:
// scalar prefetch steers the feat row to gather (src) and the output row to
// accumulate into (dst), and the first edge of a row initialises it.
//
// What bounds it: memory.  Counting each input once, that is 12 bytes per
// edge (src, dst, rad) plus feat and out (0.81 ms at the ogbn-products
// cell).  But the feat rows are gathered by edge: E * D * 4 bytes (24.7 GB
// there), from a table of ~1 GB that the 50 MB L2 does not hold, with src
// uniform, so nearly every row comes from HBM.  A 400-byte row at offset
// s * 400 covers 13 or 14 sectors of 32 bytes (~416 bytes on average):
// 25.7 GB, a floor of 7.7 ms at 3.35 TB/s.  What the card reaches on such
// scattered rows, not the number of rows in flight, sets the time: 4, 8
// or 16 rows in flight a warp and 16-byte or 4-byte loads ran within a few
// percent of one another, and L2 prefetch hints of 128 or 256 bytes ran
// slower (more bytes).
//
// Design: one warp owns ROWS (32) consecutive destination rows.  It finds
// its first edge itself, by a lane-parallel search of the sorted dst (32
// probes a step), and walks from there until an edge's dst reaches the
// next warp's rows, so no offsets pass runs before the kernel.  The warp
// walks its edges in order, 32 at a time (lane p holds edge p's src, dst
// and rad; the next 32 are loaded ahead), and gathers the feat rows of
// UNROLL edges before it adds any of them, across row boundaries.  The
// lanes run over the columns: 16-byte loads (float4) when D % 4 == 0 and
// the tensors are 16-byte aligned (25 of 32 lanes at D = 100, one pass),
// 4-byte loads otherwise, up to NV vectors a lane per pass over the row.
// When the edge's dst changes the finished row is stored and the rows that
// no edge reaches are written 0, so every row of the warp's range is
// written once, with no memset.  The sum of a row runs in ascending edge
// order, the TPU grid's order, as out = out + rad * feat with a separately
// rounded multiply and add (__fmul_rn, __fadd_rn), from 0.  No atomics:
// the result is deterministic.  A long row (a hub, or the sink row of the
// padding edges) stays one warp's serial chain, UNROLL rows in flight at a
// time.  Edge indices are 64-bit where a lane or the look-ahead adds to
// them, so any E < 2^31 is walked without overflow.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;   // warps per CTA
constexpr int UNROLL = 8;  // edges whose feat rows are in flight per warp
constexpr int ROWS = 32;   // destination rows per warp

// First index e in [lo, hi) with dst[e] >= key, or hi; dst ascending.  Each
// step probes the last element of 32 equal buckets, one per lane, and keeps
// the first bucket whose last element reaches key.
__device__ int lower_bound_warp(const int* __restrict__ dst, int lo, int hi,
                                int key, int lane) {
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const long long step = (len + 31) / 32;
    const long long pos = lo + min((lane + 1) * step, len) - 1;
    const int k = __popc(__ballot_sync(FULL, __ldg(dst + pos) < key));
    const long long nlo = lo + k * step;
    hi = (int)min(nlo + step, (long long)hi);
    lo = (int)min(nlo, (long long)hi);
  }
  const bool below = (long long)lo + lane < hi && __ldg(dst + lo + lane) < key;
  return lo + __popc(__ballot_sync(FULL, below));
}

__device__ __forceinline__ void madd(float& a, float r, float f) {
  a = __fadd_rn(a, __fmul_rn(r, f));
}
__device__ __forceinline__ void madd(float4& a, float r, float4 f) {
  madd(a.x, r, f.x);
  madd(a.y, r, f.y);
  madd(a.z, r, f.z);
  madd(a.w, r, f.w);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }

// T is float4 (the vector route) or float; the lanes own vectors
// c0 + lane + 32 j, j < NV, of each row's nv vectors.
template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32)
segment_spmm_kernel(const int* __restrict__ src,     // (E,)
                    const int* __restrict__ dst,     // (E,), ascending
                    const T* __restrict__ feat,      // (N, nv)
                    const float* __restrict__ rad,   // (E,)
                    T* __restrict__ out,             // (n_out, nv)
                    int n_out, int n_edges, int nv) {
  const int lane = threadIdx.x % 32;
  const long long r0l = ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * ROWS;
  if (r0l >= n_out) return;
  const int r0 = (int)r0l;
  const int r1 = (int)min(r0l + ROWS, (long long)n_out);
  // the warp's first edge; its last is found by walking: the first edge
  // whose dst reaches r1 ends the range
  const long long e0 = lower_bound_warp(dst, 0, n_edges, r0, lane);

  for (int c0 = 0; c0 < nv; c0 += 32 * NV) {
    T acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) zero(acc[j]);
    int row = -1;   // the row being summed, -1 before the first edge
    int next = r0;  // the first row not yet written
    auto store = [&](int r, bool sum) {
      T* orow = out + (size_t)r * nv;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < nv) {
          T v;
          zero(v);
          orow[c] = sum ? acc[j] : v;
        }
      }
    };
    // edges b0 .. b0 + 31, lane p holding edge b0 + p (dst INT_MAX past
    // the edges); the next 32 loaded ahead
    int n_src = 0, n_dst = INT_MAX;
    float n_rad = 0.f;
    if (e0 + lane < n_edges) {
      n_src = __ldg(src + e0 + lane);
      n_dst = __ldg(dst + e0 + lane);
      n_rad = __ldg(rad + e0 + lane);
    }
    for (long long b0 = e0; b0 < n_edges; b0 += 32) {
      const int my_src = n_src, my_dst = n_dst;
      const float my_rad = n_rad;
      const long long e = b0 + 32 + lane;
      n_dst = INT_MAX;
      if (e < n_edges) {
        n_src = __ldg(src + e);
        n_dst = __ldg(dst + e);
        n_rad = __ldg(rad + e);
      }
      // the batch's edges of this warp's rows: a prefix, dst being sorted
      const int nb = __popc(__ballot_sync(FULL, my_dst < r1));
      for (int p = 0; p < nb; p += UNROLL) {
        T f[UNROLL][NV];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int s = __shfl_sync(FULL, my_src, (p + u) % 32);
          const T* fr = feat + (size_t)s * nv;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int c = c0 + lane + 32 * j;
            if (p + u < nb && c < nv) f[u][j] = __ldg(fr + c);
            else zero(f[u][j]);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (p + u >= nb) break;  // warp-uniform
          const int d = __shfl_sync(FULL, my_dst, p + u);
          const float r = __shfl_sync(FULL, my_rad, p + u);
          if (d != row) {  // warp-uniform: a row ends
            if (row >= 0) {
              store(row, true);
              next = row + 1;
            }
            for (; next < d; ++next) store(next, false);
            row = d;
#pragma unroll
            for (int j = 0; j < NV; ++j) zero(acc[j]);
          }
#pragma unroll
          for (int j = 0; j < NV; ++j) madd(acc[j], r, f[u][j]);
        }
      }
      if (nb < 32) break;
    }
    if (row >= 0) {
      store(row, true);
      next = row + 1;
    }
    for (; next < r1; ++next) store(next, false);
  }
}

template <typename T, int NV>
cudaError_t launch(const void* src, const void* dst, const void* feat,
                   const void* rad, void* out, int n_out, int n_edges, int nv,
                   cudaStream_t stream) {
  const long long warps = ((long long)n_out + ROWS - 1) / ROWS;
  const long long grid = (warps + WARPS - 1) / WARPS;
  segment_spmm_kernel<T, NV><<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      (const int*)src, (const int*)dst, (const T*)feat, (const float*)rad,
      (T*)out, n_out, n_edges, nv);
  return cudaGetLastError();
}

}  // namespace

// vec: 4 for the float4 route (d % 4 == 0, feat and out 16-byte aligned),
// 1 for 4-byte loads.
extern "C" int launch_segment_spmm(const void* src, const void* dst,
                                   const void* feat, const void* rad, void* out,
                                   int n_out, int n_edges, int d, int vec,
                                   void* stream) {
  if (n_out <= 0 || d <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    if (d % 4 != 0 || (uintptr_t)feat % 16 != 0 || (uintptr_t)out % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int nv = d / 4;
    return (int)(nv <= 32
        ? launch<float4, 1>(src, dst, feat, rad, out, n_out, n_edges, nv, s)
        : launch<float4, 2>(src, dst, feat, rad, out, n_out, n_edges, nv, s));
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return (int)(d <= 32
      ? launch<float, 1>(src, dst, feat, rad, out, n_out, n_edges, d, s)
      : launch<float, 4>(src, dst, feat, rad, out, n_out, n_edges, d, s));
}
