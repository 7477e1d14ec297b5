// LC-RWMD phase 1 on Hopper: squared Z[w, j] = min over the valid words q
// of query j of ||E[w] - T[j, q]||^2, in gram form, clamped at 0.
//
// Replaces the TPU kernel src/repro/kernels/lc_rwmd_phase1.py,
// lc_rwmd_phase1_pallas (_phase1_kernel).
//
// What bounds it: arithmetic.  The dot products cost 2*v*B*h*m FLOP
// (1.35e11 at v=73,123, B=64, h=48, m=300) against only (v + B*h)*m*4 bytes
// of input and v*B*4 bytes of output, so the FP32 FMA rate is the limit.
// The GEMM operands stay float32 and run on the FMA units, not the TF32
// tensor cores, so the result is IEEE float32 as the reference's is.
//
// Design: one CTA owns 64 vocab rows x one query and loops over that
// query's h words inside the CTA, 16 words at a time.  That loop replaces
// the TPU's sequential h grid axis and its revisited output block: the
// running min lives in registers and Z is written once.  E and T tiles are
// staged through shared memory 32 features at a time; each thread keeps a
// 4-row x 1-word accumulator and reads its 4 E values as one float4.  The
// grid puts the query index in x, so the CTAs that share an E tile run
// together and find it in L2.  Neither h nor m is padded: the ragged edges
// are masked.  Invalid query words (valid == 0) and words past h count as
// 3.4e38, as on the TPU.  The wrapper takes the sqrt.
//
// bf16: the GEMM operands are rounded to bf16 (round to nearest even) and
// back before the float32 FMA; a product of two bf16 values is exact in
// float32, which is what preferred_element_type=f32 gives on the TPU.  The
// norms stay float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;       // vocab rows per CTA
constexpr int BW = 16;       // query words per chunk
constexpr int BK = 32;       // features per shared-memory stage
constexpr int THREADS = 256; // 16 word lanes x 16 row groups of 4 rows
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float maybe_bf16(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__global__ void __launch_bounds__(THREADS)
phase1_kernel(const float* __restrict__ emb,    // (v, m)
              const float* __restrict__ t,      // (B, h, m)
              const float* __restrict__ valid,  // (B, h) 0/1
              float* __restrict__ out,          // (v, B) squared Z
              int v, int b, int h, int m, int bf16) {
  __shared__ __align__(16) float es[BK][BM + 4];
  __shared__ float ts[BK][BW + 1];
  __shared__ float e2s[BM];
  __shared__ float t2s[BW];
  __shared__ float vs[BW];

  const int q = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % BW;  // word within the chunk
  const int ty = tid / BW;  // row group: rows ty*4 .. ty*4+3

  // |e|^2 of the tile's rows: 4 threads per row, reduced over lanes.
  {
    const int r = tid / 4, part = tid % 4;
    float s = 0.f;
    if (row0 + r < v) {
      const float* er = emb + (size_t)(row0 + r) * m;
      for (int k = part; k < m; k += 4) s = fmaf(er[k], er[k], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) e2s[r] = s;
  }

  float rmin[4] = {BIG, BIG, BIG, BIG};
  const float* tq = t + (size_t)q * h * m;

  for (int w0 = 0; w0 < h; w0 += BW) {
    // |t|^2 and validity of the chunk's words: 16 threads per word.
    {
      const int w = tid / 16, part = tid % 16;
      float s = 0.f;
      if (w0 + w < h) {
        const float* tr = tq + (size_t)(w0 + w) * m;
        for (int k = part; k < m; k += 16) s = fmaf(tr[k], tr[k], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (part == 0) {
        t2s[w] = s;
        vs[w] = (w0 + w < h) ? valid[(size_t)q * h + w0 + w] : 0.f;
      }
    }

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < m; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (BM * BK) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BK, kk = idx % BK;
        float x = 0.f;
        if (row0 + r < v && k0 + kk < m) x = emb[(size_t)(row0 + r) * m + k0 + kk];
        es[kk][r] = maybe_bf16(x, bf16);
      }
#pragma unroll
      for (int i = 0; i < (BW * BK) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BK, kk = idx % BK;
        float x = 0.f;
        if (w0 + r < h && k0 + kk < m) x = tq[(size_t)(w0 + r) * m + k0 + kk];
        ts[kk][r] = maybe_bf16(x, bf16);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float tv = ts[kk][tx];
        const float4 ev = *reinterpret_cast<const float4*>(&es[kk][ty * 4]);
        acc[0] = fmaf(ev.x, tv, acc[0]);
        acc[1] = fmaf(ev.y, tv, acc[1]);
        acc[2] = fmaf(ev.z, tv, acc[2]);
        acc[3] = fmaf(ev.w, tv, acc[3]);
      }
      __syncthreads();
    }

    const bool ok = vs[tx] > 0.f;
    const float t2 = t2s[tx];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sq = fmaxf(e2s[ty * 4 + i] + t2 - 2.f * acc[i], 0.f);
      if (!ok) sq = BIG;
      rmin[i] = fminf(rmin[i], sq);
    }
    __syncthreads();  // t2s / vs are rewritten by the next chunk
  }

  // Min over the 16 word lanes of each row group (16 consecutive lanes).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = rmin[i];
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 8));
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 4));
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < v) out[(size_t)r * b + q] = x;
  }
}

}  // namespace

extern "C" int launch_lc_rwmd_phase1(const void* emb, const void* t,
                                     const void* valid, void* out, int v,
                                     int b, int h, int m, int bf16,
                                     void* stream) {
  if (v <= 0 || b <= 0) return (int)cudaGetLastError();
  dim3 grid(b, (v + BM - 1) / BM);
  phase1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)emb, (const float*)t, (const float*)valid, (float*)out, v,
      b, h, m, bf16);
  return (int)cudaGetLastError();
}
