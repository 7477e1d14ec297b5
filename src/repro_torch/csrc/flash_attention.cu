// Causal GQA attention with an online softmax (flash attention) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas (_flash_kernel).  Its grid is (B, Hq, S/bq, T/bk)
// with the KV tiles innermost: one query head's 512-row block keeps the
// running max, sum and accumulator in VMEM across the KV sweep, reads KV
// head h // group, and skips the KV tiles wholly above the diagonal.
//
// What bounds it: operations.  Causal attention does 2*B*Hq*S*T*dh FLOP
// (Q.K^T and P.V over the lower triangle) on (B*S*Hq + 2*B*T*Hkv)*dh
// inputs: at dh = 64 that is far above the card's ratio of operations to
// bytes, and this first design runs the products on the float32 FMA units
// (67 TFLOP/s), not the tensor cores.
//
// Design: one CTA of 256 threads per (batch, KV head, query tile) serves
// gc query heads of that KV head at once (gc = 4 for llama3.2-1b's group of
// 4), so every K/V tile staged in shared memory serves all of them: its
// R = 256 rows (128 at dh = 128) are gc heads x bq = R / gc positions.
// Q is staged once, transposed (Qs[d][r]); per 64-key tile, K is staged
// transposed (Ks[d][j]) and V as it is (Vs[j][d]), both in float32.
// A thread owns TR rows: for S = Q.K^T it computes TR x 8 scores (its 8
// keys), for O += P.V the same TR rows x dh/8 output columns, so the
// online-softmax statistics of its rows (max, sum, rescale factor) stay in
// its registers; the 8 threads of a row group are neighbouring lanes and
// reduce the row max and sum by shuffle.  P goes through shared memory
// (Ps[r][j]) between the two products.  KV tiles wholly above the CTA's
// diagonal are skipped, and the heaviest query tiles are launched first.
//
// Semantics, as the reference kernel's: scores Q.K^T in float32 times
// dh^-0.5 after the product; causal masking by the finite sentinel -1e30;
// p = exp(s - m) rounded to v's dtype before P.V, its sum kept in float32;
// O accumulated in float32 and divided by max(l, 1e-30) at the end, then
// cast to q's dtype.  bf16 x bf16 products are exact in float32, and the
// float32 inputs use IEEE FMAs (no TF32), so the kernel differs from its
// plain version only in the order of its sums and, for bf16, in the running
// max against which p is rounded.  The kernel also takes lengths that are
// not tile multiples: rows past S are not stored and keys past T are absent
// (p = 0).  The first KV tile always holds key 0, valid for every row, so
// every row's max is finite after the first tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;      // keys per KV tile
constexpr int KPT = 8;      // keys per thread in the score tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DH, int TR>
struct Tile {
  static constexpr int R = 32 * TR;       // query rows per CTA
  static constexpr int TD = DH / 8;       // output columns per thread
  static constexpr int EPV = 16 / (int)sizeof(T);  // elements per 16-byte load
  static constexpr int QLD = R + 4;       // Qs[d][r]
  static constexpr int KLD = BK + 4;      // Ks[d][j]
  static constexpr int VLD = DH + 4;      // Vs[j][d]
  static constexpr int PLD = BK + 4;      // Ps[r][j]
  static constexpr int SMEM = (DH * QLD + DH * KLD + BK * VLD + R * PLD) * 4;
};

template <typename T, int DH, int TR>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const T* __restrict__ q,   // (B, S, Hq, DH)
             const T* __restrict__ k,   // (B, Tk, Hkv, DH)
             const T* __restrict__ v,   // (B, Tk, Hkv, DH)
             T* __restrict__ o,         // (B, S, Hq, DH)
             int S, int Tk, int Hq, int Hkv, int gc, int causal, float scale) {
  using C = Tile<T, DH, TR>;
  constexpr int R = C::R, TD = C::TD, EPV = C::EPV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // DH x QLD
  float* Ks = Qs + DH * C::QLD;          // DH x KLD
  float* Vs = Ks + DH * C::KLD;          // BK x VLD
  float* Ps = Vs + BK * C::VLD;          // R x PLD

  const int tid = threadIdx.x;
  const int group = Hq / Hkv;
  const int ngc = group / gc;
  const int bq = R / gc;
  const int n_qt = (S + bq - 1) / bq;
  // heaviest causal tiles first
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * bq;
  const int hk = blockIdx.y / ngc;
  const int h0 = hk * group + (blockIdx.y % ngc) * gc;  // first query head
  const int b = blockIdx.z;

  // ---- stage Q (rows past S as zeros), transposed ----
  {
    constexpr int NCH = THREADS / R;      // column chunks per row
    constexpr int CW = DH / NCH;          // columns per chunk
    const int r = tid % R;
    const int c = tid / R;
    const int pos = q0 + r % bq;
    const int h = h0 + r / bq;
    float buf[EPV];
#pragma unroll
    for (int d0 = c * CW; d0 < c * CW + CW; d0 += EPV) {
      if (pos < S) {
        load_vec(q + (((size_t)b * S + pos) * Hq + h) * DH + d0, buf);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) buf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) Qs[(d0 + e) * C::QLD + r] = buf[e];
    }
  }

  const int ty = tid / 8;   // row group: rows ty*TR .. ty*TR+TR-1
  const int tx = tid % 8;   // keys tx*8 .. tx*8+7; output columns tx*TD ..
  const int r0 = ty * TR;
  const int qpos0 = q0 + r0 % bq;   // the TR rows share one head
  float m[TR], l[TR], acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(Tk, q0 + bq) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    // ---- stage K (transposed) and V; keys past Tk as zeros ----
    {
      constexpr int CW = DH / (THREADS / BK);
      const int j = tid % BK;
      const int c = tid / BK;
      const int pos = k0 + j;
      float buf[EPV];
#pragma unroll
      for (int d0 = c * CW; d0 < c * CW + CW; d0 += EPV) {
        const size_t at = (((size_t)b * Tk + pos) * Hkv + hk) * DH + d0;
        if (pos < Tk) load_vec(k + at, buf);
        else {
#pragma unroll
          for (int e = 0; e < EPV; ++e) buf[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < EPV; ++e) Ks[(d0 + e) * C::KLD + j] = buf[e];
        if (pos < Tk) load_vec(v + at, buf);
#pragma unroll
        for (int e = 0; e < EPV; e += 4)
          *reinterpret_cast<float4*>(&Vs[j * C::VLD + d0 + e]) =
              make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
      }
    }
    __syncthreads();

    // ---- S = Q.K^T for TR rows x 8 keys ----
    float s[TR][KPT];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[TR], kb[KPT];
#pragma unroll
      for (int i = 0; i < TR; i += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(&Qs[d * C::QLD + r0 + i]);
        qa[i] = t4.x; qa[i + 1] = t4.y; qa[i + 2] = t4.z; qa[i + 3] = t4.w;
      }
#pragma unroll
      for (int jj = 0; jj < KPT; jj += 4) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&Ks[d * C::KLD + tx * KPT + jj]);
        kb[jj] = t4.x; kb[jj + 1] = t4.y; kb[jj + 2] = t4.z; kb[jj + 3] = t4.w;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[i][jj] = fmaf(qa[i], kb[jj], s[i][jj]);
    }

    // ---- online softmax over the tile ----
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = qpos0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int kpos = k0 + tx * KPT + jj;
        float x = s[i][jj] * scale;
        if (kpos >= Tk) x = -INFINITY;                // absent key: p = 0
        else if (causal && kpos > qpos) x = NEG;      // the reference's mask
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
      float pr[KPT];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        pr[jj] = round_to(p, T());
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) acc[i][dd] *= alpha;
#pragma unroll
      for (int jj = 0; jj < KPT; jj += 4)
        *reinterpret_cast<float4*>(&Ps[(r0 + i) * C::PLD + tx * KPT + jj]) =
            make_float4(pr[jj], pr[jj + 1], pr[jj + 2], pr[jj + 3]);
    }
    __syncthreads();

    // ---- O += P.V for TR rows x TD columns ----
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pa[TR][4];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 t4 = *reinterpret_cast<const float4*>(&Ps[(r0 + i) * C::PLD + j]);
        pa[i][0] = t4.x; pa[i][1] = t4.y; pa[i][2] = t4.z; pa[i][3] = t4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vb[TD];
#pragma unroll
        for (int dd = 0; dd < TD; dd += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * C::VLD + tx * TD + dd]);
          vb[dd] = t4.x; vb[dd + 1] = t4.y; vb[dd + 2] = t4.z; vb[dd + 3] = t4.w;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int dd = 0; dd < TD; ++dd)
            acc[i][dd] = fmaf(pa[i][jj], vb[dd], acc[i][dd]);
      }
    }
  }

  // ---- O / max(l, 1e-30), cast to q's dtype ----
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + i;
    const int pos = q0 + r % bq;
    if (pos >= S) continue;
    const int h = h0 + r / bq;
    T* orow = o + (((size_t)b * S + pos) * Hq + h) * DH + tx * TD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) store(orow + dd, acc[i][dd] / den);
  }
}

template <typename T, int DH, int TR>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int t, int hq, int hkv, int gc, int causal, float scale,
           cudaStream_t stream) {
  using C = Tile<T, DH, TR>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bq = C::R / gc;
  dim3 grid((s + bq - 1) / bq, hkv * (hq / hkv / gc), b);
  flash_kernel<T, DH, TR><<<grid, THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, t, hq, hkv, gc, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int s, int t, int hq, int hkv, int dh, int gc, int causal,
              float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32, 8>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, stream);
    case 64:
      return launch<T, 64, 8>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, stream);
    case 128:
      return launch<T, 128, 4>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int t, int hq, int hkv, int dh, int gc,
                                      int causal, int bf16, float scale,
                                      void* stream) {
  if (b <= 0 || s <= 0) return (int)cudaGetLastError();
  if (t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, b, s, t, hq, hkv, dh, gc,
                                    causal, scale, st);
  return launch_dh<float>(q, k, v, o, b, s, t, hq, hkv, dh, gc, causal, scale,
                          st);
}
