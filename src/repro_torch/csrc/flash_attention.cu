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
// bytes, so the products belong on the tensor cores (989 TFLOP/s bf16),
// and the softmax between them (one exp and a few float32 operations a
// score) on the FMA and MUFU units is the next limit.
//
// bf16 design (flash_tc_kernel): one CTA per (query tile, head group,
// batch) serves gc query heads of one KV head at once (gc = 4 for
// llama3.2-1b's group of 4), so every K/V tile staged in shared memory
// serves all of them: its R = 256 rows (128 at dh = 128) are gc heads x
// bq = R / gc positions, 32 rows to each of its 8 warps (16 at dh = 128,
// whose accumulators take twice the registers).  Q is staged once in bf16
// and held in registers as mma.sync A fragments for the whole sweep.  K
// and V come in 64-key bf16 tiles by cp.async into a ring of three stages,
// so the next tile's load overlaps this tile's products and one barrier a
// tile suffices.  Each warp computes S = Q.K^T for its rows with mma.sync
// m16n8k16 (bf16 inputs, float32 accumulators) and runs the online
// softmax on the accumulators in registers (the four lanes of a row reduce
// its max by shuffle), the scale applied in float32 after the product,
// inside the exponent.  p is rounded to bf16 where it becomes the A operand
// of O += P.V, a second mma.sync whose A fragments are the S accumulators'
// own registers: P never passes through shared memory.  Padded shared-
// memory rows (dh + 8 elements) keep ldmatrix free of bank conflicts.  KV
// tiles wholly above the CTA's diagonal are not loaded, tiles above a
// warp's own rows are not computed by that warp, a rescale by 1 is
// skipped, and the CTAs run in one heaviest-first order over all heads and
// batches (the query tile is the slowest grid index), so the last wave is
// the lightest.  This is the mma.sync step of the design: the products
// reach about a fifth of the tensor cores' peak, the softmax and the
// per-warp shared-memory reads of K and V share the rest; wgmma with a
// producer/consumer split (TMA loads, one warpgroup's softmax overlapping
// another's products) is the next step.
//
// float32 design (flash_f32_kernel): the products on the FMA units in IEEE
// float32 (the port's precision rule forbids TF32), with the same CTA
// tiling: Q transposed and K/V staged in float32, a thread owns 8 rows x
// 8 keys of S and the same rows x dh/8 columns of O, P through shared
// memory between the two products.
//
// Semantics, as the reference kernel's: scores Q.K^T in float32 times
// dh^-0.5 after the product; causal masking by the finite sentinel -1e30
// (on the tiles that cross the diagonal); p = exp(s - m) rounded to v's
// dtype before P.V, its sum l kept in float32; O accumulated in float32
// and divided by max(l, 1e-30) at the end, then cast to q's dtype.  bf16 x
// bf16 products are exact in float32, so the kernels differ from their
// plain version only in the order of their sums and, for bf16, in the
// running max against which p is rounded.  Both take lengths that are not
// tile multiples: rows past S are not stored and keys past T are absent
// (p = 0: their scores are -inf, not the score of a zero-filled key).  The
// first KV tile always holds key 0, valid for every row, so every row's
// max is finite after the first tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // the float32 kernel's
constexpr int BK = 64;        // keys per KV tile (both kernels)
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
  // 8 warps of 32 rows (16 at dh = 128, whose O accumulators take twice
  // the registers): each K/V fragment a warp loads serves two m16 tiles
  static constexpr int WARPS = 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int MT = DH == 128 ? 1 : 2;  // m16 row tiles per warp
  static constexpr int WR = 16 * MT;            // rows per warp
  static constexpr int R = WARPS * WR;          // rows per CTA
  static constexpr int LD = DH + 8;             // padded smem row, in bf16
  static constexpr int KT = DH / 16;            // k16 steps of Q.K^T
  static constexpr int NS = BK / 8;             // n8 tiles of S
  static constexpr int NO = DH / 8;             // n8 tiles of O
  static constexpr int CH = DH / 8;             // 16-byte chunks per row
  static constexpr int TILE = BK * LD;          // one K or V stage, bf16
  static constexpr int SMEM = (R * LD + STAGES * 2 * TILE) * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the MUFU unit (subnormal results flush to 0: p < 2^-126 adds
// nothing a float32 sum of ones can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,   // (B, S, Hq, DH)
                const __nv_bfloat16* __restrict__ k,   // (B, Tk, Hkv, DH)
                const __nv_bfloat16* __restrict__ v,   // (B, Tk, Hkv, DH)
                __nv_bfloat16* __restrict__ o,         // (B, S, Hq, DH)
                int S, int Tk, int Hq, int Hkv, int gc, int causal,
                float scale) {
  using C = Cfg<DH>;
  constexpr int MT = C::MT, LD = C::LD, NS = C::NS, NO = C::NO, CH = C::CH;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm;                 // R x LD
  __nv_bfloat16* KVs = sm + C::R * LD;    // [stage][K, V] x TILE

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int group = Hq / Hkv;
  const int ngc = group / gc;
  const int bq = C::R / gc;
  const int n_qt = (S + bq - 1) / bq;
  // one CTA per (query tile, head group, batch), the query tile slowest:
  // all the heaviest causal tiles launch first, the lightest last
  const int n_hb = (int)gridDim.x / n_qt;  // head groups x batch
  const int qi = (int)blockIdx.x / n_hb, hb = (int)blockIdx.x % n_hb;
  const int qt = causal ? n_qt - 1 - qi : qi;
  const int q0 = qt * bq;
  const int hy = hb % (Hkv * ngc);
  const int hk = hy / ngc;
  const int h0 = hk * group + (hy % ngc) * gc;
  const int b = hb / (Hkv * ngc);
  // this warp's rows: one head, positions wq0 .. wq0 + WR - 1
  const int wr0 = warp * C::WR;
  const int wh = h0 + wr0 / bq;
  const int wq0 = q0 + wr0 % bq;

  const int k_end = causal ? min(Tk, q0 + bq) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    __nv_bfloat16* ks = KVs + stage * 2 * C::TILE;
    __nv_bfloat16* vs = ks + C::TILE;
    for (int idx = tid; idx < BK * CH; idx += C::THREADS) {
      const int j = idx / CH, c = idx % CH;
      const int pos = k0 + j;
      const bool ok = pos < Tk;
      const size_t at = ok ? (((size_t)b * Tk + pos) * Hkv + hk) * DH + c * 8 : 0;
      cp_async16(smem_u32(ks + j * LD + c * 8), k + at, ok ? 16 : 0);
      cp_async16(smem_u32(vs + j * LD + c * 8), v + at, ok ? 16 : 0);
    }
  };

  // Q (rows past S as zeros) and the first KV tile, one group
  for (int idx = tid; idx < C::R * CH; idx += C::THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int pos = q0 + r % bq;
    const int h = h0 + r / bq;
    const bool ok = pos < S;
    const size_t at = ok ? (((size_t)b * S + pos) * Hq + h) * DH + c * 8 : 0;
    cp_async16(smem_u32(Qs + r * LD + c * 8), q + at, ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  // Scores stay unscaled in the registers: the masks and the running max m
  // are in those units (the sentinel -1e30 / scale), and the scale enters
  // in float32 in the exponent, p = 2^(s * c - m * c) with c = scale*log2 e.
  const float c = scale * LOG2E;
  const float neg = NEG / scale;
  uint32_t qf[MT][C::KT][4];
  float oacc[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = neg;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][n][e] = 0.f;
  }

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lr = lane % 8, lm = lane / 8;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) % STAGES);
    cp_async_commit();  // (possibly empty) keeps the group count uniform
    cp_async_wait1();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kt = 0; kt < C::KT; ++kt) {
          const int r = wr0 + mt * 16 + lr + (lm % 2) * 8;
          ldsm_x4(smem_u32(Qs + r * LD + kt * 16 + (lm / 2) * 8),
                  qf[mt][kt][0], qf[mt][kt][1], qf[mt][kt][2], qf[mt][kt][3]);
        }
    }
    const int k0 = it * BK;
    // keys above all of this warp's rows: nothing to add
    if (!(causal && k0 > wq0 + C::WR - 1)) {
      const __nv_bfloat16* ks = KVs + (it % STAGES) * 2 * C::TILE;
      const __nv_bfloat16* vs = ks + C::TILE;

      // ---- S = Q.K^T ----
      float sacc[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mt][j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < C::KT; ++kt) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b0, b1, b2, b3;
          const int key = j * 8 + (lm / 2) * 8 + lr;
          ldsm_x4(smem_u32(ks + key * LD + kt * 16 + (lm % 2) * 8), b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(sacc[mt][j], qf[mt][kt], b0, b1);
            mma16816(sacc[mt][j + 1], qf[mt][kt], b2, b3);
          }
        }
      }

      // ---- online softmax on the accumulators ----
      const bool edge = (causal && k0 + BK - 1 > wq0) || k0 + BK > Tk;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int qpos = wq0 + mt * 16 + g + hf * 8;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sacc[mt][j][hf * 2 + e];
              if (edge) {
                const int kpos = k0 + j * 8 + t4 * 2 + e;
                if (kpos >= Tk) x = -INFINITY;            // absent key: p = 0
                else if (causal && kpos > qpos) x = neg;  // the reference's mask
              }
              sacc[mt][j][hf * 2 + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][hf], mx);
          const float alpha = ex2((m[mt][hf] - m_new) * c);
          const float mb = m_new * c;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ex2(fmaf(sacc[mt][j][hf * 2 + e], c, -mb));
              sacc[mt][j][hf * 2 + e] = p;
              sum += p;
            }
          l[mt][hf] = l[mt][hf] * alpha + sum;  // this lane's columns
          m[mt][hf] = m_new;
          if (__any_sync(0xffffffffu, alpha != 1.f)) {  // x * 1 is x
#pragma unroll
            for (int n = 0; n < NO; ++n) {
              oacc[mt][n][hf * 2] *= alpha;
              oacc[mt][n][hf * 2 + 1] *= alpha;
            }
          }
        }
      }

      // ---- O += P.V, P (bf16) from the S registers ----
#pragma unroll
      for (int s16 = 0; s16 < BK / 16; ++s16) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(sacc[mt][2 * s16][0], sacc[mt][2 * s16][1]);
          pa[mt][1] = pack_bf16(sacc[mt][2 * s16][2], sacc[mt][2 * s16][3]);
          pa[mt][2] = pack_bf16(sacc[mt][2 * s16 + 1][0], sacc[mt][2 * s16 + 1][1]);
          pa[mt][3] = pack_bf16(sacc[mt][2 * s16 + 1][2], sacc[mt][2 * s16 + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b0, b1, b2, b3;
          const int key = s16 * 16 + (lm % 2) * 8 + lr;
          ldsm_x4_t(smem_u32(vs + key * LD + n * 8 + (lm / 2) * 8), b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(oacc[mt][n], pa[mt], b0, b1);
            mma16816(oacc[mt][n + 1], pa[mt], b2, b3);
          }
        }
      }
    }
    // No barrier here: the next iteration refills the stage of tile it - 1,
    // which every warp finished before the barrier at this iteration's top.
  }

  // ---- O / max(l, 1e-30), cast to bf16 ----
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float den = fmaxf(lt, 1e-30f);
      const int pos = wq0 + mt * 16 + g + hf * 8;
      if (pos >= S) continue;
      __nv_bfloat16* orow = o + (((size_t)b * S + pos) * Hq + wh) * DH + t4 * 2;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
            oacc[mt][n][hf * 2] / den, oacc[mt][n][hf * 2 + 1] / den);
    }
  }
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int s, int t, int hq, int hkv, int gc, int causal, float scale,
              cudaStream_t stream) {
  using C = Cfg<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bq = C::R / gc;
  dim3 grid(((s + bq - 1) / bq) * hkv * (hq / hkv / gc) * b);
  flash_tc_kernel<DH><<<grid, C::THREADS, C::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, s, t, hq, hkv, gc, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------
constexpr int KPT = 8;      // keys per thread in the score tile

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <int DH, int TR>
struct Tile {
  static constexpr int R = 32 * TR;       // query rows per CTA
  static constexpr int TD = DH / 8;       // output columns per thread
  static constexpr int EPV = 4;           // elements per 16-byte load
  static constexpr int QLD = R + 4;       // Qs[d][r]
  static constexpr int KLD = BK + 4;      // Ks[d][j]
  static constexpr int VLD = DH + 4;      // Vs[j][d]
  static constexpr int PLD = BK + 4;      // Ps[r][j]
  static constexpr int SMEM = (DH * QLD + DH * KLD + BK * VLD + R * PLD) * 4;
};

template <int DH, int TR>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const float* __restrict__ q,   // (B, S, Hq, DH)
                 const float* __restrict__ k,   // (B, Tk, Hkv, DH)
                 const float* __restrict__ v,   // (B, Tk, Hkv, DH)
                 float* __restrict__ o,         // (B, S, Hq, DH)
                 int S, int Tk, int Hq, int Hkv, int gc, int causal,
                 float scale) {
  using C = Tile<DH, TR>;
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
        pr[jj] = p;
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

  // ---- O / max(l, 1e-30) ----
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + i;
    const int pos = q0 + r % bq;
    if (pos >= S) continue;
    const int h = h0 + r / bq;
    float* orow = o + (((size_t)b * S + pos) * Hq + h) * DH + tx * TD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) orow[dd] = acc[i][dd] / den;
  }
}

template <int DH, int TR>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int s, int t, int hq, int hkv, int gc, int causal, float scale,
               cudaStream_t stream) {
  using C = Tile<DH, TR>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DH, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bq = C::R / gc;
  dim3 grid((s + bq - 1) / bq, hkv * (hq / hkv / gc), b);
  flash_f32_kernel<DH, TR><<<grid, THREADS, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, s, t, hq,
      hkv, gc, causal, scale);
  return (int)cudaGetLastError();
}

// bf16 to the tensor-core kernel, float32 to the FMA kernel; both tile a
// CTA as 256 rows (128 at dh = 128).
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int s, int t, int hq, int hkv, int dh, int gc, int causal,
              int bf16, float scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return bf16 ? tc::launch_tc<32>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st)
                  : launch_f32<32, 8>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st);
    case 64:
      return bf16 ? tc::launch_tc<64>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st)
                  : launch_f32<64, 8>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st);
    case 128:
      return bf16 ? tc::launch_tc<128>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st)
                  : launch_f32<128, 4>(q, k, v, o, b, s, t, hq, hkv, gc, causal, scale, st);
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
  return launch_dh(q, k, v, o, b, s, t, hq, hkv, dh, gc, causal, bf16, scale,
                   (cudaStream_t)stream);
}
