// LC-RWMD phase 2 folded into a streaming per-query top-k on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_stream.py,
// fused_lc_rwmd_topk_pallas (_fused_topk_kernel, _insert_candidates).  The
// TPU version holds all of Z in VMEM; Z (v_e x B, 18.7 MB at the slice's
// size) cannot fit 227 KB of shared memory, so phase 1 (lc_rwmd_phase1.cu)
// writes Z to HBM and this file does the rest:
//
//   fused_topk_partial: each CTA takes a contiguous range of doc rows and a
//     chunk of up to 64 queries, and walks its range in steps of 32 rows.
//     The launcher launches the query chunks in groups of at most 65,535
//     (the grid's y limit), so any number of queries is taken.
//     - Row pass: each warp computes 4 rows' D at once, lanes over the
//       queries (2 each), into a (32 rows x 64 queries) tile in shared
//       memory.  The rows' nonzero slots are staged in shared memory and
//       read back 4 per broadcast load; the 4 rows' next 4 slots issue
//       their Z gathers together, before their sums.  Each row's sum is
//       the ELL SpMM's (spmm_ell.cu): nonzero slots in order, fmaf, so the
//       values equal B2's D bit for bit.
//     - Filter: all 256 threads test the tile's entries against a
//       per-query threshold, the k-th key of the query's carry (above every
//       value while it is not full).  First the optional operands act on
//       the entry, as the reference's jnp fold applies them: d21 (n x B, the
//       symmetric bound's swapped direction) is maxed in (NaN-propagating,
//       as torch.maximum); a row with row_valid[row] == 0 (a tombstone) and
//       the pair (row q_gid[j], query j) (self-exclusion) are left out by
//       their flag, never ranked, so a real +inf distance and a masked
//       entry stay apart.  Values are ranked by an order-preserving 32-bit
//       unsigned key (sign-flipped float bits; -0 as +0; every NaN as one
//       key above +inf's; EMPTY, the unfilled slot, above that), ties by
//       doc id: ascending, +inf after every finite value and NaN after
//       +inf, torch.sort's order, which the plain fold uses.  Only
//       key < thr passes: a later row has a larger doc id, so an equal key
//       loses to the k-th entry.  The test is one float compare, val <
//       threshold_value(thr) (+inf for a threshold above every finite
//       value), exact unless val is +inf or NaN; the row pass votes on
//       whether its step holds such a value, and only such a step, or a
//       launch with operands, tests an entry that fails the compare against
//       a threshold of +inf by its key (out of line).
//       Survivors go into the query's buffer of (key, id) through a
//       shared atomicAdd on its count; the carries hold keys too, and the
//       partials are written back as values.
//     - Flush: when a buffer could overflow in the next step (count > CAP -
//       32), and at the end of the range, one warp per query sorts its
//       buffer and merges it with the sorted carry by a bitonic merge, all
//       in registers, keeping the k smallest (value, doc id) pairs; the
//       threshold drops to the new k-th value.  Between flushes the
//       threshold is stale: that lets extra candidates into the buffer,
//       which the flush drops.  No per-row walk by one warp per query.
//       Up to k = 128 the carry lives in shared memory and a flush merges
//       in registers.  Above that the carry lives in the CTA's own slice of
//       the partials in global memory (any k): the warp sorts the buffer
//       in registers, places each buffer entry at its index plus its rank
//       in the carry, and shifts the carry's entries up by their ranks in
//       the buffer, 32 at a time from the top, in place.
//     Rows >= n_real are dropped.  The CTA writes its (B, k) partial as
//     (value, id), an unfilled slot as (3.4e38, -1); the
//     wrapper asks each CTA for at most as many entries as it has rows, so
//     the partials hold about n_real entries a query however large k is.
//   topk_merge: merges pairs of sorted partial lists of k_in entries by
//     rank (a binary search of each element in the other list), in the
//     same (value, id) order, into lists of k_out <= 2 k_in entries,
//     halving the number of lists per launch.  Empty slots are (3.4e38, -1)
//     and rank after every real entry: two filled slots whose values are
//     not NaN compare as floats, any other pair by slot key (EMPTY where
//     the id is -1, else the value's key).
//
// No (n, B) tensor is written: the D rows live only in shared memory.
// Offsets into z are 32-bit while v * B < 2^31 and 64-bit above (WIDE:
// its per-gather multiply makes the slice's k = 32 call slower on an H100;
// chip_smoke.py times both), and the filter's operand tests are compiled
// only when an operand is given (EXTRA): the plain call runs the same
// instructions as without them.
//
// What bounds it: memory, as for the SpMM: the ids/weights read (~269 MB at
// n=700,000, h=48) with the Z gathers served from L2 (~4.9 GB of L2 reads
// at mean h 27.5 and B=64); the output is only B*k pairs.  The filter costs
// one shared-memory compare per (row, query); after the carries fill, about
// k*ln(rows/k) candidates per query and CTA reach a flush.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QC = 64;                 // queries per CTA (2 per lane)
constexpr int RPW = 4;                 // rows per warp per step
constexpr int STEP = WARPS * RPW;      // rows per step
constexpr int CAP = 64;                // buffered candidates per query
constexpr int KMAX_SMEM = 128;         // largest k carried in shared memory
constexpr int Y_MAX = 65535;           // query chunks per launch (grid y)
constexpr float BIG = 3.4e38f;            // the value of an unfilled output slot
constexpr unsigned EMPTY = 0xffffffffu;    // the key of an unfilled slot
constexpr unsigned NAN_KEY = 0xfffffffeu;  // every NaN's key: after +inf's
constexpr unsigned INF_KEY = 0xff800000u;  // the key of +inf
static_assert(CAP >= STEP && (CAP & (CAP - 1)) == 0, "CAP: a power of two >= STEP");

// Order-preserving key of a float: ascending keys are torch.sort's order
// (-inf ... +inf, then NaN); -0 and +0 are one key, every NaN is NAN_KEY.
__device__ __forceinline__ unsigned key_of(float v) {
  if (v != v) return NAN_KEY;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of a key (NaN's canonical bits for NAN_KEY, BIG for EMPTY).
__device__ __forceinline__ float value_of(unsigned key) {
  if (key == NAN_KEY) return __uint_as_float(0x7fc00000u);
  if (key == EMPTY) return BIG;
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The float a filter compares against for a threshold key: its value
// while that is finite; +inf above (a threshold of +inf, NaN or EMPTY),
// where the keys decide.
__device__ __forceinline__ float threshold_value(unsigned key) {
  return key < INF_KEY ? value_of(key) : __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool lex_less(unsigned v1, int i1, unsigned v2,
                                         int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

// key_of(val) < thr, out of line: the filter takes it only in a step with
// a value of +inf or NaN (or any step with operands), and only for an entry
// that failed the float compare against a threshold above every finite
// value; inlined, its predicated instructions cost every entry.
__device__ __noinline__ bool passes_above(float val, const unsigned* thr) {
  return key_of(val) < *thr;
}

// The key of an output slot: EMPTY where it is unfilled (id -1).
__device__ __forceinline__ unsigned slot_key(float v, int id) {
  return id < 0 ? EMPTY : key_of(v);
}

// (v1, i1) before (v2, i2) in slot order: by the floats where both slots
// are filled and neither value is NaN (-0 and +0 tie there, as their keys
// do), else by their slot keys.
__device__ __forceinline__ bool slot_less(float v1, int i1, float v2, int i2) {
  if (i1 >= 0 && i2 >= 0 && v1 == v1 && v2 == v2)
    return v1 < v2 || (v1 == v2 && i1 < i2);
  return lex_less(slot_key(v1, i1), i1, slot_key(v2, i2), i2);
}

// Number of entries of the sorted list (v, ix) that go before (x, xi):
// strictly before when strict, else before or equal.  Keys in v.
__device__ int rank_in(const unsigned* v, const int* ix, int k, unsigned x,
                       int xi, bool strict) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const bool before = strict ? lex_less(v[mid], ix[mid], x, xi)
                               : !lex_less(x, xi, v[mid], ix[mid]);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over an output list of (value, id) slots, for the slot (x, xi).
__device__ int rank_in(const float* v, const int* ix, int k, float x, int xi,
                       bool strict) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const bool before = strict ? slot_less(v[mid], ix[mid], x, xi)
                               : !slot_less(x, xi, v[mid], ix[mid]);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Bitonic compare-exchange of a warp's 64 register-held entries (v[s],
// i[s] is entry lane + 32 s) at one (size, stride) of the network.
__device__ __forceinline__ void bitonic_step(unsigned (&v)[2], int (&ix)[2],
                                             int size, int stride, int lane) {
  if (stride == 32) {  // the partner is this lane's other entry
    const bool up = (lane & size) == 0;  // size == 64: ascending
    if (lex_less(v[1], ix[1], v[0], ix[0]) == up) {
      const unsigned tv = v[0]; v[0] = v[1]; v[1] = tv;
      const int ti = ix[0]; ix[0] = ix[1]; ix[1] = ti;
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    const unsigned pv = __shfl_xor_sync(0xffffffffu, v[s], stride);
    const int pi = __shfl_xor_sync(0xffffffffu, ix[s], stride);
    const bool keep_min = ((e & size) == 0) == ((e & stride) == 0);
    const bool take = keep_min ? lex_less(pv, pi, v[s], ix[s])
                               : lex_less(v[s], ix[s], pv, pi);
    if (take) { v[s] = pv; ix[s] = pi; }
  }
}

// One step of a bitonic merge over a warp's N = 32 * S register-held
// entries (entry lane + 32 s in v[s], ix[s]), ascending: of each pair
// (e, e ^ stride) the lower keeps the smaller.
template <int S>
__device__ __forceinline__ void merge_step(unsigned (&v)[S], int (&ix)[S],
                                           int stride, int lane) {
  if (stride >= 32) {  // partners in this lane's registers
    const int d = stride / 32;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s & d) continue;
      if (lex_less(v[s + d], ix[s + d], v[s], ix[s])) {
        const unsigned tv = v[s]; v[s] = v[s + d]; v[s + d] = tv;
        const int ti = ix[s]; ix[s] = ix[s + d]; ix[s + d] = ti;
      }
    }
    return;
  }
  const bool lower = (lane & stride) == 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned pv = __shfl_xor_sync(0xffffffffu, v[s], stride);
    const int pi = __shfl_xor_sync(0xffffffffu, ix[s], stride);
    if (lower ? lex_less(pv, pi, v[s], ix[s]) : lex_less(v[s], ix[s], pv, pi)) {
      v[s] = pv;
      ix[s] = pi;
    }
  }
}

// One warp: merge the query's buffer (bv, bi; nb <= CAP entries, unsorted)
// into its sorted carry (cv, ci; k <= 16 S entries), keeping the k
// smallest; returns the new k-th key.  All in registers: the buffer is
// sorted (bitonic, 2 entries a lane), reversed behind the carry so the two
// form one bitonic sequence of N = 32 S entries, and merged in log2(N)
// steps.  Keys throughout; pads are (EMPTY, INT_MAX): they sort after the
// carry's empty slots (EMPTY, -1).  Ids are distinct between the two (each
// row is tested once per query).
template <int S>
__device__ unsigned flush_query(unsigned* cv, int* ci, const unsigned* bv,
                                const int* bi, int nb, int k, int lane) {
  static_assert(CAP == 64 && 16 * S >= CAP, "the buffer fills the second half");
  unsigned b[2];
  int bx[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    b[s] = e < nb ? bv[e] : EMPTY;
    bx[s] = e < nb ? bi[e] : INT_MAX;
  }
  int p = 2;
  while (p < nb) p <<= 1;
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size / 2; stride > 0; stride >>= 1)
      bitonic_step(b, bx, size, stride, lane);
  unsigned v[S];
  int ix[S];
#pragma unroll
  for (int s = 0; s < S / 2; ++s) {  // the carry, ascending
    const int j = lane + 32 * s;
    v[s] = j < k ? cv[j] : EMPTY;
    ix[s] = j < k ? ci[j] : INT_MAX;
  }
#pragma unroll
  for (int s = S / 2; s < S - 2; ++s) { v[s] = EMPTY; ix[s] = INT_MAX; }
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // the buffer, reversed: entry 63 - e
    v[S - 1 - s] = __shfl_sync(0xffffffffu, b[s], 31 - lane);
    ix[S - 1 - s] = __shfl_sync(0xffffffffu, bx[s], 31 - lane);
  }
#pragma unroll
  for (int stride = 16 * S; stride > 0; stride >>= 1)  // unrolled: static indices
    merge_step<S>(v, ix, stride, lane);
#pragma unroll
  for (int s = 0; s < S / 2; ++s) {
    const int j = lane + 32 * s;
    if (j < k) { cv[j] = v[s]; ci[j] = ix[s]; }
  }
  unsigned kth = EMPTY;
#pragma unroll
  for (int s = 0; s < S / 2; ++s)
    if ((k - 1) / 32 == s) kth = __shfl_sync(0xffffffffu, v[s], (k - 1) % 32);
  return kth;
}

// One warp: merge the query's buffer into a sorted carry of any length k
// held in global memory.  The buffer is sorted in registers and written
// back sorted; each buffer entry goes to its index plus the number of
// carry entries before it, and each carry entry moves up by the number of
// buffer entries before it.  The carry is shifted in place, 32 entries at
// a time from the top: an entry only moves up, and every lane of a chunk
// reads before any writes.  Ids are distinct between the two.
__device__ unsigned flush_global(unsigned* cv, int* ci, unsigned* bv, int* bi,
                                int nb, int k, int lane) {
  unsigned b[2];
  int bx[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    b[s] = e < nb ? bv[e] : EMPTY;
    bx[s] = e < nb ? bi[e] : INT_MAX;
  }
  int p = 2;
  while (p < nb) p <<= 1;
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size / 2; stride > 0; stride >>= 1)
      bitonic_step(b, bx, size, stride, lane);
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    if (e < nb) { bv[e] = b[s]; bi[e] = bx[s]; }
  }
  __syncwarp();
  int pos[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    pos[s] = e < nb ? e + rank_in(cv, ci, k, b[s], bx[s], true) : k;
  }
  for (int c0 = (k - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
    const int j = c0 + lane;
    unsigned v = EMPTY;
    int x = -1, to = k;
    if (j < k) {
      v = cv[j];
      x = ci[j];
      to = j + rank_in(bv, bi, nb, v, x, true);
    }
    __syncwarp();
    if (to < k) { cv[to] = v; ci[to] = x; }
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (pos[s] < k) { cv[pos[s]] = b[s]; ci[pos[s]] = bx[s]; }
  __syncwarp();
  return cv[k - 1];
}

// A flush at the smallest register width that holds the carry, or into
// the global carry.
template <bool GLOBAL>
__device__ __forceinline__ unsigned flush(unsigned* cv, int* ci, unsigned* bv,
                                          int* bi, int nb, int k, int lane) {
  if (GLOBAL) return flush_global(cv, ci, bv, bi, nb, k, lane);
  return k <= 64 ? flush_query<4>(cv, ci, bv, bi, nb, k, lane)
                 : flush_query<8>(cv, ci, bv, bi, nb, k, lane);
}

// One step's filter: every (row, query) entry of the D tile ``dt`` against
// its query's threshold.  key_of(val) < thr[c] is tested as val < thrf[c],
// exact but for a value of +inf or NaN against a threshold above every
// finite value (+inf, NaN, an open carry), which KEYS decides by the keys.
// EXTRA: d21 is maxed in first (NaN-propagating, as torch.maximum), and
// masked entries are left out.  Survivors go into their query's buffer.
template <bool EXTRA, bool KEYS>
__device__ __forceinline__ void filter_step(
    int tid, int tile, int r1, int nq, int q0, int b, const float* dt,
    const float* __restrict__ d21, const unsigned char* __restrict__ row_valid,
    const int* __restrict__ q_gid, const unsigned* thr, const float* thrf,
    int* cnt, unsigned* bv, int* bi, int* flag) {
  const float inf = __int_as_float(0x7f800000);
  for (int e = tid; e < STEP * QC; e += THREADS) {
    const int r = e / QC, c = e % QC;
    const int gid = tile + r;
    float val = dt[e];
    if (EXTRA && c < nq && gid < r1) {
      if (d21 != nullptr) {
        const float dv = d21[(size_t)gid * b + q0 + c];
        val = (val >= dv || val != val) ? val : dv;
      }
      if ((row_valid != nullptr && row_valid[gid] == 0) ||
          (q_gid != nullptr && q_gid[q0 + c] == gid))
        continue;
    }
    if (c >= nq || gid >= r1) continue;
    const float tf = thrf[c];
    if (val < tf || (KEYS && tf == inf && passes_above(val, thr + c))) {
      const int pos = atomicAdd(&cnt[c], 1);
      bv[c * CAP + pos] = key_of(val);
      bi[c * CAP + pos] = gid;
      if (pos >= CAP - STEP) *flag = 1;
    }
  }
}

// GLOBAL: the carry is the CTA's slice of the partials (any k); else it is
// in shared memory (k <= 128).  EXTRA: row_valid, q_gid and d21 are read
// (each may still be null).  WIDE: Z row offsets in 64 bits.
template <bool GLOBAL, bool EXTRA, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
fused_topk_partial_kernel(const int* __restrict__ ids,   // (n, h)
                          const float* __restrict__ w,   // (n, h)
                          const float* __restrict__ z,   // (v, B)
                          const unsigned char* __restrict__ row_valid,  // (n,)
                          const int* __restrict__ q_gid, // (B,)
                          const float* __restrict__ d21, // (n, B)
                          float* __restrict__ part_vals, // (n_ctas, B, k)
                          int* __restrict__ part_idx,    // (n_ctas, B, k)
                          int n, int n_real, int h, int b, int k,
                          int rows_per_cta, int chunk0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = (chunk0 + blockIdx.y) * QC;
  const int nq = min(QC, b - q0);
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(min(n, n_real), r0 + rows_per_cta);
  const size_t part0 = ((size_t)blockIdx.x * b + q0) * k;  // this CTA's partials

  // The carry and the buffers hold keys (key_of); the GLOBAL carry holds
  // them in the partials' value slots until the CTA's last flush.
  const int kc = GLOBAL ? 0 : k;                       // carry entries in smem
  unsigned* cv = GLOBAL ? reinterpret_cast<unsigned*>(part_vals + part0)
                        : reinterpret_cast<unsigned*>(smem);  // [QC][k]
  int* ci = GLOBAL ? part_idx + part0 : reinterpret_cast<int*>(smem) + QC * k;
  unsigned* bv = reinterpret_cast<unsigned*>(smem) + 2 * QC * kc;  // [QC][CAP]
  int* bi = reinterpret_cast<int*>(bv + QC * CAP);     // [QC][CAP]
  float* dt = reinterpret_cast<float*>(bi + QC * CAP); // [STEP][QC] D tile
  unsigned* thr = reinterpret_cast<unsigned*>(dt + STEP * QC);  // [QC]
  float* thrf = reinterpret_cast<float*>(thr + QC);    // [QC] threshold_value
  int* cnt = reinterpret_cast<int*>(thrf + QC);        // [QC]
  int* flag = cnt + QC;                                // a buffer is near full
  int* above = flag + 1;  // [2], by step parity: the step holds a +inf or NaN

  for (int i = tid; i < (GLOBAL ? nq : QC) * k; i += THREADS) {
    cv[i] = EMPTY;
    ci[i] = -1;
  }
  if (tid < QC) {
    thr[tid] = EMPTY;
    thrf[tid] = threshold_value(EMPTY);
    cnt[tid] = 0;
  }
  if (tid == 0) { *flag = 0; above[0] = 0; above[1] = 0; }
  __syncthreads();

  const int c0 = q0 + lane, c1 = q0 + lane + 32;
  for (int tile = r0; tile < r1; tile += STEP) {
    // --- row pass: 4 rows per warp, lanes over the query columns ---
    // The warp stages 32 slots of its 4 rows at a time in its own quarter
    // KB of the D tile: each row's nonzero slots, in slot order (the SpMM
    // skips the others), as Z row offsets (ids when WIDE) and weights.  It reads them back
    // 4 slots per broadcast load, and each batch of 4 slots issues its 32 Z
    // gathers before their sums.  Past a row's last nonzero slot the
    // entries read Z row 0 with weight 0 and add nothing.
    int* so = reinterpret_cast<int*>(dt + warp * RPW * QC);  // [RPW][32]
    float* sw = dt + warp * RPW * QC + RPW * 32;              // [RPW][32]
    float a0[RPW], a1[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) { a0[j] = 0.f; a1[j] = 0.f; }
    for (int p0 = 0; p0 < h; p0 += 32) {
      const int p = p0 + lane;
      int np = 0;  // the most nonzero slots of the 4 rows in this chunk
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int row = min(tile + warp * RPW + j, r1 - 1);  // past r1: dropped below
        const float wv = p < h ? w[(size_t)row * h + p] : 0.f;
        const int id = p < h ? ids[(size_t)row * h + p] : 0;
        // the nonzero slots first, in slot order; zeros after them
        const unsigned nz = __ballot_sync(0xffffffffu, wv != 0.f);
        const int n_nz = __popc(nz);
        if (wv != 0.f) {
          const int at = __popc(nz & ((1u << lane) - 1u));
          so[j * 32 + at] = WIDE ? id : id * b;
          sw[j * 32 + at] = wv;
        }
        if (lane >= n_nz) { so[j * 32 + lane] = 0; sw[j * 32 + lane] = 0.f; }
        np = max(np, n_nz);
      }
      __syncwarp();
      for (int g0 = 0; g0 < np; g0 += 4) {
        float x0[RPW][4], x1[RPW][4];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int4 off = *reinterpret_cast<const int4*>(&so[j * 32 + g0]);
          const int o[4] = {off.x, off.y, off.z, off.w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float* zr = WIDE ? z + (size_t)o[g] * b : z + o[g];
            x0[j][g] = c0 < b ? __ldg(zr + c0) : 0.f;
            x1[j][g] = c1 < b ? __ldg(zr + c1) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float4 wq = *reinterpret_cast<const float4*>(&sw[j * 32 + g0]);
          const float wg[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (wg[g] != 0.f) {  // past the row's nonzero slots
              a0[j] = fmaf(wg[g], x0[j][g], a0[j]);
              a1[j] = fmaf(wg[g], x1[j][g], a1[j]);
            }
          }
        }
      }
      __syncwarp();  // the staging is rewritten by the next chunk
    }
    bool big = false;  // a value of +inf or NaN: the filter needs keys
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      dt[(warp * RPW + j) * QC + lane] = a0[j];
      dt[(warp * RPW + j) * QC + lane + 32] = a1[j];
      if (!EXTRA) big |= !(a0[j] <= FLT_MAX) || !(a1[j] <= FLT_MAX);
    }
    const int parity = (tile - r0) / STEP & 1;
    if (!EXTRA && __any_sync(0xffffffffu, big) && lane == 0) above[parity] = 1;
    __syncthreads();

    // --- filter: every (row, query) entry against its query's threshold ---
    // Keys only where a value may be +inf or NaN: a step the row pass
    // flagged, or any step of a launch with operands.
    if (EXTRA || above[parity])
      filter_step<EXTRA, true>(tid, tile, r1, nq, q0, b, dt, d21, row_valid,
                               q_gid, thr, thrf, cnt, bv, bi, flag);
    else
      filter_step<EXTRA, false>(tid, tile, r1, nq, q0, b, dt, d21, row_valid,
                                q_gid, thr, thrf, cnt, bv, bi, flag);
    __syncthreads();
    if (!EXTRA && tid == 0) above[parity] = 0;  // every thread read it above

    // --- flush when a buffer could overflow in the next step ---
    if (*flag) {
      for (int c = warp; c < nq; c += WARPS) {
        const int nb = cnt[c];
        if (nb == 0) continue;
        const unsigned kth = flush<GLOBAL>(cv + c * k, ci + c * k, bv + c * CAP,
                                        bi + c * CAP, nb, k, lane);
        if (lane == 0) {
          thr[c] = kth;
          thrf[c] = threshold_value(kth);
          cnt[c] = 0;
        }
      }
      __syncthreads();  // every thread read the flag before this barrier
      if (tid == 0) *flag = 0;
    }
  }

  for (int c = warp; c < nq; c += WARPS) {
    const int nb = cnt[c];
    if (nb > 0)
      flush<GLOBAL>(cv + c * k, ci + c * k, bv + c * CAP, bi + c * CAP, nb, k,
                    lane);
    if (GLOBAL) {  // the carry is the partial: its keys become values
      __syncwarp();
      float* out = part_vals + part0 + (size_t)c * k;
      for (int j = lane; j < k; j += 32) out[j] = value_of(cv[(size_t)c * k + j]);
    }
  }
  if (GLOBAL) return;
  __syncthreads();

  for (int i = tid; i < nq * k; i += THREADS) {
    part_vals[part0 + i] = value_of(cv[i]);
    part_idx[part0 + i] = ci[i];
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ in_vals,  // (n_in, B, k_in)
                                  const int* __restrict__ in_idx,
                                  float* __restrict__ out_vals,       // (n_out, B, k_out)
                                  int* __restrict__ out_idx,
                                  int n_in, int b, int k_in, int k_out) {
  const int pair = blockIdx.x / b, q = blockIdx.x % b;
  const int la = 2 * pair, lb = 2 * pair + 1;
  const float* av = in_vals + ((size_t)la * b + q) * k_in;
  const int* ai = in_idx + ((size_t)la * b + q) * k_in;
  float* ov = out_vals + ((size_t)pair * b + q) * k_out;
  int* oi = out_idx + ((size_t)pair * b + q) * k_out;
  if (lb >= n_in) {  // no partner: the list, padded with empty slots
    for (int j = threadIdx.x; j < k_out; j += blockDim.x) {
      ov[j] = j < k_in ? av[j] : BIG;
      oi[j] = j < k_in ? ai[j] : -1;
    }
    return;
  }
  const float* bv = in_vals + ((size_t)lb * b + q) * k_in;
  const int* bi = in_idx + ((size_t)lb * b + q) * k_in;
  for (int j = threadIdx.x; j < k_in; j += blockDim.x) {
    const int pa = j + rank_in(bv, bi, k_in, av[j], ai[j], true);
    if (pa < k_out) { ov[pa] = av[j]; oi[pa] = ai[j]; }
    const int pb = j + rank_in(av, ai, k_in, bv[j], bi[j], false);
    if (pb < k_out) { ov[pb] = bv[j]; oi[pb] = bi[j]; }
  }
}

template <bool GLOBAL, bool EXTRA, bool WIDE>
int launch_partial(dim3 grid, size_t smem, cudaStream_t stream, const int* ids,
                   const float* w, const float* z,
                   const unsigned char* row_valid, const int* q_gid,
                   const float* d21, float* part_vals, int* part_idx, int n,
                   int n_real, int h, int b, int k, int rows_per_cta,
                   int chunk0) {
  auto kern = fused_topk_partial_kernel<GLOBAL, EXTRA, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(ids, w, z, row_valid, q_gid, d21,
                                        part_vals, part_idx, n, n_real, h, b,
                                        k, rows_per_cta, chunk0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_fused_topk_partial(const void* ids, const void* w,
                                         const void* z, const void* row_valid,
                                         const void* q_gid, const void* d21,
                                         void* part_vals, void* part_idx,
                                         int n, int n_real, int h, int v, int b,
                                         int k, int rows_per_cta, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  // One CTA per range of the rows that count: the caller allocates the
  // partials for exactly these.
  const int n_ctas = (min(n, n_real) + rows_per_cta - 1) / rows_per_cta;
  if (n_ctas <= 0 || b <= 0) return (int)cudaGetLastError();
  const bool global = k > KMAX_SMEM;
  const bool extra = row_valid != nullptr || q_gid != nullptr || d21 != nullptr;
  const bool wide = (long long)v * b >= 0x7fffffffLL;
  const size_t smem = (global ? 0 : (size_t)QC * k * (sizeof(float) + sizeof(int)))
                      + (size_t)QC * CAP * (sizeof(float) + sizeof(int))
                      + (size_t)STEP * QC * sizeof(float)
                      + (size_t)QC * (2 * sizeof(float) + sizeof(int))
                      + 3 * sizeof(int);
  auto launch = global ? (extra ? (wide ? launch_partial<true, true, true>
                                        : launch_partial<true, true, false>)
                                : (wide ? launch_partial<true, false, true>
                                        : launch_partial<true, false, false>))
                       : (extra ? (wide ? launch_partial<false, true, true>
                                        : launch_partial<false, true, false>)
                                : (wide ? launch_partial<false, false, true>
                                        : launch_partial<false, false, false>));
  const int chunks = (b + QC - 1) / QC;
  for (int c0 = 0; c0 < chunks; c0 += Y_MAX) {
    const int code = launch(
        dim3(n_ctas, min(Y_MAX, chunks - c0)), smem, (cudaStream_t)stream,
        (const int*)ids, (const float*)w, (const float*)z,
        (const unsigned char*)row_valid, (const int*)q_gid, (const float*)d21,
        (float*)part_vals, (int*)part_idx, n, n_real, h, b, k, rows_per_cta,
        c0);
    if (code != 0) return code;
  }
  return (int)cudaSuccess;
}

extern "C" int launch_topk_merge(const void* in_vals, const void* in_idx,
                                 void* out_vals, void* out_idx, int n_in, int b,
                                 int k_in, int k_out, void* stream) {
  if (n_in <= 0 || b <= 0) return (int)cudaGetLastError();
  if (k_in < 1 || k_out < k_in || k_out > 2 * k_in) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((n_in + 1) / 2) * b;  // one per (pair, query)
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  topk_merge_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)in_vals, (const int*)in_idx, (float*)out_vals,
      (int*)out_idx, n_in, b, k_in, k_out);
  return (int)cudaGetLastError();
}
