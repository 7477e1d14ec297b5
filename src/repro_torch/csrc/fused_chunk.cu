// Fused LC-RWMD vocab chunk on Hopper: one chunk of the vocabulary's Z is
// made on chip and consumed at once into the running distances,
//   Z[w, j] = sqrt(min over the valid words q of query j of
//                  max(|E[w]|^2 + |T[j,q]|^2 - 2 E[w].T[j,q], 0))   (w in the chunk)
//   D[i, j] += sum over the slots p with lo <= ids[i, p] < lo + cv of
//              w[i, p] * Z[ids[i, p] - lo, j]     (lo: the chunk's first id),
// reading the resident ids and weights as they are.  That is the sum of the
// reference's chunk-relative, clipped ids and out-of-chunk zeroed weights,
// less the (n, h1) passes that make them.  Invalid query words count as
// 3.4e38, as on the TPU.
//
// Replaces the TPU kernel src/repro/kernels/fused_stream.py,
// fused_lc_rwmd_chunk_pallas (_fused_kernel).  That kernel made the chunk's
// Z in VMEM during its first doc tile (program_id(0) == 0) and let every
// later doc tile re-read it, which relies on the TPU's sequential grid.
// Hopper CTAs run in no order, so here a thread-block cluster of 8 CTAs
// shares the chunk's Z through distributed shared memory:
//
//   1. CTA r of the cluster makes rows [r * rpc, (r+1) * rpc) of the
//      chunk's Z (rpc = ceil(cv / 8) <= 128): its embedding rows stay in
//      shared memory and tiles::gram_min_cols runs them against all B * h
//      query words, folding the per-(row, query) minimum.
//   2. cluster.sync(); each warp then takes doc rows (grid-stride over the
//      whole launch) and adds their in-chunk slots, reading the Z rows from
//      whichever CTA of the cluster holds them (tiles::ell_row_accumulate).
//      A row with no slot in the chunk is left as it is; the others add
//      their partial into D in place (the same sum as returning it).
//   3. cluster.sync() again, so no CTA leaves while a peer reads its Z.
//
// Every cluster makes the chunk's whole Z, so the launch repeats phase 1's
// work once per cluster (16 clusters on 132 SMs): the price of sharing Z
// without a pass through device memory.  What bounds it: at the slice's
// shapes (vc = 512, B = 64, h = 48, m = 300, n = 700,000) the bytes, one
// read of the resident ids and weights (269 MB) and D read and written (358 MB)
// per chunk; phase 1 of one chunk is 0.94 GFLOP, x16 clusters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CS = 8;   // CTAs per cluster
constexpr int WARPS = tiles::GRAM_THREADS / 32;
constexpr int COLS = 64;  // query columns per consume pass (2 per lane)
constexpr int PEERS_BYTES = 64;  // CS pointers, keeps what follows 16-byte aligned

struct Offset {
  int base;
  __device__ int operator()(int r) const { return base + r; }
};

struct PeerRow {
  float* const* peers;  // the cluster's Z slices, by rank
  int rpc, b, c0, lo;
  __device__ const float* operator()(int id) const {
    const int r = id - lo;
    return peers[r / rpc] + (size_t)(r % rpc) * b + c0;
  }
};

template <int NRT>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(tiles::GRAM_THREADS)
fused_chunk_kernel(const float* __restrict__ emb,     // (cv, m) chunk rows
                   const float* __restrict__ t,       // (B, h, m)
                   const float* __restrict__ valid,   // (B, h) 0/1
                   const int* __restrict__ ids,       // (n, h1) vocab ids
                   const float* __restrict__ w,       // (n, h1)
                   float* __restrict__ d,             // (n, B), accumulated in place
                   int cv, int lo_chunk, int m, int b, int h, int n, int h1,
                   int rpc, int bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ldd = NRT * tiles::TR + 4;
  const int lo = rank * rpc;
  const int R = max(0, min(rpc, cv - lo));
  float** peers = reinterpret_cast<float**>(smem);    // [CS]: the cluster's Z slices
  float* ds = reinterpret_cast<float*>(smem + PEERS_BYTES);  // [m][ldd]
  float* a2s = ds + (size_t)m * ldd;                  // [ldd]
  float* qs = a2s + ldd;                              // [KC][QS_LD]
  float* b2s = qs + tiles::KC * tiles::QS_LD;         // [TC]
  float* vs = b2s + tiles::TC;                        // [TC]
  float* zs = vs + tiles::TC;                         // [rpc][B]: this CTA's Z rows
  unsigned* zbits = reinterpret_cast<unsigned*>(zs);

  // --- 1. this CTA's rows of the chunk's Z ---
  tiles::load_rows_transposed(emb, Offset{lo}, R, m, bf16, ds, ldd, a2s);
  for (int e = threadIdx.x; e < rpc * b; e += blockDim.x) zbits[e] = tiles::big_bits();
  __syncthreads();
  if (R > 0)  // CTA-uniform
    tiles::gram_min_cols<NRT, false>(
        ds, ldd, a2s, R, m, t, nullptr, valid, 0, b * h, h, bf16, qs, b2s, vs,
        zbits, b, 0, nullptr, nullptr, 0, 1, 0);
  for (int e = threadIdx.x; e < rpc * b; e += blockDim.x)
    zs[e] = sqrtf(fmaxf(__uint_as_float(zbits[e]), 0.f));
  if (threadIdx.x < CS) peers[threadIdx.x] = cluster.map_shared_rank(zs, (int)threadIdx.x);
  cluster.sync();

  // --- 2. consume: every doc row's in-chunk slots ---
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + threadIdx.x / 32; row < n; row += stride) {
    for (int c0 = 0; c0 < b; c0 += COLS) {
      const int nc = min(COLS, b - c0);
      float acc[2] = {0.f, 0.f};
      const bool any = tiles::ell_row_accumulate<2>(
          ids + (size_t)row * h1, w + (size_t)row * h1, h1, lo_chunk, cv,
          PeerRow{peers, rpc, b, c0, lo_chunk}, nc, lane, acc);
      if (any) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          if (col < nc) d[(size_t)row * b + c0 + col] += acc[c];
        }
      }
    }
  }

  // --- 3. keep this CTA's Z alive until every peer is done with it ---
  cluster.sync();
}

size_t smem_bytes(int cv, int m, int b) {
  const int rpc = (cv + CS - 1) / CS;
  const int nrt = (rpc + tiles::TR - 1) / tiles::TR;
  const size_t ldd = nrt * tiles::TR + 4;
  return 4 * (m * ldd + ldd + tiles::KC * tiles::QS_LD + 2 * tiles::TC
              + (size_t)rpc * b) + PEERS_BYTES;
}

template <int NRT>
int launch(const void* emb, const void* t, const void* valid, const void* ids,
           const void* w, void* d, int cv, int lo, int m, int b, int h, int n,
           int h1, int n_clusters, int bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(cv, m, b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_chunk_kernel<NRT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_chunk_kernel<NRT><<<n_clusters * CS, tiles::GRAM_THREADS, smem, stream>>>(
      (const float*)emb, (const float*)t, (const float*)valid, (const int*)ids,
      (const float*)w, (float*)d, cv, lo, m, b, h, n, h1, (cv + CS - 1) / CS,
      bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_fused_chunk(const void* emb, const void* t,
                                  const void* valid, const void* ids,
                                  const void* w, void* d, int cv, int lo,
                                  int m, int b, int h, int n, int h1,
                                  int n_clusters, int bf16, void* stream) {
  if (cv <= 0 || b <= 0 || n <= 0) return (int)cudaGetLastError();
  const int rpc = (cv + CS - 1) / CS;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((rpc + tiles::TR - 1) / tiles::TR) {
    case 1: return launch<1>(emb, t, valid, ids, w, d, cv, lo, m, b, h, n, h1, n_clusters, bf16, s);
    case 2: return launch<2>(emb, t, valid, ids, w, d, cv, lo, m, b, h, n, h1, n_clusters, bf16, s);
    case 3: return launch<3>(emb, t, valid, ids, w, d, cv, lo, m, b, h, n, h1, n_clusters, bf16, s);
    case 4: return launch<4>(emb, t, valid, ids, w, d, cv, lo, m, b, h, n, h1, n_clusters, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
