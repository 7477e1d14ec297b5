"""Drive the PyTorch/CUDA port on one GPU and check it: the query cascade,
the paper's comparison path (streaming LC-RWMD, the SpMM formulations, the
quadratic RWMD and the WMD baselines), flash attention and the GNN
gather-scale-scatter, llama3.2-1b prefill and decode (fp and int8 cache),
grok-1 and deepseek-v2 (MoE, MLA) at full width, and NequIP's energies and
forces at full width on its four cells.

    python3 chip_smoke.py              # Table IV set 2 at scale 0.25: 700,000 docs
    python3 chip_smoke.py --scale 0.01 # a quick rehearsal at 28,000 docs
                                       # (and shorter sequences and graphs)

Phases, each of which exits non-zero on failure:

1. build: the CUDA kernels of ``src/repro_torch/csrc`` are compiled for
   sm_90a (one nvcc per source, in parallel); the build time is printed.
2. small: a small corpus through the engine on the card and on the CPU
   (plain versions): one-sided, dense symmetric, both streaming top-ks,
   the rerank and the pruned cascade must agree.
3. kernels: on the slice's corpus, each kernel at the shapes the main path
   gives it against its plain PyTorch version on the card, with the stated
   tolerance; its time beside the plain version's, the library yardstick's
   where one PyTorch call computes the same function, and its bound on an
   H100 SXM.  Phase 1 also reports its TFLOP/s over the valid query words;
   the ELL SpMM its nonzero slots, the Z bytes they gather and the rate,
   the share of those slots that the 600 most frequent ids hold, and its
   time at the vocabulary-chunk shape of ``lc_rwmd_streaming(fuse="scan")``
   (chunk-relative ids, Z of (512, 64)) on chunk 0 and a mid chunk;
   the fused top-k its GB/s, the merge launches' share of its device time
   (``torch.profiler``), and must return values equal bit for bit to the
   SpMM's D at the ids it returns; its partial launch through the 32-bit
   and the 64-bit Z-offset variants, bit-equal and timed side by side;
   then the fused top-k at k = 256 (its
   carry in global memory) and with both masks (tombstones, each query's
   own id excluded), and the quadratic RWMD kernel's d21 mode (the
   symmetric fold's swapped direction) on the whole corpus, held against
   its plain version on every doc, with its TFLOP/s over the valid words;
   then the fused top-k with that d21 maxed in, as the symmetric route
   calls it, at k = 32 and at ``pruned_wmd_topk``'s budget of 20; the
   fused top-k against its plain version where D is non-finite (NaN and
   +inf Z rows, NaN and +inf d21 entries, with and without the masks, k
   covering every doc on both carries, and the 64-bit-offset variant):
   ids and values equal in every slot; then
   the Sinkhorn-WMD kernel on the rerank's 2,048 pairs, also at
   ``max_iters = 0`` (its cost tile and final plan alone) beside the full
   run, with its mean iterations and their agreement with the plain
   version's.
4. slice: the synthetic corpus at the paper's Table IV set 2 statistics
   (h_max 48, mean h 27.5, m 300) resident in one engine; a batch of 64
   resident docs goes through the README quickstart (one-sided streaming
   top-32, Sinkhorn rerank to top-5, every query's top-1 is itself),
   ``one_sided`` and ``pruned_wmd_topk`` (whose symmetric bound runs phase
   1, the d21 mode and the fused top-k).  The kernel launch counts are
   reset just before and read just after; each kernel must have run.
   Then per-call times after warm-up (``symmetric_topk_streaming`` k=20
   too), the peak device memory, a ``torch.profiler`` breakdown of
   ``topk_streaming``, the quickstart, ``one_sided`` and
   ``pruned_wmd_topk`` (which must show no host-to-device copy), the
   device time of one
   ``symmetric_topk_streaming`` call split into B1 / d21 / B3 / other (it
   fails if a cuBLAS GEMM ran there), and a whole trace of ``one_sided``.
5. comparison: the paper's comparison path on the same corpus, with the
   counts reset just before and read just after: phase 2 by each SpMM
   formulation (blocked, dense, naive) on the engine's Z, the vocab-streamed
   one-sided LC-RWMD (``fuse="kernel"`` and ``"scan"``, vocab chunk 512), the
   quadratic RWMD over all docs, and the WMD baselines on the cascade's
   2,048 (candidate, query) pairs.  Then each new kernel against its plain
   version (the fused vocab chunk on chunk 0 and on a mid-vocabulary
   chunk, each timed whole and with Z alone, a launch over one doc row),
   the streaming results against ``one_sided``, the quadratic RWMD
   against ``core/rwmd.py`` on the first 65,536 docs and against its plain
   version at 160 words a doc (Table IV set 1's h_max), the batched Sinkhorn
   and ``wmd_one_vs_many`` against the Sinkhorn-WMD kernel (at settings
   where they converge), and the kernel's gap to the exact EMD on 16 pairs;
   the ELL SpMM's launches and device time inside one ``"scan"`` call
   (``torch.profiler``); the seed SpMM (B6b) beside the blocked one (B2),
   alternated and bit-equal, at the main shape, the ``"scan"`` chunk shape,
   Table IV set 1's h_max (160) and B = 256;
   one line compares the quadratic RWMD's time with LC-RWMD's.  The
   engine of phases 3-5 is freed before the next phases.
6. segments and the serve step: the same corpus, held on the card, as a
   ``SegmentedEngine`` of a 688,000-doc base and three 4,000-doc deltas
   (the last ends with an exact copy of doc 5), with
   7,000 seeded deletions and the queries 60-63 deleted; with the counts
   reset just before and read just after, ``topk_streaming`` k=32,
   ``symmetric_topk_streaming`` k=20, ``rerank_topk`` k=5, ``one_sided``
   and ``build_serve_step`` (refine, rerank at a budget of 32) at tiers
   0-2 and with ``self_exclude``: B1, B2, B3, B4 and the d21 mode must
   each have run.  Checks: every live query first at tier 0, the copy of
   doc 5 right after it, no dead doc, filler or id past the corpus in a
   result, no self-match under ``self_exclude``, tier 1 the first k of
   ``topk_streaming``, the ids of a monolithic ``LCRWMDEngine`` over the
   live docs (distances within 1e-5 (1 + |d|), the bit-equal share
   printed), the same answers after ``compact``, no host-to-device copy
   in a serve call at an unchanged version.  Per-call times, an append, a
   delete with the first serve after it, ``compact``, the segments' bytes
   and the phase's peak memory are printed.  (The small phase holds the
   segmented engine and the serve step, the engine-less and
   ``streaming=False`` steps and ``build_allpairs_d1`` against the CPU.)
   Before ``compact``, a cluster index over that engine: 64 cells
   (kcenters, seed 0), ``routed_topk`` k=20 at top_p 1 and 4 (triangle
   bound at slack 1.0) and at all 64 cells without the bound,
   ``pruned_wmd_topk(index=, top_p=4)`` beside the flat one, and the
   routed serve step at tiers 0-2 and self-excluding, with the counts
   reset at the start: B1, B2, B3, B4 and the d21 mode must each have
   run.  Checks: exhaustive routing equals ``engine.topk`` and the flat
   serve step bit for bit, no dead doc or id past the corpus (and no
   filler while the routed cells hold live docs) in any result, no
   self-match, every top_p = 4 id in a cell its query was routed to.
   Printed: the rebuild by part, per-call times, launches by call, device
   time by kernel, the cells' rows and v_e, recall@20 against the flat
   scan, the index's bytes, the phase's peak memory, and a k-medoids
   index, ``kmedoids(prefilter=4)`` and the WCD baseline (on the first
   200,000 docs) with their purity and ARI.  After ``compact``:
   ``rebuild`` must give a fresh index's labels, an append plus
   ``index.add`` must keep exhaustive routing equal to ``engine.topk``,
   and a doc deleted on the engine must leave the routed results.
6b. the serving plane (``repro_torch.serving``) on the same corpus, each
   server over its own engine of all the docs, at k = 16, B = 64, h_max
   48, refine and the rerank at a budget of 32: ``QueryServer`` and
   ``AsyncQueryServer`` on 4,096 resident docs' own histograms (with the
   counts reset just before and read just after, B1, B3 and B4 must have
   run; self-recall@16 1.0; the async answers equal the sync ones bit for
   bit; the unrouted dispatch once under
   ``torch.cuda.set_sync_debug_mode("error")``), their queries a second,
   per-query p50/p99, the share of batches dispatched before their
   predecessor was collected, launches a batch, the host seconds a batch,
   the device busy share of a 512-query window (``torch.profiler``, CUDA
   activity only); an adaptive budget (its trajectory); degradation at a
   shed depth of 128 (tier-1 answers equal the serve step's tier 1 on
   the same batch); a NaN batch and one poisoned query (only it fails,
   with ``PoisonQuery``; the rest bit-equal) and a worker crash (its
   batch fails with ``WorkerCrashed``, the loop restarts, submission order
   holds); a second tenant that evicts the first, whose readmission
   answers bit for bit as before; between batches, an ingest of 4,000 new
   docs, a 64-doc dedup ingest whose 8 exact copies are refused (B2 and
   the d21 mode must run), 64 deletes that never come back and
   ``compact``; a 64-cell indexed tenant (answers equal
   ``build_serve_step(index=)``'s on the same batches, every query routed
   to its own doc's cell finds it, the index metrics in the Prometheus
   text); the ingest pool (2 spawned workers, answers equal the in-thread
   text path's, no worker maps torch); the reference's metric names.
6c. the corpus workloads (``repro_torch.workloads``) on the first
   min(65,536, n) docs (the row count of the paper's all-pairs cell
   ``allpairs_64k``), their last 64 rows made exact copies of docs 0-63,
   each run with its own counts: ``corpus_self_topk`` k=16 at tile 1,024
   (B1 once a tile and B2 twice a visited block, counted exactly; rows
   ascending without self; each planted doc's top-1 its copy; 64 sampled
   rows against ``symmetric_topk_streaming`` within 2.5e-2 + 1e-4*|d|,
   ids equal where the gaps exceed that), the same on a
   ``SegmentedEngine`` of the docs less 4,096 plus a 4,096-doc delta (bit
   for bit), then after 64 deletions (no deleted doc in a row, a deleted
   doc's row all unfilled); ``near_duplicate_graph`` at 0.05 (every
   planted pair an edge, no self-loop, every pair in one of
   ``duplicate_groups``); ``knn_graph`` union and mutual (mutual within
   union); ``corpus_vs_corpus_topk`` of 1,024 external docs at tile 64
   with the resident side (both sides against the engine's own top-k);
   ``corpus_self_topk_distributed`` (the serve step, tile 256, refined:
   256 sampled distances against ``symmetric_resident``).  Times,
   launches, the Z cache's bytes, the phase's peak and the monolithic
   ``corpus_self_topk``'s device time by kernel group and busy share (a
   ``torch.profiler`` window with CUDA activity only) are printed.
6d. the entry points: ``repro_torch.examples.{quickstart, knn_classify,
   cluster_corpus, serve_queries}`` (also ``--async --rerank-wmd``) and
   ``repro_torch.launch.serve`` in-process at their default sizes, with
   the counts reset just before and read just after: B1, B2, B3, B4 and
   the d21 mode must each run; each holds its gate (the quickstart's
   self-matches, accuracies above chance, the planted duplicate groups,
   serve_queries' recall > 0.9, the launcher's self-recall), and
   ``--full`` and ``--full --multi-pod`` must raise the production mesh's
   ``ValueError`` (a world of one rank, not 256 or 512).
6e. the mesh (``repro_torch.launch.mesh``) on the same corpus, in a
   world-size-1 NCCL group that the phase sets up and tears down, with
   the counts reset just before and read just after: the 1x1 mesh's
   monolithic streaming step (k = 32), its tier 0 with the refine and
   the rerank (budget 64), the engine-less step and the all-pairs D1, each
   equal to the mesh-less call bit for bit and timed beside it (B1, B2,
   B3 and B4 must run; no collective issued); each of 2 and 8 vocabulary
   shards run rank by rank, their B1 + B2 partials summed against
   ``one_sided`` within B2's tolerance (launches counted); with two cards
   or more, min(cards, 4) spawned NCCL ranks at (1, n) and (n, 1) on the
   first 65,536 docs, the monolithic step and the segmented one over two
   segments with a tombstone every 97th doc, against the one-card steps,
   and an ``AsyncQueryServer`` at (1, n) whose ranks answer alike and
   within B2's tolerance of the one-card async server (skipped, and
   logged, on one card).  The peak memory and the phase's
   seconds are printed; each kernel's entry in the kernels line carries
   its ``mesh_launches``: this phase's and 6f's, summed, and apart in
   ``mesh_launches_by_phase``.
6f. (inside 6, after the index phase and before ``compact``, on its
   engine and its 64-cell index) the segmented and routed steps and the
   server on a 1x1 mesh, in a world-size-1 NCCL group set up and torn
   down there, with the counts reset just before and read just after:
   the segmented step (k = 32), its tier 0 with the refine and the
   rerank (budget 64), the routed step (top_p 4), a ``QueryServer``
   on the mesh answering the 64 queries and an ``AsyncQueryServer`` on the
   mesh answering them as raw texts through an ingest pool of 2 workers
   (the serving phase's vectorizer); B1, B3 and B4 must run and no
   collective be issued; each equal to the mesh-less call (and the
   mesh-less servers) bit for bit, the steps timed beside it, the async
   answers also the sync mesh server's on the same texts, no dead doc or
   filler in a result, every query finding itself in both servers'
   answers.  The peak memory and the phase's seconds are printed.
6g. the paper's four cells (``repro_torch.configs.lcrwmd``:
   ``serve_set1_1m``, ``serve_set2_2p8m``, ``allpairs_64k``,
   ``serve_1m_k128``) at full size, after the LC-RWMD phases free their
   memory: each ``build_cell("lcrwmd", name, mesh)`` on a 1x1 mesh in a
   world-size-1 NCCL group, its ``step_fn`` (``bf16_matmul=True``) on
   inputs of the cell's exact shapes drawn on the card
   (``cells.make_args``: Zipf ids, repeats as padding; the mean h
   printed).  With the counts reset just before and read just after one
   call, B1 and B2 must run (``cells_launches`` in the kernels line); the
   call equals the mesh-less step (or D1) bit for bit; B1 under bf16
   matches its plain version on the first 65,536 vocabulary rows; every
   query finds its own row (D1's diagonal for ``allpairs_64k``) within
   the gram form's bf16 floor.  Printed: ms a call, the device split
   phase 1 / phase 2 / top-k of a profiled call (CUDA activity only) and
   of the parts timed apart by CUDA events (the split reported where
   every trace lost B1's records), TFLOP/s of
   ``model_flops``, the peak memory, and B1 at ``serve_set1_1m``'s shape
   under bf16 and f32 beside its bound (``cells_b1_bf16`` in the line).
7. flash attention: the kernel against its plain version at llama3.2-1b's
   heads (B=4, S=T=4,096, 32 query and 8 KV heads, dh 64), causal in bf16
   and f32, non-causal, at a length that is not a tile multiple, and with
   S=4,000 queries over T=4,096 keys, non-causal (a ragged KV tail; bf16
   within the bars of ``kernels/flash_attention.py``: relative RMS and the
   largest error over its row's largest output), and on the probe whose
   output shows that p is rounded to bf16; its time and TFLOP/s beside
   ``scaled_dot_product_attention``'s (bf16, and f32 with TF32 off).
8. gather-scale-scatter: ``ops.segment_spmm`` at the ogb_products cell
   (2,449,029 nodes, 61,859,140 edges, 100 features) with degree-0 rows
   and padding edges, against its plain version on the card, bit for bit
   against the CPU plain version on the first rows, and beside
   ``torch.sparse.mm`` of the CSR adjacency; the feat bytes gathered and
   their rate, the 32-byte sectors they cover and that floor at the HBM
   rate; three witnesses of what the card gives such gathers: a Triton
   kernel that sums the same rows in no order (``tools/gather_witness.py``),
   the bare gather ``feat[src]`` (``index_select``) and ``embedding_bag``'s
   weighted sums over the same rows; the call's time when one row holds
   1% of the edges (a hub); a whole trace of the call.
9. llama3.2-1b at full width (random weights from a seed): one 32,768-token
   prompt through ``forward_with_cache`` (flash attention in all 16 layers,
   counted) and 32 greedy ``decode_step``s; prefill and decode times, peak
   memory, the attention kernel's share of the prefill and its TFLOP/s
   (``torch.profiler``, the tensor-core kernel by name: the phase fails if
   the profile shows none of its time, i.e. bf16 did not run on it);
   the kernel at the prefill's own shape: the last layer's q, k and v of the
   32,768-token prompt, with three slices of 256 query rows (first, middle,
   last) against the plain version over all their keys; then, at 4,096
   tokens, the prefill against the plain attention and a decode step
   against the prefill of one more token; then the 32,768-token prefill
   cache quantized to int8 (``kv_quant.quantize_kv``) and 32
   ``decode_step_quant`` steps beside ``decode_step`` on the fp cache, fed
   the same tokens, over 24 rows of that cache: logits within the
   reference's bars (rtol 0.1, atol 0.15, argmax agreement >= 0.95, a
   pick that ties the fp maximum within one bf16 step counted as agreeing),
   ms a token and the caches' bytes.
10. grok-1-314b (2 of 64 layers: 8 experts top-2, 48 / 8 heads, dh 128)
   and deepseek-v2-236b (4 of 60 layers: MLA, 1 dense + 3 MoE layers of
   160 experts top-6 + 2 shared) at full width with bf16 weights from a
   seed, one after the other: an 8,192- (grok) or 4,096-token
   (deepseek) prompt through ``forward_with_cache`` and 32 greedy
   ``decode_step``s with the counts reset just before and read just
   after (grok's prefill runs B8 once a layer, deepseek's none); prefill
   and decode times, TFLOP/s of 2 x the active parameters a token, peak
   memory, the share of (token, choice) pairs dropped by capacity and the
   device busy share of the prefill (``torch.profiler``).  Checks: finite
   logits; a decode step after 1,023 tokens against ``forward_with_cache``
   of 1,024 (the capacity lifted to the whole group, so that neither path
   drops a pair); grok's prefill through B8 against the same through B8's
   plain version at 2,048 tokens; B8 at grok's prefill shape (the last
   layer's q, k, v at 4,096 tokens) against its plain version, timed
   beside SDPA and its bound at 4,096 and 8,192; deepseek's absorbed MLA
   decode on the int8 latent against the fp latent over 8 steps of one
   layer (rtol 0.08, atol 0.05).
11. NequIP (``repro_torch.models.gnn.nequip``; the ``nequip`` config at
   full width: 5 layers, 32 channels, l_max 2, 8 RBF, cutoff 5, seeded
   weights) on the four cells of ``configs/gnn_archs.py`` at full size,
   one after the other: ``full_graph_sm`` (2,708 nodes, 10,556 edges,
   1,433 features), ``minibatch_lg`` (the port's sampler over a
   232,965-node random graph of degree 25: 1,024 seeds, fanout (15, 10),
   padded to 180,224 nodes and 184,320 edges; 602 features),
   ``ogb_products`` (2,449,029 nodes, 61,859,140 edges drawn on the card
   as phase 8 draws them, 100 features; energy only, in chunks of whole
   destination rows of at most 2^20 edges) and ``molecule`` (128 graphs
   of 30 atoms, 8,192 edges, species); positions in a cube of side 4
   (``minibatch_lg``: the sampler's). With the counts reset just before
   and read just after, the energies (``forward_energy``) must launch B9
   2 + 2 x layers x chunks times (the position gathers, each block's
   feature gather and aggregation) and the forces
   (``forward_energy_forces``) 2 x layers + 1 more in the backward.
   Printed: ms a forward and a forward with forces (CUDA events),
   TFLOP/s by the reference's formula (``src/repro/launch/cells.py``
   ``_nequip_flops``, ``train=False``), peak GB, and of one profiled call
   the device busy share and B9's device ms against the rest.  Checks:
   the same calls with B9 swapped for its plain version (energies within
   1e-5 and forces within 1e-4 of their largest magnitude), whether the
   forces repeat bit for bit, ``molecule`` against the port on the CPU,
   and on ``molecule`` and ``minibatch_lg`` E(R x + t) = E(x) and F(R x) =
   R F(x) within 1e-4.  Then B9 at NequIP's aggregation on
   ``ogb_products`` (D 288, one layer's chunks) against its bytes bound,
   beside ``segment_reduce(lengths=)`` and ``index_add_``.

Before the last line come a JSON object with one entry per kernel and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings


ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores; the kernels run IEEE float32 on the FMA units.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Transcendentals (expf's ex2) run on the SFUs: 132 SMs x 16 results per
# clock per SM x the 1.98 GHz boost clock of the H100 SXM (Hopper white
# paper: 4 SFUs in each of an SM's 4 partitions).
SFU_OPS_PER_S = 132 * 16 * 1.98e9

KW_RERANK = dict(eps=0.05, eps_scaling=2, max_iters=100)
B = 64           # query batch: resident docs 0..63
K_CAND = 32      # quickstart candidates
K_FINAL = 5
K_LARGE = 256    # B3 above its shared-memory carry (the global carry)
SYM_ROW_BLOCK = 4096  # slab of the symmetric fold; the result does not depend on it
VOCAB_CHUNK = 512     # the streaming engine's chunk (the reference's default)
CHECK_ROWS = 65536    # rows held against the plain versions that gather (n, h, B)
RWMD_QUERY_CHUNK = 4  # queries per GEMM block of core/rwmd.py's check
N_LP = 16             # pairs solved exactly by the LP
SET1_H, SET1_DOCS, SET1_QUERIES = 160, 1024, 16  # B7 at Table IV set 1's h_max
NAIVE_H160_ROWS = 200_000  # B6b and B2 at set 1's h_max, 80% of slots nonzero
NAIVE_WIDE_B = 256         # B6b and B2 at B = 256: Z of (v_e, 256) past the L2
# The WMD solvers are held to each other on the pairs where both stopped on
# tol at every level (total iterations < max_iters): at the rerank's
# settings (eps 0.05 against costs of ~30) most pairs stop at max_iters,
# and unconverged iterates of the log-domain kernel and the batched
# exp-domain solver (whose kernel matrix underflows between absorptions)
# part ways.  At these settings most pairs converge.
WMD_CHECK_KW = dict(eps=0.5, eps_scaling=3, max_iters=2000)
WMD_CONVERGED_MIN_SHARE = 0.5
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# B8 at llama3.2-1b's heads: (B, S = T, Hq, Hkv, dh), and a length that is
# not a multiple of the kernel's tiles.
FLASH_SHAPE = (4, 4096, 32, 8, 64)
FLASH_ODD_LEN = 4000
FLASH_F32_TOL = 1e-4  # float32: the order of ~64 tiles' rescaled sums
                      # (bf16: the bars of kernels/flash_attention.py)
# B9 at the ogb_products cell (src/repro/configs/gnn_archs.py): N, E, D.
OGB_NODES, OGB_EDGES, OGB_FEAT = 2_449_029, 61_859_140, 100
OGB_PAD_EDGES = 1024  # padding edges (rad 0) to the sink row N - 1
OGB_ISOLATED = 0.01   # share of rows that no edge reaches
SEG_TOL = 1e-4        # the plain version adds with atomics, in no fixed order
# llama3.2-1b serving: prefill_32k's sequence length at batch 1, then
# greedy decode steps; the checks run at LM_CHECK_LEN.
LM_PROMPT = 32768
LM_DECODE = 32
LM_CHECK_LEN = 4096
LM_SLICE_ROWS = 256   # query rows per slice of the kernel check at S = 32,768
# Relative RMS gap allowed between two bf16 attention paths through the
# whole model: 3x the reference's own gap between its gqa_attention and its
# Pallas flash kernel at bf16 on the llama3.2-1b smoke config at depth 16
# (tests/test_torch_transformer.py::test_chip_bar_covers_the_references_gap).
LM_REL_RMS_BAR = 0.05
# The int8 KV cache against the fp cache: the reference's own bars
# (tests/test_kv_quant.py): decode logits within rtol 0.1 / atol 0.15 with
# argmax agreement >= 0.95; MLA's attention output within rtol 0.08 / atol
# 0.05 over MLA_INT8_STEPS steps of one layer.
INT8_RTOL, INT8_ATOL, INT8_TOP1 = 0.1, 0.15, 0.95
INT8_ROWS = 24   # rows of the 32,768-token cache: 24 x 32 argmax samples
# The reference's argmax bar, read literally, does not hold on llama3.2-
# 1b's random weights: the logits are the float32 cast of a bf16 product
# (as the reference's), and over 128,256 tokens their top two tie exactly
# or within one bf16 step in many samples (median top-1 margin 0.156;
# 0.9297 of 768 samples agreed, many flips at margin 0; PERF.md, PR 28).
# So the run holds INT8_TOP1 with a pick whose fp logit lies within one
# bf16 step of the fp maximum (the fp logits' own resolution, not the
# int8 error's) counted as agreeing, and beside it two bars on the literal
# agreement that can fail: at least INT8_TOP1_FLOOR (twice the
# reference's share of flips), and every flip within INT8_FLIP_RMS of its
# row's RMS |dlogit| of a tie (4.2 standard deviations of the difference
# of two logits' errors; the widest measured flip was 4.5).
INT8_TOP1_FLOOR, INT8_FLIP_RMS = 0.90, 6.0
MLA_INT8_RTOL, MLA_INT8_ATOL, MLA_INT8_STEPS = 0.08, 0.05, 8
# The MoE and MLA models at full width (depth cut, bf16 weights from a
# seed): (arch, layers kept, prompt); greedy decode steps after each prompt.
MOE_MODELS = (("grok-1-314b", 2, 8192), ("deepseek-v2-236b", 4, 4096))
MOE_DECODE = 32
MOE_SWAP_LEN = 2048    # grok's prefill through B8 vs its plain version
MOE_B8_CHECK_LEN = 4096  # B8 at grok's heads against the plain version
# MOE_DV_STEPS decode steps after a prompt of MOE_DV_LEN - MOE_DV_STEPS
# against forward_with_cache of MOE_DV_LEN tokens: one MoE group either way
MOE_DV_LEN = 1024
MOE_DV_STEPS = 32
# Share of (token, choice) pairs that two bf16 paths may route to another
# expert, about 3x the most measured (PERF.md, PR 28): grok-1 0.0135 (its
# prefill through B8 against its plain version, S = 2,048) and 0.0156 (the
# decode steps against the forward); deepseek-v2, whose 160 experts' top-6
# edge nearly ties on random weights, 0.104 (the decode steps).  A path
# that routed on a wrong input would flip most choices.
MOE_FLIP_BAR = {"grok-1-314b": 0.05, "deepseek-v2-236b": 0.3}


# kernel -> (its CUDA source, the TPU kernel's pallas_call it replaces);
# B1-B4 and B7's d21 mode serve the cascade, B5-B7 the comparison path, B8
# the llama3.2-1b prefill, B9 its own entry point (ops.segment_spmm).
KERNEL_SOURCES = {
    "lc_rwmd_phase1": ("src/repro_torch/csrc/lc_rwmd_phase1.cu",
                       "src/repro/kernels/lc_rwmd_phase1.py:85"),
    "spmm_ell": ("src/repro_torch/csrc/spmm_ell.cu",
                 "src/repro/kernels/spmm_ell.py:90"),
    "fused_topk": ("src/repro_torch/csrc/fused_topk.cu",
                   "src/repro/kernels/fused_stream.py:294"),
    "sinkhorn_wmd": ("src/repro_torch/csrc/sinkhorn_wmd.cu",
                     "src/repro/kernels/sinkhorn_wmd.py:177"),
    "fused_chunk": ("src/repro_torch/csrc/fused_chunk.cu",
                    "src/repro/kernels/fused_stream.py:128"),
    "spmm_ell_dense": ("src/repro_torch/csrc/spmm_ell.cu",
                       "src/repro/kernels/spmm_ell.py:142"),
    "spmm_ell_naive": ("src/repro_torch/csrc/spmm_ell.cu",
                       "src/repro/kernels/spmm_ell.py:188"),
    "rwmd_pairwise": ("src/repro_torch/csrc/rwmd_pairwise.cu",
                      "src/repro/kernels/rwmd_pairwise.py:80"),
    # B7's d21 mode: the symmetric fold's swapped direction (main path)
    "rwmd_d21": ("src/repro_torch/csrc/rwmd_pairwise.cu",
                 "src/repro/kernels/rwmd_pairwise.py:80"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93"),
    "segment_spmm": ("src/repro_torch/csrc/segment_spmm.cu",
                     "src/repro/kernels/segment_spmm.py:66"),
}


# Figures beyond the contract's that the kernels line carries for a kernel:
# B2's gathers and its time at the vocabulary-chunk shape, B6b beside B2 at
# four shapes, B9's gathers, sector floor and the gather witnesses' times.
EXTRA = {"spmm_ell": ("nnz", "gathered_gb", "gathered_tbps", "hot_share",
                      "scan_chunks", "scan_call"),
         "spmm_ell_naive": ("shapes",),
         "segment_spmm": ("info",)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Mean device milliseconds per call, by CUDA events, after one warm-up
    (``warm=False`` for a call too long to repeat, whose inputs and library
    handles an earlier call already brought up)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds per call ending in a synchronize, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float,
             flop_per_s: float = FP32_FLOP_PER_S,
             n_sfu: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate against the
    operations, FMA-unit operations at ``flop_per_s`` and ``n_sfu``
    transcendentals at the SFU rate, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / flop_per_s, n_sfu / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(ids, w, n_cols):
    """cuSPARSE yardstick: the resident ELL set as a CSR (n, n_cols) tensor."""
    import torch

    mask = w > 0
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    r = rows[mask]
    c = ids[mask].long()
    order = torch.argsort(r * n_cols + c)
    crow = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=ids.device)
    crow[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, c[order], w[mask][order],
                                       size=(ids.shape[0], n_cols))


def check_topk(name, vals, idx, ref_vals, ref_idx, tol):
    """Values within tol; indices equal wherever both neighbour gaps > tol.

    ``ref_*`` carry one more column than ``vals``, so the last kept slot's
    gap to the first dropped candidate is known.
    """
    import torch

    k = vals.shape[1]
    err = (vals - ref_vals[:, :k]).abs().max().item()
    if not err <= tol:
        fail(f"{name}: values differ by {err} > {tol}")
    gaps = ref_vals[:, 1:] - ref_vals[:, :-1]                    # (B, k)
    big = torch.ones_like(ref_vals[:, :k], dtype=torch.bool)
    big[:, 1:] &= gaps[:, :k - 1] > tol
    big &= gaps[:, :k] > tol
    bad = (idx != ref_idx[:, :k]) & big
    if bad.any():
        fail(f"{name}: {int(bad.sum())} indices differ where the gap exceeds {tol}")
    return err


def kernel_phase(engine, q, report):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core.lc_rwmd import doc_targets
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels import lc_rwmd_phase1 as p1
    from repro_torch.kernels import rwmd_pairwise as rw
    from repro_torch.kernels import sinkhorn_wmd as sk
    from repro_torch.kernels import spmm_ell as sp

    emb_r = engine.emb_restricted
    v_e, m = emb_r.shape
    t = engine.gather_queries(q.ids)                               # (B, h, m)
    valid = (q.weights > 0).to(torch.float32)
    r_ids = engine.resident_restricted.ids
    r_w = engine.resident_restricted.weights
    n, h1 = r_ids.shape
    h2 = t.shape[1]

    # --- B1: phase 1, compared in squared space ---
    z_k = p1.phase1_sq_cuda(emb_r, t, valid)
    z_p = p1.phase1_sq_plain(emb_r, t, valid)
    e2 = (emb_r * emb_r).sum(1)[:, None]
    t2max = ((t * t).sum(2) * valid).amax(1)[None, :]
    tol = 1e-5 * (e2 + t2max)
    diff = (z_k - z_p).abs()
    if not bool((diff <= tol).all()):
        fail(f"lc_rwmd_phase1: |dZ^2| exceeds 1e-5*(|e|^2+|t|^2) at "
             f"{int((diff > tol).sum())} entries (max {diff.max().item()})")
    n_valid = int(valid.sum().item())
    tf = t.reshape(-1, m)
    vmask = valid.reshape(-1) > 0

    def lib_p1():
        d = torch.cdist(emb_r, tf)
        d.masked_fill_(~vmask[None, :], float("inf"))
        return d.reshape(v_e, B, h2).amin(dim=2)

    flop1 = 2.0 * v_e * m * n_valid   # the products over the valid words
    bnd, by = bound_ms(4 * (v_e * m + B * h2 * m + B * h2 + v_e * B), flop1)
    r1 = report["lc_rwmd_phase1"] = dict(
        max_abs_err=diff.max().item(), tol="1e-5*(|e|^2+|t|^2), squared Z",
        ms=time_ms(lambda: p1.phase1_sq_cuda(emb_r, t, valid)),
        plain_ms=time_ms(lambda: p1.phase1_sq_plain(emb_r, t, valid), 2),
        library_ms=time_ms(lib_p1, 2), bound_ms=bnd, bound_by=by)
    r1["tflops"] = flop1 / r1["ms"] / 1e9
    del z_p, diff, tol
    log(f"kernel lc_rwmd_phase1: max |dZ^2| {r1['max_abs_err']:.3e} within "
        f"1e-5*(|e|^2+|t|^2); {r1['ms']:.3f} ms, {r1['tflops']:.1f} TFLOP/s "
        f"over the {n_valid} valid words ({flop1:.3e} FLOP), "
        f"{bnd / r1['ms']:.3f} of its {by} bound {bnd:.3f} ms; cdist + amin "
        f"{r1['library_ms']:.3f} ms")

    # --- B2: ELL SpMM ---
    z1 = torch.sqrt(torch.clamp(z_k, min=0.0))
    d_k = sp.spmm_ell_cuda(r_ids, r_w, z1)
    d_p = sp.spmm_ell_plain(r_ids, r_w, z1)
    err = (d_k - d_p).abs()
    if not bool((err <= 1e-5 + 1e-5 * d_p.abs()).all()):
        fail(f"spmm_ell: |dD| exceeds 1e-5 + 1e-5*|D| (max {err.max().item()})")
    csr = csr_of(r_ids, r_w, v_e)
    nnz = csr.values().numel()
    # bytes: every weight, the ids of the nonzero slots (the only ones the
    # sum needs), Z and D once
    bnd, by = bound_ms(n * h1 * 4 + nnz * 4 + v_e * B * 4 + n * B * 4,
                       2.0 * nnz * B)
    r2 = report["spmm_ell"] = dict(
        max_abs_err=err.max().item(), tol="1e-5 + 1e-5*|D|",
        ms=time_ms(lambda: sp.spmm_ell_cuda(r_ids, r_w, z1)),
        plain_ms=time_ms(lambda: sp.spmm_ell_plain(r_ids, r_w, z1), 2),
        library_ms=time_ms(lambda: torch.sparse.mm(csr, z1)),
        bound_ms=bnd, bound_by=by)
    # The Z rows gathered (nnz * B * 4 bytes, from L2 or L1) and their rate;
    # the share of the nonzero slots whose id is among the H most frequent,
    # H Z rows filling 150 KB of shared memory.
    r2["nnz"] = nnz
    r2["gathered_gb"] = nnz * B * 4 / 1e9
    r2["gathered_tbps"] = r2["gathered_gb"] / r2["ms"]
    hot = 150 * 1024 // (B * 4)
    freq = torch.bincount(r_ids[r_w != 0].long(), minlength=v_e)
    r2["hot_rows"] = hot
    r2["hot_share"] = float(freq.topk(hot).values.sum()) / nnz
    # the vocabulary-chunk shape of lc_rwmd_streaming(fuse="scan"): the
    # resident ids made relative to a chunk of VOCAB_CHUNK words (most
    # slots zero-weight), Z of (VOCAB_CHUNK, B)
    f_ids, f_w = engine.resident.ids, engine.resident.weights
    v_full = engine.emb_full.shape[0]
    zc = torch.rand(VOCAB_CHUNK, B, device=z1.device)
    r2["scan_chunks"] = {}
    for name, lo in (("chunk0", 0),
                     ("mid", (v_full // VOCAB_CHUNK // 2) * VOCAB_CHUNK)):
        c_ids, c_w = fs.chunk_relative(f_ids, f_w, lo, VOCAB_CHUNK)
        d_c = sp.spmm_ell_cuda(c_ids, c_w, zc)
        err_c = (d_c - sp.spmm_ell_plain(c_ids, c_w, zc)).abs()
        if not bool((err_c <= 1e-5 + 1e-5 * d_c.abs()).all()):
            fail(f"spmm_ell at the chunk shape ({name}): |dD| exceeds 1e-5 + "
                 f"1e-5*|D| (max {err_c.max().item()})")
        nnz_c = int((c_w != 0).sum())
        bnd_c, _ = bound_ms(n * h1 * 4 + nnz_c * 4 + VOCAB_CHUNK * B * 4
                            + n * B * 4, 2.0 * nnz_c * B)
        r2["scan_chunks"][name] = dict(
            lo=lo, nnz=nnz_c, max_abs_err=err_c.max().item(), bound_ms=bnd_c,
            ms=time_ms(lambda: sp.spmm_ell_cuda(c_ids, c_w, zc), 10))
        del c_ids, c_w, d_c, err_c
    log(f"kernel spmm_ell: max |dD| {r2['max_abs_err']:.3e} within 1e-5 + "
        f"1e-5*|D|; {r2['ms']:.4f} ms, {bnd / r2['ms']:.3f} of its {by} bound "
        f"{bnd:.4f} ms; {nnz} nonzero slots gather {r2['gathered_gb']:.2f} GB "
        f"of Z rows at {r2['gathered_tbps']:.2f} TB/s; the {hot} most "
        f"frequent ids hold {r2['hot_share']:.3f} of the slots; sparse.mm "
        f"{r2['library_ms']:.4f} ms; at the scan chunk shape: " + ", ".join(
            f"{k} {c['ms']:.4f} ms ({c['nnz']} slots, bound {c['bound_ms']:.4f})"
            for k, c in r2["scan_chunks"].items()))
    del d_p, err

    # --- B3: phase 2 folded into the streaming top-k ---
    kk = K_CAND
    v_k, i_k = fs.phase2_topk_cuda(r_ids, r_w, z1, kk)
    v_p, i_p = fs.phase2_topk_plain(r_ids, r_w, z1, kk + 1, row_block=65536)
    tol3 = 1e-4
    err3 = check_topk("fused_topk", v_k, i_k, v_p, i_p, tol3)

    def lib_topk():
        d = torch.sparse.mm(csr, z1)
        return torch.topk(d, kk, dim=0, largest=False)

    # its values are B2's D at the returned ids, bit for bit
    if not torch.equal(v_k, d_k.T.gather(1, i_k.long())):
        fail("fused_topk: values differ from spmm_ell's D at the returned ids")
    del d_k
    bytes3 = n * h1 * 8 + v_e * B * 4 + B * kk * 8
    bnd, by = bound_ms(bytes3, 2.0 * nnz * B)
    r3 = report["fused_topk"] = dict(
        max_abs_err=err3, tol=f"values {tol3}; ids where gaps > {tol3}",
        ms=time_ms(lambda: fs.phase2_topk_cuda(r_ids, r_w, z1, kk)),
        plain_ms=time_ms(lambda: fs.phase2_topk_plain(
            r_ids, r_w, z1, kk, row_block=65536), 2),
        library_ms=time_ms(lib_topk), bound_ms=bnd, bound_by=by)
    r3["gbps"] = bytes3 / r3["ms"] / 1e6
    _, dev_us, merge_us, _ = profile_one(
        lambda: fs.phase2_topk_cuda(r_ids, r_w, z1, kk), "topk_merge")
    r3["merge_share"] = merge_us / dev_us if dev_us else None
    log(f"kernel fused_topk: max |dval| {err3:.3e} within {tol3}; ids equal "
        f"where the gaps exceed {tol3}; values equal spmm_ell's D; "
        f"{r3['ms']:.3f} ms, {r3['gbps']:.1f} GB/s ({bytes3 / 1e6:.1f} MB), "
        f"{bnd / r3['ms']:.3f} of its {by} bound {bnd:.3f} ms; the merge "
        f"launches {merge_us / 1e3:.3f} of {dev_us / 1e3:.3f} device ms "
        f"(torch.profiler); sparse.mm + topk {r3['library_ms']:.3f} ms")
    del csr

    # B3's 64-bit-offset variant (WIDE, which the launcher takes only when
    # v*B >= 2^31) on the same partial launch: a v argument past 2^31 / B
    # selects it on this Z.  Bit-equal partials; both timed, alternated.
    n_sm = torch.cuda.get_device_properties(z1.device).multi_processor_count
    rows3, n_ctas3 = fs.cta_rows(n, n_sm)
    lib3 = _build.lib(fs.NAME)
    stream = torch.cuda.current_stream().cuda_stream
    parts = {}
    for name in ("narrow", "wide"):
        parts[name] = (torch.empty((n_ctas3, B, kk), device=z1.device),
                       torch.empty((n_ctas3, B, kk), dtype=torch.int32,
                                   device=z1.device))

    def partial(name):
        v_arg = v_e if name == "narrow" else 2 ** 31 // B + 1
        pv, pi = parts[name]
        _build.check(lib3.launch_fused_topk_partial(
            r_ids.data_ptr(), r_w.data_ptr(), z1.data_ptr(), 0, 0, 0,
            pv.data_ptr(), pi.data_ptr(), n, n, h1, v_arg, B, kk, rows3,
            stream), fs.NAME)

    wide_ms = {"narrow": [], "wide": []}
    for name in ("narrow", "wide", "wide", "narrow"):
        wide_ms[name].append(time_ms(lambda: partial(name), 10))
    if not (torch.equal(parts["narrow"][0], parts["wide"][0])
            and torch.equal(parts["narrow"][1], parts["wide"][1])):
        fail("fused_topk: the 64-bit-offset variant's partials differ")
    r3["partial_ms"] = sum(wide_ms["narrow"]) / 2
    r3["wide_partial_ms"] = sum(wide_ms["wide"]) / 2
    log(f"kernel fused_topk partial launch: 32-bit Z offsets "
        f"{wide_ms['narrow'][0]:.3f} / {wide_ms['narrow'][1]:.3f} ms, 64-bit "
        f"(WIDE) {wide_ms['wide'][0]:.3f} / {wide_ms['wide'][1]:.3f} ms, "
        f"partials bit-equal")
    del parts

    # B3 above its shared-memory carry, and with both masks: a seventh of
    # the rows tombstoned, each query (resident doc j) excluding itself
    v_l, i_l = fs.phase2_topk_cuda(r_ids, r_w, z1, K_LARGE)
    v_p, i_p = fs.phase2_topk_plain(r_ids, r_w, z1, K_LARGE + 1,
                                    row_block=65536)
    r3["k256_max_abs_err"] = check_topk(f"fused_topk k={K_LARGE}", v_l, i_l,
                                        v_p, i_p, tol3)
    live = torch.arange(n, device=z1.device) % 7 != 3
    gid = torch.arange(B, dtype=torch.int32, device=z1.device)
    masks = dict(row_valid=live, q_gid=gid)
    v_m, i_m = fs.phase2_topk_cuda(r_ids, r_w, z1, kk, **masks)
    v_p, i_p = fs.phase2_topk_plain(r_ids, r_w, z1, kk + 1, row_block=65536,
                                    **masks)
    r3["masks_max_abs_err"] = check_topk("fused_topk masks", v_m, i_m, v_p,
                                         i_p, tol3)
    if bool((i_m == gid[:, None]).any()) or not bool(live[i_m.long()].all()):
        fail("fused_topk: a tombstoned row or a query's own id came back")
    r3["k256_ms"] = time_ms(lambda: fs.phase2_topk_cuda(r_ids, r_w, z1, K_LARGE))
    r3["masks_ms"] = time_ms(lambda: fs.phase2_topk_cuda(r_ids, r_w, z1, kk,
                                                         **masks))
    log(f"kernel fused_topk at k={K_LARGE} (global carry): max |dval| "
        f"{r3['k256_max_abs_err']:.3e}, {r3['k256_ms']:.3f} ms; k={kk} with "
        f"row_valid and q_gid: max |dval| {r3['masks_max_abs_err']:.3e}, "
        f"{r3['masks_ms']:.3f} ms; ids equal where the gaps exceed {tol3}")
    del v_l, i_l, v_m, i_m, v_p, i_p, live

    # --- B7's d21 mode: the symmetric fold's swapped direction ---
    emb_f, ids_f, w_f = engine.emb_full, engine.resident.ids, engine.resident.weights
    d21_k = rw.rwmd_d21_cuda(emb_f, ids_f, w_f, q.ids, q.weights)
    kept = {}

    def plain21():
        kept["d21"] = rw.rwmd_d21_plain(emb_f, ids_f, w_f, q.ids, q.weights)

    plain21_ms = time_ms(plain21, 1, warm=False)
    d21_p = kept.pop("d21")
    # the gram form's noise on near-zero distances (see comparison_phase)
    gram_atol = math.sqrt(2.0 ** -23 * 2.0 * float((emb_f * emb_f).sum(1).max()))
    err21 = (d21_k - d21_p).abs()
    ok = (d21_k == d21_p) | (err21 <= gram_atol + 1e-4 * d21_p.abs())
    if bool(torch.isnan(d21_k).any()) or not bool(ok.all()):
        fail(f"rwmd_d21: NaN, or |dd21| exceeds {gram_atol:.3e} + 1e-4*|d21| on "
             f"{int((~ok).sum())} of the {n} docs x {B} queries (max "
             f"{err21.max().item()})")
    n1 = float((w_f > 0).sum().item())
    flop21 = 2.0 * m * n1 * float(valid.sum().item())
    bnd, by = bound_ms(4 * emb_f.numel() + n * h1 * 8 + B * h2 * 8 + n * B * 4,
                       flop21)
    r21 = report["rwmd_d21"] = dict(
        max_abs_err=float(err21[torch.isfinite(err21)].max()),
        tol=f"{gram_atol:.3e} (gram floor) + 1e-4*|d21| (all {n} docs)",
        ms=time_ms(lambda: rw.rwmd_d21_cuda(emb_f, ids_f, w_f, q.ids,
                                            q.weights), 2, warm=False),
        plain_ms=plain21_ms, library_ms=None, bound_ms=bnd, bound_by=by)
    r21["tflops"] = flop21 / r21["ms"] / 1e9
    log(f"kernel rwmd_d21: max |dd21| {r21['max_abs_err']:.3e} within "
        f"{gram_atol:.3e} + 1e-4*|d21| on all {n} docs; "
        f"{r21['ms']:.1f} ms, {r21['tflops']:.1f} TFLOP/s over the valid words "
        f"({flop21:.3e} FLOP), {bnd / r21['ms']:.3f} of its {by} bound "
        f"{bnd:.1f} ms; plain {r21['plain_ms']:.1f} ms")
    del d21_p, err21, ok

    # B3 with the d21 operand maxed in, as the symmetric route calls it: at
    # the cascade's k and at pruned_wmd_topk's budget (4 * K_FINAL)
    for k21 in (kk, 4 * K_FINAL):
        v_s, i_s = fs.phase2_topk_cuda(r_ids, r_w, z1, k21, d21=d21_k)
        v_p, i_p = fs.phase2_topk_plain(r_ids, r_w, z1, k21 + 1,
                                        row_block=65536, d21=d21_k)
        r3[f"d21_k{k21}_max_abs_err"] = check_topk(
            f"fused_topk d21 k={k21}", v_s, i_s, v_p, i_p, tol3)
    r3["d21_ms"] = time_ms(lambda: fs.phase2_topk_cuda(r_ids, r_w, z1,
                                                       4 * K_FINAL, d21=d21_k))
    log(f"kernel fused_topk with the d21 operand at k={kk} and "
        f"{4 * K_FINAL}: max |dval| {r3[f'd21_k{kk}_max_abs_err']:.3e} / "
        f"{r3[f'd21_k{4 * K_FINAL}_max_abs_err']:.3e} within {tol3}, ids "
        f"equal where the gaps exceed it; {r3['d21_ms']:.3f} ms at k="
        f"{4 * K_FINAL}")
    del d21_k, v_s, i_s, v_p, i_p
    torch.cuda.empty_cache()
    r3["nonfinite"] = nonfinite_topk_check()

    # --- B4: Sinkhorn-WMD on the rerank's pairs ---
    flat = i_k.reshape(-1).long()
    t1, w1 = doc_targets(engine.resident, engine.emb_full, flat)
    t2 = t.repeat_interleave(kk, dim=0)
    w2 = q.weights.repeat_interleave(kk, dim=0)
    c_k, it_k = sk.sinkhorn_cuda(t1, w1, t2, w2, **KW_RERANK)
    c_p, it_p = sk.sinkhorn_plain(t1, w1, t2, w2, **KW_RERANK)
    err4 = (c_k - c_p).abs()
    # The cost tile's gram form carries ~sqrt(eps_f32 * (|a|^2 + |b|^2)) of
    # cancellation noise at near-zero costs (a doc against itself), in both
    # versions; that is the absolute floor, 1e-4 the relative part.
    norm2 = float((t1 * t1).sum(2).amax() + (t2 * t2).sum(2).amax())
    atol4 = math.sqrt(2.0 ** -23 * norm2)
    tol4 = atol4 + 1e-4 * c_p.abs()
    worst = int(torch.argmax(err4 - tol4))
    log(f"sinkhorn_wmd: worst pair {worst}: kernel {c_k[worst].item():.6f} "
        f"plain {c_p[worst].item():.6f} iterations {int(it_k[worst])}/"
        f"{int(it_p[worst])}; max rel err where WMD > 1: "
        f"{float((err4 / c_p.abs())[c_p.abs() > 1].max()):.2e}")
    if not bool((err4 <= tol4).all()):
        fail(f"sinkhorn_wmd: |dWMD| exceeds {atol4:.3e} + 1e-4*|WMD| (max "
             f"{err4.max().item()})")
    n1 = (w1 > 0).sum(1).to(torch.float64)
    n2 = (w2 > 0).sum(1).to(torch.float64)
    # Cost tile over the valid words (2m FLOP an entry), then per iteration
    # two sweeps of ~3 operations and one exp per valid entry (the row
    # sweep's sum is both the last row marginal and the f update), and the
    # final plan's sweep: the exps on the SFUs.
    it64 = it_k.to(torch.float64)
    ops4 = float((n1 * n2 * (2.0 * m + 6.0 * it64 + 6.0)).sum())
    exps4 = float((n1 * n2 * (2.0 * it64 + 1.0)).sum())
    bnd, by = bound_ms(4 * (t1.numel() + t2.numel() + w1.numel() + w2.numel()
                            + c_k.numel()), ops4, n_sfu=exps4)
    # the split: the cost tile and the final plan alone (max_iters = 0)
    # against the full run, alternated
    kw0 = dict(KW_RERANK, max_iters=0)
    split = {"tile": [], "full": []}
    for name in ("full", "tile", "tile", "full"):
        kw = kw0 if name == "tile" else KW_RERANK
        split[name].append(time_ms(lambda: sk.sinkhorn_cuda(t1, w1, t2, w2, **kw), 10))
    c0_k, _ = sk.sinkhorn_cuda(t1, w1, t2, w2, **kw0)
    c0_p, _ = sk.sinkhorn_plain(t1, w1, t2, w2, **kw0)
    err40 = (c0_k - c0_p).abs()
    if not bool((err40 <= atol4 + 1e-4 * c0_p.abs()).all()):
        fail(f"sinkhorn_wmd at max_iters = 0: |dWMD| exceeds {atol4:.3e} + "
             f"1e-4*|WMD| (max {err40.max().item()})")
    r4 = report["sinkhorn_wmd"] = dict(
        max_abs_err=err4.max().item(),
        tol=f"{atol4:.3e} (gram floor) + 1e-4*|WMD|",
        ms=sum(split["full"]) / 2,
        plain_ms=time_ms(lambda: sk.sinkhorn_plain(t1, w1, t2, w2, **KW_RERANK), 1),
        library_ms=None, bound_ms=bnd, bound_by=by, exps=exps4,
        tile_ms=sum(split["tile"]) / 2, runs_ms=split,
        max_iters0_max_abs_err=err40.max().item(),
        iters_mean=float(it_k.float().mean()),
        iters_equal_share=float((it_k == it_p).float().mean()))
    r4["iterations_ms"] = r4["ms"] - r4["tile_ms"]
    log(f"kernel sinkhorn_wmd: max |dWMD| {err4.max().item():.3e} within "
        f"{atol4:.3e} + 1e-4*|WMD| (mean iterations {r4['iters_mean']:.1f}, "
        f"equal to the plain version's on {r4['iters_equal_share']:.3f} of the "
        f"pairs); {r4['ms']:.3f} ms ({split['full'][0]:.3f} / "
        f"{split['full'][1]:.3f}), of which the cost tile and final plan "
        f"(max_iters = 0: {split['tile'][0]:.3f} / {split['tile'][1]:.3f} ms, "
        f"max |dWMD| {r4['max_iters0_max_abs_err']:.3e}) and the iterations "
        f"{r4['iterations_ms']:.3f} ms; {exps4:.3e} exps at "
        f"{SFU_OPS_PER_S:.3e}/s: {by} bound {bnd:.3f} ms")


NONFINITE_CASES = ((120, 120, 70), (3000, 3000, 70))  # (n, k, B): k = n


def nonfinite_topk_check() -> dict:
    """B3 against its plain version where D is non-finite: Z rows of NaN,
    of +inf and half +inf reached through positive weights, and d21 with
    NaN and +inf entries, k covering every doc, on the shared-memory carry
    (k = 120) and the global one (k = 3,000, merged over many CTAs), 70
    queries (two query chunks); without operands, with d21, and with d21,
    tombstones and self-exclusion.  Small-integer Z and d21 and weights in
    quarters make every sum exact, so ids and values must be equal in every
    slot (NaN as NaN); the plain fold's unfilled slots are (+inf, -1), the
    kernel's (3.4e38, -1).  Then the 64-bit-offset variant's partials
    against the 32-bit ones, bit for bit."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_stream as fs

    g = torch.Generator().manual_seed(23)
    out = {}
    for n, k, b in NONFINITE_CASES:
        v, h = 400, 16
        w = torch.randint(0, 5, (n, h), generator=g).float() / 4
        ids = torch.randint(8, v, (n, h), generator=g, dtype=torch.int32)
        ids[w == 0] = 0                       # zero weights read a finite row
        rows = torch.arange(n)
        for row, every, at in ((5, 7, 0), (6, 11, 1), (7, 13, 2)):
            hit = rows % every == 3
            ids[hit, at], w[hit, at] = row, 0.5
        z = torch.randint(0, 50, (v, b), generator=g).float()
        z[5], z[6], z[7, : b // 2] = float("nan"), float("inf"), float("inf")
        d21 = torch.randint(0, 60, (n, b), generator=g).float()
        d21[rows % 17 == 2, 3] = float("nan")
        d21[rows % 19 == 4, 5] = float("inf")
        ids, w, z, d21 = ids.cuda(), w.cuda(), z.cuda(), d21.cuda()
        live = (rows % 9 != 4).cuda()
        gid = (torch.arange(b, dtype=torch.int32) * 3).cuda()
        for name, extra in (("plain", {}), ("d21", dict(d21=d21)),
                            ("masks", dict(d21=d21, row_valid=live,
                                           q_gid=gid))):
            kv, ki = fs.phase2_topk_cuda(ids, w, z, k, **extra)
            pv, pi = fs.phase2_topk_plain(ids, w, z, k, **extra)
            real = pi >= 0
            if not torch.equal(ki, pi):
                fail(f"fused_topk non-finite n={n} k={k} {name}: "
                     f"{int((ki != pi).sum())} ids differ from the plain fold")
            if not (torch.equal(torch.isnan(kv), torch.isnan(pv))
                    and torch.equal(kv[real & ~torch.isnan(kv)],
                                    pv[real & ~torch.isnan(pv)])
                    and bool((kv[~real] == 3.4e38).all())
                    and bool((pv[~real] == float("inf")).all())):
                fail(f"fused_topk non-finite n={n} k={k} {name}: values "
                     "differ from the plain fold's")
            out[f"n{n}_{name}"] = dict(
                nan=int(torch.isnan(kv).sum()),
                inf=int(torch.isinf(kv).sum()), unfilled=int((~real).sum()))
        # the 64-bit-offset variant on the same partial launch (its v
        # argument past 2^31 / B selects it), d21 and masks in
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        rows3, n_ctas3 = fs.cta_rows(n, n_sm)
        kw = fs.list_widths(k, rows3, n_ctas3)[0]
        lib3 = _build.lib(fs.NAME)
        parts = []
        for v_arg in (v, 2 ** 31 // b + 1):
            pv_ = torch.empty((n_ctas3, b, kw), device="cuda")
            pi_ = torch.empty((n_ctas3, b, kw), dtype=torch.int32,
                              device="cuda")
            _build.check(lib3.launch_fused_topk_partial(
                ids.data_ptr(), w.data_ptr(), z.data_ptr(), live.data_ptr(),
                gid.data_ptr(), d21.data_ptr(), pv_.data_ptr(),
                pi_.data_ptr(), n, n, h, v_arg, b, kw, rows3,
                torch.cuda.current_stream().cuda_stream), fs.NAME)
            parts.append((pv_.view(torch.int32), pi_))
        if not (torch.equal(*[p[0] for p in parts])
                and torch.equal(*[p[1] for p in parts])):
            fail(f"fused_topk non-finite n={n}: the 64-bit-offset variant's "
                 "partials differ")
    log("kernel fused_topk with non-finite D (k covering every doc; shared "
        "and global carries; plain, d21, d21 + masks; 32- and 64-bit "
        "offsets): ids and values equal to the plain fold in every slot: "
        + json.dumps(out))
    return out


def naive_shape_inputs(docs, v, r_ids, r_w, z1) -> dict:
    """B6b's shapes as ``{name: (ids, w, z)}``: the main path's (r_ids, r_w,
    z1), the ``"scan"`` chunk shape (chunk 0 and a mid chunk, Z (512, B)),
    Table IV set 1's h_max (seeded, 80% of slots nonzero) and B = 256 (the
    main rows against a seeded Z of (v_e, 256))."""
    import torch

    from repro_torch.kernels import fused_stream as fs

    dev = z1.device
    v_e = z1.shape[0]
    g = torch.Generator(device=dev).manual_seed(19)
    zc = torch.rand(VOCAB_CHUNK, B, device=dev, generator=g)
    shapes = {"main": (r_ids, r_w, z1)}
    for name, lo in (("chunk0", 0), ("mid", (v // VOCAB_CHUNK // 2) * VOCAB_CHUNK)):
        shapes[name] = (*fs.chunk_relative(docs.ids, docs.weights, lo,
                                           VOCAB_CHUNK), zc)
    ids160 = torch.randint(0, v_e, (NAIVE_H160_ROWS, SET1_H), device=dev,
                           generator=g, dtype=torch.int32)
    w160 = torch.rand(ids160.shape, device=dev, generator=g)
    w160 = w160 * (torch.rand(ids160.shape, device=dev, generator=g) > 0.2)
    shapes["h160"] = (ids160, w160 / w160.sum(1, keepdim=True), z1)
    shapes["b256"] = (r_ids, r_w, torch.rand(v_e, NAIVE_WIDE_B, device=dev,
                                             generator=g))
    return shapes


def naive_shapes(docs, v, r_ids, r_w, z1) -> dict:
    """B6b beside B2 on one card, alternated, at :func:`naive_shape_inputs`'
    shapes, each bit-equal to B2; the bound by B2's rule (every weight, the
    ids of nonzero slots, Z and D once)."""
    import torch

    from repro_torch.kernels import spmm_ell as sp

    out = {}
    for name, (ids, w, z) in naive_shape_inputs(docs, v, r_ids, r_w,
                                                z1).items():
        n_, h_ = ids.shape
        v_, b_ = z.shape
        d6 = sp.spmm_ell_naive_cuda(ids, w, z)
        if not torch.equal(d6, sp.spmm_ell_cuda(ids, w, z)):
            fail(f"spmm_ell_naive at the {name} shape: not bit-equal to the "
                 f"blocked kernel")
        nnz = int((w != 0).sum())
        bnd, by = bound_ms(n_ * h_ * 4 + nnz * 4 + v_ * b_ * 4 + n_ * b_ * 4,
                           2.0 * nnz * b_)
        runs = {"naive": [], "blocked": []}
        for k in ("naive", "blocked", "blocked", "naive"):
            fn = sp.spmm_ell_naive_cuda if k == "naive" else sp.spmm_ell_cuda
            runs[k].append(time_ms(lambda: fn(ids, w, z), 10))
        ms, b2_ms = sum(runs["naive"]) / 2, sum(runs["blocked"]) / 2
        row = dict(n=n_, h=h_, b=b_, nnz=nnz, ms=ms, blocked_ms=b2_ms,
                   runs_ms=runs, bound_ms=bnd, bound_by=by,
                   gathered_tbps=nnz * b_ * 4 / ms / 1e9,
                   blocked_gathered_tbps=nnz * b_ * 4 / b2_ms / 1e9)
        out[name] = row
        log(f"spmm_ell_naive at the {name} shape (n {n_}, h {h_}, B {b_}, "
            f"{nnz} nonzero slots): {ms:.4f} ms ({runs['naive'][0]:.4f} / "
            f"{runs['naive'][1]:.4f}), blocked {b2_ms:.4f} ms; {by} bound "
            f"{bnd:.4f} ms; Z rows at {row['gathered_tbps']:.2f} TB/s "
            f"(blocked {row['blocked_gathered_tbps']:.2f}); bit-equal to "
            f"blocked")
        del d6
    return out


def comparison_phase(engine, q, cand, report):
    """The paper's comparison path on the slice's corpus, then its checks.

    The launch counts are reset just before the path and read just after;
    every kernel of the path must have run.  Returns the comparison line's
    numbers.
    """
    import torch

    from repro_torch.core import rwmd as trw
    from repro_torch.core import wmd as twmd
    from repro_torch.core.distances import dists, pair_dists
    from repro_torch.core.lc_rwmd import doc_targets, lc_rwmd_streaming
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels import rwmd_pairwise as rw
    from repro_torch.kernels import sinkhorn_wmd as sk
    from repro_torch.kernels import spmm_ell as sp

    docs, emb = engine.resident, engine.emb_full   # on the card, f32
    dev = emb.device
    n, h1 = docs.ids.shape
    v, m = emb.shape
    b, h2 = q.ids.shape
    r_ids = engine.resident_restricted.ids
    r_w = engine.resident_restricted.weights
    v_e = engine.emb_restricted.shape[0]
    t_q = engine.gather_queries(q.ids)                            # (B, h2, m)
    valid = (q.weights > 0).to(torch.float32)
    n_valid_q = int(valid.sum().item())
    # the cascade's (candidate, query) pairs, query-major
    flat = cand.indices.reshape(-1).long()
    ids1 = docs.ids.index_select(0, flat)
    w1 = docs.weights.index_select(0, flat)
    t1 = doc_targets(docs, emb, flat)[0]
    ids2 = q.ids.repeat_interleave(K_CAND, dim=0)
    w2 = q.weights.repeat_interleave(K_CAND, dim=0)
    t2 = t_q.repeat_interleave(K_CAND, dim=0)

    # --- the path, counts reset just before and read just after ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launches()
    z1 = engine._phase1(t_q.reshape(b * h2, m), q.weights)        # (v_e, B)
    d_sp = {mode: ops.spmm_ell(r_ids, r_w, z1, mode=mode)
            for mode in ("blocked", "dense", "naive")}
    d_kernel = lc_rwmd_streaming(docs, q, emb, vocab_chunk=VOCAB_CHUNK,
                                 fuse="kernel")
    d_scan = lc_rwmd_streaming(docs, q, emb, vocab_chunk=VOCAB_CHUNK,
                               fuse="scan")
    d_quad = ops.rwmd_pairwise(emb, docs.ids, docs.weights, q.ids, q.weights)
    wmd_k = twmd.wmd_batched_dispatch(t1, w1, t2, w2, use_kernel=True,
                                      **KW_RERANK)
    wmd_b = twmd.wmd_batched(ids1, w1, ids2, w2, emb, **KW_RERANK)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"comparison path launches: {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name in ("lc_rwmd_phase1", "spmm_ell", "spmm_ell_dense",
                 "spmm_ell_naive", "fused_chunk", "rwmd_pairwise",
                 "sinkhorn_wmd"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the comparison path")

    t_phase = time.perf_counter()
    rows = min(CHECK_ROWS, n)
    # Distances near zero (a query's own words) carry the gram form's
    # cancellation noise, ~sqrt(eps_f32 * (|e|^2 + |t|^2)), computed in
    # another order by each kernel and plain version: the absolute floor of
    # the checks that compare two ways of computing them.
    emax2 = float((emb * emb).sum(1).max())
    gram_atol = math.sqrt(2.0 ** -23 * 2.0 * emax2)
    csr = csr_of(r_ids, r_w, v_e)
    nnz = csr.values().numel()

    # --- B6a, B6b: against their plain versions and the blocked kernel ---
    for name, mode, plain, cuda in (
            ("spmm_ell_dense", "dense", sp.spmm_ell_dense_plain,
             sp.spmm_ell_dense_cuda),
            ("spmm_ell_naive", "naive", sp.spmm_ell_naive_plain,
             sp.spmm_ell_naive_cuda)):
        want = plain(r_ids[:rows], r_w[:rows], z1)
        err = (d_sp[mode][:rows] - want).abs()
        if not bool((err <= 1e-5 + 1e-5 * want.abs()).all()):
            fail(f"{name}: |dD| exceeds 1e-5 + 1e-5*|D| on the first {rows} "
                 f"rows (max {err.max().item()})")
        # B6a reads every id; B6b, as B2, needs the ids of nonzero slots only
        ids_bytes = n * h1 * 4 if mode == "dense" else nnz * 4
        bnd, by = bound_ms(n * h1 * 4 + ids_bytes + v_e * b * 4 + n * b * 4,
                           2.0 * nnz * b)
        report[name] = dict(
            max_abs_err=err.max().item(),
            tol=f"1e-5 + 1e-5*|D| (first {rows} rows)",
            ms=time_ms(lambda: cuda(r_ids, r_w, z1)),
            plain_ms=time_ms(lambda: plain(r_ids, r_w, z1), 1, warm=False),
            library_ms=time_ms(lambda: torch.sparse.mm(csr, z1)),
            bound_ms=bnd, bound_by=by, launches=launches.get(name, 0))
        del want, err
        log(f"kernel {name}: max |dD| {report[name]['max_abs_err']:.3e} within "
            f"1e-5 + 1e-5*|D| on the first {rows} rows")
    blocked = d_sp["blocked"]
    e_nb = (d_sp["naive"] - blocked).abs().max().item()
    if not torch.equal(d_sp["naive"], blocked):
        fail(f"spmm_ell_naive: not bit-equal to the blocked kernel (max |dD| "
             f"{e_nb})")
    e_db = (d_sp["dense"] - blocked).abs()
    if not bool((e_db <= 1e-5 + 1e-5 * blocked.abs()).all()):
        fail(f"spmm_ell_dense: differs from the blocked kernel by "
             f"{e_db.max().item()} > 1e-5 + 1e-5*|D|")
    log(f"all {n} rows: naive bit-equal to blocked, dense vs blocked "
        f"{e_db.max().item():.3e} (<= 1e-5 + 1e-5*|D|)")
    del csr, d_sp, e_db
    report["spmm_ell_naive"]["shapes"] = naive_shapes(docs, v, r_ids, r_w, z1)

    # --- streaming LC-RWMD against one_sided; B5 against its plain version ---
    d1 = engine.one_sided(q)
    for name, d in (("kernel", d_kernel), ("scan", d_scan)):
        if tuple(d.shape) != (n, b) or not bool(torch.isfinite(d).all()):
            fail(f"lc_rwmd_streaming(fuse={name!r}): bad shape or non-finite")
        if not torch.allclose(d, d1, rtol=1e-4, atol=gram_atol):
            fail(f"lc_rwmd_streaming(fuse={name!r}) differs from one_sided by "
                 f"{(d - d1).abs().max().item()} (rtol 1e-4, atol "
                 f"{gram_atol:.3e})")
    # B2 inside the "scan" call: its launches and device time there
    before = _build.LAUNCHES["spmm_ell"]
    _, dev_us, b2_us, _ = profile_one(lambda: lc_rwmd_streaming(
        docs, q, emb, vocab_chunk=VOCAB_CHUNK, fuse="scan"), "spmm_ell_kernel")
    n_b2 = _build.LAUNCHES["spmm_ell"] - before
    report["spmm_ell"]["scan_call"] = dict(
        launches=n_b2, device_ms=dev_us / 1e3, spmm_ell_ms=b2_us / 1e3,
        ms_per_chunk=b2_us / 1e3 / max(n_b2, 1))
    log(f"spmm_ell in lc_rwmd_streaming(fuse='scan'): {n_b2} launches, "
        f"{b2_us / 1e3:.3f} of {dev_us / 1e3:.3f} device ms (torch.profiler), "
        f"{b2_us / 1e3 / max(n_b2, 1):.4f} ms a chunk")
    log(f"lc_rwmd_streaming: kernel and scan within rtol 1e-4, atol "
        f"{gram_atol:.3e} (gram floor) of one_sided over all {n} rows (max |dD| "
        f"{(d_kernel - d1).abs().max().item():.3e} / "
        f"{(d_scan - d1).abs().max().item():.3e})")
    del d_kernel, d_scan, d1
    # B5 on chunk 0 and on a mid-vocabulary chunk, each held against its
    # plain version; a launch over one doc row times Z alone, the rest of a
    # chunk's time is the consume
    vc = VOCAB_CHUNK
    r_ids0, r_w0 = docs.ids, docs.weights
    chunks = {"chunk0": 0, "mid": (v // vc // 2) * vc}
    r5 = report["fused_chunk"] = dict(library_ms=None,
                                      launches=launches.get("fused_chunk", 0))
    for name, lo in chunks.items():
        e_c = emb[lo:lo + vc].contiguous()
        d_k = fs.fused_chunk_cuda(e_c, t_q, valid, r_ids0, r_w0, lo,
                                  torch.zeros(n, b, device=dev))
        d_p = fs.fused_chunk_plain(e_c, t_q, valid, r_ids0[:rows], r_w0[:rows],
                                   lo, torch.zeros(rows, b, device=dev))
        err5 = (d_k[:rows] - d_p).abs()
        if not bool((err5 <= gram_atol + 1e-4 * d_p.abs()).all()):
            fail(f"fused_chunk ({name}, ids {lo}..{lo + vc}): |dD| exceeds "
                 f"{gram_atol:.3e} + 1e-4*|D| on the first {rows} rows (max "
                 f"{err5.max().item()})")
        inb = (r_w0 > 0) & (r_ids0 >= lo) & (r_ids0 < lo + vc)
        hit_rows = int(inb.any(dim=1).sum().item())
        nnz_c = int(inb.sum().item())
        # bytes: every id once (to find the chunk's slots), the weights of
        # the slots found, D read and written on the rows they sit in, the
        # chunk's rows and the queries; operations: Z over the valid words
        # and the slots' products
        bnd, by = bound_ms(4 * (vc * m + b * h2 * m + b * h2) + n * h1 * 4
                           + nnz_c * 4 + hit_rows * b * 8,
                           2.0 * vc * m * n_valid_q + 2.0 * nnz_c * b)
        scratch = torch.zeros(n, b, device=dev)
        one = torch.zeros(1, b, device=dev)
        ms = time_ms(lambda: fs.fused_chunk_cuda(e_c, t_q, valid, r_ids0, r_w0,
                                                 lo, scratch), 10)
        z_ms = time_ms(lambda: fs.fused_chunk_cuda(
            e_c, t_q, valid, r_ids0[:1], r_w0[:1], lo, one), 10)
        # the two launches by name (torch.profiler, five chunk calls): the
        # one-row launch above also stages Z into every SM's shared memory
        _, dev_us, z_us, top = profile_one(lambda: [fs.fused_chunk_cuda(
            e_c, t_q, valid, r_ids0, r_w0, lo, scratch) for _ in range(5)],
            "chunk_z_kernel")
        cons_us = sum(us for us, key, _ in top if "chunk_consume" in key)
        out = dict(max_abs_err=err5.max().item(), ms=ms, z_ms=z_ms,
                   consume_ms=ms - z_ms, bound_ms=bnd, bound_by=by,
                   rows_hit=hit_rows, nnz=nnz_c, lo=lo,
                   profiled_ms=dict(device=dev_us / 5e3, z=z_us / 5e3,
                                    consume=cons_us / 5e3))
        if name == "chunk0":
            out["plain_ms"] = time_ms(lambda: fs.fused_chunk_plain(
                e_c, t_q, valid, r_ids0, r_w0, lo, scratch), 1)
            out["tol"] = (f"{gram_atol:.3e} (gram floor) + 1e-4*|D| (chunks "
                          f"{chunks}, first {rows} rows)")
            r5.update(out)
        else:
            r5[name] = out
        log(f"kernel fused_chunk {name} (ids {lo}..{lo + vc}): max |dD| "
            f"{out['max_abs_err']:.3e} within {gram_atol:.3e} + 1e-4*|D| ({nnz_c} "
            f"slots in {hit_rows} rows); {ms:.4f} ms a chunk, Z alone (one doc "
            f"row) {z_ms:.4f} ms, the consume {ms - z_ms:.4f} ms; by kernel "
            f"(torch.profiler) Z {z_us / 5e3:.4f} ms, consume "
            f"{cons_us / 5e3:.4f} ms of {dev_us / 5e3:.4f} device ms; {by} "
            f"bound {bnd:.4f} ms")
        del d_k, d_p, err5, scratch, inb

    # --- B7: the quadratic RWMD ---
    if tuple(d_quad.shape) != (n, b) or not bool(torch.isfinite(d_quad).all()):
        fail("rwmd_pairwise: bad shape or non-finite values")
    head = docs[:rows]
    want7 = rw.rwmd_pairwise_plain(emb, head.ids, head.weights, q.ids,
                                   q.weights)
    err7 = (d_quad[:rows] - want7).abs()
    if not bool((err7 <= gram_atol + 1e-4 * want7.abs()).all()):
        fail(f"rwmd_pairwise: |dRWMD| exceeds {gram_atol:.3e} + 1e-4*|RWMD| on "
             f"the first {rows} docs (max {err7.max().item()})")
    core7 = trw.rwmd_many_vs_many(head, q, emb, query_chunk=RWMD_QUERY_CHUNK)
    if not torch.allclose(d_quad[:rows], core7, rtol=1e-4, atol=gram_atol):
        fail(f"rwmd_pairwise differs from core/rwmd.rwmd_many_vs_many by "
             f"{(d_quad[:rows] - core7).abs().max().item()} (rtol 1e-4, "
             f"atol {gram_atol:.3e})")
    if not bool((d_quad >= d_quad.new_zeros(())).all()):
        fail("rwmd_pairwise: negative distances")
    n1 = float((docs.weights > 0).sum().item())
    flop7 = 2.0 * m * n1 * n_valid_q   # the products over the valid words
    bnd, by = bound_ms(4 * v * m + n * h1 * 8 + b * h2 * 8 + n * b * 4, flop7)
    report["rwmd_pairwise"] = dict(
        max_abs_err=err7.max().item(),
        tol=f"{gram_atol:.3e} (gram floor) + 1e-4*|RWMD| (first {rows} docs)",
        ms=time_ms(lambda: rw.rwmd_pairwise_cuda(
            emb, docs.ids, docs.weights, q.ids, q.weights), 1, warm=False),
        plain_ms=time_ms(lambda: rw.rwmd_pairwise_plain(
            emb, docs.ids, docs.weights, q.ids, q.weights), 1, warm=False),
        library_ms=None, bound_ms=bnd, bound_by=by,
        launches=launches.get("rwmd_pairwise", 0))
    r7 = report["rwmd_pairwise"]
    r7["tflops"] = flop7 / r7["ms"] / 1e9
    log(f"kernel rwmd_pairwise: max |dRWMD| {err7.max().item():.3e} within "
        f"{gram_atol:.3e} + 1e-4*|RWMD| of its plain version; max "
        f"{(d_quad[:rows] - core7).abs().max().item():.3e} from "
        f"rwmd_many_vs_many on the first {rows} docs; {r7['ms']:.1f} ms, "
        f"{r7['tflops']:.1f} TFLOP/s over the valid words ({flop7:.3e} FLOP), "
        f"{bnd / r7['ms']:.3f} of its {by} bound {bnd:.1f} ms")
    del want7, err7, core7, head
    # Docs and queries of Table IV set 1's h_max (160 words, more than one
    # 128-row tile of the kernel) on the same vocabulary.
    g1 = torch.Generator(device=dev).manual_seed(1)
    ids160 = torch.randint(0, v, (SET1_DOCS + SET1_QUERIES, SET1_H), device=dev,
                           generator=g1, dtype=torch.int32)
    w160 = torch.rand(ids160.shape, device=dev, generator=g1)
    w160 = w160 * (torch.rand(ids160.shape, device=dev, generator=g1) > 0.2)
    w160 = w160 / w160.sum(1, keepdim=True)
    args160 = (emb, ids160[:SET1_DOCS], w160[:SET1_DOCS],
               ids160[SET1_DOCS:], w160[SET1_DOCS:])
    got160 = rw.rwmd_pairwise_cuda(*args160)
    want160 = rw.rwmd_pairwise_plain(*args160)
    err160 = (got160 - want160).abs()
    if not bool((err160 <= gram_atol + 1e-4 * want160.abs()).all()):
        fail(f"rwmd_pairwise at h = {SET1_H}: |dRWMD| exceeds {gram_atol:.3e} "
             f"+ 1e-4*|RWMD| (max {err160.max().item()})")
    log(f"kernel rwmd_pairwise at h = {SET1_H} ({SET1_DOCS} docs x "
        f"{SET1_QUERIES} queries): max |dRWMD| {err160.max().item():.3e} "
        f"within {gram_atol:.3e} + 1e-4*|RWMD| of its plain version")
    del ids160, w160, args160, got160, want160, err160

    # --- WMD baselines on the cascade's pairs ---
    norm2 = float((t1 * t1).sum(2).amax() + (t2 * t2).sum(2).amax())
    atol4 = math.sqrt(2.0 ** -23 * norm2)
    e_rerank = (wmd_b - wmd_k).abs().max().item()   # reported, see WMD_CHECK_KW
    chk_k, it_k = sk.sinkhorn(t1, w1, t2, w2, **WMD_CHECK_KW)
    res_b = twmd.sinkhorn_log_batched(
        w1, w2, pair_dists(emb[ids1.long()], emb[ids2.long()]), **WMD_CHECK_KW)
    conv = (it_k < WMD_CHECK_KW["max_iters"]) & (
        res_b.n_iters < WMD_CHECK_KW["max_iters"])
    conv_share = float(conv.float().mean())
    err_all = (res_b.cost - chk_k).abs()
    err = err_all[conv]
    if conv_share < WMD_CONVERGED_MIN_SHARE:
        fail(f"WMD check: only {conv_share:.3f} of the pairs converged in both "
             f"solvers at {WMD_CHECK_KW}")
    if not bool((err <= atol4 + 1e-4 * chk_k[conv].abs()).all()):
        fail(f"wmd_batched (sinkhorn_log_batched) differs from the "
             f"Sinkhorn-WMD kernel by {err.max().item()} > {atol4:.3e} + "
             f"1e-4*|WMD| on converged pairs at {WMD_CHECK_KW}")
    sub = docs[cand.indices[0].long()]
    ovm_chk = twmd.wmd_one_vs_many(sub, q.ids[0], q.weights[0], emb,
                                   **WMD_CHECK_KW)
    c32 = conv[:K_CAND]
    e_ovm = (ovm_chk - chk_k[:K_CAND]).abs()[c32]
    if not bool((e_ovm <= atol4 + 1e-4 * chk_k[:K_CAND][c32].abs()).all()):
        fail(f"wmd_one_vs_many differs from the kernel by {e_ovm.max().item()} "
             f"on converged pairs at {WMD_CHECK_KW}")
    torch.cuda.synchronize()
    t_ovm = time.perf_counter()
    twmd.wmd_one_vs_many(sub, q.ids[0], q.weights[0], emb, **KW_RERANK)
    torch.cuda.synchronize()
    ovm_ms = (time.perf_counter() - t_ovm) * 1e3 / sub.n_docs
    gaps = []
    for i in range(N_LP):
        c = dists(emb[ids1[i].long()], emb[ids2[i].long()])
        gaps.append(float(wmd_k[i]) - twmd.emd_exact_lp(w1[i], w2[i], c))
    if not all(math.isfinite(g) for g in gaps):
        fail("emd_exact_lp: non-finite gap")
    batched_ms = wall_ms(lambda: twmd.wmd_batched(ids1, w1, ids2, w2, emb,
                                                  **KW_RERANK), 1)
    log(f"WMD on {flat.numel()} pairs at {WMD_CHECK_KW}: {conv_share:.3f} "
        f"converged in both; there sinkhorn_log_batched vs kernel max |dWMD| "
        f"{err.max().item():.3e}, wmd_one_vs_many vs kernel "
        f"{e_ovm.max().item() if e_ovm.numel() else 0.0:.3e} (<= {atol4:.3e} "
        f"+ 1e-4*|WMD|); over all pairs {err_all.max().item():.3e}; at "
        f"the rerank's {KW_RERANK} (not converged, reported only): "
        f"{e_rerank:.3e}; wmd_one_vs_many {ovm_ms:.2f} ms per pair over "
        f"{sub.n_docs} pairs; kernel - exact EMD over {N_LP} pairs: max |gap| "
        f"{max(abs(g) for g in gaps):.3e}, mean {sum(gaps) / N_LP:.3e}")
    log(f"comparison checks: {time.perf_counter() - t_phase:.1f} s")

    # --- the paper's comparison: quadratic RWMD against LC-RWMD ---
    budget = min(4 * K_FINAL, n)
    comp = dict(
        quadratic_rwmd_ms=report["rwmd_pairwise"]["ms"],
        one_sided_ms=wall_ms(lambda: engine.one_sided(q)),
        streaming_kernel_ms=wall_ms(lambda: lc_rwmd_streaming(
            docs, q, emb, vocab_chunk=VOCAB_CHUNK, fuse="kernel"), 2),
        streaming_scan_ms=wall_ms(lambda: lc_rwmd_streaming(
            docs, q, emb, vocab_chunk=VOCAB_CHUNK, fuse="scan"), 2),
        symmetric_topk_ms=wall_ms(lambda: engine.symmetric_topk_streaming(
            q, budget), 1),
        sinkhorn_batched_ms=batched_ms,
        sinkhorn_kernel_ms=report["sinkhorn_wmd"]["ms"],
        wmd_one_vs_many_ms_per_pair=ovm_ms,
        emd_gap_max=max(abs(g) for g in gaps), emd_gap_mean=sum(gaps) / N_LP,
        wmd_batched_vs_kernel_converged=err.max().item(),
        wmd_converged_share=conv_share,
        wmd_batched_vs_kernel_all=err_all.max().item(),
        wmd_batched_vs_kernel_rerank=e_rerank,
        symmetric_budget=budget)
    for key in ("one_sided", "streaming_kernel", "streaming_scan",
                "symmetric_topk"):
        comp[f"quadratic_over_{key}"] = comp["quadratic_rwmd_ms"] / comp[f"{key}_ms"]
    torch.cuda.empty_cache()
    return comp


def profile_calls(calls: dict) -> dict:
    """Device time by kernel name and the device's busy share per call.

    ``torch.profiler`` (CUPTI) over one call each, after warm-up.  Busy
    share = summed kernel time / host wall time of the call; overlapping
    kernels would count twice (these calls run on one stream).
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_PAD_S)
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # operator rows repeat their kernels' device time
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        htod = sum(c for _, k, c in rows if "HtoD" in k)
        out[name] = dict(
            wall_ms=wall_us / 1e3,
            device_busy_share=busy / wall_us if rows else None,
            htod_copies=htod,
            top=[dict(name=k[:80], device_ms=d / 1e3, count=c)
                 for d, k, c in rows[:6]])
        log(f"profile {name}: wall {wall_us / 1e3:.2f} ms, device busy share "
            + (f"{busy / wall_us:.3f}" if rows else "not measured (no device time)")
            + f"; {htod} host-to-device copies; " + ", ".join(
                f"{k[:40]} {d / 1e3:.2f} ms x{c}" for d, k, c in rows[:4]))
    return out


def small_phase():
    """A small corpus on the card (kernels) and on the CPU (plain versions)."""
    import torch

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.core.pipeline import pruned_wmd_topk
    from repro_torch.data.synth import CorpusSpec, make_corpus

    c = make_corpus(CorpusSpec(n_docs=2048, vocab_size=4096, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=16, seed=1),
                    device="cpu")
    eng_c = LCRWMDEngine(c.docs, c.emb, device="cpu")
    eng_g = LCRWMDEngine(c.docs, c.emb, device="cuda")
    q = c.docs[:16]
    # Near-zero distances carry the gram form's cancellation noise,
    # ~sqrt(eps_f32 * |e|^2), in both versions; that sets the absolute floor.
    emax2 = float((eng_c.emb_full ** 2).sum(1).max())
    atol = 4.0 * math.sqrt(2.0 ** -23 * emax2)
    for name in ("one_sided", "symmetric"):
        a = getattr(eng_g, name)(q).cpu()
        b = getattr(eng_c, name)(q)
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1e-4, atol=atol):
            fail(f"small {name}: card and CPU differ by {(a - b).abs().max()}")
    for name in ("topk_streaming", "symmetric_topk_streaming"):
        a = getattr(eng_g, name)(q, 10)
        b = getattr(eng_c, name)(q, 11)
        check_topk(f"small {name}", a.dists.cpu(), a.indices.cpu(),
                   b.dists, b.indices, atol)
    cand = eng_c.topk_streaming(q, 16)
    a = eng_g.rerank_topk(q, cand.indices, 5, sinkhorn_kw=KW_RERANK)
    b = eng_c.rerank_topk(q, cand.indices, 5, sinkhorn_kw=KW_RERANK)
    if not torch.allclose(a.dists.cpu(), b.dists, rtol=1e-4, atol=atol):
        fail("small rerank_topk: card and CPU differ")
    ra = pruned_wmd_topk(c.docs, q, c.emb, k=5, engine=eng_g, sinkhorn_kw=KW_RERANK)
    rb = pruned_wmd_topk(c.docs, q, c.emb, k=5, engine=eng_c, sinkhorn_kw=KW_RERANK)
    if not torch.allclose(ra.topk.dists.cpu(), rb.topk.dists, rtol=1e-4, atol=atol):
        fail("small pruned_wmd_topk: card and CPU differ")
    if not bool((ra.topk.indices[:, 0].cpu() == torch.arange(16)).all()):
        fail("small pruned_wmd_topk: a query's top-1 is not itself")
    from repro_torch.core.lc_rwmd import lc_rwmd_streaming
    from repro_torch.kernels import ops

    qg, eg = q.to("cuda"), eng_g.emb_full
    want = eng_c.one_sided(q)
    for fuse in ("kernel", "scan"):
        a = lc_rwmd_streaming(eng_g.resident, qg, eg, vocab_chunk=VOCAB_CHUNK,
                              fuse=fuse).cpu()
        if not torch.allclose(a, want, rtol=1e-4, atol=atol):
            fail(f"small lc_rwmd_streaming({fuse}): card and CPU differ by "
                 f"{(a - want).abs().max()}")
    a = ops.rwmd_pairwise(eg, eng_g.resident.ids, eng_g.resident.weights,
                          qg.ids, qg.weights).cpu()
    b = ops.rwmd_pairwise(eng_c.emb_full, c.docs.ids, c.docs.weights, q.ids,
                          q.weights)
    if not torch.allclose(a, b, rtol=1e-4, atol=atol):
        fail(f"small rwmd_pairwise: card and CPU differ by {(a - b).abs().max()}")
    log(f"small (n=2048, m=300, atol {atol:.3f}): one_sided, symmetric, "
        "topk_streaming, symmetric_topk_streaming, rerank_topk, "
        "pruned_wmd_topk, lc_rwmd_streaming (kernel, scan) and rwmd_pairwise "
        "agree with the CPU plain versions")
    small_serve_phase(c, eng_c, eng_g, q, atol)


def small_serve_phase(c, eng_c, eng_g, q, atol):
    """The segmented engine and the serve step at the small size: card
    against CPU, ids equal where the gaps are clear, values within atol."""
    import torch

    from repro_torch.core.lc_rwmd import SegmentedEngine
    from repro_torch.distributed.lcrwmd_dist import (build_allpairs_d1,
                                                     build_serve_step)

    dead = list(range(100, 1800, 29)) + [14, 15]
    engines = []
    for dev in ("cpu", "cuda"):
        e = SegmentedEngine(c.docs[:1800], c.emb, device=dev)
        e.append(c.docs[1800:1900])
        e.append(c.docs[1900:])
        e.delete(dead)
        engines.append(e)
    sc, sg = engines
    for name, k in (("topk_streaming", 10), ("symmetric_topk_streaming", 10)):
        a = getattr(sg, name)(q, k)
        b = getattr(sc, name)(q, k + 1)
        check_topk(f"small segmented {name}", a.dists.cpu(), a.indices.cpu(),
                   b.dists, b.indices, atol)
    for name in ("one_sided", "symmetric"):
        a = getattr(sg, name)(q).cpu()
        b = getattr(sc, name)(q)
        if not torch.allclose(a, b, rtol=1e-4, atol=atol):
            fail(f"small segmented {name}: card and CPU differ")
    cand = sc.topk_streaming(q, 16).indices
    a = sg.rerank_topk(q, cand, 5, sinkhorn_kw=KW_RERANK)
    b = sc.rerank_topk(q, cand, 5, sinkhorn_kw=KW_RERANK)
    if not torch.allclose(a.dists.cpu(), b.dists, rtol=1e-4, atol=atol):
        fail("small segmented rerank_topk: card and CPU differ")
    kw = dict(refine=True, rerank_wmd=True, rerank_budget=16,
              wmd_kw=KW_RERANK, bf16_matmul=False)
    ids = torch.arange(16, dtype=torch.int32)
    for self_exclude in (False, True):
        x = dict(query_ids=ids) if self_exclude else {}
        xg = dict(query_ids=ids.cuda()) if self_exclude else {}
        for tier in (1, 2, 0):
            a = build_serve_step(engine=sg, k=5, self_exclude=self_exclude,
                                 **kw)(q, tier=tier, **xg).topk
            b = build_serve_step(engine=sc, k=6 if tier else 5,
                                 self_exclude=self_exclude, **kw)(
                q, tier=tier, **x).topk
            if tier:
                check_topk(f"small serve tier {tier}", a.dists.cpu(),
                           a.indices.cpu(), b.dists, b.indices, atol)
                continue
            # the rerank's inputs are the 16 candidates: compare the queries
            # whose candidate sets agree (near ties at the cutoff may not)
            cg, cc = (build_serve_step(engine=e, k=16, self_exclude=self_exclude,
                                       **kw)(q, tier=1, **xx).topk.indices.cpu()
                      for e, xx in ((sg, xg), (sc, x)))
            same = torch.tensor([set(u.tolist()) == set(v.tolist())
                                 for u, v in zip(cg, cc)])
            if float(same.float().mean()) < 0.75 or not torch.allclose(
                    a.dists.cpu()[same], b.dists[same], rtol=1e-4, atol=atol):
                fail(f"small serve tier 0 (self_exclude {self_exclude}): "
                     f"card and CPU differ ({int(same.sum())} of 16 queries "
                     "with the same candidates)")
            if self_exclude and bool((a.indices.cpu() == ids[:, None]).any()):
                fail("small serve self_exclude: a query found itself")
    # the monolithic engine's materialized step and the engine-less step
    for label, (ga, ca) in {
            "streaming=False": (
                build_serve_step(engine=eng_g, k=7, streaming=False,
                                 bf16_matmul=False)(q),
                build_serve_step(engine=eng_c, k=8, streaming=False,
                                 bf16_matmul=False)(q)),
            "engine-less": (
                build_serve_step(k=7, bf16_matmul=False)(c.docs, q, c.emb),
                build_serve_step(k=8, bf16_matmul=False, device="cpu")(
                    c.docs, q, c.emb))}.items():
        check_topk(f"small serve {label}", ga.topk.dists.cpu(),
                   ga.topk.indices.cpu(), ca.topk.dists, ca.topk.indices, atol)
        if not torch.allclose(ga.d_local.cpu(), ca.d_local, rtol=1e-4,
                              atol=atol):
            fail(f"small serve {label}: d_local differs")
    a = build_allpairs_d1()(c.docs, q, c.emb).cpu()
    b = build_allpairs_d1(device="cpu")(c.docs, q, c.emb)
    if not torch.allclose(a, b, rtol=1e-4, atol=atol):
        fail("small build_allpairs_d1: card and CPU differ")
    log("small segmented engine (3 segments, "
        f"{len(dead)} deleted) and serve step (tiers 0-2, self_exclude, "
        "streaming=False, engine-less, build_allpairs_d1) agree with the "
        "CPU plain versions")


def flash_phase(frac: float, dev) -> dict:
    """B8 against its plain version on the card at llama3.2-1b's heads."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, s, hq, hkv, dh = FLASH_SHAPE
    odd = FLASH_ODD_LEN
    if frac < 1.0:                       # a rehearsal: shorter sequences
        s, odd = 1024, 1000
    g = torch.Generator(device=dev).manual_seed(13)

    def qkv(length, dtype, kv_length=None):
        t = length if kv_length is None else kv_length
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, length, hq, dh), (b, t, hkv, dh),
                                   (b, t, hkv, dh)))

    gaps = {}

    def check(label, q, k, v, causal):
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        if not bool(torch.isfinite(got).all()):
            fail(f"flash_attention {label}: non-finite values")
        err = (got.float() - want.float()).abs().max().item()
        if q.dtype == torch.float32:   # only the order of the sums differs
            if not err <= FLASH_F32_TOL:
                fail(f"flash_attention {label}: |dO| {err} > {FLASH_F32_TOL}")
            log(f"kernel flash_attention {label} {tuple(q.shape)} kv "
                f"{tuple(k.shape)}: max |dO| {err:.3e} within {FLASH_F32_TOL}")
            return err
        gap = fa.bf16_gap(got, want)
        gaps[label] = gap
        if not gap["ok"]:
            fail(f"flash_attention {label}: {gap} outside the bars (relative "
                 f"RMS {fa.BF16_REL_RMS_BAR}, row {fa.BF16_ROW_BAR})")
        log(f"kernel flash_attention {label} {tuple(q.shape)} kv "
            f"{tuple(k.shape)}: {json.dumps(gap)}")
        return err

    # p rounded to bf16: the probe's output is 0.99609375, not 1
    pq, pk, pv, pwant = fa.p_rounding_probe(device=dev)
    if not torch.equal(fa.flash_attention_cuda(pq, pk, pv, causal=False), pwant):
        fail("flash_attention: the p-rounding probe's output is not "
             f"{float(pwant[0, 0, 0, 0])}: p is not rounded to bf16")
    log("kernel flash_attention: the p-rounding probe gives "
        f"{float(pwant[0, 0, 0, 0])}, as the plain version")

    q16 = qkv(s, torch.bfloat16)
    err16 = check("bf16 causal", *q16, True)
    q32 = tuple(x.float() for x in q16)            # the same values in f32
    err32 = check("f32 causal", *q32, True)
    check("bf16 non-causal", *q16, False)
    check(f"bf16 causal at {odd} (not a tile multiple)", *qkv(odd, torch.bfloat16),
          True)
    # keys past T are absent (p = 0), not zero-filled keys: a ragged KV tail
    check(f"bf16 non-causal at S={odd}, T={s} (ragged KV tail)",
          *qkv(odd, torch.bfloat16, s), False)
    check(f"f32 non-causal at {odd}", *qkv(odd, torch.float32), False)

    flops = 2.0 * b * hq * s * s * dh                 # causal: the lower half
    io = 2 * b * s * (hq + hkv) * dh                  # q, k, v read, o written
    bnd16, by16 = bound_ms(io * 2, flops, BF16_FLOP_PER_S)
    bnd32, by32 = bound_ms(io * 4, flops)
    qt, kt, vt = (x.transpose(1, 2) for x in q16)     # SDPA's (B, H, S, dh)
    qt32, kt32, vt32 = (x.transpose(1, 2) for x in q32)
    ms16 = time_ms(lambda: fa.flash_attention_cuda(*q16, causal=True))
    ms32 = time_ms(lambda: fa.flash_attention_cuda(*q32, causal=True))
    # SDPA in float32 with TF32 off, as the port's precision rule (timed only)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sdpa32 = time_ms(lambda: F.scaled_dot_product_attention(
            qt32, kt32, vt32, is_causal=True, enable_gqa=True), 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    info = dict(
        shape=dict(b=b, s=s, t=s, hq=hq, hkv=hkv, dh=dh),
        bf16_causal_ms=ms16, f32_causal_ms=ms32,
        bf16_noncausal_ms=time_ms(lambda: fa.flash_attention_cuda(
            *q16, causal=False)),
        f32_plain_ms=time_ms(lambda: fa.flash_attention_plain(*q32, causal=True), 2),
        f32_bound_ms=bnd32, f32_bound_by=by32, f32_max_abs_err=err32,
        bf16_gaps=gaps,
        sdpa_bf16_causal_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        sdpa_f32_causal_ms=sdpa32,
        tflops_bf16=flops / ms16 / 1e9, tflops_f32=flops / ms32 / 1e9,
        cta_bytes=fa.flash_hbm_bytes(b, s, s, hq, hkv, dh))
    log("flash_attention: " + json.dumps(info))
    return {"flash_attention": dict(
        max_abs_err=err16,
        tol=(f"bf16: relative RMS <= {fa.BF16_REL_RMS_BAR} and |dO| <= "
             f"{fa.BF16_ROW_BAR} x its row's max |O|; f32: {FLASH_F32_TOL}"),
        ms=ms16, plain_ms=time_ms(lambda: fa.flash_attention_plain(
            *q16, causal=True), 2),
        bound_ms=bnd16, bound_by=by16, library_ms=info["sdpa_bf16_causal_ms"],
        info=info)}


def segment_phase(frac: float, dev) -> dict:
    """B9 through its entry point at the ogb_products cell's size."""
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import segment_spmm as sg

    n = max(int(OGB_NODES * frac), 4096)
    e = max(int(OGB_EDGES * frac), 4 * OGB_PAD_EDGES)
    d = OGB_FEAT
    g = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()
    # Edges as kernels_bench.py makes them (src uniform, dst sorted, rad
    # uniform in [0.1, 1)), with a share of rows that no edge reaches and
    # padding edges (rad 0) to the sink row n - 1.
    isolated = torch.rand(n - 1, generator=g, device=dev) < OGB_ISOLATED
    cand = (~isolated).nonzero()[:, 0].to(torch.int32)
    e_real = e - OGB_PAD_EDGES
    dst = cand[torch.randint(0, cand.numel(), (e_real,), generator=g, device=dev)]
    dst = torch.cat([torch.sort(dst).values,
                     torch.full((OGB_PAD_EDGES,), n - 1, dtype=torch.int32,
                                device=dev)])
    del cand
    src = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    rad = torch.rand(e, generator=g, device=dev) * 0.9 + 0.1
    rad[e_real:] = 0.0
    feat = torch.randn(n, d, generator=g, device=dev)
    torch.cuda.synchronize()
    log(f"graph: {n} nodes, {e} edges ({OGB_PAD_EDGES} padding), D={d}, in "
        f"{time.perf_counter() - t0:.1f} s")

    # the entry point, counts reset just before and read just after
    torch.cuda.synchronize()
    _build.reset_launches()
    out = ops.segment_spmm(src, dst, feat, rad, n)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["segment_spmm"]
    if launches < 1:
        fail("kernel segment_spmm was not launched by ops.segment_spmm")
    if tuple(out.shape) != (n, d) or not bool(torch.isfinite(out).all()):
        fail("segment_spmm: bad shape or non-finite values")
    if not bool((out[:-1][isolated] == 0).all()) or not bool((out[-1] == 0).all()):
        fail("segment_spmm: a row with no (weighted) edge is not 0")
    off = sg.row_offsets(dst, n)
    deg = off[1:] - off[:-1]
    plain = sg.segment_spmm_plain(src, dst, feat, rad, n)
    err = (out - plain).abs().max().item()
    if not err <= SEG_TOL:
        fail(f"segment_spmm: |dout| {err} > {SEG_TOL} against the plain version")
    del plain
    # Bit for bit against the plain version on the CPU, which adds in edge
    # order as the kernel does, on the first rows.
    rows = min(CHECK_ROWS, n)
    e_hi = int(off[rows])
    cpu = sg.segment_spmm_plain(src[:e_hi].cpu(), dst[:e_hi].cpu(), feat.cpu(),
                                rad[:e_hi].cpu(), rows)
    if not torch.equal(out[:rows].cpu(), cpu):
        fail(f"segment_spmm: the first {rows} rows differ from the CPU plain "
             f"version (max {(out[:rows].cpu() - cpu).abs().max().item()})")
    log(f"kernel segment_spmm: max |dout| {err:.3e} within {SEG_TOL} of the "
        f"plain version (atomics); the first {rows} rows equal the CPU plain "
        f"version bit for bit; max degree {int(deg.max())}, "
        f"{int((deg == 0).sum())} rows of degree 0")
    del cpu
    order = torch.argsort(dst.long() * n + src.long())
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(off.long(), src[order].long(), rad[order],
                                      size=(n, n))
    del order
    lib_err = (torch.sparse.mm(csr, feat) - out).abs().max().item()
    bnd, by = bound_ms(12.0 * e + 8.0 * n * d, 2.0 * e * d)
    rep = dict(
        max_abs_err=err, tol=f"{SEG_TOL} (plain version's atomics); first "
                             f"{rows} rows bit-equal to the CPU plain version",
        ms=time_ms(lambda: ops.segment_spmm(src, dst, feat, rad, n)),
        plain_ms=time_ms(lambda: sg.segment_spmm_plain(src, dst, feat, rad, n), 1),
        library_ms=time_ms(lambda: torch.sparse.mm(csr, feat)),
        bound_ms=bnd, bound_by=by, launches=launches)
    del csr
    # Witnesses of what the card gives gathers of these rows: a Triton
    # kernel that reads them in no order and sums them with no chain
    # (tools/gather_witness.py), the bare gather feat[src] (reads the rows,
    # writes them out in order), and embedding_bag's weighted sums of the
    # same rows by CSR row (the same function, its own order of work).
    sys.path.insert(0, str(ROOT / "tools"))
    import gather_witness

    # its first programs' sums against the rows', within 1e-5 of the sums
    # of their magnitudes
    k = min(e // gather_witness.BLOCK, 1 << 16)
    sums = gather_witness.gather_sum(src, feat)[:k].double()
    rows_k = feat[src[:k * gather_witness.BLOCK].long()].double().view(k, -1)
    if bool(((sums - rows_k.sum(1)).abs() > 1e-5 * rows_k.abs().sum(1)).any()):
        fail("gather witness: a program's sum is not its rows' sum")
    del sums, rows_k
    witness_ms = time_ms(lambda: gather_witness.gather_sum(src, feat))
    gather_ms = time_ms(lambda: feat.index_select(0, src), 2)

    def bag():
        return torch.nn.functional.embedding_bag(
            src, feat, off, mode="sum", per_sample_weights=rad,
            include_last_offset=True)

    bag_err = (bag() - out).abs().max().item()
    bag_ms = time_ms(bag)
    # A skewed degree distribution: one row (a hub) takes a contiguous 1% of
    # the sorted edges, which stay sorted.  Its sum is one warp's chain.
    k_hub = e // 100
    mid = e // 2
    dst_hub = dst.clone()
    dst_hub[mid - k_hub // 2: mid - k_hub // 2 + k_hub] = dst[mid]
    hub_ms = time_ms(lambda: ops.segment_spmm(src, dst_hub, feat, rad, n), 2)
    del dst_hub
    # Bytes: the feat rows gathered by edge, and the 32-byte sectors they
    # cover (a row at byte s * 4D spans its first to its last sector).
    row_b = 4 * d
    s64 = src.long() * row_b
    sectors = int(((s64 + row_b - 1) // 32 - s64 // 32 + 1).sum())
    del s64
    info = dict(n_nodes=n, n_edges=e, d=d, max_degree=int(deg.max()),
                degree0_rows=int((deg == 0).sum()),
                vector_width=sg.vector_width(d, feat.data_ptr(), out.data_ptr()),
                hub_edges=k_hub, hub_ms=hub_ms,
                gathered_gb=e * row_b / 1e9,
                gathered_tbps=e * row_b / 1e9 / rep["ms"],
                sector_gb=sectors * 32 / 1e9,
                sector_floor_ms=sectors * 32 / HBM_BYTES_PER_S * 1e3,
                witness_ms=witness_ms,
                witness_tbps=e * row_b / 1e9 / witness_ms,
                gather_ms=gather_ms,
                gather_tbps=2 * e * row_b / 1e9 / gather_ms,
                embedding_bag_ms=bag_ms,
                embedding_bag_tbps=e * row_b / 1e9 / bag_ms,
                embedding_bag_vs_kernel=bag_err,
                sparse_mm_vs_kernel=lib_err)
    log("segment_spmm: " + json.dumps(info))
    log(f"kernel segment_spmm: {rep['ms']:.3f} ms; gathers "
        f"{info['gathered_gb']:.2f} GB at {info['gathered_tbps']:.2f} TB/s, "
        f"{info['sector_gb']:.2f} GB in sectors: floor "
        f"{info['sector_floor_ms']:.3f} ms at the HBM rate; bound {bnd:.3f} ms "
        f"({by}, each input once); sparse.mm {rep['library_ms']:.3f} ms; "
        f"gather witness {witness_ms:.3f} ms ({info['witness_tbps']:.2f} TB/s "
        f"of rows); feat[src] {gather_ms:.3f} ms ({info['gather_tbps']:.2f} TB/s read "
        f"and written); embedding_bag {bag_ms:.3f} ms "
        f"({info['embedding_bag_tbps']:.2f} TB/s of rows); with one row of "
        f"{k_hub} edges (1%) {hub_ms:.3f} ms")
    # one kernel: a trace that holds it is whole, however short the call
    _, dev_us, top, launched = profile_whole(
        lambda: ops.segment_spmm(src, dst, feat, rad, n), "ops.segment_spmm",
        {"segment_spmm": ("segment_spmm_kernel",)}, busy=False)
    info["profile"] = dict(device_ms=dev_us / 1e3, top=[
        dict(name=k, device_ms=us / 1e3, count=c) for us, k, c in top[:4]])
    log(f"profile ops.segment_spmm: device {dev_us / 1e3:.3f} ms: " + ", ".join(
        f"{k[:50]} {us / 1e3:.3f} ms x{c}" for us, k, c in top[:4]))
    rep["info"] = info
    return {"segment_spmm": rep}


def llama_phase(frac: float, dev) -> dict:
    """llama3.2-1b serving at full width: a 32,768-token prefill through B8,
    then greedy decode steps; checks against the plain attention."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import model as TM
    from repro_torch.models.transformer.attention import gqa_attention

    cfg = get_spec("llama3.2-1b").model_cfg
    s_len = LM_PROMPT if frac >= 1.0 else 2048
    max_len = s_len + LM_DECODE
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in _leaves(params))
    log(f"llama3.2-1b: {n_par} parameters (f32, {n_par * 4 / 1e9:.2f} GB) from "
        f"a seeded generator in {time.perf_counter() - t0:.1f} s; prompt "
        f"{s_len}, batch 1, {LM_DECODE} decode steps")
    g = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (1, s_len), generator=g, device=dev)

    def decode(cache, nxt):
        out = []
        lg = None
        for _ in range(LM_DECODE):
            lg, cache = TM.decode_step(params, cache, nxt, cfg)
            nxt = lg[:, -1].argmax(dim=-1, keepdim=True)
            out.append(nxt)
        return lg, torch.cat(out, dim=1), cache

    # --- the main path, counts reset just before and read just after ---
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = TM.forward_with_cache(params, tokens, cfg, max_len)
    # A row's sum is finite exactly when all its logits are (|logit| << 1e33);
    # isfinite on the whole (1, S, V) tensor would take 21 GB of temporaries.
    if tuple(logits.shape) != (1, s_len, cfg.vocab_size) or not bool(
            torch.isfinite(logits.sum(dim=-1)).all()):
        fail("forward_with_cache: bad shape or non-finite logits")
    nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
    del logits
    lg, gen, cache = decode(cache, nxt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"llama3.2-1b main path launches: {launches} ({first_s:.1f} s, "
        f"peak {peak_gb:.2f} GB)")
    if launches.get("flash_attention", 0) != cfg.n_layers:
        fail(f"prefill launched flash_attention "
             f"{launches.get('flash_attention', 0)} times, not {cfg.n_layers}")
    if not bool(torch.isfinite(lg).all()) or int(cache.lengths[0]) != max_len:
        fail("decode_step: non-finite logits or a wrong cache length")
    del cache, lg

    # --- times: host clock around calls ending in a synchronize ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TM.forward_with_cache(params, tokens, cfg, max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
    del logits
    cache_p = TM.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, gen_a, _ = decode(cache, nxt)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
    del cache
    same = bool(torch.equal(gen_a, gen))
    log(f"decode: {decode_ms:.2f} ms a token (f32 weights, cast at each "
        f"product); the same tokens as the first run: {same}")
    int8 = int8_decode_check(TM, params, cfg, cache_p,
                             torch.cat([nxt, gen_a[:, :-1]], dim=1))

    # --- B8's share of the prefill (torch.profiler, one call) ---
    # Below full scale the prompt is 2,048 tokens and the prefill host-bound
    # (busy share under DROP_SHARE), so there only a kernel that ran and has
    # no time in the trace marks a lost trace.
    wall_us, dev_us, top, launched = profile_whole(
        lambda: TM.forward_with_cache(params, tokens, cfg, max_len),
        "prefill", {"flash_attention": ("flash_",)}, busy=s_len == LM_PROMPT)
    flash_us = sum(us for us, name, _ in top if "flash_tc_kernel" in name)
    if launched.get("flash_attention", 0) != cfg.n_layers or flash_us <= 0.0:
        # a whole trace: the attention ran, but not on the tensor-core kernel
        ran = [(name, c) for us, name, c in top if "flash_" in name]
        fail(f"prefill: a whole trace shows no flash_tc_kernel time; "
             f"flash_attention launched {launched.get('flash_attention', 0)} "
             f"times, as {ran}; by device time: {top[:8]}")
    # causal attention over the prompt, all layers: 2 * Hq * S^2 * dh each
    b8_tflops = (cfg.n_layers * 2.0 * cfg.n_heads * s_len * s_len * cfg.d_head
                 / (flash_us * 1e-6) / 1e12)
    log(f"prefill profile: wall {wall_us / 1e3:.1f} ms, device busy share "
        f"{dev_us / wall_us:.3f}; B8 (flash_tc_kernel) {flash_us / 1e3:.1f} ms, "
        f"{flash_us / dev_us:.3f} of device time, {b8_tflops} TFLOP/s at "
        f"S={s_len}")

    d_wall, d_dev, _, d_top = profile_one(
        lambda: TM.decode_step(params, cache_p, nxt, cfg), "flash_tc_kernel")
    del cache_p
    log(f"decode step profile: wall {d_wall / 1e3:.2f} ms, device busy share "
        f"{d_dev / d_wall:.3f}; " + ", ".join(
            f"{k[:40]} {u / 1e3:.3f} ms x{c}" for u, k, c in d_top[:4]))

    # --- B8 at the prefill's own shape: the last layer's q, k, v ---
    seen = {}
    flash = TM.flash_attention

    def capture(q, k, v, *, causal=True):   # each layer overwrites the last
        seen.update(q=q, k=k, v=v, o=flash(q, k, v, causal=causal))
        return seen["o"]

    with attention_swapped(TM, capture):
        TM.forward_with_cache(params, tokens, cfg, max_len)
    torch.cuda.synchronize()
    slices = {}
    for lo in (0, s_len // 2, s_len - LM_SLICE_ROWS):
        hi = lo + LM_SLICE_ROWS
        want = fa.flash_attention_plain(seen["q"][:, lo:hi], seen["k"][:, :hi],
                                        seen["v"][:, :hi], q_offset=lo)
        gap = fa.bf16_gap(seen["o"][:, lo:hi], want)
        slices[f"rows {lo}-{hi - 1}"] = gap
        if not gap["ok"]:
            fail(f"flash_attention at the prefill's shape "
                 f"{tuple(seen['q'].shape)}, rows {lo}-{hi - 1}: {gap} "
                 f"outside the bars")
        del want
    log(f"kernel flash_attention at the prefill's shape "
        f"{tuple(seen['q'].shape)} (layer {cfg.n_layers - 1}), rows against "
        f"the plain version over all their keys: {json.dumps(slices)}")
    del seen

    # --- checks against the plain attention, at LM_CHECK_LEN ---
    n4 = min(LM_CHECK_LEN, s_len)
    t4 = tokens[:, :n4]
    lf, _ = TM.forward_with_cache(params, t4, cfg, n4)

    def plain(q, k, v, *, causal=True):
        return gqa_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)

    with attention_swapped(TM, plain):
        lp, _ = TM.forward_with_cache(params, t4, cfg, n4)
    pre = _gap(lf, lp)
    if not pre["rel_rms"] <= LM_REL_RMS_BAR:
        fail(f"prefill with B8 vs plain attention at S={n4}: relative RMS gap "
             f"{pre['rel_rms']:.4f} > {LM_REL_RMS_BAR}")
    del lp
    _, c = TM.forward_with_cache(params, t4[:, :n4 - 1], cfg, n4)
    dec, _ = TM.decode_step(params, c, t4[:, n4 - 1:], cfg)
    dvp = _gap(dec[:, 0], lf[:, -1])
    if not dvp["rel_rms"] <= LM_REL_RMS_BAR:
        fail(f"decode after a prefill of {n4 - 1} vs forward_with_cache of {n4} "
             f"at the last position: relative RMS gap {dvp['rel_rms']:.4f} > "
             f"{LM_REL_RMS_BAR}")
    log(f"llama3.2-1b checks (bar: relative RMS {LM_REL_RMS_BAR}): prefill B8 vs "
        f"plain attention at S={n4} {json.dumps(pre)}; decode after {n4 - 1} vs "
        f"forward_with_cache({n4}) {json.dumps(dvp)}")
    del lf, c, dec
    torch.cuda.empty_cache()
    return dict(
        config=cfg.name, prompt=s_len, batch=1, decode_steps=LM_DECODE,
        reduced=["prefill batch 32 -> 1: forward_with_cache returns (B, S, V) "
                 "f32 logits, 16.8 GB a sequence at S = 32,768"],
        n_params=n_par, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
        decode_repeat_tokens_equal=same, main_path_s=first_s,
        peak_gb=peak_gb, launches=launches,
        prefill_profile=dict(
            wall_ms=wall_us / 1e3, device_busy_share=dev_us / wall_us,
            b8_share_of_device_time=flash_us / dev_us,
            b8_share_of_wall=flash_us / wall_us, b8_ms=flash_us / 1e3,
            b8_tflops=b8_tflops,
            top=[dict(name=k, device_ms=u / 1e3, count=c) for u, k, c in top[:6]]),
        decode_profile=dict(
            wall_ms=d_wall / 1e3, device_busy_share=d_dev / d_wall,
            top=[dict(name=k, device_ms=u / 1e3, count=c)
                 for u, k, c in d_top[:6]]),
        checks=dict(prefill_b8_vs_plain=pre, decode_vs_prefill=dvp,
                    rel_rms_bar=LM_REL_RMS_BAR, b8_at_prefill_shape=slices),
        int8_decode=int8, generated=gen[0, :8].tolist())


def int8_decode_check(TM, params, cfg, cache, toks) -> dict:
    """The int8 KV cache at the prefill's length: ``cache`` (batch 1)
    quantized by ``kv_quant.quantize_kv``; ``decode_step_quant`` beside
    ``decode_step`` on a copy of the fp cache, both fed the same tokens.
    Timed at batch 1, fed ``toks`` (1, n), after a warm-up step of each
    (host clock after a synchronize).  Held to the reference's bars over
    INT8_ROWS rows of the same cache, n steps each: row 0 fed ``toks``,
    the others seeded random tokens.  Returns ms a token for both, the
    caches' bytes, the gaps and each argmax flip with its fp margin."""
    import torch

    from repro_torch.models.transformer import kv_quant as KQ

    def quant(c):
        kq, ks = KQ.quantize_kv(c.k)
        vq, vs = KQ.quantize_kv(c.v)
        return KQ.QuantKVCache(kq, ks, vq, vs, c.lengths.clone())

    def fp_copy(c):
        return TM.KVCache(c.k.clone(), c.v.clone(), c.lengths.clone())

    def run(step, c, tk):
        out = []
        for i in range(tk.shape[1]):
            lg, c = step(params, c, tk[:, i:i + 1], cfg)
            out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    n = toks.shape[1]
    times = {}
    for name, step, make in (("fp", TM.decode_step, fp_copy),
                             ("int8", TM.decode_step_quant, quant)):
        step(params, make(cache), toks[:, :1], cfg)           # warm-up
        c = make(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(step, c, toks)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3 / n
        del c

    # the agreement sample: INT8_ROWS rows of the prefill's cache
    g = torch.Generator(device=toks.device).manual_seed(23)
    tk = torch.cat([toks, torch.randint(0, cfg.vocab_size, (INT8_ROWS - 1, n),
                                        generator=g, device=toks.device)])
    rows = TM.KVCache(cache.k.repeat(1, INT8_ROWS, 1, 1, 1),
                      cache.v.repeat(1, INT8_ROWS, 1, 1, 1),
                      cache.lengths.repeat(INT8_ROWS))
    qc = quant(cache)            # the rows' quantized cache: one row's, repeated
    qc = KQ.QuantKVCache(*(x.repeat(1, INT8_ROWS, *(1,) * (x.dim() - 2))
                           for x in qc[:4]), rows.lengths.clone())
    fp = run(TM.decode_step, rows, tk)
    del rows
    qq = run(TM.decode_step_quant, qc, tk)
    del qc
    d = qq - fp
    excess = (d.abs() - (INT8_ATOL + INT8_RTOL * fp.abs())).max()
    a_fp, a_q = fp.argmax(dim=-1), qq.argmax(dim=-1)
    top1 = float((a_q == a_fp).float().mean())
    rms = d.square().mean(dim=-1).sqrt()                     # (rows, n)
    top2 = fp.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                     # fp's top-1 margin
    # one bf16 step at the fp maximum: 2^(floor(log2 |top|) - 7)
    top = top2[..., 0]
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    gap = top - fp.gather(-1, a_q[..., None])[..., 0]
    top1_ties = float((gap <= ulp).float().mean())
    flips = [dict(row=r, step=t, fp_margin=float(gap[r, t]),
                  bf16_step=float(ulp[r, t]), rms_dlogit=float(rms[r, t]))
             for r, t in (a_q != a_fp).nonzero().tolist()]
    wide = [f for f in flips if f["fp_margin"] > INT8_FLIP_RMS * f["rms_dlogit"]]
    fp_bytes = (cache.k.numel() + cache.v.numel()) * cache.k.element_size()
    q_bytes = sum(x.numel() * x.element_size() for x in quant(cache)[:4])
    info = dict(steps=n, rows=INT8_ROWS, samples=INT8_ROWS * n,
                cache_len=int(cache.lengths[0]),
                fp_ms_per_token=times["fp"], int8_ms_per_token=times["int8"],
                fp_cache_gb=fp_bytes / 1e9, int8_cache_gb=q_bytes / 1e9,
                bytes_ratio=q_bytes / fp_bytes, max_abs=float(d.abs().max()),
                rms_dlogit=float(rms.mean()), top1_agree=top1,
                top1_agree_bf16_ties=top1_ties,
                fp_margin_median=float(margin.median()),
                share_margin_within_2rms=float((margin <= 2 * rms).float()
                                               .mean()),
                n_flips=len(flips), flips_by_fp_gap=dict(
                    exact_tie=sum(f["fp_margin"] == 0 for f in flips),
                    within_one_bf16_step=sum(
                        0 < f["fp_margin"] <= f["bf16_step"] for f in flips),
                    wider=sum(f["fp_margin"] > f["bf16_step"] for f in flips)),
                widest_flip_in_rms=max(
                    (f["fp_margin"] / f["rms_dlogit"] for f in flips),
                    default=0.0),
                flips=flips[:16], wide_flips=wide,
                worst_excess=float(excess),
                bars=dict(rtol=INT8_RTOL, atol=INT8_ATOL,
                          reference_top1=INT8_TOP1, top1_floor=INT8_TOP1_FLOOR,
                          flip_margin_rms=INT8_FLIP_RMS))
    log(f"{cfg.name} int8 KV cache: " + json.dumps(info))
    if not bool(torch.isfinite(qq).all()):
        fail(f"{cfg.name}: decode_step_quant gave non-finite logits")
    if not (float(excess) <= 0.0 and top1_ties >= INT8_TOP1
            and top1 >= INT8_TOP1_FLOOR and not wide):
        fail(f"{cfg.name}: decode_step_quant's logits outside the bars "
             f"against decode_step's: {info}")
    return info


def moe_mla_phase(frac: float, dev) -> dict:
    """grok-1 and deepseek-v2 at full width, one after the other (the
    first freed before the second): each ``moe_model_run``, then B8 at
    grok's heads and the MLA int8 decode check inside them."""
    import torch

    out = {}
    for arch, layers, prompt in MOE_MODELS:
        if frac < 1.0:                    # a rehearsal: shorter prompts
            prompt = 1024
        out[arch] = moe_model_run(arch, layers, prompt, dev)
        torch.cuda.empty_cache()
    return out


def _moe_params(arch: str, layers: int, dev):
    """The registered config at full width, cut to ``layers`` (prefix
    layers kept) with bf16 weights, and its seeded parameters."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models.transformer import model as TM

    cfg = dataclasses.replace(get_spec(arch).model_cfg, n_layers=layers,
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in _leaves(params))
    log(f"{arch}: {n_par} parameters (bf16, {n_par * 2 / 1e9:.2f} GB) in "
        f"{layers} layers from a seeded generator in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params, n_par


def moe_model_run(arch: str, layers: int, prompt: int, dev) -> dict:
    """One model's serving path at full width: a ``prompt``-token prefill
    and MOE_DECODE greedy steps with the counts reset just before and read
    just after, then times, a profile and the checks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import model as TM

    cfg, params, n_par = _moe_params(arch, layers, dev)
    gqa = cfg.attention == "gqa"
    max_len = prompt + MOE_DECODE
    g = torch.Generator(device=dev).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                           device=dev)

    def decode(cache, nxt):
        out = []
        for _ in range(MOE_DECODE):
            lg, cache = TM.decode_step(params, cache, nxt, cfg)
            nxt = lg[:, -1].argmax(dim=-1, keepdim=True)
            out.append(nxt)
        return lg, torch.cat(out, dim=1), cache

    # --- the main path, counts reset just before and read just after ---
    # (the routing recorded on the way: each MoE call's chosen experts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rec_p, rec_d = [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    with routing_recorded(rec_p):
        logits, cache = TM.forward_with_cache(params, tokens, cfg, max_len)
    if tuple(logits.shape) != (1, prompt, cfg.vocab_size) or not bool(
            torch.isfinite(logits.sum(dim=-1)).all()):
        fail(f"{arch} forward_with_cache: bad shape or non-finite logits")
    nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
    del logits
    with routing_recorded(rec_d):
        lg, gen, cache = decode(cache, nxt)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_b8 = cfg.n_layers if gqa else 0
    if launches.get("flash_attention", 0) != want_b8:
        fail(f"{arch} prefill launched flash_attention "
             f"{launches.get('flash_attention', 0)} times, not {want_b8}")
    if not bool(torch.isfinite(lg).all()) or int(cache.lengths[0]) != max_len:
        fail(f"{arch} decode_step: non-finite logits or a wrong cache length")
    drop = dict(prefill=_dropped_share(rec_p, cfg.moe),
                decode=_dropped_share(rec_d, cfg.moe))
    del rec_p, rec_d
    log(f"{arch} main path: launches {launches} ({main_s:.1f} s, peak "
        f"{peak_gb:.2f} GB); (token, choice) pairs dropped by capacity: "
        f"{json.dumps(drop)}")
    del cache, lg

    # --- times: host clock around calls ending in a synchronize ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TM.forward_with_cache(params, tokens, cfg, max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, gen_a, _ = decode(cache, nxt)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / MOE_DECODE
    same = bool(torch.equal(gen_a, gen))
    tflops = 2.0 * cfg.n_active_params * prompt / (prefill_ms * 1e-3) / 1e12
    log(f"{arch}: prefill {prompt} tokens {prefill_ms:.1f} ms "
        f"({tflops:.1f} TFLOP/s of 2 x {cfg.n_active_params} active "
        f"parameters a token), decode {decode_ms:.2f} ms a token; the same "
        f"tokens as the first run: {same}")

    # --- the device busy share of the prefill (torch.profiler) ---
    families = {"flash_attention": ("flash_",)} if gqa else {}
    wall_us, dev_us, top, launched = profile_whole(
        lambda: TM.forward_with_cache(params, tokens, cfg, max_len),
        f"{arch} prefill", families, busy=prompt >= 4096)
    flash_us = sum(us for us, name, _ in top if "flash_tc_kernel" in name)
    if gqa and flash_us <= 0.0:
        fail(f"{arch} prefill: a whole trace shows no flash_tc_kernel time; "
             f"by device time: {top[:8]}")
    log(f"{arch} prefill profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"share {dev_us / wall_us:.3f}; B8 {flash_us / 1e3:.2f} ms; by device "
        "time: " + ", ".join(f"{k[:40]} {u / 1e3:.2f} ms x{c}"
                             for u, k, c in top[:6]))

    # --- checks ---
    checks = {}
    # MOE_DV_STEPS decode steps after MOE_DV_LEN - MOE_DV_STEPS tokens
    # against forward_with_cache of MOE_DV_LEN at those positions.  A
    # group's capacity drops depend on its other tokens (a decode step is a
    # group of one token, never dropped), so here the capacity holds the
    # whole group in both paths.  The forward's routing is replayed in the
    # prefill and the steps (routing_replayed), so the bar sees the
    # attention paths' roundings; then the steps run again on their own
    # routing, whose flips against the forward's are held to MOE_FLIP_BAR.
    n = min(MOE_DV_LEN, prompt)
    m = n - MOE_DV_STEPS
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    rec = []
    with routing_recorded(rec):
        lf, _ = TM.forward_with_cache(params, tokens[:, :n], nodrop, n)
    lf = lf[:, m:]
    with routing_replayed([r[:, :m] for r in rec]):
        _, c0 = TM.forward_with_cache(params, tokens[:, :m], nodrop, n)

    def steps(replay):
        c, out, seen = TM.KVCache(c0.k.clone(), c0.v.clone(),
                                  c0.lengths.clone()), [], []
        for j in range(MOE_DV_STEPS):
            tk = tokens[:, m + j:m + j + 1]
            ctx = (routing_replayed([r[:, m + j:m + j + 1] for r in rec])
                   if replay else routing_recorded(seen))
            with ctx:
                lg, c = TM.decode_step(params, c, tk, nodrop)
            out.append(lg[:, 0])
        return torch.stack(out, dim=1), seen

    dec, _ = steps(True)
    checks["decode_vs_forward"] = dvf = dict(_gap(dec, lf), steps=MOE_DV_STEPS,
                                             first=_gap(dec[:, 0], lf[:, 0]))
    dec, seen = steps(False)
    # the steps' routing in call order: step j's MoE layers in turn
    n_moe = len(rec)
    want = [rec[i][:, m + j:m + j + 1] for j in range(MOE_DV_STEPS)
            for i in range(n_moe)]
    dvf["unreplayed"] = dict(_gap(dec, lf), flip_share=_flip_share(want, seen))
    del lf, c0, dec, seen, want
    if not dvf["rel_rms"] <= LM_REL_RMS_BAR:
        fail(f"{arch}: {MOE_DV_STEPS} decode steps after {m} tokens vs "
             f"forward_with_cache of {n} at their positions: relative RMS "
             f"{dvf['rel_rms']:.4f} > {LM_REL_RMS_BAR}")
    if not dvf["unreplayed"]["flip_share"] <= MOE_FLIP_BAR[arch]:
        fail(f"{arch}: the decode steps routed "
             f"{dvf['unreplayed']['flip_share']:.4f} of their (token, choice) "
             f"pairs to another expert than the forward did "
             f"(> {MOE_FLIP_BAR[arch]})")
    if gqa:
        checks.update(grok_b8_checks(TM, fa, params, cfg, tokens))
    else:
        checks["mla_int8"] = mla_int8_check(params, cfg, cache, tokens)
    del cache
    log(f"{arch} checks (bar: relative RMS {LM_REL_RMS_BAR}): "
        + json.dumps(checks))
    del params
    torch.cuda.empty_cache()
    return dict(
        config=cfg.name, source=("hf:xai-org/grok-1" if gqa
                                 else "arXiv:2405.04434"),
        layers=cfg.n_layers, prompt=prompt, batch=1, decode_steps=MOE_DECODE,
        reduced=[f"depth {get_spec(arch).model_cfg.n_layers} -> "
                 f"{cfg.n_layers}",
                 "param_dtype float32 -> bfloat16 (the reference's own "
                 "deviation for llama3-405b)",
                 "prefill batch -> 1"],
        n_params=n_par, n_active_params=cfg.n_active_params,
        prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
        decode_repeat_tokens_equal=same, prefill_tflops=tflops,
        main_path_s=main_s, peak_gb=peak_gb, launches=launches,
        dropped_share=drop,
        prefill_profile=dict(
            wall_ms=wall_us / 1e3, device_busy_share=dev_us / wall_us,
            b8_ms=flash_us / 1e3,
            top=[dict(name=k, device_ms=u / 1e3, count=c)
                 for u, k, c in top[:6]]),
        checks=checks, generated=gen[0, :8].tolist())


def grok_b8_checks(TM, fa, params, cfg, tokens) -> dict:
    """grok-1's prefill through B8 against the same through B8's plain
    version (B8's routing replayed; without, the share of routing flips is
    held to MOE_FLIP_BAR), and B8 at grok's heads (48 / 8, dh 128: two
    heads a CTA)
    against its plain version at the prefill's own q, k, v; B8 timed
    beside SDPA and its bound at MOE_B8_CHECK_LEN and the prompt's length."""
    import torch
    import torch.nn.functional as F

    out = {}
    n = min(MOE_SWAP_LEN, tokens.shape[1])
    rec, free = [], []
    with routing_recorded(rec):
        la, _ = TM.forward_with_cache(params, tokens[:, :n], cfg, n)
    with attention_swapped(TM, fa.flash_attention_plain), \
            routing_replayed(rec):
        lb, _ = TM.forward_with_cache(params, tokens[:, :n], cfg, n)
    out["prefill_b8_vs_plain"] = gap = _gap(la, lb)
    del lb
    with attention_swapped(TM, fa.flash_attention_plain), \
            routing_recorded(free):
        lb, _ = TM.forward_with_cache(params, tokens[:, :n], cfg, n)
    gap["unreplayed"] = dict(_gap(la, lb), flip_share=_flip_share(rec, free))
    del la, lb
    if not gap["rel_rms"] <= LM_REL_RMS_BAR:
        fail(f"{cfg.name}: prefill through B8 vs its plain version at S={n}: "
             f"relative RMS {gap['rel_rms']:.4f} > {LM_REL_RMS_BAR}")
    if not gap["unreplayed"]["flip_share"] <= MOE_FLIP_BAR[cfg.name]:
        fail(f"{cfg.name}: the prefill through B8's plain version routed "
             f"{gap['unreplayed']['flip_share']:.4f} of its (token, choice) "
             f"pairs to another expert than through B8 "
             f"(> {MOE_FLIP_BAR[cfg.name]})")

    # B8 at the prefill's own shape: the last layer's q, k, v
    n = min(MOE_B8_CHECK_LEN, tokens.shape[1])
    seen = {}
    flash = TM.flash_attention

    def capture(q, k, v, *, causal=True):
        seen.update(q=q, k=k, v=v, o=flash(q, k, v, causal=causal))
        return seen["o"]

    with attention_swapped(TM, capture):
        TM.forward_with_cache(params, tokens[:, :n], cfg, n)
    q, k, v = seen["q"], seen["k"], seen["v"]
    want = fa.flash_attention_plain(q, k, v)
    out["b8_vs_plain"] = b8 = fa.bf16_gap(seen["o"], want)
    del want
    if not b8["ok"]:
        fail(f"flash_attention at {cfg.name}'s prefill shape "
             f"{tuple(q.shape)}: {b8} outside the bars")
    log(f"kernel flash_attention at {cfg.name}'s prefill shape "
        f"{tuple(q.shape)} kv {tuple(k.shape)} (tiling "
        f"{fa.tiling(cfg.d_head, cfg.n_heads // cfg.n_kv_heads)}): "
        f"{json.dumps(b8)}")
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), 2)
    del seen

    def timed(s):
        g = torch.Generator(device=q.device).manual_seed(s)
        b, hq, hkv, dh = 1, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        qq, kk, vv = (torch.randn(shape, generator=g, device=q.device)
                      .to(torch.bfloat16)
                      for shape in ((b, s, hq, dh), (b, s, hkv, dh),
                                    (b, s, hkv, dh)))
        flops = 2.0 * b * hq * s * s * dh
        io = 2 * b * s * (hq + hkv) * dh
        bnd, by = bound_ms(io * 2, flops, BF16_FLOP_PER_S)
        ms = time_ms(lambda: fa.flash_attention_cuda(qq, kk, vv, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        return dict(s=s, ms=ms, sdpa_ms=sdpa, bound_ms=bnd, bound_by=by,
                    tflops=flops / ms / 1e9, bound_share=bnd / ms)

    shape = dict(b=1, hq=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.d_head,
                 gc=fa.tiling(cfg.d_head, cfg.n_heads // cfg.n_kv_heads)[1])
    times = [timed(s) for s in sorted({n, tokens.shape[1]})]
    out["b8_times"] = dict(shape=shape, plain_ms_at_check=plain_ms,
                           check_len=n, by_length=times)
    log(f"flash_attention at {cfg.name}'s heads: " + json.dumps(out["b8_times"]))
    return out


def mla_int8_check(params, cfg, cache, tokens) -> dict:
    """deepseek-v2's absorbed MLA decode on its first stacked layer:
    ``mla_attention_decode_quant`` on the prefill's latent quantized
    against ``mla_attention_decode`` on the fp latent, MLA_INT8_STEPS
    steps fed the prompt's embeddings, with the reference's bars."""
    import torch

    from repro_torch.models.transformer import kv_quant as KQ
    from repro_torch.models.transformer import mla as MLA
    from repro_torch.models.transformer.model import _layer, dtype_of

    i = len(params.get("prefix_layers", []))
    attn = _layer(params["layers"], 0)["attn"]
    c_kv, k_rope = cache.k[i, :, :], cache.v[i, :, :]
    fp = MLA.MLACache(c_kv.clone(), k_rope.clone())
    c_q, c_s = KQ.quantize_kv(c_kv)
    k_r = k_rope.clone()
    # the steps rewrite the prompt's last MLA_INT8_STEPS positions
    lengths = cache.lengths.clone() - MLA_INT8_STEPS
    worst, dmax = -1.0, 0.0
    for j in range(MLA_INT8_STEPS):
        x = params["embed"][tokens[:, j:j + 1]].to(dtype_of(cfg.dtype))
        a_fp, fp = MLA.mla_attention_decode(attn, x, cfg, fp, lengths)
        a_q, (c_q, c_s, k_r) = MLA.mla_attention_decode_quant(
            attn, x, cfg, c_q, c_s, k_r, lengths)
        d = (a_q.float() - a_fp.float()).abs()
        worst = max(worst, float(
            (d - (MLA_INT8_ATOL + MLA_INT8_RTOL * a_fp.float().abs())).max()))
        dmax = max(dmax, float(d.max()))
        lengths = lengths + 1
    info = dict(layer=i, steps=MLA_INT8_STEPS,
                start_len=int(cache.lengths[0]) - MLA_INT8_STEPS,
                max_abs=dmax, worst_excess=worst,
                bars=dict(rtol=MLA_INT8_RTOL, atol=MLA_INT8_ATOL))
    if not worst <= 0.0:
        fail(f"{cfg.name}: mla_attention_decode_quant outside the reference's "
             f"bars against mla_attention_decode: {info}")
    return info


@contextlib.contextmanager
def routing_recorded(out: list):
    """Each ``moe.route`` call's chosen experts (G, n, k) appended to
    ``out``, in call order."""
    from repro_torch.models.transformer import moe as MOE

    orig = MOE.route

    def record(xt, router, moe):
        probs, top_p, top_i = orig(xt, router, moe)
        out.append(top_i)
        return probs, top_p, top_i

    MOE.route = record
    try:
        yield
    finally:
        MOE.route = orig


@contextlib.contextmanager
def routing_replayed(choices):
    """Each ``moe.route`` call takes the next of ``choices`` (G, n, k) as
    its experts, their weights this call's probabilities at them,
    renormalised.  A bf16 difference upstream can flip a token's expert
    choice (routing is a step function of the router's input), and a
    flip moves other tokens' capacity slots; with the routing replayed, two
    paths differ only by their roundings."""
    from repro_torch.models.transformer import moe as MOE

    orig = MOE.route
    it = iter(choices)

    def replay(xt, router, moe):
        probs, _, _ = orig(xt, router, moe)
        top_i = next(it)
        top_p = probs.gather(-1, top_i)
        return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i

    MOE.route = replay
    try:
        yield
    finally:
        MOE.route = orig


def _dropped_share(recorded: list, moe) -> float:
    """Share of the recorded (token, choice) pairs that the capacity drops:
    each call's slots (``moe.slots``) against its group's capacity."""
    from repro_torch.models.transformer import moe as MOE

    pairs = dropped = 0
    for top_i in recorded:
        cap = MOE.capacity(moe, top_i.shape[1])
        pairs += top_i.numel()
        dropped += int((MOE.slots(top_i, moe.n_experts) >= cap).sum())
    return dropped / max(pairs, 1)


def _flip_share(a: list, b: list) -> float:
    """Share of (token, choice) pairs whose expert differs between two
    recordings of the same calls."""
    n = sum(x.numel() for x in a)
    diff = sum(int((x != y).sum()) for x, y in zip(a, b))
    return diff / max(n, 1)


@contextlib.contextmanager
def attention_swapped(TM, attend):
    """The model's prefill attention (``TM.flash_attention``) replaced by
    ``attend`` inside the block."""
    orig = TM.flash_attention
    TM.flash_attention = attend
    try:
        yield
    finally:
        TM.flash_attention = orig


# torch.profiler has been seen to return a trace that kept only a few of a
# call's kernels (the symmetric call: 1.65 of 661 device ms, while the launch
# counts and the profile before it showed every kernel).  Such a trace shows
# its loss: a device busy share under DROP_SHARE on a call that keeps the
# card busy (the prefill and the symmetric call run at 0.99), or a kernel
# the call launched (its launch count) with no time in the trace.  Only such
# a trace is taken again, at most PROFILE_TRIES times; a whole trace that
# lacks a kernel fails at once.
DROP_SHARE = 0.5
PROFILE_TRIES = 4
# Idle seconds at each end of a profiled window, outside the timed call: a
# kernel record whose timestamps fall outside the window is dropped, and the
# device's clock may drift from the host's over a long process.  Traces
# that lost records dropped kernels at the start or the end of the window,
# and a retry with longer pads came back whole.  A retry of a trace that
# lost records idles 4 times longer than the last, up to PROFILE_PAD_MAX_S.
PROFILE_PAD_S = 0.5
PROFILE_PAD_MAX_S = 8.0
# Traces judged whole or not (profile_whole), and those that lost records:
# first traces, and retries.
PROFILE_STATS = {"calls": 0, "first_lost": 0, "retries": 0}


def profile_one(fn, match: str, pad: float = 0.0):
    """torch.profiler over one call: (wall us, device us, device us of the
    kernels whose name holds ``match``, [(us, name, count)] by device time).
    ``pad``: idle seconds at each end of the window (PROFILE_PAD_S if 0)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    pad = pad or PROFILE_PAD_S
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(pad)
    del out
    dev_us = hit_us = 0.0
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        dev_us += us
        if match in ev.key:
            hit_us += us
        top.append((us, ev.key[:60], ev.count))
    top.sort(reverse=True)
    return wall_us, dev_us, hit_us, top


def profile_whole(fn, what: str, families: dict, busy: bool = True):
    """torch.profiler over one call until its trace is whole: (wall us,
    device us, [(us, name, count)] by device time, {kernel: launches} of
    the call).  ``families`` maps a launch-count name to the names its
    kernels have in a trace; ``busy=False`` for a call whose host work
    leaves the card idle much of the time, so that only a missing kernel
    marks a loss."""
    from repro_torch.kernels import _build

    PROFILE_STATS["calls"] += 1
    for attempt in range(1, PROFILE_TRIES + 1):
        before = dict(_build.LAUNCHES)
        pad = min(PROFILE_PAD_S * 4 ** (attempt - 1), PROFILE_PAD_MAX_S)
        wall_us, dev_us, _, top = profile_one(fn, "", pad)
        launched = {k: c - before.get(k, 0) for k, c in _build.LAUNCHES.items()
                    if c > before.get(k, 0)}
        lost = [k for k, keys in families.items() if launched.get(k, 0) and not
                any(us > 0 and any(key in name for key in keys)
                    for us, name, _ in top)]
        share = dev_us / wall_us
        if (share >= DROP_SHARE or not busy) and not lost:
            return wall_us, dev_us, top, launched
        PROFILE_STATS["first_lost" if attempt == 1 else "retries"] += 1
        log(f"{what} profile, trace {attempt} of at most {PROFILE_TRIES} "
            f"({pad} s idle at each end) lost "
            f"records: {dev_us / 1e3:.2f} device ms of a {wall_us / 1e3:.1f} ms "
            f"call (busy share {share:.3f}); launched {launched}, none in the "
            f"trace: {lost}; by device time: {top[:6]}")
    fail(f"{what}: {PROFILE_TRIES} profiles lost records")


# The symmetric streaming top-k's kernels: (launch-count name, names in a
# trace) of B1 (phase 1, its prep), B7's d21 mode (its three list launches
# and the GEMM), B3 (the fold and its merges).
SYM_KERNELS = {"B1": ("lc_rwmd_phase1", ("phase1_",)),
               "d21": ("rwmd_d21", ("rwmd_kernel", "count_rows",
                                    "scan_kernel", "list_rows")),
               "B3": ("fused_topk", ("fused_topk", "topk_merge"))}


def symmetric_split(fn) -> dict:
    """Device ms of one ``symmetric_topk_streaming`` call by kernel group
    (``torch.profiler``); fails if a cuBLAS GEMM ran on the path."""
    wall_us, dev_us, top, launched = profile_whole(
        fn, "symmetric_topk_streaming", dict(SYM_KERNELS.values()))
    split = dict.fromkeys(SYM_KERNELS, 0.0)
    split["other"] = 0.0
    for us, name, _ in top:
        if "gemm" in name.lower():
            fail(f"symmetric_topk_streaming ran a GEMM outside the port's "
                 f"kernels: {name}")
        group = next((g for g, (_, keys) in SYM_KERNELS.items()
                      if any(key in name for key in keys)), "other")
        split[group] += us / 1e3
    if min(split["B1"], split["d21"], split["B3"]) <= 0:
        fail(f"symmetric_topk_streaming: a whole trace shows no time in one "
             f"of B1, d21, B3: {split}; launched {launched}")
    log(f"profile symmetric_topk_streaming k={4 * K_FINAL}: wall "
        f"{wall_us / 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms: " + ", ".join(
            f"{g} {ms:.2f} ms" for g, ms in split.items()) + "; no cuBLAS GEMM")
    return dict(wall_ms=wall_us / 1e3, device_ms=dev_us / 1e3, **split)


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


def _gap(a, b) -> dict:
    """Relative RMS, max |a - b| and top-1 agreement of two logit tensors."""
    import torch

    d = (a.float() - b.float())
    rel = float(torch.sqrt((d * d).mean() / (b.float() ** 2).mean()))
    top1 = float((a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean())
    return dict(rel_rms=rel, max_abs=float(d.abs().max()), top1_agree=top1)


# The segmented phase at scale 0.25: a 688,000-doc base and three deltas of
# 4,000 (the last 3,999 docs and a copy of doc 5); 7,000 seeded deletions
# from 64..n-2 and the queries 60..63.  Other scales take these in
# proportion.
SEG_DELTA = 4000
SEG_DELETES = 7000
SEG_DEAD_QUERIES = (60, 61, 62, 63)
SEG_REL_TOL = 1e-5    # a monolithic rebuild: |d - d_mono| <= 1e-5 (1 + |d|)


def segmented_phase(docs, emb, labels, smi: str) -> dict:
    """The corpus as a segmented engine and the single-GPU serve step.

    Counts reset just before the calls and read just after: B1, B2, B3, B4
    and the d21 mode must each have run.  Checks: self-queries first at
    tier 0, the copy of doc 5 right after it, no dead doc, filler or id
    past the corpus in any result, no self-match under self_exclude,
    tier 1 = the first k of ``topk_streaming``, the same ids as a
    monolithic ``LCRWMDEngine`` over the live docs (distances within
    ``SEG_REL_TOL``), the same answers after ``compact``, and no
    host-to-device copy in a serve call at an unchanged version.
    """
    import numpy as np
    import torch

    from repro_torch.core.lc_rwmd import LCRWMDEngine, SegmentedEngine
    from repro_torch.data.docs import DocSet
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.kernels import _build

    n = docs.n_docs
    f = n / 700_000
    delta = max(32, round(SEG_DELTA * f))
    base = n - 3 * delta
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize

    eng, build_ms = clocked(lambda: SegmentedEngine(docs[:base], emb))
    copy5 = DocSet(torch.cat([docs.ids[n - delta:n - 1], docs.ids[5:6]]),
                   torch.cat([docs.weights[n - delta:n - 1],
                              docs.weights[5:6]]))
    append_ms = []
    for part in (docs[base:base + delta], docs[base + delta:base + 2 * delta],
                 copy5):
        _, ms = clocked(lambda part=part: eng.append(part))
        append_ms.append(ms)
    v_e = [s.tensors.emb_r.shape[0] for s in eng.segments]
    if (eng.n_docs, eng.n_segments) != (n, 4) or any(
            s.n_rows != delta for s in eng.segments[1:]):
        fail(f"segments: n_docs {eng.n_docs}, {eng.n_segments} segments, "
             f"rows {[s.n_rows for s in eng.segments]}")
    rng = np.random.default_rng(20)
    dead = np.concatenate([rng.choice(np.arange(64, n - 1),
                                      max(1, round(SEG_DELETES * f)),
                                      replace=False), SEG_DEAD_QUERIES])
    q = docs[:B]
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    kw = dict(k=K_FINAL, refine=True, rerank_wmd=True, rerank_budget=K_CAND,
              wmd_kw=KW_RERANK, bf16_matmul=False)
    step = build_serve_step(engine=eng, **kw)
    step_x = build_serve_step(engine=eng, self_exclude=True, **kw)
    step(q)                      # warm the step before the timed delete
    sync()
    t0 = time.perf_counter()
    removed = eng.delete(dead)
    step(q)
    sync()
    delete_serve_ms = (time.perf_counter() - t0) * 1e3
    if removed != len(dead) or eng.n_live != n - len(dead):
        fail(f"delete: removed {removed} of {len(dead)}, n_live {eng.n_live}")
    dead_t = torch.as_tensor(dead, device="cuda")

    def run_all():
        out = dict(stream=eng.topk_streaming(q, K_CAND),
                   sym=eng.symmetric_topk_streaming(q, 4 * K_FINAL))
        out["rerank"] = eng.rerank_topk(q, out["stream"].indices, K_FINAL,
                                        sinkhorn_kw=KW_RERANK)
        out["one_sided"] = eng.one_sided(q)
        for tier in (0, 1, 2):
            out[f"tier{tier}"] = step(q, tier=tier)
        out["self_exclude"] = step_x(q, query_ids=ids)
        return out

    sync()
    _build.reset_launches()
    res = run_all()
    sync()
    launches = dict(_build.LAUNCHES)
    log(f"segmented path launches: {launches}")
    for name in ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd",
                 "rwmd_d21"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the segmented path")
    peak_serve_gb = torch.cuda.max_memory_allocated() / 1e9

    # checks
    tops = {k: (v.topk if hasattr(v, "topk") else v) for k, v in res.items()
            if k != "one_sided"}
    for name, tk in tops.items():
        i = tk.indices
        if bool((i < 0).any()) or bool((i >= n).any()) or bool(
                torch.isin(i.long(), dead_t).any()) or not bool(
                torch.isfinite(tk.dists).all()):
            fail(f"segmented {name}: a dead doc, filler or id "
                 f"past {n} in the result")
    live_q = torch.tensor([j for j in range(B) if j not in SEG_DEAD_QUERIES],
                          device="cuda")
    t0i = res["tier0"].topk.indices
    if not bool((t0i[live_q, 0] == live_q).all()):
        fail("segmented tier 0: a live query's top-1 is not itself")
    if bool((res["self_exclude"].topk.indices == ids[:, None]).any()):
        fail("segmented self_exclude: a query found itself")
    for name in ("stream", "sym"):
        row = tops[name].indices[5].tolist()
        if n - 1 not in row or row.index(n - 1) != row.index(5) + 1 or (
                tops[name].dists[5, row.index(5)]
                != tops[name].dists[5, row.index(n - 1)]):
            fail(f"segmented {name}: the copy of doc 5 does not tie right "
                 f"after it: {row[:4]}")
    t1 = res["tier1"].topk
    if not (torch.equal(t1.indices, res["stream"].indices[:, :K_FINAL])
            and torch.equal(t1.dists, res["stream"].dists[:, :K_FINAL])):
        fail("segmented tier 1 is not the first k of topk_streaming")
    d1 = res["one_sided"]
    if tuple(d1.shape) != (n, B) or not bool(torch.isinf(d1[dead_t]).all()) \
            or not bool(torch.isfinite(d1[eng.live_mask_device()]).all()):
        fail("segmented one_sided: bad shape, or a dead row finite, or a "
             "live row not")
    del d1, res["one_sided"]
    pe = res["tier0"].pruned_exact
    exact_share = float(pe.float().mean())

    # per-call times after warm-up (host clock, ending in a synchronize)
    cand = tops["stream"].indices
    times = {
        "topk_streaming_k32": wall_ms(lambda: eng.topk_streaming(q, K_CAND)),
        "symmetric_topk_streaming_k20": wall_ms(
            lambda: eng.symmetric_topk_streaming(q, 4 * K_FINAL), 2),
        "rerank_topk_k5": wall_ms(lambda: eng.rerank_topk(
            q, cand, K_FINAL, sinkhorn_kw=KW_RERANK)),
        "one_sided": wall_ms(lambda: eng.one_sided(q)),
        "serve_tier0": wall_ms(lambda: step(q)),
        "serve_tier1": wall_ms(lambda: step(q, tier=1)),
        "serve_tier2": wall_ms(lambda: step(q, tier=2)),
        "serve_self_exclude": wall_ms(lambda: step_x(q, query_ids=ids)),
    }
    profiles = profile_calls({
        "serve_tier0": lambda: step(q),
        "serve_self_exclude": lambda: step_x(q, query_ids=ids)})
    for name, p in profiles.items():
        if p["htod_copies"]:
            fail(f"segmented {name}: host-to-device copies at an unchanged "
                 f"version: {p}")

    # a monolithic engine over the live docs, ids mapped back
    live_ids = torch.nonzero(eng.live_mask_device())[:, 0]
    res_docs = eng.resident
    mono, mono_ms = clocked(lambda: LCRWMDEngine(
        DocSet(res_docs.ids[live_ids].contiguous(),
               res_docs.weights[live_ids].contiguous()), emb))
    mono_cmp = {}
    for name, fn, k in (("stream", "topk_streaming", K_CAND),
                        ("sym", "symmetric_topk_streaming", 4 * K_FINAL)):
        a = tops[name]
        b = getattr(mono, fn)(q, k)
        if not torch.equal(a.indices.long(), live_ids[b.indices.long()]):
            fail(f"segmented {fn}: ids differ from the monolithic rebuild's")
        err = (a.dists - b.dists).abs()
        if not bool((err <= SEG_REL_TOL * (1 + b.dists.abs())).all()):
            fail(f"segmented {fn}: distances differ from the monolithic "
                 f"rebuild's by {float(err.max())}")
        mono_cmp[fn] = dict(max_abs=float(err.max()),
                            bit_equal_share=float((a.dists == b.dists)
                                                  .float().mean()))
    del mono
    torch.cuda.empty_cache()
    log(f"segmented vs monolithic rebuild over the {eng.n_live} live docs "
        f"(built in {mono_ms:.0f} ms): ids equal; {json.dumps(mono_cmp)}")

    # 7. the cluster index over this engine (its own counts and peak)
    pre_index_peak = torch.cuda.max_memory_allocated()
    true = np.concatenate([labels[:n - 1], labels[5:6]])   # doc n-1 copies 5
    t0 = time.perf_counter()
    idx, index_info = index_phase(eng, q, res, kw, true, smi)
    log(f"index phase (before compact): {time.perf_counter() - t0:.1f} s")
    # 6f. the segmented and routed steps and the server on a 1x1 mesh
    mesh_info = mesh_segmented_phase(eng, idx, docs, emb, q, smi)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # compact: one segment, the same ids and answers
    nbytes_before = eng.nbytes
    n_docs, n_live = eng.n_docs, eng.n_live
    _, compact_ms = clocked(eng.compact)
    if (eng.n_segments, eng.n_docs, eng.n_live) != (1, n_docs, n_live):
        fail(f"compact: {eng.n_segments} segments, n_docs {eng.n_docs}, "
             f"n_live {eng.n_live}")
    after = dict(stream=eng.topk_streaming(q, K_CAND),
                 sym=eng.symmetric_topk_streaming(q, 4 * K_FINAL),
                 tier0=step(q).topk, tier1=step(q, tier=1).topk,
                 tier2=step(q, tier=2).topk,
                 self_exclude=step_x(q, query_ids=ids).topk)
    compact_cmp = {}
    for name, b in after.items():
        a = tops[name]
        if not torch.equal(a.indices, b.indices):
            fail(f"compact changed the {name} ids")
        err = (a.dists - b.dists).abs()
        if not bool((err <= SEG_REL_TOL * (1 + a.dists.abs())).all()):
            fail(f"compact changed the {name} distances by {float(err.max())}")
        compact_cmp[name] = float((a.dists == b.dists).float().mean())
    # the index is held across compact: its bytes are not this phase's
    peak_gb = max(pre_index_peak,
                  torch.cuda.max_memory_allocated() - idx.nbytes) / 1e9
    seg_bytes = [s.nbytes for s in eng.segments]
    info = dict(
        n_docs=n, base=base, delta=delta, deleted=len(dead),
        v_e=v_e,
        n_live=n_live, launches=launches, per_call_ms=times,
        build_ms=build_ms, append_ms=append_ms,
        delete_then_first_serve_ms=delete_serve_ms, compact_ms=compact_ms,
        nbytes_segments=nbytes_before, nbytes_compacted=sum(seg_bytes),
        peak_serve_gb=peak_serve_gb, peak_gb=peak_gb,
        pruned_exact_share=exact_share, monolithic=mono_cmp,
        compact_bit_equal_share=compact_cmp,
        profiles=profiles, card=smi)
    log(f"segmented per-call ms (B={B}, after warm-up; {smi}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    log(f"segmented lifecycle ms: build {build_ms:.0f}, appends of {delta} "
        + " / ".join(f"{ms:.1f}" for ms in append_ms)
        + f", delete of {len(dead)} then the first serve {delete_serve_ms:.1f},"
        f" compact {compact_ms:.0f}; segments {nbytes_before / 1e9:.3f} GB "
        f"(compacted {sum(seg_bytes) / 1e9:.3f} GB); peak device memory "
        f"{peak_serve_gb:.2f} GB serving, {peak_gb:.2f} GB with the "
        f"monolithic rebuild (max_memory_allocated)")
    log("segmented: " + json.dumps(info))
    t0 = time.perf_counter()
    index_info.update(index_lifecycle(eng, idx, docs, q, smi))
    log(f"index lifecycle (after compact): {time.perf_counter() - t0:.1f} s")
    log("index: " + json.dumps(index_info))
    info["index"] = index_info
    info["mesh"] = mesh_info
    return info


# The index phase (after the segmented phase's checks, on its engine): 64
# cells (kcenters, seed 0) probed 1, 4 or all 64 a query, the triangle bound
# at slack 1.0 for 1 and 4; the routed serve step at top_p 4 with every cell
# a slot (no probe overflow).  Then a k-medoids index at 16 cells,
# kmedoids(prefilter=4) for 2 iterations and the WCD baseline on the first
# WCD_BASELINE_DOCS docs (scaled like the corpus).
INDEX_CELLS = 64
INDEX_TOP_P = 4
INDEX_SLACK = 1.0
KMEDOIDS_CELLS = 16
WCD_BASELINE_DOCS = 200_000


def clocked(fn):
    """(fn(), host ms) around a call ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _spread(x) -> dict:
    import numpy as np

    return dict(min=int(np.min(x)), median=float(np.median(x)),
                max=int(np.max(x)))


def _split(top, groups: dict) -> dict:
    """Device ms of a trace's kernels by group (names matched by part)."""
    out = dict.fromkeys(groups, 0.0)
    out["other"] = 0.0
    for us, name, _ in top:
        g = next((g for g, keys in groups.items()
                  if any(key in name for key in keys)), "other")
        out[g] += us / 1e3
    return out


def index_phase(eng, q, flat: dict, kw: dict, true, smi: str):
    """The cluster index over the segmented engine, before ``compact``.

    ``flat``: the segmented phase's results at this engine version
    (``sym`` is ``symmetric_topk_streaming`` k=20, which is ``engine.topk``;
    ``tier0``-``tier2``, ``self_exclude`` its serve step built with
    ``kw``).  Counts reset at the start and read per call; B1, B2, B3, B4
    and the d21 mode must each have run in the phase.  Checks: exhaustive
    routing (top_p 64, bound off) equals ``engine.topk`` and the flat
    serve step bit for bit; no dead doc, filler or id past the corpus in
    any routed result; no self-match under ``self_exclude``; every id of a
    top_p = 4 result lies in a cell its query was routed to.  Returns
    (index, info).
    """
    import numpy as np
    import torch

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.core.pipeline import pruned_wmd_topk
    from repro_torch.core.wcd import resident_centroids
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.index import ClusterIndex
    from repro_torch.kernels import _build
    from repro_torch.workloads import clustering as cl

    n = eng.n_docs
    k_sym = 4 * K_FINAL
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    live = eng.live_mask()
    dead_t = torch.from_numpy(np.nonzero(~live)[0]).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    # rebuild, split: the doc centroids and kcenters timed again alone
    idx, build_ms = clocked(lambda: ClusterIndex(
        eng, num_cells=INDEX_CELLS, top_p=INDEX_TOP_P, probe_cap=INDEX_CELLS,
        bound_slack=INDEX_SLACK, seed=0))
    launches = {"rebuild": dict(_build.LAUNCHES)}
    _, cen_ms = clocked(lambda: resident_centroids(eng.resident, eng.emb_full))
    before = dict(_build.LAUNCHES)
    centers, kc_ms = clocked(lambda: cl.kcenters(eng, INDEX_CELLS, seed=0))
    launches["kcenters"] = {k: c - before.get(k, 0)
                            for k, c in _build.LAUNCHES.items()
                            if c > before.get(k, 0)}
    cells = [c for c in idx.cells if c is not None]
    rows = [c.segment.n_rows for c in cells]
    v_e = [c.segment.tensors.emb_r.shape[0] for c in cells]
    log(f"index: {len(cells)} of {INDEX_CELLS} cells alive over {n} docs; "
        f"rebuild {build_ms:.0f} ms = doc centroids {cen_ms:.0f} + kcenters "
        f"({INDEX_CELLS - 1} symmetric_resident calls at B=1) {kc_ms:.0f} + "
        f"assignment and cells {build_ms - cen_ms - kc_ms:.0f}; rows "
        f"{_spread(rows)}, v_e {_spread(v_e)}; {idx.nbytes / 1e9:.3f} GB "
        f"({idx.centroid_nbytes / 1e9:.3f} GB routing state)")

    step = build_serve_step(engine=eng, index=idx, **kw)
    step_x = build_serve_step(engine=eng, index=idx, self_exclude=True, **kw)
    prune_kw = dict(k=K_FINAL, sinkhorn_kw=KW_RERANK)
    calls = {
        "route_p4": lambda: idx.route(q),
        "routed_topk_p1": lambda: idx.routed_topk(q, k_sym, top_p=1),
        "routed_topk_p4": lambda: idx.routed_topk(q, k_sym, top_p=4),
        "routed_topk_p64_nobound": lambda: idx.routed_topk(
            q, k_sym, top_p=INDEX_CELLS, bound_slack=None),
        "pruned_wmd_topk_index_p4": lambda: pruned_wmd_topk(
            eng.resident, q, eng.emb_full, index=idx, top_p=4, **prune_kw),
        "pruned_wmd_topk_flat": lambda: pruned_wmd_topk(
            eng.resident, q, eng.emb_full, engine=eng, **prune_kw),
        "serve_tier0": lambda: step(q),
        "serve_tier1": lambda: step(q, tier=1),
        "serve_tier2": lambda: step(q, tier=2),
        "serve_self_exclude": lambda: step_x(q, query_ids=ids),
    }
    out = {}
    for name, fn in calls.items():
        before = dict(_build.LAUNCHES)
        out[name] = fn()
        torch.cuda.synchronize()
        launches[name] = {k: c - before.get(k, 0)
                          for k, c in _build.LAUNCHES.items()
                          if c > before.get(k, 0)}
    phase_launches = dict(_build.LAUNCHES)
    log(f"index phase launches: {phase_launches}; by call: "
        f"{json.dumps(launches)}")
    for name in ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd",
                 "rwmd_d21"):
        if phase_launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched in the index phase")

    # exhaustive routing: the flat scan and the flat serve step, bit for bit
    ex = out["routed_topk_p64_nobound"]
    if not (torch.equal(ex.dists, flat["sym"].dists)
            and torch.equal(ex.indices, flat["sym"].indices)):
        fail("exhaustive routing differs from engine.topk (bit for bit)")
    idx.top_p, idx.bound_slack = INDEX_CELLS, None
    step_e = build_serve_step(engine=eng, index=idx, **kw)
    step_xe = build_serve_step(engine=eng, index=idx, self_exclude=True, **kw)
    exhaustive = {f"tier{t}": step_e(q, tier=t) for t in (0, 1, 2)}
    exhaustive["self_exclude"] = step_xe(q, query_ids=ids)
    idx.top_p, idx.bound_slack = INDEX_TOP_P, INDEX_SLACK
    for name, r in exhaustive.items():
        f_ = flat[name]
        if not (torch.equal(r.topk.dists, f_.topk.dists)
                and torch.equal(r.topk.indices, f_.topk.indices)) or (
                name == "tier0" and not torch.equal(r.pruned_exact,
                                                    f_.pruned_exact)):
            fail(f"the exhaustive routed serve step's {name} differs from "
                 f"the flat segmented step (bit for bit)")

    # no dead doc or id past the corpus, and no filler while the query's
    # routed cells hold live docs for the slot; no self-match
    results = {k: v for k, v in out.items() if k != "route_p4"}
    results.update({f"exhaustive_{k}": v for k, v in exhaustive.items()})

    def reach(route):   # (B,) live docs in each query's kept cells
        c = idx._cell_live[route.cells] * route.keep
        return torch.from_numpy(c.sum(axis=1)).to("cuda")

    every = torch.full((B,), eng.n_live, device="cuda")
    r4 = reach(out["route_p4"])
    caps = {"routed_topk_p1": reach(idx.route(q, top_p=1)),
            "routed_topk_p4": r4, "pruned_wmd_topk_index_p4": r4,
            "serve_tier0": r4, "serve_tier1": r4, "serve_self_exclude": r4 - 1}
    for name, r in list(results.items()):
        tks = ([r.topk, r.rwmd_topk] if hasattr(r, "rwmd_topk")
               else [r.topk] if hasattr(r, "topk") else [r])
        cap = caps.get(name, every)
        for tk in tks:
            i = tk.indices
            pos = torch.arange(i.shape[1], device="cuda")[None, :]
            filler = i < 0
            if bool((i >= n).any()) or bool(
                    torch.isin(i.long(), dead_t).any()) or bool(
                    (filler & (pos < cap[:, None])).any()) or not bool(
                    torch.isfinite(tk.dists[~filler]).all()):
                fail(f"index {name}: a dead doc, filler or id past {n} in "
                     f"the result")
    n_filler = {k: int(sum(int((tk.indices < 0).sum()) for tk in (
        [r.topk] if hasattr(r, "topk") else [r]))) for k, r in results.items()}
    for name in ("serve_self_exclude", "exhaustive_self_exclude"):
        if bool((results[name].topk.indices == ids[:, None]).any()):
            fail(f"index {name}: a query found itself")

    # top_p = 4: every id in a cell its query was routed to
    route = out["route_p4"]
    lab = torch.from_numpy(idx.labels).to("cuda")
    allowed = torch.zeros((B, INDEX_CELLS), dtype=torch.bool, device="cuda")
    for j in range(route.cells.shape[1]):
        kept = torch.from_numpy(route.keep[:, j]).to("cuda")
        allowed[torch.arange(B, device="cuda"),
                torch.from_numpy(route.cells[:, j]).long().to("cuda")] |= kept
    for name in ("routed_topk_p4", "serve_tier1"):
        i = results[name].indices if name.startswith("routed") else \
            results[name].topk.indices
        if not bool(torch.gather(allowed, 1, lab[i.long()].long()).all()):
            fail(f"index {name}: an id from a cell its query was not routed to")

    def recall(tk):
        a, b = tk.indices.cpu().numpy(), flat["sym"].indices.cpu().numpy()
        return float(np.mean([len(set(x) & set(y)) / len(y)
                              for x, y in zip(a, b)]))

    live_q = np.array([j for j in range(B) if live[j]])
    quality = {}
    for p in (1, 4):
        tk = out[f"routed_topk_p{p}"]
        quality[f"top_p{p}"] = dict(
            recall_at_20=recall(tk),
            self_first_share=float(np.mean(
                tk.indices[live_q, 0].cpu().numpy() == live_q)))
    quality["filler_slots"] = {k: v for k, v in n_filler.items() if v}
    quality["probed_cells_p4"] = int(len(route.probed))
    quality["bound_pruned_slots_p4"] = route.n_bound_pruned
    quality["bound_pruned_docs_p4"] = route.n_docs_pruned
    quality["pruned_exact_share_p4"] = float(
        out["pruned_wmd_topk_index_p4"].pruned_exact.float().mean())
    log(f"index quality against the flat scan (k={k_sym}, B={B}): "
        f"{json.dumps(quality)}")

    # per-call times after warm-up (host clock, ending in a synchronize)
    times = {}
    for name, fn in calls.items():
        slow = "pruned" in name or "p64" in name
        times[name] = wall_ms(fn, 2 if slow else 3)
    times["exhaustive_serve_tier1"] = wall_ms(lambda: step_e(q, tier=1))
    log(f"index per-call ms (B={B}, after warm-up; {smi}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    # device time by kernel: the one-sided routed step and the symmetric
    # routed top-k at top_p 4
    groups = {"B1": ("phase1_",), "d21": SYM_KERNELS["d21"][1],
              "B3": ("fused_topk", "topk_merge"), "B4": ("sinkhorn",)}
    profiles = {}
    for name, fn, fam in (
            ("serve_tier1", calls["serve_tier1"],
             {"lc_rwmd_phase1": ("phase1_",), "fused_topk": ("fused_topk",)}),
            ("routed_topk_p4", calls["routed_topk_p4"],
             {"lc_rwmd_phase1": ("phase1_",), "fused_topk": ("fused_topk",),
              "rwmd_d21": SYM_KERNELS["d21"][1]})):
        wall_us, dev_us, top, _ = profile_whole(fn, f"index {name}", fam,
                                                busy=False)
        profiles[name] = dict(wall_ms=wall_us / 1e3, device_ms=dev_us / 1e3,
                              device_busy_share=dev_us / wall_us,
                              **_split(top, groups))
    log(f"index device ms by kernel: {json.dumps(profiles)}")

    # k-medoids: an index at 16 cells, the prefiltered assignment, the WCD
    # baseline on a cut
    clusterings = {}
    kmi, ms = clocked(lambda: ClusterIndex(eng, num_cells=KMEDOIDS_CELLS,
                                           seed=0, method="kmedoids"))
    clusterings["kmedoids_index_16"] = dict(ms=ms, labels=kmi.labels,
                                            on=live)
    del kmi
    res_pf, ms = clocked(lambda: cl.kmedoids(eng, KMEDOIDS_CELLS, prefilter=4,
                                             n_iters=2, seed=0))
    clusterings["kmedoids_prefilter4_2iters"] = dict(
        ms=ms, labels=res_pf.labels, on=live, objective=res_pf.objective)
    clusterings["kcenters_index_64"] = dict(ms=build_ms, labels=idx.labels,
                                            on=live)
    n_w = min(n, round(WCD_BASELINE_DOCS * n / 700_000))
    res_docs = eng.resident
    sub = LCRWMDEngine(res_docs[:n_w], eng.emb_full)
    res_w, ms = clocked(lambda: cl.kmedoids_wcd_baseline(sub, KMEDOIDS_CELLS))
    del sub
    on_w = np.zeros(n, dtype=bool)
    on_w[:n_w] = True
    clusterings["kmedoids_wcd_baseline"] = dict(
        ms=ms, labels=np.concatenate([res_w.labels, np.zeros(n - n_w, int)]),
        on=on_w, objective=res_w.objective, n_iters=res_w.n_iters,
        docs=n_w)
    for name, c in clusterings.items():
        on = c.pop("on")
        pred = c.pop("labels")
        c["purity"] = cl.purity(pred[on], true[on])
        c["ari"] = cl.adjusted_rand_index(pred[on], true[on])
    log(f"clustering (topic labels of the live docs; {smi}): "
        f"{json.dumps(clusterings)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"index phase peak device memory {peak_gb:.2f} GB "
        f"(max_memory_allocated); index {idx.nbytes / 1e9:.3f} GB")
    info = dict(
        cells=INDEX_CELLS, alive=len(cells), top_p=INDEX_TOP_P,
        bound_slack=INDEX_SLACK, rows=_spread(rows), v_e=_spread(v_e),
        rebuild_ms=dict(total=build_ms, doc_centroids=cen_ms, kcenters=kc_ms,
                        assignment_and_cells=build_ms - cen_ms - kc_ms),
        per_call_ms=times, launches=launches, quality=quality,
        profiles=profiles, clustering=clusterings, nbytes=idx.nbytes,
        centroid_nbytes=idx.centroid_nbytes, peak_gb=peak_gb, card=smi)
    return idx, info


def index_lifecycle(eng, idx, docs, q, smi: str) -> dict:
    """After ``compact``: ``rebuild`` gives the labels of a fresh index over
    the compacted engine; an ``append`` then ``index.add`` keeps exhaustive
    routing bit-equal to ``engine.topk``; a doc deleted on the engine leaves
    the routed results without an index call."""
    import numpy as np
    import torch

    from repro_torch.index import ClusterIndex

    kw = dict(num_cells=INDEX_CELLS, top_p=INDEX_TOP_P, probe_cap=INDEX_CELLS,
              bound_slack=INDEX_SLACK, seed=0)
    _, rebuild_ms = clocked(idx.rebuild)
    fresh = ClusterIndex(eng, **kw)
    if not np.array_equal(idx.labels, fresh.labels):
        fail("index rebuild after compact: labels differ from a fresh index")
    del fresh
    k_sym = 4 * K_FINAL
    part = docs[100:100 + max(32, round(SEG_DELTA * eng.n_docs / 700_000))]
    gids, append_ms = clocked(lambda: eng.append(part))
    assign, add_ms = clocked(lambda: idx.add(gids, part))
    a = idx.routed_topk(q, k_sym, top_p=INDEX_CELLS, bound_slack=None)
    b = eng.topk(q, k_sym)
    if not (torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)):
        fail("index.add: exhaustive routing differs from engine.topk")
    r = idx.routed_topk(q, k_sym)
    victim = int(r.indices[0, 1])
    v = idx.version
    eng.delete([victim])
    r2 = idx.routed_topk(q, k_sym)
    if victim in r2.indices.cpu().numpy() or idx.version != v:
        fail("a doc deleted on the engine came back from routed_topk")
    info = dict(rebuild_after_compact_ms=rebuild_ms, append_ms=append_ms,
                add_ms=add_ms, added=part.n_docs,
                cells_touched=int(len(np.unique(assign))),
                deleted_without_index_call=victim)
    log(f"index lifecycle ({smi}): rebuild after compact {rebuild_ms:.0f} ms "
        f"(labels = a fresh index's); append of {part.n_docs} docs "
        f"{append_ms:.1f} ms, index.add {add_ms:.1f} ms over "
        f"{info['cells_touched']} cells (exhaustive routing still equals "
        f"engine.topk); doc {victim} deleted on the engine is gone from "
        f"routed_topk")
    return info


# The serving phase (after the segmented and index phases, on the same
# corpus): the serving plane through its entry points on the card.  A
# stream of SERVE_QUERIES resident docs' own histograms (seeded picks) at
# k = 16, B = 64, h_max 48, refine + the Sinkhorn rerank at a fixed budget
# of 2k; the tenant is docs 500,000-699,999 (scaled with the corpus); the
# lifecycle ingests SERVE_INGEST new docs (scaled), then SERVE_DEDUP with
# SERVE_COPIES exact copies of live docs at a 0.05 dedup threshold, deletes
# SERVE_DELETES and compacts; the indexed tenant has 64 cells probed 4 a
# query.
SERVE_K = 16
SERVE_QUERIES = 4096
SERVE_WINDOW = 512        # the profiled window of the async run
SERVE_FAULT_QUERIES = 1024
# The adaptive run is short: on failing batches the budget doubles, and
# the rerank gathers (64 x budget) candidates of 48 x 300 floats.
SERVE_ADAPTIVE_QUERIES = 5 * 64
SERVE_INGEST = 4000
SERVE_DEDUP = 64
SERVE_COPIES = 8
SERVE_DELETES = 64
SERVE_DEDUP_THRESHOLD = 0.05
SERVE_TENANT = (500_000, 700_000)
SERVE_POOL_WORKERS = 2
SERVE_POOL_QUERIES = 1024
SERVE_WAIT_S = 300        # the most a stream's futures may take to resolve
# What the reference's AsyncQueryServer registers for the main async
# configuration (this script imports no JAX; listed from a CPU run of
# ``repro.serving``), its mesh collective gauges left out.
REFERENCE_SERVER_METRICS = (
    "corpus_cache_hits_total", "corpus_cache_misses_total",
    "corpus_evictions_total", "corpus_readmissions_total",
    "corpus_resident_bytes", "serve_step_host_seconds", "serving_batch_size",
    "serving_batches_total", "serving_device_collect_seconds",
    "serving_dispatch_host_seconds", "serving_e2e_latency_seconds",
    "serving_ewma_latency_seconds", "serving_queries_total",
    "serving_queue_depth", "serving_queue_wait_seconds",
    "serving_rerank_budget")
SERVE_FAMILIES = {"lc_rwmd_phase1": ("phase1_",),
                  "fused_topk": ("fused_topk", "topk_merge"),
                  "sinkhorn_wmd": ("sinkhorn",)}


def _serve_async(server, payloads):
    """Submit every payload (an (ids, weights) pair or a raw payload), then
    flush and wait at most SERVE_WAIT_S: (outcomes, per-query
    submit-to-answer seconds, wall seconds from the first submit to the
    last answer)."""
    import concurrent.futures

    import numpy as np

    n = len(payloads)
    t_sub, t_done = np.zeros(n), np.zeros(n)
    futs = []
    t0 = time.perf_counter()
    for j, p in enumerate(payloads):
        t_sub[j] = time.perf_counter()
        f = server.submit(*p) if isinstance(p, tuple) else server.submit(p)
        f.add_done_callback(
            lambda _f, j=j: t_done.__setitem__(j, time.perf_counter()))
        futs.append(f)
    server.flush()
    _, pending = concurrent.futures.wait(futs, timeout=SERVE_WAIT_S)
    if pending:
        fail(f"serving: {len(pending)} futures unresolved after "
             f"{SERVE_WAIT_S} s (health {server.health()})")
    out = [f.exception() or f.result() for f in futs]
    return out, t_done - t_sub, float(t_done.max() - t0)


def _serve_sync(server, stream, batch: int):
    """Submit a batch, flush it, next: (answers, per-query submit-to-answer
    seconds, wall seconds)."""
    import numpy as np

    out, lat = [], []
    t0 = time.perf_counter()
    for lo in range(0, len(stream), batch):
        t_sub = []
        for q in stream[lo:lo + batch]:
            t_sub.append(time.perf_counter())
            server.submit(*q)
        ans = server.flush()
        t = time.perf_counter()
        out += ans
        lat += [t - s for s in t_sub]
    return out, np.array(lat), time.perf_counter() - t0


def _latency(lat, wall, n) -> dict:
    import numpy as np

    return dict(qps=n / wall, p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3), wall_s=wall)


def _busy_window(fn, families: dict = SERVE_FAMILIES,
                 what: str = "serving", wall_ms: float | None = None,
                 required: bool = True) -> dict | None:
    """A window's device time (``torch.profiler`` with CUDA activity only,
    so the profiler adds no per-operator host records to a host-heavy
    loop) over its wall time, the window run once without the profiler and
    once with it; the busy share divides the device time by the wall time
    without it (the kernels are the same work either way).  Each run
    starts after a ``gc.collect()``: a collection of a finished stream's
    futures and traces (~0.3 s) would otherwise land in the window.  A
    caller that timed the window already passes ``wall_ms``, and the run
    without the profiler is not repeated.  If every trace shows no device
    time, the phase fails, or, where not ``required`` (the caller times
    the parts with CUDA events instead), None is returned."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if wall_ms is None:
        gc.collect()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(PROFILE_TRIES):
        gc.collect()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        top = []
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0.0)
                top.append((us, ev.key[:60], ev.count))
        dev_ms = sum(us for us, _, _ in top) / 1e3
        if dev_ms > 0:
            break
        PROFILE_STATS["retries"] += 1
    else:
        if not required:
            return None
        fail(f"{what}: profiles of a window show no device time")
    return dict(wall_ms=wall_ms, profiled_wall_ms=prof_ms, device_ms=dev_ms,
                busy_share=dev_ms / wall_ms,
                by_group=_split(sorted(top, reverse=True), families))


def _bit_equal(a, b) -> bool:
    return a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def _mixed_docs(docs, rng, n: int):
    """``n`` new docs: one resident doc's words in the even slots and
    another's in the odd ones, weights renormalized (histograms no resident
    doc holds)."""
    import torch

    from repro_torch.data.docs import DocSet

    a = torch.as_tensor(rng.integers(0, docs.n_docs, n), device=docs.device)
    b = torch.as_tensor(rng.integers(0, docs.n_docs, n), device=docs.device)
    even = torch.arange(docs.h_max, device=docs.device) % 2 == 0
    ids = torch.where(even, docs.ids[a], docs.ids[b])
    w = torch.where(even, docs.weights[a], docs.weights[b])
    w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-30)
    return DocSet(ids=ids.contiguous(), weights=w.contiguous())


def _host_rows(ds):
    """A DocSet's rows as (ids, weights) numpy pairs (serving queries)."""
    ids, w = ds.ids.cpu().numpy(), ds.weights.cpu().numpy()
    return [(ids[j], w[j]) for j in range(len(ids))]


def _text_vectorizer(vocab: int):
    """The serving phase's text vectorizer: word ``w{i}`` is row i."""
    from repro_torch.data.vectorizer import VocabVectorizer

    return VocabVectorizer(h_max=48).fit([" ".join(
        f"w{i}" for i in range(vocab))])


def _texts(stream) -> list:
    """Raw text payloads of (ids, weights) rows: each word repeated in
    proportion to its weight (32 copies for a weight of 1)."""
    return [" ".join(" ".join([f"w{i}"] * max(1, round(float(x) * 32)))
                     for i, x in zip(ids, w) if x > 0)
            for ids, w in stream]


def serving_phase(docs, emb, smi: str) -> dict:
    """The serving plane on the card: ``QueryServer`` and
    ``AsyncQueryServer`` (self-recall, async = sync bit for bit, the
    dispatch/collect overlap, busy share, launches per batch, no
    synchronizing call in the unrouted dispatch), an adaptive budget,
    degradation, faults and a crash, a second tenant evicting and
    readmitting the first, ingest / dedup / delete / compact between
    batches, an indexed tenant and the ingest pool; every future resolves
    as planned."""
    import concurrent.futures

    import numpy as np
    import torch

    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.index import IndexConfig
    from repro_torch.kernels import _build
    from repro_torch.serving import (
        Answer, AsyncQueryServer, FaultPlan, PoisonQuery, QueryServer,
        ServerConfig, WorkerCrashed)

    n = docs.n_docs
    f = n / 700_000
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(22)
    picks = rng.choice(n, SERVE_QUERIES, replace=False)
    stream = _host_rows(docs[torch.as_tensor(picks, device=docs.device)])
    kw = dict(k=SERVE_K, max_batch=B, h_max=48, refine_symmetric=True,
              rerank_wmd=True, wmd_kw=KW_RERANK, max_wait_s=1.0)
    step_kw = dict(k=SERVE_K, refine=True, rerank_wmd=True,
                   rerank_budget=2 * SERVE_K, wmd_kw=KW_RERANK,
                   bf16_matmul=False)
    info: dict = dict(queries=SERVE_QUERIES, batch=B, k=SERVE_K, card=smi)
    builds = {}

    def build(name, fn):
        server, ms = clocked(fn)
        builds[name] = ms
        return server

    def recall(answers, which):
        bad = [j for j, a in enumerate(answers) if not isinstance(a, Answer)]
        if bad:
            fail(f"serving {which}: {len(bad)} futures resolved with an "
                 f"error, first {answers[bad[0]]!r}")
        hit = np.mean([picks[j] in a[0] for j, a in enumerate(answers)])
        if hit != 1.0:
            fail(f"serving {which}: self-recall@{SERVE_K} {hit}")
        return float(hit)

    def check_equal(got, want, which, rows=None):
        rows = range(len(want)) if rows is None else rows
        diff = [j for j in rows if not _bit_equal(got[j], want[j])]
        if diff:
            fail(f"serving {which}: {len(diff)} answers differ bit for bit, "
                 f"first query {diff[0]}")

    # -- 1. QueryServer: warm-up, the sync-debug dispatch, the timed stream
    sync = build("sync", lambda: QueryServer(docs, emb, ServerConfig(**kw)))
    _serve_sync(sync, stream[:B], B)                 # warm-up
    core = sync._core
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = core.dispatch(stream[:B])
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"the unrouted serve dispatch synchronized: {e}")
    torch.cuda.set_sync_debug_mode(0)
    core.collect(handle)
    _build.reset_launches()
    want, lat, wall = _serve_sync(sync, stream, B)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    info["sync"] = dict(_latency(lat, wall, len(stream)),
                        self_recall=recall(want, "sync"),
                        launches_per_batch={k: v / (len(stream) // B)
                                            for k, v in launches.items()})
    for name in ("lc_rwmd_phase1", "fused_topk", "sinkhorn_wmd"):
        if launches.get(name, 0) < 1:
            fail(f"serving: kernel {name} was not launched by the servers")
    del sync, core, handle

    # -- 2. AsyncQueryServer: the same stream, its overlap and busy share;
    # the text preprocess hook is the ingest pool's in-thread baseline
    vec = _text_vectorizer(emb.shape[0])
    srv = build("async", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(**kw), preprocess=vec.query_histogram))
    _serve_async(srv, stream[:B])                    # warm-up
    srv._core.trace = []
    host_names = ("serving_dispatch_host_seconds", "serve_step_host_seconds",
                  "serving_device_collect_seconds")

    def host_sums():
        m = srv.metrics_snapshot()["metrics"]
        return {n: (m[n]["series"][0]["sum"], m[n]["series"][0]["count"])
                for n in host_names}

    h0 = host_sums()
    _build.reset_launches()
    got, lat, wall = _serve_async(srv, stream)
    launches_async = dict(_build.LAUNCHES)
    h1 = host_sums()
    trace = list(srv._core.trace)
    srv._core.trace = None
    recall(got, "async")
    check_equal(got, want, "async")
    pos = {e: j for j, e in enumerate(trace)}
    seqs = sorted(s for kind, s in trace if kind == "collect")
    overlap = [pos[("dispatch", s + 1)] < pos[("collect", s)]
               for s in seqs if ("dispatch", s + 1) in pos]
    batches = len(seqs)
    window = stream[:SERVE_WINDOW]
    info["async"] = dict(
        _latency(lat, wall, len(stream)), batches=batches,
        dispatch_before_collect_share=float(np.mean(overlap)),
        launches_per_batch={k: v / batches for k, v in launches_async.items()},
        window=dict(queries=len(window),
                    **_busy_window(lambda: _serve_async(srv, window))))
    # host seconds a batch over the timed stream: the dispatch (pad, step
    # launch, result copies), the step's own share, the wait at collect
    info["async"]["host_ms_a_batch"] = {
        n: (h1[n][0] - h0[n][0]) * 1e3 / max(1, h1[n][1] - h0[n][1])
        for n in host_names}
    names = set(srv.metrics_snapshot()["metrics"])
    missing = sorted(set(REFERENCE_SERVER_METRICS) - names)
    if missing:
        fail(f"serving: metrics the reference registers are missing: {missing}")
    prom = srv.obs.render_prometheus()
    info["metric_names"] = sorted(names)
    log("serving prometheus (bucket series left out): " + " | ".join(
        ln for ln in prom.splitlines()
        if not ln.startswith("#") and "_bucket{" not in ln))
    # in-thread text path, the pool's baseline (SERVE_POOL_QUERIES texts)
    texts = _texts(stream[:SERVE_POOL_QUERIES])
    text_want, lat_t, wall_t = _serve_async(srv, texts)
    info["text_in_thread"] = _latency(lat_t, wall_t, len(texts))
    srv.close()
    del srv

    # -- 3. the adaptive budget: its trajectory and rebuilds
    srv = build("adaptive", lambda: AsyncQueryServer(docs, emb, ServerConfig(
        adaptive_budget=True, **kw)))
    adaptive = stream[:SERVE_ADAPTIVE_QUERIES]
    got, lat, wall = _serve_async(srv, adaptive)
    s = srv.stats_snapshot()
    info["adaptive"] = dict(_latency(lat, wall, len(adaptive)),
                            self_recall=recall(got, "adaptive"),
                            budget_trajectory=s["budget_trajectory"],
                            budget_rebuilds=s["budget_rebuilds"])
    srv.close()
    del srv

    # -- 4. degradation: a queue the stream keeps over the shed depth
    srv = build("degraded", lambda: AsyncQueryServer(docs, emb, ServerConfig(
        degradation=True, shed_queue_depth=2 * B, **kw)))
    got, lat, wall = _serve_async(srv, stream)
    bad = [a for a in got if not isinstance(a, Answer)]
    if bad:
        fail(f"serving degraded: unplanned errors, first {bad[0]!r}")
    tiers = np.array([a.tier for a in got])
    if not ((tiers == 1).any() and (tiers == 2).any()):
        fail(f"serving degraded: tiers served {np.unique(tiers)}")
    step = build_serve_step(engine=srv.engine, **step_kw)
    groups: dict = {}
    for j, a in enumerate(got):
        if a.tier == 1:
            groups.setdefault(a.trace.batch.seq, []).append(j)
    for rows in groups.values():
        res = step(srv._core.pad_batch([stream[j] for j in rows]), tier=1)
        ti, td = res.topk.indices.cpu().numpy(), res.topk.dists.cpu().numpy()
        for r, j in enumerate(rows):
            if not _bit_equal(got[j], (ti[r], td[r])):
                fail(f"serving degraded: query {j}'s tier-1 answer differs "
                     "from the serve step's tier 1 on its batch")
    s = srv.stats_snapshot()
    info["degraded"] = dict(_latency(lat, wall, len(stream)),
                            tier_counts=s["tier_counts"],
                            answers_by_tier=np.bincount(tiers, minlength=3)
                            .tolist(),
                            transitions=len(s["tier_transitions"]),
                            first_transitions=s["tier_transitions"][:6],
                            tier1_batches_checked=len(groups))
    srv.close()
    del srv, step

    # -- 5. faults: a transient NaN batch and one sticky poison query, then
    # an injected worker crash
    firsts = [int(q[0][0]) for q in stream]
    j0 = next(j for j in range(3 * B, len(stream))   # not in the NaN batch
              if firsts.count(firsts[j]) == 1)
    srv = build("faults", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(**kw), faults=FaultPlan(
            nan_batches={1: "all"}, poison_word_id=firsts[j0])))
    got, _, wall = _serve_async(srv, stream)
    errs = [j for j, a in enumerate(got) if not isinstance(a, Answer)]
    if errs != [j0] or not isinstance(got[j0], PoisonQuery):
        fail(f"serving faults: errors at {errs[:8]} "
             f"({[type(got[j]).__name__ for j in errs[:8]]}), planned only "
             f"query {j0} as PoisonQuery")
    check_equal(got, want, "faults", [j for j in range(len(got)) if j != j0])
    s = srv.stats_snapshot()
    info["faults"] = dict(poisoned_query=int(j0), wall_s=wall,
                          validation_failures=s["validation_failures"],
                          validation_retries=s["validation_retries"],
                          poisoned_queries=s["poisoned_queries"],
                          worker_restarts=s["worker_restarts"])
    srv.close()
    del srv
    srv = build("crash", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(pipeline_depth=1, **kw),
        faults=FaultPlan(crash_batches=(2,))))
    done = []
    futs = []
    for j, q in enumerate(stream[:SERVE_FAULT_QUERIES]):
        fut = srv.submit(*q)
        fut.add_done_callback(lambda _f, j=j: done.append(j))
        futs.append(fut)
    srv.flush()
    if concurrent.futures.wait(futs, timeout=SERVE_WAIT_S).not_done:
        fail(f"serving crash: futures unresolved after {SERVE_WAIT_S} s")
    got = [fut.exception() or fut.result() for fut in futs]
    crashed = [j for j, a in enumerate(got) if isinstance(a, WorkerCrashed)]
    other = [j for j, a in enumerate(got)
             if not isinstance(a, (Answer, WorkerCrashed))]
    if other or crashed != list(range(2 * B, 3 * B)):
        fail(f"serving crash: WorkerCrashed at {crashed[:4]}..{crashed[-4:]}"
             f", other errors at {other[:8]}")
    if done != list(range(len(futs))):
        fail("serving crash: futures resolved out of submission order")
    check_equal(got, want, "crash",
                [j for j in range(len(got)) if j not in set(crashed)])
    s = srv.stats_snapshot()
    info["crash"] = dict(worker_restarts=s["worker_restarts"],
                         crashed=len(crashed), alive=srv.health()[
                             "worker_alive"])
    if s["worker_restarts"] != 1 or not info["crash"]["alive"]:
        fail(f"serving crash: {info['crash']}")
    srv.close()
    del srv

    # -- 6. tenants and the lifecycle between batches of a running server
    srv = build("lifecycle", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(**kw)))
    life: dict = {}
    probe = stream[:2 * B]
    before, _, _ = _serve_async(srv, probe)
    mgr = srv._core.manager
    lo, hi = (round(x * f) for x in SERVE_TENANT)
    mgr.cache_bytes = mgr.resident_bytes + 1        # below the two corpora
    _, life["add_tenant_ms"] = clocked(lambda: srv.add_corpus(
        "tenant", docs[lo:hi]))
    if mgr.is_resident("default") or mgr.stats["evictions"] != 1:
        fail(f"serving tenants: the default corpus was not evicted "
             f"({mgr.snapshot()})")
    t_ids = _host_rows(docs[lo:lo + B])
    t_futs = [srv.submit(*q, corpus_id="tenant") for q in t_ids]
    srv.flush()
    t_ans = [fu.result(timeout=SERVE_WAIT_S) for fu in t_futs]
    if any(j not in a[0] for j, a in enumerate(t_ans)):
        fail("serving tenants: a tenant query does not find itself")
    t0 = time.perf_counter()
    after, _, _ = _serve_async(srv, probe)           # readmits the default
    life["readmit_and_serve_ms"] = (time.perf_counter() - t0) * 1e3
    if mgr.stats["readmissions"] != 1 or mgr.is_resident("tenant"):
        fail(f"serving tenants: no readmission ({mgr.snapshot()})")
    check_equal(after, before, "readmission")
    mgr.cache_bytes = None
    # ingest new docs (no dedup) while batches are in flight
    n_ingest = max(32, round(SERVE_INGEST * f))
    fresh = _mixed_docs(docs, rng, n_ingest)
    bg = [srv.submit(*q) for q in stream[:SERVE_WINDOW]]
    (gids, keep), life["ingest_ms"] = clocked(lambda: srv.ingest(fresh))
    if not keep.all() or len(gids) != n_ingest:
        fail(f"serving ingest: admitted {int(keep.sum())} of {n_ingest}")
    # dedup: SERVE_COPIES exact copies of live docs among SERVE_DEDUP
    copies = torch.as_tensor(rng.choice(n, SERVE_COPIES, replace=False),
                             device=docs.device)
    new = _mixed_docs(docs, rng, SERVE_DEDUP - SERVE_COPIES)
    from repro_torch.data.docs import DocSet
    batch = DocSet(ids=torch.cat([docs.ids[copies], new.ids]),
                   weights=torch.cat([docs.weights[copies], new.weights]))
    _build.reset_launches()
    (gids2, keep2), life["dedup_ingest_ms"] = clocked(lambda: srv.ingest(
        batch, dedup_threshold=SERVE_DEDUP_THRESHOLD))
    dedup_launches = dict(_build.LAUNCHES)
    for name in ("spmm_ell", "rwmd_d21"):
        if dedup_launches.get(name, 0) < 1:
            fail(f"serving dedup ingest: kernel {name} was not launched")
    if keep2[:SERVE_COPIES].any():
        fail(f"serving dedup: admitted exact copies {keep2[:SERVE_COPIES]}")
    life["dedup_admitted_of_new"] = int(keep2[SERVE_COPIES:].sum())
    life["dedup_launches"] = dedup_launches
    # a freshly ingested doc answers itself first
    fresh_q = _host_rows(fresh[:B])
    ans, _, _ = _serve_async(srv, fresh_q)
    if any(a[0][0] != gids[j] for j, a in enumerate(ans)):
        fail("serving ingest: a freshly ingested doc does not answer itself "
             "first")
    # delete SERVE_DELETES docs: freshly ingested ones and stream picks
    dead = np.concatenate([gids[:SERVE_DELETES // 2],
                           picks[:SERVE_DELETES - SERVE_DELETES // 2]])
    bg += [srv.submit(*q) for q in stream[:SERVE_WINDOW]]
    removed, life["delete_ms"] = clocked(lambda: srv.delete_docs(dead))
    if removed != SERVE_DELETES:
        fail(f"serving delete: removed {removed} of {SERVE_DELETES}")
    dead_set = set(int(x) for x in dead)
    check = fresh_q[:SERVE_DELETES // 2] + stream[:SERVE_WINDOW]
    ans, _, _ = _serve_async(srv, check)
    if any(dead_set & set(a[0].tolist()) for a in ans):
        fail("serving delete: a deleted doc came back")
    bg += [srv.submit(*q) for q in stream[:SERVE_WINDOW]]
    _, life["compact_ms"] = clocked(lambda: srv.compact())
    ans, _, _ = _serve_async(srv, fresh_q[SERVE_DELETES // 2:] + check)
    if any(dead_set & set(a[0].tolist()) for a in ans) or any(
            a[0][0] != gids[SERVE_DELETES // 2 + j]
            for j, a in enumerate(ans[:B - SERVE_DELETES // 2])):
        fail("serving compact: a deleted doc came back or an ingested doc "
             "lost itself")
    srv.flush()
    if not all(isinstance(fu.result(timeout=SERVE_WAIT_S), Answer)
               for fu in bg):
        fail("serving lifecycle: a background query failed")
    life["segments_after_compact"] = srv.engine.n_segments
    life["cache"] = mgr.snapshot()
    info["lifecycle"] = life
    srv.close()
    del srv, mgr

    # -- 7. an indexed tenant: 64 cells, 4 probed a query, every cell a
    # slot; then one batch at the default probe cap (16), which overflows
    icfg = IndexConfig(num_cells=INDEX_CELLS, top_p=INDEX_TOP_P,
                       probe_cap=INDEX_CELLS)
    srv = build("indexed", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(index=icfg, **kw)))
    got, lat, wall = _serve_async(srv, stream)
    st = srv._core.manager.checkout("default")
    step = build_serve_step(engine=st.engine, index=st.index, **step_kw)
    if not all(isinstance(a, Answer) for a in got):
        fail("serving indexed: a future resolved with an error")
    groups = {}
    for j, a in enumerate(got):
        groups.setdefault(a.trace.batch.seq, []).append(j)
    labels = st.index.labels
    own_routed = np.zeros(len(got), dtype=bool)
    for rows in groups.values():
        qd = srv._core.pad_batch([stream[j] for j in rows])
        res = step(qd)
        ti, td = res.topk.indices.cpu().numpy(), res.topk.dists.cpu().numpy()
        if any(not _bit_equal(got[j], (ti[r], td[r]))
               for r, j in enumerate(rows)):
            fail("serving indexed: the server's answers differ from "
                 "build_serve_step(index=)'s on the same batch")
        route = st.index.route(qd)
        for r, j in enumerate(rows):
            own_routed[j] = labels[picks[j]] in route.cells[r][route.keep[r]]
    found = np.array([picks[j] in a[0] for j, a in enumerate(got)])
    if (own_routed & ~found).any():
        fail(f"serving indexed: {int((own_routed & ~found).sum())} queries "
             "routed to their own doc's cell did not find it")
    hit = float(found.mean())
    busy = _busy_window(lambda: _serve_async(srv, window))
    st.index.probe_cap = 16
    srv._core._serve = srv._core._build_serve(2 * SERVE_K)
    capped, _, _ = _serve_async(srv, stream[:B])
    prom = srv.obs.render_prometheus()
    for name in ("index_cells_probed", "index_routed_fraction",
                 "index_probe_overflow_total"):
        if f"# TYPE {name} " not in prom:
            fail(f"serving indexed: {name} not in render_prometheus")
    m = srv.metrics_snapshot()["metrics"]
    info["indexed"] = dict(
        _latency(lat, wall, len(stream)), self_recall=hit,
        own_cell_routed_share=float(own_routed.mean()),
        batches_checked=len(groups),
        window=busy,
        cells_probed_p50=m["index_cells_probed"]["series"][0]["p50"],
        probe_cap16_self_recall=float(np.mean(
            [picks[j] in a[0] for j, a in enumerate(capped)])),
        overflow_dropped=m["index_probe_overflow_total"]["series"][0]["value"],
        index_build_ms=builds["indexed"])
    srv.close()
    del srv, st, step

    # -- 8. the ingest pool: texts vectorized in spawned processes
    srv = build("pool", lambda: AsyncQueryServer(
        docs, emb, ServerConfig(ingest_workers=SERVE_POOL_WORKERS, **kw),
        preprocess=vec.query_histogram))
    got, lat, wall = _serve_async(srv, texts)
    if not all(isinstance(a, Answer) for a in got):
        fail("serving pool: a pooled query failed")
    check_equal(got, text_want, "pool (against the in-thread text path)")
    pids = [p.pid for p in srv._pool._workers]
    for pid in pids:
        maps = pathlib.Path(f"/proc/{pid}/maps").read_text()
        if "libtorch" in maps or "/torch/" in maps:
            fail(f"serving pool: ingest worker {pid} loaded torch")
    info["pool"] = dict(_latency(lat, wall, len(texts)), workers=len(pids),
                        health=srv.health()["ingest_pool"])
    srv.close()
    del srv

    info["builds_ms"] = builds
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    info["phase_s"] = time.perf_counter() - t_phase
    a, s_ = info["async"], info["sync"]
    log(f"serving ({smi}): sync {s_['qps']:.0f} queries/s (p50 "
        f"{s_['p50_ms']:.1f} ms, p99 {s_['p99_ms']:.1f} ms); async "
        f"{a['qps']:.0f} queries/s (p50 {a['p50_ms']:.1f}, p99 "
        f"{a['p99_ms']:.1f}), dispatch(i+1) before collect(i) in "
        f"{a['dispatch_before_collect_share']:.3f} of {a['batches']} batches,"
        f" busy share {a['window']['busy_share']:.3f}; launches a batch "
        f"{a['launches_per_batch']}; indexed {info['indexed']['qps']:.0f} "
        f"queries/s; pool {info['pool']['qps']:.0f} against in-thread "
        f"{info['text_in_thread']['qps']:.0f}; peak {info['peak_gb']:.2f} GB;"
        f" phase {info['phase_s']:.1f} s")
    log("serving: " + json.dumps(info, default=float))
    return info


WL_DOCS = 65_536    # the paper's all-pairs cell allpairs_64k (its row count)
WL_K = 16
WL_TILE = 1024      # the reference's default tile of 64 would make 524,800 blocks
WL_PLANTED = 64     # the last 64 rows become exact copies of docs 0-63
WL_SAMPLE = 64
WL_THRESHOLD = 0.05
WL_DELTA = 4096
WL_DELETES = 64
WL_EXTERNAL = 1024  # allpairs_64k's second set
WL_CROSS_TILE = 64
WL_DIST_TILE = 256
WL_DIST_PAIRS = 256
WL_ATOL, WL_RTOL = 2.5e-2, 1e-4   # the gram form's noise (ROADMAP C)
WL_FAMILIES = {"lc_rwmd_phase1": ("phase1_",),
               "spmm_ell": ("spmm_ell_kernel",),
               "sort": ("sort", "Sort")}


def _near(name, got_d, got_i, ref_d, ref_i) -> float:
    """Distances within WL_ATOL + WL_RTOL*|d|; ids equal wherever both
    neighbouring gaps of the reference exceed that tolerance.  ``ref_*``
    carry one more column than ``got_*`` (the first dropped candidate)."""
    import torch

    k = got_d.shape[1]
    tol = WL_ATOL + WL_RTOL * ref_d.abs()
    err = (got_d - ref_d[:, :k]).abs()
    if not bool((err <= tol[:, :k]).all()):
        fail(f"{name}: distances differ by up to {float(err.max())}")
    gaps = ref_d[:, 1:] - ref_d[:, :-1]
    big = torch.ones_like(got_d, dtype=torch.bool)
    big[:, 1:] &= gaps[:, :k - 1] > tol[:, 1:k]
    big &= gaps[:, :k] > tol[:, :k]
    bad = (got_i != ref_i[:, :k]) & big
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} ids differ where the gaps exceed the "
             "tolerance")
    return float(err.max())


def _ascending_no_self(name, tk, rows) -> None:
    import torch

    d, i = tk.dists, tk.indices
    if bool((i == rows[:, None]).any()):
        fail(f"{name}: a doc is its own neighbour")
    fin = torch.isfinite(d)
    if bool(((d[:, 1:] < d[:, :-1]) & fin[:, 1:]).any()) or bool(
            torch.isnan(d).any()):
        fail(f"{name}: a row is not ascending, or holds NaN")


def _launched(name, launches, want) -> None:
    for kern in want:
        if launches.get(kern, 0) < 1:
            fail(f"{name}: kernel {kern} was not launched ({launches})")


def workloads_phase(docs, emb, smi: str) -> dict:
    """The corpus workloads on the card (``repro_torch.workloads``), on the
    first min(65,536, n) docs of the corpus with their last 64 rows made
    exact copies of docs 0-63: self all-pairs top-k (the pair scheduler: B1
    once a tile, B2 twice a visited block), the same on a segmented engine
    (bit-equal; then 64 deletions), the near-duplicate and kNN graphs, the
    cross-corpus top-k (the d21 mode) and the serve-step all-pairs (B1, B3)."""
    import numpy as np
    import torch

    from repro_torch.core.lc_rwmd import LCRWMDEngine, SegmentedEngine
    from repro_torch.core.topk import topk_smallest
    from repro_torch.data.docs import DocSet
    from repro_torch.kernels import _build
    from repro_torch.workloads import (connected_components,
                                       corpus_self_topk,
                                       corpus_self_topk_distributed,
                                       corpus_vs_corpus_topk,
                                       duplicate_groups, knn_graph,
                                       near_duplicate_graph)

    t_phase = time.perf_counter()
    dev = docs.device
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_all = docs.n_docs
    n = min(WL_DOCS, n_all)
    src = docs.slice_rows(0, n)
    ids, w = src.ids.clone(), src.weights.clone()
    ids[n - WL_PLANTED:], w[n - WL_PLANTED:] = ids[:WL_PLANTED], w[:WL_PLANTED]
    wdocs = DocSet(ids=ids, weights=w)
    twin = torch.arange(WL_PLANTED, device=dev)
    twin = torch.cat([twin + n - WL_PLANTED, twin])       # of rows 0-63, then
    planted = torch.cat([torch.arange(WL_PLANTED, device=dev),  # their copies
                         torch.arange(n - WL_PLANTED, n, device=dev)])
    eng, build_ms = clocked(lambda: LCRWMDEngine(wdocs, emb, device=dev))
    v_e = eng.emb_restricted.shape[0]
    n_tiles = -(-n // WL_TILE)
    n_blocks = n_tiles * (n_tiles + 1) // 2
    info = dict(card=smi, n_docs=n, v_e=v_e, tile=WL_TILE, k=WL_K,
                tiles=n_tiles, blocks=n_blocks, engine_build_ms=build_ms,
                z_cache_gb=n * v_e * 4 / 1e9,
                z_cache_gb_at_700k=700_000 * v_e * 4 / 1e9)
    log(f"workloads: {n} docs (first {n} of {n_all}), v_e={v_e}; the "
        f"scheduler's Z cache is n*v_e*4 B = {info['z_cache_gb']:.2f} GB "
        f"({info['z_cache_gb_at_700k']:.1f} GB at 700,000 docs); tile "
        f"{WL_TILE}: {n_tiles} tiles, {n_blocks} blocks")
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(23)
    sample = torch.as_tensor(np.sort(rng.choice(
        np.arange(WL_PLANTED, n - WL_PLANTED), WL_SAMPLE, replace=False)),
        device=dev)
    times, launches = {}, {}

    def run(name, fn):
        _build.reset_launches()
        out, ms = clocked(fn)
        times[name] = ms
        launches[name] = dict(_build.LAUNCHES)
        if not launches[name]:
            fail(f"workloads {name}: no kernel was launched")
        return out

    # -- self all-pairs top-k, monolithic
    tk = run("corpus_self_topk", lambda: corpus_self_topk(eng, WL_K,
                                                          tile=WL_TILE))
    lw = launches["corpus_self_topk"]
    if (lw.get("lc_rwmd_phase1") != n_tiles
            or lw.get("spmm_ell") != 2 * n_blocks):
        fail(f"corpus_self_topk: launches {lw}, want B1 once a tile "
             f"({n_tiles}) and B2 twice a block ({2 * n_blocks})")
    if tuple(tk.indices.shape) != (n, WL_K) or bool((tk.indices < 0).any()):
        fail("corpus_self_topk: bad shape or an unfilled slot")
    _ascending_no_self("corpus_self_topk", tk, rows)
    if not torch.equal(tk.indices[planted, 0].long(), twin):
        fail("corpus_self_topk: a planted doc's top-1 is not its copy")
    ref = eng.symmetric_topk_streaming(eng.resident_tile(sample), WL_K + 2)
    keep = ref.indices != sample[:, None]
    if not bool((keep.sum(1) == WL_K + 1).all()):
        fail("corpus_self_topk: a sampled doc is not in its own "
             "symmetric_topk_streaming row")
    ref_d = ref.dists[keep].reshape(WL_SAMPLE, WL_K + 1)
    ref_i = ref.indices[keep].reshape(WL_SAMPLE, WL_K + 1)
    info["self_sample_max_abs_err"] = _near(
        "corpus_self_topk vs symmetric_topk_streaming", tk.dists[sample],
        tk.indices[sample], ref_d, ref_i)
    info["peak_gb_self"] = torch.cuda.max_memory_allocated() / 1e9
    # where the time goes: the call's device time by kernel group
    t0 = time.perf_counter()
    info["self_profile"] = _busy_window(
        lambda: corpus_self_topk(eng, WL_K, tile=WL_TILE), WL_FAMILIES,
        "corpus_self_topk", times["corpus_self_topk"])
    info["self_profile"]["profile_s"] = time.perf_counter() - t0

    # -- the same on a segmented engine: bit-equal, then 64 deletions
    seng, seg_build_ms = clocked(lambda: SegmentedEngine(
        wdocs.slice_rows(0, n - WL_DELTA), emb, device=dev))
    seng.append(wdocs.slice_rows(n - WL_DELTA, WL_DELTA))
    stk = run("corpus_self_topk_segmented", lambda: corpus_self_topk(
        seng, WL_K, tile=WL_TILE))
    _launched("corpus_self_topk_segmented",
              launches["corpus_self_topk_segmented"],
              ("lc_rwmd_phase1", "spmm_ell"))
    if not (torch.equal(stk.indices, tk.indices)
            and torch.equal(stk.dists, tk.dists)):
        fail("corpus_self_topk: the segmented engine (base + one delta) is "
             "not bit-equal to the monolithic one")
    dead = np.sort(rng.choice(np.arange(WL_PLANTED, n - WL_PLANTED),
                              WL_DELETES, replace=False))
    seng.delete(dead)
    stk = run("corpus_self_topk_deleted", lambda: corpus_self_topk(
        seng, WL_K, tile=WL_TILE))
    dead_t = torch.as_tensor(dead, device=dev)
    if bool(torch.isin(stk.indices, dead_t.to(torch.int32)).any()):
        fail("corpus_self_topk after deletions: a deleted doc is a neighbour")
    if not (bool((stk.indices[dead_t] == -1).all())
            and bool(torch.isinf(stk.dists[dead_t]).all())):
        fail("corpus_self_topk after deletions: a deleted doc's row is not "
             "all unfilled slots")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[dead_t] = False
    if bool((stk.indices[alive] < 0).any()):
        fail("corpus_self_topk after deletions: a live doc has an unfilled "
             "slot")
    info["segments"] = dict(build_ms=seg_build_ms, delta=WL_DELTA,
                            deletes=WL_DELETES, bit_equal=True)
    del seng, stk
    torch.cuda.empty_cache()

    # -- near-duplicate graph and the kNN graphs
    g = run("near_duplicate_graph", lambda: near_duplicate_graph(
        eng, WL_THRESHOLD, tile=WL_TILE))
    ptr, nbr = g.indptr, g.indices
    pl = planted.cpu().numpy()
    tw = twin.cpu().numpy()
    for i, j in zip(pl, tw):
        if j not in nbr[ptr[i]:ptr[i + 1]]:
            fail(f"near_duplicate_graph: the planted pair ({i}, {j}) is not "
                 "an edge")
    src_rows = np.repeat(np.arange(n), np.diff(ptr))
    if bool((src_rows == nbr).any()):
        fail("near_duplicate_graph: a self-loop")
    labels = connected_components(g)
    groups = duplicate_groups(g)
    if not all(labels[i] == labels[j] for i, j in zip(pl, tw)):
        fail("duplicate_groups: a planted pair is split")
    info["near_duplicate"] = dict(threshold=WL_THRESHOLD, edges=g.n_edges,
                                  groups=len(groups),
                                  largest=len(groups[0]) if groups else 0)
    union = run("knn_graph_union", lambda: knn_graph(eng, WL_K, tile=WL_TILE))
    mutual = run("knn_graph_mutual", lambda: knn_graph(
        eng, WL_K, tile=WL_TILE, mutual=True))
    ue = set(zip(np.repeat(np.arange(n), np.diff(union.indptr)).tolist(),
                 union.indices.tolist()))
    me = zip(np.repeat(np.arange(n), np.diff(mutual.indptr)).tolist(),
             mutual.indices.tolist())
    if mutual.n_edges > union.n_edges or not all(e in ue for e in me):
        fail("knn_graph: the mutual graph is not a subset of the union")
    info["knn_graph"] = dict(union_edges=union.n_edges,
                             mutual_edges=mutual.n_edges)
    del g, union, mutual, ue

    # -- cross-corpus top-k: an external 1,024-doc set against the engine
    lo = n if n_all >= n + WL_EXTERNAL else n_all - WL_EXTERNAL
    ext = docs.slice_rows(lo, WL_EXTERNAL)
    res = run("corpus_vs_corpus_topk", lambda: corpus_vs_corpus_topk(
        eng, ext, WL_K, tile=WL_CROSS_TILE, resident_side=True))
    _launched("corpus_vs_corpus_topk", launches["corpus_vs_corpus_topk"],
              ("lc_rwmd_phase1", "spmm_ell", "rwmd_d21"))
    ref = eng.symmetric_topk_streaming(ext, WL_K + 1)
    info["cross_query_max_abs_err"] = _near(
        "corpus_vs_corpus_topk (query side)", res.query_topk.dists,
        res.query_topk.indices, ref.dists, ref.indices)
    d_full = eng.symmetric(ext)                               # (n, 1,024)
    ref = topk_smallest(d_full[sample], WL_K + 1)
    info["cross_resident_max_abs_err"] = _near(
        "corpus_vs_corpus_topk (resident side)",
        res.resident_topk.dists[sample], res.resident_topk.indices[sample],
        ref.dists, ref.indices)
    info["cross"] = dict(external_rows=[lo, lo + WL_EXTERNAL],
                         tile=WL_CROSS_TILE)
    del d_full, res

    # -- all-pairs through the serve step (self-excluding, refined)
    dk = run("corpus_self_topk_distributed", lambda: (
        corpus_self_topk_distributed(eng, None, WL_K, tile=WL_DIST_TILE,
                                     refine=True)))
    _launched("corpus_self_topk_distributed",
              launches["corpus_self_topk_distributed"],
              ("lc_rwmd_phase1", "fused_topk"))
    _ascending_no_self("corpus_self_topk_distributed", dk, rows)
    pi = torch.as_tensor(rng.choice(n, WL_DIST_PAIRS, replace=False),
                         device=dev)
    pj = dk.indices[pi, torch.as_tensor(
        rng.integers(0, WL_K, WL_DIST_PAIRS), device=dev)].long()
    sym = eng.symmetric_resident(pi)                          # (n, 256)
    want = sym[pj, torch.arange(WL_DIST_PAIRS, device=dev)]
    got = dk.dists[pi].gather(1, (dk.indices[pi].long() == pj[:, None])
                              .float().argmax(1, keepdim=True))[:, 0]
    err = (got - want).abs()
    if not bool((err <= WL_ATOL + WL_RTOL * want.abs()).all()):
        fail(f"corpus_self_topk_distributed: a refined distance differs from "
             f"symmetric_resident's by {float(err.max())}")
    info["distributed_max_abs_err"] = float(err.max())
    del dk, sym, eng
    torch.cuda.empty_cache()

    info["times_ms"] = times
    info["launches"] = launches
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    info["phase_s"] = time.perf_counter() - t_phase
    sp = info["self_profile"]
    log(f"workloads ({smi}): " + ", ".join(
        f"{k} {v / 1e3:.2f} s" for k, v in times.items())
        + f"; corpus_self_topk: {sp['device_ms']:.0f} device ms in "
        f"{sp['wall_ms']:.0f} ms (busy {sp['busy_share']:.3f}; " + ", ".join(
            f"{g} {ms:.0f}" for g, ms in sp["by_group"].items())
        + f"); peak {info['peak_gb']:.2f} GB; phase {info['phase_s']:.1f} s")
    log("workloads: " + json.dumps(info, default=float))
    return info


def entry_points_phase(smi: str, argv: tuple = ()) -> dict:
    """The examples and the serving launcher on the card, each through its
    ``main`` at its default sizes (serve_queries also with --async
    --rerank-wmd), with their own gates and the counts reset just before
    and read just after: B1, B2, B3, B4 and the d21 mode must each run.
    ``argv`` goes to every ``main`` (``("--device", "cpu")`` rehearses the
    phase without a card)."""
    import numpy as np
    import torch

    from repro_torch.examples import (cluster_corpus, knn_classify,
                                      quickstart, serve_queries)
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launcher

    runs = {
        "quickstart": lambda: quickstart.main([*argv]),
        "knn_classify": lambda: knn_classify.main([*argv]),
        "cluster_corpus": lambda: cluster_corpus.main([*argv]),
        "serve_queries": lambda: serve_queries.main([*argv]),
        "serve_queries_async_rerank": lambda: serve_queries.main(
            [*argv, "--async", "--rerank-wmd"]),
        "launch.serve": lambda: launcher.main([*argv]),
    }
    out, times = {}, {}
    torch.cuda.synchronize()
    _build.reset_launches()
    for name, fn in runs.items():
        out[name], times[name] = clocked(fn)
    launches = dict(_build.LAUNCHES)
    _launched("entry points", launches, ("lc_rwmd_phase1", "spmm_ell",
                                         "fused_topk", "sinkhorn_wmd",
                                         "rwmd_d21"))
    qs = out["quickstart"]
    if not (np.array_equal(qs["top_ids"][:, 0], np.arange(4))
            and np.isfinite(qs["top_dists"]).all()
            and qs["lc_vs_quadratic_max_diff"] <= WL_ATOL):
        fail(f"quickstart: {qs}")
    kn = out["knn_classify"]
    if not min(kn["acc_wcd"], kn["acc_rwmd"], kn["acc_wmd"]) > 0.25:
        fail(f"knn_classify: an accuracy at or below chance: {kn}")
    cc = out["cluster_corpus"]
    if not ([3, 4, 200] in cc["groups"] and [9, 150] in cc["groups"]
            and cc["ari"] > cc["ari_wcd"]):
        fail(f"cluster_corpus: planted groups or ARI: {cc['groups']}, "
             f"{cc['ari']} vs {cc['ari_wcd']}")
    if out["launch.serve"]["self_recall"] < 0.99:
        fail(f"launch.serve: self-recall {out['launch.serve']['self_recall']}")
    for flags, shape in ((["--full"], "16x16"),
                         (["--full", "--multi-pod"], "2x16x16")):
        try:
            launcher.main(flags)
        except ValueError as e:   # the production mesh refuses one rank
            if f"{shape} > 1 ranks" not in str(e):
                fail(f"launch.serve {flags}: {e}")
        else:
            fail(f"launch.serve {flags} did not raise")
    info = dict(card=smi, ms=times, launches=launches,
                quickstart=dict(top1=qs["top_ids"][:, 0].tolist(),
                                lc_vs_quadratic=qs["lc_vs_quadratic_max_diff"],
                                rwmd=qs["rwmd"], wmd=qs["wmd"]),
                knn_classify={k: kn[k] for k in ("acc_wcd", "acc_rwmd",
                                                  "acc_wmd", "budget")},
                cluster_corpus={k: cc[k] for k in ("ari", "purity", "ari_wcd",
                                                    "purity_wcd", "n_edges",
                                                    "groups")},
                serve_queries={k: {x: out[k][x] for x in (
                    "mode", "recall", "ms_per_query")}
                    for k in ("serve_queries", "serve_queries_async_rerank")},
                launch_serve={x: out["launch.serve"][x]
                              for x in ("self_recall", "ms_per_query")})
    log(f"entry points ({smi}): " + ", ".join(
        f"{k} {v / 1e3:.2f} s" for k, v in times.items()))
    log("entry points: " + json.dumps(info, default=float))
    return info


MESH_K = 32
MESH_BUDGET = 64          # the tier-0 step's rerank budget (2k)
MESH_SHARDS = (2, 8)      # model shards run rank by rank
MESH_SPAWN_DOCS = 65_536  # docs of the multi-card check (a copy each rank)
MESH_TOL = 1e-5           # B2's: |d - d_one| <= 1e-5 (1 + |d|)


def _same(a, b) -> bool:
    """Two serve results (or tensors) equal bit for bit, None for None."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is b
    return all(_same(x, y) for x, y in zip(a, b) if not isinstance(x, int))


def _mesh_segments(docs, emb, device):
    """The multi-card check's segmented engine: two segments split at
    ``MESH_SEG_SPLIT`` (or half the docs), a tombstone every
    ``MESH_SEG_DEAD_EVERY``-th doc from doc 64."""
    import numpy as np

    from repro_torch.core.lc_rwmd import SegmentedEngine

    cut = min(MESH_SEG_SPLIT, docs.n_docs // 2)
    seg = SegmentedEngine(docs[:cut], emb, device=device)
    seg.append(docs[cut:])
    seg.delete(np.arange(64, docs.n_docs, MESH_SEG_DEAD_EVERY))
    return seg


def _mesh_rank(rank: int, n: int, device_type: str, inputs: str,
               out_dir: str) -> None:
    """One rank of the multi-card check: a file rendezvous (NCCL on the
    card, gloo on the CPU), a copy of the docs on its own device, the
    monolithic and the segmented streaming steps at (1, n) and (n, 1), and
    an ``AsyncQueryServer`` at (1, n) answering the queries."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.data.docs import DocSet
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import AsyncQueryServer, ServerConfig

    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"file://{out_dir}/rendezvous", rank=rank, world_size=n)
    try:
        dev = torch.device("cuda", rank) if device_type == "cuda" else "cpu"
        data = np.load(inputs)
        docs = DocSet(ids=torch.tensor(data["ids"], device=dev),
                      weights=torch.tensor(data["weights"], device=dev))
        engines = {"": LCRWMDEngine(docs, data["emb"], device=dev),
                   "seg/": _mesh_segments(docs, data["emb"], dev)}
        out = {}
        for name, shape in (("1xn", (1, n)), ("nx1", (n, 1))):
            mesh = make_host_mesh(*shape, device=device_type)
            for tag, eng in engines.items():
                before = (mesh.counts["psum"], mesh.counts["all_gather"])
                tk = build_serve_step(mesh, k=int(data["k"]), engine=eng,
                                      bf16_matmul=False)(
                    docs[:int(data["b"])]).topk
                out[f"{tag}{name}/d"] = tk.dists.cpu().numpy()
                out[f"{tag}{name}/i"] = tk.indices.cpu().numpy()
                out[f"{tag}{name}/collectives"] = np.array(
                    [mesh.counts["psum"] - before[0],
                     mesh.counts["all_gather"] - before[1]])
        # the async server over the ranks: rank 0's decisions, every
        # rank's own copy of the queries
        b = int(data["b"])
        cfg = ServerConfig(**_mesh_server_cfg(b, int(data["k"]), docs.h_max))
        mesh = make_host_mesh(1, n, device=device_type)
        with AsyncQueryServer(docs, torch.tensor(data["emb"]), cfg,
                              mesh=mesh) as srv:
            futs = [srv.submit(i, w) for i, w in zip(data["ids"][:b],
                                                     data["weights"][:b])]
            srv.drain()
            answers = [f.result() for f in futs]
        out["async/d"] = np.stack([a[1] for a in answers])
        out["async/i"] = np.stack([a[0] for a in answers])
        out["async/tier"] = np.array([a.tier for a in answers])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _mesh_server_cfg(b: int, k: int, h_max: int) -> dict:
    """The multi-card check's async server: one batch of the b queries
    through the plain streaming step at the default tier (no refine, no
    rerank)."""
    return dict(k=k, max_batch=b, h_max=h_max, max_wait_s=1.0)


def mesh_multi_card(docs, emb, n: int, device_type: str = "cuda") -> dict:
    """``n`` spawned ranks, one device each, on the first
    ``MESH_SPAWN_DOCS`` docs, monolithic and as two segments with
    tombstones: every rank's TopK the same, and within B2's tolerance of
    the one-device step's (ids by the distance they name); an
    ``AsyncQueryServer`` at (1, n): every rank's answers the same, within
    B2's tolerance of the one-device async server's (ids equal where the
    neighbouring gaps exceed it)."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.serving import AsyncQueryServer, ServerConfig

    sub = docs[:min(MESH_SPAWN_DOCS, docs.n_docs)]
    q = sub[:B]
    wants = {}
    for tag, eng in (("", LCRWMDEngine(sub, emb, device=sub.device)),
                     ("seg/", _mesh_segments(sub, emb, sub.device))):
        want = build_serve_step(k=MESH_K, engine=eng, bf16_matmul=False)(q)
        wants[tag] = (want.topk.dists.cpu().numpy(),
                      eng.one_sided(q).cpu().numpy())
    with AsyncQueryServer(sub, emb, ServerConfig(
            device=sub.device, **_mesh_server_cfg(B, MESH_K, sub.h_max))) as srv:
        futs = [srv.submit(i, w) for i, w in _host_rows(q)]
        srv.drain()
        one_card = [f.result() for f in futs]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as tmp:
        inputs = f"{tmp}/inputs.npz"
        np.savez(inputs, ids=sub.ids.cpu().numpy(),
                 weights=sub.weights.cpu().numpy(),
                 emb=torch.as_tensor(emb).cpu().numpy(), b=B, k=MESH_K)
        mp.spawn(_mesh_rank, args=(n, device_type, inputs, tmp), nprocs=n,
                 join=True)
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(n)]
    info = dict(ranks=n, docs=sub.n_docs, s=time.perf_counter() - t0)
    for name in [f"{t}{s}" for t in wants for s in ("1xn", "nx1")]:
        want_d, d_one = wants[name[:-3]]
        tol = MESH_TOL * (1 + np.abs(want_d))
        d, i = ranks[0][f"{name}/d"], ranks[0][f"{name}/i"]
        if not all(np.array_equal(r[f"{name}/{x}"], ranks[0][f"{name}/{x}"])
                   for r in ranks for x in ("d", "i")):
            fail(f"mesh {name} on {n} cards: the ranks' TopKs differ")
        named = np.take_along_axis(d_one.T, i.astype(np.int64), axis=1)
        err = max(float(np.abs(d - want_d).max()),
                  float(np.abs(named - want_d).max()))
        if (np.abs(d - want_d) > tol).any() or (
                np.abs(named - want_d) > tol).any():
            fail(f"mesh {name} on {n} cards: TopK off the one-card step's "
                 f"by {err}")
        info[name] = dict(max_abs_err=err,
                          collectives=ranks[0][f"{name}/collectives"].tolist())
    if not all(np.array_equal(r[f"async/{x}"], ranks[0][f"async/{x}"])
               for r in ranks for x in ("d", "i", "tier")):
        fail(f"mesh AsyncQueryServer on {n} cards: the ranks' answers differ")
    want_d = np.stack([a[1] for a in one_card])
    want_i = np.stack([a[0] for a in one_card])
    d, i = ranks[0]["async/d"], ranks[0]["async/i"]
    tol = MESH_TOL * (1 + np.abs(want_d))
    gaps = np.diff(want_d, axis=1)
    clear = np.ones(want_d.shape, bool)
    clear[:, 1:] &= gaps > tol[:, 1:]
    clear[:, :-1] &= gaps > tol[:, :-1]
    if ((np.abs(d - want_d) > tol).any() or (i != want_i)[clear].any()
            or (ranks[0]["async/tier"] != 0).any()):
        fail(f"mesh AsyncQueryServer on {n} cards: off the one-card "
             f"server's answers by {float(np.abs(d - want_d).max())}")
    info["async_server"] = dict(
        max_abs_err=float(np.abs(d - want_d).max()),
        ids_equal_share=float((i == want_i).mean()))
    return info


def mesh_phase(docs, emb, smi: str) -> dict:
    """The mesh program (``repro_torch.launch.mesh``) on the card: in a
    world-size-1 NCCL group set up and torn down here, the 1x1 mesh's
    monolithic streaming step (k = 32), its tier 0 with the refine and the
    rerank, the engine-less step and the all-pairs D1 on all the docs,
    with the counts reset just before and read just after (B1, B2, B3 and
    B4 must each run); each equal to the mesh-less call's result bit for
    bit and timed beside it.  Then each of 2 and 8 vocabulary shards, run
    rank by rank in this process, its B1 and B2 partial, the partials
    summed in rank order against ``one_sided`` within B2's tolerance (B1
    and B2 launches counted); and, where there are two cards or more,
    min(cards, 4) spawned NCCL ranks at (1, n) and (n, 1), the monolithic
    and the segmented step."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.distributed.lcrwmd_dist import (build_allpairs_d1,
                                                     build_serve_step)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_mesh_ranks import RankAlone

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = LCRWMDEngine(docs, emb)
    q = docs[:B]
    emb_d = eng.emb_full   # the table on the card: no copy a call
    kw = dict(k=MESH_K, bf16_matmul=False)
    rerank = dict(refine=True, rerank_wmd=True, rerank_budget=MESH_BUDGET,
                  wmd_kw=KW_RERANK)
    builds = {
        "stream_k32": (lambda m: build_serve_step(m, engine=eng, **kw),
                       lambda s: s(q)),
        "tier0_rerank": (lambda m: build_serve_step(m, engine=eng, **kw,
                                                    **rerank),
                         lambda s: s(q)),
        "engineless": (lambda m: build_serve_step(m, device="cuda", **kw),
                       lambda s: s(docs, q, emb_d)),
        "allpairs_d1": (lambda m: build_allpairs_d1(m, bf16_matmul=False,
                                                    device="cuda"),
                        lambda s: s(docs, q, emb_d)),
    }
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            if mesh.size != 1 or mesh.device.type != eng.device.type:
                fail(f"make_host_mesh() in a world of one: {mesh}")
            steps = {name: (b(mesh), b(None), call)
                     for name, (b, call) in builds.items()}
            torch.cuda.synchronize()
            _build.reset_launches()
            got = {name: call(m) for name, (m, _, call) in steps.items()}
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            _launched("mesh", launches, ("lc_rwmd_phase1", "spmm_ell",
                                         "fused_topk", "sinkhorn_wmd"))
            if sum(mesh.counts.values()):
                fail(f"a 1x1 mesh issued collectives: {dict(mesh.counts)}")
            for name, (_, one, call) in steps.items():
                if not _same(got[name], call(one)):
                    fail(f"mesh {name}: the 1x1 mesh step differs from the "
                         "mesh-less one")
            self_ids = torch.arange(B, device=eng.device)
            d_self = got["allpairs_d1"][self_ids, self_ids]
            if not bool((got["stream_k32"].topk.dists[:, 0] <= d_self).all()):
                fail("mesh stream_k32: a top-1 lies above the query's own "
                     "distance")
            if not bool((got["tier0_rerank"].topk.indices[:, 0]
                         == self_ids).all()):
                fail("mesh tier0_rerank: a query's top-1 is not itself")
            del got
            times = {}
            for name, (m, one, call) in steps.items():
                a = wall_ms(lambda: call(m))
                b = wall_ms(lambda: call(one))
                times[name] = dict(mesh_ms=[a, wall_ms(lambda: call(m))],
                                   meshless_ms=[b, wall_ms(lambda: call(one))])
        finally:
            dist.destroy_process_group()

    # each model shard's kernel work, rank by rank (its own counts)
    want = eng.one_sided(q)
    torch.cuda.synchronize()
    _build.reset_launches()
    eng.one_sided(q)
    b1_call = _build.LAUNCHES["lc_rwmd_phase1"]
    shards = {}
    for n_sh in MESH_SHARDS:
        torch.cuda.synchronize()
        _build.reset_launches()
        total = 0
        for rank in range(n_sh):
            total = total + build_serve_step(
                RankAlone(n_sh, rank, want.device), engine=eng, k=MESH_K,
                streaming=False, bf16_matmul=False)(q).d_local
        torch.cuda.synchronize()
        sl = dict(_build.LAUNCHES)
        err = (total - want).abs()
        if bool((err > MESH_TOL * (1 + want.abs())).any()):
            fail(f"mesh: {n_sh} vocabulary shards' partials do not sum to "
                 f"one_sided (max |err| {float(err.max())})")
        if (sl.get("lc_rwmd_phase1", 0) != n_sh * b1_call
                or sl.get("spmm_ell", 0) != n_sh):
            fail(f"mesh: {n_sh} shards launched {sl}")
        shards[n_sh] = dict(b1=sl["lc_rwmd_phase1"], b2=sl["spmm_ell"],
                            max_abs_err=float(err.max()))
    del total, want, eng

    cards = torch.cuda.device_count()
    if cards >= 2:
        multi = mesh_multi_card(docs, emb, min(cards, 4))
    else:
        multi = None
        log(f"mesh: the multi-card check is skipped: "
            f"torch.cuda.device_count() = {cards}")
    info = dict(card=smi, launches=launches, times=times, shards=shards,
                multi_card=multi,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                s=time.perf_counter() - t_phase)
    log(f"mesh ({smi}): 1x1 mesh bit-equal to the mesh-less step in "
        f"{list(steps)}; ms mesh / mesh-less: " + ", ".join(
            f"{k} {v['mesh_ms'][0]:.2f}/{v['meshless_ms'][0]:.2f}"
            for k, v in times.items()) + f"; phase {info['s']:.1f} s")
    log("mesh: " + json.dumps(info, default=float))
    return info


MESH_SEG_SPLIT = 49_152   # the multi-card check's segments: [0, this), the rest
MESH_SEG_DEAD_EVERY = 97  # and a tombstone every 97th doc from doc 64


def mesh_segmented_phase(eng, idx, docs, emb, q, smi: str) -> dict:
    """The segmented and routed steps and both servers on a 1x1 mesh,
    over the segmented phase's engine (4 segments, its tombstones) and its
    64-cell index, in a world-size-1 NCCL group set up and torn down here.
    With the counts reset just before and read just after: the segmented
    step (k = 32), its tier 0 with the refine and the rerank (budget 64),
    the routed step (top_p 4), a ``QueryServer`` on the mesh answering
    the 64 queries (its own engine of all the docs) and an
    ``AsyncQueryServer`` on the mesh answering them as raw texts through an
    ingest pool of 2 workers (the serving phase's vectorizer); B1, B3 and
    B4 must each run, and no collective be issued.  Each equal to the
    mesh-less call (and server) bit for bit, the steps timed beside it;
    the async server's answers also equal the sync mesh server's on the
    same texts, and every query finds itself."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import AsyncQueryServer, QueryServer, ServerConfig

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(k=MESH_K, bf16_matmul=False)
    rerank = dict(refine=True, rerank_wmd=True, rerank_budget=MESH_BUDGET,
                  wmd_kw=KW_RERANK)
    builds = {
        "seg_k32": lambda m: build_serve_step(m, engine=eng, **kw),
        "seg_tier0_rerank": lambda m: build_serve_step(m, engine=eng, **kw,
                                                       **rerank),
        "routed_p4": lambda m: build_serve_step(m, engine=eng, index=idx,
                                                **kw),
    }
    cfg = dict(k=SERVE_K, max_batch=B, h_max=48, refine_symmetric=True,
               rerank_wmd=True, wmd_kw=KW_RERANK, max_wait_s=1.0)
    stream = _host_rows(q)
    vec = _text_vectorizer(emb.shape[0])
    texts = _texts(stream)
    with tempfile.TemporaryDirectory(prefix="mesh_seg_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            if mesh.size != 1 or mesh.device.type != eng.device.type:
                fail(f"make_host_mesh() in a world of one: {mesh}")
            steps = {name: (b(mesh), b(None)) for name, b in builds.items()}
            servers, asyncs, build_ms = {}, {}, {}
            for name, m in (("mesh", mesh), ("meshless", None)):
                servers[name], build_ms[name] = clocked(
                    lambda m=m: QueryServer(docs, emb, ServerConfig(**cfg),
                                            mesh=m,
                                            preprocess=vec.query_histogram))
                asyncs[name], build_ms[f"async_{name}"] = clocked(
                    lambda m=m: AsyncQueryServer(
                        docs, emb, ServerConfig(
                            ingest_workers=SERVE_POOL_WORKERS, **cfg),
                        mesh=m, preprocess=vec.query_histogram))
            torch.cuda.synchronize()
            _build.reset_launches()
            got = {name: m(q) for name, (m, _) in steps.items()}
            answers = _serve_sync(servers["mesh"], stream, B)[0]
            async_got = _serve_async(asyncs["mesh"], texts)[0]
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            _launched("mesh segmented", launches,
                      ("lc_rwmd_phase1", "fused_topk", "sinkhorn_wmd"))
            if sum(mesh.counts.values()):
                fail(f"a 1x1 mesh issued collectives: {dict(mesh.counts)}")
            for name, (_, one) in steps.items():
                if not _same(got[name], one(q)):
                    fail(f"mesh {name}: the 1x1 mesh step differs from the "
                         "mesh-less one")
            want = _serve_sync(servers["meshless"], stream, B)[0]
            for j, (a, b) in enumerate(zip(answers, want)):
                if not (_bit_equal(a, b) and a.tier == b.tier == 0):
                    fail(f"mesh QueryServer: answer {j} differs from the "
                         "mesh-less server's")
            live = eng.live_mask()
            for name, r in got.items():
                i = r.topk.indices.cpu().numpy()
                if (i < 0).any() or not live[i].all():
                    fail(f"mesh {name}: a dead doc or filler in the result")
            if not all(j in a[0] for j, a in enumerate(answers)):
                fail("mesh QueryServer: a query did not find itself")
            # the async server on the mesh: raw texts through its pool
            async_want = _serve_async(asyncs["meshless"], texts)[0]
            for t in texts:
                servers["mesh"].submit(t)
            sync_texts = servers["mesh"].flush()
            for j, a in enumerate(async_got):
                if not (_bit_equal(a, async_want[j]) and _bit_equal(
                        a, sync_texts[j]) and a.tier == 0):
                    fail(f"mesh AsyncQueryServer: answer {j} differs from "
                         "the mesh-less async server's or the sync mesh "
                         "server's on the same texts")
            if not all(j in a[0] for j, a in enumerate(async_got)):
                fail("mesh AsyncQueryServer: a query did not find itself")
            del got
            times = {}
            for name, (m, one) in steps.items():
                a = wall_ms(lambda: m(q))
                b = wall_ms(lambda: one(q))
                times[name] = dict(mesh_ms=[a, wall_ms(lambda: m(q))],
                                   meshless_ms=[b, wall_ms(lambda: one(q))])
            for name in ("mesh", "meshless"):
                times[f"server_{name}"] = dict(stream_ms=(_serve_sync(
                    servers[name], stream, B)[2]) * 1e3)
                times[f"async_{name}"] = dict(stream_ms=(_serve_async(
                    asyncs[name], texts)[2]) * 1e3)
                asyncs[name].close()
            del servers, asyncs
        finally:
            dist.destroy_process_group()
    info = dict(card=smi, launches=launches, times=times,
                server_build_ms=build_ms,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                s=time.perf_counter() - t_phase)
    log(f"mesh segmented ({smi}): the 1x1 mesh bit-equal to the mesh-less "
        f"step in {list(steps)}, the QueryServer and the AsyncQueryServer "
        "(texts through a pool of 2); ms mesh / mesh-less: "
        + ", ".join(f"{k} {v['mesh_ms'][0]:.2f}/{v['meshless_ms'][0]:.2f}"
                    for k, v in times.items() if "mesh_ms" in v)
        + f"; phase {info['s']:.1f} s")
    log("mesh segmented: " + json.dumps(info, default=float))
    return info


def lcrwmd_phases(scale: float, smi: str) -> dict:
    """Phases 3-6 on one LC-RWMD corpus; returns the kernel report of B1-B7.

    Everything the phases build is freed when this returns.
    """
    import torch

    from repro_torch.kernels import _build
    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.core.pipeline import pruned_wmd_topk
    from repro_torch.data.synth import make_corpus, table_iv_spec

    # corpus + engine
    spec = table_iv_spec("set2", scale=scale)
    t0 = time.perf_counter()
    corpus = make_corpus(spec, device="cuda")
    log(f"corpus: n={spec.n_docs} vocab={spec.vocab_size} m={spec.emb_dim} "
        f"h_max={spec.h_max} mean_h={spec.mean_h} in {time.perf_counter() - t0:.1f} s")
    docs = corpus.docs
    t0 = time.perf_counter()
    engine = LCRWMDEngine(docs, corpus.emb, row_block=SYM_ROW_BLOCK)
    torch.cuda.synchronize()
    v_e = engine.emb_restricted.shape[0]
    log(f"engine: v_e={v_e}, built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card")
    q = docs[:B]

    # 3. kernels against their plain versions
    report: dict = {}
    kernel_phase(engine, q, report)
    torch.cuda.empty_cache()

    # 4. the slice: main path, counts reset just before and read just after
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    cand = engine.topk_streaming(q, K_CAND)
    top = engine.rerank_topk(q, cand.indices, K_FINAL, sinkhorn_kw=KW_RERANK)
    d1 = engine.one_sided(q)
    res = pruned_wmd_topk(docs, q, corpus.emb, k=K_FINAL, engine=engine,
                          sinkhorn_kw=KW_RERANK)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path launches: {launches}")
    for name in ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd",
                 "rwmd_d21"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")

    self_ids = torch.arange(B, device="cuda", dtype=torch.int32)
    if tuple(top.indices.shape) != (B, K_FINAL) or not bool(
            torch.isfinite(top.dists).all()):
        fail("rerank_topk: bad shape or non-finite values")
    if not bool((top.indices[:, 0] == self_ids).all()):
        fail("quickstart: a query's top-1 after the rerank is not itself")
    if tuple(d1.shape) != (spec.n_docs, B) or not bool(torch.isfinite(d1).all()):
        fail("one_sided: bad shape or non-finite values")
    if not torch.allclose(cand.dists[:, 0], d1.amin(dim=0), rtol=1e-5, atol=1e-4):
        fail("topk_streaming's best distance disagrees with one_sided's min")
    if float(d1[self_ids.long(), self_ids.long()].max()) > 0.25:
        fail("one_sided: a query's distance to itself is not ~0")
    if not bool((res.topk.indices[:, 0] == self_ids).all()):
        fail("pruned_wmd_topk: a query's top-1 is not itself")
    exact_share = float(res.pruned_exact.float().mean())
    log(f"slice ok: all {B} self-queries ranked first after the rerank; "
        f"pruned_exact share {exact_share:.3f}; mean n_refined "
        f"{float(res.n_refined.float().mean()):.2f}")
    del d1

    # per-call times after warm-up (host clock, ending in a synchronize)
    times = {
        "topk_streaming_k32": wall_ms(lambda: engine.topk_streaming(q, K_CAND)),
        "rerank_topk_k5": wall_ms(lambda: engine.rerank_topk(
            q, cand.indices, K_FINAL, sinkhorn_kw=KW_RERANK)),
        "one_sided": wall_ms(lambda: engine.one_sided(q)),
        "pruned_wmd_topk_k5": wall_ms(lambda: pruned_wmd_topk(
            docs, q, corpus.emb, k=K_FINAL, engine=engine,
            sinkhorn_kw=KW_RERANK), 2),
        "symmetric_topk_streaming_k20": wall_ms(
            lambda: engine.symmetric_topk_streaming(q, 4 * K_FINAL), 2),
    }
    log("per-call ms (B=64, after warm-up): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    log(f"peak device memory over the main path: {peak_gb:.2f} GB "
        f"(max_memory_allocated)")
    profiles = profile_calls({
        "topk_streaming_k32": lambda: engine.topk_streaming(q, K_CAND),
        "quickstart": lambda: engine.rerank_topk(
            q, engine.topk_streaming(q, K_CAND).indices, K_FINAL,
            sinkhorn_kw=KW_RERANK),
        "one_sided": lambda: engine.one_sided(q),
        "pruned_wmd_topk_k5": lambda: pruned_wmd_topk(
            docs, q, corpus.emb, k=K_FINAL, engine=engine,
            sinkhorn_kw=KW_RERANK),
    })
    if profiles["pruned_wmd_topk_k5"]["htod_copies"]:
        fail("pruned_wmd_topk with an engine made host-to-device copies: "
             f"{profiles['pruned_wmd_topk_k5']}")
    sym_split = symmetric_split(
        lambda: engine.symmetric_topk_streaming(q, 4 * K_FINAL))
    # one_sided's device time by kernel: B1 (prep and GEMM) and B2
    wall_us, dev_us, top, _ = profile_whole(
        lambda: engine.one_sided(q), "one_sided",
        {"lc_rwmd_phase1": ("phase1_",), "spmm_ell": ("spmm_ell_kernel",)},
        busy=False)
    profiles["one_sided_whole"] = dict(
        wall_ms=wall_us / 1e3, device_ms=dev_us / 1e3, top=[
            dict(name=k, device_ms=us / 1e3, count=c) for us, k, c in top[:6]])
    log(f"profile one_sided (whole): wall {wall_us / 1e3:.3f} ms, device "
        f"{dev_us / 1e3:.3f} ms: " + ", ".join(
            f"{k[:50]} {us / 1e3:.3f} ms x{c}" for us, k, c in top[:6]))

    # 5. the paper's comparison path (its own launch counts)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    comp = comparison_phase(engine, q, cand, report)
    log(f"comparison phase: {time.perf_counter() - t0:.1f} s")
    log("comparison: " + json.dumps(comp))

    # 6. the same corpus as segments, and the serve step (its own counts)
    del engine, cand, top, res
    torch.cuda.empty_cache()
    log(f"monolithic engine freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB still allocated")
    t0 = time.perf_counter()
    seg = segmented_phase(docs, corpus.emb, corpus.labels, smi)
    log(f"segmented phase: {time.perf_counter() - t0:.1f} s")

    # 6b. the serving plane on the same corpus (its own counts)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_phase(docs, corpus.emb, smi)
    log(f"serving phase: {time.perf_counter() - t0:.1f} s")

    # 6c. the corpus workloads on the same corpus (their own counts)
    torch.cuda.empty_cache()
    wl = workloads_phase(docs, corpus.emb, smi)
    torch.cuda.empty_cache()

    # 6d. the examples and the serving launcher (their own counts)
    t0 = time.perf_counter()
    ep = entry_points_phase(smi)
    log(f"entry points phase: {time.perf_counter() - t0:.1f} s")

    # 6e. the mesh on the same corpus (its own counts)
    torch.cuda.empty_cache()
    mesh = mesh_phase(docs, corpus.emb, smi)
    del corpus, docs
    torch.cuda.empty_cache()

    slice_info = dict(
        n_docs=spec.n_docs, v_e=v_e, batch=B, per_call_ms=times,
        peak_gb=peak_gb, pruned_exact_share=exact_share, profiles=profiles,
        symmetric_topk_split=sym_split,
        tolerances={k: r["tol"] for k, r in report.items()},
        comparison=comp,
        sinkhorn=dict(iters_mean=report["sinkhorn_wmd"]["iters_mean"],
                      iters_equal_share=report["sinkhorn_wmd"]["iters_equal_share"]))
    log("slice: " + json.dumps(slice_info))
    for name, r in report.items():
        r.setdefault("launches", launches.get(name, 0))
    for name in ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd",
                 "rwmd_d21"):
        report[name]["workloads_launches"] = {
            k: v.get(name, 0) for k, v in wl["launches"].items()}
        report[name]["entry_point_launches"] = ep["launches"].get(name, 0)
    for name, r in report.items():
        by_phase = {"mono": mesh["launches"].get(name, 0),
                    "seg": seg["mesh"]["launches"].get(name, 0)}
        r["mesh_launches"] = sum(by_phase.values())
        r["mesh_launches_by_phase"] = by_phase
    return report


# 6g: the paper's four cells (src/repro_torch/configs/lcrwmd.py) at full
# size, through launch/cells.py's build_cell on a 1x1 mesh; inputs drawn on
# the card from CELL_SEED (cells.make_args).
CELLS = ("serve_set1_1m", "serve_set2_2p8m", "allpairs_64k", "serve_1m_k128")
CELL_SEED = 0
CELL_REPS = 3             # timed calls after a warm-up
CELL_CHECK_VOCAB = 65_536  # B1 under bf16 against its plain version: first rows
CELL_CHECK_CHUNK = 8192    # the plain version's rows at a time
# bf16 products round each operand to 8 bits: the gram form's noise on a
# near-zero distance is ~sqrt(2^-8 * 2 * max|e|^2), as the f32 floor is
# with 2^-23.
BF16_EPS = 2.0 ** -8
# the device split of a cell's call: B1 (its prep and GEMM), B2, the top-k
# (the two stable radix sorts and their gathers); the rest is "other"
CELL_GROUPS = {"phase1": ("phase1_",), "phase2": ("spmm_ell",),
               "topk": ("ort", "ather", "opk")}
CELL_PROFILE_TRIES = 2


def _cell_window(fn, what: str, ms: float) -> dict | None:
    """One call's device time by CELL_GROUPS (``_busy_window``: CUDA
    activity only; on an H100 a whole-host trace of a serve cell took
    25-35 s at its sort sizes), retaken while it lost B1's or B2's
    records or every device record; None if every trace lost them (the
    port's kernels, launched through ctypes, drop out of some traces:
    ROADMAP C)."""
    for attempt in range(1, CELL_PROFILE_TRIES + 1):
        out = _busy_window(fn, CELL_GROUPS, what, wall_ms=ms, required=False)
        if (out is not None and out["by_group"]["phase1"] > 0
                and out["by_group"]["phase2"] > 0):
            return out
        PROFILE_STATS["first_lost" if attempt == 1 else "retries"] += 1
        log(f"{what}: trace {attempt} lost B1's or B2's records: "
            f"{out['by_group'] if out else 'no device time at all'}")
    return None


def _cell_parts(args, k: int | None) -> dict:
    """CUDA-event ms of the step's parts on the cell's inputs, run apart
    as the mesh-less step runs them: phase 1 (the query gather and B1),
    phase 2 (B2), and for a serve cell the top-k of the (n, B) block."""
    from repro_torch.core.topk import topk_smallest_cols
    from repro_torch.kernels import ops

    res, q, emb = args
    z = ops.lc_rwmd_phase1(emb, q.ids, q.weights, bf16_matmul=True)
    d = ops.spmm_ell(res.ids, res.weights, z)
    out = dict(
        phase1=time_ms(lambda: ops.lc_rwmd_phase1(
            emb, q.ids, q.weights, bf16_matmul=True), CELL_REPS),
        phase2=time_ms(lambda: ops.spmm_ell(res.ids, res.weights, z),
                       CELL_REPS))
    if k is not None:
        out["topk"] = time_ms(lambda: topk_smallest_cols(d, k), CELL_REPS)
    return out


def _b1_bf16_check(emb, q) -> dict:
    """B1 under bf16_matmul against its plain version on the first
    CELL_CHECK_VOCAB vocabulary rows at the cell's queries (squared Z,
    tolerance 1e-5*(|e|^2+|t|^2) as the card test's), the plain version
    in row chunks."""
    import torch

    from repro_torch.kernels import lc_rwmd_phase1 as p1

    rows = emb[:CELL_CHECK_VOCAB]
    t = emb[q.ids.reshape(-1).long()].reshape(*q.ids.shape, emb.shape[1])
    valid = (q.weights > 0).to(torch.float32)
    got = p1.phase1_sq_cuda(rows, t, valid, bf16_matmul=True)
    t2 = ((t * t).sum(2) * valid).amax(1)[None, :]
    worst = 0.0
    for lo in range(0, rows.shape[0], CELL_CHECK_CHUNK):
        e = rows[lo:lo + CELL_CHECK_CHUNK]
        want = p1.phase1_sq_plain(e, t, valid, bf16_matmul=True)
        diff = (got[lo:lo + CELL_CHECK_CHUNK] - want).abs()
        tol = 1e-5 * ((e * e).sum(1)[:, None] + t2)
        if not bool((diff <= tol).all()):
            fail(f"cells: B1 under bf16 exceeds 1e-5*(|e|^2+|t|^2) at "
                 f"{int((diff > tol).sum())} entries (max {float(diff.max())})")
        worst = max(worst, float(diff.max()))
    return dict(max_abs_err=worst, rows=rows.shape[0],
                tol="1e-5*(|e|^2+|t|^2), squared Z, bf16_matmul")


def _b1_bf16_time(emb, q) -> dict:
    """B1 at the cell's whole vocabulary and queries, under bf16_matmul and
    in f32, beside its bound.  The operands are rounded to bf16, so the
    bound is the card's bf16 tensor-core rate; the FP32 FMA bound (what
    the kernel's f32 arithmetic allows) is kept beside it."""
    import torch

    from repro_torch.kernels import lc_rwmd_phase1 as p1

    v, m = emb.shape
    b, h = q.ids.shape
    t = emb[q.ids.reshape(-1).long()].reshape(b, h, m)
    valid = (q.weights > 0).to(torch.float32)
    n_valid = int(valid.sum())
    flop = 2.0 * v * m * n_valid
    nbytes = 4 * (v * m + b * h * m + b * h + v * b)
    bnd, by = bound_ms(nbytes, flop, BF16_FLOP_PER_S)
    out = dict(
        v=v, b=b, h=h, valid_words=n_valid, flop=flop, bound_ms=bnd,
        bound_by=by, bound_fp32_ms=bound_ms(nbytes, flop)[0],
        ms=time_ms(lambda: p1.phase1_sq_cuda(emb, t, valid, bf16_matmul=True),
                   CELL_REPS),
        f32_ms=time_ms(lambda: p1.phase1_sq_cuda(emb, t, valid), CELL_REPS))
    out["tflops"] = flop / out["ms"] / 1e9
    return out


def cells_phase(smi: str) -> dict:
    """6g: the paper's four cells at full size on one card.  Each is
    ``build_cell("lcrwmd", name, mesh)`` on a 1x1 mesh in a world-size-1
    NCCL group set up and torn down here; its ``step_fn`` runs on inputs of
    ``cell.args``' exact shapes and dtypes, drawn on the card
    (``cells.make_args``).  With the counts reset just before and read just
    after one call, B1 and B2 must run; the call must equal the mesh-less
    engine-less step (or D1) bit for bit; B1 under ``bf16_matmul`` must
    match its plain version on the first 65,536 vocabulary rows; every
    query must find its own row (D1's diagonal for the all-pairs cell)
    within the gram form's bf16 floor.  Printed: ms a call (warm-up, then
    CELL_REPS calls), the device split phase 1 / phase 2 / top-k of one
    profiled call and of the parts timed apart (CUDA events; the split
    reported where every trace lost B1's records), the TFLOP/s of
    ``model_flops``, the peak memory, and B1
    at ``serve_set1_1m``'s shape under bf16 and f32 beside its bound."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    info: dict = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="cells_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            if mesh.size != 1:
                fail(f"make_host_mesh() in a world of one: {mesh}")
            for name in CELLS:
                info[name] = _one_cell(name, mesh, smi)
                torch.cuda.empty_cache()
            if sum(mesh.counts.values()):
                fail(f"cells: a 1x1 mesh issued collectives: {dict(mesh.counts)}")
        finally:
            dist.destroy_process_group()
    info["s"] = time.perf_counter() - t_phase
    log(f"cells ({smi}): " + ", ".join(
        f"{n} {info[n]['ms']:.1f} ms ({info[n]['tflops']:.1f} TFLOP/s, peak "
        f"{info[n]['peak_gb']:.1f} GB)" for n in CELLS)
        + f"; phase {info['s']:.1f} s")
    log("cells: " + json.dumps(info, default=float))
    return info


def _one_cell(name: str, mesh, smi: str) -> dict:
    """One cell of 6g (see ``cells_phase``)."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.distributed.lcrwmd_dist import (build_allpairs_d1,
                                                     build_serve_step)
    from repro_torch.kernels import _build
    from repro_torch.launch.cells import build_cell, make_args

    cell = build_cell("lcrwmd", name, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_part = {"start": time.perf_counter()}
    args, gen_ms = clocked(lambda: make_args(cell, seed=CELL_SEED,
                                             device=mesh.device))
    res, q, emb = args
    shapes = [(tuple(t.shape), t.dtype) for t in (
        res.ids, res.weights, q.ids, q.weights, emb)]
    want_shapes = [(tuple(t.shape), t.dtype) for t in (
        cell.args[0].ids, cell.args[0].weights, cell.args[1].ids,
        cell.args[1].weights, cell.args[2])]
    if shapes != want_shapes:
        fail(f"cells {name}: inputs {shapes} are not the cell's {want_shapes}")
    mean_h = float((res.weights > 0).sum(1).float().mean())
    allpairs = cell.kind == "lcrwmd_allpairs"
    spec = get_spec("lcrwmd")
    bf16 = spec.model_cfg.bf16_matmul
    if allpairs:
        one = build_allpairs_d1(bf16_matmul=bf16, device=mesh.device)
    else:
        k = spec.shapes[name].params.get("k", spec.model_cfg.k)
        one = build_serve_step(k=k, bf16_matmul=bf16, device=mesh.device)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = cell.step_fn(*args)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _launched(f"cells {name}", launches, ("lc_rwmd_phase1", "spmm_ell"))
    want = one(*args)
    if not _same(got, want):
        fail(f"cells {name}: the 1x1 mesh step differs from the mesh-less one")
    del want
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t_part["calls"] = time.perf_counter()
    emax2 = float((emb * emb).sum(1).max())
    floor = math.sqrt(BF16_EPS * 2.0 * emax2)
    b = q.n_docs
    self_ids = torch.arange(b, device=mesh.device)
    if allpairs:
        d_self = got[self_ids, self_ids]
    else:
        hit = got.topk.indices == self_ids[:, None].to(got.topk.indices.dtype)
        if not bool(hit.any(1).all()):
            fail(f"cells {name}: {int((~hit.any(1)).sum())} queries did not "
                 "find their own row in their top-k")
        d_self = torch.where(hit, got.topk.dists, 0.0).sum(1)
    if not bool(torch.isfinite(d_self).all()) or float(d_self.max()) > floor:
        fail(f"cells {name}: a self distance {float(d_self.max())} above the "
             f"bf16 gram floor {floor}")
    del got
    b1_check = _b1_bf16_check(emb, q)
    t_part["b1_check"] = time.perf_counter()
    ms = time_ms(lambda: cell.step_fn(*args), CELL_REPS)
    t_part["timed"] = time.perf_counter()
    window = _cell_window(lambda: cell.step_fn(*args), f"cells {name}", ms)
    t_part["profiled"] = time.perf_counter()
    parts = _cell_parts(args, None if allpairs else k)
    t_part["parts"] = time.perf_counter()
    # the profiler's split where a trace kept B1's and B2's records, else
    # the parts timed apart by CUDA events (both printed)
    split = window["by_group"] if window else parts
    out = dict(
        kind=cell.kind, n=res.n_docs, h=res.h_max, b=b, v=emb.shape[0],
        mean_h=mean_h, gen_ms=gen_ms, launches=launches, ms=ms,
        model_flops=cell.model_flops,
        tflops=cell.model_flops / ms / 1e9, device_ms=split,
        split_from="torch.profiler" if window else "cuda events",
        parts_ms=parts, profiled_device_ms=window and window["device_ms"],
        self_max=float(d_self.max()), bf16_floor=floor, b1_bf16=b1_check,
        notes=cell.notes)
    if name == "serve_set1_1m":
        out["b1_bf16_time"] = _b1_bf16_time(emb, q)
    t_part["b1_timed"] = time.perf_counter()
    marks = list(t_part.items())
    out["seconds"] = {k: t - p for (_, p), (k, t) in zip(marks, marks[1:])}
    out["peak_gb"] = step_peak_gb     # the two calls of the step
    out["phase_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"cell {name} ({smi}): n {out['n']} h {out['h']} (mean h "
        f"{mean_h:.2f}) B {b} v {out['v']}; {ms:.2f} ms a call, "
        f"{out['tflops']:.2f} TFLOP/s of model_flops {cell.model_flops:.3e}; "
        f"device ms ({out['split_from']}) "
        + ", ".join(f"{x} {v:.2f}" for x, v in split.items())
        + "; parts apart (cuda events) "
        + ", ".join(f"{x} {v:.2f}" for x, v in parts.items())
        + f"; launches {launches}; peak {out['peak_gb']:.2f} GB; seconds "
        + ", ".join(f"{x} {v:.1f}" for x, v in out["seconds"].items())
        + "; B1 bf16 vs "
        f"plain {b1_check['max_abs_err']:.3e}; self <= {out['self_max']:.4f} "
        f"(floor {floor:.4f}); inputs drawn in {gen_ms / 1e3:.2f} s")
    if "b1_bf16_time" in out:
        t = out["b1_bf16_time"]
        log(f"cell {name}: B1 at its shape (v {t['v']}, {t['valid_words']} "
            f"valid query words): bf16 {t['ms']:.2f} ms ({t['tflops']:.1f} "
            f"TFLOP/s), f32 {t['f32_ms']:.2f} ms; bound {t['bound_ms']:.2f} "
            f"ms ({t['bound_by']}, bf16 tensor cores; "
            f"{t['bound_ms'] / t['ms']:.3f} of it), FP32 FMA bound "
            f"{t['bound_fp32_ms']:.2f} ms")
    return out


# NequIP at full width (phase 11): the nequip config (5 layers, 32 channels,
# l_max 2) on the four cells of src/repro/configs/gnn_archs.py at their
# sizes.  ogb_products is energy-only (as the cell says), its edge work in
# chunks of whole destination rows of at most NEQUIP_EDGE_CHUNK edges.
NEQUIP_CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
NEQUIP_EDGE_CHUNK = 1 << 20
NEQUIP_BOX = 4.0   # positions uniform in a cube of side 4 (the reference's
                   # test batches): some edges reach past the 5.0 cutoff
# minibatch_lg: the port's sampler over a random graph of Reddit's node
# count at a degree where most seeds fill their fanout of 15.
NEQUIP_REDDIT_NODES, NEQUIP_REDDIT_DEGREE = 232_965, 25
# timed calls after the counted one (ogb_products: the counted call alone,
# CUDA events around it; the cells before it ran the same code)
NEQUIP_REPS = {"ogb_products": 0}
NEQUIP_E_TOL = 1e-5   # energies, relative to the largest |E|: B9 against
                      # its plain version, and the card against the CPU
NEQUIP_F_TOL = 1e-4   # forces, relative to the largest |F| (the plain
                      # version and the CPU add in other orders)
NEQUIP_ROT_TOL = 1e-4  # E(R x + t) = E(x), F(R x) = R F(x), relative
NEQUIP_ROT_CELLS = ("molecule", "minibatch_lg")
NEQUIP_B9 = {"segment_spmm": ("segment_spmm_kernel",)}


def nequip_flops(cfg, n_edges: int, n_nodes: int, *, train: bool,
                 forces: bool) -> float:
    """The reference's analytic FLOPs of a NequIP step
    (``src/repro/launch/cells.py`` ``_nequip_flops``), copied."""
    from repro_torch.models.gnn.nequip import _paths

    c = cfg.d_hidden
    per_edge = 0.0
    for (l1, l2, l3) in _paths(cfg.l_max):
        per_edge += 2.0 * c * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
    per_edge += 2.0 * cfg.n_rbf * cfg.radial_hidden \
        + 2.0 * cfg.radial_hidden * len(_paths(cfg.l_max)) * c
    irr = sum(2 * l + 1 for l in range(cfg.l_max + 1))
    per_node = 2.0 * 2 * c * c * irr  # lin_in + lin_out
    fwd = cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)
    mult = 3.0 if train else 1.0          # fwd + bwd
    if forces:
        mult *= 2.0                        # grad-of-grad for the force term
    return fwd * mult


@contextlib.contextmanager
def aggregation_swapped(NQ, fn):
    """NequIP's B9 calls (``NQ.segment_spmm``) replaced by ``fn`` inside
    the block."""
    orig = NQ.segment_spmm
    NQ.segment_spmm = fn
    try:
        yield
    finally:
        NQ.segment_spmm = orig


def _nequip_batch(name: str, p: dict, frac: float, dev) -> tuple[dict, dict]:
    """A cell's batch drawn from seed 0 (the graph on the card, but
    ``minibatch_lg``'s, which the port's sampler draws on the host), and
    what it holds."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(29)
    n, e, n_graphs = p["n_nodes"], p["n_edges"], p["n_graphs"]
    t0 = time.perf_counter()
    info = {}
    if name == "minibatch_lg":
        from repro_torch.models.gnn.sampler import (random_graph,
                                                     sample_fanout_subgraph)

        hg = random_graph(NEQUIP_REDDIT_NODES, NEQUIP_REDDIT_DEGREE,
                          d_feat=p["d_feat"], seed=0)
        rng = np.random.default_rng(0)
        seeds = rng.choice(hg.n_nodes, size=p["batch_nodes"], replace=False)
        sub = sample_fanout_subgraph(hg, seeds, fanout=tuple(p["fanout"]),
                                     rng=rng, max_nodes=n, max_edges=e)
        del hg
        batch = {k: torch.tensor(sub[k], device=dev) for k in (
            "positions", "edge_index", "edge_mask", "node_mask", "node_feat")}
        info.update(real_nodes=int(sub["node_mask"].sum()),
                    real_edges=int(sub["edge_mask"].sum()))
    else:
        if name == "ogb_products":
            # as segment_phase draws the cell: dst sorted, a share of rows
            # no edge reaches, padding edges (masked) to the sink row n - 1
            n = max(int(n * frac), 4096)
            e = max(int(e * frac), 4 * OGB_PAD_EDGES)
            isolated = torch.rand(n - 1, generator=g, device=dev) < OGB_ISOLATED
            cand = (~isolated).nonzero()[:, 0].to(torch.int32)
            e_real = e - OGB_PAD_EDGES
            dst = cand[torch.randint(0, cand.numel(), (e_real,), generator=g,
                                     device=dev)]
            del cand
            dst = torch.cat([torch.sort(dst).values, torch.full(
                (OGB_PAD_EDGES,), n - 1, dtype=torch.int32, device=dev)])
            src = torch.randint(0, n, (e,), generator=g, device=dev,
                                dtype=torch.int32)
            mask = torch.ones(e, dtype=torch.bool, device=dev)
            mask[e_real:] = False
        else:
            # edges within a graph (molecule: 64 of each 30-atom graph),
            # no self-loop
            per_n, per_e = n // n_graphs, e // n_graphs
            base = torch.arange(n_graphs, device=dev).repeat_interleave(per_e)
            src = torch.randint(0, per_n, (e,), generator=g, device=dev)
            dst = torch.randint(0, per_n, (e,), generator=g, device=dev)
            src = torch.where(src == dst, (src + 1) % per_n, src)
            src, dst = ((base * per_n + x).to(torch.int32) for x in (src, dst))
            mask = torch.ones(e, dtype=torch.bool, device=dev)
        batch = {"edge_index": torch.stack([src, dst]), "edge_mask": mask,
                 "positions": torch.rand((n, 3), generator=g, device=dev)
                 * NEQUIP_BOX,
                 "node_mask": torch.ones(n, dtype=torch.bool, device=dev)}
        del src, dst
        if p["d_feat"]:
            batch["node_feat"] = torch.randn((n, p["d_feat"]), generator=g,
                                             device=dev)
        else:
            batch["species"] = torch.randint(0, 16, (n,), generator=g,
                                             device=dev, dtype=torch.int32)
    n = batch["positions"].shape[0]
    per_graph = max(n // n_graphs, 1)
    batch["graph_ids"] = (torch.arange(n, device=dev) // per_graph).clamp_(
        max=n_graphs - 1).to(torch.int32)
    batch["n_graphs"] = n_graphs
    torch.cuda.synchronize()
    info.update(nodes=n, edges=batch["edge_index"].shape[1],
                masked_edges=int((~batch["edge_mask"]).sum()),
                seconds=time.perf_counter() - t0)
    return batch, info


def _rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _rotation(dev):
    import torch

    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator(
    ).manual_seed(7), dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r))
    if torch.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.to(torch.float32).to(dev)


def nequip_cell(name: str, cell, cfg0, frac: float, dev) -> dict:
    """One cell's serving path: energies (and forces where the cell asks
    for them) with the counts reset just before and read just after, then
    times, TFLOP/s, peak memory, a profile and the checks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_spmm as sg
    from repro_torch.models.gnn import nequip as NQ

    p = cell.params
    forces = bool(p["forces"])
    cfg = dataclasses.replace(cfg0, d_feat=p["d_feat"],
                              force_loss_weight=1.0 if forces else 0.0)
    params = NQ.init_params(cfg, seed=0, device=dev)
    batch, info = _nequip_batch(name, p, frac, dev)
    n, e = info["nodes"], info["edges"]
    chunk = NEQUIP_EDGE_CHUNK if name == "ogb_products" else None
    if chunk is None:
        n_chunks = 1
    else:
        dst = torch.sort(batch["edge_index"][1]).values.to(torch.int32)
        off = sg.row_offsets(dst, n).cpu().numpy().astype(np.int64)
        chunks = NQ._edge_chunks(off, chunk)
        n_chunks = len(chunks)
        info["largest_chunk_edges"] = max(c[3] - c[2] for c in chunks)
    layers = cfg.n_layers
    log(f"nequip {name}: {n} nodes, {e} edges, {n_chunks} edge chunk(s); "
        f"batch {json.dumps(info)}")

    def energy():
        with torch.no_grad():
            return NQ.forward_energy(params, batch, cfg, edge_chunk=chunk)

    def energy_forces():
        return NQ.forward_energy_forces(params, batch, cfg, edge_chunk=chunk)

    # --- the main path, counts reset just before and read just after ---
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    en = energy()
    end.record()
    torch.cuda.synchronize()
    first_ms = start.elapsed_time(end)
    fwd = _build.LAUNCHES["segment_spmm"]
    want = 2 + 2 * layers * n_chunks
    if fwd != want:
        fail(f"nequip {name}: the forward launched segment_spmm {fwd} times, "
             f"not {want} (2 position gathers, a feature gather and an "
             f"aggregation per layer and chunk)")
    bwd = 0
    if forces:
        _build.reset_launches()
        en_f, fo = energy_forces()
        torch.cuda.synchronize()
        bwd = _build.LAUNCHES["segment_spmm"] - fwd
        if bwd != 2 * layers + 1:
            fail(f"nequip {name}: the backward launched segment_spmm {bwd} "
                 f"times, not {2 * layers + 1}")
        if tuple(fo.shape) != (n, 3) or not bool(torch.isfinite(fo).all()):
            fail(f"nequip {name}: bad shape or non-finite forces")
        if _rel_err(en_f, en) > NEQUIP_E_TOL:
            fail(f"nequip {name}: the energies of the force call differ")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(en.shape) != (p["n_graphs"],) or not bool(torch.isfinite(en).all()):
        fail(f"nequip {name}: bad shape or non-finite energies")
    log(f"nequip {name}: B9 launches forward {fwd}, backward {bwd}; peak "
        f"{peak_gb:.2f} GB; energies[:4] {en[:4].tolist()}")

    # --- times (CUDA events), TFLOP/s by the reference's formula ---
    reps = NEQUIP_REPS.get(name, 5)
    r = dict(launches=dict(forward=fwd, backward=bwd), peak_gb=peak_gb,
             chunks=n_chunks, nodes=n, edges=e, batch=info)
    r["forward_ms"] = time_ms(energy, reps, warm=False) if reps else first_ms
    r["first_forward_ms"] = first_ms
    fl = nequip_flops(cfg, e, n, train=False, forces=False)
    r["forward_tflops"] = fl / (r["forward_ms"] * 1e-3) / 1e12
    if forces:
        r["forces_ms"] = time_ms(energy_forces, max(reps, 1), warm=False)
        r["forces_tflops"] = nequip_flops(cfg, e, n, train=False, forces=True) \
            / (r["forces_ms"] * 1e-3) / 1e12

    # --- device busy share, B9 against the rest (torch.profiler) ---
    wall_us, dev_us, top, launched = profile_whole(
        energy_forces if forces else energy, f"nequip {name}", NEQUIP_B9,
        busy=name == "ogb_products")
    b9_us = sum(us for us, k, _ in top if "segment_spmm_kernel" in k)
    r["profile"] = dict(wall_ms=wall_us / 1e3, device_ms=dev_us / 1e3,
                        busy=dev_us / wall_us, b9_ms=b9_us / 1e3,
                        rest_ms=(dev_us - b9_us) / 1e3, top=[
                            dict(name=k, device_ms=us / 1e3, count=c)
                            for us, k, c in top[:6]])
    log(f"nequip {name}: forward {r['forward_ms']:.3f} ms "
        f"({r['forward_tflops']:.2f} TFLOP/s)" + (
            f", with forces {r['forces_ms']:.3f} ms "
            f"({r['forces_tflops']:.2f} TFLOP/s)" if forces else "") +
        f"; profiled call: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{dev_us / wall_us:.3f}, B9 {b9_us / 1e3:.3f} ms of "
        f"{dev_us / 1e3:.3f} device ms; by device time: " + ", ".join(
            f"{k[:40]} {us / 1e3:.3f} ms x{c}" for us, k, c in top[:5]))

    # --- checks ---
    checks = {}
    # the same forward with B9 swapped for its plain version (atomics)
    _build.reset_launches()
    with aggregation_swapped(NQ, sg.segment_spmm_plain):
        if forces:
            pe, pf = energy_forces()
        else:
            pe = energy()
    torch.cuda.synchronize()
    if _build.LAUNCHES["segment_spmm"]:
        fail(f"nequip {name}: the swapped forward launched B9")
    checks["b9_vs_plain"] = dict(energy=_rel_err(en, pe))
    if forces:
        checks["b9_vs_plain"]["forces"] = _rel_err(fo, pf)
        del pf
    del pe
    if checks["b9_vs_plain"]["energy"] > NEQUIP_E_TOL or checks[
            "b9_vs_plain"].get("forces", 0.0) > NEQUIP_F_TOL:
        fail(f"nequip {name}: B9 against its plain version: "
             f"{checks['b9_vs_plain']}")
    if forces:
        # the forces repeat bit for bit (no atomics in their backward)
        _, again = energy_forces()
        checks["forces_repeat_bitwise"] = bool(torch.equal(again, fo))
        del again
    if name == "molecule":
        # the port on the CPU (its plain versions) on the same batch
        cpu_p = _to_device(params, "cpu")
        cpu_b = {k: v if k == "n_graphs" else v.cpu() for k, v in batch.items()}
        ce, cf = NQ.forward_energy_forces(cpu_p, cpu_b, cfg)
        checks["card_vs_cpu"] = dict(energy=_rel_err(en.cpu(), ce),
                                     forces=_rel_err(fo.cpu(), cf))
        if checks["card_vs_cpu"]["energy"] > NEQUIP_E_TOL or checks[
                "card_vs_cpu"]["forces"] > NEQUIP_F_TOL:
            fail(f"nequip {name}: the card against the CPU: "
                 f"{checks['card_vs_cpu']}")
    if name in NEQUIP_ROT_CELLS:
        rot = _rotation(dev)
        t = torch.tensor([1.3, -0.7, 2.1], device=dev)
        pos = batch["positions"]
        moved = dict(batch, positions=pos @ rot.T + t)
        e_t = NQ.forward_energy(params, moved, cfg)
        _, f_r = NQ.forward_energy_forces(params, dict(batch,
                                                       positions=pos @ rot.T), cfg)
        checks["rotation"] = dict(energy=_rel_err(e_t, en),
                                  forces=_rel_err(f_r, fo @ rot.T))
        if max(checks["rotation"].values()) > NEQUIP_ROT_TOL:
            fail(f"nequip {name}: not invariant / equivariant under a "
                 f"rotation: {checks['rotation']}")
    log(f"nequip {name} checks: {json.dumps(checks)}")
    r["checks"] = checks
    if name == "ogb_products":
        r["b9_d288"] = nequip_b9_shape(batch, n, chunks, cfg, dev)
    return r


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def nequip_b9_shape(batch, n: int, chunks, cfg, dev) -> dict:
    """B9 at NequIP's aggregation shape on ogb_products: one layer's
    messages (E, C·9) in the model's chunks (one chunk's messages drawn
    once, each chunk reading its own rows of them), against its bytes
    bound and two PyTorch yardsticks over the same chunks:
    ``segment_reduce(lengths=)`` and ``index_add_``."""
    import torch

    from repro_torch.kernels import segment_spmm as sg

    d = cfg.d_hidden * (cfg.l_max + 1) ** 2
    dst = torch.sort(batch["edge_index"][1]).values.to(torch.int32)
    off = sg.row_offsets(dst, n)
    deg = (off[1:] - off[:-1]).long()
    ec_max = max(e1 - e0 for _, _, e0, e1 in chunks)
    g = torch.Generator(device=dev).manual_seed(30)
    msgs = torch.randn((ec_max, d), generator=g, device=dev)
    ar = torch.arange(ec_max, dtype=torch.int32, device=dev)
    one = torch.ones(ec_max, device=dev)
    args = [(dst[e0:e1] - r0, deg[r0:r1], e1 - e0, r1 - r0)
            for r0, r1, e0, e1 in chunks]

    def b9():
        for dc, _, ec, rows in args:
            sg.segment_spmm_cuda(ar[:ec], dc, msgs[:ec], one[:ec], rows)

    def seg_reduce():
        for _, lc, ec, _ in args:
            torch.segment_reduce(msgs[:ec], "sum", lengths=lc, axis=0)

    def index_add():
        for dc, _, ec, rows in args:
            torch.zeros((rows, d), device=dev).index_add_(0, dc, msgs[:ec])

    dc, lc, ec, rows = args[0]
    got = sg.segment_spmm_cuda(ar[:ec], dc, msgs[:ec], one[:ec], rows)
    err = dict(segment_reduce=float((torch.segment_reduce(
        msgs[:ec], "sum", lengths=lc, axis=0) - got).abs().max()),
               index_add=float((torch.zeros((rows, d), device=dev).index_add_(
                   0, dc, msgs[:ec]) - got).abs().max()))
    if max(err.values()) > SEG_TOL:
        fail(f"B9 at D {d}: the yardsticks disagree with it: {err}")
    e_all = sum(a[2] for a in args)
    bnd, by = bound_ms(4.0 * e_all * (d + 3) + 4.0 * n * d, 2.0 * e_all * d)
    out = dict(d=d, chunks=len(chunks), edges=e_all, ms=time_ms(b9, 3),
               bound_ms=bnd, bound_by=by, segment_reduce_ms=time_ms(seg_reduce, 3),
               index_add_ms=time_ms(index_add, 3), yardstick_err=err)
    out["gbps"] = 4.0 * e_all * (d + 3) / 1e6 / out["ms"]
    log(f"kernel segment_spmm at NequIP's aggregation (D {d}, {len(chunks)} "
        f"chunks, {e_all} edges): {out['ms']:.3f} ms against a {bnd:.3f} ms "
        f"bound ({by}; {out['gbps']:.0f} GB/s of messages and edges); "
        f"segment_reduce {out['segment_reduce_ms']:.3f} ms, index_add_ "
        f"{out['index_add_ms']:.3f} ms")
    return out


def nequip_phase(frac: float, dev) -> dict:
    """NequIP at full width on its four cells, one after the other (each
    freed before the next)."""
    import torch

    from repro_torch.configs import get_spec

    spec = get_spec("nequip")
    out = {}
    t0 = time.perf_counter()
    for name in NEQUIP_CELLS:
        out[name] = nequip_cell(name, spec.shapes[name], spec.model_cfg, frac,
                                dev)
        torch.cuda.empty_cache()
    log(f"nequip phase: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="Table IV set 2 scale (0.25: 700,000 docs)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.SOURCES)} "
        f"kernel libraries (nvcc, sm_90a)")
    t_start = time.perf_counter()

    # 2. small-size agreement, card vs CPU (cheap; before the big corpus)
    small_phase()

    # 3-6. the LC-RWMD slice, the comparison path and the segments
    report = lcrwmd_phases(args.scale, smi)
    torch.cuda.empty_cache()
    log(f"LC-RWMD phases freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")

    # 6g. the paper's four cells at full size (their own counts)
    cells = cells_phase(smi)
    for name in ("lc_rwmd_phase1", "spmm_ell"):
        report[name]["cells_launches"] = {
            c: cells[c]["launches"].get(name, 0) for c in CELLS}
    report["lc_rwmd_phase1"]["cells_b1_bf16"] = dict(
        cells["serve_set1_1m"]["b1_bf16_time"],
        max_abs_err=cells["serve_set1_1m"]["b1_bf16"]["max_abs_err"])
    torch.cuda.empty_cache()

    # 7-9. attention (B8), gather-scale-scatter (B9), llama3.2-1b serving
    frac = min(1.0, args.scale / 0.25)
    dev = torch.device("cuda")
    report.update(flash_phase(frac, dev))
    report.update(segment_phase(frac, dev))
    lm = llama_phase(frac, dev)
    report["flash_attention"]["launches"] = lm["launches"]["flash_attention"]

    # 10. grok-1 and deepseek-v2 at full width (MoE, MLA)
    moe = moe_mla_phase(frac, dev)
    grok = moe["grok-1-314b"]
    report["flash_attention"]["moe_launches"] = {
        a: r["launches"].get("flash_attention", 0) for a, r in moe.items()}
    report["flash_attention"]["grok_shape"] = dict(
        grok["checks"]["b8_times"], max_abs_err=grok["checks"]["b8_vs_plain"][
            "max_abs"], gap=grok["checks"]["b8_vs_plain"])
    torch.cuda.empty_cache()

    # 11. NequIP at full width on its four cells (B9 forward and backward)
    gnn = nequip_phase(frac, dev)
    report["segment_spmm"]["gnn_launches"] = {
        c: r["launches"] for c, r in gnn.items()}
    report["segment_spmm"]["nequip_d288"] = gnn["ogb_products"]["b9_d288"]

    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            mesh_launches=r.get("mesh_launches", 0)))
        for key in ("workloads_launches", "entry_point_launches",
                    "mesh_launches_by_phase", "cells_launches",
                    "cells_b1_bf16", "moe_launches", "grok_shape",
                    "gnn_launches", "nequip_d288"):
            if key in r:
                kernels[-1][key] = r[key]
        if name in EXTRA:
            kernels[-1]["extra"] = {k: r[k] for k in EXTRA[name]}
    log("llama3.2-1b: " + json.dumps(lm))
    for arch, r in moe.items():
        log(f"{arch}: " + json.dumps(r))
    for cell, r in gnn.items():
        log(f"nequip {cell}: " + json.dumps(r))
    log("tolerances: " + json.dumps({k: r["tol"] for k, r in report.items()}))
    log(f"profiler: {PROFILE_STATS['calls']} traces judged whole or not, "
        f"{PROFILE_STATS['first_lost']} first traces and "
        f"{PROFILE_STATS['retries']} retries lost records")
    log(f"total after the build: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
