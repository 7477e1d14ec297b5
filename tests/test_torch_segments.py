"""The port's SegmentedEngine against the reference's, on the CPU.

Both engines see the same corpus (``tests/test_segments.py``'s: 192 docs,
carried across by ``repro_torch.convert.from_numpy``) grown the same way:
a 128-doc base, a 32-doc delta, and a 25-doc delta whose last doc is an
exact copy of doc 5 (a genuine tie).  The port runs ``device="cpu"``
(each kernel's plain version), the reference its jnp segment fold.

Tolerances: distances through phase 1 carry the gram form's cancellation
noise near zero, up to 2.5e-2 absolute (``tests/test_torch_engine.py``);
indices must be exact wherever both neighbouring gaps exceed it.  Within
the port, the segmented result must equal a one-segment rebuild over the
same docs bit for bit: a word's Z row does not depend on which vocabulary
restriction holds it, and each row sums its slots in one order.  The
reranks compare at ``RERANK_KW`` (eps 0.5, 2 levels, up to 200 iterations
a level, tol 1e-4), where on this corpus all but 6 of 128 candidate pairs
stop on the tolerance and the two backends agree within 5.2e-3: the
reference's segmented rerank runs its batched exp-domain solver, the
port's the log-domain kernel's plain version, and far from convergence
they part ways (``test_unconverged_rerank_gap_is_the_references``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc_rwmd as jlc
from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_corpus
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.data.docs import DocSet
from test_torch_engine import _np, assert_topk_close

K = 8
BASE_N = 128
N_GROWN = BASE_N + 57
RERANK_KW = dict(eps=0.5, eps_scaling=2, max_iters=200, tol=1e-4)
METHODS = ["topk", "topk_streaming", "symmetric_topk_streaming"]


@pytest.fixture(scope="module")
def corpus():
    c = make_corpus(CorpusSpec(n_docs=192, vocab_size=512, emb_dim=48,
                               h_max=16, mean_h=8.0, n_classes=4, seed=3))
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    return c, docs, emb


def _jslice(c, lo, hi):
    return JDocSet(ids=c.docs.ids[lo:hi], weights=c.docs.weights[lo:hi])


def _cat(*parts):
    return DocSet(ids=torch.cat([p.ids for p in parts]),
                  weights=torch.cat([p.weights for p in parts]))


def _jcat(*parts):
    return JDocSet(ids=jnp.concatenate([p.ids for p in parts]),
                   weights=jnp.concatenate([p.weights for p in parts]))


def _grow(c, docs, emb, **kw):
    """(port segmented, reference segmented, port one-segment rebuild)."""
    seg = tlc.SegmentedEngine(docs[:BASE_N], emb, device="cpu", **kw)
    g1 = seg.append(docs[BASE_N:BASE_N + 32])
    g2 = seg.append(_cat(docs[BASE_N + 32:BASE_N + 56], docs[5:6]))
    np.testing.assert_array_equal(g1, np.arange(BASE_N, BASE_N + 32))
    np.testing.assert_array_equal(g2, np.arange(BASE_N + 32, N_GROWN))
    ref = jlc.SegmentedEngine(_jslice(c, 0, BASE_N), c.emb)
    ref.append(_jslice(c, BASE_N, BASE_N + 32))
    ref.append(_jcat(_jslice(c, BASE_N + 32, BASE_N + 56), _jslice(c, 5, 6)))
    mono = tlc.SegmentedEngine(_cat(docs[:BASE_N + 56], docs[5:6]), emb,
                               device="cpu", **kw)
    assert (seg.n_segments, ref.n_segments, mono.n_segments) == (3, 3, 1)
    assert seg.n_docs == ref.n_docs == mono.n_docs == N_GROWN
    return seg, ref, mono


@pytest.fixture(scope="module")
def grown(corpus):
    return _grow(*corpus)


def assert_bit_equal(a, b):
    assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)


@pytest.mark.parametrize("method", METHODS)
def test_topk_matches_reference_and_monolithic_rebuild(corpus, grown, method):
    c, docs, _ = corpus
    seg, ref, mono = grown
    queries = docs[4:20]              # includes doc 5, duplicated as gid 184
    got = getattr(seg, method)(queries, K)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (16, K)
    assert_topk_close(got, getattr(ref, method)(_jslice(c, 4, 20), K))
    assert_bit_equal(got, getattr(mono, method)(queries, K))
    # the duplicate ties with doc 5 and ranks right after it (lower gid first)
    row = got.indices[1].tolist()
    assert row.index(N_GROWN - 1) == row.index(5) + 1
    assert got.dists[1, row.index(5)] == got.dists[1, row.index(N_GROWN - 1)]


@pytest.mark.parametrize("method", ["one_sided", "symmetric"])
def test_dense_matches_reference_and_monolithic_rebuild(corpus, grown, method):
    c, docs, _ = corpus
    seg, ref, mono = grown
    got = getattr(seg, method)(docs[4:20])
    assert got.shape == (N_GROWN, 16)
    np.testing.assert_allclose(
        _np(got), _np(getattr(ref, method)(_jslice(c, 4, 20))), rtol=1e-4,
        atol=2.5e-2)
    assert torch.equal(got, getattr(mono, method)(docs[4:20]))


@pytest.mark.parametrize("method", METHODS + ["one_sided"])
def test_delete_excludes_and_matches_reference(corpus, method):
    c, docs, emb = corpus
    seg, ref, _ = _grow(c, docs, emb)
    target = BASE_N + 3                # a delta doc; query 0 is its copy
    queries, jq = docs[[target, 7]], _jslice(c, target, target + 1)
    jq = _jcat(jq, _jslice(c, 7, 8))
    dead = [target, 7, 2]
    if method == "one_sided":
        before = seg.one_sided(queries)
        assert torch.isfinite(before[dead]).all()
    else:
        before = getattr(seg, method)(queries, K)
        assert target in before.indices[0] and 7 in before.indices[1]
    assert seg.delete(dead) == ref.delete(dead) == 3
    assert seg.n_live == ref.n_live == N_GROWN - 3
    assert seg.delete([target, target]) == 0        # already tombstoned
    if method == "one_sided":
        after = seg.one_sided(queries)
        assert torch.isinf(after[dead]).all()
        np.testing.assert_allclose(_np(after), _np(ref.one_sided(jq)),
                                   rtol=1e-4, atol=2.5e-2)
        return
    after = getattr(seg, method)(queries, K)
    assert not np.isin(dead, _np(after.indices)).any()
    assert torch.isfinite(after.dists).all()
    assert_topk_close(after, getattr(ref, method)(jq, K))


def test_delete_rejects_out_of_range_ids(corpus, grown):
    seg = grown[0]
    with pytest.raises(IndexError, match="out of range"):
        seg.delete([N_GROWN])
    assert seg.n_live == N_GROWN


@pytest.mark.parametrize("method", METHODS)
def test_fewer_live_rows_than_k_match_reference(corpus, method):
    """k past the live docs: the tail is (+inf, -1) on the CPU, as in the
    reference's fold (the card's is (3.4e38, -1), ROADMAP C)."""
    c, docs, emb = corpus
    seg = tlc.SegmentedEngine(docs[:24], emb, device="cpu")
    seg.append(docs[24:40])
    ref = jlc.SegmentedEngine(_jslice(c, 0, 24), c.emb)
    ref.append(_jslice(c, 24, 40))
    dead = list(range(0, 40, 3))
    seg.delete(dead)
    ref.delete(dead)
    got = getattr(seg, method)(docs[1:3], 40)
    want = getattr(ref, method)(_jslice(c, 1, 3), 40)
    n_live = 40 - len(dead)
    assert torch.isinf(got.dists[:, n_live:]).all()
    assert (got.indices[:, n_live:] == -1).all()
    assert np.array_equal(_np(got.indices[:, n_live:]),
                          _np(want.indices)[:, n_live:])
    assert_topk_close(topk_head(got, n_live), topk_head(want, n_live))


def topk_head(tk, n):
    return type(tk)(tk.dists[:, :n], tk.indices[:, :n])


def test_compact_preserves_answers_and_ids(corpus):
    c, docs, emb = corpus
    seg, ref, _ = _grow(c, docs, emb)
    dead = [2, BASE_N + 5, N_GROWN - 1]
    seg.delete(dead)
    ref.delete(dead)
    queries = docs[30:46]
    before = {m: getattr(seg, m)(queries, K) for m in METHODS}
    dense = seg.symmetric(queries)
    n_docs, n_live, version = seg.n_docs, seg.n_live, seg.version
    seg.compact()
    ref.compact()
    assert seg.n_segments == 1 and seg.version == version + 1
    assert (seg.n_docs, seg.n_live) == (n_docs, n_live) == (ref.n_docs,
                                                             ref.n_live)
    assert not seg.live_mask()[dead].any()
    assert np.array_equal(seg.live_mask(), ref.live_mask())
    for m in METHODS:
        assert_bit_equal(getattr(seg, m)(queries, K), before[m])
        assert_topk_close(before[m], getattr(ref, m)(_jslice(c, 30, 46), K))
    assert torch.equal(seg.symmetric(queries), dense)
    # the dead docs' words left the restricted vocabulary
    assert seg.segments[0].tensors.emb_r.shape[0] == \
        ref.segments[0].tensors.emb_r.shape[0]
    seg.compact()                      # one segment, but rows still dead
    assert seg.n_segments == 1 and seg.n_live == n_live


def test_append_hmax_guard(corpus):
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:64], emb, device="cpu")
    wide = DocSet(ids=torch.nn.functional.pad(docs.ids[64:66], (0, 4)),
                  weights=torch.nn.functional.pad(docs.weights[64:66], (0, 4)))
    with pytest.raises(ValueError, match="h_max"):
        eng.append(wide)
    # narrower docs are padded up and accepted
    gids = eng.append(DocSet(ids=docs.ids[64:66, :8],
                             weights=docs.weights[64:66, :8]))
    np.testing.assert_array_equal(gids, [64, 65])
    assert eng.h_max == docs.h_max and eng.n_docs == 66
    assert eng.append(docs[0:0]).size == 0


@pytest.mark.parametrize("method", METHODS)
def test_delta_smaller_than_k_matches_reference(corpus, method):
    """A 5-doc delta against k = 8: the segment serves all its rows, holds
    them unpadded, and no id past ``n_docs`` comes back."""
    c, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:64], emb, device="cpu")
    assert eng.append(docs[64:69]).tolist() == list(range(64, 69))
    assert eng.segments[-1].n_rows == 5 and eng.segment_live_device()[-1].all()
    assert eng.n_docs == eng.n_live == 69
    ref = jlc.SegmentedEngine(_jslice(c, 0, 64), c.emb)
    ref.append(_jslice(c, 64, 69))
    tk = getattr(eng, method)(docs[60:68], K)
    assert int(tk.indices.max()) < 69
    assert_topk_close(tk, getattr(ref, method)(_jslice(c, 60, 68), K))
    assert eng.one_sided(docs[:4]).shape == (69, 4)


def test_rerank_topk_matches_reference(corpus, grown):
    """Empty (-1) and tombstoned candidates are +inf WMD; the rest match the
    reference at ``RERANK_KW``."""
    c, docs, emb = corpus
    seg, ref, _ = _grow(c, docs, emb)
    seg.delete([9])
    ref.delete([9])
    cand = seg.topk_streaming(docs[8:16], 12).indices.clone()
    cand[0, -1] = -1                   # an empty slot
    cand[1, -1] = 9                    # a tombstoned doc
    got = seg.rerank_topk(docs[8:16], cand, 12, sinkhorn_kw=RERANK_KW)
    want = ref.rerank_topk(_jslice(c, 8, 16), jnp.asarray(cand.numpy()), 12,
                           sinkhorn_kw=RERANK_KW)
    assert torch.isinf(got.dists[:2, -1]).all()
    assert got.indices[0, -1] == -1 and got.indices[1, -1] == 9
    assert_topk_close(got, want)
    self_first = _np(got.indices[:, 0]) == np.arange(8, 16)
    assert self_first[[0, *range(2, 8)]].all() and not self_first[1]  # 9 dead


def test_segments_hold_no_target_gather(corpus, grown):
    """No (n·h1, m) gather anywhere; nbytes counts what each segment owns."""
    _, docs, emb = corpus
    seg = grown[0]
    h1, m = docs.h_max, emb.shape[1]
    for s in seg.segments:
        t = s.tensors
        assert t.emb is seg.emb_full   # shared, not owned
        owned = (t.emb_r, t.r_ids, t.r_w, t.ids, s.old_to_new)
        for x in owned:
            assert x.shape[-1] != m or x.shape[0] < s.n_rows * h1
        assert s.nbytes == sum(x.numel() * x.element_size() for x in owned)
    assert seg.nbytes == sum(s.nbytes for s in seg.segments)


def test_device_views_are_cached_per_version(corpus):
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:64], emb, device="cpu")
    eng.append(docs[64:80])
    live, seg_live, res = (eng.live_mask_device(), eng.segment_live_device(),
                           eng.resident)
    eng.topk(docs[:4], K)
    assert eng.live_mask_device() is live and eng.resident is res
    assert eng.segment_live_device() is seg_live
    assert torch.equal(res.ids, docs.ids[:80])
    eng.delete([3])
    assert eng.live_mask_device() is not live
    assert not bool(eng.live_mask_device()[3]) and bool(live[3])
    assert eng.segment_live_device() is not seg_live


def test_device_none_needs_a_card(corpus):
    _, docs, emb = corpus
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlc.SegmentedEngine(docs[:8], emb)


def test_vocab_chunk_bounds_the_cpu_phase1_only(corpus, grown):
    """``vocab_chunk`` takes the CPU's plain phase 1 that many restricted
    vocab rows at a time; the answers stay those of the unchunked engine."""
    _, docs, _ = corpus
    chunked = _grow(*corpus, vocab_chunk=100)[0]
    for m in METHODS:
        a = getattr(chunked, m)(docs[4:20], K)
        b = getattr(grown[0], m)(docs[4:20], K)
        assert torch.equal(a.indices, b.indices)
        torch.testing.assert_close(a.dists, b.dists, rtol=1e-6, atol=1e-6)
