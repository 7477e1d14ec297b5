"""The port's data layer against the reference: bit-equal corpora and DocSets."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data import docs as jdocs
from repro.data import synth as jsynth
from repro_torch import convert
from repro_torch.data import docs as tdocs
from repro_torch.data import synth as tsynth

SPECS = [
    dict(n_docs=96, vocab_size=512, emb_dim=48, h_max=16, mean_h=8.0,
         n_classes=4, seed=7),
    dict(n_docs=64, vocab_size=300, emb_dim=16, h_max=8, mean_h=5.0,
         n_classes=3, seed=3, topic_noise=0.4),
]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("maker", ["make_corpus", "make_bimodal_corpus"])
@pytest.mark.parametrize("spec", SPECS, ids=["small", "narrow"])
def test_corpus_bit_equal(spec, maker):
    want = getattr(jsynth, maker)(jsynth.CorpusSpec(**spec))
    got = getattr(tsynth, maker)(tsynth.CorpusSpec(**spec), device="cpu")
    assert np.array_equal(got.emb, want.emb)
    assert np.array_equal(got.labels, want.labels)
    assert got.docs.ids.dtype == torch.int32
    assert got.docs.weights.dtype == torch.float32
    assert np.array_equal(_np(got.docs.ids), _np(want.docs.ids))
    assert np.array_equal(_np(got.docs.weights), _np(want.docs.weights))


@pytest.mark.parametrize("which,scale", [("set1", 0.001), ("set2", 0.25)])
def test_table_iv_spec_equal(which, scale):
    got = dataclasses.asdict(tsynth.table_iv_spec(which, scale))
    assert got == dataclasses.asdict(jsynth.table_iv_spec(which, scale))


def test_table_iv_spec_rejects_unknown():
    with pytest.raises(ValueError):
        tsynth.table_iv_spec("set3")


def test_make_docset_bit_equal():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, size=(7, 6)).astype(np.int32)
    w = rng.uniform(0, 3, size=(7, 6)).astype(np.float32)
    ids[1, 3:] = -1          # ingest padding convention
    w[4] = 0.0               # an empty row keeps weight 0, norm 1
    want = jdocs.make_docset(ids, w)
    got = tdocs.make_docset(ids, w, device="cpu")
    assert np.array_equal(_np(got.ids), _np(want.ids))
    assert np.array_equal(_np(got.weights), _np(want.weights))
    with pytest.raises(ValueError):
        tdocs.make_docset(ids, w[:, :3], device="cpu")


def test_docset_from_lists_bit_equal():
    lists = [[(3, 2.0), (7, 1.0), (9, 5.0)], [(1, 1.0)], [],
             [(i, float(i + 1)) for i in range(10)]]
    want = jdocs.docset_from_lists(lists, h_max=4)
    got = tdocs.docset_from_lists(lists, h_max=4, device="cpu")
    assert np.array_equal(_np(got.ids), _np(want.ids))
    assert np.array_equal(_np(got.weights), _np(want.weights))


def test_csr_round_trip_and_parity(small_corpus):
    ds = tsynth.make_corpus(tsynth.CorpusSpec(**SPECS[0]), device="cpu").docs
    got = tdocs.to_csr(ds, vocab_size=512)
    want = jdocs.to_csr(small_corpus.docs, vocab_size=512)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    back = tdocs.from_csr(*got, h_max=ds.h_max, device="cpu")
    assert torch.equal(back.ids, ds.ids)
    assert torch.allclose(back.weights, ds.weights, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        tdocs.to_csr(ds, vocab_size=10)


def test_from_csr_truncates_like_reference():
    indptr = np.array([0, 5, 6])
    indices = np.array([4, 1, 8, 2, 6, 3])
    data = np.array([0.1, 0.5, 0.2, 0.9, 0.3, 1.0], np.float32)
    want = jdocs.from_csr(indptr, indices, data, h_max=3)
    got = tdocs.from_csr(indptr, indices, data, h_max=3, device="cpu")
    assert np.array_equal(_np(got.ids), _np(want.ids))
    assert np.array_equal(_np(got.weights), _np(want.weights))


def test_docset_views(small_corpus):
    ds, _ = convert.from_numpy(np.asarray(small_corpus.docs.ids),
                               np.asarray(small_corpus.docs.weights),
                               small_corpus.emb, device="cpu")
    ref = small_corpus.docs
    assert (ds.n_docs, ds.h_max) == (ref.n_docs, ref.h_max)
    assert np.array_equal(_np(ds.mask), _np(ref.mask))
    assert np.array_equal(_np(ds.lengths), _np(ref.lengths))
    assert ds.lengths.dtype == torch.int32
    sub = ds[3:9]
    assert np.array_equal(_np(sub.ids), _np(ref[3:9].ids))
    assert ds.to("cpu").device.type == "cpu"


def test_from_numpy_carries_the_reference_arrays(small_corpus):
    ids = np.asarray(small_corpus.docs.ids)
    w = np.asarray(small_corpus.docs.weights)
    ds, emb = convert.from_numpy(ids, w, small_corpus.emb, device="cpu")
    assert ds.ids.dtype == torch.int32 and emb.dtype == torch.float32
    assert np.array_equal(_np(ds.ids), ids)
    assert np.array_equal(_np(ds.weights), w)
    assert np.array_equal(_np(emb), small_corpus.emb)
    with pytest.raises(ValueError):
        convert.from_numpy(ids, w[:, :2], small_corpus.emb, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA: without a card it raises, it never moves to the CPU."""
    from repro_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tdocs.make_docset(np.zeros((2, 3), np.int32), np.ones((2, 3), np.float32))
    with pytest.raises(RuntimeError):
        tsynth.make_corpus(tsynth.CorpusSpec(**SPECS[1]))
    assert resolve_device("cpu") == torch.device("cpu")
