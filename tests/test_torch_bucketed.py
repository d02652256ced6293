"""The port's multi-probe LSH index and the ``bucketed`` / ``auto``
backends (``repro_torch.index``) against ``repro.index`` on seeded banks:
the same candidate sets, top-k answers and telemetry, the same switch from
the exact scan to the LSH probe at ``auto_bucketed_min``, and the same
``autotune`` decisions on the same query stream."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.index import SimilarityIndex as JIndex  # noqa: E402
from repro.index.bank import EmbeddingBank as JBank  # noqa: E402
from repro.index.bucketed import BucketedIndex as JBucketed  # noqa: E402
from repro_torch.index import SimilarityIndex, embed_batch  # noqa: E402
from repro_torch.index.bank import EmbeddingBank  # noqa: E402
from repro_torch.index.bucketed import BucketedIndex  # noqa: E402

WORDS = ["revenue", "margin", "ratio", "growth", "debt", "cash", "capital", "quarterly",
         "annual", "net", "operating", "working", "asset", "equity", "turnover", "yield",
         "interest", "coverage", "inventory", "payout"]


def _keys(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        k = " ".join(rng.choice(WORDS, size=rng.randint(2, 5))) + f" {rng.randint(10**6)}"
        if k not in out:
            out.append(k)
    return out


def _queries(keys, n, seed):
    """Paraphrase-like probes: stored keys with a word added, and fresh ones."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 3:
            out.append(keys[rng.randint(len(keys))] + " " + rng.choice(WORDS))
        else:
            out.append(" ".join(rng.choice(WORDS, size=3)))
    return out


def _pair_bucketed(keys, **kw):
    t_bank, j_bank = EmbeddingBank(64), JBank(64)
    vecs = embed_batch(keys)
    for k, v in zip(keys, vecs):
        t_bank.add(k, v)
        j_bank.add(k, v)
    return BucketedIndex(t_bank, **kw), JBucketed(j_bank, **kw)


@pytest.mark.parametrize("n,kw", [
    (100, {"scan_threshold": 0, "n_bits": 6}),  # a small bank forced onto the probe
    (100, {"scan_threshold": 0, "probe_hamming": 2, "n_tables": 2}),
    (5000, {}),  # above the default scan threshold: adaptive 12-bit tables
])
def test_bucketed_candidates_and_topk_match_reference(n, kw):
    keys = _keys(n, seed=n)
    t, j = _pair_bucketed(keys, **kw)
    np.testing.assert_array_equal(t._planes, j._planes)  # drawn as the reference draws them
    assert t.n_bits == j.n_bits
    q = embed_batch(_queries(keys, 150, seed=1))
    for row in q[:60]:
        np.testing.assert_array_equal(t.candidates(row), j.candidates(row))
    assert t.best_slot(q[0]) == j.best_slot(q[0])
    for k in (1, 4):
        ts, ti = t.topk(q, k)
        js, ji = j.topk(q, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    assert (ti[:, 0] >= 0).any()
    snap = t.telemetry.snapshot()
    assert snap == j.telemetry.snapshot()
    assert snap["probed_queries"] > 0 and snap["recall_checks"] > 0


def test_bucketed_maintenance_matches_reference():
    """Removals and slot reuse keep the buckets equal: after a churn of
    removes and re-adds the candidates and answers still agree."""
    keys = _keys(300, seed=3)
    t, j = _pair_bucketed(keys, scan_threshold=0, n_bits=8)
    rng = np.random.RandomState(4)
    fresh = iter(_keys(200, seed=5))
    for _ in range(150):
        if rng.rand() < 0.5:
            k = keys.pop(rng.randint(len(keys)))
            for idx in (t, j):
                idx.on_remove(idx.bank.remove(k))
        else:
            k = next(fresh)
            keys.append(k)
            for idx in (t, j):
                idx.on_add(idx.bank.add(k), idx.bank.vector(k))
    assert t._sigs_of == j._sigs_of
    q = embed_batch(_queries(keys, 40, seed=6))
    for row in q:
        np.testing.assert_array_equal(t.candidates(row), j.candidates(row))
    np.testing.assert_array_equal(t.topk(q, 3)[1], j.topk(q, 3)[1])


def test_auto_switches_at_auto_bucketed_min():
    """``auto`` answers with the exact scan up to ``auto_bucketed_min`` live
    entries and with the LSH probe past it, as the reference does; the
    default threshold is 4096 in both."""
    assert SimilarityIndex(backend="auto")._bucketed.scan_threshold == 4096
    assert JIndex(backend="auto")._bucketed.scan_threshold == 4096
    assert SimilarityIndex(backend="bucketed")._bucketed.scan_threshold == 2048
    t = SimilarityIndex(backend="auto", auto_bucketed_min=64)
    j = JIndex(backend="auto", auto_bucketed_min=64)
    keys = _keys(120, seed=8)
    probes = _queries(keys, 12, seed=9)
    for i in range(0, 120, 8):
        t.add_batch(keys[i:i + 8])
        j.add_batch(keys[i:i + 8])
        assert t.best_match_batch(probes, 0.5) == j.best_match_batch(probes, 0.5)
        assert [t.best_match(p, 0.5) for p in probes] == [j.best_match(p, 0.5) for p in probes]
        ts, ti = t.topk(probes, k=2)
        js, ji = j.topk(probes, k=2)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        tele = t._bucketed.telemetry.snapshot()
        assert tele == j.telemetry()["bucketed"]
        if len(t) <= 64:
            assert tele["probed_queries"] == 0
    assert tele["brute_fallback_queries"] > 0 and tele["probed_queries"] > 0
    for k in keys[::3]:
        t.remove(k)
        j.remove(k)
    assert t.best_match_batch(probes, 0.3) == j.best_match_batch(probes, 0.3)


def test_autotune_decisions_match_reference():
    """The same query stream gives the same telemetry windows and the same
    autotune actions (growing n_bits while candidates run high, widening
    the probe ball when recall or empty probes call for it)."""
    keys = _keys(1500, seed=10)
    t, j = _pair_bucketed(keys, n_bits=4, probe_hamming=0, scan_threshold=256)
    actions, jactions = [], []
    for window in range(6):
        probes = embed_batch(_queries(keys, 80, seed=20 + window))
        assert [t.best_slot(q) for q in probes] == [j.best_slot(q) for q in probes]
        actions.append(t.autotune(target_candidates=48.0, min_queries=64))
        jactions.append(j.autotune(target_candidates=48.0, min_queries=64))
        assert t.telemetry.snapshot() == j.telemetry.snapshot()
    assert actions == jactions
    assert "n_bits->6" in actions and any(a and a.startswith("probe_hamming") for a in actions)


def test_facade_autotune_matches_reference():
    """``SimilarityIndex.autotune`` steps the ``auto`` backend's LSH tables
    as the reference's does, and is None on a backend without them."""
    keys = _keys(600, seed=11)
    t = SimilarityIndex(backend="auto", auto_bucketed_min=256)
    j = JIndex(backend="auto", auto_bucketed_min=256)
    t.add_batch(keys)
    j.add_batch(keys)
    for window in range(2):
        probes = _queries(keys, 80, seed=30 + window)
        assert t.best_match_batch(probes, 0.5) == j.best_match_batch(probes, 0.5)
        assert t.autotune(min_queries=64) == j.autotune(min_queries=64)
        assert t._bucketed.telemetry.snapshot() == j.telemetry()["bucketed"]
    assert SimilarityIndex(backend="brute").autotune() is None
