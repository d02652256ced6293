"""The port's ``repro_torch.core.fuzzy`` (``similarity``, ``FuzzyMatcher``
and the re-exported embedding surface) against ``repro.core.fuzzy`` on the
same keys and queries, on every index backend the port runs on the CPU
(``pallas`` and ``device`` on ``device="cpu"``), and
tests/test_index.py::test_fuzzy_matcher_compat_keys_argument's case on the
port's matcher. Similarities are compared to 1e-6 (both packages embed with
the same float32 numpy code); matches exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fuzzy as jfuzzy  # noqa: E402
from repro_torch.core import fuzzy  # noqa: E402

KEYS = ["working capital ratio", "net revenue growth", "free cash flow margin",
        "operating expense change", "dupont roe decomposition", "receivable days",
        "insurance float yoy change", "fee income yoy change"]
QUERIES = ["working capital ratio analysis", "net revenue growth yoy", "fcf margin",
           "opex change analysis", "quantum chromodynamics", "receivable days derivation",
           "insurance float share of revenue", "fee income change"]
BACKENDS = ["auto", "brute", "bucketed", "pallas", "device"]


def _matcher(mod, backend):
    kw = {"device": "cpu"} if mod is fuzzy and backend in ("pallas", "device") else {}
    return mod.FuzzyMatcher(backend=backend, **kw)


def test_embedding_surface_matches_reference():
    assert fuzzy.DIM == jfuzzy.DIM
    np.testing.assert_array_equal(fuzzy.embed("net revenue growth"),
                                  jfuzzy.embed("net revenue growth"))
    np.testing.assert_array_equal(fuzzy.embed_batch(KEYS), jfuzzy.embed_batch(KEYS))


def test_similarity_matches_reference():
    for a in KEYS:
        for b in QUERIES:
            assert abs(fuzzy.similarity(a, b) - jfuzzy.similarity(a, b)) <= 1e-6
    assert abs(fuzzy.similarity("fcf margin", "fcf margin") - 1.0) <= 1e-6


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("threshold", [0.5, 0.7, 0.9])
def test_best_match_matches_reference(backend, threshold):
    ms = [_matcher(jfuzzy, backend), _matcher(fuzzy, backend)]
    for m in ms:
        m.add_batch(KEYS[:4])
        for k in KEYS[4:]:
            m.add(k)
    got = [[m.best_match(q, threshold=threshold) for q in QUERIES] for m in ms]
    batch = [m.best_match_batch(QUERIES, threshold=threshold) for m in ms]
    assert got[1] == got[0] and batch[1] == batch[0] and batch[0] == got[0]
    for m in ms:
        m.remove("fcf margin")  # absent: a no-op
        m.remove(KEYS[0])
    assert ms[1].best_match_batch(QUERIES, threshold) == ms[0].best_match_batch(QUERIES,
                                                                                threshold)
    for m in ms:
        m.clear()
    assert [m.best_match(QUERIES[0], threshold=0.0) for m in ms] == [None, None]


def test_caller_vectors_skip_embedding_like_the_reference():
    vecs = jfuzzy.embed_batch(["alpha beta", "gamma delta"])
    ms = [_matcher(jfuzzy, "brute"), _matcher(fuzzy, "brute")]
    for m in ms:
        m.add_batch(["k1", "k2"], vecs)  # keys stored under someone else's vectors
    assert ms[1].best_match_batch(["alpha beta", "gamma delta", "k1"], 0.9) == \
        ms[0].best_match_batch(["alpha beta", "gamma delta", "k1"], 0.9) == ["k1", "k2", None]


def test_fuzzy_matcher_compat_keys_argument():
    """tests/test_index.py's case: an external key set reconciles the
    index (stale removed, new added)."""
    for mod in (jfuzzy, fuzzy):
        m = mod.FuzzyMatcher()
        m.add("stale key")
        assert m.best_match("fresh key", ["fresh key"], threshold=0.9) == "fresh key"
        assert m.best_match("stale key", threshold=0.99) != "stale key"
