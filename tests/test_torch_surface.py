"""The plan store's remaining public API in the port, each held to the
reference on the same inputs (numpy seeds): ``PlanCache.from_state`` across
the two packages, ``CostLedger.merge``, ``ModelConfig.to_json`` for every
arch of the registry, the ``PlanStore`` protocol, the match stages'
per-key ``on_insert`` hook, ``build_pipeline`` with stage instances,
``SimilarityIndex(bank=, n_tables=, n_bits=, lsh_seed=, probe_hamming=)``,
and ``generalize`` / ``instantiate`` on the reference's recorded fault."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.core import template as ref_template  # noqa: E402
from repro.core.cache import PlanCache as RefPlanCache  # noqa: E402
from repro.core.cost_model import CostLedger as RefLedger  # noqa: E402
from repro.core.distributed_cache import DistributedPlanCache as RefDistributed  # noqa: E402
from repro.index import EmbeddingBank as RefBank  # noqa: E402
from repro.index import SimilarityIndex as RefIndex  # noqa: E402
from repro.memory import pipeline as ref_pipeline  # noqa: E402
from repro.memory.protocol import PlanStore as RefPlanStore  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.apc_minion import DEFAULT  # noqa: E402
from repro_torch.core import template  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.core.cost_model import CostLedger  # noqa: E402
from repro_torch.core.distributed_cache import DistributedPlanCache  # noqa: E402
from repro_torch.index import DIM, EmbeddingBank, SimilarityIndex  # noqa: E402
from repro_torch.memory import pipeline  # noqa: E402
from repro_torch.memory.protocol import PlanStore  # noqa: E402

WORDS = ["revenue", "growth", "quarterly", "margin", "apple", "tesla", "net", "income",
         "ratio", "debt", "cash", "flow", "2021", "2022", "student", "grade"]


def _keywords(rng, n):
    return [" ".join(rng.choice(WORDS, size=rng.integers(2, 4), replace=False)) for _ in range(n)]


def _filled(cls, keys, capacity, **kw):
    c = cls(capacity=capacity, **kw)
    for i in range(0, len(keys), 3):  # waves of 3: eviction between waves
        c.insert_batch([(k, f"plan:{k}:{i}") for k in keys[i:i + 3]])
    return c


# ---------------------------------------------------------------------------
# PlanCache.from_state
# ---------------------------------------------------------------------------

STATE_KW = [{}, {"fuzzy": True, "fuzzy_threshold": 0.6}, {"eviction": "lfu"}]


@pytest.mark.parametrize("kw", STATE_KW, ids=["exact", "fuzzy0.6", "lfu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_state_crosses_packages(kw, seed):
    """A ``to_state()`` of either package restores in the other: the same
    keys in the same order, and a seeded lookup stream (stored keys, near
    variants and misses) answers alike, also after further inserts."""
    rng = np.random.default_rng(seed)
    keys = _keywords(rng, 30)
    ref, port = _filled(RefPlanCache, keys, 12, **kw), _filled(PlanCache, keys, 12, **kw)
    assert ref.to_state() == port.to_state()
    pairs = [(PlanCache.from_state(ref.to_state(), **kw), ref),
             (RefPlanCache.from_state(port.to_state(), **kw), port)]
    probes = keys + [k + " total" for k in keys[:8]] + _keywords(rng, 8)
    more = [(k, f"late:{k}") for k in _keywords(rng, 6)]
    for restored, src in pairs:
        assert restored.keys() == src.keys() and restored.capacity == src.capacity
        assert restored.lookup_batch(probes) == src.lookup_batch(probes)
        restored.insert_batch(more)
        src.insert_batch(more)
        assert restored.keys() == src.keys()
        assert restored.lookup_batch(probes) == src.lookup_batch(probes)


# ---------------------------------------------------------------------------
# CostLedger.merge
# ---------------------------------------------------------------------------

ROLES = ["large_planner", "small_planner", "actor", "keyword_extractor", "cache_generator"]


def _usage(ledger, rng, n):
    for _ in range(n):
        ledger.record(str(rng.choice(ROLES)), int(rng.integers(1, 4000)),
                      int(rng.integers(1, 800)))
    return ledger


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_merge_matches_reference(seed):
    """Two ledgers of seeded usage merged into one: the same breakdown,
    cost and latency as the reference's; the merged-from ledger unchanged."""
    def pair(cls):
        a = _usage(cls(pricing_map=dict(DEFAULT.pricing)), np.random.default_rng(seed), 40)
        b = _usage(cls(pricing_map=dict(DEFAULT.pricing)), np.random.default_rng(seed + 10), 25)
        before = b.breakdown()
        a.merge(b)
        assert b.breakdown() == before
        return a

    ref, port = pair(RefLedger), pair(CostLedger)
    assert port.breakdown() == ref.breakdown()
    assert port.total_cost() == pytest.approx(ref.total_cost(), rel=1e-12)
    assert port.total_latency() == pytest.approx(ref.total_latency(), rel=1e-12)


# ---------------------------------------------------------------------------
# ModelConfig.to_json
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_registry.ARCH_NAMES)
def test_to_json_is_the_references_bytes(arch):
    """Byte for byte, published and smoke configs."""
    assert registry.get(arch).to_json() == ref_registry.get(arch).to_json()
    assert registry.get_smoke(arch).to_json() == ref_registry.get_smoke(arch).to_json()


# ---------------------------------------------------------------------------
# The PlanStore protocol
# ---------------------------------------------------------------------------


def test_plan_stores_satisfy_the_protocol():
    """Both stores of both packages are ``PlanStore`` instances in their own
    package's protocol and in the other's (the same methods); an object
    without them is not."""
    stores = [PlanCache(4), DistributedPlanCache(2, capacity_per_node=4),
              RefPlanCache(4), RefDistributed(2, capacity_per_node=4)]
    for proto in (PlanStore, RefPlanStore):
        for s in stores:
            assert isinstance(s, proto), (proto, type(s))
        assert not isinstance(object(), proto)
        assert not isinstance({}, proto)


# ---------------------------------------------------------------------------
# MatchStage.on_insert and build_pipeline with stage instances
# ---------------------------------------------------------------------------


def _recorder(base):
    class Recorder(base):
        """Overrides only ``on_insert``: sees every insert through the
        default ``on_insert_batch``."""

        name = "recorder"

        def __init__(self):
            self.seen = []

        def on_insert(self, key, value, context=None, vector=None):
            self.seen.append((key, value, context, None if vector is None else
                              float(np.asarray(vector).sum())))

        def resolve(self, queries, contexts, contains):
            return [None] * len(queries)

    return Recorder()


def _insert_stream(cache, rng):
    keys = _keywords(rng, 20)
    for i in range(0, 20, 4):
        wave = keys[i:i + 4]
        ctx = [f"query about {k}" if j % 2 else None for j, k in enumerate(wave)]
        cache.insert_batch([(k, f"v{i}:{k}") for k in wave], contexts=ctx)
    vec = np.random.default_rng(7).standard_normal(DIM).astype(np.float32)
    cache.insert("single key", "v-single", context="the single query", vector=vec / 4)
    cache.insert("single key 2", "v-single-2")
    return keys


@pytest.mark.parametrize("seed", [0, 3])
def test_custom_stage_overriding_on_insert_sees_every_insert(seed):
    ref_rec, port_rec = _recorder(ref_pipeline.MatchStage), _recorder(pipeline.MatchStage)
    ref = RefPlanCache(8, pipeline=["exact", ref_rec])
    port = PlanCache(8, pipeline=["exact", port_rec])
    keys = _insert_stream(ref, np.random.default_rng(seed))
    _insert_stream(port, np.random.default_rng(seed))
    assert len(port_rec.seen) == 22 and port_rec.seen == ref_rec.seen
    assert port.lookup_batch(keys) == ref.lookup_batch(keys)


@pytest.mark.parametrize("stages", [("exact", "fuzzy"), ("exact", "semantic"),
                                    ("exact", "fuzzy", "semantic")], ids="-".join)
def test_build_pipeline_with_instances_equals_names(stages):
    """A cache over pre-built stages answers as one over the stages' names,
    and as the reference's cache over its own pre-built stages."""
    def built(mod):
        return [{"exact": lambda: mod.ExactStage(), "fuzzy": lambda: mod.FuzzyStage(0.6),
                 "semantic": lambda: mod.SemanticStage(0.7)}[s]() for s in stages]

    kw = {"fuzzy_threshold": 0.6, "semantic_threshold": 0.7}
    by_name = PlanCache(10, pipeline=list(stages), **kw)
    by_inst = PlanCache(10, pipeline=built(pipeline))
    ref = RefPlanCache(10, pipeline=built(ref_pipeline))
    assert [s.name for s in by_inst.pipeline.stages] == list(stages)
    rng = np.random.default_rng(5)
    keys = _keywords(rng, 16)
    probes = keys + [k + " figure" for k in keys] + _keywords(rng, 10)
    ctxs = [f"what is the {p} of the firm" for p in probes]
    for c in (by_name, by_inst, ref):
        c.insert_batch([(k, f"plan:{k}") for k in keys],
                       contexts=[f"what is the {k} of the firm" for k in keys])
    want = ref.lookup_batch(probes, contexts=ctxs)
    assert by_name.lookup_batch(probes, contexts=ctxs) == want
    assert by_inst.lookup_batch(probes, contexts=ctxs) == want


def test_build_pipeline_refuses_unknown_items():
    with pytest.raises(ValueError, match="MatchStage"):
        pipeline.build_pipeline(["exact", "nearest"])
    with pytest.raises(ValueError, match="duplicate"):
        pipeline.build_pipeline(["exact", pipeline.ExactStage()])


# ---------------------------------------------------------------------------
# SimilarityIndex(bank=, n_tables=, n_bits=, lsh_seed=, probe_hamming=)
# ---------------------------------------------------------------------------

N_BANK = 5000  # past the bucketed backend's scan threshold (2,048)


def _bank_rows(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N_BANK, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[rng.integers(0, N_BANK, 24)] + 0.3 * rng.standard_normal((24, DIM)).astype(np.float32)
    q = np.concatenate([q, rng.standard_normal((8, DIM)).astype(np.float32)])
    return v, q / np.linalg.norm(q, axis=1, keepdims=True)


def _with_bank(bank_cls, vecs):
    bank = bank_cls(64)
    for i, v in enumerate(vecs):
        bank.add(f"key-{i}", v)
    for i in range(0, N_BANK, 97):  # tombstones in the arena
        bank.remove(f"key-{i}")
    return bank


LSH = [dict(n_tables=4, n_bits=None, lsh_seed=0, probe_hamming=1),
       dict(n_tables=6, n_bits=10, lsh_seed=3, probe_hamming=2),
       dict(n_tables=2, n_bits=14, lsh_seed=11, probe_hamming=0)]


@pytest.mark.parametrize("lsh", LSH, ids=["default", "t6b10h2", "t2b14h0"])
def test_bucketed_index_over_an_existing_bank_matches_reference(lsh):
    """An existing bank of 5,000 rows (with removed ones) indexed by the
    ``bucketed`` backend with the LSH arguments: the same candidates and so
    the same top-k slots and scores as the reference's, and the same LSH
    geometry and telemetry."""
    vecs, q = _bank_rows(100 + lsh["lsh_seed"])
    ref = RefIndex(backend="bucketed", bank=_with_bank(RefBank, vecs), **lsh)
    port = SimilarityIndex(backend="bucketed", bank=_with_bank(EmbeddingBank, vecs), **lsh)
    assert len(port) == len(ref) == N_BANK - len(range(0, N_BANK, 97))
    assert port._bucketed.n_bits == ref._bucketed.n_bits
    rs, ri = ref.topk(q, k=4)
    ps, pi = port.topk(q, k=4)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=0, atol=1e-6)
    assert port.telemetry()["bucketed"]["probed_queries"] == len(q)
    assert port.telemetry()["bucketed"] == ref.telemetry()["bucketed"]


def test_device_index_over_an_existing_bank_uploads_it_once():
    """On the ``device`` backend (its plain version on the CPU) an existing
    bank's live rows are uploaded at construction, and its answers equal
    the reference's exact scan of the same bank."""
    vecs, q = _bank_rows(4)
    bank = _with_bank(EmbeddingBank, vecs[:300])
    port = SimilarityIndex(backend="device", bank=bank, device="cpu")
    tele = port.telemetry()["device"]
    assert (tele["batched_updates"], tele["row_updates"]) == (1, 0)
    assert tele["h2d_bytes_total"] == len(bank) * (DIM * 4 + 4)  # rows and their slots
    ref = RefIndex(backend="brute", bank=_with_bank(RefBank, vecs[:300]))
    rs, ri = ref.topk(q, k=3)
    ps, pi = port.topk(q, k=3)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=0, atol=1e-5)
    after = port.telemetry()["device"]  # lookups upload queries only, no rows
    assert (after["batched_updates"], after["row_updates"]) == (1, 0)


# ---------------------------------------------------------------------------
# generalize / instantiate
# ---------------------------------------------------------------------------


def _roundtrip(mod, slots):
    content = "Retrieve data for " + " ".join(str(v) for v in slots.values())
    steps = [mod.PlanStep("message", content, {"scope": dict(slots)})]
    gen = mod.generalize(steps, slots)
    return gen[0].content, gen[0].op, mod.instantiate(gen[0].op, slots)


def test_generalize_reproduces_the_references_recorded_fault():
    """``slots={'student': '11', 'company': 'de'}``: the reference replaces
    '11' inside the placeholder it just wrote, so the roundtrip gives
    ``{'student': '{student}', ...}`` back (ROADMAP §3); the port's twin does
    the same."""
    slots = {"student": "11", "company": "de"}
    got = _roundtrip(template, slots)
    assert got == _roundtrip(ref_template, slots)
    content, op, inst = got
    assert "{stu{company}nt}" in content and op["scope"]["student"] == "{stu{company}nt}"
    assert inst["scope"] == {"student": "{student}", "company": "de"}


def test_generalize_matches_reference_on_seeded_slots():
    rng = np.random.default_rng(0)
    alphabet = list("ABCdef123")
    names = ["company", "year", "student"]
    for _ in range(50):
        chosen = rng.choice(names, size=rng.integers(1, 4), replace=False)
        slots = {str(n): "".join(rng.choice(alphabet, size=rng.integers(2, 9)))
                 for n in chosen}
        assert _roundtrip(template, slots) == _roundtrip(ref_template, slots), slots
