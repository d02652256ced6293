"""The port's paged KV prefix cache (``repro_torch.serving.kv_cache``) and
the engine's prefix path against ``repro.serving.kv_cache`` and
``repro.serving.engine``.

Every op stream of tests/test_kv_cache.py runs through both packages on the
same data (numpy, handed to jax and to torch): after each op the refcounts,
the free list (in order), the entries (pages, length, recency, leases), the
page tables and the four counters must be equal, and both raise the same
exception with the same message. Gathered contents must be equal exactly
(f32 copies). The engine tests run f32 smoke olmo-1b in both packages on the
same weights, vocab widened to 50,304 as in test_torch_serving.py: logits
within 2e-4, identical greedy tokens.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

torch.set_num_threads(2)

COUNTERS = {"pages_hit": "_pages_hit", "pages_built": "_pages_built",
            "tokens_prefetched": "_tokens_prefetched",
            "prefix_evictions": "_prefix_evictions"}


def _kv_np(L=2, S=10, fill=None):
    if fill is None:
        return np.arange(L * S * 2 * 8, dtype=np.float32).reshape(L, S, 2, 8)
    return np.full((L, S, 2, 8), float(fill), np.float32)


class Both:
    """One KVPrefixCache of each package over a (2 layers, num_pages,
    page_size, 2 heads, hd 8) f32 pool; ``do`` runs one op on both and
    checks that their states agree."""

    def __init__(self, num_pages=16, page_size=4, **obs):
        self.j = jkv.KVPrefixCache(
            jkv.PagePool(2, num_pages, page_size, 2, 8, dtype=jnp.float32), **obs.get("j", {}))
        self.t = tkv.KVPrefixCache(
            tkv.PagePool(2, num_pages, page_size, 2, 8, dtype=torch.float32, device="cpu"),
            **obs.get("t", {}))

    @staticmethod
    def _conv(a, side):
        if isinstance(a, np.ndarray):
            return jnp.asarray(a) if side == "j" else torch.from_numpy(a.copy())
        if isinstance(a, tuple):  # a pair of leases
            return a[0] if side == "j" else a[1]
        if isinstance(a, list):
            return [Both._conv(x, side) for x in a]
        return a

    def do(self, op, *args, **kw):
        """Run ``op`` on both caches; returns (reference result, port
        result). Both must raise alike or return alike."""
        res, errs = {}, {}
        for side, obj in (("j", self.j), ("t", self.t)):
            a = [self._conv(x, side) for x in args]
            k = {n: self._conv(x, side) for n, x in kw.items()}
            try:
                res[side] = getattr(obj, op)(*a, **k)
            except Exception as e:  # compared below
                errs[side] = e
        if errs:
            assert set(errs) == {"j", "t"}, f"{op}: only {set(errs)} raised: {errs}"
            assert type(errs["t"]).__name__ == type(errs["j"]).__name__
            assert str(errs["t"]) == str(errs["j"])
            self.check()
            raise errs["t"]
        self.check()
        return res["j"], res["t"]

    def check(self):
        jp, tp = self.j.pool, self.t.pool
        assert tp.refcount.tolist() == jp.refcount.tolist()
        assert tp._free == jp._free
        assert tp.free_pages == jp.free_pages
        je = {k: (list(e.pages), e.length, e.last_used, e.leases)
              for k, e in self.j._entries.items()}
        te = {k: (list(e.pages), e.length, e.last_used, e.leases)
              for k, e in self.t._entries.items()}
        assert te == je and list(te) == list(je)
        for tname, jname in COUNTERS.items():
            assert getattr(self.t, tname) == getattr(self.j, jname).value, tname
            assert getattr(self.t, jname).value == getattr(self.j, jname).value, jname
        assert self.t.obs.snapshot() == self.j.obs.snapshot()

    def same_gather(self, leases, batch=1):
        (kj, vj, lj), (kt, vt, lt) = self.do("gather", leases, batch=batch)
        assert lt == lj
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        return kt, lt


# -- page pool / refcounts -----------------------------------------------------


def test_page_refcount_lifecycle():
    b = Both()
    b.do("put", "a", _kv_np(S=10), _kv_np(S=10), length=10)  # 3 pages (4+4+2)
    pages = list(b.t._entries["a"].pages)
    assert b.t.pool.free_pages == 13
    lease = b.do("acquire", "a")
    assert lease[1].length == 10 and lease[1] == tkv.PrefixLease("a", tuple(pages), 10)
    assert all(b.t.pool.refcount[p] == 2 for p in pages)
    # release while leased: the entry goes, the pages survive via the lease
    assert b.do("release", "a") == (True, True)
    assert "a" not in b.t
    kt, ln = b.same_gather(lease, batch=2)
    assert tuple(kt.shape) == (2, 2, 12, 2, 8) and ln == 10
    b.do("release_lease", lease)
    assert b.t.pool.free_pages == 16
    assert b.do("release", "a") == (False, False)  # unknown ids are a no-op


def test_put_roundtrips_content_with_page_padding():
    b = Both()
    src = _kv_np(S=10)
    b.do("put", "a", src, src, length=7)  # 2 pages, the last padded by 1
    lease = b.do("acquire", "a")
    kt, ln = b.same_gather(lease)
    assert ln == 7
    np.testing.assert_array_equal(kt[:, 0, :7].numpy(), src[:, :7])
    np.testing.assert_array_equal(kt[:, 0, 7:].numpy(), np.zeros((2, 1, 2, 8), np.float32))
    b.do("release_lease", lease)
    with pytest.raises(ValueError):
        b.t.put("z", torch.zeros(2, 3, 2, 8), torch.zeros(2, 3, 2, 8), length=4)


def test_cow_extend_shares_full_pages_and_copies_tail():
    b = Both()
    parent = _kv_np(S=10)
    b.do("put", "p", parent, parent, length=10)
    ppages = list(b.t._entries["p"].pages)
    n_new = b.do("extend", "p", "c", _kv_np(S=5, fill=1.0), _kv_np(S=5, fill=1.0))
    assert n_new == (2, 2)  # tail(2) + 5 suffix = 7 -> 2 pages
    cpages = list(b.t._entries["c"].pages)
    assert cpages[:2] == ppages[:2] and cpages[2] != ppages[2]
    assert b.t.pool.refcount[ppages[0]] == 2
    lease = b.do("acquire", "c")
    kt, ln = b.same_gather(lease)
    assert ln == 15
    expect = np.concatenate([parent, np.ones((2, 5, 2, 8), np.float32)], axis=1)
    np.testing.assert_array_equal(kt[:, 0, :15].numpy(), expect)
    b.do("release_lease", lease)
    b.do("release", "p")  # shared pages stay alive for the child
    assert b.t.pool.refcount[ppages[0]] == 1
    b.do("release", "c")
    assert b.t.pool.free_pages == 16
    with pytest.raises(KeyError):
        b.do("extend", "gone", "c2", _kv_np(S=5), _kv_np(S=5))


def test_lru_eviction_on_pool_exhaustion_and_lease_pinning():
    b = Both(num_pages=4)
    b.do("put", "old", _kv_np(S=8), _kv_np(S=8))  # 2 pages
    b.do("put", "new", _kv_np(S=8), _kv_np(S=8))  # 2 pages, the pool is full
    lease = b.do("acquire", "new")
    with pytest.raises(tkv.PagePoolExhausted, match="no evictable prefix"):
        # "old" can be evicted (2 pages) but "new" is leased: only 2 free
        b.do("put", "x", _kv_np(S=16), _kv_np(S=16))
    assert "old" not in b.t  # the idle LRU victim went first
    with pytest.raises(tkv.PagePoolExhausted, match="is leased"):
        b.do("put", "new", _kv_np(S=4), _kv_np(S=4))
    b.do("release_lease", lease)
    b.do("put", "x", _kv_np(S=16), _kv_np(S=16))  # now "new" is evictable
    assert "new" not in b.t and "x" in b.t
    assert b.t.prefix_evictions == 2


def test_lru_victim_follows_recency_of_acquire():
    """Acquiring a prefix makes it the most recent: the other one is the
    victim, in both packages."""
    b = Both(num_pages=4)
    b.do("put", "a", _kv_np(S=8), _kv_np(S=8))
    b.do("put", "b", _kv_np(S=8), _kv_np(S=8))
    b.do("release_lease", b.do("acquire", "a"))
    b.do("put", "c", _kv_np(S=8), _kv_np(S=8))
    assert b.t.keys() == ["a", "c"]


def test_extend_under_pool_pressure_pins_parent():
    b = Both(num_pages=4)
    parent = _kv_np(S=10)
    b.do("put", "p", parent, parent, length=10)  # 3 pages, 1 free
    with pytest.raises(tkv.PagePoolExhausted):
        b.do("extend", "p", "c", _kv_np(S=5, fill=1.0), _kv_np(S=5, fill=1.0))  # needs 2
    assert "p" in b.t and "c" not in b.t
    assert b.t._entries["p"].leases == 0  # the extend pin was released
    lease = b.do("acquire", "p")
    kt, ln = b.same_gather(lease)
    np.testing.assert_array_equal(kt[:, 0, :10].numpy(), parent)
    b.do("release_lease", lease)


def test_extend_under_pool_pressure_evicts_idle_not_parent():
    b = Both(num_pages=6)
    parent = _kv_np(S=10)
    b.do("put", "idle", _kv_np(S=8), _kv_np(S=8))  # 2 pages
    b.do("put", "p", parent, parent, length=10)  # 3 pages, 1 free
    assert b.do("extend", "p", "c", _kv_np(S=5, fill=1.0), _kv_np(S=5, fill=1.0)) == (2, 2)
    assert "idle" not in b.t and "p" in b.t
    lease = b.do("acquire", "c")
    kt, ln = b.same_gather(lease)
    assert ln == 15
    b.do("release_lease", lease)


def test_extend_on_a_page_boundary_copies_nothing_of_the_parent():
    b = Both(num_pages=8)
    b.do("put", "p", _kv_np(S=8), _kv_np(S=8))  # exactly 2 full pages
    assert b.do("extend", "p", "c", _kv_np(S=3, fill=2.0), _kv_np(S=3, fill=2.0),
                length=2) == (1, 1)
    assert b.t._entries["c"].pages[:2] == b.t._entries["p"].pages
    b.same_gather(b.do("acquire", "c"))


def test_alloc_over_capacity_fails_fast_without_evicting():
    b = Both(num_pages=4)
    b.do("put", "a", _kv_np(S=8), _kv_np(S=8))  # 2 pages
    with pytest.raises(tkv.PagePoolExhausted, match="holds only"):
        b.do("put", "x", _kv_np(S=32), _kv_np(S=32))  # 8 pages > 4 total
    assert "a" in b.t and b.t.pool.free_pages == 2
    assert b.t.prefix_evictions == 0


def test_counters_match_the_reference_registry():
    b = Both()
    b.do("put", "a", _kv_np(S=8), _kv_np(S=8))
    lease = b.do("acquire", "a")
    b.do("gather", lease, batch=4)
    b.do("release_lease", lease)
    b.do("release", "a")
    assert (b.t.pages_built, b.t.pages_hit, b.t.tokens_prefetched,
            b.t.prefix_evictions) == (2, 2, 32, 1)
    b.do("put", "b", _kv_np(S=8), _kv_np(S=8))
    b.do("put", "c", _kv_np(S=3), _kv_np(S=3))
    b.do("clear")
    assert len(b.t) == 0 and b.t.pool.free_pages == 16 and b.t.prefix_evictions == 3


def test_metrics_land_in_registry():
    """The twin of tests/test_kv_cache.py::test_metrics_land_in_registry,
    with a registry and labels given to each package's cache: the four
    series of both snapshots are equal, (2, 2, 32, 1), under the labels, and
    the port's attributes read the registry."""
    labels = {"shard": "n0"}
    jreg, treg = JRegistry(), MetricsRegistry()
    b = Both(j={"obs": jreg, "obs_labels": labels}, t={"obs": treg, "obs_labels": labels})
    assert b.t.obs is treg
    b.do("put", "a", _kv_np(S=8), _kv_np(S=8))
    lease = b.do("acquire", "a")
    b.do("gather", lease, batch=4)
    b.do("release_lease", lease)
    b.do("release", "a")
    names = ("kv.pages_built", "kv.pages_hit", "kv.tokens_prefetched", "kv.prefix_evictions")
    snap = treg.snapshot()
    assert snap == jreg.snapshot()
    assert {n: snap[n] for n in names} == {
        "kv.pages_built": {"shard=n0": 2}, "kv.pages_hit": {"shard=n0": 2},
        "kv.tokens_prefetched": {"shard=n0": 32}, "kv.prefix_evictions": {"shard=n0": 1}}
    assert (b.t.pages_built, b.t.pages_hit, b.t.tokens_prefetched, b.t.prefix_evictions) == \
        tuple(treg.counter(n, shard="n0").value for n in names)
    assert treg.counter("kv.pages_built").value == 0  # no unlabelled series
    with pytest.raises(AttributeError):
        b.t.pages_hit = 0  # read-only: the registry holds the count


def test_registry_counts_evictions_under_pool_pressure():
    """Two caches on one registry under different labels; LRU evictions
    under pool pressure land in ``_prefix_evictions`` and the labelled
    series as in the reference (tests/test_kv_cache.py:121, :171)."""
    jreg, treg = JRegistry(), MetricsRegistry()
    b = Both(num_pages=4, j={"obs": jreg, "obs_labels": {"shard": "a"}},
             t={"obs": treg, "obs_labels": {"shard": "a"}})
    b.do("put", "old", _kv_np(S=8), _kv_np(S=8))
    b.do("put", "new", _kv_np(S=8), _kv_np(S=8))
    b.do("release_lease", b.do("acquire", "new"))
    b.do("put", "x", _kv_np(S=8), _kv_np(S=8))  # evicts "old"
    b.do("put", "y", _kv_np(S=12), _kv_np(S=12))  # 3 pages: evicts "new" and "x"
    with pytest.raises(tkv.PagePoolExhausted, match="holds only"):
        b.do("put", "z", _kv_np(S=32), _kv_np(S=32))
    assert b.t._prefix_evictions.value == b.j._prefix_evictions.value == 3
    other = tkv.KVPrefixCache(  # a second cache's series beside the first's
        tkv.PagePool(2, 4, 4, 2, 8, dtype=torch.float32, device="cpu"),
        obs=treg, obs_labels={"shard": "b"})
    other.put("q", torch.zeros(2, 4, 2, 8), torch.zeros(2, 4, 2, 8))
    other.release("q")
    snap = treg.snapshot()
    assert snap["kv.prefix_evictions"] == {"shard=a": 3, "shard=b": 1}
    assert snap["kv.pages_built"] == {"shard=a": 9, "shard=b": 1}
    assert {k: v["shard=a"] for k, v in snap.items()} == \
        {k: v["shard=a"] for k, v in jreg.snapshot().items()}


# -- page table for the paged kernel -------------------------------------------


def test_page_table_calling_convention():
    b = Both()
    b.do("put", "a", _kv_np(S=10), _kv_np(S=10))  # 3 pages
    b.do("put", "b", _kv_np(S=3), _kv_np(S=3))  # 1 page
    la, lb = b.do("acquire", "a"), b.do("acquire", "b")
    (tj, lj), (tt, lt) = b.do("page_table", [la, lb])
    assert tt.dtype == torch.int32 and lt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert tt.shape == (2, 3) and lt.tolist() == [10, 3]
    assert tt[1, 1] == -1
    b.do("release_lease", la)
    b.do("release_lease", lb)


# -- the single cache point -----------------------------------------------------


def test_plan_cache_point_placement():
    tpl = np.asarray([5, 6, 7], np.int32)
    prompts = np.asarray([[5, 6, 7, 1, 2], [5, 6, 7, 3, 4]], np.int32)
    cases = [(tpl, prompts), (tpl, prompts[:, [0, 2, 1, 3, 4]]), (tpl, prompts[:, :3]),
             (np.asarray([], np.int32), prompts), (tpl, prompts[0])]
    for t, p in cases:
        got, want = tkv.plan_cache_point("t", t, p), jkv.plan_cache_point("t", t, p)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.template_id, got.prefix_len) == (want.template_id, want.prefix_len)
    assert tkv.plan_cache_point("t", tpl, prompts) == tkv.CachePoint("t", 3)


# -- engine integration ---------------------------------------------------------

WIDE = dict(vocab_size=50_304, dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """f32 smoke olmo-1b in both packages, same weights, each with a 32-page
    pool of 8-token pages."""
    jcfg = dataclasses.replace(jregistry.get_smoke("olmo-1b"), **WIDE)
    tcfg = dataclasses.replace(registry.get_smoke("olmo-1b"), **WIDE)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    pt = lm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    jk = jkv.KVPrefixCache(jkv.pool_for_config(jcfg, num_pages=32, page_size=8))
    tk = tkv.KVPrefixCache(tkv.pool_for_config(tcfg, num_pages=32, page_size=8,
                                               device="cpu"))
    return (JEngine(jcfg, pj, max_len=64, kv_prefix=jk),
            Engine(tcfg, pt, max_len=64, device="cpu", kv_prefix=tk))


def _prompts(seed, B, Sp, Ss):
    rs = np.random.RandomState(seed)
    tpl = rs.randint(3, 50_000, (Sp,)).astype(np.int32)
    suffix = rs.randint(3, 50_000, (B, Ss)).astype(np.int32)
    return tpl, suffix, np.concatenate([np.broadcast_to(tpl, (B, Sp)), suffix], axis=1)


def test_prefill_with_prefix_matches_full_prefill_and_reference(engines):
    """Suffix-only prefill against pooled template KV reproduces the full
    prefill (logits within 2e-4, cache contents, greedy continuation), and
    the port's prefix path matches the reference's."""
    je, te = engines
    B, Sp, Ss = 4, 20, 8
    tpl, suffix, toks = _prompts(0, B, Sp, Ss)
    assert te.prefill_with_prefix("tpl", suffix) is None  # cold: no prefix
    assert je.prefill_with_prefix("tpl", suffix) is None
    full_t, cache_t = te.prefill(toks)
    full_j, cache_j = je.prefill(toks)
    assert te.register_prefix("tpl", cache_t, Sp) and je.register_prefix("tpl", cache_j, Sp)
    reused0, pre0 = te.stats.prefix_tokens_reused, te.stats.prefill_tokens

    lt, ct = te.prefill_with_prefix("tpl", suffix)
    lj, cj = je.prefill_with_prefix("tpl", suffix)
    np.testing.assert_allclose(lt.numpy(), full_t.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-4, rtol=2e-4)
    assert ct["length"] == int(cj["length"]) == Sp + Ss
    np.testing.assert_allclose(ct["kv_k"][:, :, :Sp + Ss].numpy(),
                               cache_t["kv_k"][:, :, :Sp + Ss].numpy(), atol=2e-5)
    np.testing.assert_allclose(ct["kv_k"][:, :, :Sp + Ss].numpy(),
                               np.asarray(cj["kv_k"][:, :, :Sp + Ss]), atol=2e-4)
    assert te.stats.prefix_tokens_reused - reused0 == B * Sp
    assert te.stats.prefill_tokens - pre0 == B * Ss
    assert te.stats.prefix_tokens_reused == je.stats.prefix_tokens_reused

    # generate() takes the same route through a CachePoint
    cp_t = tkv.plan_cache_point("tpl", tpl, toks)
    cp_j = jkv.plan_cache_point("tpl", tpl, toks)
    a = te.generate(toks, max_new=5)
    bt = te.generate(toks, max_new=5, cache_point=cp_t)
    bj = je.generate(toks, max_new=5, cache_point=cp_j)
    np.testing.assert_array_equal(bt, a)
    np.testing.assert_array_equal(bt, bj)
    assert te.stats.prefix_tokens_reused == je.stats.prefix_tokens_reused


def test_generate_registers_prefix_on_pool_miss(engines):
    je, te = engines
    tpl, _, toks = _prompts(1, 2, 16, 6)
    cp_t = tkv.plan_cache_point("fresh-tpl", tpl, toks)
    cp_j = jkv.plan_cache_point("fresh-tpl", tpl, toks)
    assert "fresh-tpl" not in te.kv_prefix
    reused0 = te.stats.prefix_tokens_reused
    pre0 = te.stats.prefill_tokens
    a = te.generate(toks, max_new=3, cache_point=cp_t)  # miss: registers
    aj = je.generate(toks, max_new=3, cache_point=cp_j)
    assert "fresh-tpl" in te.kv_prefix and te.kv_prefix.length_of("fresh-tpl") == 16
    assert te.stats.prefix_tokens_reused == reused0  # a miss reuses nothing
    assert te.stats.prefill_tokens - pre0 == toks.size
    b = te.generate(toks, max_new=3, cache_point=cp_t)  # hit: reuses
    bj = je.generate(toks, max_new=3, cache_point=cp_j)
    assert te.stats.prefix_tokens_reused - reused0 == 2 * 16
    assert te.stats.prefix_tokens_reused == je.stats.prefix_tokens_reused
    for x in (aj, b, bj):
        np.testing.assert_array_equal(a, x)


def test_prefix_length_mismatch_falls_back_and_reregisters(engines):
    """A pooled prefix whose length disagrees with the cache point is a
    miss: full prefill, and the prefix is registered again at the right
    length."""
    je, te = engines
    B, Sp = 2, 16
    tpl, _, toks = _prompts(2, B, Sp, 6)
    for eng, kvm in ((te, tkv), (je, jkv)):
        _, cache = eng.prefill(toks)
        assert eng.register_prefix("stale-tpl", cache, Sp - 4)
        assert eng.kv_prefix.length_of("stale-tpl") == Sp - 4
        assert eng.prefill_with_prefix("stale-tpl", toks[:, Sp:], expected_len=Sp) is None
        cp = kvm.plan_cache_point("stale-tpl", tpl, toks)
        reused0 = eng.stats.prefix_tokens_reused
        a = eng.generate(toks, max_new=4)
        b = eng.generate(toks, max_new=4, cache_point=cp)  # mismatch -> fallback
        np.testing.assert_array_equal(a, b)
        assert eng.stats.prefix_tokens_reused == reused0
        assert eng.kv_prefix.length_of("stale-tpl") == Sp  # re-registered


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_prefix_families_gate(arch):
    """A family that carries recurrent state (ssm: rwkv6-3b; hybrid:
    zamba2-2.7b) can't re-enter a stored prefix: the engine drops the
    kv_prefix wiring, as the reference's engine does, and
    ``prefill_extend`` refuses it with the reference's message."""
    cfg = registry.get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dense_cfg = registry.get_smoke("olmo-1b")
    kvc = tkv.KVPrefixCache(tkv.pool_for_config(dense_cfg, num_pages=4, page_size=8,
                                                device="cpu"))
    assert Engine(cfg, params, max_len=48, device="cpu", kv_prefix=kvc).kv_prefix is None
    jcfg = jregistry.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jkvc = jkv.KVPrefixCache(jkv.PagePool(2, 4, 8, 4, 32, dtype=jnp.float32))
    assert JEngine(jcfg, jparams, max_len=48, kv_prefix=jkvc).kv_prefix is None
    with pytest.raises(NotImplementedError) as want:
        jlm.prefill_extend(jcfg, jparams, {"tokens": jnp.zeros((1, 2), jnp.int32)},
                           None, None, 0)
    with pytest.raises(NotImplementedError) as got:
        lm.prefill_extend(cfg, params, torch.zeros(1, 2, dtype=torch.long), None, None, 0)
    assert str(got.value) == str(want.value)
    dense = Engine(dense_cfg, lm.init_params(dense_cfg, torch.Generator().manual_seed(0),
                                             "cpu"), max_len=48, device="cpu", kv_prefix=kvc)
    assert dense.kv_prefix is kvc


def test_pool_defaults_to_cuda():
    """The pool lives on an explicit device, CUDA unless the caller asks
    for another; without CUDA the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkv.pool_for_config(registry.get_smoke("olmo-1b"))
