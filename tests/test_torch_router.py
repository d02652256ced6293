"""The port's two-tier router (``repro_torch.serving.router``) against
``repro.serving.router``: the TierPool and router tests of
tests/test_serving.py, the plan-cache / prefix-pool coupling tests of
tests/test_kv_cache.py, and seeded keyword streams pushed through both
routers (hits, misses, tier calls and cache contents after every wave must
be equal), including the stream ``chip_smoke.py`` routes on the card."""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.cache import PlanCache as JPlanCache  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.router import TwoTierRouter as JRouter  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.router import TierPool, TwoTierRouter  # noqa: E402

torch.set_num_threads(2)


def _pool():
    return tkv.PagePool(2, 16, 4, 2, 8, dtype=torch.float32, device="cpu")


def _kv(S=8):
    return torch.arange(2 * S * 2 * 8, dtype=torch.float32).reshape(2, S, 2, 8)


def _callbacks():
    return dict(
        extract_keyword=lambda req: req["kw"],
        plan_large=lambda req: {"plan": "fresh", "kw": req["kw"]},
        plan_small_with_template=lambda req, tpl: {"plan": "adapted", "tpl": tpl},
        make_template=lambda req, res: {"tpl_for": req["kw"]},
    )


# -- tier pools ----------------------------------------------------------------


def test_tier_pool_round_robin_visits_every_replica():
    pool = TierPool("small", replicas=["r0", "r1", "r2"])
    assert [pool.pick() for _ in range(6)] == ["r0", "r1", "r2", "r0", "r1", "r2"]


def test_tier_pool_hedged_dispatch_reuses_one_executor():
    pool = TierPool("large", replicas=["a", "b"])
    assert pool.dispatch(lambda e: e, hedge=True) in ("a", "b")
    ex = pool._executor
    assert ex is not None
    assert pool.dispatch(lambda e: e, hedge=True) in ("a", "b")
    assert pool._executor is ex  # one pool per TierPool, not per call
    pool.close()
    assert pool._executor is None


def test_tier_pool_hedged_failover_serves_surviving_replica():
    def flaky(eng):
        if eng == "bad":
            raise TimeoutError("engine timed out")
        return f"served-by-{eng}"

    pool = TierPool("large", replicas=["bad", "good"])
    for _ in range(4):  # every rotation parity: failover always saves it
        assert pool.dispatch(flaky, hedge=True) == "served-by-good"
    pool.close()
    ablated = TierPool("large", replicas=["bad", "good"], hedge_failover=False)
    with pytest.raises(TimeoutError):
        ablated.dispatch(flaky, hedge=True)  # picks replica 0 ("bad")
    ablated.close()


def test_tier_pool_hedged_raises_only_when_all_replicas_fail():
    def always_bad(eng):
        raise RuntimeError(f"{eng} down")

    pool = TierPool("large", replicas=["a", "b"])
    with pytest.raises(RuntimeError, match="down"):
        pool.dispatch(always_bad, hedge=True)
    pool.close()


def test_tier_pool_hedged_times_out_on_hung_replicas():
    release = threading.Event()

    def hung(eng):
        assert release.wait(timeout=30)
        return eng

    pool = TierPool("large", replicas=["a", "b"], hedge_timeout_s=0.05)
    try:
        with pytest.raises(TimeoutError, match="every replica"):
            pool.dispatch(hung, hedge=True)
    finally:
        release.set()
        pool.close()


def test_tier_pool_unhedged_skips_executor():
    pool = TierPool("actor", replicas=["only"])
    assert pool.dispatch(lambda e: e, hedge=True) == "only"  # <2 replicas
    assert pool._executor is None
    pool.close()


# -- two-tier router ------------------------------------------------------------


def test_router_routes_by_cache_and_async_cachegen():
    cache = PlanCache(capacity=10)
    calls = {"large": 0, "small": 0}

    def large(req):
        calls["large"] += 1
        return {"plan": "fresh"}

    def small(req, tpl):
        calls["small"] += 1
        return {"plan": "adapted", "tpl": tpl}

    router = TwoTierRouter(cache, extract_keyword=lambda req: req["kw"], plan_large=large,
                           plan_small_with_template=small,
                           make_template=lambda req, res: {"tpl_for": req["kw"]},
                           async_cachegen=True)
    assert router.route({"kw": "mean calculation"})["plan"] == "fresh" and calls["large"] == 1
    router.drain()  # the async insert lands
    assert router.route({"kw": "mean calculation"})["plan"] == "adapted"
    assert calls["small"] == 1
    m = router.metrics.snapshot()
    assert m["hit_rate"] == 0.5 and m["async_cachegens"] == 1 and m["requests"] == 2
    jrouter = JRouter(JPlanCache(capacity=1), async_cachegen=False, **_callbacks())
    assert set(m) == set(jrouter.metrics.snapshot())  # the reference's schema
    router.close()


def test_router_route_batch_single_lookup_pass():
    """route_batch answers the whole batch with one lookup_batch pass;
    fuzzy near-keywords resolve against the cache's index (brute here: the
    port has no ``auto`` backend)."""
    cache = PlanCache(capacity=10, fuzzy=True, fuzzy_threshold=0.7, index_backend="brute")
    cache.insert("working capital ratio", {"tpl_for": "working capital ratio"})
    seen = []
    real = cache.lookup_batch
    cache.lookup_batch = lambda kws, **kw: seen.append(list(kws)) or real(kws, **kw)
    router = TwoTierRouter(cache, async_cachegen=False, **_callbacks())
    out = router.route_batch([
        {"kw": "working capital ratio"},           # exact hit
        {"kw": "working capital ratio analysis"},  # fuzzy hit
        {"kw": "quantum chromodynamics"},          # miss -> large tier
    ])
    assert [o["plan"] for o in out] == ["adapted", "adapted", "fresh"]
    assert len(seen) == 1 and len(seen[0]) == 3
    m = router.metrics.snapshot()
    assert m["requests"] == 3
    assert m["small_tier_calls"] == 2 and m["large_tier_calls"] == 1
    # the miss distilled its template into the cache synchronously
    assert router.route({"kw": "quantum chromodynamics"})["plan"] == "adapted"
    router.close()


def test_router_async_does_not_block():
    cache = PlanCache(capacity=10)
    release = threading.Event()
    slow = {"done": False}

    def make_template(req, res):
        assert release.wait(timeout=30)
        slow["done"] = True
        return {"t": 1}

    router = TwoTierRouter(cache, extract_keyword=lambda r: "k", plan_large=lambda r: "res",
                           plan_small_with_template=lambda r, t: "hit",
                           make_template=make_template, async_cachegen=True)
    assert router.route({}) == "res"
    assert not slow["done"]  # the response returned; cachegen is still gated
    release.set()
    router.close()  # drains the pending cachegen
    assert slow["done"]


def test_router_saturated_pool_falls_back_to_sync():
    """A rejected submission (the pool shut down) runs the wave on the
    request thread: slower, never lost."""
    cache = PlanCache(capacity=10)
    router = TwoTierRouter(cache, async_cachegen=True, **_callbacks())
    router._pool.shutdown(wait=True)
    router.route_batch([{"kw": "a"}, {"kw": "b"}])
    router.route({"kw": "c"})
    assert sorted(cache.keys()) == ["a", "b", "c"]
    m = router.metrics.snapshot()
    assert m["sync_cachegen_fallbacks"] == 3 and m["async_cachegens"] == 0


def test_router_wave_errors_are_deferred_to_drain():
    """A failing make_template loses only its own template: the rest of the
    wave lands, the responses are served, and drain() raises the error."""
    cache = PlanCache(capacity=10)

    def make_template(req, res):
        if req["kw"] == "bad":
            raise ValueError("no template")
        return {"tpl_for": req["kw"]}

    cb = dict(_callbacks(), make_template=make_template)
    router = TwoTierRouter(cache, async_cachegen=False, **cb)
    with pytest.warns(UserWarning, match="deferred to drain"):
        out = router.route_batch([{"kw": "good"}, {"kw": "bad"}])
    assert [o["plan"] for o in out] == ["fresh", "fresh"]
    assert cache.keys() == ["good"]
    with pytest.raises(ValueError, match="no template"):
        router.drain()
    router.drain()  # raised once
    asy = TwoTierRouter(PlanCache(capacity=10), async_cachegen=True, **cb)
    asy.route_batch([{"kw": "bad"}])
    with pytest.raises(ValueError, match="no template"):
        asy.drain()
    asy.close()


def test_router_admission_skips_entries_written_since_the_lookup():
    """The wave inserts unless the key was (re)written after the lookup's
    clock read: a client write during the large-tier call wins."""
    cache = PlanCache(capacity=10)

    def large(req):
        cache.insert(req["kw"], {"tpl_for": "client"})
        return {"plan": "fresh"}

    router = TwoTierRouter(cache, async_cachegen=False, **dict(_callbacks(), plan_large=large))
    router.route_batch([{"kw": "x"}])
    assert cache.lookup("x") == {"tpl_for": "client"}
    assert cache.stats.stale_insert_skips == 1


def test_concurrent_route_batch_with_async_cachegen_conserves_counts():
    """Request threads and cachegen workers bump the same counters: none is
    lost (more threads than cores, a short switch interval)."""
    import sys

    cache = PlanCache(capacity=1000)
    router = TwoTierRouter(cache, async_cachegen=True, **_callbacks())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(t):
            for i in range(40):
                router.route_batch([{"kw": f"k{t}-{i}"}, {"kw": f"k{t}-{i % 5}"}])

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    router.close()
    m = router.metrics
    assert m.requests == 12 * 40 * 2
    assert m.hits + m.misses == m.requests
    assert m.async_cachegens + m.sync_cachegen_fallbacks == m.misses
    assert m.large_tier_calls == m.misses and m.small_tier_calls == m.hits


# -- plan-cache / prefix-pool coupling ---------------------------------------------


def test_plan_cache_eviction_frees_prefix_pages():
    pool = _pool()
    kv = tkv.KVPrefixCache(pool)
    cache = PlanCache(capacity=2)
    TwoTierRouter(cache, async_cachegen=False, kv_prefix=kv, **_callbacks())
    for kw in ("a", "b"):
        cache.insert(kw, {"t": kw})
        kv.put(kw, _kv(), _kv())
    cache.insert("c", {"t": "c"})  # LRU-evicts "a" from the plan cache
    assert "a" not in kv and "b" in kv  # pages freed with the template
    assert cache.stats.evictions == 1
    cache.remove("b")
    assert "b" not in kv
    cache.clear()
    assert len(kv) == 0 and pool.free_pages == 16


def test_insert_overwrite_fires_evict_listeners_and_frees_prefix():
    pool = _pool()
    kv = tkv.KVPrefixCache(pool)
    cache = PlanCache(capacity=4)
    cache.add_evict_listener(kv.release)
    seen = []
    cache.add_evict_listener(seen.append)
    cache.insert("a", {"t": 1})
    kv.put("a", _kv(), _kv())
    cache.insert("a", {"t": 2})  # regenerated plan, same keyword
    assert seen == ["a"]
    assert "a" not in kv and pool.free_pages == 16
    assert cache.lookup("a") == {"t": 2}
    assert cache.stats.evictions == 0  # a replace is not an eviction


def test_router_kv_prefix_requires_evict_listener():
    class Bare:
        def lookup(self, kw):
            return None

    with pytest.raises(TypeError, match="add_evict_listener"):
        TwoTierRouter(Bare(), kv_prefix=tkv.KVPrefixCache(_pool()), **_callbacks())


# -- seeded streams against the reference router ---------------------------------


def _run_both(waves, capacity, *, kv=False):
    """Push the same waves of keywords through both routers (sync
    cachegen); after every wave the outcomes, metrics and cache contents
    must agree. With ``kv`` each side also owns a prefix pool whose entries
    follow its plan cache. Returns the port's router."""
    routers = {}
    for side, Cache, Router, kvm in (("j", JPlanCache, JRouter, jkv),
                                     ("t", PlanCache, TwoTierRouter, tkv)):
        prefix = None
        if kv:
            pool = (kvm.PagePool(2, 64, 4, 2, 8, dtype=jnp.float32) if side == "j"
                    else kvm.PagePool(2, 64, 4, 2, 8, dtype=torch.float32, device="cpu"))
            prefix = kvm.KVPrefixCache(pool)
        cache = Cache(capacity=capacity)
        cb = _callbacks()
        if kv:
            data = (jnp.zeros((2, 6, 2, 8), jnp.float32) if side == "j"
                    else torch.zeros(2, 6, 2, 8))

            def small(req, tpl, prefix=prefix, data=data):
                if tpl["tpl_for"] not in prefix:
                    prefix.put(tpl["tpl_for"], data, data)
                return {"plan": "adapted", "tpl": tpl}

            cb["plan_small_with_template"] = small
        routers[side] = Router(cache, async_cachegen=False, kv_prefix=prefix, **cb)
    for wave in waves:
        reqs = [{"kw": kw} for kw in wave]
        outs = {s: r.route_batch(reqs) for s, r in routers.items()}
        assert outs["t"] == outs["j"]
        jm, tm = routers["j"].metrics, routers["t"].metrics
        for f in ("requests", "hits", "misses", "large_tier_calls", "small_tier_calls"):
            assert getattr(tm, f) == getattr(jm, f), f
        assert routers["t"].cache.keys() == list(routers["j"].cache._store)
        if kv:
            held = routers["t"].kv_prefix.keys()
            assert held == list(routers["j"].kv_prefix._entries)
            assert set(held) <= set(routers["t"].cache.keys())
    for r in routers.values():
        r.close()
    return routers["t"]


def test_seeded_keyword_stream_matches_reference():
    rs = np.random.RandomState(0)
    names = [f"intent {i}" for i in range(10)]
    p = 1.0 / np.arange(1, 11)
    stream = list(rs.choice(names, size=60, p=p / p.sum()))
    waves = [stream[i:i + 5] for i in range(0, 60, 5)]
    r = _run_both(waves, capacity=4, kv=True)
    assert r.metrics.hits > 0 and r.metrics.misses > 0
    assert r.kv_prefix.prefix_evictions > 0  # plan-cache evictions freed pages


def test_chip_smoke_router_stream_matches_reference():
    """The waves chip_smoke.py routes on the card, and the hits and misses
    it pins, are the reference router's on the same keyword stream."""
    import chip_smoke
    from repro.envs.workloads import get_env as jget_env
    from repro_torch.envs.workloads import get_env

    jtasks = jget_env("financebench").generate(chip_smoke.N_TASKS, seed=0)
    ttasks = get_env("financebench").generate(chip_smoke.N_TASKS, seed=0)
    assert [t.intent.keyword for t in ttasks] == [t.intent.keyword for t in jtasks]
    waves = [[t.intent.keyword for t in w] for w in chip_smoke.router_waves(ttasks)]
    r = _run_both(waves, capacity=chip_smoke.ROUTER_CAPACITY, kv=True)
    assert (r.metrics.hits, r.metrics.misses) == chip_smoke.ROUTER_EXPECT


# -- the simulation's seams: clock, an injected pool, cachegen_fallback --------


class QueuePool:
    """A cachegen pool the caller drives (the simulation's kind): ``submit``
    queues the task and returns a future, or raises while ``reject`` > 0;
    ``run`` runs the queued tasks. ``shutdown`` is recorded: a router must
    not shut down a pool it was given."""

    def __init__(self):
        self.queued, self.reject, self.shut = [], 0, False

    def submit(self, fn):
        if self.reject > 0:
            self.reject -= 1
            raise RuntimeError("pool saturated")
        import concurrent.futures as cf

        fut = cf.Future()
        self.queued.append((fn, fut))
        return fut

    def run(self):
        queued, self.queued = self.queued, []
        for fn, fut in queued:
            fut.set_result(fn())

    def shutdown(self, wait=True):
        self.shut = True


@pytest.mark.parametrize("fallback", [True, False])
def test_injected_pool_clock_and_fallback_match_reference(fallback):
    """``clock=``, ``cachegen_pool=`` and ``cachegen_fallback=`` on a seeded
    stream of route_batch waves in both routers: the pool rejects some
    submissions and runs the queued ones every third wave. With the
    fallback a rejected wave is generated on the request thread; without
    it, it is dropped (``cachegen_dropped``) and its keys never land. The
    metrics, the lookup times read from the virtual clock among them, and
    the cache contents equal the reference's after every wave; ``close()``
    leaves the injected pool running."""
    rs = np.random.RandomState(3)
    names = [f"intent {i}" for i in range(12)]
    waves = [list(rs.choice(names, size=4)) for _ in range(24)]
    routers, pools = {}, {}
    for side, Cache, Router in (("j", JPlanCache, JRouter), ("t", PlanCache, TwoTierRouter)):
        ticks = iter(range(10**6))
        pools[side] = QueuePool()
        routers[side] = Router(Cache(capacity=6), async_cachegen=True,
                               cachegen_pool=pools[side], cachegen_fallback=fallback,
                               clock=lambda ticks=ticks: 0.25 * next(ticks), **_callbacks())
    for n, wave in enumerate(waves):
        for side in routers:
            pools[side].reject = 2 if n % 5 == 1 else 0
        outs = {s: r.route_batch([{"kw": kw} for kw in wave]) for s, r in routers.items()}
        assert outs["t"] == outs["j"]
        if n % 3 == 2:
            for p in pools.values():
                p.run()
        assert routers["t"].metrics.snapshot() == routers["j"].metrics.snapshot()
        assert routers["t"].cache.keys() == list(routers["j"].cache._store)
    m = routers["t"].metrics
    assert m.lookup_s == 0.25 * len(waves)  # one virtual tick a lookup
    assert m.sync_cachegen_fallbacks > 0 if fallback else m.cachegen_dropped > 0
    assert (m.cachegen_dropped == 0) == fallback
    for side, r in routers.items():
        pools[side].run()
        r.close()
        assert not pools[side].shut


def test_store_without_now_admits_unconditionally():
    """A store without ``now()`` gets no conditional-admission token: its
    inserts take no ``unless_written_since``, in both routers."""
    class Legacy:
        def __init__(self):
            self.data = {}

        def lookup(self, kw):
            return self.data.get(kw)

        def lookup_batch(self, kws):
            return [self.data.get(k) for k in kws]

        def insert(self, kw, v):
            self.data[kw] = v

        def insert_batch(self, items):
            self.data.update(items)

    seen = {}
    for side, Router in (("j", JRouter), ("t", TwoTierRouter)):
        r = Router(Legacy(), async_cachegen=False, **_callbacks())
        assert r._read_token() is None
        out = r.route_batch([{"kw": "a"}, {"kw": "b"}]) + [r.route({"kw": "c"}),
                                                           r.route({"kw": "a"})]
        seen[side] = (out, r.cache.data, r.metrics.snapshot()["requests"])
        r.close()
    assert seen["t"] == seen["j"]
