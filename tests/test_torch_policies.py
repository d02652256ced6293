"""The port's eviction policies (``repro_torch.memory.policies``) driven
through its PlanCache, in lockstep with ``repro``'s PlanCache under an
injected clock: the same evicted and expired keys, answers, hits, misses and
evictions, and ``make_policy``'s errors."""

import random
import zlib

import pytest

pytest.importorskip("torch")

from repro.core.cache import PlanCache as JPlanCache  # noqa: E402
from repro.memory import policies as jpolicies  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.memory import policies  # noqa: E402


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Plan:
    """A value with the fields the cost-aware policy reads: ``uses`` (bumped
    on every hit, as ``apc`` bumps a template's) and ``size_tokens()``."""

    def __init__(self, size):
        self.size, self.uses = size, 0

    def size_tokens(self):
        return self.size


def _stats(c):
    s = c.stats
    return (s.hits, s.misses, s.inserts, s.evictions)


# (eviction, ttl_s): LFU and cost-aware alone, TTL over each inner policy,
# and the bare "ttl" name (TTL over LRU)
CASES = [("lfu", None), ("cost", None), ("lru", 6.0), ("lfu", 6.0), ("cost", 6.0),
         ("ttl", 6.0)]


@pytest.mark.parametrize("eviction,ttl_s", CASES)
@pytest.mark.parametrize("capacity", [0, 1, 6])
def test_policy_stream_matches_reference(eviction, ttl_s, capacity):
    """A seeded stream of inserts (single and waves, overwrites among
    them), lookups and clock steps over 14 keys: every lookup's answer, the
    sequence of removed keys (evictions and TTL expiries, via the delete
    listeners), the live key set and the counters stay equal."""
    rng = random.Random(zlib.crc32(repr((eviction, ttl_s, capacity)).encode()))
    clock, jclock = _Clock(), _Clock()
    t = PlanCache(capacity, eviction=eviction, ttl_s=ttl_s, clock=clock)
    j = JPlanCache(capacity, eviction=eviction, ttl_s=ttl_s, clock=jclock)
    gone, jgone = [], []
    t.add_evict_listener(gone.append)
    j.add_evict_listener(jgone.append)
    keys = [f"intent {i}" for i in range(14)]
    for step in range(500):
        r = rng.random()
        if r < 0.1:
            dt = rng.choice([0.5, 1.0, 3.0])
            clock.t += dt
            jclock.t += dt
        elif r < 0.4:
            wave = [(rng.choice(keys), _Plan(rng.randint(1, 400)))
                    for _ in range(rng.choice([1, 1, 2, 3]))]
            t.insert_batch(wave)
            j.insert_batch(wave)
        else:
            k = rng.choice(keys)
            got, want = t.lookup(k), j.lookup(k)
            assert got is want, step
            if got is not None:
                got.uses += 1
        assert gone == jgone, step
        assert sorted(t.keys()) == sorted(j.keys()), step
        assert _stats(t) == _stats(j), step
    assert len(t) <= capacity
    if capacity == 6:  # the stream reached every path of the policy
        assert t.stats.evictions > 0 and t.stats.hits > 0
        if ttl_s is not None:
            assert len(gone) > t.stats.evictions  # some keys expired


def test_capacity_zero_matches_reference():
    """A capacity-0 store admits nothing: each insert is evicted at once
    (the deep-research agent's no-cache arm)."""
    t, j = PlanCache(0), JPlanCache(0)
    for c in (t, j):
        c.insert("a", 1)
    assert t.lookup("a") is None and j.lookup("a") is None
    assert (len(t), t.stats.evictions) == (len(j), j.stats.evictions) == (0, 1)


def test_policy_objects_match_reference():
    """make_policy composes the same policies: TTL wraps any inner policy,
    a policy instance passes through, and the scores agree."""
    for spec in ("lru", "lfu", "cost"):
        for ttl in (None, 2.0):
            p, jp = policies.make_policy(spec, ttl_s=ttl), jpolicies.make_policy(spec, ttl_s=ttl)
            assert type(p).__name__ == type(jp).__name__ and p.name == jp.name
            if ttl is not None:
                assert type(p.inner).__name__ == type(jp.inner).__name__
                assert p.ttl_s == jp.ttl_s == 2.0
    inst = policies.LFUPolicy()
    assert policies.make_policy(inst) is inst
    assert isinstance(policies.make_policy(policies.TTLPolicy(3.0), ttl_s=9.0), policies.TTLPolicy)
    e = policies.CacheEntry(_Plan(50), 0.0, hits=2)
    je = jpolicies.CacheEntry(e.value, 0.0, hits=2)
    e.value.uses = 3
    assert policies.CostAwarePolicy.score(e) == jpolicies.CostAwarePolicy.score(je) == 300.0
    assert policies.CostAwarePolicy.score(policies.CacheEntry("plain", 0.0)) == 1.0
    ttl = policies.TTLPolicy(5.0)
    assert not ttl.expired("k", e, 5.0) and ttl.expired("k", e, 5.01)
    assert sorted(policies.EVICTION_POLICIES) == sorted(jpolicies.EVICTION_POLICIES)


@pytest.mark.parametrize("spec,ttl_s", [("mru", None), ("ttl", None), ("random", 3.0)])
def test_make_policy_errors_match_reference(spec, ttl_s):
    with pytest.raises(ValueError) as got:
        policies.make_policy(spec, ttl_s=ttl_s)
    with pytest.raises(ValueError) as want:
        jpolicies.make_policy(spec, ttl_s=ttl_s)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="eviction policy|requires ttl_s"):
        PlanCache(4, eviction=spec, ttl_s=ttl_s)
