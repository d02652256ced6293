"""Two-tier serving router — the APC cache as a routing policy (the port of
``repro.serving.router``).

A cache hit routes the planning request to the cheap tier (small planner)
and skips the expensive tier; a miss goes to the large planner, and the
completed execution is distilled into the plan cache, optionally on a
worker pool so cache generation never blocks the response path.

The plan cache is any plan store: a local ``PlanCache`` or a
``DistributedPlanCache`` (consistent-hash sharded, replicated).
``route_batch`` admits a whole arrival wave through one ``lookup_batch``
pass and distills the wave's misses back through one ``insert_batch``,
conditional on the store clock read before the lookup
(``unless_written_since``), so a slow distillation never clobbers an entry
written after that read.

With ``spec_verify``, a fuzzy/semantic near hit is served at once (the
adapted template is the speculative execution) while
``spec_verify(request, matched_key)`` re-derives the plan on the cachegen
pool, or inline without one: agreement commits the journaled effects (the
near match admitted under the precise keyword, with the lookup's token, and
the ``spec_commits`` bump), disagreement rolls them back.

With ``kv_prefix`` (a ``serving.kv_cache.KVPrefixCache``), the prefix pool's
lifecycle is slaved to the plan cache: the router registers
``kv_prefix.release`` as an eviction listener, so a template's pages are
freed when the template leaves the plan cache.

Observability: ``RouterMetrics`` is a view over a
:class:`repro_torch.obs.MetricsRegistry` (the cache's own by default, so one
snapshot covers router, store and index). Under a tracer every
``route``/``route_batch`` opens a span tree — router, cache lookup, shard
and replica tier, match stage, index, engines — with one
``cache.attribution`` event a request and a ``cachegen.fate`` event a wave.
Pool threads start with an empty span context, so cache generation and
verification capture the tracer and parent span at submit time.

Thread-safety: the router's lock guards the pending futures, the deferred
errors and the speculator; the metrics are lock-safe registry counters,
since request threads and workers bump the same series. The plan cache
serializes itself.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.speculative import PlanSpeculator
from repro_torch.obs import (
    MetricsRegistry,
    collect,
    current_span,
    get_tracer,
    tokens_saved_estimate,
    trace_span,
)
from repro_torch.obs import names as _names


@dataclass
class TierPool:
    """A pool of interchangeable engine replicas for one role."""

    name: str
    replicas: List[Any] = field(default_factory=list)
    _rr: int = 0
    hedge_timeout_s: float = 30.0
    # hedged failover: a hedged dispatch serves the first SUCCESSFUL
    # replica and only raises when every replica failed. False sends the
    # dispatch to a single replica and lets its failure propagate.
    hedge_failover: bool = True
    _executor: Optional[cf.ThreadPoolExecutor] = field(
        default=None, repr=False, compare=False
    )
    _executor_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def pick(self) -> Any:
        # return-then-increment: the rotation starts at replica 0 and visits
        # every replica; locked so concurrent dispatches don't share a pick
        with self._executor_lock:
            eng = self.replicas[self._rr % len(self.replicas)]
            self._rr = (self._rr + 1) % len(self.replicas)
        return eng

    def dispatch(self, fn: Callable[[Any], Any], *, hedge: bool = False) -> Any:
        """Run fn(engine); optionally hedge onto a second replica.

        Hedged calls share ONE executor per pool (created at first use).
        The winner is the first replica to SUCCEED (completion order)."""
        if not hedge or len(self.replicas) < 2 or not self.hedge_failover:
            return fn(self.pick())
        if self._executor is None:
            # sized above 2: a hedge loser that is already running cannot be
            # cancelled and holds its worker until it finishes
            with self._executor_lock:
                if self._executor is None:
                    self._executor = cf.ThreadPoolExecutor(
                        max_workers=max(4, 2 * len(self.replicas)),
                        thread_name_prefix=f"tier-{self.name}",
                    )
        futs = [self._executor.submit(fn, self.pick()) for _ in range(2)]
        last_err: Optional[BaseException] = None
        try:
            for f in cf.as_completed(futs, timeout=self.hedge_timeout_s):
                try:
                    result = f.result()
                except Exception as e:  # noqa: BLE001 - replica failure
                    last_err = e
                    continue
                for other in futs:
                    if other is not f:
                        other.cancel()
                return result
        except cf.TimeoutError as e:
            # cancel what has not started, so a hung replica can't pin every
            # worker of the pool
            for f in futs:
                f.cancel()
            last_err = TimeoutError(
                f"hedged dispatch on pool {self.name!r} exceeded "
                f"{self.hedge_timeout_s}s on every replica"
            )
            last_err.__cause__ = e
        if last_err is None:
            raise RuntimeError(f"hedged dispatch on pool {self.name!r} returned nothing")
        raise last_err

    def close(self) -> None:
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None


def _metric_prop(field: str):
    def get(self):
        v = self._c[field].value
        return v if field == "lookup_s" else int(v)

    return property(get)


class RouterMetrics:
    """Router accounting as a view over a :class:`repro_torch.obs.MetricsRegistry`,
    with the reference's field reads and ``snapshot()``. Every counter is a
    lock-safe registry counter (request threads and cache-generation workers
    bump the same series); writers go through :meth:`add`.
    ``lookup_latency`` is the bucketed histogram of lookup times."""

    _FIELDS = {
        "requests": _names.ROUTER_REQUESTS,
        "hits": _names.ROUTER_HITS,
        "misses": _names.ROUTER_MISSES,
        "large_tier_calls": _names.ROUTER_LARGE_TIER_CALLS,
        "small_tier_calls": _names.ROUTER_SMALL_TIER_CALLS,
        "async_cachegens": _names.ROUTER_ASYNC_CACHEGENS,
        "sync_cachegen_fallbacks": _names.ROUTER_SYNC_CACHEGEN_FALLBACKS,
        "cachegen_dropped": _names.ROUTER_CACHEGEN_DROPPED,
        "lookup_s": _names.ROUTER_LOOKUP_S,
        "tokens_saved": _names.ROUTER_TOKENS_SAVED,
        "speculations": _names.ROUTER_SPECULATIONS,
        "spec_commits": _names.ROUTER_SPEC_COMMITS,
        "spec_rollbacks": _names.ROUTER_SPEC_ROLLBACKS,
        "spec_sync_verifies": _names.ROUTER_SPEC_SYNC_VERIFIES,
        "spec_dropped": _names.ROUTER_SPEC_DROPPED,
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 **labels: str):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._c = {
            field: self.registry.counter(name, **labels)
            for field, name in self._FIELDS.items()
        }
        self.lookup_latency = self.registry.histogram(
            _names.ROUTER_LOOKUP_LATENCY, **labels
        )

    requests = _metric_prop("requests")
    hits = _metric_prop("hits")
    misses = _metric_prop("misses")
    large_tier_calls = _metric_prop("large_tier_calls")
    small_tier_calls = _metric_prop("small_tier_calls")
    async_cachegens = _metric_prop("async_cachegens")
    sync_cachegen_fallbacks = _metric_prop("sync_cachegen_fallbacks")
    cachegen_dropped = _metric_prop("cachegen_dropped")
    lookup_s = _metric_prop("lookup_s")
    tokens_saved = _metric_prop("tokens_saved")
    speculations = _metric_prop("speculations")
    spec_commits = _metric_prop("spec_commits")
    spec_rollbacks = _metric_prop("spec_rollbacks")
    spec_sync_verifies = _metric_prop("spec_sync_verifies")
    spec_dropped = _metric_prop("spec_dropped")

    def add(self, field: str, n: float = 1) -> None:
        """Lock-safe increment — callable from any thread."""
        self._c[field].inc(n)

    def observe_lookup(self, dt: float) -> None:
        self._c["lookup_s"].inc(dt)
        self.lookup_latency.observe(dt)

    def reset(self) -> None:
        for c in self._c.values():
            c.reset()
        self.lookup_latency.reset()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "hit_rate": self.hits / max(1, self.hits + self.misses),
            "large_tier_calls": self.large_tier_calls,
            "small_tier_calls": self.small_tier_calls,
            "async_cachegens": self.async_cachegens,
            "sync_cachegen_fallbacks": self.sync_cachegen_fallbacks,
            "cachegen_dropped": self.cachegen_dropped,
            "lookup_s": round(self.lookup_s, 6),
            "tokens_saved": self.tokens_saved,
            "speculations": self.speculations,
            "spec_commits": self.spec_commits,
            "spec_rollbacks": self.spec_rollbacks,
            "spec_sync_verifies": self.spec_sync_verifies,
            "spec_dropped": self.spec_dropped,
            "lookup_latency": self.lookup_latency.snapshot(),
        }


class TwoTierRouter:
    """keyword -> cache -> tier selection.

    ``obs`` is the registry of ``metrics`` (the cache's own by default).
    ``spec_verify(request, matched_key) -> bool`` turns on near-hit
    speculation; ``spec_effect(request, kw)`` applies an eager env effect
    and returns its compensation. ``spec_rollback=False`` commits a
    disagreeing speculation anyway, and ``spec_verify_fallback=False`` drops
    a verification the pool rejects (counted in ``spec_dropped``) instead of
    running it on the request thread.
    """

    def __init__(
        self,
        cache,  # PlanCache | DistributedPlanCache
        *,
        extract_keyword: Callable[[Any], str],
        plan_large: Callable[[Any], Any],
        plan_small_with_template: Callable[[Any, Any], Any],
        make_template: Callable[[Any, Any], Any],
        async_cachegen: bool = True,
        cachegen_workers: int = 2,
        obs: Optional[MetricsRegistry] = None,
        kv_prefix: Optional[Any] = None,
        spec_verify: Optional[Callable[[Any, Optional[str]], bool]] = None,
        spec_effect: Optional[Callable[[Any, str], Callable[[], None]]] = None,
        spec_rollback: bool = True,
        spec_verify_fallback: bool = True,
    ):
        self.cache = cache
        # the paged KV prefix pool: when a template leaves the plan cache,
        # its prefix pages are released with it, so the pool never serves KV
        # for a plan the router no longer routes to
        self.kv_prefix = kv_prefix
        if kv_prefix is not None:
            add = getattr(cache, "add_evict_listener", None)
            if add is None:
                raise TypeError(
                    "kv_prefix requires a cache with add_evict_listener "
                    "(plan-cache eviction must free the prefix pages)"
                )
            add(kv_prefix.release)
        self.extract_keyword = extract_keyword
        self.plan_large = plan_large
        self.plan_small_with_template = plan_small_with_template
        self.make_template = make_template
        if obs is None:
            obs = getattr(cache, "obs", None)
        self.metrics = RouterMetrics(obs)
        self._pool: Optional[cf.ThreadPoolExecutor] = (
            cf.ThreadPoolExecutor(max_workers=cachegen_workers) if async_cachegen else None
        )
        self._pending: List[cf.Future] = []
        self._sync_cachegen_errors: List[BaseException] = []
        self._lock = threading.Lock()
        self.spec_verify = spec_verify
        self._spec_effect = spec_effect
        self.spec_rollback = spec_rollback
        self.spec_verify_fallback = spec_verify_fallback
        self.speculator: Optional[PlanSpeculator] = (
            PlanSpeculator(rollback_enabled=spec_rollback) if spec_verify is not None else None
        )

    def route(self, request: Any) -> Any:
        self.metrics.add("requests")
        kw = self.extract_keyword(request)
        with trace_span(_names.SPAN_ROUTE) as sp:
            token = self.cache.now()
            t0 = time.perf_counter()
            with collect() as attrib, trace_span(_names.SPAN_ROUTER_LOOKUP, n=1):
                tpl = self.cache.lookup(kw)
            self.metrics.observe_lookup(time.perf_counter() - t0)
            self._attribution_event(sp, 0, tpl, attrib)
            return self._dispatch(request, kw, tpl, token)

    def route_batch(self, requests: List[Any]) -> List[Any]:
        """Admit a whole batch of requests through one cache pass.

        All keywords are answered by a single ``lookup_batch`` (with the
        attribution collector open: the resolving layers deposit stage,
        matched key, node and replica tier a request), then each request
        takes its hit/miss tier dispatch, and a near hit opens a
        speculation when ``spec_verify`` is set. The misses' distilled
        templates land back in the cache as one admission wave
        (``insert_batch``) instead of one insert per miss.
        """
        self.metrics.add("requests", len(requests))
        kws = [self.extract_keyword(r) for r in requests]
        with trace_span(_names.SPAN_ROUTE_BATCH, batch=len(requests)) as bsp:
            token = self.cache.now()
            t0 = time.perf_counter()
            with collect() as attrib, trace_span(_names.SPAN_ROUTER_LOOKUP, n=len(kws)):
                tpls = self.cache.lookup_batch(kws)
            self.metrics.observe_lookup(time.perf_counter() - t0)

            out: List[Any] = []
            wave: List[tuple] = []  # (request, kw, large-tier result) misses
            for i, (r, kw, tpl) in enumerate(zip(requests, kws, tpls)):
                stage = attrib.get(i).get("stage", "exact")
                speculate = tpl is not None and self.speculator is not None and stage != "exact"
                self._attribution_event(bsp, i, tpl, attrib, speculative=speculate)
                if tpl is not None:
                    out.append(self._serve_hit(r, tpl))
                    if speculate:
                        self._begin_speculation(r, kw, tpl, token,
                                                attrib.get(i).get("matched_key"))
                else:
                    result = self._serve_miss(r)
                    out.append(result)
                    wave.append((r, kw, result))
            bsp.set(hits=len(requests) - len(wave))

            if wave:
                def gen_and_insert_wave():
                    # per-request failure isolation: one bad make_template
                    # must not discard the rest of the wave's templates; the
                    # first error still surfaces through drain()
                    items, first_err = [], None
                    for r, kw, result in wave:
                        try:
                            template = self.make_template(r, result)
                        except Exception as e:
                            first_err = first_err or e
                            continue
                        if template is not None:
                            items.append((kw, template))
                    if items:
                        # insert-if-newer: an entry (re)written since the
                        # lookup wins over the possibly slow distillation
                        self.cache.insert_batch(items, unless_written_since=token)
                    if first_err is not None:
                        raise first_err
                    return items

                gen = self._traced_cachegen(gen_and_insert_wave, len(wave))
                if self._pool is None or not self._submit_cachegen(gen, len(wave)):
                    # sync mode (or the saturated-pool fallback): the batch's
                    # plans are already served, so a wave error is deferred
                    # to drain()/close(); warn so a caller that never drains
                    # still sees it
                    try:
                        gen()
                    except Exception as e:
                        warnings.warn(
                            f"cache generation failed for an admission wave "
                            f"(deferred to drain()): {e!r}"
                        )
                        with self._lock:
                            if len(self._sync_cachegen_errors) < 16:
                                self._sync_cachegen_errors.append(e)
            return out

    def _begin_speculation(self, request: Any, kw: str, tpl: Any, token: float,
                           matched_key: Optional[str]) -> None:
        """Open a near-hit speculation and race its verification.

        The served response is already on its way; the journal holds what a
        wrong speculation must take back: the optional eager env effect, and
        the deferred admission of the near match under the precise keyword
        with the lookup-time ``unless_written_since`` token, so a commit
        never clobbers an entry (re)written while the verifier ran. The
        verification rides the cachegen pool (inline without one)."""
        speculator = self.speculator

        def admit() -> None:
            self.cache.insert(kw, tpl, unless_written_since=token)

        def bump_commit() -> None:
            self.metrics.add("spec_commits")

        effect = None
        if self._spec_effect is not None:
            spec_effect = self._spec_effect
            effect = lambda: spec_effect(request, kw)  # noqa: E731
        # begin/resolve share the router lock: pool workers resolve while
        # request threads begin the next speculation
        with self._lock:
            spec_id = speculator.begin(kw, effect=effect, on_commit=(admit, bump_commit))
        self.metrics.add("speculations")
        verify = self._traced_spec_verify(request, kw, spec_id, matched_key)
        if self._pool is None:
            verify()
            return
        try:
            fut = self._pool.submit(verify)
        except RuntimeError:
            if not self.spec_verify_fallback:
                # the rejected verification is dropped: the speculation
                # stays pending
                self.metrics.add("spec_dropped")
                current_span().event(_names.EVENT_SPEC_FATE, fate="dropped", kw=kw)
                return
            # a rejected submission verifies on the request thread
            self.metrics.add("spec_sync_verifies")
            verify()
            return
        with self._lock:
            self._pending.append(fut)

    def _traced_spec_verify(self, request: Any, kw: str, spec_id: int,
                            matched_key: Optional[str]) -> Callable[[], str]:
        """A speculation's verification in a ``router.spec_verify`` span
        (tracer and parent captured at submit time, as in
        ``_traced_cachegen``)."""
        tracer = get_tracer()
        parent = current_span()

        def verify() -> str:
            sp = tracer.start_span(_names.SPAN_SPEC_VERIFY, parent=parent, kw=kw)
            try:
                agree = bool(self.spec_verify(request, matched_key))
                with self._lock:
                    outcome = self.speculator.resolve(spec_id, agree)
                if outcome == "rollback":
                    self.metrics.add("spec_rollbacks")
                sp.event(_names.EVENT_SPEC_FATE, fate=outcome, kw=kw)
                return outcome
            except BaseException as e:
                sp.set(error=type(e).__name__)
                raise
            finally:
                sp.end()

        return verify

    def _attribution_event(self, sp: Any, i: int, tpl: Optional[Any], attrib: Any, *,
                           speculative: bool = False) -> None:
        """One ``cache.attribution`` event for request ``i``: the tier that
        serves it, where a hit came from (stage, matched key, shard, replica
        tier, deposited by the resolving layers) and the §4.4 cost
        attribution: the large-planner output tokens the cached template
        saves regenerating. A near hit being verified carries
        ``speculative: true``; its ``spec.fate`` event comes later."""
        if tpl is None:
            sp.event(_names.EVENT_ATTRIBUTION, i=i, hit=False, tier="large")
            return
        saved = tokens_saved_estimate(tpl)
        self.metrics.add("tokens_saved", saved)
        extra = {"speculative": True} if speculative else {}
        sp.event(_names.EVENT_ATTRIBUTION, i=i, hit=True, tier="small", tokens_saved=saved,
                 adapt_cost_tokens=saved, **extra, **attrib.get(i))

    def _traced_cachegen(self, gen: Callable[[], Any], n: int) -> Callable[[], Any]:
        """A cache-generation task in a ``router.cachegen`` span. The tracer
        and parent span are captured at submit time: a pool thread's span
        context starts empty (``contextvars`` do not cross into a
        ``ThreadPoolExecutor``), so the span is parented explicitly."""
        tracer = get_tracer()
        parent = current_span()

        def traced() -> Any:
            sp = tracer.start_span(_names.SPAN_CACHEGEN, parent=parent, n=n)
            try:
                return gen()
            except BaseException as e:
                sp.set(error=type(e).__name__)
                raise
            finally:
                sp.end()

        return traced

    def _submit_cachegen(self, gen: Callable[[], Any], n: int) -> bool:
        """Hand one cache-generation task to the worker pool. Returns False
        when the pool rejected it (saturated or shut down): the caller then
        runs it synchronously — slower, never lost."""
        try:
            fut = self._pool.submit(gen)
        except RuntimeError:
            self.metrics.add("sync_cachegen_fallbacks", n)
            current_span().event(_names.EVENT_CACHEGEN_FATE, fate="sync_fallback", n=n)
            return False
        with self._lock:
            self._pending.append(fut)
        self.metrics.add("async_cachegens", n)
        current_span().event(_names.EVENT_CACHEGEN_FATE, fate="async", n=n)
        return True

    def _serve_hit(self, request: Any, tpl: Any) -> Any:
        """Cache hit: the cheap tier adapts the cached template. With
        ``kv_prefix`` wired, the adapter behind ``plan_small_with_template``
        places the single cache point after the template and before the
        adaptation prompt (``serving.kv_cache.plan_cache_point``) and passes
        it to ``Engine.generate``: the hit then prefills only the suffix."""
        self.metrics.add("hits")
        self.metrics.add("small_tier_calls")
        return self.plan_small_with_template(request, tpl)

    def _serve_miss(self, request: Any) -> Any:
        """Cache miss: the expensive tier replans (distillation is the
        caller's job: per request, or one batched wave)."""
        self.metrics.add("misses")
        self.metrics.add("large_tier_calls")
        return self.plan_large(request)

    def _dispatch(self, request: Any, kw: str, tpl: Optional[Any], token: float) -> Any:
        if tpl is not None:
            return self._serve_hit(request, tpl)
        result = self._serve_miss(request)

        def gen_and_insert():
            template = self.make_template(request, result)
            if template is not None:
                self.cache.insert(kw, template, unless_written_since=token)
            return template

        gen = self._traced_cachegen(gen_and_insert, 1)
        if self._pool is None or not self._submit_cachegen(gen, 1):
            gen()
        return result

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for pending cache generations and verifications. Raises the
        first deferred error of either mode: an async task's from its
        future, a sync wave's from the stash filled at route time."""
        with self._lock:
            pending, self._pending = self._pending, []
            errors, self._sync_cachegen_errors = self._sync_cachegen_errors, []
        for f in pending:
            f.result(timeout=timeout)
        if errors:
            raise errors[0]

    def close(self) -> None:
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)


__all__ = ["RouterMetrics", "TierPool", "TwoTierRouter"]
