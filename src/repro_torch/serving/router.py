"""Two-tier serving router — the APC cache as a routing policy (the port of
``repro.serving.router``, without speculation, spans and attribution).

A cache hit routes the planning request to the cheap tier (small planner)
and skips the expensive tier; a miss goes to the large planner, and the
completed execution is distilled into the plan cache, optionally on a
worker pool so cache generation never blocks the response path.

``route_batch`` admits a whole arrival wave through one ``lookup_batch``
pass and distills the wave's misses back through one ``insert_batch``,
conditional on the store clock read before the lookup
(``unless_written_since``), so a slow distillation never clobbers an entry
written after that read.

With ``kv_prefix`` (a ``serving.kv_cache.KVPrefixCache``), the prefix pool's
lifecycle is slaved to the plan cache: the router registers
``kv_prefix.release`` as an eviction listener, so a template's pages are
freed when the template leaves the plan cache.

Thread-safety: the router's lock guards the pending futures and deferred
errors; ``RouterMetrics`` takes its own lock for every increment, since
request threads and cache-generation workers bump the same counters. The
plan cache serializes itself.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


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


class RouterMetrics:
    """Router accounting: plain counters under one lock (request threads and
    cache-generation workers increment the same fields). Field names and
    ``snapshot()`` keys are the reference's, for the fields the port keeps."""

    FIELDS = ("requests", "hits", "misses", "large_tier_calls", "small_tier_calls",
              "async_cachegens", "sync_cachegen_fallbacks", "lookup_s")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0.0 if f == "lookup_s" else 0)

    def add(self, name: str, n: float = 1) -> None:
        """Lock-safe increment, callable from any thread."""
        if name not in self.FIELDS:
            raise KeyError(name)
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": self.requests,
                "hit_rate": self.hits / max(1, self.hits + self.misses),
                "large_tier_calls": self.large_tier_calls,
                "small_tier_calls": self.small_tier_calls,
                "async_cachegens": self.async_cachegens,
                "sync_cachegen_fallbacks": self.sync_cachegen_fallbacks,
                "lookup_s": round(self.lookup_s, 6),
            }


class TwoTierRouter:
    """keyword -> cache -> tier selection."""

    def __init__(
        self,
        cache,  # repro_torch.core.cache.PlanCache
        *,
        extract_keyword: Callable[[Any], str],
        plan_large: Callable[[Any], Any],
        plan_small_with_template: Callable[[Any, Any], Any],
        make_template: Callable[[Any, Any], Any],
        async_cachegen: bool = True,
        kv_prefix: Optional[Any] = None,
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
        self.metrics = RouterMetrics()
        self._pool: Optional[cf.ThreadPoolExecutor] = (
            cf.ThreadPoolExecutor(max_workers=2) if async_cachegen else None
        )
        self._pending: List[cf.Future] = []
        self._sync_cachegen_errors: List[BaseException] = []
        self._lock = threading.Lock()

    def route(self, request: Any) -> Any:
        self.metrics.add("requests")
        kw = self.extract_keyword(request)
        token = self.cache.now()
        t0 = time.perf_counter()
        tpl = self.cache.lookup(kw)
        self.metrics.add("lookup_s", time.perf_counter() - t0)
        return self._dispatch(request, kw, tpl, token)

    def route_batch(self, requests: List[Any]) -> List[Any]:
        """Admit a whole batch of requests through one cache pass.

        All keywords are answered by a single ``lookup_batch``, then each
        request takes its hit/miss tier dispatch. The misses' distilled
        templates land back in the cache as one admission wave
        (``insert_batch``) instead of one insert per miss.
        """
        self.metrics.add("requests", len(requests))
        kws = [self.extract_keyword(r) for r in requests]
        token = self.cache.now()
        t0 = time.perf_counter()
        tpls = self.cache.lookup_batch(kws)
        self.metrics.add("lookup_s", time.perf_counter() - t0)

        out: List[Any] = []
        wave: List[tuple] = []  # (request, kw, large-tier result) misses
        for r, kw, tpl in zip(requests, kws, tpls):
            if tpl is not None:
                out.append(self._serve_hit(r, tpl))
            else:
                result = self._serve_miss(r)
                out.append(result)
                wave.append((r, kw, result))

        if wave:
            def gen_and_insert_wave():
                # per-request failure isolation: one bad make_template must
                # not discard the rest of the wave's templates; the first
                # error still surfaces through drain() after the wave lands
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
                    # insert-if-newer: an entry (re)written since the lookup
                    # wins over the possibly slow distillation
                    self.cache.insert_batch(items, unless_written_since=token)
                if first_err is not None:
                    raise first_err
                return items

            if self._pool is None or not self._submit_cachegen(gen_and_insert_wave, len(wave)):
                # sync mode (or the saturated-pool fallback): the batch's
                # plans are already computed and served, so a wave error is
                # deferred to drain()/close() instead of discarding them;
                # warn so a caller that never drains still sees it
                try:
                    gen_and_insert_wave()
                except Exception as e:
                    warnings.warn(
                        f"cache generation failed for an admission wave "
                        f"(deferred to drain()): {e!r}"
                    )
                    with self._lock:
                        if len(self._sync_cachegen_errors) < 16:
                            self._sync_cachegen_errors.append(e)
        return out

    def _submit_cachegen(self, gen: Callable[[], Any], n: int) -> bool:
        """Hand one cache-generation task to the worker pool. Returns False
        when the pool rejected it (saturated or shut down): the caller then
        runs it synchronously — slower, never lost."""
        try:
            fut = self._pool.submit(gen)
        except RuntimeError:
            self.metrics.add("sync_cachegen_fallbacks", n)
            return False
        with self._lock:
            self._pending.append(fut)
        self.metrics.add("async_cachegens", n)
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

        if self._pool is None or not self._submit_cachegen(gen_and_insert, 1):
            gen_and_insert()
        return result

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for pending cache generations. Raises the first deferred
        cache-generation error of either mode: an async wave's from its
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
