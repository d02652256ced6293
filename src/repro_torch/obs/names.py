"""The canonical catalog of metric names, span kinds, and event kinds.

Instrumented code references these constants instead of writing string
literals, and two gates keep the catalog honest:

* ``tools/check_docs.py`` reads the literals below via the AST (no import
  needed) and fails CI when any catalogued name is missing from the docs
  corpus — adding a metric or span kind without documenting it is a build
  failure;
* ``tests/test_obs.py`` runs a traced serving path and fails when the
  registry or tracer saw a name OUTSIDE this catalog — so the catalog
  can't silently under-report the instrumented surface either.

The tuples below must stay pure literals (the docs gate parses, it does
not import).
"""

from __future__ import annotations

# -- metrics (see docs/observability.md for semantics & units) -------------

ROUTER_REQUESTS = "router.requests"
ROUTER_HITS = "router.hits"
ROUTER_MISSES = "router.misses"
ROUTER_LARGE_TIER_CALLS = "router.large_tier_calls"
ROUTER_SMALL_TIER_CALLS = "router.small_tier_calls"
ROUTER_ASYNC_CACHEGENS = "router.async_cachegens"
ROUTER_SYNC_CACHEGEN_FALLBACKS = "router.sync_cachegen_fallbacks"
ROUTER_CACHEGEN_DROPPED = "router.cachegen_dropped"
ROUTER_LOOKUP_S = "router.lookup_s"
ROUTER_LOOKUP_LATENCY = "router.lookup_latency_s"
ROUTER_TOKENS_SAVED = "router.tokens_saved"
ROUTER_SPECULATIONS = "router.speculations"
ROUTER_SPEC_COMMITS = "router.spec_commits"
ROUTER_SPEC_ROLLBACKS = "router.spec_rollbacks"
ROUTER_SPEC_SYNC_VERIFIES = "router.spec_sync_verifies"
ROUTER_SPEC_DROPPED = "router.spec_dropped"

CACHE_HITS = "cache.hits"
CACHE_MISSES = "cache.misses"
CACHE_INSERTS = "cache.inserts"
CACHE_EVICTIONS = "cache.evictions"
CACHE_LOOKUP_TIME_S = "cache.lookup_time_s"
CACHE_COLD_HITS = "cache.cold_hits"
CACHE_SPILLS = "cache.spills"
CACHE_PROMOTES = "cache.promotes"
CACHE_COMPACTION_SAVED_TOKENS = "cache.compaction_saved_tokens"
CACHE_STALE_INSERT_SKIPS = "cache.stale_insert_skips"

LSH_QUERIES = "index.lsh.queries"
LSH_PROBED_QUERIES = "index.lsh.probed_queries"
LSH_BRUTE_FALLBACK_QUERIES = "index.lsh.brute_fallback_queries"
LSH_CANDIDATES_TOTAL = "index.lsh.candidates_total"
LSH_EMPTY_CANDIDATE_QUERIES = "index.lsh.empty_candidate_queries"
LSH_CANDIDATES = "index.lsh.candidates"
LSH_RECALL_CHECKS = "index.lsh.recall_checks"
LSH_RECALL_AGREEMENTS = "index.lsh.recall_agreements"

KV_PAGES_HIT = "kv.pages_hit"
KV_PAGES_BUILT = "kv.pages_built"
KV_TOKENS_PREFETCHED = "kv.tokens_prefetched"
KV_PREFIX_EVICTIONS = "kv.prefix_evictions"

DEVICE_CAPACITY = "index.device.capacity"
DEVICE_H2D_BYTES = "index.device.h2d_bytes_total"
DEVICE_ROW_UPDATES = "index.device.row_updates"
DEVICE_BATCHED_UPDATES = "index.device.batched_updates"
DEVICE_CLEARS = "index.device.clears"
DEVICE_GROWS = "index.device.grows"

METRIC_NAMES = (
    "router.requests",
    "router.hits",
    "router.misses",
    "router.large_tier_calls",
    "router.small_tier_calls",
    "router.async_cachegens",
    "router.sync_cachegen_fallbacks",
    "router.cachegen_dropped",
    "router.lookup_s",
    "router.lookup_latency_s",
    "router.tokens_saved",
    "router.speculations",
    "router.spec_commits",
    "router.spec_rollbacks",
    "router.spec_sync_verifies",
    "router.spec_dropped",
    "cache.hits",
    "cache.misses",
    "cache.inserts",
    "cache.evictions",
    "cache.lookup_time_s",
    "cache.cold_hits",
    "cache.spills",
    "cache.promotes",
    "cache.compaction_saved_tokens",
    "cache.stale_insert_skips",
    "kv.pages_hit",
    "kv.pages_built",
    "kv.tokens_prefetched",
    "kv.prefix_evictions",
    "index.lsh.queries",
    "index.lsh.probed_queries",
    "index.lsh.brute_fallback_queries",
    "index.lsh.candidates_total",
    "index.lsh.empty_candidate_queries",
    "index.lsh.candidates",
    "index.lsh.recall_checks",
    "index.lsh.recall_agreements",
    "index.device.capacity",
    "index.device.h2d_bytes_total",
    "index.device.row_updates",
    "index.device.batched_updates",
    "index.device.clears",
    "index.device.grows",
)

# -- span kinds ------------------------------------------------------------

SPAN_ROUTE = "router.route"
SPAN_ROUTE_BATCH = "router.route_batch"
SPAN_ROUTER_LOOKUP = "router.lookup"
SPAN_CACHEGEN = "router.cachegen"
SPAN_SPEC_VERIFY = "router.spec_verify"
SPAN_DCACHE_LOOKUP = "dcache.lookup_batch"
SPAN_DCACHE_INSERT = "dcache.insert_batch"
SPAN_DCACHE_TIER = "dcache.tier"
SPAN_SHARD_CALL = "dcache.shard_call"
SPAN_CACHE_LOOKUP = "cache.lookup_batch"
SPAN_CACHE_INSERT = "cache.insert_batch"
SPAN_CACHE_SPILL = "cache.spill"
SPAN_CACHE_PROMOTE = "cache.promote"
SPAN_MATCH_STAGE = "match.stage"
SPAN_INDEX_TOPK = "index.topk"
SPAN_ENGINE_GENERATE = "engine.generate"

SPAN_NAMES = (
    "router.route",
    "router.route_batch",
    "router.lookup",
    "router.cachegen",
    "router.spec_verify",
    "dcache.lookup_batch",
    "dcache.insert_batch",
    "dcache.tier",
    "dcache.shard_call",
    "cache.lookup_batch",
    "cache.insert_batch",
    "cache.spill",
    "cache.promote",
    "match.stage",
    "index.topk",
    "engine.generate",
)

# -- span event kinds ------------------------------------------------------

EVENT_ATTRIBUTION = "cache.attribution"
EVENT_CACHEGEN_FATE = "cachegen.fate"
EVENT_SPEC_FATE = "spec.fate"

EVENT_NAMES = (
    "cache.attribution",
    "cachegen.fate",
    "spec.fate",
)

__all__ = [n for n in dir() if n.isupper()]
