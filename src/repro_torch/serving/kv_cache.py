"""Paged KV prefix cache keyed by plan template id (the port of
``repro.serving.kv_cache``).

A plan-cache hit re-serves a known prefix: the cached plan template is
rendered verbatim ahead of the per-request adaptation prompt. This module
keeps that prefix's KV in a shared refcounted page pool, so a hit prefills
only the adaptation suffix:

  * :class:`PagePool` — per-layer K/V slabs of ``(num_pages, page_size,
    Hkv, hd)`` pages on an explicit device, with refcounts and a free list.
    Unlike the reference's immutable arrays, the slabs are updated IN PLACE
    (``index_copy_``), so a write never holds two copies of the pool.
  * :class:`KVPrefixCache` — template id -> page list, with LRU eviction on
    pool exhaustion, copy-on-write suffix extension (:meth:`extend` shares
    full pages with the parent and copies only the partial tail page), and
    lease-based pinning so a prefix can't be evicted under an in-flight
    prefill.
  * :class:`CachePoint` / :func:`plan_cache_point` — the single cache
    point: one prefix/suffix split per request, after the template and
    before the adaptation prompt.

Lifecycle is tied to the plan cache: ``TwoTierRouter`` registers
:meth:`KVPrefixCache.release` as a ``PlanCache`` eviction listener, so a
template's pages are freed exactly when the template leaves the plan cache.

Thread-safety: ``KVPrefixCache`` owns the lock; ``PagePool`` must only be
mutated by its owning cache (or a single-threaded test). Recency is a
monotonic integer sequence, not wall-clock time, so eviction order is
deterministic.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.obs import names as _names
from repro_torch.obs.registry import MetricsRegistry


class PagePoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied even after evicting
    every idle (lease-free) prefix."""


class PagePool:
    """Refcounted per-layer K/V page slabs shared by every cached prefix.

    One pool row = one page of ``page_size`` tokens across all layers. A row
    goes back on the free list only when its last owner (prefix entry or
    lease) releases it. NOT independently thread-safe.
    """

    def __init__(
        self,
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        self._k = torch.zeros(shape, dtype=dtype, device=self.device)
        self._v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcount = np.zeros((num_pages,), np.int32)
        # pop() from the tail allocates low rows first (stable test order)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` free rows at refcount 1."""
        if len(self._free) < n:
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}"
            )
        rows = [self._free.pop() for _ in range(n)]
        for r in rows:
            self.refcount[r] = 1
        return rows

    def retain(self, rows: Sequence[int]) -> None:
        for r in rows:
            self.refcount[r] += 1

    def release(self, rows: Sequence[int]) -> None:
        for r in rows:
            if self.refcount[r] <= 0:
                raise RuntimeError(f"page {r} over-released")
            self.refcount[r] -= 1
            if self.refcount[r] == 0:
                self._free.append(r)

    def _rows(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long, device=self.device)

    def write(self, rows: Sequence[int], k_data: torch.Tensor, v_data: torch.Tensor) -> None:
        """Copy page data (L, n, page_size, Hkv, hd) into rows, in place."""
        idx = self._rows(rows)
        self._k.index_copy_(1, idx, k_data.to(device=self.device, dtype=self._k.dtype))
        self._v.index_copy_(1, idx, v_data.to(device=self.device, dtype=self._v.dtype))

    def gather(self, rows: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (k, v) each (L, n, page_size, Hkv, hd), copies."""
        idx = self._rows(rows)
        return self._k.index_select(1, idx), self._v.index_select(1, idx)

    @property
    def nbytes(self) -> int:
        """Bytes of the K and V slabs."""
        return 2 * self._k.numel() * self._k.element_size()

    @property
    def page_layout(self) -> Tuple[int, int]:
        """(kv heads, head dim) a page holds."""
        return int(self._k.shape[3]), int(self._k.shape[4])

    def kernel_view(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (N, page_size, Hkv, hd) slabs one layer of the paged decode
        kernel reads through its page table (views, not copies)."""
        return self._k[layer], self._v[layer]


def pool_for_config(cfg, *, num_pages: int = 64, page_size: int = 16,
                    device=None, mesh=None, profile=None) -> PagePool:
    """Size a pool to a model config (dense-family cache geometry), in the
    config's cache dtype, on ``device`` (CUDA unless asked otherwise).

    With ``mesh=`` (and the engine's ``profile=``, default as ``Engine``'s)
    the pool is one rank's: its pages hold the rank's block of each prefix
    (``models.parallel.prefix_spec``: kv heads over tp where they split,
    else the head dim), so a rank's pool holds 1/tp of the whole pool's
    bytes where either splits. Every rank keeps its own pool and calls it
    in lockstep with the others, so all make the same alloc, evict and
    lease decisions."""
    heads, hd = cfg.num_kv_heads, cfg.head_dim
    if mesh is not None:
        from repro_torch.configs.base import ShardingProfile
        from repro_torch.models import parallel as par

        ctx = par.ParallelCtx.from_profile(mesh, profile or ShardingProfile())
        heads, hd = par.prefix_dims(cfg, ctx)
    return PagePool(
        cfg.num_layers, num_pages, page_size, heads, hd,
        dtype=dtype_of(cfg.dtype), device=device,
    )


@dataclass(frozen=True)
class PrefixLease:
    """A pinned view of one prefix: holds its own refcount on every page,
    so the prefix stays gatherable even if the entry is evicted mid-use."""

    template_id: str
    pages: Tuple[int, ...]
    length: int


@dataclass
class _Prefix:
    pages: List[int]
    length: int
    last_used: int
    leases: int = 0


def _check_length(length: Optional[int], S: int) -> int:
    length = S if length is None else int(length)
    if not 0 < length <= S:
        raise ValueError(f"length {length} outside (0, {S}]")
    return length


class KVPrefixCache:
    """template_id -> prefix pages, with plan-cache-coupled lifecycle.

    ``put`` chops a prefix's per-layer K/V into pool pages; ``acquire`` +
    ``gather`` re-materialize it for a suffix-only prefill; ``extend``
    derives a child prefix copy-on-write; ``release`` (the plan-cache
    eviction listener) frees the pages when the template is evicted.

    Owns the lock for itself AND its pool. Its four counters
    (``kv.pages_hit``, ``kv.pages_built``, ``kv.tokens_prefetched``,
    ``kv.prefix_evictions``) live in ``obs`` (a registry of its own when
    none is given) under ``obs_labels``; the properties of the same names
    read them.
    """

    def __init__(
        self,
        pool: PagePool,
        *,
        obs: Optional[MetricsRegistry] = None,
        obs_labels: Optional[Dict[str, str]] = None,
    ):
        self.pool = pool
        self._lock = threading.Lock()
        self._entries: Dict[str, _Prefix] = {}
        self._seq = 0  # monotonic recency counter (deterministic LRU)
        self.obs = obs if obs is not None else MetricsRegistry()
        labels = dict(obs_labels or {})
        self._pages_hit = self.obs.counter(_names.KV_PAGES_HIT, **labels)
        self._pages_built = self.obs.counter(_names.KV_PAGES_BUILT, **labels)
        self._tokens_prefetched = self.obs.counter(
            _names.KV_TOKENS_PREFETCHED, **labels
        )
        self._prefix_evictions = self.obs.counter(
            _names.KV_PREFIX_EVICTIONS, **labels
        )

    @property
    def pages_hit(self) -> int:
        return self._pages_hit.value

    @property
    def pages_built(self) -> int:
        return self._pages_built.value

    @property
    def tokens_prefetched(self) -> int:
        return self._tokens_prefetched.value

    @property
    def prefix_evictions(self) -> int:
        return self._prefix_evictions.value

    # -- internals (call with the lock held) -------------------------------

    def _release_locked(self, template_id: str) -> None:
        entry = self._entries.pop(template_id)
        self.pool.release(entry.pages)
        self._prefix_evictions.inc()

    def _alloc_locked(self, n: int) -> List[int]:
        """Allocate ``n`` pages, LRU-evicting idle prefixes to make room."""
        if n > self.pool.num_pages:
            # unsatisfiable even by evicting everything: refuse up front
            # rather than destroy the whole cache before failing anyway
            raise PagePoolExhausted(
                f"need {n} pages but the pool holds only "
                f"{self.pool.num_pages} total"
            )
        while self.pool.free_pages < n:
            victim = None
            for tid, e in self._entries.items():
                if e.leases:
                    continue
                if victim is None or e.last_used < self._entries[victim].last_used:
                    victim = tid
            if victim is None:
                leased = sum(1 for e in self._entries.values() if e.leases)
                raise PagePoolExhausted(
                    f"need {n} pages, {self.pool.free_pages} free of "
                    f"{self.pool.num_pages}; no evictable prefix left "
                    f"({leased} leased, remaining pages pinned by "
                    f"outstanding leases or COW shares)"
                )
            self._release_locked(victim)
        return self.pool.alloc(n)

    def _paginate(self, k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                  length: int, n_pages: int):
        """(L, S, Hkv, hd) tensors -> (L, n_pages, ps, Hkv, hd) page data,
        zero-padded past ``length``."""
        ps = self.pool.page_size
        L, _, H, hd = k_prefix.shape
        pad = n_pages * ps - length

        def chop(x):
            x = x[:, :length]
            if pad:
                x = torch.cat([x, x.new_zeros((L, pad, H, hd))], dim=1)
            return x.reshape(L, n_pages, ps, H, hd)

        return chop(k_prefix), chop(v_prefix)

    # -- public API --------------------------------------------------------

    def put(self, template_id: str, k_prefix: torch.Tensor, v_prefix: torch.Tensor, *,
            length: Optional[int] = None) -> int:
        """Store a template prefix. k/v: (L, S, Hkv, hd) post-RoPE cache
        rows; ``length`` valid tokens (default S). Returns pages used."""
        length = _check_length(length, int(k_prefix.shape[1]))
        n = -(-length // self.pool.page_size)
        with self._lock:
            if template_id in self._entries:
                if self._entries[template_id].leases:
                    raise PagePoolExhausted(
                        f"prefix {template_id!r} is leased; cannot replace"
                    )
                self._release_locked(template_id)
            rows = self._alloc_locked(n)
            kp, vp = self._paginate(k_prefix, v_prefix, length, n)
            self.pool.write(rows, kp, vp)
            self._seq += 1
            self._entries[template_id] = _Prefix(rows, length, self._seq)
            self._pages_built.inc(n)
        return n

    def acquire(self, template_id: str) -> Optional[PrefixLease]:
        """Pin a prefix for use; None on miss. Pair with release_lease."""
        with self._lock:
            entry = self._entries.get(template_id)
            if entry is None:
                return None
            entry.leases += 1
            self._seq += 1
            entry.last_used = self._seq
            self.pool.retain(entry.pages)
            self._pages_hit.inc(len(entry.pages))
            return PrefixLease(template_id, tuple(entry.pages), entry.length)

    def gather(self, lease: PrefixLease, *, batch: int = 1):
        """-> (k, v, length): (L, B, Sp, Hkv, hd) dense prefix views, the one
        gathered copy expanded over the batch (Sp = pages * page_size >=
        length; positions past length are the zero padding the extend mask
        discards)."""
        with self._lock:
            kg, vg = self.pool.gather(lease.pages)
            self._tokens_prefetched.inc(batch * lease.length)
        L, n, ps, H, hd = kg.shape
        k = kg.reshape(L, 1, n * ps, H, hd).expand(L, batch, n * ps, H, hd)
        v = vg.reshape(L, 1, n * ps, H, hd).expand(L, batch, n * ps, H, hd)
        return k, v, lease.length

    def release_lease(self, lease: PrefixLease) -> None:
        with self._lock:
            self.pool.release(lease.pages)
            entry = self._entries.get(lease.template_id)
            if entry is not None and entry.leases > 0:
                entry.leases -= 1

    def page_table(self, leases: Sequence[PrefixLease]):
        """Batch leases into the paged-attention calling convention, on the
        pool's device: -> (page_table (B, P) int32 with -1 past each
        prefix's last page, lengths (B,) int32)."""
        P = max(len(l.pages) for l in leases)
        table = np.full((len(leases), P), -1, np.int32)
        for i, l in enumerate(leases):
            table[i, : len(l.pages)] = l.pages
        lengths = np.asarray([l.length for l in leases], np.int32)
        dev = self.pool.device
        return torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev)

    def extend(self, parent_id: str, child_id: str, k_suffix: torch.Tensor,
               v_suffix: torch.Tensor, *, length: Optional[int] = None) -> int:
        """Copy-on-write suffix extension: the child shares every FULL
        parent page (refcount bump, no copy) and copies only the parent's
        partial tail page before appending the suffix K/V.

        k/v_suffix: (L, S, Hkv, hd); ``length`` valid suffix tokens
        (default S). Returns the number of NEW pages written."""
        length = _check_length(length, int(k_suffix.shape[1]))
        ps = self.pool.page_size
        with self._lock:
            parent = self._entries.get(parent_id)
            if parent is None:
                raise KeyError(f"unknown parent prefix {parent_id!r}")
            # Pin the parent for the duration: with leases == 0 it would be
            # a legal victim of _alloc_locked's LRU sweep, whose eviction
            # would free the parent's pages and let the child's new rows be
            # carved out of them (and a child_id == parent_id replace fails
            # loudly instead of freeing the pages mid-read).
            parent.leases += 1
            try:
                if child_id in self._entries:
                    if self._entries[child_id].leases:
                        raise PagePoolExhausted(
                            f"prefix {child_id!r} is leased; cannot replace"
                        )
                    self._release_locked(child_id)
                n_full, tail = divmod(parent.length, ps)
                new_len = parent.length + length
                n_new = -(-new_len // ps) - n_full
                shared = list(parent.pages[:n_full])
                rows = self._alloc_locked(n_new)
                # tail-page data precedes the suffix in the first new page
                k_suf = k_suffix[:, :length].to(self.pool.device)
                v_suf = v_suffix[:, :length].to(self.pool.device)
                if tail:
                    tk, tv = self.pool.gather(parent.pages[n_full : n_full + 1])
                    tk, tv = tk[:, 0, :tail], tv[:, 0, :tail]  # (L, tail, H, hd)
                    k_data = torch.cat([tk.to(k_suf.dtype), k_suf], dim=1)
                    v_data = torch.cat([tv.to(v_suf.dtype), v_suf], dim=1)
                else:
                    k_data, v_data = k_suf, v_suf
                kp, vp = self._paginate(k_data, v_data, tail + length, n_new)
                self.pool.write(rows, kp, vp)
                self.pool.retain(shared)
                self._seq += 1
                self._entries[child_id] = _Prefix(shared + rows, new_len, self._seq)
                self._pages_built.inc(n_new)
            finally:
                parent.leases -= 1
        return n_new

    def release(self, template_id: str) -> bool:
        """Free a prefix's pages (refcount-decrement; COW children and
        outstanding leases keep shared rows alive). This is the plan-cache
        eviction listener: it runs for every plan-cache delete, so unknown
        ids are a no-op."""
        with self._lock:
            if template_id not in self._entries:
                return False
            self._release_locked(template_id)
            return True

    def clear(self) -> None:
        with self._lock:
            for tid in list(self._entries):
                self._release_locked(tid)

    def __contains__(self, template_id: str) -> bool:
        with self._lock:
            return template_id in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[str]:
        """The template ids held, in insertion order."""
        with self._lock:
            return list(self._entries)

    def length_of(self, template_id: str) -> Optional[int]:
        with self._lock:
            entry = self._entries.get(template_id)
            return None if entry is None else entry.length


# ---------------------------------------------------------------------------
# The single cache point
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CachePoint:
    """One prefix/suffix split for a request batch: the first
    ``prefix_len`` prompt columns are the plan template (shared KV, keyed
    ``template_id``); everything after is the per-request adaptation
    prompt (fresh prefill)."""

    template_id: str
    prefix_len: int


def plan_cache_point(template_id: str, template_tokens,
                     prompt_tokens) -> Optional[CachePoint]:
    """Place the single cache point after the template and before the
    adaptation prompt. Returns None when the placement is unsafe: the
    prompt doesn't literally start with the template tokens (on every
    batch row), or there is no adaptation suffix left to prefill."""
    t = np.asarray(template_tokens).reshape(-1)
    p = np.atleast_2d(np.asarray(prompt_tokens))
    if t.size == 0 or t.size >= p.shape[1]:
        return None
    if not np.array_equal(p[:, : t.size],
                          np.broadcast_to(t, (p.shape[0], t.size))):
        return None
    return CachePoint(template_id=template_id, prefix_len=int(t.size))


__all__ = [
    "CachePoint",
    "KVPrefixCache",
    "PagePool",
    "PagePoolExhausted",
    "PrefixLease",
    "plan_cache_point",
    "pool_for_config",
]
