"""Serving engine: prefill + decode for one model deployment (the port of
``repro.serving.engine``).

One Engine instance = one model (a planner tier or the actor). It exposes

  * ``generate(tokens, max_new)`` — batched greedy/temperature generation
  * ``prefill_with_prefix(template_id, suffix)`` — suffix-only prefill
    against a template prefix held in the paged KV pool
    (``serving/kv_cache.py``): a plan-cache hit re-serves a known prefix,
    so only the adaptation prompt pays prefill compute
  * ``measured_rates()`` — tokens/s observed on the device, fed to the APC
    cost model so control-plane latency comes from the data plane.

The prefix path gathers the pooled pages into a dense cache and decodes
with the dense decode kernel, as the reference does; the paged decode
kernel reads the same pool through a page table beside it.

An engine serves token prompts, so it takes every family but audio:
whisper's decoder needs the stub frontend's frames, and its entry points
are ``lm.prefill(..., frames=)`` and ``lm.decode_step``.

With ``mesh=`` (a live ``distributed.mesh_compat.Mesh``) and ``profile=``
(a ``ShardingProfile``; default TP over "model", no FSDP) every rank of the
mesh builds the engine from the whole parameters, keeps its shards
(``param_pspecs``), and runs ``generate`` in lockstep with the others on the
same prompts: each rank prefills and decodes its rows of the batch (split
over the dp axes) on its shards, the logits are full-vocabulary on every
rank, and the generated ids are all-gathered over dp, so every rank returns
the whole batch's tokens. With ``kv_prefix=`` as well, each rank keeps its
own prefix cache over a pool of its layout (``kv_cache.pool_for_config(cfg,
mesh=, profile=)``): a registered prefix is batch row 0 of the rank's cache
block, taken to the pool's layout (``lm.prefix_of``), and a hit extends the
rank's rows from the rank's pages (``lm.prefill_extend(ctx=)``). The ranks
call their caches in lockstep, so they hit, miss and evict alike.

Decode through a CUDA graph. A dense model without a mesh on the card
(every role of ``configs/apc_minion.py::DEFAULT``) decodes each step as one
replay of ``lm.decode_step`` captured into a ``torch.cuda.CUDAGraph``, so
the host enqueues one launch a step instead of ~50 a layer. The engine
keeps one graph: it owns that batch size's cache (rows x ``max_len``, its
position ``pos`` on the device), ``generate`` prefills into it, the first
decode step on it runs eagerly and the second captures the step (on a side
stream) and replays it; every later step of that batch size, whatever its
prompt's length, copies the sampled ids into the graph's token buffer and
replays. Positions past a row's length keep an earlier call's K/V: the
decode kernel reads a row only up to its length. A call of another batch
size drops the graph and its cache and builds the next. Sampling, EOS and
the token readback stay outside the graph. A replay launches kernels that
no wrapper counts, so the engine adds what the wrappers counted while it
captured (``kernels.counts``). Everything else decodes eagerly: the CPU;
a mesh (collectives inside the step); moe, whose dispatch reads the
routing on the host; the recurrent families; vlm, not yet measured
under a graph. ``EngineStats``
counts the captures, replays and eager steps.

The engine runs on ``cuda`` unless constructed with ``device="cpu"``.
Its timers synchronize the device before reading the clock, so the rates
measure device work, not kernel-launch time. Under a tracer
(``repro_torch.obs``) every ``generate`` call is one ``engine.generate``
span, with the reference's attributes and the arch's name; the span closes
after the tokens are on the host, so it covers the device's time. Inside it
the port adds its own spans (``obs.port_names``): one ``engine.prefill``
(batch, tokens: the prompt length, prefix: ``"hit"``, ``"miss"`` or
``"none"``) and one ``engine.decode_step`` a decode step (step, from 0;
active: the rows still generating; graph: ``"capture"``, ``"replay"`` or
``"eager"``). Each closes after the engine's timer
has synchronised the device, so the device work it launched ends inside it
(the page copies of a miss's ``register_prefix`` excepted: the readback of
the first token waits for them). Sampling, the token readback and the
loop's own work are ``engine.generate``'s self time. With a tracer on
``obs.profiler_clock`` the spans lie on ``torch.profiler``'s timebase.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels as kernel_table
from repro_torch.configs.base import ModelConfig, ShardingProfile
from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models import parallel as par
from repro_torch.models.common import resolve_device
from repro_torch.obs import trace_span
from repro_torch.obs.names import SPAN_ENGINE_GENERATE
from repro_torch.obs.port_names import (
    ATTR_DECODE_GRAPH,
    SPAN_ENGINE_DECODE_STEP,
    SPAN_ENGINE_PREFILL,
)
from repro_torch.serving.kv_cache import CachePoint, KVPrefixCache, PagePoolExhausted
from repro_torch.serving.sampler import sample_token

# families whose cache is pure KV (no recurrent state): the only ones a
# stored prefix can be re-entered into mid-stream
_PREFIX_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefix_tokens_reused: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # of decode_s, the host's part: from a step's start until its work is
    # enqueued (``lm.decode_step`` returned), before the device is waited
    # for. When the device paces the steps, CUDA's launch queue fills and
    # the enqueue blocks, so this approaches decode_s.
    decode_host_s: float = 0.0
    # how the decode steps ran: captured into the engine's CUDA graph (the
    # capture's step is also one replay), replayed from it, or eagerly
    decode_graph_captures: int = 0
    decode_graph_replays: int = 0
    decode_eager_steps: int = 0

    def rates(self) -> Dict[str, float]:
        return {
            "prefill": self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0,
            "decode": self.decode_tokens / self.decode_s if self.decode_s else 0.0,
        }


class _StepGraph:
    """The engine's decode step for a batch of ``rows``, captured once and
    replayed: the cache it reads and writes, at fixed addresses (with the
    position ``pos`` on the device), the token buffer it reads, the logits
    it writes, and the kernels' launch counts a replay stands for."""

    def __init__(self, cfg, rows: int, max_len: int, device):
        self.rows = rows
        self.cache = lm.init_cache(cfg, rows, max_len, device)
        self.cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        self.tokens = torch.zeros((rows, 1), dtype=torch.int32, device=device)
        self.warm = False  # an eager step has run on this cache
        self.graph = None
        self.logits = None
        self.launches = {}

    def owns(self, cache) -> bool:
        return cache.get("pos") is self.cache["pos"]

    def capture(self, cfg, params) -> None:
        before = kernel_table.counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            logits, _ = lm.decode_step(cfg, params, self.cache, self.tokens)
            self.logits = logits[:, -1]
        after = kernel_table.counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernel_table.add_counts(self.launches, sign=-1)  # a capture launches nothing

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        kernel_table.add_counts(self.launches)
        return self.logits


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, *, mesh=None,
                 profile: Optional[ShardingProfile] = None, max_len: int = 512,
                 device=None, kv_prefix: Optional[KVPrefixCache] = None):
        if cfg.family == "audio":
            raise ValueError(
                f"{cfg.name}: an Engine serves token prompts; the audio family also "
                "needs the frontend's frames: call lm.prefill(cfg, params, tokens, "
                "frames=...) and lm.decode_step instead")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ctx = None
        if mesh is not None:
            profile = profile or ShardingProfile()
            self.ctx = lm.ParallelCtx.from_profile(mesh, profile)
            specs = shd.param_pspecs(params, profile, mesh)
            params = shd.shard_tree(params, specs, mesh)
        self.params = lm.params_to(params, self.device)
        self.max_len = max_len
        self.stats = EngineStats()
        # decode through a CUDA graph, or eagerly (module docstring)
        self._graphed = self.device.type == "cuda" and self.ctx is None and cfg.family == "dense"
        self._graph: Optional[_StepGraph] = None
        self.kv_prefix = kv_prefix if cfg.family in _PREFIX_FAMILIES else None
        if self.kv_prefix is not None:
            want = par.prefix_dims(cfg, self.ctx)
            if self.kv_prefix.pool.page_layout != want:
                raise ValueError(
                    f"kv_prefix's pool holds pages of {self.kv_prefix.pool.page_layout} (kv "
                    f"heads, head dim); this engine's rank needs {want}: build it with "
                    f"pool_for_config(cfg, mesh=, profile=) as the engine's")

    def _rows(self, tokens: np.ndarray) -> np.ndarray:
        """This rank's rows of a whole batch (all of them without a mesh)."""
        if self.ctx is None or not self.ctx.dp:
            return tokens
        n = self._n_dp()
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split over {n} dp ranks")
        b = tokens.shape[0] // n
        i = self.mesh.axis_index(self.ctx.dp)
        return tokens[i * b:(i + 1) * b]

    def _n_dp(self) -> int:
        """The dp ranks a whole batch splits over (1 without a mesh)."""
        if self.ctx is None or not self.ctx.dp:
            return 1
        return self.mesh.axis_size(self.ctx.dp)

    def _whole(self, ids: np.ndarray) -> np.ndarray:
        """The whole batch's generated ids from this rank's rows."""
        if self.ctx is None or not self.ctx.dp:
            return ids
        out = mc.all_gather(torch.as_tensor(ids, device=self.device), self.mesh, self.ctx.dp,
                            dim=0)
        return out.cpu().numpy()

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _graph_cache(self, rows: int) -> Optional[Dict[str, Any]]:
        """The cache of the graph for ``rows`` rows, where this engine
        decodes through one: a new batch size drops the old graph and its
        cache before it builds their successors."""
        if not self._graphed:
            return None
        if self._graph is None or self._graph.rows != rows:
            self._graph = None
            self._graph = _StepGraph(self.cfg, rows, self.max_len, self.device)
        return self._graph.cache

    def prefill(self, tokens: np.ndarray, *, n_valid: Optional[int] = None,
                into: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, Any]:
        """tokens: (B, S) int -> (last logits (B, V) on the device, cache).

        ``n_valid`` is the number of REAL tokens in the batch; without it
        every element counts, padding included. ``into``: the cache to
        fill (``generate`` passes its graph's), else a new one."""
        t0 = self._clock()
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits, cache = lm.prefill(self.cfg, self.params, toks, cache_len=self.max_len,
                                   ctx=self.ctx, cache=into)
        logits = logits[:, -1]
        self.stats.prefill_s += self._clock() - t0
        self.stats.prefill_tokens += int(tokens.size if n_valid is None else n_valid)
        return logits, cache

    def decode(self, cache: Any, tokens, *,
               active: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """One decode step (updates ``cache`` in place). ``tokens``: (B, 1)
        ids, on the host or the device. ``active`` counts the rows still
        generating; finished (post-EOS) rows ride along in the dense batch
        but must not inflate the decode tokens/s rate. On the graph's cache
        the logits are the graph's output, overwritten by the next step."""
        return self._decode(cache, tokens, active)[:2]

    def _decode(self, cache: Any, tokens, active: Optional[int]):
        """``decode``, and how the step ran: "capture", "replay" or "eager"."""
        t0 = self._clock()
        toks = (tokens if isinstance(tokens, torch.Tensor)
                else torch.as_tensor(np.asarray(tokens))).to(self.device)
        g = self._graph
        st = self.stats
        if g is not None and g.owns(cache) and g.warm:
            g.tokens.copy_(toks)
            mode = "replay"
            if g.graph is None:
                g.capture(self.cfg, self.params)
                st.decode_graph_captures += 1
                mode = "capture"
            logits = g.replay()
            cache = dict(cache, length=cache["length"] + 1)
            st.decode_graph_replays += 1
        else:
            logits, cache = lm.decode_step(self.cfg, self.params, cache, toks, ctx=self.ctx)
            logits = logits[:, -1]
            if g is not None and g.owns(cache):
                g.warm = True
            mode = "eager"
            st.decode_eager_steps += 1
        st.decode_host_s += time.perf_counter() - t0
        st.decode_s += self._clock() - t0
        st.decode_tokens += int(toks.shape[0] if active is None else active)
        return logits, cache, mode

    # -- paged KV prefix path ------------------------------------------

    def register_prefix(self, template_id: str, cache: Any, prefix_len: int) -> bool:
        """Copy the first ``prefix_len`` cached positions of batch row 0 (the
        template prefix is identical across rows by construction) into the
        page pool under ``template_id``. Call right after the full prefill
        that built ``cache``, before decode writes into it. Under a mesh:
        row 0 of the rank's rows, the rank's block of it."""
        if self.kv_prefix is None:
            return False
        k, v = lm.prefix_of(self.cfg, cache, self.ctx)
        try:
            self.kv_prefix.put(template_id, k, v, length=prefix_len)
        except PagePoolExhausted:
            # registration is best-effort: the full prefill already served
            # this request; a pool too small (or a still-leased stale
            # entry) just means the next hit pays prefill again
            return False
        return True

    def prefill_with_prefix(
        self, template_id: str, suffix_tokens: np.ndarray, *,
        n_valid: Optional[int] = None, expected_len: Optional[int] = None,
        into: Optional[Dict[str, Any]] = None,
    ) -> Optional[Tuple[torch.Tensor, Any]]:
        """Prefill only the adaptation suffix; the template prefix K/V is
        gathered from the page pool. Returns None when the prefix isn't
        cached (the caller falls back to a full prefill + register_prefix).

        ``expected_len`` is the prefix length the caller split the prompt at
        (the cache point). A pooled prefix of another length (a stale
        registration, a re-tokenized template) would shift every suffix
        position and the attention mask, so it is treated as a miss.
        ``into`` as for ``prefill``."""
        if self.kv_prefix is None:
            return None
        lease = self.kv_prefix.acquire(template_id)
        if lease is None:
            return None
        if expected_len is not None and lease.length != expected_len:
            self.kv_prefix.release_lease(lease)
            return None
        try:
            B = suffix_tokens.shape[0]
            t0 = self._clock()  # the page gather is device work of this prefill
            pk, pv, plen = self.kv_prefix.gather(lease, batch=B)
            toks = torch.as_tensor(np.asarray(suffix_tokens), device=self.device)
            logits, cache = lm.prefill_extend(self.cfg, self.params, toks, pk, pv, plen,
                                              cache_len=self.max_len, ctx=self.ctx, cache=into)
            logits = logits[:, -1]
            self.stats.prefill_s += self._clock() - t0
            self.stats.prefill_tokens += int(
                suffix_tokens.size if n_valid is None else n_valid)
            self.stats.prefix_tokens_reused += B * self._n_dp() * plen
            return logits, cache
        finally:
            self.kv_prefix.release_lease(lease)

    def generate(
        self,
        tokens: np.ndarray,
        max_new: int = 32,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        prompt_lengths: Optional[np.ndarray] = None,
        cache_point: Optional[CachePoint] = None,
    ) -> np.ndarray:
        """Batched generation. Returns (B, <=max_new) generated ids.

        Rows that hit ``eos_id`` emit ``pad_id`` from the next step on and
        stop counting toward decode throughput. ``prompt_lengths`` ((B,)
        valid prompt token counts) keeps right-padding out of the prefill
        rate. ``cache_point`` routes the prefill through the paged KV prefix
        cache: suffix-only prefill on a pool hit, full prefill + prefix
        registration on a pool miss."""
        B, S = tokens.shape
        if S + max_new > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) exceeds the engine's "
                f"KV capacity (max_len={self.max_len}); decode would write "
                f"past the cache"
            )
        n_valid = None if prompt_lengths is None else int(np.sum(prompt_lengths))
        tokens = self._rows(tokens)  # under a mesh: this rank's rows
        B = tokens.shape[0]
        with trace_span(SPAN_ENGINE_GENERATE, batch=B, prompt_len=S, max_new=max_new,
                        arch=self.cfg.name) as sp:
            res = None
            use_prefix = cache_point is not None and self.kv_prefix is not None
            into = self._graph_cache(B)
            with trace_span(SPAN_ENGINE_PREFILL, batch=B, tokens=S) as pre:
                if use_prefix:
                    n_suf = None if n_valid is None else n_valid - B * cache_point.prefix_len
                    res = self.prefill_with_prefix(
                        cache_point.template_id, tokens[:, cache_point.prefix_len:],
                        n_valid=n_suf, expected_len=cache_point.prefix_len, into=into)
                    pre.set(prefix="miss" if res is None else "hit")
                else:
                    pre.set(prefix="none")
                if res is None:
                    res = self.prefill(tokens, n_valid=n_valid, into=into)
                    if use_prefix:
                        self.register_prefix(cache_point.template_id, res[1],
                                             cache_point.prefix_len)
            logits, cache = res
            gen = None
            if temperature > 0.0:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            out = []
            feed = sample_token(logits, temperature, gen)  # the next step's ids, on the device
            tok = feed.cpu().numpy()
            done = np.zeros((B,), bool)
            for i in range(max_new):
                if eos_id is not None and done.any():
                    # finished rows keep a slot in the dense batch but must
                    # emit padding, not whatever the sampler drew for them
                    tok = np.where(done[:, None], pad_id, tok).astype(tok.dtype)
                    feed = tok
                out.append(tok)
                if eos_id is not None:
                    done |= tok[:, 0] == eos_id
                    if self._all_done(done):
                        break
                if i + 1 == max_new:
                    break  # the last token is emitted; skip the wasted decode
                active = int(B - done.sum())
                with trace_span(SPAN_ENGINE_DECODE_STEP, step=i, active=active) as ds:
                    logits, cache, mode = self._decode(cache, feed, active)
                    ds.set(**{ATTR_DECODE_GRAPH: mode})
                feed = sample_token(logits, temperature, gen)
                tok = feed.cpu().numpy()
            sp.set(new_tokens=len(out))
            return self._whole(np.concatenate(out, axis=1))

    def _all_done(self, done: np.ndarray) -> bool:
        """Every row finished (under a mesh: on every dp rank, so the ranks
        stop in lockstep)."""
        if self.ctx is None or not self.ctx.dp:
            return bool(done.all())
        left = torch.tensor([int((~done).sum())], device=self.device)
        return int(mc.psum(left, self.mesh, self.ctx.dp)) == 0

    def measured_rates(self) -> Dict[str, float]:
        r = self.stats.rates()
        r["rtt"] = 0.0  # local serving: no API round-trip
        return r
