"""The engine's decode step as one CUDA graph (``serving/engine.py``) and
what it rests on in ``models/lm.py``: the position read from a device
tensor the cache carries, and prefills that fill a given cache.

On the CPU: the step from the device position matches ``repro``'s decode
through the clamp, a prefill into a used cache equals one into a new
cache over the prompt's positions, and the engine stays eager. On the card
(``python3 -m pytest -m card tests/test_torch_decode_graph.py``; skipped
without one): ``Engine.generate``'s tokens through the graph equal an eager
loop written here, at two layers of both benchmark cells' widths, and the
graph is captured once a batch size, replayed through a prefix hit, and
counted by the kernels' launch counters as an eager step is, which the
profiler's device trace of the replays confirms. JAX only inside the one
test that compares with the reference: the card's machine has none."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kernel_table  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.sampler import sample_token  # noqa: E402
from torch_card import card  # noqa: E402,F401

DENSE = ["olmo-1b", "qwen2.5-3b", "nemotron-4-15b", "qwen3-4b"]


def _close(t, j, tol=1e-4):
    """Within the f32 tolerance of the port's model tests
    (tests/test_torch_models.py)."""
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


def _smoke(arch, seed=0):
    cfg = registry.get_smoke(arch)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _garbage(cfg, rows, max_len, seed):
    """A cache whose every position holds something: a cache used before."""
    c = lm.init_cache(cfg, rows, max_len, "cpu")
    g = torch.Generator().manual_seed(seed)
    for k in ("kv_k", "kv_v"):
        c[k].copy_(torch.randn(c[k].shape, generator=g))
    c["length"] = 5
    c["pos"] = torch.tensor(5, dtype=torch.int32)
    return c


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("carried", [True, False])
def test_decode_through_the_clamp_matches_the_reference(arch, carried):
    """Ten steps from a 6-token prompt into 12 positions, the last five at
    slot M - 1 under the clamp, against ``repro``'s decode on the same
    weights (f32): logits at every step and the K/V after the last. The
    cache carries ``pos`` (prefilled into a cache that has one), which
    follows ``length``, or not (a new cache), and each step makes it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import lm as jlm

    kw = dict(vocab_size=50_304, dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jregistry.get_smoke(arch), **kw)
    cfg = dataclasses.replace(registry.get_smoke(arch), **kw)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    params = lm.params_from_jax(cfg, jax.tree.map(np.asarray, pj))
    toks = np.random.RandomState(3).randint(3, 500, (2, 16)).astype(np.int32)
    _, cj = jlm.prefill(jcfg, pj, {"tokens": jnp.asarray(toks[:, :6])}, cache_len=12)
    into = None
    if carried:
        into = dict(lm.init_cache(cfg, 2, 12, "cpu"), pos=torch.zeros((), dtype=torch.int32))
    _, ct = lm.prefill(cfg, params, torch.from_numpy(toks[:, :6]), cache_len=12, cache=into)
    assert ("pos" in ct) == carried
    step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
    for i in range(6, 16):
        lj, cj = step(pj, cj, jnp.asarray(toks[:, i:i + 1]))
        lt, ct = lm.decode_step(cfg, params, ct, torch.from_numpy(toks[:, i:i + 1]))
        assert ct["length"] == int(cj["length"]) == i + 1
        assert int(ct["pos"]) == i + 1 if carried else "pos" not in ct
        _close(lt, lj)
    for k in ("kv_k", "kv_v"):
        _close(ct[k], cj[k])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("path", ["prefill", "prefill_extend"])
def test_prefill_into_a_used_cache_equals_a_new_cache(arch, path):
    """Over the prompt's positions the given cache holds what a new one
    does; the logits are equal, ``length`` and ``pos`` are the prompt's."""
    cfg, params = _smoke(arch)
    rs = np.random.RandomState(4)
    toks = torch.as_tensor(rs.randint(3, 500, (2, 11)).astype(np.int32))
    used = _garbage(cfg, 2, 20, seed=5)
    if path == "prefill":
        want_l, want = lm.prefill(cfg, params, toks, cache_len=20)
        got_l, got = lm.prefill(cfg, params, toks, cache_len=20, cache=used)
    else:
        _, pc = lm.prefill(cfg, params, toks[:, :7])
        args = (cfg, params, toks[:, 7:], pc["kv_k"], pc["kv_v"], 7)
        want_l, want = lm.prefill_extend(*args, cache_len=20)
        got_l, got = lm.prefill_extend(*args, cache_len=20, cache=used)
    n = 11
    assert got is used
    assert torch.equal(got_l, want_l)
    assert got["length"] == want["length"] == n == int(got["pos"])
    for k in ("kv_k", "kv_v"):
        assert torch.equal(got[k][:, :, :n], want[k][:, :, :n])


def test_a_prefill_refuses_a_cache_too_small():
    cfg, params = _smoke("olmo-1b")
    toks = torch.ones((2, 11), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot take a prefill"):
        lm.prefill(cfg, params, toks, cache=lm.init_cache(cfg, 2, 8, "cpu"))
    with pytest.raises(ValueError, match="cannot take a prefill"):
        lm.prefill(cfg, params, toks, cache=lm.init_cache(cfg, 3, 20, "cpu"))


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m", "rwkv6-3b"])
def test_the_engine_on_the_cpu_stays_eager(arch):
    cfg, params = _smoke(arch)
    eng = Engine(cfg, params, max_len=40, device="cpu")
    toks = np.random.RandomState(5).randint(3, 500, (3, 9)).astype(np.int32)
    eng.generate(toks, max_new=6)
    eng.generate(toks[:2, :7], max_new=4)
    st = eng.stats
    assert (st.decode_eager_steps, st.decode_graph_captures, st.decode_graph_replays) == (8, 0, 0)
    assert eng._graph is None


def test_add_counts_undoes_and_repeats_a_difference():
    """What a capture counted comes off, then each replay adds it again; a
    breakdown keeps no zero entry."""
    fns = kernel_table.launchers()
    dec = fns["decode_attention"]
    saved = kernel_table.counts()
    try:
        kernel_table.reset_counts()
        dec.launches = 3
        dec.launches_by_hd[64] = 3
        before = kernel_table.counts()
        dec.launches += 2
        dec.launches_by_hd[128] += 2
        after = kernel_table.counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernel_table.add_counts(delta, sign=-1)
        assert kernel_table.counts() == before and 128 not in dec.launches_by_hd
        kernel_table.add_counts(delta)
        kernel_table.add_counts(delta)
        assert dec.launches == 7 and dec.launches_by_hd == {64: 3, 128: 4}
    finally:
        kernel_table.reset_counts()
        kernel_table.add_counts(saved)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# two layers of each benchmark cell's model at its published widths, at the
# cell's batch, its longest prompt and its tokens a call
CELLS = {"nemotron-4-15b": (16, 1549), "olmo-1b": (512, 245)}
MAX_NEW = 32


def _card_model(arch, device, layers=2, seed=0):
    cfg = dataclasses.replace(registry.get(arch), num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, lm.init_params(cfg, gen, device)


def _prompts(cfg, rows, n, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (rows, n)).astype(np.int32)


def _eager(cfg, params, logits, cache, n):
    """n greedy tokens from a prefill's last logits, one ``lm.decode_step``
    a token: (rows, n) on the host."""
    out = []
    tok = sample_token(logits[:, -1])
    for i in range(n):
        out.append(tok.cpu().numpy())
        if i + 1 < n:
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            tok = sample_token(logits[:, -1])
    return np.concatenate(out, axis=1)


def _eager_generate(cfg, params, prompts, max_len, device):
    toks = torch.as_tensor(prompts, device=device)
    logits, cache = lm.prefill(cfg, params, toks, cache_len=max_len)
    return _eager(cfg, params, logits, cache, MAX_NEW)


@pytest.mark.card
@pytest.mark.parametrize("arch", sorted(CELLS))
def test_graph_tokens_equal_an_eager_loop(card, arch):
    """The first call captures once (after one eager step) and replays the
    rest; its tokens and the decode kernel's launches, in total and by head
    dim, equal an eager loop's."""
    rows, n = CELLS[arch]
    cfg, params = _card_model(arch, card)
    max_len = n + MAX_NEW
    prompts = _prompts(cfg, rows, n, seed=11)
    dec = kernel_table.launchers()["decode_attention"]
    with torch.no_grad():
        kernel_table.reset_counts()
        want = _eager_generate(cfg, params, prompts, max_len, card)
        eager_counts = (dec.launches, dict(dec.launches_by_hd))
        eng = Engine(cfg, params, max_len=max_len, device=card)
        kernel_table.reset_counts()
        got = eng.generate(prompts, max_new=MAX_NEW)
    np.testing.assert_array_equal(got, want)
    steps = cfg.num_layers * (MAX_NEW - 1)
    assert eager_counts == (steps, {cfg.head_dim: steps})
    assert (dec.launches, dict(dec.launches_by_hd)) == eager_counts
    st = eng.stats
    assert (st.decode_eager_steps, st.decode_graph_captures, st.decode_graph_replays) == (
        1, 1, MAX_NEW - 2)


@pytest.mark.card
def test_prompt_lengths_share_a_graph_and_a_batch_size_captures_anew(card):
    """A shorter prompt after a longer one replays the same graph over the
    longer call's stale positions, with an eager loop's tokens; another
    batch size captures once more."""
    cfg, params = _card_model("olmo-1b", card)
    max_len = 245 + MAX_NEW
    eng = Engine(cfg, params, max_len=max_len, device=card)
    with torch.no_grad():
        eng.generate(_prompts(cfg, 64, 245, seed=1), max_new=MAX_NEW)
        short = _prompts(cfg, 64, 190, seed=2)
        got = eng.generate(short, max_new=MAX_NEW)
        want = _eager_generate(cfg, params, short, max_len, card)
        assert eng.stats.decode_graph_captures == 1
        other = _prompts(cfg, 8, 200, seed=3)
        got8 = eng.generate(other, max_new=MAX_NEW)
        want8 = _eager_generate(cfg, params, other, max_len, card)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got8, want8)
    st = eng.stats
    assert (st.decode_graph_captures, st.decode_eager_steps) == (2, 2)
    assert st.decode_graph_replays == 3 * (MAX_NEW - 1) - 2


@pytest.mark.card
def test_a_prefix_hit_decodes_through_the_graph(card):
    """A cache point's miss registers the template, its hit prefills the
    suffix from the pool into the graph's cache; both calls' tokens equal
    the eager loop's from the same prefill."""
    cfg, params = _card_model("olmo-1b", card)
    pool = tkv.pool_for_config(cfg, num_pages=64, page_size=16, device=card)
    eng = Engine(cfg, params, max_len=256, device=card, kv_prefix=tkv.KVPrefixCache(pool))
    rs = np.random.RandomState(6)
    tpl = rs.randint(0, cfg.vocab_size, (160,)).astype(np.int32)
    prompts = np.concatenate([np.broadcast_to(tpl, (8, 160)),
                              rs.randint(0, cfg.vocab_size, (8, 40)).astype(np.int32)], axis=1)
    cp = tkv.plan_cache_point("tpl", tpl, prompts)
    with torch.no_grad():
        miss = eng.generate(prompts, max_new=MAX_NEW, cache_point=cp)
        hit = eng.generate(prompts, max_new=MAX_NEW, cache_point=cp)
        want_miss = _eager_generate(cfg, params, prompts, 256, card)
        lease = eng.kv_prefix.acquire("tpl")
        pk, pv, plen = eng.kv_prefix.gather(lease, batch=8)
        suffix = torch.as_tensor(prompts[:, plen:], device=card)
        logits, cache = lm.prefill_extend(cfg, params, suffix, pk, pv, plen, cache_len=256)
        eng.kv_prefix.release_lease(lease)
        want_hit = _eager(cfg, params, logits, cache, MAX_NEW)
    assert eng.stats.prefix_tokens_reused == 8 * 160
    np.testing.assert_array_equal(miss, want_miss)
    np.testing.assert_array_equal(hit, want_hit)
    st = eng.stats
    assert (st.decode_graph_captures, st.decode_eager_steps) == (1, 1)
    assert st.decode_graph_replays == 2 * (MAX_NEW - 1) - 1


@pytest.mark.card
@pytest.mark.parametrize("arch", sorted(CELLS))
def test_the_replays_launch_what_the_counters_count(card, arch):
    """A call that only replays: the profiler's device trace holds one
    split-K chunk kernel of decode attention for every launch the engine
    added to ``decode_attention``'s counters, ``layers x (max_new - 1)``."""
    from torch.profiler import ProfilerActivity, profile

    rows, n = CELLS[arch]
    cfg, params = _card_model(arch, card)
    eng = Engine(cfg, params, max_len=n + MAX_NEW, device=card)
    dec = kernel_table.launchers()["decode_attention"]
    with torch.no_grad():
        eng.generate(_prompts(cfg, rows, n, seed=12), max_new=MAX_NEW)  # captures
        prompts = _prompts(cfg, rows, n, seed=13)
        replays = eng.stats.decode_graph_replays
        kernel_table.reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, max_new=MAX_NEW)
            torch.cuda.synchronize()
    chunks = sum(1 for e in prof.profiler.kineto_results.events()
                 if "decode_chunk_kernel" in e.name())
    steps = cfg.num_layers * (MAX_NEW - 1)
    assert eng.stats.decode_graph_replays - replays == MAX_NEW - 1
    assert (dec.launches, dict(dec.launches_by_hd)) == (steps, {cfg.head_dim: steps})
    assert chunks == steps
