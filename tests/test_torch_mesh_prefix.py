"""The KV prefix path under a mesh: ``Engine(mesh=, kv_prefix=)``,
``lm.prefill_extend(ctx=)`` and the page pool of a rank's layout, on 4 gloo
ranks on the CPU (meshes (1, 4) and (2, 2) over ("data", "model"), one spawn
each, under its own timeout), against ``repro``'s unsharded
``Engine(kv_prefix=)`` at smoke size in fp32.

The archs cover the layouts the pool and the cache take: olmo-1b (kv heads
split over tp: the rank's pages are its heads, read in place), qwen2.5-3b
(2 kv heads: at tp 4 the pool splits the head dim and the rank gathers its
kv head; its profile shards the cache's sequence), granite-moe-1b-a400m in
mode "ep" at capacity factor 8 (expert parallelism inside the extension,
nothing dropped, so the reference's dropless path is the oracle; a
sequence-sharded cache) and qwen2-vl-7b (M-RoPE on text positions)."""

import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.mesh import spawn_local  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 120
ARCHS = ["olmo-1b", "qwen2.5-3b", "granite-moe-1b-a400m", "qwen2-vl-7b"]
MESHES = [(1, 4), (2, 2)]
B, SP, SS, NEW, MAX_LEN = 4, 16, 8, 6, 40
PAGES, PAGE_SIZE = 16, 8
REL_TOL = 1e-4  # of the reference's largest |logit|: fp32 on both sides, sums in another order
PREFIX_TOL = 2e-4  # prefix path against the full prefill (test_torch_kv_cache.py's bound)


def _jcfg(arch):
    cfg = dataclasses.replace(jreg.get_smoke(arch), dtype="float32", param_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, mode="ep",
                                                               capacity_factor=8.0))
    return cfg


def _cases():
    sys.path.insert(0, HERE)
    import torch_mesh_cases

    return torch_mesh_cases


def _reference(arch, params, toks):
    """The reference engine's full-prefill logits, its prefix path's greedy
    tokens and logits step by step, and generate() through a cache point
    (miss, then hit)."""
    cfg = _jcfg(arch)
    eng = JEngine(cfg, params, max_len=MAX_LEN, kv_prefix=jkv.KVPrefixCache(
        jkv.pool_for_config(cfg, num_pages=PAGES, page_size=PAGE_SIZE)))
    full, cache = eng.prefill(toks)
    assert eng.register_prefix("tpl", cache, SP)
    logits, cache = eng.prefill_with_prefix("tpl", toks[:, SP:])
    steps, tokens = [np.asarray(logits)], []
    for i in range(NEW):
        tok = np.argmax(np.asarray(logits), -1)[:, None].astype(np.int32)
        tokens.append(tok)
        if i + 1 == NEW:
            break
        logits, cache = eng.decode(cache, tok)
        steps.append(np.asarray(logits))
    cp = jkv.CachePoint("gen", SP)
    miss = eng.generate(toks, NEW, cache_point=cp)
    hit = eng.generate(toks, NEW, cache_point=cp)
    return {"full": np.asarray(full), "prefix": np.stack(steps),
            "forced": np.concatenate(tokens, 1), "gen_miss": np.asarray(miss),
            "gen_hit": np.asarray(hit), "reused": eng.stats.prefix_tokens_reused}


def _reference_stream(arch, params, toks):
    """The lockstep stream of ``torch_mesh_cases.prefix_cases`` on the
    reference's unsharded pool: (op, id, result, keys, free pages) each."""
    cfg = _jcfg(arch)
    kv = jkv.KVPrefixCache(jkv.pool_for_config(cfg, num_pages=6, page_size=8))
    eng = JEngine(cfg, params, max_len=MAX_LEN, kv_prefix=kv)
    _, cache = eng.prefill(toks)
    out = []

    def keys():
        return list(kv._entries)  # the reference keeps no public listing

    for tid in ("a", "b", "c"):
        out.append(("put", tid, eng.register_prefix(tid, cache, 16), keys(),
                    kv.pool.free_pages))
    lease = kv.acquire("a")
    for tid in ("d", "e"):
        out.append(("put", tid, eng.register_prefix(tid, cache, 16), keys(),
                    kv.pool.free_pages))
    kv.release_lease(lease)
    out.append(("release", "a", kv.release("a"), keys(), kv.pool.free_pages))
    return out


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    archs, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _jcfg(arch)
        params = jlm.init_params(cfg, jax.random.PRNGKey(i))
        toks = rng.integers(0, cfg.vocab_size, (B, SP + SS)).astype(np.int32)
        toks[:, :SP] = toks[0, :SP]  # one template prefix across the rows
        refs[arch] = _reference(arch, params, toks)
        archs[arch] = {"params": jax.tree.map(np.asarray, params), "toks": toks, "Sp": SP,
                       "forced": refs[arch]["forced"]}
    first = ARCHS[0]
    refs["stream"] = _reference_stream(first, jlm.init_params(_jcfg(first),
                                                              jax.random.PRNGKey(0)),
                                       archs[first]["toks"])
    ranks = {}
    for shape in MESHES:
        data = {"shape": shape, "archs": archs, "pages": PAGES, "page_size": PAGE_SIZE,
                "max_len": MAX_LEN, "new": NEW}
        ranks[shape] = spawn_local(_cases().prefix_cases, 4, args=(data,),
                                   timeout_s=SPAWN_TIMEOUT_S)
    return ranks, refs


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_path_under_mesh_matches_reference(run, arch, shape):
    """On every rank: the greedy tokens of generate() through a cache point
    (the miss that registers, then the hit that extends) equal the
    reference engine's; the prefix path's logits, step by step under the
    reference's greedy tokens, within REL_TOL of its largest; and the
    global batch's reused prefix tokens counted as the reference counts
    them."""
    ranks, refs = run
    ref = refs[arch]
    for r, out in enumerate(ranks[shape]):
        got = out[arch]
        np.testing.assert_array_equal(got["gen_miss"], ref["gen_miss"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["gen_hit"], ref["gen_hit"], err_msg=f"rank {r}")
        assert _rel(got["prefix"], ref["prefix"]) <= REL_TOL, (r, _rel(got["prefix"],
                                                                       ref["prefix"]))
        assert _rel(got["full"], ref["full"]) <= REL_TOL
        assert got["reused"] == B * SP
        assert got["cache_len"] == SP + SS


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_path_equals_full_prefill_on_the_mesh(run, arch, shape):
    """The suffix-only prefill from the rank's pages gives the same mesh's
    full-prefill logits within PREFIX_TOL, the bound the unsharded twin
    holds (test_torch_kv_cache.py)."""
    ranks, _ = run
    for out in ranks[shape]:
        np.testing.assert_allclose(out[arch]["prefix"][0], out[arch]["full"],
                                   atol=PREFIX_TOL, rtol=PREFIX_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pools_decide_alike_and_hold_a_tp_share(run, shape):
    """Every rank's pool made the same decisions (keys, free pages,
    refcounts, counters); its pages hold the rank's block (kv heads or
    head dim over tp), so its bytes are 1/tp of the unsharded pool's for
    the same geometry; a stale, wrong-length registration was refused on
    every rank, its lease given back."""
    ranks, _ = run
    tp = shape[1]
    for arch in ARCHS:
        cfg = dataclasses.replace(treg.get_smoke(arch), dtype="float32", param_dtype="float32")
        whole = tkv.pool_for_config(cfg, num_pages=PAGES, page_size=PAGE_SIZE, device="cpu")
        pools = [out[arch]["pool"] for out in ranks[shape]]
        assert all(p == pools[0] for p in pools), arch
        assert set(pools[0]["keys"]) == {"tpl", "gen", "stale"}
        assert pools[0]["lengths"]["stale"] == SP - 4
        for out in ranks[shape]:
            assert out[arch]["nbytes"] * tp == whole.nbytes, arch
            assert out[arch]["stale_refused"]
        # no lease left: every pinned page is held by its entry alone
        assert max(pools[0]["refcount"]) == 1


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lockstep_eviction_stream_matches_reference(run, shape):
    """A stream that fills a 6-page pool, pins one prefix with a lease and
    evicts by LRU: every rank's results, keys and free pages equal the
    reference's unsharded pool's, step by step."""
    ranks, refs = run
    for out in ranks[shape]:
        got = [(op, tid, res, st["keys"], st["free"]) for op, tid, res, st in out["stream"]]
        assert got == [tuple(x) for x in refs["stream"]]
