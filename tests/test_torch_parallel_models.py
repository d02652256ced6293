"""Every family's sharded prefill and decode, and ``Engine(mesh=)``, on 8
gloo ranks on the CPU (mesh (2, 4) over ("data", "model"), each arch under
its serving profile ``get_sharding(arch)``: tensor parallelism over model,
the batch over data, FSDP where the profile has it), against ``repro``'s
unsharded ``lm.prefill`` / ``lm.decode_step`` and its ``Engine`` at smoke
size in fp32. One spawn for the module, with its own timeout.

The archs cover each layout the port shards: heads split evenly (olmo),
kv heads below the tp extent and a sequence-sharded cache (qwen2.5-3b),
qk-norm (qwen3), GShard experts (granite) and expert parallelism in the
model (kimi-k2 at capacity factor 8, so that nothing drops and the
reference's dropless path is the oracle), M-RoPE positions (3, B, S) split
on their batch axis (qwen2-vl), the rwkv6 and mamba2 mixers (rwkv6-3b,
zamba2-2.7b) and the encoder-decoder with cross-attention (whisper)."""

import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.mesh import spawn_local  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 120
TOL = 1e-4  # fp32 on both sides: summation order only (test_torch_models.py's)
ARCHS = ["olmo-1b", "qwen2.5-3b", "qwen3-4b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b",
         "qwen2-vl-7b", "rwkv6-3b", "zamba2-2.7b", "whisper-tiny"]
B, S, CACHE = 4, 8, 16


def _jcfg(arch):
    cfg = dataclasses.replace(jreg.get_smoke(arch), dtype="float32", param_dtype="float32")
    if arch == "kimi-k2-1t-a32b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _port_kw(arch):
    if arch != "kimi-k2-1t-a32b":
        return {}
    moe = treg.get_smoke(arch).moe
    return {"moe": dataclasses.replace(moe, capacity_factor=8.0)}


def _inputs(arch, cfg, rng):
    if cfg.family == "vlm":
        pos = np.stack([np.arange(S)[None].repeat(B, 0) + i for i in range(3)]).astype(np.int32)
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "positions": pos}
    x = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        x["frames"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return x


def _case(name):
    sys.path.insert(0, HERE)
    import torch_parallel_cases

    return getattr(torch_parallel_cases, name)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    fams, refs = {}, {}
    for arch in ARCHS:
        cfg = _jcfg(arch)
        params = jlm.init_params(cfg, jax.random.PRNGKey(1))
        inputs = _inputs(arch, cfg, rng)
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        fams[arch] = {"params": jax.tree.map(np.asarray, params), "inputs": inputs,
                      "next": nxt, "cache_len": CACHE, "cfg": _port_kw(arch)}
    jcfg = _jcfg("olmo-1b")
    eng_params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    prompts = rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int32)
    data = {"families": fams,
            "engine": {"params": jax.tree.map(np.asarray, eng_params), "prompts": prompts,
                       "max_new": 8}}
    ranks = spawn_local(_case("model_cases"), 8, args=(data,), timeout_s=SPAWN_TIMEOUT_S)
    for arch in ARCHS:  # the reference, unsharded
        cfg, case = _jcfg(arch), fams[arch]
        batch = {k: jnp.asarray(v) for k, v in case["inputs"].items()}
        logits, cache = jlm.prefill(cfg, jax.tree.map(jnp.asarray, case["params"]), batch,
                                    cache_len=CACHE)
        p = jax.tree.map(jnp.asarray, case["params"])
        dec, cache = jlm.decode_step(cfg, p, cache, jnp.asarray(case["next"]))
        dec2, _ = jlm.decode_step(cfg, p, cache, jnp.asarray(case["next"]))
        refs[arch] = {"prefill": np.asarray(logits), "decode": np.asarray(dec),
                      "decode2": np.asarray(dec2)}
    refs["engine"] = JEngine(jcfg, eng_params, max_len=64).generate(prompts, 8)
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(run, arch):
    """Prefill logits and two decode steps' logits, gathered over dp, within
    the fp32 tolerance of the reference's unsharded model, on every rank."""
    ranks, refs = run
    for r, out in enumerate(ranks):
        for name in ("prefill", "decode", "decode2"):
            np.testing.assert_allclose(out[arch][name], refs[arch][name], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
def test_attention_launches_at_local_heads(run, arch):
    """The count the card's phase 11 pins, here from the CPU run: a prefill
    calls flash once a layer and a decode step decode once a layer, on each
    rank, at the rank's heads: 1 q / 1 kv of the smoke 4 / 4 over tp 4
    (olmo); qwen2.5-3b's 2 kv heads do not split 4 ways, so each rank reads
    the one kv head its q head groups with."""
    ranks, _ = run
    L = treg.get_smoke(arch).num_layers
    for out in ranks:
        assert out[arch]["calls"] == {"flash": {"1/1": L}, "decode": {"1/1": 2 * L}}


def test_engine_with_mesh_matches_reference_greedy(run):
    """Engine(mesh=, profile=) on smoke olmo: every rank returns the whole
    batch's greedy tokens, equal to the reference engine's."""
    ranks, refs = run
    for out in ranks:
        np.testing.assert_array_equal(out["engine"], np.asarray(refs["engine"]))


def test_model_collectives_counted(run):
    """The model path ran its collectives through the backend: psum (row
    shards, the embedding), all_gather (logits, FSDP, the caches) and
    all_to_all (kimi's experts)."""
    ranks, _ = run
    c = ranks[0]["counters"]
    for kind in ("psum", "all_gather", "all_to_all"):
        assert c[kind]["calls"] > 0 and c[kind]["bytes"] > 0, kind
