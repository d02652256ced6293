"""Sequence parallelism (``ShardingProfile.seq_parallel``) and remat "dots"
on 4 gloo ranks on the CPU (mesh (2, 2) over ("data", "model"), one spawn
under its own timeout), against ``repro``'s unsharded prefill, decode and
train step at smoke size in fp32.

Under sequence parallelism the residual stream between sublayers is each
rank's half of the sequence (padded to a multiple of tp where the length is
odd): a layout of the same function, as in the reference, so the sharded
results are held to the unsharded reference's with the fp32 bound of the
other sharded tests (summation order only). Remat "dots" keeps the matrix
products of a layer and recomputes the rest in the backward: the same
gradients as without remat, with the forward's products not run again."""

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
from repro.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro.training.train_step import loss_fn as jloss_fn  # noqa: E402
from repro.training.train_step import make_train_step  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.mesh import spawn_local  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 120
TOL = 1e-4  # fp32 on both sides, sums in another order (the sharded tests' bound)
GRAD_TOL = 1e-6  # "dots" against "none": the same operations, the products read back
ARCHS = ["olmo-1b", "qwen2.5-3b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b"]
SEQS = (8, 7)  # a multiple of tp 2, and one that is not
# the families whose loss gradients are held under tp and sp (olmo's are by
# the train step's); granite in its own GShard mode, whose load-balancing
# loss is the global batch's under a mesh (expert parallelism averages the
# ranks' losses, as the reference's own EP does)
GRAD_ARCHS = ["qwen2.5-3b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b"]
B = 4


def _jcfg(arch, ep=True):
    cfg = dataclasses.replace(jreg.get_smoke(arch), dtype="float32", param_dtype="float32")
    if cfg.moe is not None and ep:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, mode="ep",
                                                               capacity_factor=8.0))
    return cfg


def _cases():
    sys.path.insert(0, HERE)
    import torch_mesh_cases

    return torch_mesh_cases


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(3)
    prefill, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _jcfg(arch)
        params = jlm.init_params(cfg, jax.random.PRNGKey(10 + i))
        toks = {S: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for S in SEQS}
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        prefill[arch] = {"params": jax.tree.map(np.asarray, params), "tokens": toks,
                         "next": nxt}
        for S, t in toks.items():
            logits, cache = jlm.prefill(cfg, params, {"tokens": jnp.asarray(t)}, cache_len=S + 1)
            dec, _ = jlm.decode_step(cfg, params, cache, jnp.asarray(nxt))
            refs[f"{arch}/{S}"] = {"prefill": np.asarray(logits), "decode": np.asarray(dec)}
    jcfg = _jcfg("olmo-1b")
    olmo = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    seqs = {S: rng.integers(10, 400, (B, S + 1)).astype(np.int32) for S in SEQS}
    opt_cfg = AdamWConfig(lr=1e-3)
    step = jax.jit(make_train_step(jcfg, opt_cfg))
    for S, seq in seqs.items():
        batch = {"tokens": jnp.asarray(seq[:, :-1]), "labels": jnp.asarray(seq[:, 1:])}
        p1, _, m1 = step(olmo, adamw_init(olmo, opt_cfg), batch)
        refs[f"train/{S}"] = {"loss": float(m1["loss"]), "params": [
            np.asarray(t) for t in tree_leaves(tlm.params_from_jax(
                treg.get_smoke("olmo-1b"), jax.tree.map(np.asarray, p1)))]}
    grads = {}
    for i, arch in enumerate(GRAD_ARCHS):
        cfg = _jcfg(arch, ep=False)
        params = jlm.init_params(cfg, jax.random.PRNGKey(20 + i))
        seq = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
        grads[arch] = {"params": jax.tree.map(np.asarray, params), "seq": seq}
        batch = {"tokens": jnp.asarray(seq[:, :-1]), "labels": jnp.asarray(seq[:, 1:])}
        (loss, _), g = jax.value_and_grad(lambda p: jloss_fn(cfg, p, batch),
                                          has_aux=True)(params)
        refs[f"grads/{arch}"] = {"loss": float(loss), "grads": [
            np.asarray(t) for t in tree_leaves(tlm.params_from_jax(
                treg.get_smoke(arch), jax.tree.map(np.asarray, g)))]}
    data = {"prefill": prefill, "olmo_params": jax.tree.map(np.asarray, olmo), "train": seqs,
            "grads": grads}
    ranks = spawn_local(_cases().seqpar_cases, 4, args=(data,), timeout_s=SPAWN_TIMEOUT_S)
    return ranks, refs


def _rel(a, b):
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_prefill_matches_reference(run, arch, S):
    """The sequence-parallel prefill's logits, and a decode step from its
    cache, gathered over dp, within TOL of the reference's unsharded ones on
    every rank; equal, within TOL, to the same mesh without it."""
    ranks, refs = run
    for out in ranks:
        sp, tp = out[f"{arch}/{S}/sp"], out[f"{arch}/{S}/tp"]
        assert _rel(sp["logits"], refs[f"{arch}/{S}"]["prefill"]) <= TOL
        assert _rel(sp["decode"], refs[f"{arch}/{S}"]["decode"]) <= TOL
        assert _rel(sp["logits"], tp["logits"]) <= TOL


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b", "rwkv6-3b", "zamba2-2.7b"])
def test_seq_parallel_reduce_scatters_in_place_of_psums(run, arch):
    """Each tp psum of a row-parallel output (the embedding, attention's
    W_o, the MLP's W_down, the mixers' out projections) becomes one
    reduce-scatter over the sequence, and a gather of the sequence feeds
    each sublayer: the prefill without seq_parallel runs psums and no
    reduce-scatter; with it, as many reduce-scatters as the psums it
    replaces."""
    ranks, _ = run
    for S in SEQS:
        tp, sp = ranks[0][f"{arch}/{S}/tp"]["counts"], ranks[0][f"{arch}/{S}/sp"]["counts"]
        assert "reduce_scatter" not in tp and tp["psum"] > 0
        replaced = tp["psum"] - sp.get("psum", 0)
        assert replaced > 0 and sp["reduce_scatter"] == replaced
        assert sp["all_gather"] > tp.get("all_gather", 0)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("name", ["sp", "dots"])
def test_train_step_matches_reference(run, name, S):
    """One AdamW step of olmo smoke on (2, 2) under seq_parallel, and under
    remat "dots": loss and every parameter within TOL of the reference's
    unsharded step (tests/test_distributed.py's bound)."""
    ranks, refs = run
    ref = refs[f"train/{S}"]
    for out in ranks:
        got = out[f"train/{name}/{S}"]
        assert abs(got["loss"] - ref["loss"]) < TOL
        d = max(float(np.abs(a - b).max()) for a, b in zip(got["params"], ref["params"]))
        assert d < TOL, d


@pytest.mark.parametrize("mode", ["tp", "sp"])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_match_reference(run, arch, mode):
    """The loss and every parameter's gradient (reduced over dp, gathered)
    on (2, 2) under tensor parallelism, and with seq_parallel, within TOL
    of the larger of 1 and the reference's largest |gradient|. The norms'
    weights, used on the rank's sequence block under seq_parallel, have
    their gradients summed over tp; zamba2's gated norm sums its squares
    over tp, and each rank's partial sum takes the whole cotangent."""
    ranks, refs = run
    ref = refs[f"grads/{arch}"]
    for out in ranks:
        got = out[f"grads/{arch}/{mode}"]
        assert abs(got["loss"] - ref["loss"]) < TOL
        assert len(got["grads"]) == len(ref["grads"])
        for a, b in zip(got["grads"], ref["grads"]):
            assert _rel(a, b) <= TOL, _rel(a, b)


def test_remat_dots_keeps_products_and_recomputes_the_rest(run):
    """On every rank: "dots" gives the gradients of "none" within GRAD_TOL;
    its backward runs no more matrix products than "none"'s (the
    forward's are read back) and fewer than "full"'s (which recomputes
    them), and as many other ops as "full"'s (the elementwise work is
    recomputed), more than "none"'s; its rerun repeats the forward's
    psums, as "full"'s does."""
    ranks, _ = run
    for out in ranks:
        none, dots, full = (out[f"remat/{m}"] for m in ("none", "dots", "full"))
        assert none["loss"] == dots["loss"] == full["loss"]
        for a, b in zip(dots["grads"], none["grads"]):
            assert float(np.abs(a - b).max()) <= GRAD_TOL
        assert dots["bwd"][0] == none["bwd"][0] < full["bwd"][0]
        # the layers' products are rerun; the head's, outside them, are not
        assert full["bwd"][0] - none["bwd"][0] < none["fwd"][0]
        assert dots["bwd"][1] == full["bwd"][1] > none["bwd"][1]
        assert dots["bwd_psum"] == full["bwd_psum"] > none["bwd_psum"]
