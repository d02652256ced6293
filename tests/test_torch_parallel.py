"""The port's multi-device layer against ``repro``'s, on 8 gloo ranks on the
CPU (``repro_torch.launch.mesh.spawn_local``, one spawn for the module,
its own timeout): the sharded train step (with and without remat),
expert parallelism (dropless, capacity-limited, on the fp8 wire and in
dispatch chunks), the int8 all-reduce on the host mesh, the GPipe pipeline,
and elastic resharding of parameters and of the AdamW state. The model families' sharded prefill and
decode and ``Engine(mesh=)`` are in ``test_torch_parallel_models.py``.

Weights are drawn by ``repro``'s inits and cross through
``params_from_jax``; inputs come from numpy seeds. The reference's
expert-parallel and all-reduce outputs come from a subprocess with 8 forced
host devices (its own mesh runs), started before the ranks so the two
overlap; everything else from the reference runs in this process."""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.distributed.pipeline import sequential_reference  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro.training.train_step import make_train_step  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.mesh import spawn_local  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SPAWN_TIMEOUT_S = 120
# the fp8 wire: both sides quantize the same fp32 rows to e4m3 with a
# per-row scale and sum in fp32; a product that lands within rounding of an
# e4m3 tie may round the other way on the way back (one e4m3 step, 1/8 of
# the row's scale, times a routing weight <= 1)
FP8_TOL = 1e-3

JEP = JModelConfig(name="t", family="moe", num_layers=1, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
                   moe=JMoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32,
                                  capacity_factor=8.0, mode="ep"),
                   param_dtype="float32", dtype="float32")

REF_SCRIPT = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.base import ModelConfig, MoEConfig
from repro.distributed.mesh_compat import make_mesh, set_mesh, shard_map
from repro.models import moe
from repro.training.grad_compress import compressed_allreduce, ef_state_init
d = dict(np.load(sys.argv[1]))
cfg = ModelConfig(name='t', family='moe', num_layers=1, d_model=64, num_heads=4,
                  num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
                  moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32,
                                capacity_factor=1.25, mode='ep'),
                  param_dtype='float32', dtype='float32')
p = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith('p_')}
x = jnp.asarray(d['x'])
mesh = make_mesh((2, 4), ('data', 'model'))
out = {}
for name, c in (('ep125', cfg), ('epfp8', dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, a2a_dtype='float8_e4m3fn'))),
                ('epch2', dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch_chunks=2)))):
    with set_mesh(mesh):
        y, aux = jax.jit(lambda p, x, c=c: moe.moe_forward_ep(
            c, p, x, mesh=mesh, ep_axis='model', dp_axes=('data',)))(p, x)
    out[name + '_y'] = np.asarray(y)
    out[name + '_aux'] = np.asarray(aux)
mesh8 = make_mesh((8,), ('data',))
g = jnp.asarray(d['grads'])
ef = ef_state_init({'w': g[0]})
fn = shard_map(lambda g, ef: compressed_allreduce({'w': g}, ef, 'data'), mesh=mesh8,
               in_specs=(P('data', None), P()), out_specs=(P(), P('data', None)),
               check_vma=False)
with set_mesh(mesh8):
    red, new_ef = fn(g, ef)
out['ar_out'] = np.asarray(red['w'])
out['ar_ef'] = np.asarray(new_ef['w'])
np.savez(sys.argv[2], **out)
"""


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def run():
    """(rank 0's results, every rank's, the reference's values)."""
    rng = np.random.default_rng(0)
    # inputs
    ep_params = _np_tree(jmoe.moe_init(JEP, jax.random.PRNGKey(0)))
    ep_x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    grads = (np.arange(8 * 512, dtype=np.float32).reshape(8, 512) / 100)
    tmp = tempfile.mkdtemp(prefix="ref_ep_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(inp, x=ep_x, grads=grads, **{f"p_{k}": v for k, v in ep_params.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), inp, outp],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    jcfg = dataclasses.replace(jreg.get_smoke("olmo-1b"), dtype="float32",
                               param_dtype="float32")
    olmo = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.RandomState(0).randint(10, 400, size=(8, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    qcfg = dataclasses.replace(jreg.get_smoke("qwen2.5-3b"), dtype="float32",
                               param_dtype="float32")
    qwen = jlm.init_params(qcfg, jax.random.PRNGKey(0))
    ws = (rng.standard_normal((8, 16, 16)) * 0.1).astype(np.float32)
    px = rng.standard_normal((8, 16)).astype(np.float32)
    data = {"olmo_params": _np_tree(olmo), "olmo_batch": batch, "ep_params": ep_params,
            "ep_x": ep_x, "ar_grads": grads, "pipe_ws": ws, "pipe_x": px,
            "qwen_params": _np_tree(qwen)}
    try:
        ranks = spawn_local(_case("train_cases"), 8, args=(data,), timeout_s=SPAWN_TIMEOUT_S)
        # the reference, in this process
        opt_cfg = AdamWConfig(lr=1e-3)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        p1, _, m1 = jax.jit(make_train_step(jcfg, opt_cfg))(olmo, adamw_init(olmo, opt_cfg), jb)
        y_grouped, _ = jmoe.moe_forward_grouped(JEP, jax.tree.map(jnp.asarray, ep_params),
                                                jnp.asarray(ep_x))

        def layer_fn(w, h):
            return jnp.tanh(h @ w) + h

        pref = sequential_reference(layer_fn, jnp.asarray(ws), jnp.asarray(px))
        gref = jax.grad(lambda w: jnp.sum(sequential_reference(layer_fn, w,
                                                               jnp.asarray(px)) ** 2))(
            jnp.asarray(ws))
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
        assert proc.returncode == 0, stderr[-3000:]
        sub = dict(np.load(outp))
    finally:
        if proc.poll() is None:
            proc.kill()
    ref = {"loss": float(m1["loss"]),
           "params": [np.asarray(t) for t in tree_leaves(
               tlm.params_from_jax(treg.get_smoke("olmo-1b"), _np_tree(p1)))],
           "grouped": np.asarray(y_grouped), "pipe_y": np.asarray(pref),
           "pipe_g": np.asarray(gref), "qwen": _np_tree(qwen), "grads": grads, **sub}
    return ranks[0], ranks, ref


def _case(name):
    sys.path.insert(0, HERE)
    import torch_parallel_cases

    return getattr(torch_parallel_cases, name)


@pytest.mark.parametrize("kind", ["", "train"])
def test_sharded_train_step_matches_single_device(run, kind):
    """olmo smoke fp32 on (2, 4), batch 8 x 17: loss and every parameter
    after one AdamW step against the reference's single-device step, <= 1e-4
    (tests/test_distributed.py's bound); the serving profile (TP over model)
    and the train profile (FSDP over data and model, model as extra dp)."""
    r0, ranks, ref = run
    assert abs(r0[f"train{kind}/loss"] - ref["loss"]) < 1e-4
    assert len(r0[f"train{kind}/params"]) == len(ref["params"])
    d = max(float(np.abs(a - b).max()) for a, b in zip(r0[f"train{kind}/params"],
                                                      ref["params"]))
    assert d < 1e-4, d
    for r in ranks[1:]:  # every rank ends with the same loss
        assert r[f"train{kind}/loss"] == r0[f"train{kind}/loss"]


def test_remat_recomputes_layers(run):
    """The olmo profiles' remat "full" reruns each layer in the backward
    (its psums run again) and changes no number: the serving profile's step
    with remat equals the one without, bit for bit."""
    r0, ranks, _ = run
    assert r0["train/psum_calls"] > 0
    assert r0["train/psum_calls"] > r0["trainnoremat/psum_calls"]
    assert r0["train/loss"] == r0["trainnoremat/loss"]
    for a, b in zip(r0["train/params"], r0["trainnoremat/params"]):
        assert np.array_equal(a, b)


def test_ep_dropless_matches_grouped(run):
    """moe_forward_ep on (2, 4) at capacity_factor 8 against the reference's
    moe_forward_grouped (tests/test_distributed.py's case), < 1e-5."""
    r0, _, ref = run
    assert r0["ep8/dropped"] == 0
    assert float(np.abs(r0["ep8/y"] - ref["grouped"]).max()) < 1e-5


def test_ep_capacity_drops_match_reference_ep(run):
    """At capacity_factor 1.25 pairs drop; the port's output equals the
    reference's moe_forward_ep on its own 8-device mesh, < 1e-5 (the same
    pairs dropped), and so does the aux loss."""
    r0, _, ref = run
    assert r0["ep125/dropped"] > 0
    assert float(np.abs(r0["ep125/y"] - ref["ep125_y"]).max()) < 1e-5
    assert abs(r0["ep125/aux"] - float(ref["ep125_aux"])) < 1e-6
    # the drops change the output: the grouped (dropless) path differs
    assert float(np.abs(r0["ep125/y"] - ref["grouped"]).max()) > 1e-3


def test_ep_dispatch_chunks_match_reference_ep(run):
    """dispatch_chunks 2 at capacity_factor 1.25: each chunk routes and
    drops on its own capacity (half the tokens, cap 6 instead of 11); the
    output and the last chunk's aux equal the reference's chunked
    moe_forward_ep, < 1e-5 and < 1e-6."""
    r0, _, ref = run
    assert r0["epch2/dropped"] > 0
    assert float(np.abs(r0["epch2/y"] - ref["epch2_y"]).max()) < 1e-5
    assert abs(r0["epch2/aux"] - float(ref["epch2_aux"])) < 1e-6
    # the chunks' own capacities drop other pairs than one dispatch does
    assert float(np.abs(r0["epch2/y"] - r0["ep125/y"]).max()) > 1e-3


def test_ep_fp8_wire_matches_reference(run):
    """The float8_e4m3fn dispatch (per-row scales) against the reference's
    fp8 path, within FP8_TOL."""
    r0, _, ref = run
    err = float(np.abs(r0["epfp8/y"] - ref["epfp8_y"]).max())
    assert err < FP8_TOL, err
    assert float(np.abs(r0["epfp8/y"] - r0["ep125/y"]).max()) > 0  # it did quantize


def test_compressed_allreduce_matches_reference(run):
    """8 ranks, the reference test's gradients: the mean within 1e-6
    relative of the reference's, each rank's EF residual equal to the
    reference's, and the int8 error bound (< 0.02 of the largest mean)."""
    _, ranks, ref = run
    mean = ref["grads"].mean(0) if "grads" in ref else None
    scale = float(np.abs(ref["ar_out"]).max())
    for r, out in enumerate(ranks):
        assert float(np.abs(out["ar/out"] - ref["ar_out"]).max()) <= 1e-6 * scale
        np.testing.assert_allclose(out["ar/ef"], ref["ar_ef"][r:r + 1], rtol=0, atol=1e-6)
    if mean is not None:
        assert float(np.abs(ranks[0]["ar/out"] - mean).max()) / scale < 0.02


def test_pipeline_forward_and_gradient(run):
    """pipeline_apply over 4 ranks (L 8, D 16, B 8, 4 microbatches): forward
    < 1e-5 and gradient < 1e-3 against the reference's sequential_reference
    and jax.grad; the port's own sequential_reference agrees too."""
    _, ranks, ref = run
    for out in ranks[:4]:
        assert float(np.abs(out["pipe/y"] - ref["pipe_y"]).max()) < 1e-5
        assert float(np.abs(out["pipe/g"] - ref["pipe_g"]).max()) < 1e-3
        assert float(np.abs(out["pipe/seq"] - ref["pipe_y"]).max()) < 1e-5
    assert all("pipe/y" not in out for out in ranks[4:])


def test_reshard_to_smaller_mesh_is_bitwise(run):
    """qwen2.5-3b smoke sharded on (2, 4), resharded onto (1, 4) over the
    first four ranks (the others lost): gathered back, every leaf equals
    the original bit for bit."""
    _, ranks, ref = run
    whole = sum(np.asarray(v).size for v in jax.tree.leaves(ref["qwen"]))
    for out in ranks[:4]:
        assert out["reshard/maxdiff"] == 0.0
        assert out["reshard/local_numel"] < whole  # it is sharded over model
    assert all("reshard/maxdiff" not in out for out in ranks[4:])
    assert ranks[0]["rebatch"] == (30, 30)


def test_rescale_training_state_is_bitwise(run):
    """The FSDP step's parameters and AdamW m / v, rescaled from (2, 4) onto
    (1, 4) over the first four ranks: gathered back, equal bit for bit to
    the same state gathered on (2, 4); the step count carried; the ranks
    outside the new mesh get None."""
    _, ranks, _ = run
    whole = sum(a.size for a in ranks[0]["traintrain/params"])
    for out in ranks[:4]:
        assert out["rescale/maxdiff"] == {"p": 0.0, "m": 0.0, "v": 0.0}
        assert out["rescale/step"] == (1, 1)
        assert out["rescale/local_numel"] < whole  # sharded over model
    assert all(out["rescale/none"] for out in ranks[4:])


def test_host_mesh_spans_the_world(run):
    """make_host_mesh: the 8 ranks as one 'data' axis, rank r at index r."""
    _, ranks, _ = run
    for r, out in enumerate(ranks):
        assert out["host_mesh"] == (("data",), (8,), r)


def test_collectives_counted(run):
    """Every kind of collective the cases use was counted, with its bytes."""
    r0, _, _ = run
    c = r0["counters"]
    for kind in ("psum", "pmax", "all_gather", "all_to_all", "ppermute", "reduce_scatter"):
        assert c[kind]["calls"] > 0 and c[kind]["bytes"] > 0, kind
        assert c[kind]["staged_bytes"] == 0  # CPU tensors: nothing to stage
