"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, at smoke size, on the same weights and
inputs: routing (top-k indices equal, ties to the lower index), the GShard
dense dispatch with and without capacity drops (the same pairs dropped),
the dropless grouped path, ``mode="ep"`` without a mesh, and each
activation.

Weights are drawn by ``repro.models.moe.moe_init`` and carried across as
numpy; inputs come from numpy with a fixed seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # as tests/test_torch_models.py
ACTS = ["swiglu", "squared_relu", "gelu"]


def _cfgs(arch="granite-moe-1b-a400m", dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (dataclasses.replace(jregistry.get_smoke(arch), **kw),
            dataclasses.replace(tregistry.get_smoke(arch), **kw))


def _t(x):
    """JAX/numpy array -> torch tensor, bf16 kept as bf16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol,
                               rtol=tol)


def _layer(jcfg, seed=0, B=2, S=16, ties=False):
    pj = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    if ties:  # expert 3 routes exactly as expert 1: every token ties the two
        r = np.asarray(pj["router"]).copy()
        r[:, 3] = r[:, 1]
        pj = dict(pj, router=jnp.asarray(r))
    pt = {k: _t(v) for k, v in pj.items()}
    x = np.random.RandomState(seed + 1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(jcfg.dtype))
    return pj, pt, xj, _t(xj)


@pytest.mark.parametrize("ties", [False, True])
def test_routing_matches_reference(ties):
    """Probabilities, renormalized top-k weights and the aux loss within
    f32 tolerance; the top-k indices equal, also where two experts tie
    (jax.lax.top_k gives the lower index first)."""
    jcfg, tcfg = _cfgs()
    pj, pt, xj, xt = _layer(jcfg, seed=3, ties=ties)
    x2j, x2t = xj.reshape(-1, jcfg.d_model), xt.reshape(-1, tcfg.d_model)
    probs_j, w_j, idx_j, aux_j = jmoe._routing(jcfg, pj, x2j)
    probs_t, w_t, idx_t, aux_t = tmoe._routing(tcfg, pt, x2t)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(probs_t, probs_j, 1e-6)
    _close(w_t, w_j, 1e-6)
    _close(aux_t, aux_j, 1e-6)
    if ties:  # both tied experts sit in the top-2 of some token, 1 before 3
        both = (idx_t == 1).any(-1) & (idx_t == 3).any(-1)
        assert bool(both.any())
        assert bool((idx_t[both] == torch.tensor([1, 3])).all())


def _drop_oracle(idx, num_experts, capacity):
    """keep (G, Tg, K): each expert takes its first ``capacity`` pairs in
    (token, k) order within the group; a loop over the pairs."""
    keep = np.zeros(idx.shape, bool)
    for g in range(idx.shape[0]):
        load = [0] * num_experts
        for t in range(idx.shape[1]):
            for k in range(idx.shape[2]):
                e = int(idx[g, t, k])
                keep[g, t, k] = load[e] < capacity
                load[e] += 1
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 3])
def test_dense_dispatch_matches_reference(capacity, dtype):
    """GShard dispatch at the default capacity and at capacity 3 (more pairs
    dropped): the port drops the same (token, k) pairs as a queue-order
    oracle on the reference's routing, and its output equals repro's
    moe_forward_dense."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    pj, pt, xj, xt = _layer(jcfg, seed=5)
    B, S, D = xj.shape
    yj, auxj = jmoe.moe_forward_dense(jcfg, pj, xj, capacity=capacity)
    yt, auxt = tmoe.moe_forward_dense(tcfg, pt, xt, capacity=capacity)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    _close(yt, yj, TOL[dtype])
    _close(auxt, auxj, 1e-6)
    idx = np.array(jmoe._routing(jcfg, pj, xj.reshape(B * S, D))[2]).reshape(B, S, -1)
    C = tmoe.gshard_capacity(tcfg, S) if capacity is None else capacity
    _, keep = tmoe.gshard_positions(torch.from_numpy(idx).long(), tcfg.moe.num_experts, C)
    want = _drop_oracle(idx, tcfg.moe.num_experts, C)
    np.testing.assert_array_equal(keep.numpy(), want)
    if capacity is not None:  # pairs were dropped, and that changed the output
        assert not want.all()
        y_free, _ = tmoe.moe_forward_dense(tcfg, pt, xt)
        dropped = torch.from_numpy(~want.all(-1))  # (B, S): tokens that lost a pair
        assert not torch.equal(y_free[dropped], yt[dropped])
        assert torch.equal(y_free[~dropped], yt[~dropped])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matches_reference(dtype):
    """The dropless grouped path (a loop of matmuls over the experts with
    rows) against repro's ragged_dot path."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    pj, pt, xj, xt = _layer(jcfg, seed=7, B=3, S=11)
    yj, auxj = jmoe.moe_forward_grouped(jcfg, pj, xj)
    yt, auxt = tmoe.moe_forward_grouped(tcfg, pt, xt)
    assert yt.dtype == xt.dtype
    _close(yt, yj, TOL[dtype])
    _close(auxt, auxj, 1e-6)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", ["dense", "ep"])
def test_moe_forward_modes_and_activations_match_reference(mode, act):
    """moe_forward in each mode ("ep" without a mesh is the grouped path in
    both packages) with each activation (gelu: jax's tanh form), f32, on
    kimi-k2's smoke config (qk-norm aside, the same layer)."""
    moe_j = dataclasses.replace(jregistry.get_smoke("kimi-k2-1t-a32b").moe, mode=mode)
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b", mlp_act=act)
    jcfg = dataclasses.replace(jcfg, moe=moe_j)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, mode=mode))
    pj, pt, xj, xt = _layer(jcfg, seed=9)
    assert ("w_gate" in pt) == (act == "swiglu")
    yj, _ = jmoe.moe_forward(jcfg, pj, xj)
    yt, _ = tmoe.moe_forward(tcfg, pt, xt)
    _close(yt, yj, TOL["float32"])


def test_moe_init_and_refusals():
    """moe_init: fp32 router, experts (E, D, F) / (E, F, D) in param_dtype
    drawn at 0.02 one expert at a time (the same generator state gives the
    same experts); expert parallelism refuses experts that are not the
    rank's share of the mesh, and an unknown mode raises."""
    _, tcfg = _cfgs(dtype="bfloat16")
    p = tmoe.moe_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    e = tcfg.moe
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (tcfg.d_model, e.num_experts)
    assert p["w_gate"].shape == p["w_up"].shape == (e.num_experts, tcfg.d_model, e.d_ff_expert)
    assert p["w_down"].shape == (e.num_experts, e.d_ff_expert, tcfg.d_model)
    assert p["w_up"].dtype == torch.bfloat16
    assert abs(p["w_up"].float().std().item() - 0.02) < 1e-3
    q = tmoe.moe_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["w_down"], q["w_down"])
    assert not torch.equal(p["w_up"][0], p["w_up"][1])
    x = torch.zeros(1, 2, tcfg.d_model, dtype=torch.bfloat16)
    from repro_torch.distributed.mesh_compat import AbstractMesh
    from repro_torch.models.parallel import ParallelCtx

    ep = dataclasses.replace(tcfg, moe=dataclasses.replace(e, mode="ep"))
    ctx = ParallelCtx(mesh=AbstractMesh((2,), ("model",)), dp_axes=())
    with pytest.raises(ValueError, match="rank's"):
        tmoe.moe_forward(ep, p, x, ctx=ctx)
    bad = dataclasses.replace(tcfg, moe=dataclasses.replace(e, mode="megablox"))
    with pytest.raises(ValueError, match="mode"):
        tmoe.moe_forward(bad, p, x)
