"""The port's dense model (``repro_torch.models``) against ``repro.models``
on the CPU, at smoke size, on the same weights and inputs.

Weights are drawn by ``repro.models.lm.init_params`` and carried across
with ``params_from_jax``; inputs come from numpy with a fixed seed. The
smoke configs are widened back to ``vocab_size=50_304`` (the reference's
512-entry smoke vocab is narrower than its own tokenizer)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["olmo-1b", "qwen2.5-3b", "nemotron-4-15b"]
VOCAB = 50_304
# f32: both sides compute in f32 and differ in summation order only.
# bf16: activations round to bf16 after every op on both sides, at places
# that differ (XLA fuses; torch rounds each op), so errors compound.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, dtype="float32"):
    """(reference cfg, port cfg) for one arch at smoke size."""
    kw = dict(vocab_size=VOCAB, dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(jregistry.get_smoke(arch), **kw),
            dataclasses.replace(tregistry.get_smoke(arch), **kw))


def _t(x):
    """JAX/numpy array -> torch tensor, bf16 kept as bf16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """The port's configs carry the reference's values on every field
    they share, at full size and smoke size."""
    for getter in ("get", "get_smoke"):
        j = getattr(jregistry, getter)(arch)
        t = getattr(tregistry, getter)(arch)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (getter, f.name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rs.standard_normal(64).astype(np.float32)
    bias = rs.standard_normal(64).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = _t(xj)
    tol = TOL[dtype]
    _close(tcommon.rms_norm(xt, torch.from_numpy(scale)),
           jcommon.rms_norm(xj, jnp.asarray(scale)), tol)
    _close(tcommon.layer_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias)),
           jcommon.layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias)), tol)
    for arch in ARCHS:  # the three norm types of the deployment
        jcfg, tcfg = _cfgs(arch)
        p = {"ln1_scale": scale, "ln1_bias": bias}
        out_t = tcommon.apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in p.items()}, "ln1", xt)
        out_j = jcommon.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, "ln1", xj)
        assert out_t.dtype == xt.dtype
        _close(out_t, out_j, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + 3
    cj, sj = jrope.rope_angles(jnp.asarray(pos), 32, 1_000_000.0)
    ct, st = trope.rope_angles(torch.from_numpy(pos), 32, 1_000_000.0)
    assert ct.dtype == torch.float32
    _close(ct, cj, 1e-5)
    _close(st, sj, 1e-5)
    x = np.random.RandomState(1).standard_normal((2, 12, 3, 32)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    out_t = trope.apply_rope(_t(xj), ct, st)
    assert out_t.dtype == getattr(torch, dtype)
    _close(out_t, jrope.apply_rope(xj, cj, sj), TOL[dtype])


def _layer(arch, dtype, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    pj = jattn.attn_init(jcfg, jax.random.PRNGKey(seed))
    if jcfg.qkv_bias:  # nonzero biases, so the bias path is exercised
        rs = np.random.RandomState(seed)
        pj = dict(pj, **{b: jnp.asarray(rs.standard_normal(pj[b].shape) * 0.1,
                                        pj[b].dtype) for b in ("bq", "bk", "bv")})
    pt = {k: _t(v) for k, v in pj.items()}
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_seq_and_decode_match_reference(arch, dtype):
    """Prefill attention (the port's flash route) and one decode step
    against the reference's jnp attention, on the same projections."""
    jcfg, tcfg, pj, pt = _layer(arch, dtype)
    S, M, B = 11, 16, 2
    rs = np.random.RandomState(2)
    x = jnp.asarray(rs.standard_normal((B, S, jcfg.d_model)).astype(np.float32)).astype(
        getattr(jnp, dtype))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    cj, sj = jrope.rope_angles(pos, jcfg.head_dim, jcfg.rope_theta)
    ct, st = trope.rope_angles(_t(pos), tcfg.head_dim, tcfg.rope_theta)
    oj, (kj, vj) = jattn.attention_seq(jcfg, pj, x, cj, sj)
    ot, (kt, vt) = tattn.attention_seq(tcfg, pt, _t(x), ct, st)
    tol = TOL[dtype]
    _close(ot, oj, tol)
    _close(kt, kj, tol)
    _close(vt, vj, tol)

    # decode at position S against a cache holding the prefill K/V
    ck = jnp.zeros((B, M, jcfg.num_kv_heads, jcfg.head_dim), kj.dtype).at[:, :S].set(kj)
    cv = jnp.zeros_like(ck).at[:, :S].set(vj)
    xd = x[:, -1:] * 0.5
    pd = jnp.full((B, 1), S, jnp.int32)
    cdj, sdj = jrope.rope_angles(pd, jcfg.head_dim, jcfg.rope_theta)
    cdt, sdt = trope.rope_angles(_t(pd), tcfg.head_dim, tcfg.rope_theta)
    odj, ckj, cvj = jattn.attention_decode(jcfg, pj, xd, cdj, sdj, ck, cv, jnp.asarray(S))
    ckt, cvt = _t(ck), _t(cv)
    odt = tattn.attention_decode(tcfg, pt, _t(xd), cdt, sdt, ckt, cvt, S,
                                 torch.full((B,), S + 1, dtype=torch.int32))
    _close(odt, odj, tol)
    _close(ckt, ckj, tol)  # the new K/V was written in place at position S
    _close(cvt, cvj, tol)


def test_attention_seq_matches_reference_pallas_route():
    """At S=128 with use_pallas the reference routes prefill through its
    Pallas flash kernel (interpret mode here); the port's route matches."""
    jcfg, tcfg, pj, pt = _layer("qwen2.5-3b", "float32", seed=3)
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    S, B = 128, 1
    x = jnp.asarray(np.random.RandomState(4).standard_normal((B, S, jcfg.d_model)),
                    jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    cj, sj = jrope.rope_angles(pos, jcfg.head_dim, jcfg.rope_theta)
    ct, st = trope.rope_angles(_t(pos), tcfg.head_dim, tcfg.rope_theta)
    oj, _ = jattn.attention_seq(jcfg, pj, x, cj, sj)
    ot, _ = tattn.attention_seq(tcfg, pt, _t(x), ct, st)
    _close(ot, oj, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
    """Every leaf crosses exactly: names, (in, out) orientation, dtypes
    (bf16 through a uint16 view, norms in f32) and the unstacked layers."""
    jcfg, tcfg = _cfgs("nemotron-4-15b", dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    pnp = jax.tree.map(np.asarray, pj)
    pt = tlm.params_from_jax(tcfg, pnp)
    assert len(pt["blocks"]) == tcfg.num_layers
    assert set(pt) == set(pj)
    for name in ("embed", "head", "final_scale", "final_bias"):
        assert pt[name].dtype == (torch.float32 if name.startswith("final") else getattr(torch, dtype))
        np.testing.assert_array_equal(pt[name].float().numpy(), np.asarray(pj[name], np.float32))
    leaves_j, _ = jax.tree.flatten(pj["blocks"])
    paths = jax.tree_util.tree_flatten_with_path(pj["blocks"])[0]
    for (path, leaf) in paths:
        keys = [p.key for p in path]
        for i in range(tcfg.num_layers):
            got = pt["blocks"][i]
            for k in keys:
                got = got[k]
            assert tuple(got.shape) == leaf.shape[1:]
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf[i], np.float32))
    assert pt["blocks"][0]["ln1_scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and cache, then 8 teacher-forced decode steps, on the
    same weights: the port's lm against repro.models.lm."""
    jcfg, tcfg = _cfgs(arch, dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    B, S, M = 2, 12, 24
    toks = np.random.RandomState(6).randint(3, VOCAB, (B, S + 8)).astype(np.int32)
    tol = TOL[dtype]

    lj, cj = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, cache_len=M))(
        pj, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = tlm.prefill(tcfg, pt, torch.from_numpy(toks[:, :S]), cache_len=M)
    assert ct["length"] == int(cj["length"]) == S
    assert ct["kv_k"].dtype == getattr(torch, dtype)
    _close(lt, lj, tol)
    _close(ct["kv_k"], cj["kv_k"], tol)
    _close(ct["kv_v"], cj["kv_v"], tol)

    step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
    for i in range(8):
        t_in = toks[:, S + i:S + i + 1]
        lj, cj = step(pj, cj, jnp.asarray(t_in))
        lt, ct = tlm.decode_step(tcfg, pt, ct, torch.from_numpy(t_in))
        assert ct["length"] == int(cj["length"]) == S + i + 1
        _close(lt, lj, tol)
    _close(ct["kv_k"], cj["kv_k"], tol)
    _close(ct["kv_v"], cj["kv_v"], tol)


def test_embedding_rejects_out_of_vocabulary_ids():
    """The reference's jnp.take fills an out-of-range row with NaN; the
    port raises instead."""
    _, tcfg = _cfgs("olmo-1b")
    tcfg = dataclasses.replace(tcfg, vocab_size=512)
    pt = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tlm.prefill(tcfg, pt, torch.tensor([[1, 600]]))
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tlm.prefill(tcfg, pt, torch.tensor([[-1, 3]]))


def test_init_params_distribution_and_dtypes():
    """init_params draws 0.02 * N(0, 1) in f32, casts to param_dtype; norm
    scales 1 and biases 0 in f32; the same generator seed gives the same
    weights."""
    cfg = dataclasses.replace(tregistry.get_smoke("nemotron-4-15b"), vocab_size=4096)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    w = p["embed"].float()
    assert p["embed"].dtype == torch.bfloat16
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3
    assert p["final_scale"].dtype == torch.float32 and bool((p["final_scale"] == 1).all())
    assert bool((p["blocks"][1]["ln2_bias"] == 0).all())
    p2 = tlm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(p["blocks"][1]["mlp"]["w_down"], p2["blocks"][1]["mlp"]["w_down"])
