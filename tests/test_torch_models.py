"""The port's models (``repro_torch.models``: the dense family with and
without qk-norm, rwkv6-3b's ssm family, zamba2-2.7b's hybrid family, the moe
family (granite-moe, kimi-k2), qwen2-vl's vlm family with M-RoPE and the
``embeds`` input, and whisper's audio encoder-decoder) against
``repro.models`` on the CPU, at smoke size, on the same weights and inputs.

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
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["olmo-1b", "qwen2.5-3b", "nemotron-4-15b"]
RECURRENT = ["rwkv6-3b", "zamba2-2.7b"]
# the token archs of the other families: qk-norm (qwen3-4b, kimi-k2), moe in
# GShard dense mode (granite) and in ep mode without a mesh (kimi-k2: the
# grouped path), M-RoPE (qwen2-vl)
FAMILY_ARCHS = ["qwen3-4b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "qwen2-vl-7b"]
AUDIO = "whisper-tiny"
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


def _fields_equal(t, j):
    """Whether the port's config ``t`` carries ``j``'s value on each of its
    own fields; a sub-config (SSMConfig) is held on the port's fields too,
    since the two packages' classes differ. A field of the port alone
    (``PORT_ONLY_FIELDS``) has to hold its default, which is the
    reference's behaviour."""
    for f in dataclasses.fields(t):
        if f.name in tbase.PORT_ONLY_FIELDS:
            assert getattr(t, f.name) == tbase.PORT_ONLY_FIELDS[f.name], f.name
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.is_dataclass(jv), f.name
            _fields_equal(tv, jv)
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("arch", ARCHS + RECURRENT + FAMILY_ARCHS + [AUDIO])
def test_configs_match_reference(arch):
    """The port's configs carry the reference's values on every field
    they share, at full size and smoke size."""
    for getter in ("get", "get_smoke"):
        j = getattr(jregistry, getter)(arch)
        t = getattr(tregistry, getter)(arch)
        _fields_equal(t, j)


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
    odt = tattn.attention_decode(tcfg, pt, _t(xd), cdt, sdt, ckt, cvt, torch.tensor([S]),
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
@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
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


def test_token_shift_matches_reference():
    x = np.random.RandomState(9).standard_normal((2, 5, 8)).astype(np.float32)
    prev = np.random.RandomState(10).standard_normal((2, 8)).astype(np.float32)
    for p in (None, prev):
        want = jcommon.token_shift(jnp.asarray(x), None if p is None else jnp.asarray(p))
        got = tcommon.token_shift(torch.from_numpy(x), None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", RECURRENT)
def test_params_from_jax_recurrent_layouts(arch):
    """Every leaf of an ssm / hybrid pytree crosses exactly: the layer axis
    (hybrid: the (G, attn_every) axes) unstacked, names and dtypes kept
    (the decay LoRA, bonus, conv and SSM parameters in f32, the
    projections in bf16)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    assert set(pt) == set(pj)
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj["blocks"])[0]:
        keys = [p.key for p in path]
        lead = leaf.shape[:2] if tcfg.family == "hybrid" else leaf.shape[:1]
        for idx in np.ndindex(*lead):
            got = pt["blocks"]
            for i in idx:
                got = got[i]
            for k in keys:
                got = got[k]
            want = np.asarray(leaf[idx])
            assert str(got.dtype).endswith(want.dtype.name), (keys, got.dtype, want.dtype)
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    if tcfg.family == "hybrid":
        assert len(pt["blocks"]) == tcfg.num_layers // tcfg.attn_every
        assert all(len(g) == tcfg.attn_every for g in pt["blocks"])
        assert pt["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    else:
        assert len(pt["blocks"]) == tcfg.num_layers
        assert pt["ln0_scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_decode_and_caches_match_reference(arch, dtype):
    """rwkv6-3b (ssm) and zamba2-2.7b (hybrid) at smoke size: forward
    logits, prefill logits and cache, 3 teacher-forced decode steps, and
    the final caches (ssm_state and shift_* / conv and kv_*), against
    repro.models.lm on the same weights."""
    jcfg, tcfg = _cfgs(arch, dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(12))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    B, S, M = 2, 21, 32
    toks = np.random.RandomState(13).randint(3, VOCAB, (B, S + 3)).astype(np.int32)
    tol = TOL[dtype]

    lj, _, _ = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(pj, {"tokens": jnp.asarray(toks)})
    lt, _, none = tlm.forward(tcfg, pt, torch.from_numpy(toks))
    assert none is None
    _close(lt, lj, tol)

    lj, cj = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, cache_len=M))(
        pj, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = tlm.prefill(tcfg, pt, torch.from_numpy(toks[:, :S]), cache_len=M)
    assert set(ct) == set(cj) and ct["length"] == int(cj["length"]) == S
    for name in ct:
        if name != "length":
            assert tuple(ct[name].shape) == cj[name].shape, name
            assert str(ct[name].dtype).endswith(cj[name].dtype.name), name
            _close(ct[name], cj[name], tol)
    _close(lt, lj, tol)
    step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
    for i in range(3):
        t_in = toks[:, S + i:S + i + 1]
        lj, cj = step(pj, cj, jnp.asarray(t_in))
        lt, ct = tlm.decode_step(tcfg, pt, ct, torch.from_numpy(t_in))
        assert ct["length"] == int(cj["length"]) == S + i + 1
        _close(lt, lj, tol)
    for name in ct:
        if name != "length":
            _close(ct[name], cj[name], tol)


@pytest.mark.parametrize("arch", RECURRENT)
def test_multi_step_decode_matches_forward(arch):
    """The port's own decode against its own forward (as
    tests/test_models.py does for the reference): prefill 18 tokens, then 3
    decode steps; each step's logits within 1e-3 (relative to the largest)
    of the full forward's at that position. f32."""
    _, cfg = _cfgs(arch)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    B, S, extra = 1, 18, 3
    toks = torch.randint(3, VOCAB, (B, S + extra), generator=torch.Generator().manual_seed(4))
    full, _, _ = tlm.forward(cfg, p, toks)
    _, cache = tlm.prefill(cfg, p, toks[:, :S], cache_len=S + extra + 2)
    for i in range(extra):
        ld, cache = tlm.decode_step(cfg, p, cache, toks[:, S + i:S + i + 1])
        a, b = full[:, S + i], ld[:, 0]
        rel = (a - b).abs().max().item() / (a.abs().max().item() + 1e-9)
        assert rel < 1e-3, (arch, i, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_hd80_matches_reference(dtype):
    """Zamba2's shared attention block at its published head dim 80
    (4 heads at smoke width): prefill through the plain flash version and
    one decode step through the plain decode version, against the
    reference's jnp attention on the same projections."""
    jcfg, tcfg = _cfgs("zamba2-2.7b", dtype)
    jcfg = dataclasses.replace(jcfg, head_dim=80)
    tcfg = dataclasses.replace(tcfg, head_dim=80)
    pj = jattn.attn_init(jcfg, jax.random.PRNGKey(8))
    pt = {k: _t(v) for k, v in pj.items()}
    S, M, B = 13, 16, 2
    x = jnp.asarray(np.random.RandomState(14).standard_normal((B, S, jcfg.d_model)),
                    jnp.float32).astype(getattr(jnp, dtype))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    cj, sj = jrope.rope_angles(pos, 80, jcfg.rope_theta)
    ct, st = trope.rope_angles(_t(pos), 80, tcfg.rope_theta)
    oj, (kj, vj) = jattn.attention_seq(jcfg, pj, x, cj, sj)
    ot, (kt, vt) = tattn.attention_seq(tcfg, pt, _t(x), ct, st)
    tol = TOL[dtype]
    _close(ot, oj, tol)
    ck = jnp.zeros((B, M, jcfg.num_kv_heads, 80), kj.dtype).at[:, :S].set(kj)
    cv = jnp.zeros_like(ck).at[:, :S].set(vj)
    pd = jnp.full((B, 1), S, jnp.int32)
    cdj, sdj = jrope.rope_angles(pd, 80, jcfg.rope_theta)
    cdt, sdt = trope.rope_angles(_t(pd), 80, tcfg.rope_theta)
    odj, ckj, _ = jattn.attention_decode(jcfg, pj, x[:, -1:], cdj, sdj, ck, cv, jnp.asarray(S))
    ckt, cvt = _t(ck), _t(cv)
    odt = tattn.attention_decode(tcfg, pt, _t(x[:, -1:]), cdt, sdt, ckt, cvt, torch.tensor([S]),
                                 torch.full((B,), S + 1, dtype=torch.int32))
    _close(odt, odj, tol)
    _close(ckt, ckj, tol)


def test_recurrent_init_distributions_and_dtypes():
    """The mixers draw the reference's distributions: rwkv's mixes 0.5,
    decay base -4.6, LoRA at 0.01 and bonus at 0.1 in f32; mamba's conv at
    0.1 in f32, A_log 0, dt_bias -2, D 1; projections in param_dtype.
    Smoke depth, widened to 512 so the standard deviations are estimated
    from enough draws (tolerance 15%: at least 512 draws each)."""
    cfg = dataclasses.replace(tregistry.get_smoke("rwkv6-3b"), d_model=512)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")["blocks"][1]["rwkv"]
    assert bool((p["mix_w"] == 0.5).all()) and bool((p["w_base"] == -4.6).all())
    for name, std in (("w_lora_a", 0.01), ("w_lora_b", 0.01), ("bonus", 0.1), ("wr", 0.02)):
        assert abs(p[name].float().std().item() - std) < 0.15 * std, name
    assert all(p[n].dtype == torch.float32 for n in ("w_lora_a", "w_lora_b", "bonus"))
    assert p["wr"].dtype == torch.bfloat16 and p["bonus"].shape == (16, 32)
    cfg = dataclasses.replace(tregistry.get_smoke("zamba2-2.7b"), d_model=512)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    m = params["blocks"][1][1]["mamba"]
    assert len(params["blocks"]) == 2 and len(params["blocks"][0]) == 2
    assert m["conv_w"].dtype == torch.float32
    assert abs(m["conv_w"].std().item() - 0.1) < 0.015
    assert bool((m["A_log"] == 0).all()) and bool((m["dt_bias"] == -2).all())
    assert bool((m["D"] == 1).all()) and m["in_proj"].dtype == torch.bfloat16
    assert m["in_proj"].shape == (512, 2 * 1024 + 2 * 16 + 32)  # z, x, B, C, dt
    assert params["shared_attn"]["attn"]["wq"].shape == (512, 4 * 32)


def test_hybrid_needs_one_whole_group():
    """A hybrid config with fewer layers than attn_every would run no layer
    at all (the reference's group count is num_layers // attn_every): the
    port refuses it."""
    cfg = dataclasses.replace(tregistry.get_smoke("zamba2-2.7b"), num_layers=1)
    with pytest.raises(ValueError, match="no group"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


# -- the other families: qk-norm, moe, vlm (M-RoPE, embeds), audio ------------


def test_registry_has_every_reference_arch():
    """The reference's archs and families are the port's, less the port's
    own (each listed with its reason), which the registry and the model
    resolve all the same."""
    assert tregistry.PORT_ONLY_ARCHS == ("nemotron-h-47b",)
    assert tlm.PORT_ONLY_FAMILIES == ("nemotron_h",)
    assert sorted(tregistry.ARCH_NAMES) == sorted(jregistry.ARCH_NAMES)
    assert sorted(jregistry.ARCH_NAMES) == sorted(
        set(tregistry._MODULES) - set(tregistry.PORT_ONLY_ARCHS))
    assert {jregistry.get(a).family for a in jregistry.ARCH_NAMES} == (
        set(tlm.FAMILIES) - set(tlm.PORT_ONLY_FAMILIES))
    assert [tregistry.get(a).family for a in tregistry.PORT_ONLY_ARCHS] == list(
        tlm.PORT_ONLY_FAMILIES)


@pytest.mark.parametrize("arch", FAMILY_ARCHS + [AUDIO])
def test_params_from_jax_new_layouts(arch):
    """Every leaf of the new layouts crosses exactly, bf16: the moe router
    in f32 and its (E, D, F) / (E, F, D) experts per layer, the qk-norm
    scales in f32, qwen2-vl's QKV biases, whisper's enc_blocks / dec_blocks
    (with ``cross``), enc_final and dec_pos; the port's own init gives the
    same names, shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    assert set(pt) == set(pj)
    stacks = [k for k in pj if k.endswith("blocks")]
    for name in stacks:
        for path, leaf in jax.tree_util.tree_flatten_with_path(pj[name])[0]:
            keys = [p.key for p in path]
            assert len(pt[name]) == leaf.shape[0]
            for i in range(leaf.shape[0]):
                got = pt[name][i]
                for k in keys:
                    got = got[k]
                want = np.asarray(leaf[i])
                assert str(got.dtype).endswith(want.dtype.name), (name, keys)
                np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    for k in set(pj) - set(stacks):
        np.testing.assert_array_equal(pt[k].float().numpy(), np.asarray(pj[k], np.float32))
    own = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else
                [layout(x) for x in v] if isinstance(v, list) else (tuple(v.shape), v.dtype)
                for k, v in tree.items()}

    assert layout(own) == layout(pt)
    layer = pt["dec_blocks" if arch == AUDIO else "blocks"][1]
    if tcfg.moe is not None:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_up"].shape == (tcfg.moe.num_experts, tcfg.d_model,
                                              tcfg.moe.d_ff_expert)
    if tcfg.qk_norm:
        assert layer["attn"]["q_norm_scale"].dtype == torch.float32
    if arch == AUDIO:
        assert len(pt["enc_blocks"]) == tcfg.encoder.num_layers and "cross" in layer
        assert pt["dec_pos"].shape == (tlm.DEC_POS_ROWS, tcfg.d_model)


def test_mrope_and_gelu_match_reference():
    """positions_for_rope: M-RoPE from distinct (3, B, S) streams and from
    text (B, S) positions (replicated), standard RoPE, and "none"; the MLP's
    gelu is jax's tanh form."""
    jcfg, tcfg = _cfgs("qwen2-vl-7b")
    rs = np.random.RandomState(3)
    pos3 = rs.randint(0, 300, (3, 2, 9)).astype(np.int32)
    for pos in (pos3, pos3[0]):
        cj, sj = jrope.positions_for_rope(jcfg, jnp.asarray(pos), 128)
        ct, st = trope.positions_for_rope(tcfg, torch.from_numpy(pos), 128)
        _close(ct, cj, 1e-5)
        _close(st, sj, 1e-5)
    assert trope.mrope_sections(128) == jrope.mrope_sections(128) == (16, 24, 24)
    none = dataclasses.replace(tcfg, rope_type="none")
    assert trope.positions_for_rope(none, torch.from_numpy(pos3[0]), 128) == (None, None)
    x = rs.standard_normal((4, 64)).astype(np.float32) * 3
    _close(tcommon.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)), 1e-6)
    assert (tcommon.gelu(torch.from_numpy(x)) - torch.nn.functional.gelu(
        torch.from_numpy(x))).abs().max() > 1e-5  # not torch's exact-erf default


def _vlm_inputs(cfg, B=2, S=10, seed=15):
    """Stub-frontend embeds and distinct (temporal, height, width) streams."""
    rs = np.random.RandomState(seed)
    emb = rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos = np.stack([t, t // 3, (t * 7) % 5]).astype(np.int32)
    return emb, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_embeds_with_mrope_positions_match_reference(dtype):
    """qwen2-vl through the stub frontend's embeds with distinct (3, B, S)
    positions: forward and prefill logits and the prefill cache, then 3
    teacher-forced text decode steps, against repro.models.lm."""
    jcfg, tcfg = _cfgs("qwen2-vl-7b", dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(16))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    emb, pos = _vlm_inputs(tcfg)
    tol = TOL[dtype]
    batch = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}
    lj, cj = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, cache_len=16))(pj, batch)
    lt, ct = tlm.prefill(tcfg, pt, embeds=torch.from_numpy(emb),
                         positions=torch.from_numpy(pos), cache_len=16)
    _close(lt, lj, tol)
    _close(ct["kv_k"], cj["kv_k"], tol)
    toks = np.random.RandomState(17).randint(3, VOCAB, (2, 3)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
    for i in range(3):
        lj, cj = step(pj, cj, jnp.asarray(toks[:, i:i + 1]))
        lt, ct = tlm.decode_step(tcfg, pt, ct, torch.from_numpy(toks[:, i:i + 1]))
        _close(lt, lj, tol)


def test_mrope_positions_change_output():
    """M-RoPE reads the 3D position streams: another height stream changes
    the logits (tests/test_models.py's check, on the port's own init: at
    0.02-scale weights the change is ~6e-5, far above the 0 that recomputing
    the same positions gives)."""
    _, cfg = _cfgs("qwen2-vl-7b")
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 1, 8
    emb = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos1 = torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S)
    pos2 = pos1.clone()
    pos2[1] = pos1[1] * 3
    l1, _, _ = tlm.forward(cfg, p, embeds=emb, positions=pos1)
    l2, _, _ = tlm.forward(cfg, p, embeds=emb, positions=pos2)
    assert (l1 - l2).abs().max().item() > 1e-5
    l0, _, _ = tlm.forward(cfg, p, embeds=emb)  # default: 0..S-1 on every stream
    assert torch.equal(l0, l1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_prefill_decode_match_reference(dtype):
    """whisper-tiny at smoke size (2 encoder and 2 decoder layers, 16
    frames): forward logits, prefill logits and every cache tensor (self
    and cross K/V), 3 teacher-forced decode steps and the final caches,
    against repro.models.lm."""
    jcfg, tcfg = _cfgs(AUDIO, dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(18))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    B, S, M = 2, 9, 16
    rs = np.random.RandomState(19)
    frames = rs.standard_normal((B, tcfg.encoder.num_frames, tcfg.d_model)).astype(np.float32)
    toks = rs.randint(3, VOCAB, (B, S + 3)).astype(np.int32)
    tol = TOL[dtype]
    batch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :S])}
    lj, _, _ = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(pj, batch)
    lt, _, none = tlm.forward(tcfg, pt, torch.from_numpy(toks[:, :S]),
                           frames=torch.from_numpy(frames))
    assert none is None
    _close(lt, lj, tol)
    lj, cj = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, cache_len=M))(pj, batch)
    lt, ct = tlm.prefill(tcfg, pt, torch.from_numpy(toks[:, :S]), cache_len=M,
                         frames=torch.from_numpy(frames))
    assert set(ct) == set(cj) and ct["length"] == int(cj["length"]) == S
    for name in ct:
        if name != "length":
            assert tuple(ct[name].shape) == cj[name].shape, name
            _close(ct[name], cj[name], tol)
    _close(lt, lj, tol)
    step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
    for i in range(3):
        t_in = toks[:, S + i:S + i + 1]
        lj, cj = step(pj, cj, jnp.asarray(t_in))
        lt, ct = tlm.decode_step(tcfg, pt, ct, torch.from_numpy(t_in))
        assert ct["length"] == int(cj["length"]) == S + i + 1
        _close(lt, lj, tol)
    for name in ("kv_k", "kv_v"):
        _close(ct[name], cj[name], tol)
    with pytest.raises(ValueError, match="frames"):
        tlm.prefill(tcfg, pt, torch.from_numpy(toks[:, :S]))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b", "qwen2-vl-7b"])
def test_prefill_extend_matches_reference(arch):
    """The suffix-only prefill of the moe and vlm families against a
    prefix's K/V: logits and the assembled cache against repro's
    prefill_extend on the same prefix K/V (page padding past prefix_len
    included), f32; then one decode step from the assembled cache."""
    jcfg, tcfg = _cfgs(arch)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(20))
    pt = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    B, Sp, Ss, M = 2, 12, 5, 24
    rs = np.random.RandomState(21)
    toks = rs.randint(3, VOCAB, (B, Sp + Ss + 1)).astype(np.int32)
    _, cj = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, cache_len=16))(
        pj, {"tokens": jnp.asarray(toks[:, :Sp])})
    pk, pv = cj["kv_k"], cj["kv_v"]  # (L, B, 16, Hkv, hd): 4 positions of padding
    lj, cej = jlm.prefill_extend(jcfg, pj, {"tokens": jnp.asarray(toks[:, Sp:Sp + Ss])},
                                 pk, pv, Sp, cache_len=M)
    lt, cet = tlm.prefill_extend(tcfg, pt, torch.from_numpy(toks[:, Sp:Sp + Ss]), _t(pk),
                                 _t(pv), Sp, cache_len=M)
    assert cet["length"] == int(cej["length"]) == Sp + Ss
    _close(lt, lj, TOL["float32"])
    _close(cet["kv_k"], cej["kv_k"], TOL["float32"])
    _close(cet["kv_v"], cej["kv_v"], TOL["float32"])
    t_in = toks[:, -1:]
    lj, _ = jlm.decode_step(jcfg, pj, cej, jnp.asarray(t_in))
    lt, _ = tlm.decode_step(tcfg, pt, cet, torch.from_numpy(t_in))
    _close(lt, lj, TOL["float32"])
