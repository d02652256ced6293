"""The nemotron_h family (Nemotron-H: Mamba-2 with B/C groups, MLP and
attention layers by ``hybrid_override_pattern``) against the benchmark's
plain reference, ``perfbench/references/nemotron_h.py``, which reads the
configuration file's keys alone; and the grouped SSD scan against a
step-by-step recurrence.

On the CPU: seeded random weights at a small width, with D != 0, 2 or 4
B/C groups, drawn conv taps and a pattern holding all three kinds of
layer. On the card (``python3 -m pytest -m card tests/test_torch_nemotron_h.py``;
skipped without one): the ssd kernel at Nemotron-H's (P, Ns) = (64, 128)
and (64, 256) with 8 groups against its plain version and the oracle, and
``Engine.generate`` at the published widths decoding through its CUDA
graph against an eager loop."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.references import nemotron_h as ref_nh  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.obs import InMemoryExporter, Tracer, use_tracer  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

ARCH = "nemotron-h-47b"
# every kind of layer, attention twice, Mamba-2 first and last
PATTERN = "M-M*-M-*M"


def _cfg(groups=4, pattern=PATTERN, dtype="float32", **kw):
    """A small nemotron_h config: d_model 128, 8 Mamba-2 heads of 32 with
    state 16, ``groups`` B/C groups, chunk 16 (so prompts span chunks)."""
    base = registry.get_smoke(ARCH)
    ssm = dataclasses.replace(base.ssm, n_groups=groups, chunk_size=16)
    return dataclasses.replace(base, num_layers=len(pattern), hybrid_pattern=pattern, ssm=ssm,
                               num_kv_heads=2, dtype=dtype, param_dtype=dtype, **kw)


def _conf(cfg):
    """The configuration file's keys of ``cfg``, as the reference reads them."""
    s = cfg.ssm
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "attention_head_dim": cfg.head_dim, "intermediate_size": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "tie_word_embeddings": cfg.tie_embeddings,
            "hybrid_override_pattern": cfg.hybrid_pattern, "layer_norm_epsilon": cfg.norm_eps,
            "mlp_hidden_act": "relu2", "mamba_hidden_act": "silu", "expand": s.expand,
            "mamba_head_dim": s.head_dim, "n_groups": s.n_groups, "ssm_state_size": s.state_dim,
            "conv_kernel": s.conv_dim, "chunk_size": s.chunk_size, "dtype": cfg.dtype}


def _params(cfg, seed=0):
    """The port's init (drawn conv taps) with D, A_log and dt_bias drawn
    per head, so that the D term, the decays and dt all differ by head."""
    g = torch.Generator().manual_seed(seed)
    p = lm.init_params(cfg, g, "cpu")
    for blk in p["blocks"]:
        if "mamba" in blk:
            m = blk["mamba"]
            H = m["D"].shape[0]
            m["D"] = torch.rand(H, generator=g) + 0.5
            m["A_log"] = torch.rand(H, generator=g) - 0.5
            m["dt_bias"] = torch.rand(H, generator=g) - 2.0
            m["conv_b"] = 0.1 * torch.randn(m["conv_b"].shape, generator=g)
    return p


def _tokens(cfg, rows, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, n), generator=g)


# the port and the reference both compute in float32; they differ in the
# order of their sums (the scan's chunks, the einsums' reductions), which
# moves logits of size ~0.3 by ~1e-6. 1e-4 is the float32 tolerance of the
# port's other model tests (tests/test_torch_models.py).
F32_TOL = 1e-4


@pytest.mark.parametrize("groups", [2, 4])
def test_prefill_logits_equal_the_reference(groups):
    cfg = _cfg(groups)
    params = _params(cfg)
    toks = _tokens(cfg, 2, 45)
    logits, _, _ = lm.forward(cfg, params, toks)
    want = ref_nh.logits(_conf(cfg), params, list(toks), [range(45)] * 2)
    for b in range(2):
        torch.testing.assert_close(logits[b], want[b], rtol=F32_TOL, atol=F32_TOL)


def test_prefill_then_decode_equals_the_references_full_forward():
    """A 30-token prefill into a cache of 48, then 15 decode steps, each
    step's logits against the reference's full forward over the prompt and
    every token fed so far."""
    cfg = _cfg()
    params = _params(cfg, seed=3)
    toks = _tokens(cfg, 2, 45, seed=4)
    _, cache = lm.prefill(cfg, params, toks[:, :30], cache_len=48)
    got = []
    for t in range(30, 45):
        logits, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    want = ref_nh.logits(_conf(cfg), params, list(toks), [range(30, 45)] * 2)
    for b in range(2):
        torch.testing.assert_close(torch.stack([g[b] for g in got]), want[b], rtol=F32_TOL,
                                   atol=F32_TOL)


def test_bfloat16_prefill_and_decode_stay_near_the_reference():
    """The served dtype: bf16 weights and activations, fp32 scan and norms.
    Logits of size ~0.3 hold to the float32 reference within 0.02, ten
    times bf16's rounding of them (2^-8 relative): a fault in the scan,
    the groups or the carried state moves them by more than 0.1."""
    cfg = _cfg(dtype="bfloat16")
    params = _params(cfg, seed=5)
    toks = _tokens(cfg, 2, 40, seed=6)
    pre, cache = lm.prefill(cfg, params, toks[:, :32], cache_len=40)
    got = [pre[:, -1]]
    for t in range(32, 39):
        logits, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    want = ref_nh.logits(_conf(cfg), params, list(toks), [range(31, 39)] * 2)
    for b in range(2):
        err = (torch.stack([g[b] for g in got]).float() - want[b]).abs().max()
        assert err < 0.02, err


def _recurrence(x, dt, A_log, B_, C_, D):
    """The scan written out step by step, head by head: head h reads group
    h // (H / G)."""
    Bb, S, H, P = x.shape
    G = B_.shape[2]
    y = torch.zeros(Bb, S, H, P)
    state = torch.zeros(Bb, H, P, B_.shape[-1])
    for h in range(H):
        g = h // (H // G)
        for t in range(S):
            a = torch.exp(-dt[:, t, h] * torch.exp(A_log[h]))
            state[:, h] = a[:, None, None] * state[:, h] + (
                dt[:, t, h, None, None] * x[:, t, h, :, None] * B_[:, t, g, None, :])
            y[:, t, h] = (state[:, h] @ C_[:, t, g, :, None])[..., 0] + D[h] * x[:, t, h]
    return y, state


def _scan_inputs(Bb=2, S=40, H=8, P=4, G=4, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(Bb, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(Bb, S, H, generator=g) - 1)
    A_log = torch.randn(H, generator=g) * 0.3
    B_, C_ = (torch.randn(Bb, S, G, N, generator=g) for _ in range(2))
    return x, dt, A_log, B_, C_, torch.rand(H, generator=g)


@pytest.mark.parametrize("groups,chunk", [(1, 16), (2, 7), (4, 16), (8, 40)])
def test_grouped_scan_equals_a_step_by_step_recurrence(groups, chunk):
    """``ref.ssd_chunked_ref`` (what ``ops.ssd_op`` runs on the CPU), the
    oracle ``ref.ssd_ref`` and the reference's chunked scan, on grouped
    B/C, against the recurrence written out here: y and the final state."""
    x, dt, A_log, B_, C_, D = _scan_inputs(G=groups)
    want_y, want_st = _recurrence(x, dt, A_log, B_, C_, D)
    for y, st in (ref.ssd_chunked_ref(x, dt, A_log, B_, C_, D, chunk=chunk),
                  ops.ssd_op(x, dt, A_log, B_, C_, D, chunk=chunk),
                  ref.ssd_ref(x, dt, A_log, B_, C_, D)):
        torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(st, want_st, rtol=1e-4, atol=1e-4)
    for b in range(2):
        y = ref_nh.scan(x[b], dt[b], -torch.exp(A_log), B_[b], C_[b], D, chunk)
        torch.testing.assert_close(y, want_y[b], rtol=1e-4, atol=1e-4)


def test_one_group_of_four_dims_is_the_shared_scan_bit_for_bit():
    x, dt, A_log, B_, C_, D = _scan_inputs(G=1)
    for fn in (ref.ssd_chunked_ref, ref.ssd_ref):
        shared = fn(x, dt, A_log, B_[:, :, 0], C_[:, :, 0], D)
        grouped = fn(x, dt, A_log, B_, C_, D)
        assert all(torch.equal(a, b) for a, b in zip(shared, grouped))


def test_grouped_decode_step_equals_the_recurrence():
    x, dt, A_log, B_, C_, D = _scan_inputs(S=6, G=4)
    want_y, want_st = _recurrence(x, dt, A_log, B_, C_, D)
    state = torch.zeros_like(want_st)
    for t in range(6):
        y, state = mam.ssd_step(x[:, t], dt[:, t], A_log, B_[:, t], C_[:, t], D, state)
        torch.testing.assert_close(y, want_y[:, t], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, want_st, rtol=1e-5, atol=1e-5)


def _zamba2_mixer_as_before(cfg, p, x):
    """zamba2's mixer as the port computed it before B/C groups: B and C
    sliced at state_dim, one RMSNorm over d_in at eps 1e-6."""
    s = cfg.ssm
    d_in, heads, _ = mam.mamba_dims(cfg)
    B, S, _ = x.shape
    proj = x @ p["in_proj"]
    z, conv_in, dt_raw = (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * s.state_dim],
                          proj[..., 2 * d_in + 2 * s.state_dim:])
    conv_out, carry = mam._causal_conv(conv_in, p["conv_w"], p["conv_b"])
    Bc, Cc = conv_out[..., d_in:d_in + s.state_dim], conv_out[..., d_in + s.state_dim:]
    dt = torch.nn.functional.softplus(dt_raw.float() + p["dt_bias"])
    y, state = ref.ssd_chunked_ref(conv_out[..., :d_in].reshape(B, S, heads, s.head_dim), dt,
                                   p["A_log"], Bc, Cc, p["D"], chunk=s.chunk_size)
    y = rms_norm(y.reshape(B, S, d_in).to(x.dtype) * torch.nn.functional.silu(z),
                 p["norm_scale"])
    return y @ p["out_proj"], state, carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_group_leaves_zamba2s_mixer_bit_for_bit(dtype):
    cfg = dataclasses.replace(registry.get_smoke("zamba2-2.7b"), dtype=dtype, param_dtype=dtype)
    assert cfg.ssm.n_groups == 1 and cfg.norm_eps is None
    p = mam.mamba_init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 21, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(
        getattr(torch, dtype))
    got = mam.mamba_forward(cfg, p, x, use_kernels=False)
    want = _zamba2_mixer_as_before(cfg, p, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_param_count_counts_every_parameter():
    cfg = _cfg()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    assert cfg.param_count() == n
    full = registry.get(ARCH)
    assert (full.num_layers, len(full.hybrid_pattern)) == (49, 98)
    assert round(full.param_count() / 1e9, 1) == 24.5  # the first pipeline stage and the head


def test_the_family_refuses_what_it_cannot_serve():
    cfg = _cfg()
    params = _params(cfg)
    toks = _tokens(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        lm.prefill_extend(cfg, params, toks, None, None, 0)
    with pytest.raises(NotImplementedError, match="one device"):
        lm.forward(cfg, params, toks, ctx=object())
    with pytest.raises(ValueError, match="hybrid_pattern"):
        lm.init_params(dataclasses.replace(cfg, hybrid_pattern="M-"), None, "meta")
    with pytest.raises(ValueError, match="do not divide"):
        mam.mamba_dims(_cfg(groups=3))


def test_the_cpu_engine_decodes_eagerly_and_traces_the_mixers():
    """On the CPU the engine decodes eagerly, its tokens those of
    ``lm.decode_step`` greedy; the prefill span carries the layer counts
    and the state's bytes, and holds one ``model.mamba`` span a mixer."""
    cfg = _cfg()
    params = _params(cfg)
    eng = Engine(cfg, params, max_len=40, device="cpu")
    prompts = _tokens(cfg, 3, 20, seed=9).numpy()
    exp = InMemoryExporter()
    with use_tracer(Tracer(exporters=[exp])):
        out = eng.generate(prompts, max_new=6)
    logits, cache = lm.prefill(cfg, params, torch.as_tensor(prompts), cache_len=40)
    want = []
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for i in range(6):
        want.append(tok.numpy())
        if i < 5:
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
    np.testing.assert_array_equal(out, np.concatenate(want, axis=1))
    st = eng.stats
    assert (st.decode_eager_steps, st.decode_graph_replays) == (5, 0)
    _, heads, conv_ch = mam.mamba_dims(cfg)
    s = cfg.ssm
    n_m = PATTERN.count("M")
    state = n_m * 3 * (heads * s.head_dim * s.state_dim + (s.conv_dim - 1) * conv_ch) * 4
    assert st.ssm_state_bytes == state == lm.state_bytes(cache)
    spans = exp.spans
    (pre,) = [s for s in spans if s["name"] == "engine.prefill"]
    assert pre["attrs"] == {"batch": 3, "tokens": 20, "prefix": "none", "mamba_layers": n_m,
                            "attention_layers": 2, "ssm_state_bytes": state}
    mixers = [s for s in spans if s["name"] == "model.mamba"]
    assert [s["attrs"]["layer"] for s in mixers] == [i for i, k in enumerate(PATTERN) if k == "M"]
    assert all(s["parent_id"] == pre["span_id"] for s in mixers)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    """The card's device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the card tests on the GPU machine)")
    return "cuda:0"


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Ns", [128, 256])
def test_the_ssd_kernel_at_nemotron_hs_state_and_groups(card, Ns, dtype):
    """B 2, H 16 heads of 64 in 8 groups (two heads a group), S 37 and 300,
    x, B and C strided views of one conv output as the model slices it;
    against the chunked plain version (chunk 64) and the oracle, y and
    state, at chip_smoke's scan tolerance (atol 5e-4 x max(1, max|plain|),
    rtol 1e-3: both sides fp32, the sums in other orders)."""
    from repro_torch.kernels.ssd import ssd

    g = torch.Generator(device=card).manual_seed(Ns)
    H, P, G = 16, 64, 8
    for S in (37, 300):
        conv = torch.nn.functional.silu(
            0.5 * torch.randn(2, S, H * P + 2 * G * Ns, generator=g, device=card))
        conv = conv.to(getattr(torch, dtype))
        x = conv[..., :H * P].unflatten(-1, (H, P))
        B_ = conv[..., H * P:H * P + G * Ns].unflatten(-1, (G, Ns))
        C_ = conv[..., H * P + G * Ns:].unflatten(-1, (G, Ns))
        dt = torch.nn.functional.softplus(torch.randn(2, S, H, generator=g, device=card) - 2)
        A_log = 0.3 * torch.randn(H, generator=g, device=card)
        D = torch.rand(H, generator=g, device=card)
        y, st = ssd(x, dt, A_log, B_, C_, D)
        for yr, sr in (ref.ssd_chunked_ref(x, dt, A_log, B_, C_, D, chunk=64),
                       ref.ssd_ref(x, dt, A_log, B_, C_, D)):
            for got, want in ((y, yr), (st, sr)):
                tol = 5e-4 * max(1.0, float(want.abs().max()))
                assert ((got - want).abs() <= tol + 1e-3 * want.abs()).all()


@pytest.mark.card
def test_graph_decode_equals_an_eager_decode_at_published_widths(card):
    """The published widths at 4 layers (Mamba-2, MLP, Mamba-2, attention):
    ``Engine.generate``'s tokens, which replay the graph from the second
    step on, equal an eager loop's; one capture, every later step a replay."""
    from repro_torch.serving.sampler import sample_token

    cfg = dataclasses.replace(registry.get(ARCH), num_layers=4, hybrid_pattern="M-M*")
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    prompts = np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 300)).astype(np.int32)
    max_new = 16
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, torch.as_tensor(prompts, device=card),
                                   cache_len=300 + max_new)
        want = []
        tok = sample_token(logits[:, -1])
        for i in range(max_new):
            want.append(tok.cpu().numpy())
            if i + 1 < max_new:
                logits, cache = lm.decode_step(cfg, params, cache, tok)
                tok = sample_token(logits[:, -1])
        eng = Engine(cfg, params, max_len=300 + max_new, device=card)
        got = eng.generate(prompts, max_new=max_new)
        again = eng.generate(prompts, max_new=max_new)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    np.testing.assert_array_equal(again, got)
    st = eng.stats
    assert (st.decode_eager_steps, st.decode_graph_captures) == (1, 1)
    assert st.decode_graph_replays == 2 * (max_new - 1) - 1
