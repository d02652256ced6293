"""The Mamba-2 prefill's causal conv kernel (``kernels/causal_conv.py``,
``csrc/causal_conv.cu``) and its op, ``kernels.ops.causal_conv_op``,
against the plain conv ``kernels/ref.py::causal_conv_ref``.

On the CPU: the op is the plain conv bit for bit, the plain conv is the
reference's, the launcher refuses what the kernel cannot take before it
looks for a card, and a prefill goes through the op once a Mamba-2 layer
(training not at all). On the card (``python3 -m pytest -m card
tests/test_torch_causal_conv.py``; skipped without one), what
``chip_smoke.py``'s ``check_causal_conv`` and ``time_causal_conv`` do
not cover: short prompts and tile edges bit for bit, one launch a call,
and a prefill of the nemotron-h-47b cell's 49 layers launching it once a
Mamba-2 layer (24)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kernel_table  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import causal_conv as causal_conv_launcher  # noqa: E402
from repro_torch.kernels.causal_conv import causal_conv  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from torch_card import card  # noqa: E402,F401

K = 4


def _inputs(B, S, width, col, CH, dtype=torch.float32, device="cpu", seed=0, carry=False):
    """xc the columns [col, col + CH) of an in_proj output (B, S, width)
    drawn N(0, 1) in ``dtype``; w 0.25 + 0.1 N(0, 1) (K, CH) and b 0.1
    N(0, 1) in fp32; prev (B, K-1, CH) N(0, 1) in ``dtype`` or None."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)

    xc = rnd(B, S, width).to(dtype)[..., col:col + CH]
    w, b = 0.25 + 0.1 * rnd(K, CH), 0.1 * rnd(CH)
    return xc, w, b, rnd(B, K - 1, CH).to(dtype) if carry else None


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("S", [2, 1, 64], ids=["S_below_taps", "S1", "S64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_op_on_the_cpu_is_the_plain_conv_bit_for_bit(dtype, S, carry):
    xc, w, b, prev = _inputs(3, S, 40, 8, 24, dtype=dtype, carry=carry)
    y, c = ops.causal_conv_op(xc, w, b, prev)
    want_y, want_c = ref.causal_conv_ref(xc, w, b, prev)
    assert y.dtype == c.dtype == dtype
    assert torch.equal(y, want_y) and torch.equal(c, want_c)
    assert y.shape == (3, S, 24) and c.shape == (3, K - 1, 24)


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_the_plain_conv_is_the_references(carry):
    """The oracle the kernel is held to: the reference's ``_causal_conv``
    on the same numbers, in float32; the model's ``_causal_conv`` is it."""
    import jax.numpy as jnp

    from repro.models import mamba as jmam

    xc, w, b, prev = _inputs(2, 5, 24, 0, 24, carry=carry, seed=4)
    assert mam._causal_conv is ref.causal_conv_ref
    y, c = ref.causal_conv_ref(xc, w, b, prev)
    jy, jc = jmam._causal_conv(jnp.asarray(xc.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(b.numpy()),
                               None if prev is None else jnp.asarray(prev.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=0)


def _cpu_call(**change):
    """The launcher's arguments at a layout it takes, on the CPU, with
    ``change`` applied."""
    xc, w, b, prev = _inputs(2, 9, 48, 8, 32, carry=True)
    args = dict(xc=xc, w=w, b=b, prev=prev)
    args.update({k: f(args) for k, f in change.items()})
    return args


REFUSALS = {
    "mixed_devices": (dict(prev=lambda a: torch.empty_like(a["prev"], device="meta")),
                      "one device"),
    "requires_grad": (dict(w=lambda a: a["w"].clone().requires_grad_()), "requires grad"),
    "xc_float16": (dict(xc=lambda a: a["xc"].half(), prev=lambda a: a["prev"].half()),
                   "float32, bfloat16"),
    "prev_of_another_dtype": (dict(prev=lambda a: a["prev"].bfloat16()), "float32, bfloat16"),
    "w_bfloat16": (dict(w=lambda a: a["w"].bfloat16()), "must be float32"),
    "three_taps": (dict(w=lambda a: a["w"][:3], prev=lambda a: a["prev"][:, :2]), "taps"),
    "five_taps": (dict(w=lambda a: torch.cat([a["w"], a["w"][:1]]),
                       prev=lambda a: torch.cat([a["prev"], a["prev"][:, :1]], dim=1)), "taps"),
    "channels_not_a_multiple_of_8": (dict(xc=lambda a: a["xc"][..., :28],
                                          w=lambda a: a["w"][:, :28], b=lambda a: a["b"][:28],
                                          prev=lambda a: a["prev"][..., :28]), "multiple of 8"),
    "w_of_other_channels": (dict(w=lambda a: a["w"][:, :16]), "vs w"),
    "prev_of_other_rows": (dict(prev=lambda a: a["prev"][:1]), "vs w"),
    "xc_channels_strided": (dict(xc=lambda a: a["xc"].transpose(1, 2).contiguous()
                                 .transpose(1, 2)), "contiguous"),
    "xc_rows_unaligned": (dict(xc=lambda a: torch.zeros(2, 9, 49)[..., 1:33]), "16-byte"),
    "on_the_cpu": ({}, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_launcher_refuses_what_the_kernel_cannot_take(case, monkeypatch):
    """Before any build: each refusal raises ValueError, and a CPU call the
    kernel would take otherwise raises for want of a card."""
    monkeypatch.setattr(_build, "entry", lambda *a: pytest.fail("built a kernel"))
    change, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        causal_conv(**_cpu_call(**change))


def test_the_kernel_is_in_the_table_and_takes_the_registrys_taps():
    """The table's wrapper (its counter reset and added with the others),
    and the one K every Mamba-2 config of the registry has."""
    assert "causal_conv" in kernel_table.KERNELS
    assert kernel_table.launchers()["causal_conv"] is causal_conv
    taps = {registry.get(a).ssm.conv_dim for a in ("nemotron-h-47b", "zamba2-2.7b")}
    assert taps == {causal_conv_launcher.TAPS} == {K}


@pytest.mark.parametrize("arch", ["nemotron-h-47b", "zamba2-2.7b"])
def test_a_prefill_calls_the_op_once_a_mamba2_layer(arch, monkeypatch):
    """On the CPU a prefill reaches the plain conv through
    ``causal_conv_op``, once a Mamba-2 layer, with the logits and conv
    carries of the plain conv called directly; training
    (``use_kernels=False``) never calls the op."""
    cfg = registry.get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(1))
    calls = []
    real = ops.causal_conv_op
    with torch.no_grad():
        monkeypatch.setattr(ops, "causal_conv_op", lambda *a: calls.append(1) or real(*a))
        got, got_cache = lm.prefill(cfg, params, tokens, cache_len=9)
        mamba_layers = got_cache["ssm_state"].shape[:-4].numel()
        assert len(calls) == mamba_layers > 0
        monkeypatch.setattr(ops, "causal_conv_op", ref.causal_conv_ref)
        want, want_cache = lm.prefill(cfg, params, tokens, cache_len=9)
    assert torch.equal(got, want)
    assert torch.equal(got_cache["conv"], want_cache["conv"])
    del calls[:]
    monkeypatch.setattr(ops, "causal_conv_op", lambda *a: calls.append(1) or real(*a))
    lm.forward(cfg, params, tokens, use_kernels=False)
    assert not calls


# -- on the card -------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("S", [1, 2, 3, 8, 63, 64, 65, 130])
def test_short_prompts_and_tile_edges(card, S):
    """Prompts shorter than the taps (the carry partly the old one), each
    side of a 64-step tile, and a channel count that leaves a CTA part
    idle: y and the carry bit for bit, with and without a carry, in bf16
    and fp32, one launch a call."""
    for dtype in (torch.bfloat16, torch.float32):
        xc, w, b, prev = _inputs(3, S, 1200, 8, 1096, dtype=dtype, device=card, seed=S,
                                 carry=True)
        for given in (None, prev):
            launches = causal_conv.launches
            y, c = ops.causal_conv_op(xc, w, b, given)
            assert causal_conv.launches == launches + 1
            want_y, want_c = ref.causal_conv_ref(xc, w, b, given)
            assert y.is_contiguous() and c.is_contiguous()
            assert torch.equal(y, want_y) and torch.equal(c, want_c)


@pytest.mark.card
def test_a_prefill_of_the_cells_model_launches_it_once_a_mamba2_layer(card):
    """nemotron-h-47b at its 49 layers (the cell's config), 2 rows of 32
    tokens: 24 launches, and none in a decode step (decode keeps its window
    conv in the graph)."""
    cfg = registry.get("nemotron-h-47b")
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    prompts = torch.as_tensor(np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 32)),
                              device=card)
    kernel_table.reset_counts()
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, prompts, cache_len=34)
        assert causal_conv.launches == cfg.hybrid_pattern[:cfg.num_layers].count("M") == 24
        lm.decode_step(cfg, params, cache, logits[:, -1:].argmax(-1).int())
    torch.cuda.synchronize()
    assert causal_conv.launches == 24
