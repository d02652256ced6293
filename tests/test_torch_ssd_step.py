"""The Mamba-2 decode step's kernel (``kernels/ssd_step.py``,
``csrc/ssd_step.cu``) and its op, ``kernels.ops.ssd_step_op``, against the
plain step ``models/mamba.py::ssd_step``.

On the CPU: the op is the plain step bit for bit (and leaves the state it
was given as it was), the launcher refuses what the kernel cannot take
before it looks for a card, and the models' decode steps go through the op
once a Mamba-2 layer. On the card (``python3 -m pytest -m card
tests/test_torch_ssd_step.py``; skipped without one): the kernel against
the plain step at Nemotron-H's and zamba2's layouts, in bf16 and fp32, x,
B and C strided views of one conv output as the models slice them; the
state updated in its own storage; a captured graph's replays equal to
eager steps; and ``Engine.generate`` on the nemotron-h-47b cell's 49 layers
launching it once a Mamba-2 layer and step (24), with no copy of the
state, and a dense engine not at all."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kernel_table  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssd_step as ssd_step_launcher  # noqa: E402
from repro_torch.kernels.ssd import SHAPES  # noqa: E402
from repro_torch.kernels.ssd_step import ssd_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from torch_card import card  # noqa: E402,F401

# (B, H, P, Ns, G): Nemotron-H-47B's decode in the benchmark's cell, its
# state 128 (the smaller Nemotron-H models'), and zamba2-2.7b's (one group)
NEMOTRON_H = (16, 256, 64, 256, 8)
NEMOTRON_H_128 = (16, 256, 64, 128, 8)
ZAMBA2 = (4, 80, 64, 64, 1)


def _inputs(B, H, P, Ns, G, dtype=torch.float32, device="cpu", seed=0):
    """x, dt, A_log, B_, C_, D and a state, drawn as a decode step sees
    them: x, B_ and C_ strided views of one conv output (silu of 0.5
    N(0, 1)) in ``dtype``, B_/C_ (B, Ns) with one group, else (B, G, Ns);
    dt = softplus(N(0, 1) - 2), A_log 0.3 N(0, 1), D uniform; the state
    N(0, 1) in fp32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)

    n = G * Ns
    conv = torch.nn.functional.silu(0.5 * rnd(B, H * P + 2 * n)).to(dtype)
    bc = (Ns,) if G == 1 else (G, Ns)
    x = conv[:, :H * P].unflatten(-1, (H, P))
    B_, C_ = conv[:, H * P:H * P + n].unflatten(-1, bc), conv[:, H * P + n:].unflatten(-1, bc)
    dt = torch.nn.functional.softplus(rnd(B, H) - 2.0)
    A_log, D = 0.3 * rnd(H), torch.rand(H, generator=g, device=device)
    return x, dt, A_log, B_, C_, D, rnd(B, H, P, Ns)


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", [(2, 8, 32, 16, 4), (3, 6, 64, 64, 1), (2, 4, 64, 256, 2)],
                         ids=["groups", "one_group", "state_256"])
def test_the_op_on_the_cpu_is_the_plain_step_bit_for_bit(layout, dtype):
    x, dt, A_log, B_, C_, D, state = _inputs(*layout, dtype=dtype)
    before = state.clone()
    y, st = ops.ssd_step_op(x, dt, A_log, B_, C_, D, state)
    want_y, want_st = mam.ssd_step(x, dt, A_log, B_, C_, D, before.clone())
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert torch.equal(state, before) and st is not state  # out of place on the CPU


def _cpu_call(**change):
    """The launcher's arguments at a layout it takes, on the CPU, with
    ``change`` applied."""
    x, dt, A_log, B_, C_, D, state = _inputs(2, 8, 64, 128, 4)
    args = dict(x=x, dt=dt, A_log=A_log, B_=B_, C_=C_, D=D, state=state)
    args.update({k: f(args) for k, f in change.items()})
    return args


REFUSALS = {
    "mixed_devices": (dict(state=lambda a: torch.empty_like(a["state"], device="meta")),
                      "one device"),
    "x_float16": (dict(x=lambda a: a["x"].half(), B_=lambda a: a["B_"].half(),
                       C_=lambda a: a["C_"].half()), "float32, bfloat16"),
    "x_and_B_differ": (dict(B_=lambda a: a["B_"].bfloat16()), "float32, bfloat16"),
    "state_bfloat16": (dict(state=lambda a: a["state"].bfloat16()), "must be float32"),
    "dt_bfloat16": (dict(dt=lambda a: a["dt"].bfloat16()), "must be float32"),
    "head_dim_48": (dict(x=lambda a: a["x"][..., :48], state=lambda a: a["state"][:, :, :48]),
                    r"not in"),
    "state_dim_96": (dict(B_=lambda a: a["B_"][..., :96], C_=lambda a: a["C_"][..., :96],
                          state=lambda a: a["state"][..., :96].contiguous()), "not in"),
    "groups_not_dividing_heads": (dict(B_=lambda a: a["B_"][:, :3], C_=lambda a: a["C_"][:, :3]),
                                  "vs dt"),
    "state_of_other_heads": (dict(state=lambda a: a["state"][:, :4]), "vs dt"),
    "state_not_contiguous": (dict(state=lambda a: a["state"].transpose(0, 1).contiguous()
                                  .transpose(0, 1)), "contiguous"),
    "x_columns_strided": (dict(x=lambda a: a["x"].transpose(1, 2).contiguous().transpose(1, 2)),
                          "last dims"),
    "on_the_cpu": ({}, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_launcher_refuses_what_the_kernel_cannot_take(case, monkeypatch):
    """Before any build: each refusal raises ValueError, and a CPU call the
    kernel would take otherwise raises for want of a card."""
    monkeypatch.setattr(_build, "entry", lambda *a: pytest.fail("built a kernel"))
    change, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        ssd_step(**_cpu_call(**change))


def test_the_kernel_takes_every_shape_of_the_prefill_scan():
    """One algorithm for every (P, Ns) the scan kernel takes: the table and
    the C entry point's signature (8 pointers, dtype and 5 sizes, 8
    strides, the stream) are the launcher's."""
    assert "ssd_step" in kernel_table.KERNELS
    assert kernel_table.launchers()["ssd_step"] is ssd_step
    assert {ns for _, ns in SHAPES} == {16, 32, 64, 128, 256}
    assert ssd_step_launcher.SYMBOL == "ssd_step_fwd"
    assert len(ssd_step_launcher.ARGTYPES) == 8 + 6 + 8 + 1


@pytest.mark.parametrize("arch", ["nemotron-h-47b", "zamba2-2.7b"])
def test_a_decode_step_calls_the_op_once_a_mamba2_layer(arch, monkeypatch):
    """On the CPU the models' decode steps reach the plain step through
    ``ssd_step_op``, once a Mamba-2 layer, and their logits are those of the
    plain step called directly."""
    cfg = registry.get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = lm.prefill(cfg, params, tokens, cache_len=9)
        mamba_layers = cache["ssm_state"].shape[:-4].numel()
        calls = []
        real = ops.ssd_step_op
        monkeypatch.setattr(ops, "ssd_step_op", lambda *a: calls.append(1) or real(*a))
        base = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
        got, _ = lm.decode_step(cfg, params, cache, tokens[:, -1:])
        monkeypatch.setattr(ops, "ssd_step_op", mam.ssd_step)
        want, _ = lm.decode_step(cfg, params, base, tokens[:, -1:])
    assert len(calls) == mamba_layers > 0
    assert torch.equal(got, want)


# -- on the card -------------------------------------------------------------------


def _close(got, want):
    """chip_smoke's scan tolerance (atol 5e-4 x max(1, max|plain|), rtol
    1e-3): both sides fp32, the kernel fusing products the plain step
    rounds apart and summing y in another order."""
    tol = 5e-4 * max(1.0, float(want.abs().max()))
    assert ((got - want).abs() <= tol + 1e-3 * want.abs()).all()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("layout", [NEMOTRON_H, NEMOTRON_H_128, ZAMBA2],
                         ids=["nemotron_h", "nemotron_h_ns128", "zamba2"])
def test_the_kernel_equals_the_plain_step_in_place(card, layout, dtype):
    """y and the new state within the scan tolerance of the plain step; the
    state is the tensor given, updated in its own storage, and a second step
    from it still agrees."""
    x, dt, A_log, B_, C_, D, state = _inputs(*layout, dtype=dtype, device=card, seed=3)
    ptr, want_st = state.data_ptr(), state.clone()
    for _ in range(2):
        want_y, want_st = mam.ssd_step(x, dt, A_log, B_, C_, D, want_st)
        y, st = ops.ssd_step_op(x, dt, A_log, B_, C_, D, state)
        assert st is state and state.data_ptr() == ptr
        _close(y, want_y)
        _close(state, want_st)


@pytest.mark.card
def test_graph_replays_equal_eager_steps(card):
    """A step captured in a CUDA graph on static buffers, replayed over 5
    steps of new inputs, leaves the state and y bit for bit as the same 5
    steps taken eagerly from a copy of the state."""
    B, H, P, Ns, G = 4, 256, 64, 256, 8
    steps = [_inputs(B, H, P, Ns, G, dtype=torch.bfloat16, device=card, seed=10 + i)
             for i in range(5)]
    static = [t.clone() for t in steps[0]]
    eager_state = static[-1].clone()
    ops.ssd_step_op(*static[:-1], static[-1].clone())  # loads the library before capture
    launches = ssd_step.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, _ = ops.ssd_step_op(*static)
    assert ssd_step.launches == launches + 1
    for inputs in steps:
        for buf, t in zip(static[:-1], inputs[:-1]):
            buf.copy_(t)
        graph.replay()
        want_y, eager_state = ops.ssd_step_op(*inputs[:-1], eager_state)
        assert torch.equal(y, want_y) and torch.equal(static[-1], eager_state)


def _launches_in_replays(cfg, params, card, prompts, max_new):
    """``Engine.generate`` twice; ``ssd_step``'s launches in the second
    call, whose steps are all replays, and the engine."""
    eng = Engine(cfg, params, max_len=prompts.shape[1] + max_new, device=card)
    with torch.no_grad():
        eng.generate(prompts, max_new=max_new)  # the eager step and the capture
        kernel_table.reset_counts()
        eng.generate(prompts, max_new=max_new)
    return ssd_step.launches, eng.stats


@pytest.mark.card
def test_the_cells_engine_launches_it_once_a_mamba2_layer_and_step(card):
    """nemotron-h-47b at its 49 layers (the cell's config), 2 rows of 32
    tokens, 4 new: 24 launches a decode step, the first step eager and the
    rest replays. An eager step makes no device copy long enough to be a
    layer's state (33.5 MB, ~20 us to copy at 3.35 TB/s): the cache slot
    is the state the kernel updated, and ``copy_`` onto itself copies
    nothing. A dense engine launches it not at all."""
    from torch.profiler import ProfilerActivity, profile

    cfg = registry.get("nemotron-h-47b")
    assert cfg.hybrid_pattern[:cfg.num_layers].count("M") == 24
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    prompts = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    max_new = 4
    launches, stats = _launches_in_replays(cfg, params, card, prompts, max_new)
    assert (stats.decode_eager_steps, stats.decode_graph_captures) == (1, 1)
    assert launches == 24 * (max_new - 1)
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, torch.as_tensor(prompts, device=card),
                                   cache_len=32 + max_new)
        tok = logits[:, -1:].argmax(-1).int()
        lm.decode_step(cfg, params, cache, tok)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lm.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
    copies = [e.duration_ns() / 1e3 for e in prof.profiler.kineto_results.events()
              if "memcpy" in e.name().lower()]
    assert max(copies, default=0.0) < 5.0, copies
    del params, cache, logits
    torch.cuda.empty_cache()
    dense = registry.get("olmo-1b")
    params = lm.init_params(dense, torch.Generator(device=card).manual_seed(0), card)
    prompts = np.random.RandomState(5).randint(0, dense.vocab_size, (2, 32)).astype(np.int32)
    launches, stats = _launches_in_replays(dense, params, card, prompts, max_new)
    assert stats.decode_graph_replays > 0 and launches == 0
