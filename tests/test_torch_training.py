"""The port's training stack (``repro_torch.training``, ``distributed.fault``,
``launch.train``, the model's training path) against ``repro``'s on the CPU,
on the same inputs drawn from numpy with fixed seeds.

Tolerances, each stated where it is used: fp32 optimizer updates and the
cross-entropy within 1e-6 relative (the same fp32 formulas, XLA fusing some
of them); the int8 payloads bit for bit (both round half to even); loss and
gradients of the six families' smoke configs in fp32 within 1e-5 relative
(loss) and 1e-4 of each gradient's largest entry (sums in other orders);
two full train steps likewise, their parameters also within 1e-2 * lr a
step (AdamW's first steps move an entry by ~lr * g / |g|, so an entry
whose gradient is near 0 turns a tiny gradient difference into a visible
step difference)."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sim.clock import VirtualClock  # noqa: E402
from repro.training import grad_compress as jgc  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed.fault import (  # noqa: E402
    FaultEvent,
    FaultPolicy,
    FaultSchedule,
    FaultTolerantRunner,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.training import grad_compress as tgc  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

FAMILY_ARCHS = ["olmo-1b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b", "qwen2-vl-7b",
                "whisper-tiny"]


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_close(got, want, rel, atol=0.0):
    """max |got - want| <= rel * max |want| + atol (relative to the largest
    entry)."""
    got, want = _n(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0.0, 1e-30) + atol, (err, rel)


# -- cross-entropy ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, 128, 515, 1000])
def test_cross_entropy_matches_reference(dtype, chunk):
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 8, 515) * 3).astype(np.float32)
    labels = rng.randint(0, 515, (2, 8)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = float(jts.cross_entropy(jl, jnp.asarray(labels), chunk_vocab=chunk))
    got = tts.cross_entropy(tl, torch.from_numpy(labels), chunk_vocab=chunk).item()
    assert abs(got - want) <= 1e-6 * abs(want)  # fp32 logsumexp in either order
    plain = tts.cross_entropy(tl, torch.from_numpy(labels)).item()
    assert abs(got - plain) <= 1e-5  # chunked against unchunked (the reference's bound)


# -- optimizers ------------------------------------------------------------------


def _opt_tree(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(6, 5).astype(dtype), "blocks": [
        {"a": rs.randn(3, 4, 2).astype(np.float32), "b": rs.randn(7).astype(np.float32)},
        {"a": rs.randn(3, 4, 2).astype(np.float32), "b": rs.randn(7).astype(np.float32)}]}


def _to_t(tree):
    return jax.tree.map(_t, tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1e9, 0.5])
def test_adamw_matches_reference(state_dtype, grad_clip):
    cfg_kw = dict(lr=0.05, weight_decay=0.1, grad_clip=grad_clip, state_dtype=state_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    pj = jax.tree.map(jnp.asarray, _opt_tree(0))
    pt = _to_t(_opt_tree(0))
    sj, st = jopt.adamw_init(pj, jcfg), topt.adamw_init(pt, tcfg)
    for step in range(4):
        g = _opt_tree(10 + step)
        pj, sj, mj = jopt.adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, jcfg)
        pt, st, mt = topt.adamw_update(pt, _to_t(g), st, tcfg)
        assert abs(mt["grad_norm"].item() - float(mj["grad_norm"])) <= 1e-6 * float(
            mj["grad_norm"])
    # fp32 within 1e-6 of each leaf's largest; bf16 states within one bf16 ulp
    rel = 1e-6 if state_dtype == "float32" else 2 ** -8
    for got, want in zip(jax.tree.leaves(pt), jax.tree.leaves(pj)):
        _rel_close(got, want, 1e-6)
    for key in ("m", "v"):
        for got, want in zip(jax.tree.leaves(st[key]), jax.tree.leaves(sj[key])):
            assert got.dtype == (torch.bfloat16 if state_dtype == "bfloat16" else torch.float32)
            _rel_close(got, np.asarray(want, np.float32), rel)
    assert int(st["step"]) == int(sj["step"]) == 4 and st["step"].dtype == torch.int32


def test_adamw_bias_correction_is_fp32():
    """b1 ** step is taken in fp32 (a Python power would be fp64); the
    reference's manual case (tests/test_training.py) holds."""
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    cfg = topt.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, grad_clip=1e9)
    newp, st, _ = topt.adamw_update(p, g, topt.adamw_init(p, cfg), cfg)
    m = 0.1 * g["w"].numpy()
    v = 0.001 * g["w"].numpy() ** 2
    ref = p["w"].numpy() - 0.1 * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0, 3.0]))  # functional: input untouched


def test_global_norm_matches_reference():
    tree = _opt_tree(3)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(topt.global_norm(_to_t(tree)).item() - want) <= 1e-6 * want


def test_adafactor_matches_reference():
    pj = jax.tree.map(jnp.asarray, _opt_tree(1))
    pt = _to_t(_opt_tree(1))
    sj, st = jopt.adafactor_init(pj), topt.adafactor_init(pt)
    for step in range(3):
        g = _opt_tree(20 + step)
        pj, sj = jopt.adafactor_update(pj, jax.tree.map(jnp.asarray, g), sj, lr=0.01)
        pt, st = topt.adafactor_update(pt, _to_t(g), st, lr=0.01)
    for got, want in zip(jax.tree.leaves(pt), jax.tree.leaves(pj)):
        _rel_close(got, want, 1e-6)
    for got, want in zip(jax.tree.leaves(st["vs"]), jax.tree.leaves(sj["vs"])):
        _rel_close(got, want, 1e-5)
    assert int(st["step"]) == 3


# -- int8 gradient compression ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_quantize_int8_matches_reference(n):
    x = (np.random.RandomState(n).randn(n) * 3).astype(np.float32)
    x[::7] = 0.0
    pj, pt = jgc.quantize_int8(jnp.asarray(x)), tgc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(pt["q"].numpy(), np.asarray(pj["q"]))  # bit for bit
    np.testing.assert_array_equal(pt["scale"].numpy(), np.asarray(pj["scale"]))
    assert (pt["pad"], tuple(pt["shape"])) == (pj["pad"], tuple(pj["shape"]))
    np.testing.assert_array_equal(tgc.dequantize_int8(pt).numpy(),
                                  np.asarray(jgc.dequantize_int8(pj)))
    assert tgc.compression_ratio(torch.from_numpy(x)) == jgc.compression_ratio(jnp.asarray(x))


def test_round_half_to_even_in_quantize():
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 250, np.float32)
    np.testing.assert_array_equal(tgc.quantize_int8(torch.from_numpy(x))["q"].numpy(),
                                  np.asarray(jgc.quantize_int8(jnp.asarray(x))["q"]))


def test_error_feedback_matches_reference():
    rng = np.random.RandomState(1)
    ej = et = None
    total_recon = np.zeros(300, np.float32)
    total_g = np.zeros(300, np.float32)
    for i in range(20):
        g = (rng.randn(300) * (1 + i)).astype(np.float32)
        pj, ej = jgc.compress_with_ef(jnp.asarray(g), ej)
        pt, et = tgc.compress_with_ef(torch.from_numpy(g), et)
        np.testing.assert_array_equal(pt["q"].numpy(), np.asarray(pj["q"]))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        total_recon += tgc.dequantize_int8(pt).numpy()
        total_g += g
    # the residual carries over: the reference's error-feedback property
    np.testing.assert_allclose(total_recon + et.numpy(), total_g, atol=1e-2)
    state = tgc.ef_state_init({"a": torch.ones(3), "b": [torch.ones(2, 2)]})
    assert all(torch.equal(t, torch.zeros_like(t)) for t in tree_leaves(state))


def test_compressed_allreduce_waits_for_multi_device():
    """The int8 all-reduce over a mesh axis of one rank (a gloo group of
    one in this process) is the error-feedback round trip of
    ``compress_with_ef``: the mean of one gradient through its int8 payload,
    and its residual. The multi-rank cases are in test_torch_parallel.py."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.mesh_compat import Mesh

    rng = np.random.default_rng(3)
    g = {"a": torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32)),
         "b": [torch.from_numpy(rng.standard_normal(7).astype(np.float32))]}
    ef = {"a": torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32)) * 1e-3,
          "b": [torch.zeros(7)]}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            out, new_ef = tgc.compressed_allreduce(g, ef, Mesh((1,), ("data",)), "data")
        finally:
            dist.destroy_process_group()
    for gt, et, ot, nt in zip(tree_leaves(g), tree_leaves(ef), tree_leaves(out),
                              tree_leaves(new_ef)):
        payload, resid = tgc.compress_with_ef(gt, et)
        assert torch.equal(ot, tgc.dequantize_int8(payload))
        assert torch.equal(nt, resid)


# -- loss and gradients of every family --------------------------------------------


def _cfgs(arch, dtype="float32"):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(jregistry.get_smoke(arch), **kw),
            dataclasses.replace(tregistry.get_smoke(arch), **kw))


def _batches(jcfg, B=2, S=24, seed=5):
    """The same batch for both packages: tokens (vlm: embeds with (3, B, S)
    M-RoPE positions), labels, audio frames."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(16, 400, (B, S + 1))
    toks[:, 1::2] = toks[:, 0:-1:2]
    nb = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if jcfg.family == "audio":
        nb["frames"] = rs.randn(B, jcfg.encoder.num_frames, jcfg.d_model).astype(np.float32)
    if jcfg.family == "vlm":
        ar = np.arange(S)[None].repeat(B, 0)
        nb = {"embeds": (rs.randn(B, S, jcfg.d_model) * 0.02).astype(np.float32),
              "positions": np.stack([ar, ar * 2, ar * 3]).astype(np.int32),
              "labels": nb["labels"]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _pair(arch, seed=3, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, pj, tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jcfg, tcfg, pj, pt = _pair(arch)
    jb, tb = _batches(jcfg)
    (lj, mj), gj = jax.value_and_grad(lambda p: jts.loss_fn(jcfg, p, jb), has_aux=True)(pj)
    lt, mt, gt = tts.value_and_grad(tcfg, pt, tb)
    assert abs(lt.item() - float(lj)) <= 1e-5 * abs(float(lj))
    assert abs(mt["aux"].item() - float(mj["aux"])) <= 1e-5 * max(abs(float(mj["aux"])), 1e-30)
    if arch == "granite-moe-1b-a400m":
        assert mt["aux"].item() > 0  # the MoE's load-balancing loss is in the loss
    want = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, gj))
    for got, w in zip(tree_leaves(gt), tree_leaves(want)):
        _rel_close(got, w.numpy(), 1e-4)


def test_training_path_launches_no_kernel_wrapper(monkeypatch):
    """loss_fn and its backward reach none of kernels/ops.py's wrappers, for
    every family (the wrappers are replaced by ones that raise)."""
    def refuse(*a, **kw):
        raise AssertionError("the training path called a kernel wrapper")

    for name in ("flash_attention_op", "decode_attention_op", "paged_decode_attention_op",
                 "wkv6_op", "ssd_op", "batch_topk", "resident_topk"):
        monkeypatch.setattr(ops, name, refuse)
    for arch in FAMILY_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        params = tlm.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
        live = tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = tts.loss_fn(tcfg, live, _batches(jcfg)[1])
        loss.backward()
        leaves = tree_leaves(live)
        assert sum(p.grad is not None for p in leaves) > len(leaves) // 2
    with pytest.raises(AssertionError, match="kernel wrapper"):  # serving still launches them
        tlm.prefill(tcfg, params, _batches(jcfg)[1]["tokens"], frames=_batches(jcfg)[1]["frames"])


def test_refuse_grad_guard():
    """The CUDA branches' guard: raises under grad mode for an input that
    requires grad, and only then."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops._refuse_grad("flash_attention", torch.ones(2), x)
    ops._refuse_grad("flash_attention", torch.ones(2))
    with torch.no_grad():
        ops._refuse_grad("flash_attention", x)


def test_chunked_attention_matches_reference():
    """flash_attention_chunked (the training path past 512 positions)
    against the reference's flash_attention_jnp, causal and not, with a
    ragged last block."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    rs = np.random.RandomState(2)
    q = rs.randn(2, 37, 4, 16).astype(np.float32)
    k = rs.randn(2, 37, 2, 16).astype(np.float32)
    v = rs.randn(2, 37, 2, 16).astype(np.float32)
    for causal in (True, False):
        want = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         chunk=16, causal=causal)
        got = tattn.flash_attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), chunk=16, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        naive = tattn.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(naive.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- train steps -----------------------------------------------------------------------


def _compare_state(tcfg, pt, st, pj, sj, rel, lr):
    steps = int(sj["step"])
    for got, w in zip(tree_leaves(pt), tree_leaves(tlm.params_from_jax(
            tcfg, jax.tree.map(np.asarray, pj)))):
        _rel_close(got, w.numpy(), rel, atol=1e-2 * lr * steps)
    for key in ("m", "v"):  # the optimizer state through the same layer mapping
        want = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, sj[key]))
        for got, w in zip(tree_leaves(st[key]), tree_leaves(want)):
            _rel_close(got, w.numpy(), rel)
    assert int(st["step"]) == int(sj["step"])


def test_two_train_steps_match_reference():
    jcfg, tcfg, pj, pt = _pair("olmo-1b")
    kw = dict(lr=2e-3)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**kw)))
    tstep = tts.make_train_step(tcfg, topt.AdamWConfig(**kw))
    sj, st = jopt.adamw_init(pj, jopt.AdamWConfig(**kw)), topt.adamw_init(pt, topt.AdamWConfig(
        **kw))
    for i in range(2):
        jb, tb = _batches(jcfg, B=4, seed=i)
        pj, sj, mj = jstep(pj, sj, jb)
        pt, st, mt = tstep(pt, st, tb)
        assert abs(mt["loss"].item() - float(mj["loss"])) <= 1e-5 * float(mj["loss"])
        assert abs(mt["grad_norm"].item() - float(mj["grad_norm"])) <= 1e-4 * float(
            mj["grad_norm"])
    _compare_state(tcfg, pt, st, pj, sj, 1e-4, kw["lr"])


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b"])
def test_microbatch_matches_reference(arch):
    """Gradient accumulation over 2 microbatches (qwen2-vl: the (3, B, S)
    positions split on their batch axis) against the reference's. eps = 1
    keeps AdamW's step linear in the gradient, so the parameters show the
    accumulated gradients' difference unamplified (1e-4 of each leaf's
    largest, no lr term)."""
    jcfg, tcfg, pj, pt = _pair(arch)
    cfg = dict(lr=2e-3, eps=1.0)
    jb, tb = _batches(jcfg, B=4)
    pj2, sj, mj = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**cfg), microbatch=2))(
        pj, jopt.adamw_init(pj, jopt.AdamWConfig(**cfg)), jb)
    pt2, st, mt = tts.make_train_step(tcfg, topt.AdamWConfig(**cfg), microbatch=2)(
        pt, topt.adamw_init(pt, topt.AdamWConfig(**cfg)), tb)
    assert set(mt) == set(mj) == {"loss", "grad_norm"}
    assert abs(mt["loss"].item() - float(mj["loss"])) <= 1e-5 * float(mj["loss"])
    _compare_state(tcfg, pt2, st, pj2, sj, 1e-4, 0.0)


def test_microbatch_equivalence():
    """tests/test_training.py's case on the port: 4 microbatches against one
    batch, bf16 parameters (accumulation-order drift only)."""
    cfg = tregistry.get_smoke("olmo-1b")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = topt.AdamWConfig(lr=2e-3)
    opt = topt.adamw_init(params, opt_cfg)
    batch = ttrain.synthetic_batches(cfg, 8, 24)(0)
    p1, _, _ = tts.make_train_step(cfg, opt_cfg)(params, opt, batch)
    p2, _, _ = tts.make_train_step(cfg, opt_cfg, microbatch=4)(params, opt, batch)
    d = max((a.float() - b.float()).abs().max().item()
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-2


def test_loss_decreases():
    cfg = tregistry.get_smoke("olmo-1b")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = topt.AdamWConfig(lr=2e-3)
    opt = topt.adamw_init(params, opt_cfg)
    step = tts.make_train_step(cfg, opt_cfg)
    batches = ttrain.synthetic_batches(cfg, 4, 24)
    losses = []
    for i in range(25):
        params, opt, m = step(params, opt, batches(i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.05, losses[::6]
    assert all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny", "qwen2-vl-7b"])
def test_synthetic_batches_match_reference(arch):
    jcfg, tcfg = jregistry.get_smoke(arch), tregistry.get_smoke(arch)
    jb = jtrain.synthetic_batches(jcfg, 3, 10)(7)
    tb = ttrain.synthetic_batches(tcfg, 3, 10)(7)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)


def test_train_entry_point_runs_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--steps", "4", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert ttrain.main(args) == 0
    out = capsys.readouterr().out
    assert "arch=olmo-1b-smoke" in out and "done: 4 steps" in out
    assert CheckpointStore(tmp_path).committed_steps() == [2, 4]
    assert ttrain.main(args) == 0  # a new process resumes at step 4: nothing to run
    assert "resumed at step 4" in capsys.readouterr().out


@pytest.mark.parametrize("arch", list(tregistry.ARCH_NAMES))
def test_param_count_matches_reference(arch):
    assert tregistry.get(arch).param_count() == jregistry.get(arch).param_count()
    assert tregistry.get_smoke(arch).param_count() == jregistry.get_smoke(arch).param_count()


# -- the fault-tolerant runner ------------------------------------------------------


def _counter_stepper():
    def step(state, batch):
        return state + 1, {"loss": 1.0 / (state + 1)}

    return step


def test_fault_runner_nan_rollback(tmp_path):
    r = FaultTolerantRunner(_counter_stepper(), CheckpointStore(tmp_path, keep_last=3),
                            FaultPolicy(checkpoint_every=5))
    r.inject(12, "nan")
    state, completed, events = r.run(0, lambda s: None, 20)
    assert completed == 20
    assert any(e.kind == "nan" for e in events)
    assert state >= 20


def test_fault_runner_worker_loss_resume(tmp_path):
    r = FaultTolerantRunner(_counter_stepper(), CheckpointStore(tmp_path, keep_last=3),
                            FaultPolicy(checkpoint_every=4))
    r.inject(9, "worker_lost")
    state, completed, events = r.run(0, lambda s: None, 15)
    assert completed == 15
    assert any(e.kind == "worker_lost" for e in events)


def test_fault_runner_resumes_from_existing_checkpoint(tmp_path):
    store = CheckpointStore(tmp_path, keep_last=3)
    FaultTolerantRunner(_counter_stepper(), store, FaultPolicy(checkpoint_every=5)).run(
        0, lambda s: None, 10)
    r2 = FaultTolerantRunner(_counter_stepper(), store, FaultPolicy(checkpoint_every=5))
    state, completed, _ = r2.run(0, lambda s: None, 12)
    assert completed == 12


def test_fault_runner_straggler_detected_on_virtual_clock(tmp_path):
    clock = VirtualClock()
    seen = {"straggled": False}

    def stepper(state, batch):
        if state == 15 and not seen["straggled"]:
            seen["straggled"] = True
            clock.advance(10.0)  # one pathological step
        else:
            clock.advance(0.1)
        return state + 1, {"loss": 1.0 / (state + 1)}

    policy = FaultPolicy(checkpoint_every=5, min_steps_for_deadline=5, step_deadline_factor=5.0,
                         min_deadline_s=0.5)
    r = FaultTolerantRunner(stepper, CheckpointStore(tmp_path, keep_last=3), policy, clock=clock)
    state, completed, events = r.run(0, lambda s: None, 25)
    assert completed == 25
    stalls = [e for e in events if e.kind == "stall"]
    assert len(stalls) == 1 and stalls[0].action == "rollback"


def test_fault_runner_healthy_virtual_cadence_never_stalls(tmp_path):
    clock = VirtualClock()

    def stepper(state, batch):
        clock.advance(0.1)
        return state + 1, {"loss": 1.0}

    r = FaultTolerantRunner(stepper, CheckpointStore(tmp_path, keep_last=3),
                            FaultPolicy(checkpoint_every=10), clock=clock)
    _, completed, events = r.run(0, lambda s: None, 30)
    assert completed == 30 and events == []


def test_fault_schedule_shared_inject_path():
    fs = FaultSchedule()
    fs.inject(3, "crash", node="cache-1")
    fs.inject(3, "lag", steps=5)
    assert fs.pending() == 2 and bool(fs)
    specs = fs.pop(3)
    assert [s.kind for s in specs] == ["crash", "lag"]
    assert specs[0].details == {"node": "cache-1"}
    assert fs.pop(3) == [] and not fs


def test_fault_runner_sees_a_nan_in_a_tensor_metric(tmp_path):
    """A NaN loss left in a tensor (as a train step on the card returns it)
    is caught and rolled back."""
    def stepper(state, batch):
        bad = state == 7 and not seen
        if bad:
            seen.append(state)
        loss = torch.tensor(float("nan") if bad else 1.0 / (state + 1))
        return state + 1, {"loss": loss, "grad_norm": torch.tensor(1.0)}

    seen = []
    r = FaultTolerantRunner(stepper, CheckpointStore(tmp_path, keep_last=2),
                            FaultPolicy(checkpoint_every=5))
    state, completed, events = r.run(0, lambda s: None, 10)
    assert events == [FaultEvent(7, "nan", "rollback")] and completed == 10
    assert not r._is_bad({"loss": torch.tensor(2.0), "note": "text", "vec": torch.ones(3)})


def test_fault_runner_matches_reference_on_one_fault_plan(tmp_path):
    """The same faults on the same counter stepper: equal states, steps and
    events in both packages."""
    out = []
    for fmod, store in ((jfault, JStore(tmp_path / "j", keep_last=2)),
                        (None, CheckpointStore(tmp_path / "t", keep_last=2))):
        runner_cls = jfault.FaultTolerantRunner if fmod else FaultTolerantRunner
        policy = (jfault.FaultPolicy if fmod else FaultPolicy)(checkpoint_every=3)
        r = runner_cls(_counter_stepper(), store, policy)
        r.inject(4, "nan")
        r.inject(8, "worker_lost")
        r.inject(8, "stall")
        r.inject(11, "stall")
        state, completed, events = r.run(0, lambda s: None, 14)
        out.append((int(state), completed, [(e.step, e.kind, e.action) for e in events],
                    store.committed_steps()))
    assert out[1] == out[0]
