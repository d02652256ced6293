"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against ``repro.kernels.ops`` — the Pallas kernels in interpret mode — on
the shape grids of tests/test_kernels.py. The CUDA kernels themselves are
checked against the same plain versions on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)

# tolerances of tests/test_kernels.py: the two sides sum in other orders
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, shapes, dtype):
    """Same values for both packages: f32 normals from numpy, rounded to
    bf16 on the JAX side and handed to torch through f32 (exact)."""
    rs = np.random.RandomState(seed)
    jdt = getattr(jnp, dtype)
    out_j, out_t = [], []
    for shape in shapes:
        x = jnp.asarray(rs.standard_normal(shape).astype(np.float32)).astype(jdt)
        out_j.append(x)
        out_t.append(torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)))
    return out_j, out_t


def _close(t, j, tol):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,hd,bq,bk",
    [
        (1, 4, 4, 128, 64, 64, 64),   # MHA
        (2, 8, 2, 256, 64, 128, 64),  # GQA 4:1
        (1, 8, 8, 192, 32, 64, 64),   # non-pow2 seq (192 = 3*64)
        (2, 4, 1, 128, 128, 64, 128), # MQA, wide head
    ],
)
def test_flash_attention_op_matches_pallas(B, Hq, Hkv, S, hd, bq, bk, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        0, [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)], dtype)
    oj = jops.flash_attention_op(qj, kj, vj, block_q=bq, block_k=bk)
    ot = ops.flash_attention_op(qt, kt, vt, causal=True)
    assert ot.shape == (B, S, Hq, hd) and ot.dtype == qt.dtype
    _close(ot, oj, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,M,hd,length,bk",
    [
        (2, 8, 2, 256, 64, 177, 64),
        (1, 4, 4, 512, 128, 512, 128),
        (3, 8, 1, 128, 64, 1, 64),  # single valid position
    ],
)
def test_decode_attention_op_matches_pallas(B, Hq, Hkv, M, hd, length, bk, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        1, [(B, 1, Hq, hd), (B, M, Hkv, hd), (B, M, Hkv, hd)], dtype)
    oj = jops.decode_attention_op(qj, kj, vj, jnp.asarray(length, jnp.int32), block_k=bk)
    ot = ops.decode_attention_op(qt, kt, vt, torch.tensor(length, dtype=torch.int32))
    assert ot.shape == (B, 1, Hq, hd) and ot.dtype == qt.dtype
    _close(ot, oj, DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,M,hd,lengths,bk",
    [
        (3, 8, 2, 256, 64, (17, 177, 256), 64),   # mixed-length batch
        (2, 4, 4, 128, 32, (1, 128), 64),         # extremes
        (4, 4, 1, 256, 64, (64, 64, 64, 64), 128),  # uniform via vector
    ],
)
def test_decode_attention_op_per_sequence_lengths(B, Hq, Hkv, M, hd, lengths, bk, dtype):
    """Each row masks to ITS OWN length, as the Pallas kernel does; and
    each row equals the row decoded alone (to fp32 rounding here: the
    bitwise pin is the CUDA kernel's, checked on the card)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        2, [(B, 1, Hq, hd), (B, M, Hkv, hd), (B, M, Hkv, hd)], dtype)
    oj = jops.decode_attention_op(qj, kj, vj, jnp.asarray(lengths, jnp.int32), block_k=bk)
    lens = torch.tensor(lengths, dtype=torch.int32)
    ot = ops.decode_attention_op(qt, kt, vt, lens)
    _close(ot, oj, DECODE_TOL[dtype])
    for b, ln in enumerate(lengths):
        ob = ops.decode_attention_op(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1],
                                     torch.tensor(ln, dtype=torch.int32))
        _close(ob, ot[b:b + 1].float().numpy(), 1e-6 if dtype == "float32" else 8e-3)


def test_plain_refs_match_repro_refs():
    """The port's plain versions are twins of repro.kernels.ref's oracles,
    in the kernels' (B, H, S, hd) layout, causal and not."""
    from repro.kernels import ref as jref

    (qj, kj, vj), (qt, kt, vt) = _inputs(3, [(2, 6, 40, 32), (2, 3, 40, 32), (2, 3, 40, 32)],
                                         "float32")
    for causal in (True, False):
        _close(tref.flash_attention_ref(qt, kt, vt, causal=causal),
               jref.flash_attention_ref(qj, kj, vj, causal=causal), 2e-6)
    lens = np.asarray([3, 40], np.int32)
    _close(tref.decode_attention_ref(qt[:, :, 0], kt, vt, torch.from_numpy(lens)),
           jref.decode_attention_ref(qj[:, :, 0], kj, vj, jnp.asarray(lens)), 2e-6)


def test_softcap_plain_path_matches_model_reference():
    """A nonzero logit softcap is applied by the plain path exactly as the
    reference's jnp attention applies it (the CUDA kernels refuse it)."""
    from repro.models.attention import naive_attention as jnaive

    (qj, kj, vj), (qt, kt, vt) = _inputs(4, [(1, 9, 4, 32), (1, 9, 2, 32), (1, 9, 2, 32)],
                                         "float32")
    oj = jnaive(qj * 8, kj, vj, causal=True, logit_softcap=5.0)
    ot = ops.flash_attention_op(qt * 8, kt, vt, causal=True, logit_softcap=5.0)
    _close(ot, oj, 2e-5)


def test_cpu_tensors_never_reach_the_cuda_build(monkeypatch):
    """Dispatch is by the tensor's device: a CPU tensor takes the plain
    version and never asks for the CUDA library; a non-CPU tensor goes to
    the kernel launcher, which refuses a device it cannot launch on."""
    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(_build, "entry", no_build)
    q = torch.randn(1, 5, 4, 32)
    k = torch.randn(1, 5, 2, 32)
    assert ops.flash_attention_op(q, k, k).shape == (1, 5, 4, 32)
    assert ops.decode_attention_op(q[:, :1], k, k, torch.tensor(5)).shape == (1, 1, 4, 32)
    meta = torch.empty(1, 5, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_op(meta, meta[:, :, :2], meta[:, :, :2])
