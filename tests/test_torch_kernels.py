"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against ``repro.kernels.ops`` — the Pallas kernels in interpret mode — on
the shape grids of tests/test_kernels.py. The CUDA kernels themselves are
checked against the same plain versions on the card by chip_smoke.py."""

import ctypes
import importlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import kernels as kernel_table  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv6  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402

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
        (1, 4, 4, 128, 80, 64, 64),   # zamba2's shared block: hd 80
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
        (1, 4, 4, 128, 80, 77, 64),  # zamba2's shared block: hd 80
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
        (2, 4, 2, 64, 32, (0, 5), 32),            # an empty row: zeros
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
    assert not ot[lens == 0].any()  # a row of length 0 is zeros, as in the kernels
    for b, ln in enumerate(lengths):
        ob = ops.decode_attention_op(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1],
                                     torch.tensor(ln, dtype=torch.int32))
        _close(ob, ot[b:b + 1].float().numpy(), 1e-6 if dtype == "float32" else 8e-3)


# the decode sweeps above as (B, Hq, Hkv, M, hd, lengths, bk), plus one
# batch of the split-K edges: lengths 0, 1, C - 1, C, C + 1 for every chunk C
# tested, the served 168 and the full M
SPLIT_CHUNKS = (16, 32, 64)
SPLIT_CASES = [
    (2, 8, 2, 256, 64, (177, 177), 64),
    (1, 4, 4, 512, 128, (512,), 128),
    (3, 8, 1, 128, 64, (1, 1, 1), 64),
    (1, 4, 4, 128, 80, (77,), 64),
    (3, 8, 2, 256, 64, (17, 177, 256), 64),
    (2, 4, 4, 128, 32, (1, 128), 64),
    (4, 4, 1, 256, 64, (64, 64, 64, 64), 128),
    (13, 8, 2, 192, 64, (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 168, 192), 64),
]
_pallas_decode = {}  # (case, dtype) -> (inputs, the Pallas kernel's output)


def _decode_case(case, dtype):
    """Inputs of a SPLIT_CASES case and the reference's Pallas decode kernel
    (interpret mode) on them, computed once per case and dtype."""
    if (case, dtype) not in _pallas_decode:
        B, Hq, Hkv, M, hd, lengths, bk = SPLIT_CASES[case]
        (qj, kj, vj), (qt, kt, vt) = _inputs(
            7, [(B, 1, Hq, hd), (B, M, Hkv, hd), (B, M, Hkv, hd)], dtype)
        oj = jops.decode_attention_op(qj, kj, vj, jnp.asarray(lengths, jnp.int32), block_k=bk)
        _pallas_decode[case, dtype] = ((qj, kj, vj), (qt, kt, vt), np.asarray(oj, np.float32))
    return _pallas_decode[case, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", SPLIT_CHUNKS)
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_decode_split_ref_matches_pallas_and_reference(case, chunk, dtype):
    """The split-K arithmetic of the CUDA decode kernels (per-chunk m, l, acc,
    then the in-order combine over the chunks below each row's length), as
    ``ref.decode_attention_split_ref``, against the reference's Pallas
    kernel in interpret mode and its oracle, at tests/test_kernels.py's
    tolerances. A row of length 0 gives zeros, as the Pallas kernel does
    (the oracle averages v there)."""
    from repro.kernels import ref as jref

    B, Hq, Hkv, M, hd, lengths, bk = SPLIT_CASES[case]
    (qj, kj, vj), (qt, kt, vt), oj = _decode_case(case, dtype)
    lens = np.asarray(lengths, np.int32)
    os_ = tref.decode_attention_split_ref(qt[:, 0], kt.transpose(1, 2), vt.transpose(1, 2),
                                          torch.from_numpy(lens), chunk=chunk)
    assert os_.shape == (B, Hq, hd) and os_.dtype == qt.dtype
    _close(os_, oj[:, 0], DECODE_TOL[dtype])
    assert not os_[torch.from_numpy(lens == 0)].any()
    live = lens > 0
    orj = jref.decode_attention_ref(qj[:, 0], kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
                                    jnp.asarray(lens))
    _close(os_[torch.from_numpy(live)], np.asarray(orj, np.float32)[live], DECODE_TOL[dtype])


@pytest.mark.parametrize("ps", [8, 32])
def test_paged_split_ref_equals_dense_split_on_gathered_cache(ps):
    """The paged plain path through the same split (``chunk=``) is the dense
    split on the pages gathered in table order, exactly: the CUDA paged
    kernel shares the dense one's chunk body and combine, and is pinned
    bitwise to it on the card."""
    B, Hq, Hkv, hd, npages, P = 4, 8, 2, 64, 40, 4
    lengths = (0, 1, ps + 3, P * ps)
    (_, _, _), (qt, kt, vt) = _inputs(
        8, [(B, 1, Hq, hd), (npages, ps, Hkv, hd), (npages, ps, Hkv, hd)], "float32")
    table = torch.from_numpy(_page_table(B, P, npages, ps, lengths, seed=ps))
    lens = torch.tensor(lengths, dtype=torch.int32)
    rows = table.clamp(min=0).long()
    kd = kt[rows].reshape(B, P * ps, Hkv, hd).transpose(1, 2)
    vd = vt[rows].reshape(B, P * ps, Hkv, hd).transpose(1, 2)
    for chunk in SPLIT_CHUNKS:
        op = tref.paged_attention_ref(qt[:, 0], kt, vt, table, lens, chunk=chunk)
        od = tref.decode_attention_split_ref(qt[:, 0], kd, vd, lens, chunk=chunk)
        assert torch.equal(op, od)
        _close(op[1:], tref.paged_attention_ref(qt[:, 0], kt, vt, table, lens)[1:].numpy(), 2e-6)
    with pytest.raises(ValueError, match="softcap"):
        tref.paged_attention_ref(qt[:, 0], kt, vt, table, lens, chunk=32, logit_softcap=5.0)


def test_build_target_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A library's name carries a hash of its source and of every shared
    header in csrc/, so editing a header (decode_common.cuh, common.cuh)
    gives a new name and the stale library in build/kernels is not loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("decode_attention", "paged_decode_attention", "flash_attention")
    before = {n: _build._target(n) for n in names}
    assert {n: _build._target(n) for n in names} == before  # stable
    header = csrc / "decode_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].name.startswith(f"lib{n}-") for n in names)
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text() + "\n")
    assert _build._target("flash_attention") != after["flash_attention"]


# the C types of the kernels' entry points -> the ctypes type a launcher passes
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "int64_t": ctypes.c_int64}


@pytest.mark.parametrize("name", kernel_table.KERNELS)
def test_the_launcher_declares_its_kernels_c_entry_point(name):
    """The symbol and ctypes argument types a launcher hands to
    ``_build.entry`` are those of the one ``extern "C"`` function of
    ``csrc/<name>.cu``, argument by argument: a mismatch passes on the CPU
    and is a wrong result or a memory fault on the card."""
    launcher = importlib.import_module(kernel_table.launchers()[name].__module__)
    decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                       (_build.CSRC / f"{name}.cu").read_text())
    assert len(decls) == 1
    symbol, params = decls[0]
    argtypes = [C_TYPES[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert launcher.SYMBOL == symbol
    assert len(launcher.ARGTYPES) == len(argtypes)
    for i, (declared, parsed) in enumerate(zip(launcher.ARGTYPES, argtypes)):
        assert declared is parsed, f"{symbol} argument {i}: {declared} vs {parsed}"


def test_check_aligned16_refuses_unaligned_rows():
    """The cp.async copies of the bf16 flash kernel and the decode kernels
    need 16-byte aligned pointers and row strides; the wrappers refuse
    anything else with ValueError (no fallback)."""
    from repro_torch.kernels.flash_attention import check_aligned16

    x = torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16)
    check_aligned16("t", x, x[:, 3:], x[:, :, 1:], x.transpose(1, 2))
    check_aligned16("t", torch.zeros(1, 1, 3, 32, dtype=torch.bfloat16)[:, :, :, :16])
    with pytest.raises(ValueError, match="16-byte"):  # a row stride of 36 bf16
        check_aligned16("t", torch.zeros(2, 5, 3, 36, dtype=torch.bfloat16)[..., :32])
    with pytest.raises(ValueError, match="16-byte"):  # a data pointer 2 bytes off
        check_aligned16("t", torch.zeros(4 * 32 + 1, dtype=torch.bfloat16)[1:].view(1, 4, 1, 32))


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
    version and never asks for the CUDA library, and so does a meta tensor
    (the dry-run's; shapes only); any other tensor goes to the kernel
    launcher, which refuses a device it cannot launch on (here called on
    meta tensors directly, the one non-CPU device this container has)."""
    def no_build(name, *_):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(_build, "entry", no_build)
    q = torch.randn(1, 5, 4, 32)
    k = torch.randn(1, 5, 2, 32)
    assert ops.flash_attention_op(q, k, k).shape == (1, 5, 4, 32)
    assert ops.decode_attention_op(q[:, :1], k, k, torch.tensor(5)).shape == (1, 1, 4, 32)
    pages = torch.randn(2, 5, 2, 32)
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    out = ops.paged_decode_attention_op(q[:, :1], pages, pages, table, torch.tensor([7]))
    assert out.shape == (1, 1, 4, 32)
    y, st = ops.wkv6_op(q, q, q, -torch.rand(1, 5, 4, 32), torch.randn(4, 32), chunk=4)
    assert y.shape == (1, 5, 4, 32) and st.shape == (1, 4, 32, 32)
    y, st = ops.ssd_op(q, torch.rand(1, 5, 4), torch.zeros(4), k[:, :, 0], k[:, :, 1],
                       torch.ones(4), chunk=4)
    assert y.shape == (1, 5, 4, 32) and st.shape == (1, 4, 32, 32)
    meta = torch.empty(1, 5, 4, 32, device="meta")
    mu = torch.empty(4, 32, device="meta")
    mdt, mh = torch.empty(1, 5, 4, device="meta"), torch.empty(4, device="meta")
    o = ops.flash_attention_op(meta, meta[:, :, :2], meta[:, :, :2])
    assert o.device.type == "meta" and o.shape == (1, 5, 4, 32)
    o = ops.decode_attention_op(meta[:, :1], meta, meta, torch.tensor(5, device="meta"))
    assert o.device.type == "meta" and o.shape == (1, 1, 4, 32)
    y, st = ops.wkv6_op(meta, meta, meta, meta.float(), mu, chunk=4)
    assert y.device.type == "meta" and st.shape == (1, 4, 32, 32)
    y, st = ops.ssd_op(meta, mdt, mh, meta[:, :, 0], meta[:, :, 0], mh, chunk=4)
    assert y.device.type == "meta" and st.shape == (1, 4, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(meta, meta[:, :, :2], meta[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(meta, meta, meta, meta.float(), mu)
    with pytest.raises(ValueError, match="CUDA"):
        ssd(meta, mdt, mh, meta[:, :, 0], meta[:, :, 0], mh)


def _page_table(B, P, npages, ps, lengths, seed=0):
    """Permuted pool rows per sequence, -1 past its last page (the table of
    tests/test_kernels.py::test_paged_attention_vs_ref)."""
    rng = np.random.RandomState(seed)
    table = np.full((B, P), -1, np.int32)
    for b, ln in enumerate(lengths):
        n = -(-ln // ps)
        table[b, :n] = rng.choice(npages, size=n, replace=False)
    return table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,hd,ps,npages,P,lengths",
    [
        (3, 8, 2, 64, 64, 16, 4, (200, 100, 256)),
        (2, 4, 4, 32, 16, 32, 8, (128, 7)),
        (1, 4, 1, 64, 32, 8, 2, (33,)),
        (2, 4, 2, 32, 16, 8, 4, (0, 21)),  # row 0: table all -1, length 0
    ],
)
def test_paged_decode_attention_op_matches_pallas(B, Hq, Hkv, hd, ps, npages, P, lengths,
                                                  dtype):
    """The plain paged version against the reference's Pallas kernel in
    interpret mode, on permuted page tables with -1 past the end
    (tolerances of tests/test_kernels.py: 2e-5 f32, 3e-2 bf16)."""
    from repro.kernels.paged_attention import paged_decode_attention as jpaged

    (qj, kj, vj), (qt, kt, vt) = _inputs(
        5, [(B, 1, Hq, hd), (npages, ps, Hkv, hd), (npages, ps, Hkv, hd)], dtype)
    table = _page_table(B, P, npages, ps, lengths)
    lens = np.asarray(lengths, np.int32)
    oj = jpaged(qj[:, 0], kj, vj, jnp.asarray(table), jnp.asarray(lens), interpret=True)
    ot = ops.paged_decode_attention_op(qt, kt, vt, torch.from_numpy(table),
                                       torch.from_numpy(lens))
    assert ot.shape == (B, 1, Hq, hd) and ot.dtype == qt.dtype
    _close(ot[:, 0], oj, DECODE_TOL[dtype])
    assert not ot[torch.from_numpy(lens) == 0].any()


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
def test_paged_plain_equals_dense_plain_on_gathered_cache(ps):
    """The plain paged version is the plain decode version on the pages
    gathered in table order (entries below 0 clamped to row 0): equal, and
    equal to the reference's numpy-gather oracle within fp32 rounding."""
    from repro.kernels import ref as jref

    B, Hq, Hkv, hd, npages = 3, 8, 2, 64, 40
    lengths = (1, ps + 3, 4 * ps)  # one token, a partial page, the full table
    P = 4
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        6, [(B, 1, Hq, hd), (npages, ps, Hkv, hd), (npages, ps, Hkv, hd)], "float32")
    table = _page_table(B, P, npages, ps, lengths, seed=ps)
    lens = torch.tensor(lengths, dtype=torch.int32)
    ot = ops.paged_decode_attention_op(qt, kt, vt, torch.from_numpy(table), lens)
    rows = torch.from_numpy(np.maximum(table, 0).astype(np.int64))
    kd = kt[rows].reshape(B, P * ps, Hkv, hd)
    vd = vt[rows].reshape(B, P * ps, Hkv, hd)
    od = ops.decode_attention_op(qt, kd, vd, lens)
    assert torch.equal(ot, od)
    oj = jref.paged_attention_ref(qj[:, 0], kj, vj, jnp.asarray(table), jnp.asarray(lengths))
    _close(ot[:, 0], oj, 2e-6)


def test_paged_op_softcap_on_cpu_and_refusals():
    """A nonzero softcap is applied by the plain paged path as by the plain
    decode path; a meta tensor takes the plain path too; the launcher
    refuses a device it cannot launch on."""
    q = torch.randn(2, 1, 4, 32)
    pages = torch.randn(6, 8, 2, 32)
    table = torch.tensor([[3, 1, -1], [0, 5, 2]], dtype=torch.int32)
    lens = torch.tensor([13, 24], dtype=torch.int32)
    o = ops.paged_decode_attention_op(q * 8, pages, pages, table, lens, logit_softcap=5.0)
    rows = table.clamp(min=0).long()
    dense = pages[rows].reshape(2, 24, 2, 32)
    od = ops.decode_attention_op(q * 8, dense, dense, lens, logit_softcap=5.0)
    assert torch.equal(o, od)
    meta = torch.empty(2, 1, 4, 32, device="meta")
    mpages = torch.empty(6, 8, 2, 32, device="meta")
    mtable, mlens = table.to("meta"), lens.to("meta")
    o = ops.paged_decode_attention_op(meta, mpages, mpages, mtable, mlens)
    assert o.device.type == "meta" and o.shape == (2, 1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(meta, mpages, mpages, mtable, mlens)


# tolerances of tests/test_kernels.py's sweeps: the chunked and sequential
# forms round their fp32 sums in other orders
WKV6_TOL = dict(atol=2e-4, rtol=1e-3)
SSD_TOL = dict(atol=5e-4, rtol=1e-3)


def _scan_close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def _wkv6_np(B, S, H, N, seed=0):
    """The draws of tests/test_kernels.py::test_wkv6_sweep, from numpy."""
    rs = np.random.RandomState(seed)
    r, k, v = (rs.standard_normal((B, S, H, N)).astype(np.float32) * 0.5 for _ in range(3))
    w = -np.exp(rs.standard_normal((B, S, H, N)).astype(np.float32) * 0.5 - 2.0)
    u = rs.standard_normal((H, N)).astype(np.float32) * 0.3
    return r, k, v, w, u


@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32), (96, 32), (37, 16)])
def test_wkv6_plain_matches_reference(S, chunk, N):
    """The port's chunked plain wkv6 (what ops.wkv6_op runs on the CPU)
    against JAX's model form (wkv6_chunked), its sequential oracle
    (rwkv6_ref) and the Pallas kernel in interpret mode, on the sweep's
    shapes plus a ragged S (37, zero-padded to the chunk; the Pallas
    kernel, which needs S % chunk == 0, takes the whole sequence as one
    chunk there). The port's sequential oracle matches too."""
    from repro.kernels import ref as jref
    from repro.models.rwkv import wkv6_chunked

    B, H = 2, 3
    arrs = _wkv6_np(B, S, H, N)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    y, st = ops.wkv6_op(*tx, chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (B, H, N, N)
    zeros = jnp.zeros((B, H, N, N))
    for want_y, want_st in (wkv6_chunked(*jx, zeros, chunk=chunk),
                            jref.rwkv6_ref(*jx, zeros),
                            jops.wkv6_op(*jx, chunk=chunk if S % chunk == 0 else S)):
        _scan_close(y, want_y, WKV6_TOL)
        _scan_close(st, want_st, WKV6_TOL)
    ys, sts = tref.rwkv6_ref(*tx)
    _scan_close(ys, y.numpy(), WKV6_TOL)
    _scan_close(sts, st.numpy(), WKV6_TOL)


def _ssd_np(B, S, H, P, Ns, seed=1):
    """The draws of tests/test_kernels.py::test_ssd_sweep, from numpy."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rs.standard_normal((B, S, H)).astype(np.float32)))
    Bc = rs.standard_normal((B, S, Ns)).astype(np.float32) * 0.5
    Cc = rs.standard_normal((B, S, Ns)).astype(np.float32) * 0.5
    return x, dt, np.zeros(H, np.float32), Bc, Cc, np.ones(H, np.float32)


@pytest.mark.parametrize("S,chunk,P,Ns", [(64, 16, 32, 16), (128, 64, 64, 64),
                                          (37, 16, 32, 16)])
def test_ssd_plain_matches_reference(S, chunk, P, Ns):
    """The port's chunked plain SSD scan (what ops.ssd_op runs on the CPU)
    against JAX's model form (ssd_chunked), its sequential oracle (ssd_ref)
    and the Pallas kernel in interpret mode, on the sweep's shapes plus a
    ragged S (the Pallas kernel takes it as one chunk)."""
    from repro.kernels import ref as jref
    from repro.models.mamba import ssd_chunked

    B, H = 2, 3
    arrs = _ssd_np(B, S, H, P, Ns)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    y, st = ops.ssd_op(*tx, chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (B, H, P, Ns)
    zeros = jnp.zeros((B, H, P, Ns))
    for want_y, want_st in (ssd_chunked(*jx, zeros, chunk=chunk),
                            jref.ssd_ref(*jx, zeros),
                            jops.ssd_op(*jx, chunk=chunk if S % chunk == 0 else S)):
        _scan_close(y, want_y, SSD_TOL)
        _scan_close(st, want_st, SSD_TOL)
    ys, sts = tref.ssd_ref(*tx)
    _scan_close(ys, y.numpy(), SSD_TOL)
    _scan_close(sts, st.numpy(), SSD_TOL)


def test_scan_plain_versions_overflow_as_the_reference_does():
    """The chunked forms keep the reference's factorisation, overflow
    included: a chunk whose cumulative log decay passes ~88 makes
    exp(-la) (wkv6) or exp(la_i - la_j) (ssd) inf, and inf * 0 NaN, in JAX
    and in the port alike, while both sequential oracles stay finite."""
    from repro.kernels import ref as jref
    from repro.models.mamba import ssd_chunked
    from repro.models.rwkv import wkv6_chunked

    B, S, H, N = 1, 128, 1, 16
    r, k, v, _, u = _wkv6_np(B, S, H, N)
    w = np.full((B, S, H, N), -1.0, np.float32)  # |la| reaches 128 in one chunk
    yj, _ = wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)), jnp.zeros((B, H, N, N)),
                         chunk=128)
    yt, _ = ops.wkv6_op(*map(torch.from_numpy, (r, k, v, w, u)), chunk=128)
    assert not np.isfinite(np.asarray(yj)).all() and not torch.isfinite(yt).all()
    assert torch.isfinite(tref.rwkv6_ref(*map(torch.from_numpy, (r, k, v, w, u)))[0]).all()
    x, dt, A, Bc, Cc, D = _ssd_np(B, S, H, 16, 16)
    dt = np.full_like(dt, 1.0)
    yj, _ = ssd_chunked(*map(jnp.asarray, (x, dt, A, Bc, Cc, D)), jnp.zeros((B, H, 16, 16)),
                        chunk=128)
    yt, _ = ops.ssd_op(*map(torch.from_numpy, (x, dt, A, Bc, Cc, D)), chunk=128)
    assert not np.isfinite(np.asarray(yj)).all() and not torch.isfinite(yt).all()
    yo, _ = jref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bc, Cc, D)), jnp.zeros((B, H, 16, 16)))
    assert np.isfinite(np.asarray(yo)).all()
    assert torch.isfinite(tref.ssd_ref(*map(torch.from_numpy, (x, dt, A, Bc, Cc, D)))[0]).all()


def test_scan_launchers_refuse_tensors_off_cuda():
    """The wkv6 and ssd launchers themselves (not the ops, which dispatch
    CPU tensors to the plain versions) refuse CPU and meta tensors before
    any build: they launch on a CUDA device or raise."""
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.ssd import ssd

    x = torch.randn(1, 5, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(x, x, x, x, torch.randn(2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, torch.rand(1, 5, 2), torch.zeros(2), x[:, :, 0], x[:, :, 1], torch.ones(2))
    m = torch.empty(1, 5, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(m, m, m, m, torch.empty(2, 64, device="meta"))
