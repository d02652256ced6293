"""The top-k kernel's 3xTF32 arithmetic, emulated on the CPU.

The CUDA kernel (``repro_torch/kernels/csrc/topk_cosine.cu``) splits each
operand as hi = tf32(x), rounded as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero, to 10 mantissa bits), and lo = x - hi, which
the tensor core reads as TF32 by dropping its low 13 bits; it sums hi.hi +
hi.lo + lo.hi on the tensor cores. Here both roundings are emulated with
integer bit operations on float32 tensors, the three products are summed in
float64, and the scores are held against the float64 dot products within a
tenth of chip_smoke.py's ``TOPK_TOL``; their top-k rows against repro's
Pallas kernel (interpret mode) and both packages' plain versions. One TF32
product alone misses the tolerance: the reason for the split. The kernel
itself is held against the plain version on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.similarity import topk_cosine as jtopk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)

TOPK_TOL = 1e-5  # chip_smoke.py's kernel-vs-plain score tolerance
D = 384
N = 20_000
Q = 8


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on a float32 tensor: drop the low 13 mantissa bits,
    rounding to nearest with ties away from zero (add half of the dropped
    unit to the magnitude's bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The tensor core's reading of a float32 register as TF32: the low 13
    mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32_trunc(x - hi)  # x - hi is exact in float32


def _bank_and_queries(seed=0):
    """Unit rows from numpy with chip_smoke._topk_bank's planted rows that
    fall inside N: rows 1 and 19,999 repeat row 0, rows 40 and 63 repeat row
    5; rows 2, 50-53 and 10,000-10,003 are zero. Query 0 is row 0, query 1
    row 5."""
    rng = np.random.RandomState(seed)
    bank = rng.randn(N, D).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    for dup, src in ((1, 0), (19_999, 0), (40, 5), (63, 5)):
        bank[dup] = bank[src]
    bank[[2, 50, 51, 52, 53, 10_000, 10_001, 10_002, 10_003]] = 0.0
    queries = rng.randn(Q, D).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[0], queries[1] = bank[0], bank[5]
    return queries, bank


def _scores(queries, bank, split_products: bool):
    """(Q, N) float64 scores from TF32 operands: hi.hi + hi.lo + lo.hi, or
    hi.hi alone. Products of two 11-bit significands are exact in float64."""
    qh, ql = (t.double() for t in _split(torch.from_numpy(queries)))
    bh, bl = (t.double() for t in _split(torch.from_numpy(bank)))
    s = qh @ bh.T
    if split_products:
        s = s + qh @ bl.T + ql @ bh.T
    return s


def _topk_rows(scores: torch.Tensor, k: int) -> np.ndarray:
    """Rows of the k best float32 scores, ties to the lowest row."""
    s = scores.float()
    return torch.sort(-s, dim=1, stable=True).indices[:, :k].numpy().astype(np.int32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 3 * 2**-11),
                      1.0 + 2**-11 - 2**-23, 3.0e-3, -7.5], dtype=torch.float32)
    hi = _tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    # a tie rounds away from zero; just below it rounds down
    assert hi[1].item() == 1.0 + 2**-10 and hi[4].item() == 1.0
    assert hi[3].item() == -(1.0 + 2**-9)
    assert hi[2].item() == x[2].item() and hi[6].item() == -7.5
    assert (hi - x).abs().le(2.0**-11 * x.abs()).all()
    assert _tf32_trunc(x)[1].item() == 1.0 and _tf32_trunc(x)[3].item() == -(1.0 + 2**-10)


def test_split_represents_x_to_two_to_the_minus_22():
    """hi + lo (lo truncated) is x within 2^-22 |x|: the 3 products drop
    only lo.lo and lo's truncation, far below a score's tolerance."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))
    hi, lo = _split(x)
    assert ((hi.double() + lo.double()) - x.double()).abs().le(2.0**-22 * x.abs().double()).all()


def test_split_scores_are_within_a_tenth_of_the_tolerance():
    queries, bank = _bank_and_queries()
    exact = torch.from_numpy(queries).double() @ torch.from_numpy(bank).double().T
    err = (_scores(queries, bank, True) - exact).abs().max().item()
    assert err <= TOPK_TOL / 10, err


def test_one_tf32_product_misses_the_tolerance():
    queries, bank = _bank_and_queries()
    exact = torch.from_numpy(queries).double() @ torch.from_numpy(bank).double().T
    err = (_scores(queries, bank, False) - exact).abs().max().item()
    assert err > TOPK_TOL, err


@pytest.mark.parametrize("k", [1, 4, 32])
def test_split_topk_rows_match_the_references(k):
    """The rows of the split scores' top-k equal those of repro's Pallas
    kernel (interpret mode), of repro's numpy oracle and of the port's
    plain version; the planted ties come out lowest row first."""
    queries, bank = _bank_and_queries()
    got = _topk_rows(_scores(queries, bank, True), k)
    _, pallas_rows = jtopk(queries, bank, k, interpret=True)
    _, oracle_rows = jref.topk_cosine_ref(queries, bank, k)
    _, plain_rows = ref.topk_cosine_ref(torch.from_numpy(queries), torch.from_numpy(bank), k)
    np.testing.assert_array_equal(got, np.asarray(pallas_rows))
    np.testing.assert_array_equal(got, np.asarray(oracle_rows))
    np.testing.assert_array_equal(got, plain_rows.numpy())
    assert list(got[0, :min(k, 3)]) == [0, 1, 19_999][:k]
    assert list(got[1, :min(k, 3)]) == [5, 40, 63][:k]
