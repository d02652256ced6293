"""Launcher of the CUDA cosine top-k kernel (``csrc/topk_cosine.cu``), the
plan cache's fuzzy lookup.

Replaces ``repro/kernels/similarity.py::topk_cosine``: queries (Q, D)
against a bank (N, D) of L2-normalized rows -> the k best scores and rows
per query, ties to the lowest row, (-1e30, -1) past N. Its plain version is
``ref.topk_cosine_ref``.

Why the design differs from the TPU kernel's:

* *N is split across CTAs, merged in the same launch.* The Pallas grid is
  (Q / 128, N / 1024) with the N axis sequential: one program per 128
  queries walks the whole bank with its running top-k in VMEM. The agent
  sends at most 8 queries (padded), so on the card that grid is one CTA on
  132 SMs. Here each CTA takes a contiguous range of rows for a block of up
  to 64 queries, and the last CTA of a query block to finish merges the
  blocks' candidates (an arrival counter); with one CTA along N it writes
  the result itself and no workspace is touched. The order is total (score,
  then row) and each score comes from the same fixed-order arithmetic
  whichever CTA reads the row, so the result does not depend on the split
  count, on Q or on the padding. ``launch_plan`` chooses the blocks; the
  workspace and counters are kept per device and stream (``scratch``), so
  a call allocates only its two outputs.
* *3xTF32 tensor cores.* The TPU kernel runs the scores on the MXU in fp32.
  The fuzzy stage compares them with thresholds of 0.6-0.85, and one TF32
  product (10-bit mantissa) moves a cosine by up to ~1e-4, ten times the
  kernel's tolerance. The kernel splits each operand into hi = tf32(x) and
  lo = x - hi and sums hi.hi + hi.lo + lo.hi on the tensor cores, adding
  each 32-dim window's sum into an fp32 sum: within ~1e-6 of fp32, at the
  tensor cores' rate rather than the fp32 units'
  (``tests/test_torch_topk_split.py`` emulates the arithmetic).
"""

from __future__ import annotations

import functools
from ctypes import c_int, c_int64, c_void_p
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_K = 32
MAX_D = 1024
# the kernel's geometry (csrc/topk_cosine.cu): 8 warps, a ring of 96 KB of
# bank tiles 32 dims deep, the queries a CTA may take, and the shared memory
# one H100 block may use and one SM holds
_WARPS = 8
_RING_BYTES = 98304
_MIN_TILE = 64
QB_SIZES = (8, 16, 24, 32, 64)
SMEM_MAX = 231424  # 232,448 less 1 KB for the kernel's static shared memory
_SMEM_SM = 233472
_sm_count = {}  # device index -> multiprocessor count
# (device index, stream) -> (int32 workspace, int32 arrival counters)
_scratch = {}


class Plan(NamedTuple):
    """How one call is cut into CTAs: ``n_qb`` blocks of ``qb`` queries,
    each walked by ``n_split`` CTAs of ``rows_per`` bank rows, in tiles of
    ``tile`` rows; ``kg`` k-groups of warps split a lone tile's dims.
    ``direct``: one CTA along N writes the result itself; else ``ws_pairs``
    (score, row) pairs of workspace and ``n_qb`` arrival counters are
    used. ``smem``: a CTA's dynamic shared memory."""

    qb: int
    n_qb: int
    n_split: int
    rows_per: int
    tile: int
    kg: int
    direct: bool
    ws_pairs: int
    smem: int


def smem_bytes(qb: int, D: int, k: int, kg: int = 1) -> int:
    """A CTA's dynamic shared memory (``smem_bytes`` in the CUDA source):
    the query plane, the ring of bank tiles, the per-warp lists of a
    warp's queries (all qb, or a quarter when qb is 64: four query groups)
    and, with kg > 1 k-groups, each 32-dim window's partial scores."""
    wn = qb // 4 if qb > 32 else qb
    windows = -(-D // 32) * (_WARPS // kg) * 32 * 8 * 4 if kg > 1 else 0
    return 1024 + _RING_BYTES + qb * (-(-D // 16) * 16) * 4 + _WARPS * wn * k * 8 + windows


def _tile_rows(rows_per: int, qb: int) -> int:
    """``tile_rows`` in the CUDA source: 64, 128 or 256 rows."""
    tr = 64
    while tr < (128 if qb > 32 else 256) and tr < rows_per:
        tr *= 2
    return tr


def _k_groups(qb: int, n_split: int, tile: int, D: int, k: int) -> int:
    """``k_groups`` in the CUDA source: a lone tile of 8 queries lets the
    warps its rows leave idle take 32-dim windows of their own."""
    if qb != 8 or n_split != 1 or tile >= 256:
        return 1
    kg = 256 // tile
    return kg if smem_bytes(qb, D, k, kg) <= SMEM_MAX else 1


@functools.lru_cache(maxsize=1024)
def launch_plan(Q: int, N: int, D: int, k: int, sms: int,
                n_split: Optional[int] = None) -> Plan:
    """The CTAs of one call (Q, N >= 1). Query blocks: as few as the shared
    memory allows (up to 64 queries, fewer at large D or k), of equal size.
    Along N, unless ``n_split`` is given: as many CTAs as fit the card at
    once over all query blocks (two an SM when a CTA takes 8 queries and
    half an SM's shared memory), at least 64 rows each; no CTA gets an
    empty range."""
    fits = [qb for qb in QB_SIZES if smem_bytes(qb, D, k) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"topk_cosine: D={D}, k={k} do not fit one CTA's shared memory")
    n_qb = -(-Q // fits[-1])
    qb = next(qb for qb in fits if qb >= -(-Q // n_qb))
    if n_split is None:
        per_sm = 2 if qb == 8 and 2 * (smem_bytes(qb, D, k) + 2048) <= _SMEM_SM else 1
        n_split = max(1, min(N // _MIN_TILE, per_sm * sms // n_qb))
    if n_split < 1:
        raise ValueError(f"topk_cosine: n_split={n_split}")
    rows_per = -(-N // n_split)
    n_split = -(-N // rows_per)
    direct = n_split == 1
    tile = _tile_rows(rows_per, qb)
    kg = _k_groups(qb, n_split, tile, D, k)
    return Plan(qb, n_qb, n_split, rows_per, tile, kg, direct,
                0 if direct else Q * n_split * k, smem_bytes(qb, D, k, kg))


def scratch(device: torch.device, stream: int, plan: Plan):
    """The workspace (int32, scores' bits then rows) and the zeroed arrival
    counters for ``plan`` on one device and stream, kept between calls and
    grown when a plan needs more. The kernel leaves the counters at 0."""
    key = (device, stream)
    ws, ctr = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < 2 * plan.ws_pairs:
        ws = torch.empty(2 * plan.ws_pairs, dtype=torch.int32, device=device)
    if ctr is None or ctr.numel() < plan.n_qb:
        ctr = torch.zeros(plan.n_qb, dtype=torch.int32, device=device)
    _scratch[key] = ws, ctr
    return ws, ctr


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms


# csrc/topk_cosine.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "topk_cosine_fwd"
ARGTYPES = [c_void_p] * 7 + [c_int] * 7 + [c_void_p]


def topk_cosine(queries: torch.Tensor, bank: torch.Tensor, k: int, *,
                n_split: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), bank (N, D): float32 on one CUDA device, D a multiple
    of 4 up to 1024, 1 <= k <= 32. Returns (scores (Q, k) float32, rows
    (Q, k) int32). ``n_split`` fixes the number of CTAs along N (the result
    does not depend on it). One kernel launch, or a raise; Q = 0 or N = 0
    returns (-1e30, -1) without a launch."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_cosine: k={k}; the kernel takes 1 <= k <= {MAX_K}")
    dev = queries.device
    if not (queries.is_cuda and bank.device == dev):
        raise ValueError("topk_cosine: queries and bank must be on one CUDA device")
    if queries.dtype != torch.float32 or bank.dtype != torch.float32:
        raise ValueError(f"topk_cosine: dtypes {queries.dtype}/{bank.dtype}; need float32")
    if queries.dim() != 2 or bank.dim() != 2 or queries.shape[1] != bank.shape[1]:
        raise ValueError(f"topk_cosine: shapes {tuple(queries.shape)}, {tuple(bank.shape)}")
    Q, D = queries.shape
    N = bank.shape[0]
    if D % 4 or not 0 < D <= MAX_D:
        raise ValueError(f"topk_cosine: D={D}; need a multiple of 4 up to {MAX_D}")
    if Q == 0 or N == 0:
        return (torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((Q, k), -1, dtype=torch.int32, device=dev))
    if not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError("topk_cosine: the bank must be contiguous and 16-byte aligned")
    queries = queries.contiguous()
    if queries.data_ptr() % 16:
        queries = queries.clone()
    plan = launch_plan(Q, N, D, k, _sms(dev), n_split)
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    rows = torch.empty((Q, k), dtype=torch.int32, device=dev)
    fn = _build.entry("topk_cosine", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ws_s = ws_r = ctr = None
        if not plan.direct:
            ws, counters = scratch(dev, stream, plan)
            ws_s, ws_r, ctr = ws.data_ptr(), ws.data_ptr() + 4 * plan.ws_pairs, counters.data_ptr()
        code = fn(queries.data_ptr(), bank.data_ptr(), ws_s, ws_r, ctr, scores.data_ptr(),
                  rows.data_ptr(), Q, N, D, k, plan.qb, plan.n_split, plan.rows_per, stream)
    _build.check("topk_cosine", code)
    topk_cosine.launches += 1
    return scores, rows


topk_cosine.launches = 0  # launches since the last reset
