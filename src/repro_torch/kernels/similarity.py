"""Launcher of the CUDA cosine top-k kernel (``csrc/topk_cosine.cu``), the
plan cache's fuzzy lookup.

Replaces ``repro/kernels/similarity.py::topk_cosine``: queries (Q, D)
against a bank (N, D) of L2-normalized rows -> the k best scores and rows
per query, ties to the lowest row, (-1e30, -1) past N. Its plain version is
``ref.topk_cosine_ref``.

Why the design differs from the TPU kernel's:

* *N is split across CTAs.* The Pallas grid is (Q / 128, N / 1024) with the
  N axis sequential: one program per 128 queries walks the whole bank with
  its running top-k in VMEM. The agent sends at most 8 queries (padded), so
  on the card that grid is one CTA on 132 SMs. Here each CTA takes a
  contiguous range of rows for a block of up to 64 queries (stage 1) and
  writes its k candidates per query; one warp per query merges them
  (stage 2). The order is total (score, then row) and each score comes from
  the same fixed-order arithmetic whichever CTA reads the row, so the
  result does not depend on the split count, on Q or on the padding.
* *fp32 FMAs, not TF32.* The TPU kernel runs the scores on the MXU in fp32.
  The fuzzy stage compares them with thresholds of 0.6-0.85, and the
  tensor cores' TF32 (10-bit mantissa) would move a cosine by ~1e-3 and
  flip matches, so every product is an fp32 FMA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_K = 32
MAX_D = 1024  # 8 float4 slices per lane
_SPLITS_PER_SM = 2
_MIN_ROWS_PER_SPLIT = 128
_sm_count = {}  # device index -> multiprocessor count


def default_splits(device: torch.device, n_queries: int, n_rows: int) -> int:
    """CTAs along N: about two per SM over all query blocks (64 queries a
    block), and at least 128 rows each."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    q_blocks = -(-n_queries // 64)
    return max(1, min(-(-n_rows // _MIN_ROWS_PER_SPLIT), _SPLITS_PER_SM * sms // q_blocks))


def topk_cosine(queries: torch.Tensor, bank: torch.Tensor, k: int, *,
                n_split: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), bank (N, D): float32 on one CUDA device, D a multiple
    of 4 up to 1024, 1 <= k <= 32. Returns (scores (Q, k) float32, rows
    (Q, k) int32). ``n_split`` fixes the number of CTAs along N (the result
    does not depend on it). Launches the kernel or raises; Q = 0 or N = 0
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
    if n_split is None:
        n_split = default_splits(dev, Q, N)
    if n_split < 1:
        raise ValueError(f"topk_cosine: n_split={n_split}")
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    rows = torch.empty((Q, k), dtype=torch.int32, device=dev)
    # the (Q, n_split, k) score and row workspaces share one allocation
    ws = torch.empty(2 * Q * n_split * k, dtype=torch.int32, device=dev)
    ws_s = ws.data_ptr()
    fn = _build.entry("topk_cosine")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(queries.data_ptr(), bank.data_ptr(), ws_s, ws_s + 4 * Q * n_split * k,
                  scores.data_ptr(), rows.data_ptr(), Q, N, D, k, n_split, stream)
    _build.check("topk_cosine", code)
    topk_cosine.launches += 1
    return scores, rows


topk_cosine.launches = 0  # launches since the last reset
