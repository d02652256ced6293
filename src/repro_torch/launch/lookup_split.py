"""Where a fuzzy plan-cache lookup's time goes, on the GPU.

    python -m repro_torch.launch.lookup_split [--repeats 200]

Builds the fuzzy run's cache (``PlanCache(fuzzy=True, fuzzy_threshold=0.6,
index_backend="device")`` on the card) holding the keywords of 16
FinanceBench tasks (seed 0), then looks up their paraphrase keywords one at
a time, as the agent loop does: each misses the exact stage and runs the
fuzzy stage's top-k. It times, on the host clock, the whole
``lookup_batch`` call and then the fuzzy stage's index steps one by one,
each ended by a synchronize: the embedding (``embed_batch``, numpy), the
upload of the padded query batch, the top-k kernel (``ops.resident_topk``,
also its device time by CUDA events) and the read-back (``.cpu().numpy()``).
Prints the card's name and power limit (nvidia-smi), then one JSON line of
medians in ms.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.core.cache import PlanCache
from repro_torch.envs.workloads import get_env
from repro_torch.index import embed_batch
from repro_torch.kernels import ops


def _median_ms(fn, repeats: int) -> float:
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lookup_split: no CUDA device; this script runs on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    tasks = get_env("financebench").generate(16, seed=0)
    cache = PlanCache(100, fuzzy=True, fuzzy_threshold=0.6, index_backend="device",
                      device="cuda")
    cache.insert_batch([(t.intent.keyword, f"plan {i}") for i, t in enumerate(tasks)])
    probes = [t.intent.paraphrase_keywords[0] for t in tasks]
    index = cache.pipeline.stages[-1].index
    arena = index._device.arena
    cycle = iter(range(10**9))

    def probe():
        return probes[next(cycle) % len(probes)]

    r = args.repeats
    whole = _median_ms(lambda: cache.lookup_batch([probe()]), r)
    q = embed_batch([probes[0]])
    qp = np.ascontiguousarray(np.pad(q, ((0, 7), (0, 0))))
    embed = _median_ms(lambda: embed_batch([probe()]), r)
    upload = _median_ms(lambda: torch.from_numpy(qp).to("cuda"), r)
    qt = torch.from_numpy(qp).to("cuda")
    kernel = _median_ms(lambda: ops.resident_topk(qt, arena, k=1), r)
    s, i = ops.resident_topk(qt, arena, k=1)
    readback = _median_ms(lambda: (s[:1].cpu().numpy(), i[:1].cpu().numpy()), r)
    dev = []
    for _ in range(r):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ops.resident_topk(qt, arena, k=1)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    print(json.dumps({
        "bank_rows": int(arena.shape[0]), "keys": len(cache), "queries_padded": 8,
        "lookup_ms": whole, "embed_ms": embed, "upload_ms": upload,
        "topk_call_ms": kernel, "topk_events_ms": statistics.median(dev),
        "readback_ms": readback,
        "rest_ms": whole - embed - upload - kernel - readback,
    }), flush=True)


if __name__ == "__main__":
    main()
