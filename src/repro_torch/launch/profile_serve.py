"""Where the serving time goes, on the GPU.

    python -m repro_torch.launch.profile_serve --full [--archs rwkv6-3b zamba2-2.7b]

Builds an engine for each arch (by default the three of the ``DEFAULT``
deployment) with ``launch.serve.build_engine`` (the published configs with
``--full``), one at a time, and runs one call of
the serving path's shape — prefill of the first FinanceBench task's query
(seed 0) and ``--max-new`` greedy tokens:

* one warm call;
* ``--repeats`` unprofiled calls: the median wall time;
* one call under ``torch.profiler``: its wall time, the device-busy time
  (the sum of the device kernels' times), the kernel count and the kernels
  with the most device time.

The idle share is ``1 - busy / wall``, given both for the profiled wall
(the profiler adds host time per op) and for the unprofiled one. Prints a
JSON line with the card's name and power limit (nvidia-smi), then one
JSON line per engine.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.apc_minion import DEFAULT
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.envs.workloads import get_env
from repro_torch.launch.serve import build_engine


def profile_engine(engine, prompt: np.ndarray, *, max_new: int, repeats: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompt, max_new=max_new)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    call()  # warm: kernel build and first-launch costs
    wall_ms = statistics.median(call() for _ in range(repeats))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = call()
    # device-side entries only: a CPU op's device time repeats its kernels'
    dev = [(a.key, a.self_device_time_total / 1e3, a.count)
           for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy = sum(t for _, t, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:6]
    return {
        "engine": engine.cfg.name, "prompt_tokens": int(prompt.shape[1]),
        "max_new": max_new, "wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "profiled_idle_share": 1 - busy / profiled_ms,
        "kernels": sum(c for _, _, c in dev),
        "top": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--archs", nargs="+", default=None,
                    help="archs to profile (default: the DEFAULT deployment's)")
    args = ap.parse_args()

    archs = args.archs or list(dict.fromkeys(
        (DEFAULT.large_planner, DEFAULT.small_planner, DEFAULT.actor)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0],
                      "torch": torch.__version__}), flush=True)
    task = get_env("financebench").generate(1, seed=0)[0]
    prompt = np.asarray([HashTokenizer().encode(task.query)], np.int32)
    for arch in archs:
        engine = build_engine(arch, full=args.full)
        print(json.dumps(profile_engine(engine, prompt, max_new=args.max_new,
                                        repeats=args.repeats)), flush=True)
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
