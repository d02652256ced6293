"""The readings a cell's output-check limit is set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control] [--waves 3]

For each seed, in one process: the cell's weights and engine from the
seed, ``--waves`` waves of its traffic served as a run's window serves
them, the run's sample of those calls, and the widest gap of the served
tokens in the plain reference (the program's reading), and the verdict of
the cell's own check on it (``program_correct``). With ``--control`` also
the control's reading: the reference in fp8 put in the program's place, at
the same positions of the same calls, and the cell's check's verdict on it
(``control_correct``, which has to be false). One JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from perfbench import harness, judge, weights
    from perfbench.traffic import Traffic
    from repro_torch.serving.engine import Engine

    cell = harness.load_cell(args.workload)
    why = harness.card_check(cell.chips)
    if why:
        print(f"perfbench: {why}", file=sys.stderr)
        return 2
    device = "cuda:0"
    cfg = harness.model_config(cell.conf)
    for seed in args.seeds:
        t = time.perf_counter()
        params = weights.make(cell.conf, seed, device)
        traffic = Traffic(cell.traffic, cell.conf["vocab_size"], seed)
        engine = Engine(cfg, params, max_len=traffic.max_len, device=device)
        kept = []
        for w in range(args.waves):
            p = traffic.prompts(w)
            kept.append((p, engine.generate(p, max_new=traffic.max_new)))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        gaps = judge.widest_gaps(cell.conf, params, harness.sampled_calls(traffic, kept),
                                 device, control=args.control)
        failed = traffic.concurrency * sum(
            not harness.well_formed(o, traffic, cell.conf["vocab_size"]) for _, o in kept)
        line = {"workload": args.workload, "seed": seed, **gaps, "program_correct":
                judge.verdict(judge.checks(cell.limits, failed, gaps["served"]))}
        if args.control:
            # the control's tokens are argmaxes over the vocabulary: well formed
            line["control_correct"] = judge.verdict(judge.checks(cell.limits, 0,
                                                                 gaps["control"]))
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del params, kept
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
