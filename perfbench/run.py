"""Run one cell of the port's benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: it serves the cell's traffic through
``repro_torch`` (from ``src/``) for ``--seconds``, checks the served tokens
against the plain reference, and prints one JSON line last on standard
output: the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``. The numbers the check compared, each beside its
limit, are the last lines on standard error. Exits non-zero, printing no
result, where there is no CUDA card (or fewer than the cell asks for),
where ``src/repro_torch`` is missing, or where JAX or the JAX package is
loaded when the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here: the interpreter's own start excepted

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    why = harness.card_check(cell.chips)
    if why:
        print(f"perfbench: {why}", file=sys.stderr)
        return 2
    result = harness.serve(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    print(f"waves in the window: {result['waves']} (the independent latency samples), "
          f"calls {result['attempted']}; the output check took {result['check_s']:.3f} s",
          file=sys.stderr)
    if "breakdown" in result:
        print(f"traced waves: {result['device']['window_s']:.3f} s, stretched against the "
              f"window's waves {result['trace_stretch']}; the profiler's stop and the trace's "
              f"reduction took {result['trace_cost_s']:.3f} s more", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
