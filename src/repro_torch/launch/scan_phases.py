"""Where a prefill scan kernel's time goes, on the GPU.

    python -m repro_torch.launch.scan_phases [--seq 2048] [--variants tile32 fastexp spread]

Builds copies of ``csrc/ssd.cu`` and ``csrc/wkv6.cu`` with ``clock64()``
reads at the phase boundaries of their tile loop (thread 0 of CTA 0 writes
them to a device array), runs each once at its served layout (zamba2-2.7b:
H 80, P 64, Ns 64; rwkv6-3b: H 40, N 64), B = 1, bf16 in, and prints the
median SM cycles a tile spends in each phase over the tiles past the first
two:

* ``stage``: the wait for the tile's copies, the barrier, the once-per-CTA
  pass (a_t and dt x; exp(w), the bonus sum r u k and v) and the second
  barrier;
* ``steps``: the tile's steps, with the next tile's copies and the last
  tile's y issued among them;
* ``reduce``: the reduce-scatter of the tile's partial y and its shared
  tile.

and the device time of one call of that build (median of 5 runs of 20
calls queued behind a sleep kernel, CUDA events; the clock reads are one
thread's few stores). Each named variant is one source edit, built and
timed the same way: ``tile32`` (32 steps a tile; wkv6 in bf16 only, as
its fp32 tile would pass 48 KB of static shared memory), ``fastexp``
(wkv6's exp(w) by ``__expf``), ``spread`` (each CTA reads its B_ / C_ or
r / k / w rows at other addresses than its neighbours: wrong values, for
timing L2 contention only). The copies go to ``build/scan_phases/``. Prints the
card's name and power limit (nvidia-smi), then one JSON line per kernel and
variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess

import torch

from repro_torch.kernels import _build

PROBE = '''
__device__ long long g_phase[4 * 512];
#define PHASE(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && it < 512) \\
  g_phase[4 * it + (k)] = clock64(); } while (0)
extern "C" int phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
'''
# (file, text, replacement): the clock reads, the same in both kernels
MARKS = [
    ('#include "scan_common.cuh"\n', '#include "scan_common.cuh"\n' + PROBE),
    ("    attn::cp_async_wait<0>();\n    __syncthreads();  // tile",
     "    PHASE(0);\n    attn::cp_async_wait<0>();\n    __syncthreads();  // tile"),
    ("    __syncthreads();\n\n    // the steps",
     "    __syncthreads();\n    PHASE(1);\n\n    // the steps"),
    ("    scan::reduce_scatter<K>(yp, run);\n",
     "    PHASE(2);\n    scan::reduce_scatter<K>(yp, run);\n"),
]
VARIANTS = {
    "tile32": [("ssd.cu", "  static constexpr int TS = 16;", "  static constexpr int TS = 32;"),
               ("wkv6.cu", "  static constexpr int TS = 16;",
                "  static constexpr int TS = sizeof(T) == 2 ? 32 : 16;")],
    "fastexp": [("wkv6.cu", "make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w))",
                 "make_float4(__expf(w4.x), __expf(w4.y), __expf(w4.z), __expf(w4.w))")],
    "spread": [("ssd.cu", "const T* Bb = Bm + b * sBb;", "const T* Bb = Bm + b * sBb - 64 * h;"),
               ("ssd.cu", "const T* Cb = Cm + b * sCb;", "const T* Cb = Cm + b * sCb - 64 * h;")] + [
        ("wkv6.cu", f"{ty}* {p}b = {p} + b * s{p}b + h * s{p}h;",
         f"{ty}* {p}b = {p} + b * s{p}b"
         f" + (h + 5 * (blockIdx.x % C::CTAS)) % H * s{p}h;")
        for ty, p in (("const T", "r"), ("const T", "k"), ("const float", "w"))],
}


def _inputs(S: int):
    """Served-layout inputs, drawn as the models draw them, bf16 in; ssd's
    x, B_, C_ are views of one conv output row, as zamba2 slices it."""
    g = torch.Generator(device="cuda").manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    H, N = 40, 64
    w = (-torch.exp(-4.6 + 0.037 * rnd(1, S, H, N))).clamp(-8.0, -1e-5)
    wkv = (rnd(1, S, H, N).bfloat16(), rnd(1, S, H, N).bfloat16(), rnd(1, S, H, N).bfloat16(),
           w, 0.1 * rnd(H, N))
    H, P, Ns = 80, 64, 64
    conv = torch.nn.functional.silu(0.2 * rnd(1, S, H * P + 2 * Ns)).bfloat16()
    ssd = (conv[..., :H * P].reshape(1, S, H, P),
           torch.nn.functional.softplus(rnd(1, S, H) - 2.0), torch.zeros(H, device="cuda"),
           conv[..., H * P:H * P + Ns], conv[..., H * P + Ns:], torch.ones(H, device="cuda"))
    return {"wkv6": wkv, "ssd": ssd}


def _device_ms(fn, repeats: int = 5, calls: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms: the stream waits while the host queues
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    return statistics.median(runs)


def _build_copy(name: str, edits) -> dict:
    out = pathlib.Path(_build.BUILD_DIR).parent / "scan_phases" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out / "csrc")
    for fn, old, new in edits:
        p = out / "csrc" / fn
        text = p.read_text()
        if old not in text:
            raise RuntimeError(f"scan_phases: {fn} no longer contains {old!r}")
        p.write_text(text.replace(old, new))
    _build.CSRC, _build.BUILD_DIR = out / "csrc", out / "lib"
    _build._loaded.clear()
    return _build.build(["wkv6", "ssd"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_phases: no CUDA device; this script runs on the GPU")
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.ssd import ssd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    inputs = _inputs(args.seq)
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    for variant in ["as is"] + args.variants:
        edits = [(f, a, b) for f in ("ssd.cu", "wkv6.cu") for a, b in MARKS]
        libs = _build_copy(variant.replace(" ", "_"), edits + VARIANTS.get(variant, []))
        for name, fn in (("ssd", ssd), ("wkv6", wkv6)):
            fn(*inputs[name])
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 2048)()
            if ctypes.CDLL(str(libs[name])).phase_read(buf) != 0:
                raise RuntimeError("scan_phases: reading the clock array failed")
            ts = 32 if variant == "tile32" else 16
            ntiles = min((args.seq + ts - 1) // ts, 512)
            t = list(buf)
            phases = {ph: statistics.median(t[4 * i + b] - t[4 * i + a]
                                            for i in range(2, ntiles - 1))
                      for ph, a, b in (("stage", 0, 1), ("steps", 1, 2), ("reduce", 2, 4))}
            print(json.dumps({"kernel": name, "variant": variant, "S": args.seq,
                              "cycles_per_tile": phases,
                              "ms": _device_ms(lambda: fn(*inputs[name]))}), flush=True)
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._loaded.clear()


if __name__ == "__main__":
    main()
