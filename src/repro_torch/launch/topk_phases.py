"""Where the top-k kernel's time goes, on the GPU.

    python -m repro_torch.launch.topk_phases [--variants one_mma no_split]

First the rate of the instruction the kernel's products run on: a small
kernel issues back-to-back ``mma.sync.m16n8k8`` TF32 products (two CTAs of
8 warps an SM, 8 independent accumulators a warp) and prints the TFLOP/s
it reaches, beside the same loop of fp32 FMAs.

Then a copy of ``csrc/topk_cosine.cu`` with ``clock64()`` reads (thread 0
of CTA (0, 0) adds up the SM cycles it spends in each part of its stage
loop) is built into ``build/topk_phases/`` and called through the wrapper
at the shapes of ``chip_smoke.time_topk`` (D = 384): ``wait`` (for a
tile's copy), ``compute`` (fragment loads, splits and products), ``fold``
(a window's scores into the fp32 sums), ``epilogue`` (the per-warp lists)
and ``other`` (the rest of the loop, thread 0's refills included), then
``merge`` (the row groups' lists) and ``last_merge`` (the last CTA's merge
of the splits), with the device time of a call (median of 5 runs of 20
calls queued behind a sleep kernel, CUDA events). Each named variant is
one source edit, timed the same way, whose scores are wrong: ``one_mma``
(hi.hi only: the share of the two extra products), ``no_split`` (raw
values as hi and lo: the share of the splits). Prints the card's name and
power limit, then one JSON line per measurement.
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

RATE_SRC = r'''
#include <cstdint>
template <bool FMA>
__global__ void rate(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 3u, 5u, 7u}, b0 = blockIdx.x, b1 = 11u;
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (FMA) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = __fmaf_rn(acc[c][j], 1.0001f, 0.5f);
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool FMA>
float time_ms(float* out, int ctas, int iters) {
  rate<FMA><<<ctas, 256>>>(out, iters);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  rate<FMA><<<ctas, 256>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
extern "C" float rate_ms(int ctas, int iters, int fma) {
  float* out;
  cudaMalloc(&out, (size_t)ctas * 256 * sizeof(float));
  const float ms = fma ? time_ms<true>(out, ctas, iters) : time_ms<false>(out, ctas, iters);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
'''

PROBE = '''
__device__ long long g_phase[8];
extern "C" int phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_zero() {
  long long z[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
#define REC (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
#define TICK(v) do { if (REC) v = clock64(); } while (0)
#define TOCK(k, v) do { if (REC) g_phase[k] += clock64() - v; } while (0)
'''
NAMES = ("wait", "compute", "fold", "epilogue", "loop", "merge", "last_merge")
# (text, replacement): the clock reads
MARKS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + PROBE),
    ("  const int r_end = min(N, r_begin + rows_per);\n",
     "  const int r_end = min(N, r_begin + rows_per);\n  long long t0 = 0, t1 = 0;\n"),
    ("    mbar_wait(&full[slot], phase);\n",
     "    TICK(t1);\n    mbar_wait(&full[slot], phase);\n    TOCK(0, t1);\n    TICK(t1);\n"),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[slot]);",
     "    __syncwarp();\n    TOCK(1, t1);\n    TICK(t1);\n    if (lane == 0) mbar_arrive(&empty[slot]);"),
    ("    if (c < n_chunks - 1) continue;\n",
     "    TOCK(2, t1);\n    if (c < n_chunks - 1) continue;\n    TICK(t1);\n"),
    ("      act = __reduce_or_sync(FULL, live);\n    }\n",
     "      act = __reduce_or_sync(FULL, live);\n    }\n    TOCK(3, t1);\n"),
    ("    lr[i] = INT_MAX;\n  }\n  __syncthreads();\n",
     "    lr[i] = INT_MAX;\n  }\n  __syncthreads();\n  TICK(t0);\n"),
    ("  __syncthreads();\n\n  // merge the row groups'",
     "  TOCK(4, t0);\n  __syncthreads();\n  TICK(t0);\n\n  // merge the row groups'"),
    ("  if (n_split == 1) return;\n\n  // the last CTA",
     "  __syncthreads();\n  TOCK(5, t0);\n  if (n_split == 1) return;\n\n  // the last CTA"),
    ("  if (!is_last) return;\n",
     "  if (!is_last) return;\n  if (tid == 0) t0 = clock64();\n"),
    ("}\n\n// cuTensorMapEncodeTiled",
     "  __syncthreads();\n  if (tid == 0) g_phase[6] = clock64() - t0;\n}\n\n// cuTensorMapEncodeTiled"),
]
VARIANTS = {
    "one_mma": [("              mma_tf32(acc[1][mt][nt], ah[mt], bl0, bl1);\n"
                 "              mma_tf32(acc[1][mt][nt], al[mt], bh0, bh1);\n", "")],
    "no_split": [("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                  "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));\n",
                  "  hi = __float_as_uint(x);\n  lo = hi;\n")],
}
SHAPES = ((8, 64, 1), (8, 20_000, 1), (64, 20_000, 4), (8, 1_000_000, 1), (64, 1_000_000, 4))


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _rates(out_dir: pathlib.Path) -> dict:
    """TFLOP/s of back-to-back TF32 mma.sync and of fp32 FMAs, two CTAs of
    8 warps an SM."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rate.cu").write_text(RATE_SRC)
    lib = out_dir / "librate.so"
    subprocess.run([_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "rate.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).rate_ms
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_float
    ctas = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20_000
    mma_ms, fma_ms = fn(ctas, iters, 0), fn(ctas, iters, 1)
    warps = ctas * 8
    return {"mma_sync_tf32_tflops": warps * iters * 8 * 16 * 8 * 8 * 2 / mma_ms / 1e9,
            "fp32_fma_tflops": warps * 32 * iters * 8 * 4 * 2 / fma_ms / 1e9}


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


def _build_copy(name: str, edits) -> pathlib.Path:
    out = pathlib.Path(_build.BUILD_DIR).parent / "topk_phases" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out / "csrc")
    p = out / "csrc" / "topk_cosine.cu"
    text = p.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"topk_phases: topk_cosine.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    p.write_text(text)
    _build.CSRC, _build.BUILD_DIR = out / "csrc", out / "lib"
    _build._loaded.clear()
    return _build.build(["topk_cosine"])["topk_cosine"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topk_phases: no CUDA device; this script runs on the GPU")
    from repro_torch.kernels.similarity import topk_cosine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps(_rates(pathlib.Path(_build.BUILD_DIR).parent / "topk_phases")), flush=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    banks = {N: torch.nn.functional.normalize(torch.randn(N, 384, generator=g, device="cuda"))
             for N in sorted({N for _, N, _ in SHAPES})}
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    for variant in ["as is"] + args.variants:
        lib = ctypes.CDLL(str(_build_copy(variant.replace(" ", "_"),
                                          MARKS + VARIANTS.get(variant, []))))
        for Q, N, k in SHAPES:
            q = torch.nn.functional.normalize(torch.randn(Q, 384, generator=g, device="cuda"))
            topk_cosine(q, banks[N], k)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 8)()
            if lib.phase_zero() != 0:
                raise RuntimeError("topk_phases: clearing the clock array failed")
            topk_cosine(q, banks[N], k)
            torch.cuda.synchronize()
            if lib.phase_read(buf) != 0:
                raise RuntimeError("topk_phases: reading the clock array failed")
            cycles = dict(zip(NAMES, list(buf)))
            cycles["other"] = cycles["loop"] - sum(cycles[n] for n in NAMES[:4])
            print(json.dumps({"variant": variant, "shape": [Q, N, k], "cycles": cycles,
                              "ms": _device_ms(lambda: topk_cosine(q, banks[N], k))}), flush=True)
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._loaded.clear()


if __name__ == "__main__":
    main()
