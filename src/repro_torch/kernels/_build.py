"""Build and load the hand-written CUDA kernels (no PyTorch headers).

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root at first use, and loaded with ``ctypes``. The file name
carries a hash of the source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing here runs at import time: the
CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Any, Dict, Iterable, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signature of each kernel's entry point: (symbol, argtypes)
SIGNATURES: Dict[str, Tuple[str, List]] = {
    "flash_attention": (
        "flash_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I] + [_L] * 12 + [_P],
    ),
    "decode_attention": (
        "decode_attention_fwd",
        [_P] * 6 + [_L] + [_I] * 6 + [_L] * 10 + [_P],
    ),
    "paged_decode_attention": (
        "paged_decode_attention_fwd",
        [_P] * 7 + [_L] + [_I] * 8 + [_L] * 10 + [_P],
    ),
    "topk_cosine": (
        "topk_cosine_fwd",
        [_P] * 7 + [_I] * 7 + [_P],
    ),
    "wkv6": (
        "wkv6_fwd",
        [_P] * 7 + [_I] * 5 + [_L] * 12 + [_P],
    ),
    "ssd": (
        "ssd_fwd",
        [_P] * 8 + [_I] * 7 + [_L] * 12 + [_P],
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, Any] = {}  # name -> ctypes function
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the GPU"
        )
    return found


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, pathlib.Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns name -> library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    procs = []
    for n in names:
        if out[n].exists():
            continue
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def entry(name: str):
    """The C entry point of kernel ``name``, building it at first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = build([name])[name]
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {code}")
