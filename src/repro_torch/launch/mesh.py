"""Mesh construction and local multi-rank launch (the counterpart of
``repro.launch.mesh``).

* ``make_production_mesh(multi_pod=False)``: the reference's production
  meshes as ``AbstractMesh``es (no process group): (data 16, model 16), or
  (pod 2, data 16, model 16).
* ``make_mesh(shape, axes)``: a live ``Mesh`` over the initialised process
  group; the world size must equal the product of ``shape``.
* ``make_host_mesh()``: the whole world as one "data" axis.
* ``spawn_local(fn, world_size, ...)``: start ``world_size`` local ranks
  with ``torch.multiprocessing`` (spawn), each in a process group initialised
  through a ``file://`` store in a fresh temporary directory (no TCP port is
  guessed, so concurrent launches never collide), call ``fn(rank,
  world_size, *args)`` on each, and return their results by rank. A rank's
  exception is re-raised here with its traceback; at ``timeout_s`` every
  rank is killed and ``TimeoutError`` raised. ``fn`` must be importable by
  name (a module-level function) and should return plain data (numpy
  arrays, numbers), not tensors. A rank may mark the start of each of its
  sub-phases with ``phase(name)``; with ``phase_timeout_s`` every rank is
  killed, and ``TimeoutError`` raised, when one sub-phase of a rank runs
  longer than that.

  ``device="cuda"`` puts rank r on card ``r % device_count()``: with fewer
  cards than ranks they share a card, which NCCL refuses, so the backend
  must then be gloo (the collectives stage CUDA operands through the host,
  ``distributed/mesh_compat.py``).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.mesh_compat import AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (data=16, model=16) = 256 chips; multi-pod: (pod=2,
    data=16, model=16) = 512. Abstract: no process group stands behind it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _rank_device():
    return getattr(_rank_device, "device", torch.device("cpu"))


def phase(name: str) -> None:
    """In a rank of ``spawn_local``: this rank starts sub-phase ``name`` (its
    ``phase_timeout_s`` clock restarts). A no-op elsewhere."""
    q = getattr(phase, "queue", None)
    if q is not None:
        q.put((phase.rank, "phase", name))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None) -> Mesh:
    """A live mesh over the whole world, ranks row-major over ``shape``;
    ``device`` defaults to the rank's device under ``spawn_local``."""
    want = 1
    for s in shape:
        want *= int(s)
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"mesh {tuple(shape)} needs {want} ranks; the world has {world}")
    return Mesh(shape, axes, device=device if device is not None else _rank_device())


def make_host_mesh(*, device=None) -> Mesh:
    """The whole world as a 1-D 'data' mesh."""
    return make_mesh((dist.get_world_size(),), ("data",), device=device)


def _rank_main(rank: int, world: int, init: str, backend: str, device: str,
               timeout_s: float, fn: Callable, args: tuple, results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        _rank_device.device = dev
        phase.queue, phase.rank = results, rank
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, *, backend: str = "gloo",
                device: str = "cpu", args: Sequence[Any] = (), timeout_s: float = 120.0,
                phase_timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` local ranks;
    returns the ranks' results in rank order (module docstring)."""
    tmp = tempfile.mkdtemp(prefix="spawn_local_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, init, backend, device, timeout_s, fn,
                               tuple(args), results), daemon=True)
             for r in range(world_size)]
    done = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        started: dict = {}  # rank -> (sub-phase, its start)
        while len(got) < world_size:
            now = time.monotonic()
            left = deadline - now
            if left <= 0:
                raise TimeoutError(f"spawn_local: {world_size - len(got)} of {world_size} "
                                   f"ranks still running after {timeout_s} s")
            for r, (name, t0) in started.items():
                if phase_timeout_s is not None and r not in got and now - t0 > phase_timeout_s:
                    raise TimeoutError(f"spawn_local: rank {r} spent over {phase_timeout_s} s "
                                       f"in sub-phase {name!r}")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"spawn_local: rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if status == "phase":
                started[rank] = (out, time.monotonic())
                continue
            if status == "error":
                raise RuntimeError(f"spawn_local: rank {rank} failed:\n{out}")
            got[rank] = out
        done = True
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:  # let finished ranks tear their group down
            p.join(timeout=10 if done else 0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
