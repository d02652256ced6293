"""Sharded, atomic, versioned checkpointing (the twin of
``repro.checkpoint.store``, with numpy and torch only).

Layout, the reference's byte for byte:
    <dir>/step_000123/
        manifest.json         # tree keys, shapes, dtype tags, shard map, crc32
        shard_00000.npz       # flat arrays owned by shard 0
        ...
        COMMITTED             # written LAST -> torn checkpoints are invisible

* atomic: a checkpoint is valid iff COMMITTED exists (it is written into a
  ``.tmp_`` directory and renamed; ``restore`` skips a torn one and ``gc``
  removes it);
* versioned: ``restore`` picks the newest committed step; ``keep_last``
  prunes the unpinned ones (``pin_check(step)`` True keeps a step live);
* integrity: a crc32 per array in the manifest, checked on load;
* sharded: an array goes to shard ``blake2b(key)[0] % n_shards``; the
  shards are written and read in parallel threads (as are the crc32s), so
  a many-shard checkpoint moves at several times one file's rate.

A tree is nested dicts, lists and tuples (None is an empty subtree) whose
leaves are torch tensors, numpy arrays or Python scalars. Keys are the tree
path joined with ``/`` with dict keys sorted, as ``jax.tree_util`` orders
them, so a numpy tree saved by either package restores in the other. npz
holds no bf16 or fp8: such an array is stored as its bit-identical
``uint16``/``uint8`` view plus the dtype tag, and comes back as a torch
tensor of that dtype (or a numpy array of it when the template's leaf is
one).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}
_TAG_OF = {torch_dt: tag for tag, (torch_dt, _, _) in _EXOTIC.items()}
_THREADS = 8


def _to_storable(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as an npz-storable host array plus its dtype tag."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        tag = _TAG_OF.get(t.dtype)
        if tag is not None:
            _, np_u, torch_u = _EXOTIC[tag]
            return t.view(torch_u).cpu().numpy().view(np_u), tag
        leaf = t.cpu().numpy()
    arr = np.asarray(leaf)
    tag = str(arr.dtype)
    if tag in _EXOTIC:
        return arr.view(_EXOTIC[tag][1]), tag
    return arr, tag


def _from_storable(arr: np.ndarray, tag: str, like: Any) -> Any:
    """A stored array back in the template leaf's type, dtype and device."""
    if isinstance(like, torch.Tensor):
        if tag in _EXOTIC:
            torch_dt, _, torch_u = _EXOTIC[tag]
            t = torch.from_numpy(arr).view(torch_u).view(torch_dt)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if tag in _EXOTIC:
        if str(getattr(like, "dtype", "")) == tag:  # a numpy leaf of that dtype
            return arr.view(like.dtype)
        torch_dt, _, torch_u = _EXOTIC[tag]
        return torch.from_numpy(arr).view(torch_u).view(torch_dt)
    return arr.astype(like.dtype) if hasattr(like, "dtype") else arr


def _crc32(arr: np.ndarray) -> int:
    # the buffer itself, no bytes copy; zlib releases the GIL on large ones
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _parallel(fn: Callable, items) -> List[Any]:
    items = list(items)
    if len(items) <= 1:  # a cold-tier segment: one array, one shard
        return [fn(item) for item in items]
    with ThreadPoolExecutor(max_workers=_THREADS) as pool:
        return list(pool.map(fn, items))


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    sequences by index, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree: Any, leaf_fn: Callable[[str, Any], Any], prefix=()) -> Any:
    """The template's structure with each leaf replaced by ``leaf_fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaf_fn("/".join(prefix), tree)


class CheckpointStore:
    def __init__(
        self,
        directory: str,
        *,
        n_shards: int = 1,
        keep_last: int = 3,
        pin_check: Optional[Callable[[int], bool]] = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_shards = n_shards
        self.keep_last = keep_last
        # pin_check(step) True: the step is live (a cold-tier segment with
        # manifest entries) and survives gc whatever its age; keep_last
        # rotates only the unpinned steps
        self.pin_check = pin_check
        # step directories seen with their COMMITTED marker: a listing
        # stats only the others (a cold tier lists its directory on every
        # spill, over every live segment)
        self._committed_names: set = set()

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None) -> Path:
        tmp = self.dir / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = [(key, *_to_storable(leaf)) for key, leaf in _flatten(tree)]
        crcs = _parallel(_crc32, [arr for _, arr, _ in flat])
        shards: Dict[int, Dict[str, np.ndarray]] = {i: {} for i in range(self.n_shards)}
        manifest = {"step": step, "extra": extra or {}, "arrays": {},
                    "n_shards": self.n_shards}
        for (key, arr, tag), crc in zip(flat, crcs):
            sid = int(hashlib.blake2b(key.encode(), digest_size=2).digest()[0]) % self.n_shards
            safe = key.replace("/", "__")
            shards[sid][safe] = arr
            manifest["arrays"][key] = {"shard": sid, "name": safe, "shape": list(arr.shape),
                                       "dtype": tag, "crc32": crc}
        _parallel(lambda item: np.savez(tmp / f"shard_{item[0]:05d}.npz", **item[1]),
                  shards.items())
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        self._committed_names.discard(final.name)
        tmp.rename(final)
        (final / "COMMITTED").write_text("ok")  # the commit point
        self._committed_names.add(final.name)
        self.gc()
        return final

    def _scan(self) -> Tuple[List[int], List[str], List[str]]:
        """One listing of the directory: the committed steps (sorted), the
        torn step directories (no ``COMMITTED``) and the ``.tmp_step_*``
        leftovers. A step directory is checked for its marker only the
        first time this store lists it."""
        committed: List[int] = []
        torn: List[str] = []
        tmp: List[str] = []
        seen = set()
        with os.scandir(self.dir) as entries:
            for e in entries:
                if e.name.startswith("step_"):
                    if (e.name in self._committed_names
                            or os.path.exists(os.path.join(e.path, "COMMITTED"))):
                        committed.append(int(e.name.split("_")[1]))
                        seen.add(e.name)
                    else:
                        torn.append(e.path)
                elif e.name.startswith(".tmp_step_"):
                    tmp.append(e.path)
        self._committed_names = seen
        return sorted(committed), torn, tmp

    def committed_steps(self) -> List[int]:
        return self._scan()[0]

    def restore(self, template: Any, *, step: Optional[int] = None,
                strict: bool = True) -> Tuple[Any, Dict]:
        """The tree saved at ``step`` (default: the newest committed), in
        the template's structure, each leaf in its template leaf's type,
        dtype and device. Raises ``IOError`` on a crc mismatch and, when
        ``strict``, ``KeyError`` on a template key the checkpoint lacks
        (else that leaf is kept)."""
        # a named committed step needs no listing (a cold tier restores one
        # segment a promotion); otherwise the newest committed step, and no
        # committed step at all is an error either way
        if step is None or not (self._step_dir(step) / "COMMITTED").exists():
            steps = self.committed_steps()
            if not steps:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
            step = step if step is not None else steps[-1]
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        keys = [key for key, _ in _flatten(template)]
        missing = [key for key in keys if key not in manifest["arrays"]]
        if missing and strict:
            raise KeyError(f"missing {missing[0]!r} in checkpoint step {step}")
        by_shard: Dict[int, List[str]] = {}
        for k in keys:
            if k in manifest["arrays"]:
                by_shard.setdefault(manifest["arrays"][k]["shard"], []).append(k)

        def load_shard(item):
            sid, ks = item
            with np.load(d / f"shard_{sid:05d}.npz") as shard:
                return {k: shard[manifest["arrays"][k]["name"]] for k in ks}

        loaded: Dict[str, np.ndarray] = {}
        for part in _parallel(load_shard, sorted(by_shard.items())):
            loaded.update(part)
        for k, crc in zip(loaded, _parallel(_crc32, list(loaded.values()))):
            if crc != manifest["arrays"][k]["crc32"]:
                raise IOError(f"checkpoint corruption detected for {k!r}")

        def leaf(key, like):
            if key not in loaded:
                return like
            return _from_storable(loaded.pop(key), manifest["arrays"][key]["dtype"], like)

        return _rebuild(template, leaf), manifest["extra"]

    def gc(self) -> None:
        steps, torn, tmp = self._scan()
        # pinned steps are live: age rotation only considers the unpinned
        # ones, so a referenced cold-tier segment is never deleted from
        # under its manifest
        unpinned = (steps if self.pin_check is None
                    else [s for s in steps if not self.pin_check(s)])
        for s in unpinned[: -self.keep_last] if self.keep_last > 0 else unpinned:
            self._committed_names.discard(self._step_dir(s).name)
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for d in torn + tmp:  # torn checkpoints (no COMMITTED), leftovers
            shutil.rmtree(d, ignore_errors=True)


__all__ = ["CheckpointStore"]
