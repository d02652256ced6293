"""DeviceBank: a device-resident mirror of an :class:`EmbeddingBank` arena
(the twin of ``repro.index.device.DeviceBank``).

The ``pallas`` search backend uploads the host arena to the card on every
call (``capacity * dim * 4`` bytes per lookup). DeviceBank removes that
traffic: the arena is a float32 tensor on the card, written in place:

* ``set_row(slot, vec)``    — one row write; uploads ``dim * 4`` bytes.
* ``set_rows(slots, vecs)`` — one ``index_copy_`` for a whole admission
  wave; uploads ``n * dim * 4`` bytes of rows and ``n * 4`` bytes of int32
  slots. The reference pads a wave to a power of two so that its jit cache
  sees few shapes; eager PyTorch needs no such padding, so there is none,
  and the bytes counted differ from the reference's by that padding only.
* ``clear_row`` / ``clear`` — ``zero_()`` on the card: no upload.
* ``ensure_capacity``        — doubling: a new arena on the card and a
  device-to-device copy, no upload.

Steady-state lookups move only the query batch to the card. Every upload
this class makes is counted in ``h2d_bytes_total`` (queries through
``note_h2d``). Uploads from numpy are blocking copies: the caller may reuse
its (pageable) buffer as soon as a call returns.

Thread-safety: DeviceBank is not locked itself. Its ``SimilarityIndex``
mutates and searches it only under ``bank.lock``, the lock that serializes
the host arena's writes. Slot ``i`` on the host is row ``i`` here, so the
rows a search returns resolve through ``EmbeddingBank.key_of`` unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.index.bank import DIM
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import names as _names


class DeviceBank:
    """``(capacity, dim)`` float32 arena on ``device``; capacity only ever
    doubles, mirroring ``EmbeddingBank._grow``. Its upload and write
    counters are registry-backed (``obs``, labelled ``obs_labels``), read
    through the reference's attribute names."""

    _COUNTERS = {
        "h2d_bytes_total": _names.DEVICE_H2D_BYTES,
        "row_updates": _names.DEVICE_ROW_UPDATES,
        "batched_updates": _names.DEVICE_BATCHED_UPDATES,
        "clears": _names.DEVICE_CLEARS,
        "grows": _names.DEVICE_GROWS,
    }

    def __init__(self, capacity: int = 64, dim: int = DIM, *, device: torch.device,
                 obs: Optional[MetricsRegistry] = None,
                 obs_labels: Optional[Dict[str, str]] = None):
        cap = max(1, int(capacity))
        self.dim = dim
        self.device = torch.device(device)
        self._arena = torch.zeros((cap, dim), dtype=torch.float32, device=self.device)
        # every host-to-device byte this bank moves, and the writes by kind
        reg = obs if obs is not None else MetricsRegistry()
        labels = obs_labels or {}
        self._c = {field: reg.counter(name, **labels)
                   for field, name in self._COUNTERS.items()}
        self._cap_gauge = reg.gauge(_names.DEVICE_CAPACITY, **labels)
        self._cap_gauge.set(cap)

    @property
    def capacity(self) -> int:
        return self._arena.shape[0]

    @property
    def h2d_bytes_total(self) -> int:
        return int(self._c["h2d_bytes_total"].value)

    @property
    def row_updates(self) -> int:
        return int(self._c["row_updates"].value)

    @property
    def batched_updates(self) -> int:
        return int(self._c["batched_updates"].value)

    @property
    def clears(self) -> int:
        return int(self._c["clears"].value)

    @property
    def grows(self) -> int:
        return int(self._c["grows"].value)

    def telemetry(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "h2d_bytes_total": self.h2d_bytes_total,
            "row_updates": self.row_updates,
            "batched_updates": self.batched_updates,
            "clears": self.clears,
            "grows": self.grows,
        }

    @property
    def arena(self) -> torch.Tensor:
        """The live device tensor (searched in place; written only here)."""
        return self._arena

    def note_h2d(self, nbytes: int) -> None:
        """Count a transfer made on this bank's behalf (queries)."""
        self._c["h2d_bytes_total"].inc(int(nbytes))

    # -- mutation (caller holds the host bank's lock) ---------------------

    def ensure_capacity(self, capacity: int) -> None:
        """Grow on the card (no upload) until at least ``capacity`` rows."""
        if capacity > self.capacity:
            new_cap = self.capacity
            while new_cap < capacity:
                new_cap *= 2
            arena = torch.zeros((new_cap, self.dim), dtype=torch.float32, device=self.device)
            arena[: self.capacity].copy_(self._arena)
            self._arena = arena
            self._c["grows"].inc()
            self._cap_gauge.set(new_cap)

    def set_row(self, slot: int, vec: np.ndarray) -> None:
        self.ensure_capacity(slot + 1)
        v = np.asarray(vec, np.float32)
        self._arena[slot].copy_(torch.from_numpy(v))
        self._c["h2d_bytes_total"].inc(v.nbytes)
        self._c["row_updates"].inc()

    def set_rows(self, slots: Sequence[int], vecs: np.ndarray) -> None:
        """One ``index_copy_`` for a whole admission wave (distinct slots)."""
        if len(slots) == 0:
            return
        self.ensure_capacity(max(slots) + 1)
        s = np.asarray(slots, np.int32)
        v = np.ascontiguousarray(vecs, np.float32)
        idx = torch.from_numpy(s).to(self.device).long()
        self._arena.index_copy_(0, idx, torch.from_numpy(v).to(self.device))
        self._c["h2d_bytes_total"].inc(v.nbytes + s.nbytes)
        self._c["batched_updates"].inc()

    def clear_row(self, slot: int) -> None:
        """Tombstone a slot with zeros made on the card (no upload)."""
        if slot < self.capacity:
            self._arena[slot].zero_()

    def clear(self) -> None:
        self._arena.zero_()
        self._c["clears"].inc()
