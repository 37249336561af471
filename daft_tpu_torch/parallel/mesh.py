"""The process's device mesh: an ordered list of torch devices, one per
shard.

The torch rewrite of ``daft_tpu/parallel/mesh.py``. The reference's mesh is
a 1-D ``data`` axis over every visible JAX device (virtual CPU devices in
its tests); its exchange programs run single-controller, one program over
all shards. The port keeps that shape without ``torch.distributed``: one
process drives every shard, and a shard is a device the shard's tensors
live on.

- ``DAFT_TORCH_MESH_DEVICES=n`` asks for n shards, placed round-robin over
  the visible devices of the query's device type: with one card every
  shard sits on ``cuda:0`` (the counterpart of the reference's virtual
  devices), under ``DAFT_TORCH_DEVICE=cpu`` every shard sits on ``cpu``.
- Unset, the mesh spans ``torch.cuda.device_count()`` devices: one card
  (or none) means a mesh of at most one shard, so the mesh paths stay off
  and the single-card path plans exactly as it does without this module.
- The backend guard: the mesh exists when the query runs on a CUDA card
  that is present, or on the CPU because the caller asked for it; the
  host tier (``DAFT_TORCH_DEVICE=0``) and a missing card give no mesh.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import knobs

_lock = threading.Lock()
_meshes: Dict[Tuple[str, int], "Mesh"] = {}


@dataclass(frozen=True)
class Mesh:
    """An ordered list of shard devices (shard i's tensors live on
    ``devices[i]``)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _query_device() -> Optional[torch.device]:
    """The query's device when the mesh may use it (see the module
    docstring's guard), else None; never raises."""
    from ..device import backend
    try:
        return backend.resolve_device()
    except (RuntimeError, ValueError):
        return None


def mesh_size() -> int:
    """Number of shards the exchange mesh spans (0 = no device). Read at
    call time: the knob and the query's device may change between
    queries."""
    device = _query_device()
    if device is None:
        return 0
    cap = knobs.env_opt_int("DAFT_TORCH_MESH_DEVICES")
    if cap is not None:
        return max(cap, 0)
    return torch.cuda.device_count() if device.type == "cuda" else 0


def mesh_admits(rows: Optional[int], row_bytes: float = 32.0) -> bool:
    """Admission for a mesh collective (exchange agg, hash repartition).

    ``DAFT_TORCH_MESH_MIN_ROWS`` set: the static row floor decides (``0``
    forces the mesh). Unset: the cost model prices the collective
    (dispatch plus the bytes over the measured shard-to-shard rate,
    ``costmodel.ici_bps``) against one host hash-partition pass."""
    v = knobs.env_opt_int("DAFT_TORCH_MESH_MIN_ROWS")
    if v is not None:
        return rows is None or rows >= v
    from ..device import costmodel
    return costmodel.mesh_exchange_wins(rows, row_bytes, mesh_size())


def make_mesh(n: int, device: torch.device) -> Mesh:
    """n shards round-robin over the visible devices of ``device``'s
    type (a CPU device holds every shard)."""
    if device.type == "cuda":
        count = max(torch.cuda.device_count(), 1)
        devs = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devs = tuple(torch.device(device.type) for _ in range(n))
    return Mesh(devs)


def get_mesh() -> Optional[Mesh]:
    """The mesh of this query's device (memoized per device type and
    size), or None when there is none."""
    n = mesh_size()
    device = _query_device()
    if n < 1 or device is None:
        return None
    key = (device.type, n)
    with _lock:
        m = _meshes.get(key)
        if m is None:
            m = _meshes[key] = make_mesh(n, device)
        return m


def reset_for_tests() -> None:
    with _lock:
        _meshes.clear()
