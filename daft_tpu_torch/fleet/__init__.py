"""Horizontal serving plane: N driver replicas behind one front door.

The port's copy of ``daft_tpu/fleet/``. Pieces (each submodule's
docstring carries the design):

- ``router``      — consistent-hash session affinity, drain/kill
                    lifecycle, gauge aggregation + scale signal;
- ``cache_tier``  — cross-replica plan/result cache layer keyed by the
                    plan fingerprints (sidecar store or in-process hub);
- ``state_sync``  — gossiped learned state (calibration profiles +
                    admission history) with gen-stamped idempotent
                    merges, plus the fleet counters plane;
- ``replica``     — the subprocess replica entrypoint: Spark Connect
                    server + control HTTP plane + gossip loop.

This package root only hosts the process-level router install point the
Spark Connect server consults; everything else is imported on demand so
``import daft_tpu_torch`` stays fleet-free.
"""

from __future__ import annotations

import threading
from typing import Optional

_router_lock = threading.Lock()
_router = None


def install_router(router) -> None:
    """Install the process's fleet router: the Spark Connect server
    routes session submissions through it when present. None uninstalls
    (tests)."""
    global _router
    with _router_lock:
        _router = router


def installed_router():
    with _router_lock:
        return _router


def __getattr__(name: str):
    if name in ("router", "cache_tier", "state_sync", "replica"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name in ("FleetRouter", "InProcessReplica", "SubprocessReplica",
                "ReplicaUnavailable", "ConnectUnavailable"):
        from . import router as _r
        return getattr(_r, name)
    if name == "StateStore":
        from . import state_sync as _s
        return _s.StateStore
    raise AttributeError(name)
