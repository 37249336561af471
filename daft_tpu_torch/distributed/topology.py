"""Worker topology: which workers share a device mesh (one host).

The placement layer behind the hierarchical shuffle (the port's copy of
``daft_tpu/distributed/topology.py``): a hash boundary between workers
that share one device mesh should repartition over the mesh's
collectives (``parallel/exchange.py``), not serialize to Arrow IPC and
cross a socket. This module answers the one question that decision needs —
*which workers share a mesh* — and tracks the in-flight collective
exchange groups the resilience plane treats as all-or-nothing units.

Topology sources, in precedence order:

1. ``DAFT_TORCH_WORKER_TOPOLOGY`` — explicit ``name=w0,w1;name2=w2,w3``
   spec (the deployment knows its hosts); workers the spec does not name
   fall into singleton groups (Flight-only).
2. Autodetect — every in-process worker shares the process device mesh,
   so when a multi-device mesh is up they form ONE group; remote workers
   (and everything else when no mesh is up) are singleton groups.

The exchange-path decision (``plan_exchange_path``) is the decision
ladder the README documents: ``collective`` when producer and consumer
live on one mesh, ``hierarchical`` (intra-mesh collective, one Flight
stream per mesh) across meshes, else today's per-worker ``flight``
path — forced by ``DAFT_TORCH_EXCHANGE_PATH``, priced by
``device/costmodel`` (the measured mesh rate vs the wire), and degraded
to verbatim ``flight`` under ``DAFT_TORCH_CHAOS_SERIALIZE=1`` so chaos
replay stays bit-identical.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshGroup:
    """A set of workers sharing one device mesh (one host's mesh)."""

    name: str
    workers: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.workers)


class WorkerTopology:
    """Immutable worker → mesh-group map for one query."""

    def __init__(self, groups: List[MeshGroup]):
        self.groups = list(groups)
        self._of: Dict[str, MeshGroup] = {
            w: g for g in self.groups for w in g.workers}

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of(self, worker_id: str) -> Optional[MeshGroup]:
        return self._of.get(worker_id)

    def single_mesh(self) -> bool:
        """All workers on one multi-worker mesh (or one worker total) —
        the shape where an intra-mesh collective replaces the wire."""
        return len(self.groups) == 1

    def multi_worker_groups(self) -> int:
        """Groups where the hierarchical stream merge actually saves
        streams (one stream replaces ≥2)."""
        return sum(1 for g in self.groups if g.size > 1)

    def __repr__(self) -> str:
        return "WorkerTopology(" + "; ".join(
            f"{g.name}={','.join(g.workers)}" for g in self.groups) + ")"

    # ------------------------------------------------------- detection
    @classmethod
    def from_spec(cls, spec: str, worker_ids: List[str]
                  ) -> "WorkerTopology":
        """Parse ``name=w0,w1;name2=w2``. Unknown workers in the spec are
        ignored (the spec describes the deployment, not one query's
        worker set); workers the spec does not place become singleton
        groups."""
        groups: List[MeshGroup] = []
        placed = set()
        known = set(worker_ids)
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, eq, members = entry.partition("=")
            if not eq or not name.strip():
                raise ValueError(
                    f"DAFT_TORCH_WORKER_TOPOLOGY: bad entry {entry!r} "
                    f"(expected name=w0,w1;...)")
            ws = tuple(w.strip() for w in members.split(",")
                       if w.strip() and w.strip() in known)
            dup = [w for w in ws if w in placed]
            if dup:
                raise ValueError(
                    f"DAFT_TORCH_WORKER_TOPOLOGY: worker(s) {dup} appear "
                    f"in more than one mesh group")
            placed.update(ws)
            if ws:
                groups.append(MeshGroup(name.strip(), ws))
        for w in worker_ids:
            if w not in placed:
                groups.append(MeshGroup(w, (w,)))
        return cls(groups)

    @classmethod
    def detect(cls, worker_ids: List[str]) -> "WorkerTopology":
        """Topology for this query's workers: the explicit spec when set,
        else autodetect from the process device mesh."""
        spec = _topology_spec()
        if spec:
            return cls.from_spec(spec, worker_ids)
        if local_mesh_up():
            return cls([MeshGroup("local", tuple(worker_ids))])
        return cls([MeshGroup(w, (w,)) for w in worker_ids])


def local_mesh_up() -> bool:
    """True when this process has a mesh of two or more shards for
    intra-group collectives (``parallel/mesh.py``: none on the host tier
    or without the card the query asked for)."""
    from ..parallel import mesh as pmesh
    return pmesh.mesh_size() >= 2


def _topology_spec() -> Optional[str]:
    """The worker-topology spec: the env var is the per-process
    override; unset, the per-query ``ExecutionConfig.worker_topology``
    field applies (the registry's config_field contract)."""
    from .. import knobs
    spec = knobs.env_str("DAFT_TORCH_WORKER_TOPOLOGY")
    if spec:
        return spec
    try:
        from ..context import get_context
        return get_context().execution_config.worker_topology or None
    except Exception:
        return None


def _path_setting() -> str:
    """The exchange-path setting (env override, else the per-query
    ``ExecutionConfig.exchange_path`` field), validated: a typo'd
    rung must fail loudly, not silently behave like ``auto``."""
    from .. import knobs
    raw = knobs.env_raw("DAFT_TORCH_EXCHANGE_PATH")
    if raw is None:
        try:
            from ..context import get_context
            raw = get_context().execution_config.exchange_path
        except Exception:
            raw = "auto"
    raw = (raw or "auto").lower()
    if raw != "auto" and raw not in PATHS:
        raise ValueError(
            f"DAFT_TORCH_EXCHANGE_PATH / ExecutionConfig.exchange_path: "
            f"unknown exchange path {raw!r} (expected 'auto' or one of "
            f"{PATHS})")
    return raw


# ------------------------------------------------ exchange path decision

PATHS = ("collective", "hierarchical", "flight")


def plan_exchange_path(topo: WorkerTopology, num_partitions: int,
                       rows_est: Optional[int] = None,
                       row_bytes: float = 32.0) -> str:
    """The decision ladder for one hash boundary whose structural
    eligibility the stage planner already vetted:

    1. ``DAFT_TORCH_CHAOS_SERIALIZE=1`` → ``flight`` (the verbatim
       pre-topology path; chaos replay is bit-identical by contract).
    2. ``DAFT_TORCH_EXCHANGE_PATH`` / ``exchange_path`` forces any
       rung (an unknown value raises).
    3. An active fault plan (no explicit force) → ``flight``: recorded
       fault keys live on the flight path's task/fetch sites, so the
       auto ladder must not reroute them — the same explicit-wins
       contract as ``DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM``.
    4. One mesh group → ``collective`` when the cost model prices the
       mesh trip under the Flight trip (unknown sizes default-accept:
       the runtime admission gate re-prices with exact rows).
    5. Multiple groups with at least one multi-worker mesh →
       ``hierarchical`` (one stream per mesh instead of per worker).
    6. Otherwise ``flight``.
    """
    from .. import knobs
    from ..device import costmodel
    if knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"):
        return "flight"
    forced = _path_setting()
    if forced in PATHS:
        return forced
    from .resilience import active_fault_plan
    if active_fault_plan() is not None:
        return "flight"
    if topo.single_mesh():
        if costmodel.exchange_collective_wins(rows_est, row_bytes):
            return "collective"
        return "flight"
    if topo.multi_worker_groups() >= 1 \
            and costmodel.exchange_collective_wins(rows_est, row_bytes):
        return "hierarchical"
    return "flight"


# --------------------------------------------- collective lease registry
# Every in-flight collective exchange group holds a LEASE for its mesh
# resources (the all-or-nothing unit the resilience plane recomputes as
# one). The registry is the /metrics gauge AND the invariant daft-lint's
# Contract table proves: an acquired lease is released on every path —
# a leaked lease would make a finished exchange group look forever
# in-flight to operators and keep its group key shadowed.

_lease_lock = threading.Lock()
_leases: Dict[str, int] = {}


def acquire_collective(key: str) -> str:
    """Register one in-flight collective exchange group; returns the
    lease key to pass to :func:`release_collective` (pair them in
    try/finally — the ``collective-lease-leak`` contract row proves it
    statically)."""
    with _lease_lock:
        _leases[key] = _leases.get(key, 0) + 1
    return key


def release_collective(key: str) -> None:
    with _lease_lock:
        n = _leases.get(key, 0) - 1
        if n <= 0:
            _leases.pop(key, None)
        else:
            _leases[key] = n


def collective_inflight() -> int:
    """Gauge: collective exchange groups currently in flight."""
    with _lease_lock:
        return sum(_leases.values())


# ----------------------------------------------- collective group lineage


@dataclasses.dataclass
class CollectiveExchangeGroup:
    """Lineage producer for one mesh group's merged exchange output.

    Collective stages are ALL-OR-NOTHING: the per-mesh stream a
    hierarchical exchange serves is one fused artifact of every member
    map task plus the intra-mesh collective — there is no per-map-task
    receipt to recover. When the resilience plane loses the stream, it
    re-runs ``group_tasks`` as one unit and rebuilds the merged receipt
    through ``rebuild`` (``resilience.TaskSupervisor.recover_source``
    dispatches on ``group_tasks``)."""

    fault_key: str
    group_tasks: List[object]                 # member StageTasks
    rebuild: Callable[[List[object]], object]  # task outputs → receipt
