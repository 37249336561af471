"""Replicated learned state: what one replica learns, the fleet knows.

The port's copy of ``daft_tpu/fleet/state_sync.py``. Everything the
engine learns is process-local by birth — the calibration
profile (``device/calibration.py``) and the per-fingerprint admission /
result-byte history (``serving/scheduler.py``) both start empty in a
fresh replica, which means a scale-up event serves its first minutes of
traffic priced from hard-coded defaults. This module makes learned state
a first-class replicated artifact (the Exoshuffle lineage-as-shared-
metadata idea applied to cost-model evidence): each replica owns ONE
origin slot, stamps it with a monotonic generation counter, and gossips
full origin snapshots; peers keep the newest snapshot per origin.

Merge semantics (the properties the fleet tests assert):

- **idempotent** — re-ingesting a snapshot whose ``(origin, gen)`` is
  already held is a no-op (last-writer-wins per origin by generation);
- **commutative** — ingest order cannot matter: the held state is a
  per-origin map keyed by generation, and every *read* recomputes the
  merged view from it, so any ingest ordering that delivers the same
  snapshots yields bit-identical merged views;
- **sample-count-weighted** — merged views average origin values
  weighted by their EWMA sample counts, so a replica with 500
  observations outweighs one with 3.

Consumers:

- ``device/calibration.const`` falls back to :meth:`merged_calibration`
  when the local profile is below the sample floor — a cold replica's
  first query prices device dispatches from fleet history;
- ``serving/scheduler._fleet_history_estimate`` falls back to
  :meth:`merged_admission` when both the cost model and the local
  admission history are blind (counter ``est_seeded_fleet``);
- admission-history keys are ``PlanFingerprint.history_structure``-based
  (no calibration token), so the same workload hashes identically on
  every replica regardless of each one's learned profile.

The module also hosts the fleet-wide counters (routes, drains, gossip
merges) exported as the ``fleet`` plane of ``/metrics``
(``daft_torch_fleet_*``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------- counters

_counts_lock = threading.Lock()
_counters: Dict[str, float] = {}


def count(name: str, n: float = 1) -> None:
    """Bump a fleet-plane counter (``fleet:route``/``fleet:drain``
    events, gossip merges, fleet cache/calibration reads)."""
    with _counts_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters_snapshot() -> Dict[str, float]:
    with _counts_lock:
        return dict(_counters)


# ----------------------------------------------------------- sanitization

def _clean_calib(calib) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name, e in (calib or {}).items():
        try:
            v, n = float(e["value"]), float(e["samples"])
        except (TypeError, ValueError, KeyError):
            continue
        if v > 0 and n > 0:
            out[str(name)] = {"value": v, "samples": n}
    return out


def _clean_admission(adm) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for key, e in (adm or {}).items():
        try:
            if isinstance(e, dict):
                b = float(e["bytes"])
                w = float(e.get("wall_us", 0.0))
                n = float(e.get("samples", 1.0))
            else:  # the scheduler's native (bytes, wall_us, samples)
                b, w, n = float(e[0]), float(e[1]), float(e[2])
        except (TypeError, ValueError, KeyError, IndexError):
            continue
        if b >= 0 and n > 0:
            out[str(key)] = {"bytes": b, "wall_us": max(w, 0.0),
                             "samples": n}
    return out


def _copy_snap(s: dict) -> dict:
    return {"origin": s["origin"], "gen": s["gen"],
            "calib": {k: dict(v) for k, v in s["calib"].items()},
            "admission": {k: dict(v) for k, v in s["admission"].items()}}


# ------------------------------------------------------------------ store

class StateStore:
    """One replica's view of the fleet's learned state: its own origin
    slot (re-published with a bumped generation on every gossip round)
    plus the newest known snapshot of every peer origin."""

    def __init__(self, origin: str):
        self.origin = str(origin)
        self._lock = threading.Lock()
        self._gen = 0
        self._per_origin: Dict[str, dict] = {}

    # -- publish -------------------------------------------------------
    def publish_local(self, calibration=None, admission=None) -> dict:
        """Replace this replica's own origin snapshot with the given
        learned state and bump the generation. Returns a copy of the
        published snapshot (what a gossip push sends)."""
        calib = _clean_calib(calibration)
        adm = _clean_admission(admission)
        with self._lock:
            self._gen += 1
            snap = {"origin": self.origin, "gen": self._gen,
                    "calib": calib, "admission": adm}
            self._per_origin[self.origin] = snap
            out = _copy_snap(snap)
        count("publish")
        return out

    def publish_from_engine(self, scheduler=None) -> dict:
        """Convenience publish: export the process's LIVE learned state —
        the calibration profile plus the (given or process-shared)
        scheduler's admission history."""
        from ..device import calibration
        from ..serving import shared_scheduler_if_running
        calib = calibration.profile_entries()
        if scheduler is None:
            scheduler = shared_scheduler_if_running()
        adm = {} if scheduler is None \
            else scheduler.admission_history_snapshot()
        return self.publish_local(calibration=calib, admission=adm)

    # -- ingest --------------------------------------------------------
    def ingest(self, snapshot: dict) -> bool:
        """Accept a peer origin snapshot iff its generation is strictly
        newer than what we hold for that origin. Re-delivery and
        reordering are both safe: last-writer-wins per origin by
        generation is exactly idempotent, and merged views are computed
        from the held per-origin map on every read."""
        try:
            origin = str(snapshot["origin"])
            gen = int(snapshot["gen"])
        except (TypeError, ValueError, KeyError):
            count("ingest_malformed")
            return False
        if origin == self.origin:
            # we are authoritative for our own slot: a peer echoing our
            # old snapshot back must not regress the generation
            count("ingest_self")
            return False
        calib = _clean_calib(snapshot.get("calib"))
        adm = _clean_admission(snapshot.get("admission"))
        with self._lock:
            cur = self._per_origin.get(origin)
            if cur is not None and cur["gen"] >= gen:
                applied = False
            else:
                self._per_origin[origin] = {
                    "origin": origin, "gen": gen,
                    "calib": calib, "admission": adm}
                applied = True
        count("ingest_applied" if applied else "ingest_stale")
        return applied

    def snapshot_all(self) -> dict:
        """Full-state export for anti-entropy exchange: every origin
        snapshot this store holds (its own included)."""
        with self._lock:
            return {"origins": {o: _copy_snap(s)
                                for o, s in self._per_origin.items()}}

    def ingest_all(self, state: dict) -> int:
        """Merge a peer's full-state export; returns snapshots applied."""
        n = 0
        for snap in (state.get("origins") or {}).values():
            if isinstance(snap, dict) and self.ingest(snap):
                n += 1
        return n

    # -- merged views --------------------------------------------------
    def merged_admission(self, key: str
                         ) -> Optional[Tuple[float, float, float]]:
        """Sample-count-weighted fleet view of one admission-history
        key → ``(bytes, wall_us, samples)``, or None when no origin has
        observed it."""
        with self._lock:
            entries = [s["admission"].get(str(key))
                       for s in self._per_origin.values()]
        entries = [e for e in entries if e]
        if not entries:
            return None
        n = sum(e["samples"] for e in entries)
        b = sum(e["bytes"] * e["samples"] for e in entries) / n
        w = sum(e["wall_us"] * e["samples"] for e in entries) / n
        return (b, w, n)

    def merged_calibration(self, name: str
                           ) -> Optional[Tuple[float, float]]:
        """Sample-count-weighted fleet view of one calibrated constant
        → ``(value, samples)``, or None when the fleet is blind on it."""
        with self._lock:
            entries = [s["calib"].get(str(name))
                       for s in self._per_origin.values()]
        entries = [e for e in entries if e]
        if not entries:
            return None
        n = sum(e["samples"] for e in entries)
        v = sum(e["value"] * e["samples"] for e in entries) / n
        return (v, n)

    def merged_calibration_all(self) -> Dict[str, Tuple[float, float]]:
        with self._lock:
            names = {n for s in self._per_origin.values()
                     for n in s["calib"]}
        out: Dict[str, Tuple[float, float]] = {}
        for name in names:
            got = self.merged_calibration(name)
            if got is not None:
                out[name] = got
        return out

    # -- introspection -------------------------------------------------
    def origins(self) -> List[str]:
        with self._lock:
            return sorted(self._per_origin)

    def generation(self, origin: Optional[str] = None) -> int:
        with self._lock:
            s = self._per_origin.get(origin or self.origin)
            return int(s["gen"]) if s else 0

    def view(self) -> Dict[str, object]:
        """Dashboard/debug summary: per-origin generations + sizes."""
        with self._lock:
            return {o: {"gen": s["gen"], "calib": len(s["calib"]),
                        "admission": len(s["admission"])}
                    for o, s in self._per_origin.items()}


# ------------------------------------------------------- process install

_installed_lock = threading.Lock()
_installed: Optional[StateStore] = None


def install(store: Optional[StateStore]) -> None:
    """Install the process's fleet state store — the provider
    ``calibration.const`` and the scheduler's admission estimator fall
    back to. Pass None to uninstall (tests)."""
    global _installed
    with _installed_lock:
        _installed = store


def installed() -> Optional[StateStore]:
    with _installed_lock:
        return _installed


def reset_for_tests() -> None:
    global _installed
    with _installed_lock:
        _installed = None
    with _counts_lock:
        _counters.clear()
