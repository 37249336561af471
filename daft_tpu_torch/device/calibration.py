"""Calibrated cost-model profile: rates observed at real dispatches,
learned with an EWMA and used in place of the measured defaults once a
sample floor is met.

The torch rewrite of ``daft_tpu/device/calibration.py``. Calibrated names
(same units as the ``costmodel`` constant they override):

- ``DEV_VECTOR_BPS`` / ``DEV_AGG_BPS`` / ``DEV_AGG_HASH_BPS`` — achieved
  device bytes/s per kernel family and strategy, observed at every real
  dispatch through ``costmodel.ledger_record``;
- ``DEV_SORT_ROWS_PER_S`` / ``DEV_JOIN_ROWS_PER_S`` /
  ``DEV_JOIN_HASH_ROWS_PER_S`` — achieved rows/s, same chokepoint;
- ``SPILL_DISK_BPS`` — the spill tier's IPC rate (measured by
  ``calibrate``'s ``spill_disk`` line; no dispatch observes it);
- ``NDV_FOOTER_RATIO`` — observed actual-groups / footer-NDV ratio, which
  damps footer NDV evidence in ``costmodel.groupby_strategy``.

Everything is gated on ``DAFT_TORCH_CALIBRATION`` (default off): with the
knob off ``const`` returns the caller's default and the observation
chokepoints do nothing. With ``DAFT_TORCH_CALIBRATION_DIR`` set the
profile persists across processes, one file per card and host
(``backend.device_key``): a profile learned on one machine never prices
another's decisions.

A fresh process with calibration on seeds its profile once from the
flight recorder's history (``DAFT_TORCH_QUERY_LOG``,
:func:`ingest_flight_history`): each persisted query's ``device_kernels``
block carries the evidence ``ledger_record`` observes live.

- ``SHUFFLE_WIRE_BPS`` — the shuffle wire's achieved rate, observed at
  every sizable partition fetch (``distributed/shuffle_service.py``);
- ``ICI_BPS`` — the mesh exchange's measured rate
  (``costmodel._measure_ici``), so a process without a mesh prices with
  it.

Under ``DAFT_TORCH_CHAOS_SERIALIZE=1`` or an active fault plan
(``distributed/resilience.py``) the profile is frozen (:func:`frozen`):
reads return the caller's default and observations are dropped, so a
chaos replay prices every decision as the recorded run did.

:func:`plan_token` folds the active constants into the serving plane's
plan fingerprints (``logical/fingerprint.py``). The fleet-gossiped
constants wait for the fleet (ROADMAP A8b).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from typing import Dict, Optional

from .. import knobs

#: observations between opportunistic persists (plus a time throttle)
_PERSIST_EVERY = 32
_PERSIST_MIN_INTERVAL_S = 5.0

#: calibrated-NDV damping is clamped: below this one freak observation
#: would erase footer evidence, above it would inflate footer NDV past the
#: row count the caller clamps to
_NDV_RATIO_MIN = 1.0 / 64.0
_NDV_RATIO_MAX = 4.0

_lock = threading.Lock()
_profile: Optional[Dict[str, Dict[str, float]]] = None  # name → entry
_obs_since_persist = 0
_last_persist = 0.0
_atexit_registered = False
_history_ingested = False


# ------------------------------------------------------------------ knobs

def enabled() -> bool:
    return knobs.env_bool("DAFT_TORCH_CALIBRATION")


def frozen() -> bool:
    """The profile is frozen (reads give defaults, observations are
    dropped) while the chaos-determinism contract holds: serialized chaos
    or an active fault plan."""
    if knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"):
        return True
    from ..distributed.resilience import active_fault_plan
    return active_fault_plan() is not None


def _active() -> bool:
    return enabled() and not frozen()


def alpha() -> float:
    return min(max(knobs.env_float("DAFT_TORCH_CALIBRATION_ALPHA"), 1e-3),
               1.0)


def min_samples() -> int:
    return max(knobs.env_int("DAFT_TORCH_CALIBRATION_MIN_SAMPLES"), 1)


def profile_dir() -> Optional[str]:
    return knobs.env_raw("DAFT_TORCH_CALIBRATION_DIR")


def _profile_key() -> str:
    from . import backend
    return backend.device_key(backend.resolve_device())


def _path() -> Optional[str]:
    d = profile_dir()
    if not d:
        return None
    safe = "".join(c if c.isalnum() or c in "-_.@" else "_"
                   for c in _profile_key())
    return os.path.join(d, f"calibration_{safe}.json")


# ------------------------------------------------------------- load/store

def _read_profile_file() -> Dict[str, Dict[str, float]]:
    """Parse the persisted profile; a missing, unreadable or foreign
    (another card or host) file is an empty profile."""
    out: Dict[str, Dict[str, float]] = {}
    path = _path()
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return out
    if d.get("key") != _profile_key():
        return out
    for name, e in (d.get("entries") or {}).items():
        v, n = float(e["value"]), float(e["samples"])
        if math.isfinite(v) and v > 0 and n > 0:
            out[name] = {"value": v, "samples": n}
    return out


def _ensure_loaded() -> None:
    """Lazy one-time profile load; the file read happens outside the lock
    (a duplicate read in a race is harmless; the first install wins).
    After the install the flight-recorder history seeds the profile once
    (the nested ``observe`` calls of the ingest re-enter here and return
    on the installed profile: the latch is set before they run)."""
    global _profile
    if _profile is None:
        loaded = _read_profile_file()
        with _lock:
            if _profile is None:
                _profile = loaded
    if not _history_ingested and _active():
        ingest_flight_history()


def ingest_flight_history(limit: int = 200) -> int:
    """Seed the profile from the flight recorder's history: each entry's
    ``device_kernels`` block, per family, observed as one dispatch group.
    Once per process (a call while calibration is off does not use the
    latch up). Returns the observations ingested."""
    global _history_ingested
    if not _active():
        return 0
    with _lock:
        if _history_ingested:
            return 0
        _history_ingested = True
    from .. import tracing
    n = 0
    for entry in tracing.flight_history(limit=limit):
        dk = entry.get("device_kernels")
        if not isinstance(dk, dict):
            continue
        for kind, d in dk.items():
            if not isinstance(d, dict):
                continue
            try:
                n += _observe_family(
                    kind, d.get("strategy"),
                    rows=float(d.get("rows", 0) or 0),
                    nbytes=float(d.get("bytes", 0) or 0),
                    seconds=float(d.get("seconds", 0) or 0),
                    dispatches=float(d.get("dispatches", 1) or 1))
            except (TypeError, ValueError):
                continue
    return n


def _persist(snapshot: Dict[str, Dict[str, float]]) -> None:
    """Atomic profile write (outside the lock: the caller passes a
    snapshot)."""
    path = _path()
    if not path:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"key": _profile_key(), "ts": time.time(),
                   "entries": snapshot}, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------- updates

def observe(name: str, value: float, weight: float = 1.0) -> None:
    """Fold one observed constant into the profile (EWMA with an effective
    weight: ``w`` repeated samples collapse to one update). No-op when
    calibration is off or the sample is not a positive finite number."""
    global _obs_since_persist, _last_persist, _atexit_registered
    if not _active():
        return
    value, weight = float(value), float(weight)
    if not math.isfinite(value) or value <= 0 or weight <= 0:
        return
    persist_snap = None
    _ensure_loaded()
    with _lock:
        if not _atexit_registered and profile_dir():
            # a short-lived process must not lose the tail of its
            # observations to the persist throttle
            import atexit
            atexit.register(flush)
            _atexit_registered = True
        prof = _profile
        e = prof.get(name)
        if e is None:
            prof[name] = {"value": value, "samples": weight}
        else:
            a = 1.0 - (1.0 - alpha()) ** weight
            e["value"] += a * (value - e["value"])
            e["samples"] += weight
        _obs_since_persist += 1
        now = time.monotonic()
        if _obs_since_persist >= _PERSIST_EVERY \
                and now - _last_persist > _PERSIST_MIN_INTERVAL_S:
            _obs_since_persist = 0
            _last_persist = now
            persist_snap = {k: dict(v) for k, v in prof.items()}
    if persist_snap is not None:
        _persist(persist_snap)


def flush() -> None:
    """Persist the current profile now (atexit hook, tests)."""
    global _obs_since_persist
    with _lock:
        if _profile is None:
            return
        _obs_since_persist = 0
        snap = {k: dict(v) for k, v in _profile.items()}
    _persist(snap)


_FAMILY_BYTES = {("grouped_agg", "hash"): "DEV_AGG_HASH_BPS",
                 ("grouped_agg", "sort"): "DEV_AGG_BPS",
                 ("grouped_agg", None): "DEV_AGG_BPS",
                 ("projection", None): "DEV_VECTOR_BPS"}
_FAMILY_ROWS = {("argsort", None): "DEV_SORT_ROWS_PER_S",
                ("join", "hash"): "DEV_JOIN_HASH_ROWS_PER_S",
                ("join", "sort"): "DEV_JOIN_ROWS_PER_S",
                ("join", None): "DEV_JOIN_ROWS_PER_S"}

#: dispatches below these floors measure launch overhead, not the kernel
#: rate the constants model — skip them
_MIN_OBS_BYTES = 1 << 16
_MIN_OBS_ROWS = 1 << 12
_MIN_OBS_SECONDS = 1e-5


def _observe_family(kind: str, strategy: Optional[str], rows: float,
                    nbytes: float, seconds: float,
                    dispatches: float = 1.0) -> int:
    """One ledger-shaped observation → the matching calibrated constant
    (per-dispatch achieved rate, dispatch overhead subtracted so a small
    batch does not read as a slow kernel). Returns 1 when recorded."""
    if seconds <= _MIN_OBS_SECONDS or dispatches <= 0:
        return 0
    skey = strategy if strategy in ("hash", "sort") else None
    from . import costmodel
    eff_s = max(seconds - costmodel.DEV_DISPATCH_S * dispatches,
                seconds * 0.1)
    name = _FAMILY_BYTES.get((kind, skey)) or _FAMILY_BYTES.get((kind, None))
    if name is not None and nbytes >= _MIN_OBS_BYTES:
        observe(name, nbytes / eff_s, weight=dispatches)
        return 1
    name = _FAMILY_ROWS.get((kind, skey)) or _FAMILY_ROWS.get((kind, None))
    if name is not None and rows >= _MIN_OBS_ROWS:
        observe(name, rows / eff_s, weight=dispatches)
        return 1
    return 0


def observe_dispatch(kind: str, strategy: Optional[str], rows: float,
                     nbytes: float, seconds: float,
                     dispatches: float = 1.0) -> None:
    """Live chokepoint, called by ``costmodel.ledger_record`` at every
    real dispatch; one knob read when calibration is off."""
    if not _active():
        return
    _observe_family(kind, strategy, rows=rows, nbytes=nbytes,
                    seconds=seconds, dispatches=dispatches)


# ------------------------------------------------------------------ reads

def const(name: str, default: float) -> float:
    """The calibrated value for ``name`` when the profile has one past the
    sample floor and calibration is on; else the caller's default. Every
    costmodel rate read routes through here."""
    if not _active():
        return default
    _ensure_loaded()
    with _lock:
        e = _profile.get(name)
        if e is not None and e["samples"] >= min_samples():
            return e["value"]
    return default


def profile_entries() -> Dict[str, Dict[str, float]]:
    """Copy of the learned profile ``{name: {value, samples}}``."""
    _ensure_loaded()
    with _lock:
        return {k: dict(v) for k, v in _profile.items()}


def plan_token() -> str:
    """Calibration-generation token folded into plan fingerprints
    (``logical/fingerprint.py``): a quantized digest of every constant
    ACTIVELY overriding its default right now. When a calibrated value
    crosses the sample floor or moves materially, the token changes and
    cached plans priced under the old constants stop being served. Empty
    when calibration is off or frozen or nothing is active, so the common
    path leaves fingerprints untouched. Local constants only: the
    fleet-inherited ones come with the fleet (ROADMAP A8b)."""
    if not enabled() or frozen():
        return ""
    floor = min_samples()
    # 2 significant digits: EWMA nudges within a few percent keep the
    # token (and so the plan cache) stable
    active = {n: f"{e['value']:.1e}" for n, e in profile_entries().items()
              if e["samples"] >= floor}
    if not active:
        return ""
    blob = ",".join(f"{n}={active[n]}" for n in sorted(active))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def ndv_ratio() -> float:
    """Clamped damping factor for footer NDV evidence (1.0 = trust the
    footer; the observed actual/footer ratio once calibrated)."""
    r = const("NDV_FOOTER_RATIO", 1.0)
    return min(max(r, _NDV_RATIO_MIN), _NDV_RATIO_MAX)


def summary(defaults: Optional[Dict[str, float]] = None
            ) -> Dict[str, Dict[str, object]]:
    """Per constant the default, the learned value, its sample count, and
    whether it overrides the default right now."""
    if defaults is None:
        defaults = costmodel_defaults()
    on = enabled()
    floor = min_samples()
    prof = profile_entries()
    out: Dict[str, Dict[str, object]] = {}
    for name, default in defaults.items():
        e = prof.pop(name, None)
        out[name] = {"default": default,
                     "value": e["value"] if e else None,
                     "samples": e["samples"] if e else 0,
                     "active": bool(on and e and e["samples"] >= floor)}
    for name, e in prof.items():  # learned names outside the default map
        out[name] = {"default": None, "value": e["value"],
                     "samples": e["samples"],
                     "active": bool(on and e["samples"] >= floor)}
    return out


def costmodel_defaults() -> Dict[str, float]:
    """The measured constants the profile can override, single-sourced
    from the costmodel module."""
    from . import costmodel as cm
    return {"DEV_VECTOR_BPS": cm.DEV_VECTOR_BPS,
            "DEV_AGG_BPS": cm.DEV_AGG_BPS,
            "DEV_AGG_HASH_BPS": cm.DEV_AGG_HASH_BPS,
            "DEV_AGG_DENSE_BPS": cm.DEV_AGG_DENSE_BPS,
            "DEV_SORT_ROWS_PER_S": cm.DEV_SORT_ROWS_PER_S,
            "DEV_JOIN_ROWS_PER_S": cm.DEV_JOIN_ROWS_PER_S,
            "DEV_JOIN_HASH_ROWS_PER_S": cm.DEV_JOIN_HASH_ROWS_PER_S,
            "SPILL_DISK_BPS": cm.SPILL_DISK_BPS,
            "SHUFFLE_WIRE_BPS":
                knobs.env_float("DAFT_TORCH_SHUFFLE_WIRE_MBPS") * 1e6,
            "ICI_BPS": cm._ICI_FALLBACK_BPS,
            "NDV_FOOTER_RATIO": 1.0}


def calibrated_names() -> list:
    """Names overriding their defaults right now (sorted)."""
    return sorted(n for n, d in summary().items() if d["active"])


def reset_for_tests() -> None:
    global _profile, _obs_since_persist, _last_persist, _history_ingested
    with _lock:
        _profile = None
        _history_ingested = False
        _obs_since_persist = 0
        _last_persist = 0.0
