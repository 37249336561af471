"""Process-wide memory governor: RSS-watermark backpressure.

The port of ``daft_tpu/execution/governor.py``. The breaker tier
(``execution/memory.py``) bounds what each *store* buffers, but nothing
there watches the PROCESS: scan loads, the device pipeline, grace-join
stores and exchange buffers can each sit under their budget and together
walk RSS past ``DAFT_TORCH_MEMORY_LIMIT``. The governor observes real RSS
and acts before the kernel does:

- **watermarks** — RSS is sampled (throttled, from ``/proc/self/statm``)
  against the memory limit; crossing ``DAFT_TORCH_GOVERNOR_HIGH`` (default
  0.85 × limit) enters the pressured state, which only clears below
  ``DAFT_TORCH_GOVERNOR_LOW`` (default 0.70) — hysteresis, so actions
  don't flap at the boundary;
- **actions under pressure** — spill budgets shrink (:func:`budget_scale`
  halves the pair/bucket budget, so grace joins and spilling reducers fan
  out into smaller resident work units), read-ahead narrows to one
  (:func:`prefetch_window`), admission points take a bounded throttle
  wait (:func:`throttle`, never a hard gate), and one ``gc.collect()``
  runs per pressure episode;
- **evidence** — every action lands in the ``governor`` counters, and the
  process peak RSS is tracked.

Without a memory limit the governor is inert (there is no watermark to
govern against); peak-RSS tracking still works.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

# ------------------------------------------------------------- counters
# the spill plane's snapshot/delta discipline

_counters_lock = threading.Lock()
_counters: Dict[str, float] = {}


def governor_count(name: str, n: float = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n
    # also credit the thread's attributed query (its ``governor`` block)
    from .. import observability as obs
    obs.bump_plane("governor", name, n)


def counters_snapshot() -> Dict[str, float]:
    with _counters_lock:
        return dict(_counters)


def counters_delta(before: Dict[str, float],
                   after: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    if after is None:
        after = counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


# ------------------------------------------------------------ RSS probe

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
#: sampling throttle: /proc reads are ~µs but the callers are hot loops
_SAMPLE_INTERVAL_S = 0.02

_state_lock = threading.Lock()
_last_sample_t = 0.0
_last_rss = 0
_peak_rss = 0
_pressured = False
_gc_pending = False


def _read_rss() -> int:
    """Resident set size in bytes. ``/proc/self/statm`` field 2 on
    Linux; the ru_maxrss fallback (macOS/CI containers without /proc)
    reports the high-water mark instead — monotone, which only makes the
    governor MORE conservative."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        try:
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return int(ru) * 1024  # Linux reports KiB
        except Exception:
            return 0


def rss_bytes(refresh: bool = False) -> int:
    """Throttled current RSS (a fresh read at most every 20ms process
    wide; ``refresh=True`` forces one)."""
    global _last_sample_t, _last_rss, _peak_rss
    now = time.monotonic()
    with _state_lock:
        if not refresh and now - _last_sample_t < _SAMPLE_INTERVAL_S:
            return _last_rss
        _last_sample_t = now
    rss = _read_rss()
    with _state_lock:
        _last_rss = rss
        if rss > _peak_rss:
            _peak_rss = rss
        return rss


def peak_rss_bytes() -> int:
    """High-water RSS since process start (or the last
    :func:`reset_peak`) as seen by the governor's samples."""
    rss_bytes()
    with _state_lock:
        return _peak_rss


def reset_peak() -> int:
    """Restart peak tracking from the current RSS (a per-query peak
    bookend) and return the new baseline."""
    global _peak_rss
    rss = rss_bytes(refresh=True)
    with _state_lock:
        _peak_rss = rss
    return rss


# ----------------------------------------------------------- watermarks

def limit_bytes() -> Optional[int]:
    from . import memory
    try:
        return memory.memory_limit_bytes()
    except ValueError:
        return None


def watermarks(cfg=None) -> tuple:
    """(high, low) pressure fractions of the memory limit.
    ``DAFT_TORCH_GOVERNOR_HIGH`` / ``_LOW`` override the
    ``ExecutionConfig`` fields; low is clamped under high so the
    hysteresis band never inverts."""
    from .. import knobs
    if cfg is None:
        from ..context import get_context
        cfg = get_context().execution_config
    high = knobs.env_opt_float("DAFT_TORCH_GOVERNOR_HIGH")
    if high is None:
        high = cfg.governor_high
    low = knobs.env_opt_float("DAFT_TORCH_GOVERNOR_LOW")
    if low is None:
        low = cfg.governor_low
    high = max(float(high), 0.05)
    low = min(max(float(low), 0.0), high * 0.99)
    return high, low


def enabled(cfg=None) -> bool:
    """Governor active: a memory limit exists, ``DAFT_TORCH_GOVERNOR``
    isn't off, and the chaos-determinism freeze is not on
    (``calibration.frozen``: a replayed plan must not depend on the
    recording machine's RSS)."""
    from .. import knobs
    from ..device.calibration import frozen
    if not knobs.env_bool("DAFT_TORCH_GOVERNOR"):
        return False
    if limit_bytes() is None:
        return False
    return not frozen()


def pressure() -> float:
    """RSS / limit (0.0 when unlimited)."""
    lim = limit_bytes()
    if not lim:
        return 0.0
    return rss_bytes() / lim


def under_pressure(cfg=None) -> bool:
    """Sample RSS and return the hysteresis state: True above the high
    watermark until RSS falls back under the low one. Rising edges count
    a ``pressure_episodes`` action and schedule one gc.collect()."""
    global _pressured, _gc_pending
    if not enabled(cfg):
        return False
    lim = limit_bytes()
    high, low = watermarks(cfg)
    rss = rss_bytes()
    run_gc = False
    with _state_lock:
        if not _pressured and rss >= high * lim:
            _pressured = True
            _gc_pending = True
        elif _pressured and rss <= low * lim:
            _pressured = False
        if _pressured and _gc_pending:
            _gc_pending = False
            run_gc = True
        pressured = _pressured
    if run_gc:
        # outside the lock: a collection can run finalizers that re-enter
        governor_count("pressure_episodes")
        import gc
        gc.collect()
        governor_count("gc_collects")
        rss_bytes(refresh=True)
    return pressured


def budget_scale(cfg=None) -> float:
    """Multiplier for spill pair/bucket budgets: 0.5 under pressure
    (smaller resident work units → more, smaller partitions), 1.0
    otherwise. Counted so fanout decisions taken under governor pressure
    are visible in the stats blocks."""
    if under_pressure(cfg):
        governor_count("budget_shrinks")
        return 0.5
    return 1.0


def prefetch_window(base: int, cfg=None) -> int:
    """Read-ahead window under governor control: collapses to 1 ahead
    while pressured (prefetched bytes are exactly the RSS the governor is
    trying to claw back)."""
    if base > 1 and under_pressure(cfg):
        governor_count("prefetch_shrinks")
        return 1
    return base


#: bounded throttle: total wait cap and slice (never a hard gate)
_THROTTLE_MAX_S = 0.5
_THROTTLE_SLICE_S = 0.05


def throttle(kind: str = "admission", cfg=None) -> float:
    """Bounded backpressure at an admission point (a scan task's load,
    pipeline admission): while pressured, sleep in 50ms
    slices up to 0.5s total, re-sampling between slices so a drop below
    the low watermark releases early. Returns seconds actually waited.
    DEADLOCK-SAFE by construction: the wait is time-bounded and holds no
    locks, so even if every thread throttles at once the process keeps
    making progress at ≥2 steps/second."""
    if not under_pressure(cfg):
        return 0.0
    t0 = time.monotonic()
    waited = 0.0
    while waited < _THROTTLE_MAX_S:
        time.sleep(_THROTTLE_SLICE_S)
        waited = time.monotonic() - t0
        if not under_pressure(cfg):
            break
    governor_count("throttle_waits")
    governor_count("throttle_wait_us", waited * 1e6)
    governor_count(f"throttle_{kind}")
    return waited


def snapshot() -> Dict[str, float]:
    """Gauge snapshot: current/peak RSS, the configured limit, and the
    live pressured flag."""
    lim = limit_bytes() or 0
    rss = rss_bytes()
    with _state_lock:
        peak = _peak_rss
        pressured = _pressured
    return {"rss_bytes": float(rss), "rss_peak_bytes": float(peak),
            "limit_bytes": float(lim),
            "pressured": 1.0 if pressured else 0.0}


def _reset_for_tests() -> None:
    """Test hook: clear hysteresis/peak state between cases."""
    global _pressured, _gc_pending, _last_sample_t, _peak_rss, _last_rss
    with _state_lock:
        _pressured = False
        _gc_pending = False
        _last_sample_t = 0.0
        _last_rss = 0
        _peak_rss = 0
