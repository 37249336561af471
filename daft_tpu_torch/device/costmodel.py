"""Measured transfer-aware dispatch cost model of the torch tier.

The torch rewrite of ``daft_tpu/device/costmodel.py``. Every decision the
reference prices goes through here: the per-operator paths
(``runtime.py``), the fused-agg gates (``execution/executor.py``,
``fragment._max_out_cap``), the device join (``joins.py``), and the
hash-vs-sort choice in front of the hash-agg and hash-join kernels. Each
compares

    device_time = bytes_up/up_bps + bytes_down/down_bps + round_trips·RTT
                  + DEV_DISPATCH_S + work / DEV_* rate
    host_time   = work / HOST_* rate

and runs the op on whichever side is cheaper. The link terms are measured
at the first decision on a card, through the path the port's transfers
take (pinned staging buffers and the copy stream, ``column._upload``;
``column.fetch_host``), once per process, and stored per card and host
(``DAFT_TORCH_LINK_CACHE``). A CPU device shares host memory: a zero-cost
link. A measurement that fails raises; there is no guessed profile.

The ``HOST_*`` and ``DEV_*`` constants below were measured on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit by
``python3 -m daft_tpu_torch.benchmarking.calibrate`` (``PERF.md`` §6
lists them beside the call that measured them): ``HOST_*`` from the
port's host tier (pyarrow and numpy) on that machine's CPU, ``DEV_*`` from
``mfu.report()`` (kernel rates on device-resident inputs) and
``op_floor.py`` (``DEV_DISPATCH_S``: the host time of one per-operator
device dispatch beyond its round trips); ``DEV_REGION_*`` from the
join_agg region's program (``calibrate``'s ``region_join_agg`` line).

Env overrides:
- ``DAFT_TORCH_LINK_RTT_MS`` / ``_UP_MBPS`` / ``_DOWN_MBPS``: skip the
  measurement, use these numbers;
- ``DAFT_TORCH_DEVICE_FORCE``: ``1`` the device always wins, ``0`` the
  host;
- ``DAFT_TORCH_DISPATCH_LOG``: one JSON line per decision.

``SPILL_DISK_BPS`` (the spill tier's IPC rate, :func:`spill_plan_wins`)
comes from ``calibrate``'s ``spill_disk`` line on the same machine.

Not carried over yet (each waits for its caller's slice, ROADMAP):
``image_resize_wins`` (A8).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

from .. import knobs

# Measured at 2^20 rows (``calibrate --rows 1048576``) on an NVIDIA H100
# 80GB HBM3 at 700.00 W and its host's CPU; PERF.md §6 has the unrounded
# values beside the other runs, and the model's check by ``op_floor.py``.
# host tier rates (the port's pyarrow/numpy host paths)
HOST_VECTOR_BPS = 3.146e9       # projection / predicate, per byte touched
HOST_AGG_BPS = 9.843e8          # grouped and global agg, per byte touched
HOST_SORT_ROWS_PER_S = 8.972e6  # multi-key argsort, key-rows/s
HOST_JOIN_ROWS_PER_S = 1.914e6  # equi-join index generation, rows/s

# device tier rates (kernels on device-resident planes)
DEV_VECTOR_BPS = 3.484e11     # compiled projection, per byte up + down
DEV_AGG_BPS = 1.558e10        # sort-strategy grouped agg, per encoded byte
DEV_AGG_HASH_BPS = 3.507e10   # hash-agg table build, per encoded byte
DEV_AGG_DENSE_BPS = 9.429e9   # dense (direct-indexed) agg, per encoded byte
DEV_SORT_ROWS_PER_S = 2.146e9       # packed-key argsort, key-rows/s
DEV_JOIN_ROWS_PER_S = 1.971e9       # torch sort join, rows/s (both sides)
DEV_JOIN_HASH_ROWS_PER_S = 7.032e9  # hash build + probe, rows/s
DEV_DISPATCH_S = 1.023e-3     # host time of one per-operator dispatch
#                               (encode, launches, fetch) beyond its two
#                               round trips
# the join_agg fusion region's torch program (``calibrate``'s
# ``region_join_agg`` line at 4,096 and 131,072 probe rows, every row
# matching one of 1,024 build rows, 64 groups; 700.00 W as above)
DEV_REGION_DISPATCH_S = 1.631e-3          # device time per dispatch
DEV_REGION_JOIN_AGG_ROWS_PER_S = 4.949e6  # probe rows/s beyond it

#: the most a cacheable upload may cost against one host pass (the
#: reference's bounded-investment rule: a policy ratio, not a rate)
INVEST_MAX_RATIO = 8.0


@dataclass(frozen=True)
class LinkProfile:
    rtt_s: float
    up_bps: float
    down_bps: float

    def device_seconds(self, bytes_up: float, bytes_down: float,
                       round_trips: float, kernel_s: float = 0.0) -> float:
        return (bytes_up / self.up_bps + bytes_down / self.down_bps
                + round_trips * self.rtt_s + kernel_s)

    def pipelined_seconds(self, bytes_up: float, bytes_down: float,
                          round_trips: float, kernel_s: float = 0.0
                          ) -> float:
        """Steady-state per-dispatch cost with the async pipeline
        overlapping the transfer legs with neighbour dispatches' compute:
        the slower of (wire, kernel) plus one round trip, never more than
        the serial chain."""
        link_s = bytes_up / self.up_bps + bytes_down / self.down_bps
        serial = link_s + round_trips * self.rtt_s + kernel_s
        steady = max(link_s, kernel_s) + self.rtt_s
        return min(serial, steady)


_SHARED_MEMORY = LinkProfile(0.0, math.inf, math.inf)

_lock = threading.Lock()
#: the link profile of each device key (``backend.device_key``) this
#: process has priced with
_profiles: dict = {}


def _cal(name: str, default: float) -> float:
    """One constant through the calibration store: the learned value once
    its sample floor is met and ``DAFT_TORCH_CALIBRATION`` is on, else the
    measured default."""
    from . import calibration
    return calibration.const(name, default)


def _env_profile() -> Optional[LinkProfile]:
    rtt = knobs.env_opt_float("DAFT_TORCH_LINK_RTT_MS")
    up = knobs.env_opt_float("DAFT_TORCH_LINK_UP_MBPS")
    down = knobs.env_opt_float("DAFT_TORCH_LINK_DOWN_MBPS")
    if rtt is None and up is None and down is None:
        return None
    return LinkProfile(
        rtt_s=(rtt if rtt is not None else 1.0) / 1e3,
        up_bps=(up if up is not None else 100.0) * 1e6,
        down_bps=(down if down is not None else 100.0) * 1e6)


def _measure(device) -> LinkProfile:
    """One link measurement on a card, through the port's own transfer
    path: pinned staging and the copy stream up (``column._upload``), one
    packed copy into a pinned buffer down (``column.fetch_host``).

    RTT: a 32-byte upload, a kernel and a fetch with its wait, median of
    three after an untimed first pass (lazy init: the copy stream, the
    pinned pool). Bandwidth: 8 MiB, two rounds; per round the fetch of a
    resident plane (down), then a fresh host buffer uploaded, touched by a
    kernel and fetched (up = that round trip less the down leg and one
    RTT). The slower round wins: an optimistic link estimate buys device
    mispredicts, a pessimistic one leaves an op on the host. The copies
    count in no transfer counter."""
    import statistics

    import numpy as np
    import torch

    from . import column as dcol

    def round_trip(host: np.ndarray) -> None:
        (t,), _, _ = dcol._upload([host], len(host), device)
        dcol.fetch_host([t + 1])

    with dcol.uncounted():
        tiny = np.zeros(8, dtype=np.float32)
        round_trip(tiny)
        rtts = []
        for _ in range(3):
            t0 = time.perf_counter()
            round_trip(tiny)
            rtts.append(time.perf_counter() - t0)
        rtt = max(statistics.median(rtts), 1e-7)

        nbytes = 1 << 23
        big = np.zeros(nbytes // 4, dtype=np.float32)
        (dev,), _, _ = dcol._upload([big], len(big), device)
        dev = dev + 0
        round_trip(big)   # untimed: pinned buffers of this size pooled
        torch.cuda.synchronize(device)
        down_best = up_best = 0.0
        for rnd in range(2):
            t0 = time.perf_counter()
            dcol.fetch_host([dev])
            down_s = max(time.perf_counter() - t0 - rtt / 2, 1e-7)
            fresh = big + (1.0 + rnd)
            t0 = time.perf_counter()
            round_trip(fresh)
            round_s = time.perf_counter() - t0
            up_s = max(round_s - down_s - rtt, down_s / 10, 1e-7)
            down_best = max(down_best, down_s)
            up_best = max(up_best, up_s)
    return LinkProfile(rtt_s=rtt, up_bps=nbytes / up_best,
                       down_bps=nbytes / down_best)


_LINK_CACHE_TTL_S = 1800.0      # reuse a stored profile this long
_LINK_BLEND_MAX_S = 6 * 3600.0  # blend with a stale one up to this age


def _link_cache_path() -> str:
    p = knobs.env_raw("DAFT_TORCH_LINK_CACHE_PATH")
    if p:
        return p
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "link_profile.json")


def _load_stored(key: str):
    """(LinkProfile, age_s) stored for this card and host, or (None,
    None): a missing file, or one stored for another card or host."""
    path = _link_cache_path()
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            d = json.load(f)
        if d.get("backend") != key:
            return None, None
        return LinkProfile(rtt_s=float(d["rtt_s"]),
                           up_bps=float(d["up_bps"]),
                           down_bps=float(d["down_bps"])), \
            time.time() - float(d["ts"])
    except (ValueError, KeyError, TypeError, AttributeError):
        return None, None   # a torn or foreign file: measure afresh


def _store(key: str, p: LinkProfile) -> None:
    path = _link_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"backend": key, "ts": time.time(), "rtt_s": p.rtt_s,
                   "up_bps": p.up_bps, "down_bps": p.down_bps}, f)
    os.replace(tmp, path)


def link_profile() -> LinkProfile:
    """The measured (or overridden) host↔device link of this query's
    device. A CPU device (or the host tier) shares host memory: a
    zero-cost link.

    A card's profile is stored (``DAFT_TORCH_LINK_CACHE_PATH``, default
    ``daft_tpu_torch/_build/link_profile.json``; ``DAFT_TORCH_LINK_CACHE=0``
    to measure in every process) under the card's name and the host's
    (``backend.device_key``), so a profile from another machine never
    drives a decision. Within 30 minutes the stored profile is used as
    is; after that a fresh measurement is blended geometrically with a
    stored one up to 6 hours old, to damp sample noise."""
    from . import backend
    device = backend.resolve_device()
    key = backend.device_key(device)
    p = _profiles.get(key)
    if p is not None:
        return p
    with _lock:
        p = _profiles.get(key)
        if p is not None:
            return p
        env = _env_profile()
        if env is not None:
            p = env
        elif key == "cpu":
            p = _SHARED_MEMORY
        else:
            use_cache = knobs.env_bool("DAFT_TORCH_LINK_CACHE")
            # daft-lint: allow(blocking-under-lock) -- intentional: _lock
            # held across load/measure/store so threads wait for the ONE
            # link measurement instead of racing duplicate ones
            stored, age = _load_stored(key) if use_cache else (None, None)
            if stored is not None and age < _LINK_CACHE_TTL_S:
                p = stored
            else:
                p = _measure(device)
                if stored is not None and age < _LINK_BLEND_MAX_S:
                    p = LinkProfile(
                        rtt_s=math.sqrt(p.rtt_s * stored.rtt_s),
                        up_bps=math.sqrt(p.up_bps * stored.up_bps),
                        down_bps=math.sqrt(p.down_bps * stored.down_bps))
                if use_cache:
                    # daft-lint: allow(blocking-under-lock) -- tiny JSON
                    # write, the same one-measurement critical section
                    _store(key, p)
        _profiles[key] = p
        return p


def constants() -> dict:
    """Every constant the model prices with (calibrated values where
    active), for the record beside a run's numbers."""
    from . import calibration
    out = {n: _cal(n, v) for n, v in calibration.costmodel_defaults()
           .items() if n != "NDV_FOOTER_RATIO"}
    out.update(HOST_VECTOR_BPS=HOST_VECTOR_BPS, HOST_AGG_BPS=HOST_AGG_BPS,
               HOST_SORT_ROWS_PER_S=HOST_SORT_ROWS_PER_S,
               HOST_JOIN_ROWS_PER_S=HOST_JOIN_ROWS_PER_S,
               DEV_DISPATCH_S=DEV_DISPATCH_S,
               DEV_REGION_DISPATCH_S=DEV_REGION_DISPATCH_S,
               DEV_REGION_JOIN_AGG_ROWS_PER_S=DEV_REGION_JOIN_AGG_ROWS_PER_S,
               INVEST_MAX_RATIO=INVEST_MAX_RATIO)
    return out


def reset_for_tests() -> None:
    with _lock:
        _profiles.clear()
    with _counts_lock:
        decision_counts.clear()
    ledger_reset()
    from . import calibration
    calibration.reset_for_tests()


# ------------------------------------------------- per-dispatch MFU ledger

#: achieved-work accounting per kernel family, recorded at every real
#: dispatch site; ``mfu.report()`` embeds a snapshot
kernel_ledger: dict = {}
_ledger_lock = threading.Lock()

_LEDGER_RAW = ("dispatches", "rows", "bytes", "flops", "seconds")
#: per-family strategy counts and the summed hash-table load factor, the
#: ``pipeline`` family's serial-equivalent stage seconds, and the
#: ``region`` family's fused operators, round trips saved and modelled
#: serial seconds
_LEDGER_STRATEGY = ("strategy_hash", "strategy_sort", "strategy_dense",
                    "lf_sum", "serial_s", "fused_ops", "rt_saved",
                    "fusion_serial_s")


def ledger_record(kind: str, *, rows: int = 0, nbytes: float = 0.0,
                  flops: float = 0.0, seconds: float = 0.0,
                  dispatches: int = 1, strategy: Optional[str] = None,
                  load_factor: Optional[float] = None,
                  serial_seconds: Optional[float] = None,
                  fused_ops: Optional[int] = None,
                  round_trips_saved: Optional[int] = None,
                  fusion_serial_seconds: Optional[float] = None) -> None:
    """Record one real dispatch's achieved work. ``seconds`` is the
    dispatch's device time where a drain timed it with CUDA events (the
    fused fragments), else its host wall to a host-visible result;
    ``nbytes`` / ``flops`` are the ``mfu`` models of the kernel that ran.
    The ``pipeline`` family (one record per fused-agg pipeline run) carries
    ``serial_seconds``, its slots' stage seconds as if run one after
    another, against ``seconds``, the pipeline's active wall: their ratio
    is ``overlap_x``.
    The ``region`` family (fusion regions) also carries ``fused_ops`` (the
    operators its program runs), ``round_trips_saved`` (host round trips
    the fusion removed against the per-operator chain) and
    ``fusion_serial_seconds`` (:func:`fusion_serial_estimate`), from which
    :func:`_derive` gives the ``fusion_x`` ratio. Feeds the calibration
    store (a no-op unless it is on).

    Also credits each field to the thread's attributed query
    (``observability.bump_plane``: the query's ``device kernels`` block)
    and, in a traced query, records one ``device:<kind>`` span with rows,
    bytes, flops, strategy, load factor, GB/s, ``roofline_pct`` and
    ``mfu_pct``. The span lasts ``seconds`` and ends now: for a dispatch
    timed by its host wall that is the wall up to its result (a join's
    ends at the ``.cpu()`` that synchronizes), not kernel time — the
    ``DAFT_TORCH_PROFILE_DIR`` capture gives kernel time."""
    fields = [("dispatches", dispatches), ("rows", rows),
              ("bytes", float(nbytes)), ("flops", float(flops)),
              ("seconds", float(seconds))]
    if strategy in ("hash", "sort", "dense"):
        fields.append((f"strategy_{strategy}", dispatches))
    if load_factor is not None:
        fields.append(("lf_sum", float(load_factor) * dispatches))
    if serial_seconds is not None:
        fields.append(("serial_s", float(serial_seconds)))
    if fused_ops is not None:
        fields.append(("fused_ops", int(fused_ops)))
    if round_trips_saved is not None:
        fields.append(("rt_saved", int(round_trips_saved)))
    if fusion_serial_seconds is not None:
        fields.append(("fusion_serial_s", float(fusion_serial_seconds)))
    with _ledger_lock:
        d = kernel_ledger.setdefault(
            kind, {k: 0 if k in ("dispatches", "rows") else 0.0
                   for k in _LEDGER_RAW})
        for f, v in fields:
            d[f] = d.get(f, 0) + v
    # outside the ledger lock: credit the thread-attributed query too
    # (concurrent queries must not read each other's dispatches out of
    # the shared ledger's diff)
    from .. import observability as obs
    for f, v in fields:
        if v:
            obs.bump_plane("device_kernels", f"{kind}\x00{f}", v)
    from . import calibration
    calibration.observe_dispatch(kind, strategy, rows=rows, nbytes=nbytes,
                                 seconds=seconds, dispatches=dispatches)
    # tracing plane: guard-checked, an untraced query builds nothing here
    from .. import tracing
    tctx = tracing.current()
    if tctx is not None:
        from .mfu import HBM_BPS, PEAK_FLOPS
        attrs = {"rows": int(rows), "bytes": int(nbytes),
                 "flops": int(flops)}
        if strategy:
            attrs["strategy"] = strategy
        if load_factor is not None:
            attrs["load_factor"] = round(float(load_factor), 3)
        if seconds > 0:
            attrs["gbps"] = round(nbytes / seconds / 1e9, 3)
            attrs["roofline_pct"] = round(
                100.0 * nbytes / seconds / HBM_BPS, 4)
            if flops:
                attrs["mfu_pct"] = round(
                    100.0 * flops / seconds / PEAK_FLOPS, 4)
        dur_us = int(seconds * 1e6)
        rec = tctx.recorder
        rec.add(f"device:{kind}", rec.unique_span_id(f"device:{kind}"),
                tctx.span_id, tracing._now_us() - dur_us, dur_us,
                attrs=attrs, lane="device")


def _derive(d: dict) -> dict:
    from .mfu import HBM_BPS, PEAK_FLOPS
    out = {k: v for k, v in d.items() if k not in _LEDGER_STRATEGY}
    s = d.get("seconds", 0.0)
    if s > 0 and d.get("bytes"):
        out["achieved_gbps"] = d["bytes"] / s / 1e9
        out["roofline_pct"] = 100.0 * d["bytes"] / s / HBM_BPS
    if s > 0 and d.get("flops"):
        out["achieved_tflops"] = d["flops"] / s / 1e12
        out["mfu_pct"] = 100.0 * d["flops"] / s / PEAK_FLOPS
    counts = {nm: int(d.get(f"strategy_{nm}", 0))
              for nm in ("hash", "sort", "dense")}
    ran = [nm for nm, c in counts.items() if c]
    if ran:
        out["strategy"] = ran[0] if len(ran) == 1 else "mixed"
        if len(ran) > 1:
            for nm in ran:
                out[f"strategy_{nm}"] = counts[nm]
    if counts["hash"] and d.get("lf_sum"):
        out["load_factor"] = d["lf_sum"] / counts["hash"]
    ser = d.get("serial_s", 0.0)
    if ser and s > 0:
        # serial-equivalent stage seconds against the pipelined wall:
        # above 1.0 the in-flight window hid host work behind the card's
        out["serial_equiv_s"] = ser
        out["overlap_x"] = ser / s
    if d.get("fused_ops"):
        out["fused_ops"] = int(d["fused_ops"])
    if d.get("rt_saved"):
        out["round_trips_saved"] = int(d["rt_saved"])
    fser = d.get("fusion_serial_s", 0.0)
    if fser and s > 0:
        # modelled per-operator serial seconds against the region's wall:
        # above 1.0, running the chain as one program beat dispatching it
        # an operator at a time
        out["fusion_serial_s"] = fser
        out["fusion_x"] = fser / s
    return out


def ledger_snapshot(raw: bool = False) -> dict:
    """Per-family sums; with derived GB/s and roofline / MFU percentages
    unless ``raw`` (raw snapshots are what :func:`ledger_delta` diffs)."""
    with _ledger_lock:
        snap = {k: dict(v) for k, v in kernel_ledger.items()}
    return snap if raw else {k: _derive(d) for k, d in snap.items()}


def ledger_delta(before: dict, after: dict) -> dict:
    """Derived ledger of the work between two raw snapshots."""
    out = {}
    for kind, d in after.items():
        b = before.get(kind, {})
        diff = {k: d.get(k, 0) - b.get(k, 0)
                for k in _LEDGER_RAW + _LEDGER_STRATEGY}
        if diff["dispatches"] > 0:
            out[kind] = _derive(diff)
    return out


def ledger_from_tallies(flat: dict) -> dict:
    """Derived per-family ledger from a query's attributed tally
    (``"<kind>\\x00<field>"`` keys, what :func:`ledger_record` bumps into
    a ``RuntimeStatsContext`` plane): :func:`ledger_delta`'s shape."""
    kinds: dict = {}
    for key, v in flat.items():
        kind, _, field = key.partition("\x00")
        if field not in _LEDGER_RAW + _LEDGER_STRATEGY:
            continue
        d = kinds.setdefault(
            kind, {k: 0 if k in ("dispatches", "rows") else 0.0
                   for k in _LEDGER_RAW})
        d[field] = int(v) if field in ("dispatches", "rows") else float(v)
    return {k: _derive(d) for k, d in kinds.items()
            if d["dispatches"] > 0}


def ledger_reset() -> None:
    with _ledger_lock:
        kernel_ledger.clear()


def _forced() -> Optional[bool]:
    v = knobs.env_raw("DAFT_TORCH_DEVICE_FORCE")
    if v is None:
        return None
    if v.lower() in ("1", "device", "on", "true"):
        return True
    if v.lower() in ("0", "host", "off", "false"):
        return False
    raise ValueError(f"DAFT_TORCH_DEVICE_FORCE={v!r}: expected 1/device "
                     "or 0/host")


# ------------------------------------------------------- decision logging

#: in-process decision counters {kind: {"device": n, "host": n}};
#: :func:`reset_for_tests` clears them
decision_counts: dict = {}
_counts_lock = threading.Lock()


def decision_counts_snapshot() -> dict:
    with _counts_lock:
        return {k: dict(v) for k, v in decision_counts.items()}


def reset_decision_counts() -> None:
    with _counts_lock:
        decision_counts.clear()


def _log(kind: str, device: bool, host_s: float, dev_s: float,
         **extras) -> None:
    """Record one decision: always in :data:`decision_counts`; also as one
    JSON line appended to ``DAFT_TORCH_DISPATCH_LOG`` when it names a file
    (under the counts lock, so concurrent executor threads never
    interleave partial lines)."""
    path = knobs.env_raw("DAFT_TORCH_DISPATCH_LOG")
    rec = None
    if path:
        rec = {"kind": kind, "device": bool(device), "host_s": host_s,
               "dev_s": dev_s}
        rec.update(extras)
        rec = json.dumps(rec) + "\n"
    with _counts_lock:
        d = decision_counts.setdefault(kind, {"device": 0, "host": 0})
        d["device" if device else "host"] += 1
        if rec is not None:
            # daft-lint: allow(blocking-under-lock) -- the serialization
            # IS the point: threads must not interleave partial lines;
            # a sub-ms local append
            with open(path, "a") as f:
                f.write(rec)


# ---------------------------------------------------------------- decisions

def row_output_op_wins(bytes_up: float, bytes_down: float,
                       round_trips: float = 2.0,
                       host_bytes: Optional[float] = None) -> bool:
    """Projection / predicate: the output is row-shaped; the host cost is
    a vector pass over the touched bytes. ``bytes_up`` is encoded (wire)
    bytes; ``host_bytes`` the Arrow bytes a host pass touches (defaults to
    ``bytes_up``)."""
    f = _forced()
    if f is not None:
        return f
    host_s = ((host_bytes if host_bytes is not None else bytes_up)
              + bytes_down) / HOST_VECTOR_BPS
    kernel_s = DEV_DISPATCH_S + (bytes_up + bytes_down) \
        / _cal("DEV_VECTOR_BPS", DEV_VECTOR_BPS)
    dev_s = link_profile().device_seconds(
        bytes_up, bytes_down, round_trips, kernel_s)
    _log("row_output", dev_s < host_s, host_s, dev_s,
         bytes_up=bytes_up, bytes_down=bytes_down)
    return dev_s < host_s


def argsort_wins(n_rows: int, key_bytes: float, n_keys: int) -> bool:
    f = _forced()
    if f is not None:
        return f
    host_s = n_rows * max(n_keys, 1) / HOST_SORT_ROWS_PER_S
    bytes_down = n_rows * 8  # the permutation
    kernel_s = DEV_DISPATCH_S + n_rows * max(n_keys, 1) \
        / _cal("DEV_SORT_ROWS_PER_S", DEV_SORT_ROWS_PER_S)
    dev_s = link_profile().device_seconds(key_bytes, bytes_down, 2.0,
                                          kernel_s)
    _log("argsort", dev_s < host_s, host_s, dev_s,
         n_rows=n_rows, key_bytes=key_bytes)
    return dev_s < host_s


def agg_upload_wins(bytes_up: float, bytes_down: float,
                    cacheable: bool, round_trips: float = 2.0,
                    host_bytes: Optional[float] = None,
                    strategy: str = "sort", window: int = 1,
                    host_rescan_bytes: float = 0.0,
                    kind: str = "agg_upload") -> bool:
    """An aggregation whose inputs are not on the device yet. ``bytes_up``
    is the wire cost (encoded bytes), ``host_bytes`` what a host pass
    touches (Arrow bytes; defaults to ``bytes_up``).

    A cacheable upload (a scan task whose working set fits the device
    column cache) is an investment the cache repays on every later run:
    it wins when a resident run (no upload) beats the host pass and the
    fill costs at most ``INVEST_MAX_RATIO`` host passes
    (``DAFT_TORCH_CACHE_INVEST=0``: it must beat the host outright). A
    non-cacheable upload must beat a host pass at ``HOST_AGG_BPS``. The
    kernel term follows the strategy the dispatch would take; with the
    pipeline on (``window`` ≥ 2) the transfer is priced at its
    steady-state overlap.

    ``host_rescan_bytes`` is one of the port's two pricing terms the
    reference lacks (ROADMAP B0b; the other is :func:`fusion_wins`'
    join_agg alternative): the bytes a later host run of a cacheable task
    reads and decodes again (its file's uncompressed columns), which a
    resident device run skips. The investment's host side adds them at
    ``HOST_AGG_BPS``; at 0 (the default) the rule is the reference's.
    Without it a scan task whose pushdown filter leaves few rows (TPC-H
    Q6) prices only its small aggregation against the fill and is never
    cached. ``kind`` names the decision in :data:`decision_counts` and
    the log (``<kind>_invest`` for an investment)."""
    f = _forced()
    if f is not None:
        return f
    lp = link_profile()
    host_s = (host_bytes if host_bytes is not None else bytes_up) \
        / HOST_AGG_BPS
    bps = _cal("DEV_AGG_HASH_BPS", DEV_AGG_HASH_BPS) if strategy == "hash" \
        else _cal("DEV_AGG_DENSE_BPS", DEV_AGG_DENSE_BPS) \
        if strategy == "dense" else _cal("DEV_AGG_BPS", DEV_AGG_BPS)
    kernel_s = DEV_DISPATCH_S + bytes_up / bps
    price = lp.pipelined_seconds if window >= 2 else lp.device_seconds
    dev_s = price(bytes_up, bytes_down, round_trips, kernel_s)
    if cacheable and knobs.env_bool("DAFT_TORCH_CACHE_INVEST"):
        host_s += host_rescan_bytes / HOST_AGG_BPS
        resident_s = price(0.0, bytes_down, round_trips, kernel_s)
        win = resident_s < host_s and dev_s < INVEST_MAX_RATIO * host_s
        _log(kind + "_invest", win, host_s, dev_s,
             resident_s=resident_s, bytes_up=bytes_up,
             bytes_down=bytes_down, round_trips=round_trips,
             host_rescan_bytes=host_rescan_bytes, strategy=strategy)
        return win
    _log(kind, dev_s < host_s, host_s, dev_s,
         bytes_up=bytes_up, bytes_down=bytes_down, round_trips=round_trips,
         strategy=strategy)
    return dev_s < host_s


def _join_seconds(n_left: int, n_right: int, bytes_up: float,
                  bytes_down: float, window: int = 1) -> Tuple[float, float]:
    """The host's and the card's modelled seconds of one join's index
    generation (:func:`join_wins`' two sides)."""
    n = n_left + n_right
    rate = _cal("DEV_JOIN_HASH_ROWS_PER_S", DEV_JOIN_HASH_ROWS_PER_S) \
        if _join_strategy(n_left, n_right) == "hash" \
        else _cal("DEV_JOIN_ROWS_PER_S", DEV_JOIN_ROWS_PER_S)
    lp = link_profile()
    price = lp.pipelined_seconds if window >= 2 else lp.device_seconds
    return n / HOST_JOIN_ROWS_PER_S, price(bytes_up, bytes_down, 2.0,
                                           DEV_DISPATCH_S + n / rate)


# ------------------------------------------ shuffle and mesh exchange
#
# The distributed tier's gates (reference ``costmodel.py:768-989``). The
# host-side rates are the reference's coarse constants (Arrow IPC and a
# host hash-partition pass on its host CPU): the decisions only need the
# ratio between one agg pass and a row's whole shuffle trip to the right
# order of magnitude. The mesh's own rate is measured here.

SHUFFLE_SER_BPS = 2.0e9   # Arrow IPC write/read, per side, per byte


def shuffle_wire_bps() -> float:
    """Wire bandwidth the shuffle and exchange decisions price against:
    ``DAFT_TORCH_SHUFFLE_WIRE_MBPS`` when set, else the calibrated rate
    (observed at every sizable shuffle fetch) once its sample floor is
    met, else the knob's default."""
    if knobs.env_raw("DAFT_TORCH_SHUFFLE_WIRE_MBPS") is not None:
        return knobs.env_float("DAFT_TORCH_SHUFFLE_WIRE_MBPS") * 1e6
    return _cal("SHUFFLE_WIRE_BPS",
                knobs.env_float("DAFT_TORCH_SHUFFLE_WIRE_MBPS") * 1e6)


#: collective dispatch when the probe cannot measure it: the program's
#: fixed cost (its per-shard sorts, scatters and copies), in seconds
MESH_DISPATCH_S = 3e-3
HOST_EXCHANGE_BPS = 6.0e8  # host hash-partition pass (hash + scatter)
_ICI_FALLBACK_BPS = 2.0e9  # no mesh to probe and nothing calibrated
#: per-shard probe rows (int64 planes) by device type: on a card the
#: program's fixed cost (its kernel launches) hides a small probe's bytes
_ICI_PROBE_ROWS = {"cuda": 1 << 19, "cpu": 1 << 14}
_ICI_PROBE_REPS = 3        # timed runs per probe size (the fastest kept)

_ici_lock = threading.Lock()
_ici: Optional[Tuple[float, float]] = None   # (bytes/s, dispatch s)


def _measure_ici() -> Tuple[float, float]:
    """The mesh exchange's marginal rate and fixed cost, measured on this
    machine: two warm timed ``sharded_hash_repartition`` probes (the very
    program the mesh paths dispatch: it copies every row between the
    shards' tensors, within one card's memory when the shards share it)
    at 1x and 4x the probe size, each the fastest of
    ``_ICI_PROBE_REPS`` warm runs. The rate comes from the byte and time
    differences and the fixed cost from the intercept, so dispatch
    overhead does not read as a slow link. → (bytes/s, seconds)."""
    import numpy as np
    import torch

    from ..parallel import exchange, mesh as pmesh
    mesh = pmesh.get_mesh()
    if mesh is None or mesh.size < 2:
        raise RuntimeError("no multi-shard mesh to measure")
    n = mesh.size

    def sync():
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def timed(rows_per_shard: int):
        total = n * rows_per_shard
        plane = np.arange(total, dtype=np.int64)
        valid = np.ones(total, dtype=bool)
        pid = (np.arange(total) % n).astype(np.int32)
        sb = [exchange.shard_blocks(mesh, a)
              for a in (plane, valid, valid, pid)]
        sync()

        def run():
            exchange.sharded_hash_repartition(mesh, (sb[0],), (sb[1],),
                                              sb[2], sb[3])
            sync()

        run()  # warm-up: allocator and first-call costs paid here
        best = float("inf")
        for _ in range(_ICI_PROBE_REPS):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        # exchanged payload: value plane + valid + row mask + pid
        return best, total * (8 + 1 + 1 + 4)

    rows = _ICI_PROBE_ROWS.get(mesh.devices[0].type, 1 << 14)
    t1, b1 = timed(rows)
    t2, b2 = timed(4 * rows)
    if t2 > t1:
        rate = (b2 - b1) / (t2 - t1)
        return rate, max(t1 - b1 / rate, 0.0)
    return b2 / max(t2, 1e-7), MESH_DISPATCH_S


def _ici_profile() -> Tuple[float, float]:
    global _ici
    if _ici is not None:
        return _ici
    measured = None
    with _ici_lock:
        if _ici is not None:
            return _ici
        env = knobs.env_opt_float("DAFT_TORCH_ICI_MBPS")
        if env is not None:
            _ici = (env * 1e6, MESH_DISPATCH_S)
            return _ici
        try:
            # daft-lint: allow(blocking-under-lock) -- intentional: one
            # measurement per process; concurrent deciders wait for it
            # instead of racing duplicate mesh probes
            measured = _measure_ici()
            _ici = measured
        except RuntimeError:
            # no mesh in this process: the calibrated (cross-process)
            # rate beats the fallback once it has samples
            _ici = (_cal("ICI_BPS", _ICI_FALLBACK_BPS), MESH_DISPATCH_S)
    if measured is not None:
        # fold only a real measurement into the persisted profile
        from . import calibration
        calibration.observe("ICI_BPS", measured[0])
    return _ici


def ici_bps() -> float:
    """The measured (or overridden) mesh exchange rate, bytes/s: the
    reference's ICI link, here a copy between shards' tensors."""
    return _ici_profile()[0]


def mesh_dispatch_s() -> float:
    """The mesh exchange's measured fixed cost per dispatch, seconds."""
    return _ici_profile()[1]


def reset_ici_for_tests() -> None:
    global _ici
    with _ici_lock:
        _ici = None


def mesh_exchange_wins(rows: Optional[int], row_bytes: float = 32.0,
                       n_shards: int = 2) -> bool:
    """Admission for a local mesh collective (``DeviceExchangeAgg``, the
    mesh hash repartition): the collective's dispatch plus its bytes over
    the measured rate, against one host hash-partition pass over the same
    bytes. Unknown ``rows`` accepts (the structural gates already vetted
    the plan). ``DAFT_TORCH_MESH_MIN_ROWS`` overrides this in
    ``parallel/mesh.py``. Logged under ``mesh_exchange``."""
    if rows is None:
        return True
    if rows <= 0:
        return False
    nbytes = rows * max(row_bytes, 1.0)
    host_s = nbytes / HOST_EXCHANGE_BPS
    dev_s = mesh_dispatch_s() + nbytes / ici_bps()
    _log("mesh_exchange", dev_s < host_s, host_s, dev_s,
         rows=rows, row_bytes=row_bytes, n_shards=n_shards)
    return dev_s < host_s


def exchange_collective_wins(rows: Optional[int],
                             row_bytes: float = 32.0) -> bool:
    """A distributed hash boundary's collective path against the Flight
    wire: one mesh dispatch plus the bytes over the mesh rate, against
    IPC serialize + wire + deserialize per byte. With no cardinality
    evidence the collective wins (``mesh.mesh_admits`` re-checks with
    exact rows before dispatching). Logged under ``exchange_path``
    ("device" = the collective family)."""
    if not rows:
        _log("exchange_path", True, 0.0, 0.0, rows=rows or 0)
        return True
    nbytes = rows * max(row_bytes, 1.0)
    wire_s = nbytes * (2.0 / SHUFFLE_SER_BPS + 1.0 / shuffle_wire_bps())
    coll_s = mesh_dispatch_s() + nbytes / ici_bps()
    _log("exchange_path", coll_s < wire_s, wire_s, coll_s,
         rows=rows, row_bytes=row_bytes)
    return coll_s < wire_s


def shuffle_combine_wins(rows: Optional[int], groups: Optional[int],
                         num_partitions: int, n_cols: int = 4,
                         bytes_per_col: float = 8.0,
                         exact_groups: bool = False) -> bool:
    """The map-side shuffle combine for a hash boundary feeding a
    decomposable grouped aggregation: one extra grouped-agg pass over the
    map output against the whole shuffle trip (IPC serialize, wire,
    deserialize, reduce-side agg) of every row it eliminates (at most
    ``groups x num_partitions`` states survive). Near-unique keys decline,
    reductive group-bys accept; with no cardinality evidence it accepts.
    Footer NDV (not ``exact_groups``) is damped by the calibrated
    actual/footer ratio. Logged under ``shuffle_combine`` ("device" =
    combine applied)."""
    row_bytes = max(n_cols, 1) * bytes_per_col
    if not rows or not groups:
        _log("shuffle_combine", True, 0.0, 0.0, rows=rows or 0,
             groups=groups or 0, num_partitions=num_partitions)
        return True
    if not exact_groups:
        from . import calibration
        groups = max(groups * calibration.ndv_ratio(), 1.0)
    groups_out = min(rows, groups * max(num_partitions, 1))
    saved_rows = max(rows - groups_out, 0)
    per_byte_trip = (2.0 / SHUFFLE_SER_BPS + 1.0 / shuffle_wire_bps()
                     + 1.0 / HOST_AGG_BPS)
    saved_s = saved_rows * row_bytes * per_byte_trip
    extra_s = rows * row_bytes / HOST_AGG_BPS
    _log("shuffle_combine", saved_s > extra_s, extra_s, saved_s,
         rows=rows, groups=groups, num_partitions=num_partitions)
    return saved_s > extra_s


def combine_wins_pure(rows: Optional[int], groups: Optional[int],
                      num_partitions: int, n_cols: int = 4,
                      bytes_per_col: float = 8.0) -> bool:
    """:func:`shuffle_combine_wins` without damping, logging or side
    effects: the runtime re-planner compares its evidence-priced decision
    against this to count ``combine_flips``."""
    if not rows or not groups:
        return True
    row_bytes = max(n_cols, 1) * bytes_per_col
    groups_out = min(rows, groups * max(num_partitions, 1))
    saved_rows = max(rows - groups_out, 0)
    per_byte_trip = (2.0 / SHUFFLE_SER_BPS + 1.0 / shuffle_wire_bps()
                     + 1.0 / HOST_AGG_BPS)
    return saved_rows * row_bytes * per_byte_trip \
        > rows * row_bytes / HOST_AGG_BPS


# --------------------------------------------- out-of-core spill pricing

#: the spill tier's Arrow IPC rate, per logical byte per direction
#: (``SpillBuffer`` write and read of one spilled 2^22-row batch, lz4;
#: ``calibrate --only spill_disk --rows 4194304`` on the H100 machine,
#: NVIDIA H100 80GB HBM3 at 700.00 W, its host's disk)
SPILL_DISK_BPS = 1.202e9


def spill_plan_wins(nbytes: float, resident_budget: float) -> bool:
    """Price a spill-partitioned plan (the grace join's pairwise phase)
    against the in-memory single-unit plan for ``nbytes`` of materialized
    input with ``resident_budget`` bytes allowed resident (reference
    ``costmodel.py:1000``).

    Past the resident budget the in-memory plan is infeasible (an OOM
    has infinite cost) and the partitioned plan wins outright; under it
    the partitioned plan would spill nothing but still forfeit the
    whole-input pass, so the in-memory plan wins. Under governor pressure
    the budget halves (``governor.budget_scale``). Logged under
    ``spill_plan`` ("device" = the partitioned plan)."""
    from ..execution import governor
    scale = governor.budget_scale()
    if scale != 1.0:
        resident_budget = resident_budget * scale
    agg_s = nbytes / HOST_AGG_BPS
    if nbytes > resident_budget:
        part_s = agg_s + 2.0 * (nbytes - resident_budget) \
            / _cal("SPILL_DISK_BPS", SPILL_DISK_BPS)
        _log("spill_plan", True, 1e12, part_s,
             nbytes=nbytes, budget=resident_budget)
        return True
    _log("spill_plan", False, agg_s, agg_s,
         nbytes=nbytes, budget=resident_budget)
    return False


def join_wins(n_left: int, n_right: int, bytes_up: float,
              bytes_down: float, window: int = 1) -> bool:
    """An equi-join's index generation on the device (hash build and probe
    when :func:`_join_strategy` picks it, else the torch sort join) against
    the host's: one upload of both sides' codes, one dispatch, one fetch
    of the pairs."""
    f = _forced()
    if f is not None:
        return f
    host_s, dev_s = _join_seconds(n_left, n_right, bytes_up, bytes_down,
                                  window)
    _log("join", dev_s < host_s, host_s, dev_s,
         n_left=n_left, n_right=n_right, bytes_up=bytes_up)
    return dev_s < host_s


def fusion_serial_estimate(rows: int, n_ops: int) -> float:
    """Modelled wall of the per-operator chain a fusion region replaced:
    each of the ``n_ops`` operators would pay its own dispatch, transfer
    legs and round trips. Recorded per region dispatch into the ledger's
    ``region`` family, where :func:`_derive` turns it into ``fusion_x``."""
    lp = link_profile()
    b = max(rows, 1) * 8.0
    per_op = lp.device_seconds(
        b, b, 2.0,
        DEV_DISPATCH_S + b / _cal("DEV_VECTOR_BPS", DEV_VECTOR_BPS))
    return max(n_ops, 1) * per_op


def fusion_wins(shape: str, rows: int, bytes_up: float, bytes_down: float,
                n_ops: int, host_bytes: Optional[float] = None,
                window: int = 1, build_rows: int = 0) -> bool:
    """Admission of one fusion-region morsel: the one fused dispatch (one
    upload, one program, one packed fetch) against the chain a declined
    morsel runs instead. A chain is ``n_ops`` vectorized host passes, a
    topk adds the host sort. A join_agg morsel declined runs the
    per-operator chain: the join's index generation where
    :func:`join_wins` would put it (the card or the host, whichever it
    prices cheaper; on the host under the join's row floor), then the
    host agg pass; the fused program is priced with its own measured
    constants (``DEV_REGION_*``), not the hash kernels'.
    ``DAFT_TORCH_FUSION=1`` skips this gate (the executor admits every
    morsel); ``auto`` calls it per morsel. Logged as ``fusion``."""
    f = _forced()
    if f is not None:
        return f
    lp = link_profile()
    price = lp.pipelined_seconds if window >= 2 else lp.device_seconds
    hb = host_bytes if host_bytes is not None else bytes_up
    if shape == "join_agg":
        from ..joins import DEVICE_MIN_ROWS
        join_host_s, join_dev_s = _join_seconds(
            rows, build_rows, (rows + build_rows) * 9.0,
            16.0 * max(rows, build_rows), window)
        if rows + build_rows < DEVICE_MIN_ROWS:
            join_dev_s = join_host_s
        host_s = min(join_host_s, join_dev_s) + hb / HOST_AGG_BPS
        kernel_s = DEV_REGION_DISPATCH_S \
            + rows / DEV_REGION_JOIN_AGG_ROWS_PER_S
    elif shape == "topk":
        host_s = hb / HOST_VECTOR_BPS * max(n_ops - 1, 1) \
            + rows / HOST_SORT_ROWS_PER_S
        kernel_s = DEV_DISPATCH_S \
            + rows / _cal("DEV_SORT_ROWS_PER_S", DEV_SORT_ROWS_PER_S) \
            + bytes_up / _cal("DEV_VECTOR_BPS", DEV_VECTOR_BPS)
    else:
        host_s = hb / HOST_VECTOR_BPS * max(n_ops, 1)
        kernel_s = DEV_DISPATCH_S \
            + bytes_up / _cal("DEV_VECTOR_BPS", DEV_VECTOR_BPS)
    dev_s = price(bytes_up, bytes_down, 2.0, kernel_s)
    _log("fusion", dev_s < host_s, host_s, dev_s,
         shape=shape, rows=rows, n_ops=n_ops, build_rows=build_rows)
    return dev_s < host_s


# ------------------------------------------------------- kernel strategy

def _hash_capable_backend(device=None) -> bool:
    """The hash kernels are compiled for a card; on CPU tensors their
    plain versions stand in for parity, not speed, so ``auto`` keeps the
    torch sort path there (the reference's rule)."""
    from . import backend
    return backend.is_accelerator(device)


def _join_strategy(n_left: int, n_right: int, device=None) -> str:
    """Hash or sort for the device join, without logging (``join_wins``
    prices with it; :func:`join_strategy` is the logged decision the
    dispatch acts on). ``DAFT_TORCH_KERNEL_JOIN`` forces one; on a card
    ``auto`` is hash. The reference also declines hash past
    ``max_table_slots`` because its table and output planes must fit the
    TPU's on-chip memory; the H100's build table and probe output live in
    device memory (``join_kernels``: T = ``join_table_capacity``, twice
    the build bucket), so the port's join has no slot ceiling."""
    forced = knobs.env_str("DAFT_TORCH_KERNEL_JOIN").lower()
    if forced in ("hash", "sort"):
        return forced
    if forced != "auto":
        raise ValueError(f"DAFT_TORCH_KERNEL_JOIN={forced!r}: expected "
                         "auto, hash or sort")
    return "hash" if _hash_capable_backend(device) else "sort"


def join_strategy(n_left: int, n_right: int, device=None) -> str:
    """The join strategy of this dispatch, logged (``join_strategy`` in
    decision_counts; "device" = hash)."""
    s = _join_strategy(n_left, n_right, device)
    _log("join_strategy", s == "hash", 0.0, 0.0,
         n_left=n_left, n_right=n_right, strategy=s)
    return s


def forced_groupby() -> str:
    """``DAFT_TORCH_KERNEL_GROUPBY``: ``auto``, or a forced ``dense`` /
    ``hash`` / ``sort``."""
    forced = knobs.env_str("DAFT_TORCH_KERNEL_GROUPBY").lower()
    if forced not in ("auto", "dense", "hash", "sort"):
        raise ValueError(f"DAFT_TORCH_KERNEL_GROUPBY={forced!r}")
    return forced


def groupby_strategy(rows: int, groups: Optional[float], key_dtypes,
                     out_cap: int, log: bool = True,
                     device=None) -> Tuple[str, float]:
    """Hash or sort for one grouped-agg dispatch → ``(strategy,
    est_load_factor)``. ``log=False`` for pricing-only asks (the upload
    gates), so decision_counts tallies dispatches, not estimates.

    Evidence, best first: the footer NDV (``groups``, damped by the
    calibrated actual/footer ratio), else the group budget ``out_cap``.
    Sort when the key set packs wider than the hash key budget
    (``hash_kernels.hash_pack_words``), when the table passes
    ``DAFT_TORCH_KERNEL_MAX_TABLE`` slots, when footer evidence shows
    near-unique keys (``DAFT_TORCH_KERNEL_HASH_NDV_FRAC``), when the
    device is not a card, or when the sort model moves fewer bytes.
    ``DAFT_TORCH_KERNEL_GROUPBY=hash|sort`` forces one (hash still needs a
    packable key set); ``dense`` is the fragments' own first choice and
    leaves this one to the rule."""
    from . import calibration, hash_kernels as hk, mfu
    words = hk.hash_pack_words(key_dtypes) if key_dtypes else None
    table = hk.table_capacity(max(out_cap, 1))
    ndv = max(groups * calibration.ndv_ratio(), 1.0) if groups \
        else float(out_cap)
    lf = min(ndv / table, 1.0)
    forced = forced_groupby()
    if forced == "sort" or words is None:
        s = "sort"
    elif forced == "hash":
        s = "hash"
    elif not _hash_capable_backend(device):
        s = "sort"
    elif table > hk.max_table_slots():
        s = "sort"
    elif groups and rows > 0 and ndv / rows > knobs.env_float(
            "DAFT_TORCH_KERNEL_HASH_NDV_FRAC"):
        s = "sort"
    else:
        sort_bytes = mfu.grouped_agg_models(
            rows, out_cap, max(len(key_dtypes), 1), 1)[1]
        hash_bytes = mfu.hash_agg_models(rows, out_cap, table, words, 1)[1]
        s = "hash" if hash_bytes < sort_bytes else "sort"
    if log:
        log_strategy_decision("groupby_strategy", s, rows=rows,
                              groups=float(ndv), out_cap=out_cap,
                              load_factor=lf)
    return s, lf


def log_strategy_decision(kind: str, strategy: str, **extras) -> None:
    """Tally a kernel-strategy decision that was acted on: the dispatch
    sites call this once the strategy really ran."""
    _log(kind, strategy == "hash", 0.0, 0.0, strategy=strategy, **extras)
