"""Async device pipeline: overlap host encode and decode with device
compute, with a bounded window of in-flight slots.

The torch rewrite of ``daft_tpu/device/pipeline.py``:

- **a bounded in-flight window** (``DAFT_TORCH_DEVICE_INFLIGHT``, else
  ``ExecutionConfig.device_inflight``, default 2) driven by
  :func:`run_pipelined`: item N+1's encode and dispatch run on a
  dedicated submit pool while item N computes on the card and item N-1
  downloads and decodes on the consumer thread. Each slot is admitted for
  its footprint on submit (:func:`acquire_slot`) and released when it
  drains (:func:`release_slot`), on every path, exception edges and an
  early close included. 0 keeps the synchronous path.
- **the residency registry** (:func:`note_decoded` /
  :func:`resident_planes`): a decoded device column's planes stay alive
  (LRU, keyed weakly by the host Series, 1/8 of the device cache's
  budget) so that a later encode of the same Series reuses them instead
  of copying it to the card again.

Each drained slot's stages are timing counters (:func:`counters_snapshot`)
and, in a traced query, ``device:upload`` / ``device:compute`` /
``device:download`` spans on the ``dev:*`` lanes, cut from the same clock
reads (no synchronize, no event wait of their own). The submit bodies run
with the consumer's stats attribution and span context. The chaos
serialization and fault plans of the reference are not ported: window 0
is the synchronous path.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, Optional

import torch

from .. import knobs

_MAX_WINDOW = 64


def inflight_window() -> int:
    """In-flight device slots: ``DAFT_TORCH_DEVICE_INFLIGHT`` when set,
    else ``ExecutionConfig.device_inflight``; 0 = the synchronous path."""
    raw = knobs.env_str("DAFT_TORCH_DEVICE_INFLIGHT")
    if raw:
        w = int(raw)
    else:
        from ..context import get_context
        w = int(get_context().execution_config.device_inflight)
    return max(0, min(w, _MAX_WINDOW))


# ------------------------------------------------------------- submit pool

_PIPE_POOL: Optional[cf.ThreadPoolExecutor] = None
_pipe_lock = threading.Lock()


def _pipe_pool() -> cf.ThreadPoolExecutor:
    """The submit bodies' own pool, not the executor's: a submit blocked
    on the window gate or on admission must never hold a thread that a
    nested load needs."""
    global _PIPE_POOL
    if _PIPE_POOL is not None:
        return _PIPE_POOL
    with _pipe_lock:
        if _PIPE_POOL is None:
            _PIPE_POOL = cf.ThreadPoolExecutor(
                max_workers=max(os.cpu_count() or 4, 4),
                thread_name_prefix="daft-torch-devpipe")
        return _PIPE_POOL


# -------------------------------------------------------- in-flight slots

class PipelineAborted(Exception):
    """The consumer tore the pipeline down while this slot waited."""


class WindowGate:
    """Window admission: a submit may take a slot while fewer than
    ``window`` are live, or when it owns the oldest undrained sequence
    number (the head of line is always admitted, so pool workers running
    out of order never deadlock the consumer, which drains in order).
    ``is_set`` makes the gate a cancel signal for
    ``MemoryManager.try_acquire``."""

    def __init__(self, window: int):
        self.window = max(int(window), 1)
        self._cond = threading.Condition()
        self._live = 0
        self._drained = 0          # next sequence the consumer drains
        self._aborted = False
        #: most slots live at once (the overlap the window reached)
        self.peak = 0

    def is_set(self) -> bool:
        return self._aborted

    def acquire(self, seq: int) -> None:
        with self._cond:
            while (self._live >= self.window and seq > self._drained
                   and not self._aborted):
                self._cond.wait(0.1)
            if self._aborted:
                raise PipelineAborted()
            self._live += 1
            self.peak = max(self.peak, self._live)

    def note_drained(self, seq: int) -> None:
        with self._cond:
            self._drained = max(self._drained, seq + 1)
            self._cond.notify_all()

    def slot_released(self) -> None:
        with self._cond:
            self._live = max(self._live - 1, 0)
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


class Slot:
    """One admitted in-flight slot: window occupancy plus the admitted
    bytes. Made only by :func:`acquire_slot`, ended only by
    :func:`release_slot`."""

    __slots__ = ("gate", "mem", "nbytes", "released", "seq")

    def __init__(self, gate: WindowGate, mem, nbytes: int, seq: int):
        self.gate = gate
        self.mem = mem
        self.nbytes = int(nbytes)
        self.seq = seq
        self.released = False


#: bound on a slot's wait for memory admission. Slots hold their bytes
#: from submit to drain, and submits run out of order on the pool: an
#: unbounded wait could deadlock against bytes a later slot holds. On
#: timeout the slot proceeds unadmitted (footprint 0) and is counted.
_ADMIT_DEADLINE_S = 5.0


def acquire_slot(gate: WindowGate, seq: int, mem=None,
                 nbytes: int = 0) -> Slot:
    """Admit one in-flight slot: the window gate first, then ``nbytes``
    of ``mem``. The caller owns the Slot and must :func:`release_slot`
    it on every path."""
    gate.acquire(seq)
    if mem is not None and nbytes > 0:
        if not mem.try_acquire(
                nbytes, deadline=time.monotonic() + _ADMIT_DEADLINE_S,
                cancel=gate):
            if gate.is_set():
                gate.slot_released()
                raise PipelineAborted()
            _count("admission_timeouts")
            nbytes = 0
    _count("slots_acquired")
    return Slot(gate, mem, nbytes if mem is not None else 0, seq)


def release_slot(slot: Optional[Slot]) -> None:
    """Release a slot's bytes and window occupancy. Idempotent."""
    if slot is None or slot.released:
        return
    slot.released = True
    if slot.mem is not None and slot.nbytes > 0:
        slot.mem.release(slot.nbytes)
    slot.gate.slot_released()
    _count("slots_released")


# ------------------------------------------------------------- counters

_counters_lock = threading.Lock()
_counters: Dict[str, float] = {}


def _count(key: str, v: float = 1) -> None:
    with _counters_lock:
        _counters[key] = _counters.get(key, 0) + v


def _peak(key: str, v: float) -> None:
    with _counters_lock:
        _counters[key] = max(_counters.get(key, 0), v)


def counters_snapshot() -> Dict[str, float]:
    """``runs`` / ``slots`` (drained device slots), ``slots_acquired`` /
    ``slots_released``, ``peak_inflight``, ``admission_timeouts``,
    ``serial_equiv_s`` (the slots' submit plus drain seconds, as if run
    one after another) against ``wall_s`` (the pipeline's active wall),
    and the stage seconds ``upload_s`` (submit: encode, copy, dispatch),
    ``compute_s`` (dispatch end to drain start) and ``download_s``
    (drain: wait, fetch, decode)."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


class InflightItem:
    """A submit's in-flight device work: its Slot, an opaque token for
    the drain, the submit stage's seconds and when the dispatch ended.
    A submit that routes its item to the host returns a plain value
    instead: only InflightItems count against the window."""

    __slots__ = ("slot", "token", "sub_s", "t_dispatched")

    def __init__(self, slot: Optional[Slot], token, sub_s: float = 0.0):
        self.slot = slot
        self.token = token
        self.sub_s = sub_s
        self.t_dispatched = time.perf_counter()


def run_pipelined(items: Iterator, submit: Callable, drain: Callable, *,
                  window: int, width: Optional[int] = None) -> Iterator:
    """Drive the bounded-window pipeline.

    ``submit(item, seq, gate) -> InflightItem | host result`` runs on the
    submit pool: encode and dispatch, holding a Slot from
    ``acquire_slot(gate, seq, ...)`` for device work, or any plain value
    for an item routed to the host (it never touches the window).
    ``drain(ret, seq) -> result`` runs on the consumer thread: one fetch
    and the decode for an InflightItem, a pass-through for a host value.
    Results come in submission order. Teardown (an exception, an early
    close) aborts the gate, waits out the submits in flight and releases
    every undrained slot."""
    from .. import observability as obs
    from .. import tracing
    gate = WindowGate(window)
    pool = _pipe_pool()
    pending: collections.deque = collections.deque()   # (future, seq)
    it = iter(items)
    seq_next = [0]
    # the active wall only: not the stretches spent suspended at `yield`
    # while downstream operators run
    active_s = [0.0]
    serial_s = [0.0]
    slots_run = [0]
    if width is None:
        width = max(os.cpu_count() or 4, 4) * 2
    width = max(width, window + 1)
    # device submits past the window block in gate.acquire holding a pool
    # thread: start at window + 2 futures and widen only as host-routed
    # results show the stream does not hold slots
    cap = [min(width, window + 2)]

    def _enqueue() -> bool:
        try:
            item = next(it)
        except StopIteration:
            return False
        seq = seq_next[0]
        seq_next[0] += 1
        pending.append((pool.submit(obs.run_attributed,
                                    obs.current_attribution(), submit,
                                    item, seq, gate), seq))
        return True

    def _fill() -> None:
        while len(pending) < cap[0] and _enqueue():
            pass

    t_resume = time.perf_counter()
    try:
        _fill()
        while pending:
            fut, seq = pending.popleft()
            try:
                ret = fut.result()
            except PipelineAborted:
                gate.note_drained(seq)
                continue
            slot = ret.slot if isinstance(ret, InflightItem) else None
            try:
                t0 = time.perf_counter()
                traced = isinstance(ret, InflightItem) \
                    and tracing.current() is not None
                if traced:
                    # a live span: the kernel ledger's records made in the
                    # drain nest under it
                    with tracing.span("device:download",
                                      key=f"devpipe.down.{seq}",
                                      attrs={"slot": seq % max(window, 1),
                                             "seq": seq},
                                      lane="dev:download"):
                        result = drain(ret, seq)
                else:
                    result = drain(ret, seq)
                if isinstance(ret, InflightItem):
                    t1 = time.perf_counter()
                    serial_s[0] += ret.sub_s + (t1 - t0)
                    slots_run[0] += 1
                    _count("upload_s", ret.sub_s)
                    _count("compute_s", max(t0 - ret.t_dispatched, 0.0))
                    _count("download_s", t1 - t0)
                    if traced:
                        _slot_spans(ret, seq, window, t0)
                else:
                    cap[0] = min(width, cap[0] * 2)
            finally:
                release_slot(slot)
                gate.note_drained(seq)
            active_s[0] += time.perf_counter() - t_resume
            yield result
            t_resume = time.perf_counter()
            _fill()
    finally:
        active_s[0] += time.perf_counter() - t_resume
        gate.abort()
        for fut, seq in pending:
            if fut.cancel():
                continue
            try:
                ret = fut.result()
            except Exception:
                continue   # the submit released its own slot
            if isinstance(ret, InflightItem):
                release_slot(ret.slot)
        _peak("peak_inflight", gate.peak)
        if slots_run[0] > 0:
            _count("slots", slots_run[0])
            _count("runs")
            _count("serial_equiv_s", serial_s[0])
            _count("wall_s", active_s[0])
            # the ledger's overlap evidence: serial-equivalent stage
            # seconds against the pipeline's active wall
            from . import costmodel
            costmodel.ledger_record("pipeline", dispatches=slots_run[0],
                                    seconds=active_s[0],
                                    serial_seconds=serial_s[0])


def _slot_spans(ret: InflightItem, seq: int, window: int,
                t0: float) -> None:
    """A drained slot's ``device:upload`` (the submit: encode, copy,
    dispatch) and ``device:compute`` (dispatch end to drain start) spans,
    cut from the clock reads the stage counters took (the drain's
    ``device:download`` is a live span around it); keys follow the morsel
    sequence, so the ids replay."""
    from .. import observability as obs
    from .. import tracing
    ctx = tracing.current()
    rec = ctx.recorder
    # the upload ran on the submit pool under the query's own context
    # (the root), the compute and the download under this thread's
    attr = obs.current_attribution()
    up_parent = attr.trace_ctx.span_id \
        if attr is not None and attr.trace_ctx is not None else ctx.span_id
    # perf_counter instants onto the trace's wall clock
    now_us = tracing._now_us()
    now_pc = time.perf_counter()

    def us(t: float) -> int:
        return now_us - int((now_pc - t) * 1e6)

    attrs = {"slot": seq % max(window, 1), "seq": seq}
    for name, key, lane, parent, a, b in (
            ("device:upload", "up", "dev:upload", up_parent,
             ret.t_dispatched - ret.sub_s, ret.t_dispatched),
            ("device:compute", "comp", "dev:compute", ctx.span_id,
             ret.t_dispatched, t0)):
        rec.add(name, rec.unique_span_id(f"devpipe.{key}.{seq}"),
                parent, us(a), max(us(b) - us(a), 0),
                attrs=dict(attrs), lane=lane)


# ------------------------------------------- device-resident hand-off

# RLock: the weakref reaper (_drop) can fire from GC while this thread
# already holds the lock (an eviction drops the last strong reference)
_res_lock = threading.RLock()
_resident: "collections.OrderedDict" = collections.OrderedDict()
_res_bytes = [0]
_res_counters: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}


def _res_budget() -> int:
    return knobs.env_int("DAFT_TORCH_DEVICE_CACHE_BYTES") // 8


def residency_counters() -> Dict[str, int]:
    with _res_lock:
        out = dict(_res_counters)
        out["entries"] = len(_resident)
        out["bytes"] = int(_res_bytes[0])
    return out


def reset_residency() -> None:
    with _res_lock:
        _resident.clear()
        _res_bytes[0] = 0
        for k in _res_counters:
            _res_counters[k] = 0


def reset_residency_counters() -> None:
    with _res_lock:
        for k in _res_counters:
            _res_counters[k] = 0


def note_decoded(series, data: torch.Tensor, validity: torch.Tensor,
                 dictionary, count: int, capacity: int) -> None:
    """Register a decoded device column's planes for reuse by a later
    encode of ``series``. Only whole, contiguous ``[capacity]`` planes
    register (a broadcast literal or a slice would not stand in for an
    encoded column)."""
    for t in (data, validity):
        if t.dim() != 1 or t.shape[0] != capacity or not t.is_contiguous():
            return
    key = id(series)
    try:
        ref = weakref.ref(series, lambda _r, _k=key: _drop(_k))
    except TypeError:
        return
    nbytes = data.nbytes + validity.nbytes
    with _res_lock:
        if key in _resident:
            return
        budget = _res_budget()
        if nbytes > budget:
            return
        while _res_bytes[0] + nbytes > budget and _resident:
            _, old = _resident.popitem(last=False)
            _res_bytes[0] -= old[6]
            _res_counters["evictions"] += 1
        _resident[key] = (ref, data, validity, dictionary, count, capacity,
                          nbytes)
        _res_bytes[0] += nbytes


def _drop(key: int) -> None:
    with _res_lock:
        ent = _resident.pop(key, None)
        if ent is not None:
            _res_bytes[0] -= ent[6]


def resident_planes(series, n: int):
    """``(data, validity, dictionary, capacity)`` for a Series whose
    device planes are still resident, or None. ``validity`` comes back
    masked to the ``n`` live rows: beyond them a kernel's output holds
    garbage where a fresh encode pads with zeros. Window 0 never reuses,
    so the synchronous path stays the plain encode."""
    if not _resident or inflight_window() <= 0:
        return None
    key = id(series)
    with _res_lock:
        ent = _resident.get(key)
        if ent is None:
            _res_counters["misses"] += 1
            return None
        ref, data, validity, dictionary, count, capacity, _nb = ent
        if ref() is not series or count != n:
            _res_counters["misses"] += 1
            return None
        _resident.move_to_end(key)
        _res_counters["hits"] += 1
    if count == capacity:
        return data, validity, dictionary, capacity
    return data, _masked_validity(validity, n), dictionary, capacity


def _masked_validity(validity: torch.Tensor, n: int) -> torch.Tensor:
    """``validity`` with every slot at or past ``n`` cleared."""
    return validity & (torch.arange(validity.shape[0],
                                    device=validity.device) < n)
