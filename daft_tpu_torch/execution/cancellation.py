"""Cooperative query cancellation (reference:
``daft_tpu/execution/cancellation.py``).

A caller cancels a running query by setting its :class:`CancelToken`. The
token is *cooperative*: executors check it at morsel boundaries and in
every pipeline breaker's drain loop (a batch mid-kernel finishes), which
bounds cancellation latency to one morsel without unwinding device
dispatches mid-flight.

Propagation is scope-based: the caller installs the query's token with
:func:`cancel_scope` before entering the runner, and the executors capture
:func:`current_token` at construction — the token rides the executor, not
the thread, so pipeline stage threads spawned later still observe it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional


class QueryCancelled(RuntimeError):
    """Raised inside an executing query when its cancel token fires."""


class CancelToken:
    """One query's cancel flag + listener list.

    ``set()`` is idempotent; callbacks registered after the token fired
    run immediately (a late-registering executor must still unwind)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []
        self.reason: Optional[str] = None

    def set(self, reason: Optional[str] = None) -> None:
        with self._cb_lock:
            if self._event.is_set():
                return
            if reason is not None:
                self.reason = reason
            self._event.set()
            cbs = list(self._callbacks)
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass  # a listener must never block the cancel itself

    def is_set(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise :class:`QueryCancelled` if the token fired."""
        if self._event.is_set():
            raise QueryCancelled(self.reason or "query cancelled")

    def add_callback(self, fn: Callable[[], None]) -> None:
        fire_now = False
        with self._cb_lock:
            if self._event.is_set():
                fire_now = True
            else:
                self._callbacks.append(fn)
        if fire_now:
            try:
                fn()
            except Exception:
                pass


_tl = threading.local()


def current_token() -> Optional[CancelToken]:
    """The cancel token installed on this thread's active scope, if any."""
    return getattr(_tl, "token", None)


@contextlib.contextmanager
def cancel_scope(token: Optional[CancelToken]):
    """Install ``token`` as the thread's current cancellation scope."""
    prev = getattr(_tl, "token", None)
    _tl.token = token
    try:
        yield token
    finally:
        _tl.token = prev
