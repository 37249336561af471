"""Byte-budget admission control for the device pipeline's slots.

The admission half of ``daft_tpu/execution/memory.py:MemoryManager``
(reference ``resource_manager.rs``): ``acquire`` waits until a request
fits, ``try_acquire`` waits at most until a deadline or a cancel signal,
``release`` returns the bytes. A request larger than the whole budget is
admitted when nothing else is held, so one huge slot cannot deadlock. The
spill classes of the reference are not ported (ROADMAP A6).
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class MemoryManager:
    """``budget`` bytes, or None for no limit (every request admitted at
    once and nothing counted)."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self._held = 0
        self._cond = threading.Condition()

    def _fits(self, nbytes: int) -> bool:
        return self._held == 0 or self._held + nbytes <= self.budget

    def acquire(self, nbytes: int) -> None:
        if self.budget is None:
            return
        with self._cond:
            while not self._fits(nbytes):
                self._cond.wait()
            self._held += nbytes

    def try_acquire(self, nbytes: int, deadline: Optional[float] = None,
                    cancel=None) -> bool:
        """Wait until the request fits, the monotonic ``deadline`` passes
        or ``cancel.is_set()``; True iff the bytes were admitted."""
        if self.budget is None:
            return True
        with self._cond:
            while not self._fits(nbytes):
                if cancel is not None and cancel.is_set():
                    return False
                timeout = 0.1   # poll, so a cancel fires within ~100 ms
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    timeout = min(timeout, remaining)
                self._cond.wait(timeout)
            self._held += nbytes
            return True

    @property
    def outstanding(self) -> int:
        """Bytes admitted and not yet released (0 without a budget)."""
        with self._cond:
            return self._held if self.budget is not None else 0

    def release(self, nbytes: int) -> None:
        if self.budget is None:
            return
        with self._cond:
            self._held = max(self._held - nbytes, 0)
            self._cond.notify_all()
