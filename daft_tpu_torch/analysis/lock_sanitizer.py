"""Runtime lock-order sanitizer of the port (opt-in:
``DAFT_TORCH_SANITIZE=1``).

The port's copy of ``daft_tpu/analysis/lock_sanitizer.py``. Static
analysis can prove a blocking call sits under a lock, but not that lock A
is taken while B is held in one thread and the inverse in another — the
latent deadlock that fires only under some interleavings. This sanitizer
finds it while queries run:

- ``enable()`` patches the ``threading.Lock`` / ``threading.RLock``
  factories, so every lock *created by the port's code* (the creation
  frame under ``daft_tpu_torch/``) is wrapped in a tracking proxy. Foreign
  locks (torch, pyarrow, the stdlib's own machinery) pass through
  untouched. Unlike the reference, a lock the stdlib creates *on behalf
  of* the port — the ``RLock`` inside a ``threading.Condition()``, the
  ``Lock`` of a ``threading.Event`` or a ``queue.Queue`` — is attributed
  to the port's frame that asked for the Condition, Event or Queue, so the
  push engine's channels (Conditions), the spill stores' writer groups and
  the fused agg's slot registry are tracked.
- Each tracked lock is keyed by its **allocation site** (file:line), so
  per-object locks aggregate into one graph node.
- Every acquisition while other tracked locks are held adds
  ``held-site → acquired-site`` edges to a lock-order graph; cycle
  detection runs on edge insert. A cycle is a potential deadlock,
  reported with its sites.
- Contended acquisitions (the non-blocking probe fails) and
  ``time.sleep`` while holding a tracked lock are counted.

The proxy keeps the reference's protocol for ``threading.Condition`` and
``queue.Queue`` over a plain lock: the Condition fast-path internals
(``_release_save`` etc.) are hidden, so a Condition falls back to plain
``acquire`` / ``release`` through the proxy and the books stay true. Over
an ``RLock`` (a bare ``threading.Condition()``) that fallback cannot tell
the owner from another thread, so the proxy forwards the RLock's own
internals and keeps the books in them.

Armed by ``daft_tpu_torch/__init__.py`` before any engine module creates
its module-level locks. :class:`LockOrderSanitizer` is instanceable, so
tests drive cycle detection without the process-wide patch.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)
#: stdlib modules that create locks on their caller's behalf (Condition,
#: Event, Queue): the creation site is the caller's frame
_FACTORY_FILES = tuple(os.path.abspath(m.__file__)
                       for m in (threading, queue))


class LockOrderSanitizer:
    """A lock-order graph + counters. One global instance backs the
    ``DAFT_TORCH_SANITIZE=1`` process; tests may build their own."""

    def __init__(self):
        self._meta = threading.Lock()   # created pre-patch: never tracked
        self._edges: Dict[str, Set[str]] = {}
        self._edge_witness: Dict[Tuple[str, str], str] = {}
        self._sites: Set[str] = set()
        self._cycles: List[str] = []
        self._cycle_keys: Set[Tuple[str, str]] = set()
        self._held = threading.local()
        self.acquisitions = 0
        self.contended = 0
        self.blocking_while_held = 0
        self._blocking_sites: Set[str] = set()

    # ---- per-thread held stack --------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = []
            self._held.stack = st
        return st

    def held_sites(self) -> List[str]:
        return list(self._stack())

    # ---- graph ------------------------------------------------------
    def note_acquire(self, site: str, contended: bool) -> None:
        stack = self._stack()
        with self._meta:
            self.acquisitions += 1
            if contended:
                self.contended += 1
            self._sites.add(site)
            for held in stack:
                if held != site:
                    self._add_edge(held, site)
        stack.append(site)

    def note_release(self, site: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                break

    def note_blocking(self, what: str) -> None:
        stack = self._stack()
        if not stack:
            return
        with self._meta:
            self.blocking_while_held += 1
            self._blocking_sites.add(f"{what} while holding {stack[-1]}")

    def _add_edge(self, a: str, b: str) -> None:
        # caller holds self._meta
        succ = self._edges.setdefault(a, set())
        if b in succ:
            return
        succ.add(b)
        self._edge_witness[(a, b)] = \
            f"thread {threading.current_thread().name}"
        path = self._find_path(b, a)
        if path is not None:
            key = (min(a, b), max(a, b))
            if key not in self._cycle_keys:
                self._cycle_keys.add(key)
                self._cycles.append(" -> ".join([a, b] + path[1:]))

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src→dst through the edge set (caller holds _meta)."""
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # ---- reporting --------------------------------------------------
    def summary(self) -> dict:
        with self._meta:
            return {
                "locks": len(self._sites),
                "edges": sum(len(s) for s in self._edges.values()),
                "cycles": list(self._cycles),
                "acquisitions": self.acquisitions,
                "contended": self.contended,
                "blocking_while_held": self.blocking_while_held,
                "blocking_sites": sorted(self._blocking_sites),
            }

    def report(self) -> str:
        s = self.summary()
        lines = [
            f"lock-order sanitizer: {s['locks']} lock sites, "
            f"{s['edges']} order edges, {s['acquisitions']} acquisitions "
            f"({s['contended']} contended)",
        ]
        if s["cycles"]:
            lines.append(f"POTENTIAL DEADLOCKS ({len(s['cycles'])} "
                         f"acquisition-order cycles):")
            lines.extend(f"  {c}" for c in s["cycles"])
        else:
            lines.append("no acquisition-order cycles")
        if s["blocking_while_held"]:
            lines.append(f"blocking-while-held events: "
                         f"{s['blocking_while_held']}")
            lines.extend(f"  {b}" for b in s["blocking_sites"])
        return "\n".join(lines)

    # ---- wrapping ---------------------------------------------------
    def track(self, real_lock, site: str):
        """Wrap an existing lock object for this sanitizer instance."""
        if hasattr(real_lock, "_release_save"):
            return _TrackedRLock(real_lock, site, self)
        return _TrackedLock(real_lock, site, self)


class _TrackedLock:
    """Proxy recording acquisition order. Forwards everything else to
    the real lock — EXCEPT the Condition fast-path internals
    (``_release_save`` etc.) of a plain lock, which must fall back to plain
    acquire/release through the proxy so bookkeeping stays truthful; an
    RLock's are forwarded by :class:`_TrackedRLock`."""

    __slots__ = ("_lock", "_site", "_san", "_depth")
    _CONDITION_INTERNALS = ("_release_save", "_acquire_restore", "_is_owned")

    def __init__(self, real_lock, site: str, san: LockOrderSanitizer):
        self._lock = real_lock
        self._site = site
        self._san = san
        self._depth = 0     # reentrant depth (RLock); benign race per-lock

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not blocking:
            got = self._lock.acquire(False)
            if got:
                self._san.note_acquire(self._site, contended=False)
                self._depth += 1
            return got
        # probe first so contention is observable without timing
        if self._lock.acquire(False):
            self._san.note_acquire(self._site, contended=False)
            self._depth += 1
            return True
        self._san.note_acquire(self._site, contended=True)
        try:
            got = self._lock.acquire(True, timeout) if timeout != -1 \
                else self._lock.acquire(True)
        except BaseException:
            # e.g. KeyboardInterrupt delivered mid-acquire: the site was
            # optimistically pushed — pop it or every later acquisition
            # on this thread records false held→acquired edges
            self._san.note_release(self._site)
            raise
        if not got:
            self._san.note_release(self._site)
        else:
            self._depth += 1
        return got

    def release(self):
        self._depth = max(self._depth - 1, 0)
        self._lock.release()
        self._san.note_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    def __getattr__(self, name):
        if name in _TrackedLock._CONDITION_INTERNALS:
            # force Condition onto plain acquire()/release() via the proxy
            raise AttributeError(name)
        return getattr(self._lock, name)

    def __repr__(self):
        return f"<tracked {self._lock!r} from {self._site}>"


class _TrackedRLock(_TrackedLock):
    """An RLock's proxy: a Condition over it needs the owner test and the
    full release/restore of every recursion level, which the RLock's own
    internals give; the books drop the site once per level on the save and
    take it again per level on the restore (a Condition's wait and its
    wake-up)."""

    __slots__ = ()

    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        depth = self._depth
        state = self._lock._release_save()
        self._depth = 0
        for _ in range(max(depth, 1)):
            self._san.note_release(self._site)
        return state, depth

    def _acquire_restore(self, saved):
        state, depth = saved
        self._lock._acquire_restore(state)
        for _ in range(max(depth, 1)):
            self._san.note_acquire(self._site, contended=False)
        self._depth = depth


# ----------------------------------------------------------- global state

_global = LockOrderSanitizer()
_enabled = False
_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_sleep = time.sleep


def _creation_site() -> Optional[str]:
    """file:line of the port's frame creating the lock (through a
    Condition, Event or Queue the stdlib builds for it), or None when the
    creator is foreign code (torch, pyarrow, the stdlib's own machinery) —
    those stay untracked."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _SELF and not fn.startswith("<") \
                and os.path.abspath(fn) not in _FACTORY_FILES:
            if os.path.abspath(fn).startswith(_PKG_ROOT + os.sep):
                rel = os.path.relpath(os.path.abspath(fn),
                                      os.path.dirname(_PKG_ROOT))
                return f"{rel.replace(os.sep, '/')}:{f.f_lineno}"
            return None
        f = f.f_back
    return None


def _make_lock():
    real = _real_lock()
    site = _creation_site()
    if site is None:
        return real
    return _global.track(real, site)


def _make_rlock():
    real = _real_rlock()
    site = _creation_site()
    if site is None:
        return real
    return _global.track(real, site)


def _sleep_watched(secs):
    _global.note_blocking(f"time.sleep({secs})")
    return _real_sleep(secs)


def enabled_by_env() -> bool:
    from .. import knobs
    return knobs.env_bool("DAFT_TORCH_SANITIZE")


def enable() -> None:
    """Patch the lock factories + time.sleep. Idempotent. Engine locks
    created BEFORE enable() stay untracked — call as early as possible
    (``daft_tpu_torch/__init__`` arms it before any engine import)."""
    global _enabled
    if _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- single-threaded
    # bootstrap: enable() runs in __init__ before any engine thread
    _enabled = True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    time.sleep = _sleep_watched


def disable() -> None:
    global _enabled
    if not _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- mirror of enable():
    # teardown runs on the single main thread at session end
    _enabled = False
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    time.sleep = _real_sleep


def is_enabled() -> bool:
    return _enabled


def sanitizer() -> LockOrderSanitizer:
    return _global


def summary() -> dict:
    return _global.summary()


def report() -> str:
    return _global.report()


# -------------------------------------------- observability integration

def counters_snapshot() -> Dict[str, float]:
    """Monotonic counters for per-query deltas (observability pattern:
    snapshot at query start, diff at finish)."""
    if not _enabled:
        return {}
    s = _global.summary()
    return {"acquisitions": s["acquisitions"],
            "contended": s["contended"],
            "blocking_while_held": s["blocking_while_held"]}


def counters_delta(before: Dict[str, float],
                   after: Dict[str, float]) -> Dict[str, float]:
    out = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    # graph size is a level, not a delta — report current absolutes
    if _enabled:
        s = _global.summary()
        out["graph_locks"] = s["locks"]
        out["graph_edges"] = s["edges"]
        out["graph_cycles"] = len(s["cycles"])
    return out
