"""Runtime retrace sanitizer of the port (opt-in: ``DAFT_TORCH_SANITIZE=1``
+ ``DAFT_TORCH_SANITIZE_RETRACE=<budget multiplier>``).

The torch counterpart of ``daft_tpu/analysis/retrace_sanitizer.py``, with
its module name and API. The reference charges JAX trace events: a
dispatch site re-traces only when its declared signature changes. The
port compiles nothing per shape; the shape-instability tax it can pay is
**new device memory**: a caching-allocator segment (a ``cudaMalloc``,
which synchronizes the card) or a new pinned host block. A steady
signature should find the allocator's cached blocks and allocate nothing.

Mechanics:

- Dispatch chokepoints enter ``dispatch_scope(site_id, signature_key)``
  around their device work. The site is declared in
  ``analysis/dispatch_registry.py`` (``SITES``); the key spells what the
  site's allocations may depend on (capacity class, strategy, out-cap
  bucket, …).
- On a card, a scope reads the allocator's cumulative segment count
  (``torch.cuda.memory_stats``: ``segment.all.allocated``) and the pinned
  pool's block count (``torch.cuda.host_memory_stats``:
  ``num_host_alloc``) at entry and exit. Growth not already charged to a
  scope nested inside it is one event (:data:`SEGMENT_EVENT` /
  :data:`PINNED_EVENT`) of that scope. The counts are process-wide: an
  allocation another thread makes while a scope is open lands on it.
- The first event of a scope entry charges its (site, key) one
  *allocating entry*. The runner marks each query's start with its
  logical plan's content id (:func:`note_query`): the allocating entries
  of a query's first run at a signature are the allocator's warm-up —
  concurrent windows, the device column cache filling up and other
  queries' tensors resident grow memory there on purpose — counted
  (``warmup_events``), never enforced; a repeat of the query that still
  allocates at a signature it has warmed is the tax, and any such entry
  is a budget violation. An instance no query marks (the tests' and the
  reference's) allows :data:`SIGNATURE_BUDGET` ×
  ``DAFT_TORCH_SANITIZE_RETRACE`` allocating entries per signature, as
  the reference allows its traces.
- The three kernel wrappers report each launch (:func:`note_launch`):
  it is credited to every site on the thread's scope stack, so the
  reports show which engine site launched which kernel how often.
- Events outside any scope are attributed to the innermost
  ``daft_tpu_torch`` frame and counted (``unscoped``), never enforced;
  so are events of an exempt site (its reason is in the registry).

Off by default and allocation-free when off: ``dispatch_scope`` returns a
shared no-op singleton, and :func:`note_launch` returns at once. On the
CPU there is no device memory to read: scopes count entries and
signatures, and events come only from :meth:`RetraceSanitizer.note_event`
(the tests drive it directly).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import dispatch_registry

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))

#: event names: new caching-allocator segments, new pinned blocks
SEGMENT_EVENT = "segment"
PINNED_EVENT = "pinned"

#: allocating entries per signature in an instance no query marks (scaled
#: by the budget multiplier); a marked query's repeat is allowed none
SIGNATURE_BUDGET = 1


def device_memory_counts() -> Optional[Tuple[int, int]]:
    """(segments allocated so far, pinned blocks allocated so far) of the
    current card, or None off a card (or before CUDA is initialized)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    seg = torch.cuda.memory_stats_as_nested_dict()["segment"]["all"][
        "allocated"]
    pin = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
    return int(seg), int(pin)


class RetraceSanitizer:
    """Per-(site, signature) allocation accounting + budget enforcement.
    One global instance backs the armed process; tests build their own and
    drive :meth:`note_event` directly (``measure=None``)."""

    def __init__(self, budget_multiplier: int = 1,
                 measure: Optional[Callable[[], Optional[Tuple[int, int]]]]
                 = None):
        self._meta = threading.Lock()
        self.budget_multiplier = max(int(budget_multiplier), 1)
        self._measure = measure
        self._scopes = threading.local()
        # monotonic counters
        self.events = 0            # scoped + unscoped allocation events
        self.segments = 0          # new segments seen inside scopes
        self.pinned = 0            # new pinned blocks seen inside scopes
        self.unscoped_events = 0
        self.launches = 0
        # per-site / per-key books
        self._site_events: Dict[str, int] = {}
        self._site_entries: Dict[str, int] = {}
        self._site_keys: Dict[str, set] = {}
        self._site_segments: Dict[str, int] = {}
        self._site_pinned: Dict[str, int] = {}
        self._site_launches: Dict[str, Dict[str, int]] = {}
        self._key_events: Dict[Tuple[str, object], int] = {}
        #: queries started (None: no query marks, every entry charges),
        #: the current query's identity, and the run of each query that
        #: first met each signature
        self._query: Optional[int] = None
        self._query_id: object = None
        self._first_query: Dict[tuple, int] = {}
        self.warmup_events = 0
        #: entries of a marked query at a signature an earlier run of it
        #: warmed: the entries the repeat budget holds
        self.repeat_entries = 0
        self._unscoped_sites: Dict[str, int] = {}
        self._unscoped_launches: Dict[str, int] = {}
        #: launches under at least one engine site, per kernel
        self._engine_launches: Dict[str, int] = {}
        self.violations: List[str] = []
        self._violation_keys: set = set()

    # ---- scopes ------------------------------------------------------
    def _stack(self) -> List[list]:
        st = getattr(self._scopes, "stack", None)
        if st is None:
            st = []
            self._scopes.stack = st
        return st

    def begin_query(self, identity: object = None) -> None:
        """A query starts; ``identity`` names it across runs (None: every
        run is its own query)."""
        with self._meta:
            self._query = (self._query or 0) + 1
            try:
                hash(identity)
            except TypeError:
                identity = repr(identity)
            self._query_id = self._query if identity is None else identity

    def push(self, site_id: str, key: object) -> None:
        # [site, key, charged?, counts at entry, growth of nested scopes,
        #  the signature's first query is this one]
        counts = self._measure() if self._measure is not None else None
        warmup = False
        with self._meta:
            self._site_entries[site_id] = \
                self._site_entries.get(site_id, 0) + 1
            try:
                self._site_keys.setdefault(site_id, set()).add(key)
                if self._query is not None:
                    warmup = self._first_query.setdefault(
                        (self._query_id, site_id, key),
                        self._query) == self._query
                    if not warmup:
                        self.repeat_entries += 1
            except TypeError:   # unhashable key: entries only
                pass
        self._stack().append([site_id, key, False, counts, [0, 0], warmup])

    def pop(self) -> None:
        st = self._stack()
        if not st:
            return
        entry = st[-1]
        counts0 = entry[3]
        counts1 = self._measure() if counts0 is not None else None
        if counts1 is not None:
            seg = counts1[0] - counts0[0]
            pin = counts1[1] - counts0[1]
            own_seg, own_pin = seg - entry[4][0], pin - entry[4][1]
            if own_seg > 0:
                self.note_event(SEGMENT_EVENT, own_seg)
            if own_pin > 0:
                self.note_event(PINNED_EVENT, own_pin)
            if len(st) > 1:
                st[-2][4][0] += max(seg, 0)
                st[-2][4][1] += max(pin, 0)
        st.pop()

    # ---- event intake ------------------------------------------------
    def note_event(self, event: str, amount: float = 1) -> None:
        if event not in (SEGMENT_EVENT, PINNED_EVENT):
            return
        st = self._stack()
        if st:
            entry = st[-1]
            site = entry[0]
            with self._meta:
                if event == SEGMENT_EVENT:
                    self.segments += int(amount)
                    self._site_segments[site] = \
                        self._site_segments.get(site, 0) + int(amount)
                else:
                    self.pinned += int(amount)
                    self._site_pinned[site] = \
                        self._site_pinned.get(site, 0) + int(amount)
            if entry[2]:    # a second event of the same scope entry
                with self._meta:
                    self.events += 1
                return
            entry[2] = True
            if entry[5]:
                with self._meta:
                    self.events += 1
                    self.warmup_events += 1
                    self._site_events[site] = \
                        self._site_events.get(site, 0) + 1
                return
            self._charge(site, entry[1])
        else:
            site = _engine_frame() or "foreign"
            with self._meta:
                self.events += 1
                self.unscoped_events += 1
                self._unscoped_sites[site] = \
                    self._unscoped_sites.get(site, 0) + 1

    def note_launch(self, kernel: str) -> None:
        """One launch of the hand-written kernel ``kernel`` (its site id),
        credited to every distinct site on this thread's scope stack, and
        counted as an engine launch when one of them is an engine path's
        site (not a kernel wrapper's own)."""
        st = self._stack()
        with self._meta:
            self.launches += 1
            if not st:
                self._unscoped_launches[kernel] = \
                    self._unscoped_launches.get(kernel, 0) + 1
                return
            sites = {e[0] for e in st}
            for site in sites:
                d = self._site_launches.setdefault(site, {})
                d[kernel] = d.get(kernel, 0) + 1
            if any(dispatch_registry.is_engine_site(x) for x in sites):
                self._engine_launches[kernel] = \
                    self._engine_launches.get(kernel, 0) + 1

    def _charge(self, site_id: str, key: object) -> None:
        with self._meta:
            self.events += 1
            self._site_events[site_id] = \
                self._site_events.get(site_id, 0) + 1
            try:
                kk = (site_id, key)
                hash(kk)
            except TypeError:   # unhashable key: site-level count only
                return
            # per query too, once queries are marked: another query's
            # repeat at the same signature is its own
            marked = self._query is not None
            bk = (self._query_id,) + kk if marked else kk
            n = self._key_events.get(bk, 0) + 1
            self._key_events[bk] = n
            if not dispatch_registry.enforced(site_id):
                return          # exempt or undeclared site
            budget = 0 if marked else \
                SIGNATURE_BUDGET * self.budget_multiplier
            if n > budget and bk not in self._violation_keys:
                self._violation_keys.add(bk)
                s = dispatch_registry.site(site_id)
                contract = f" (contract: {s.budget})" if s else ""
                what = (f"a repeat of query {_fmt_key(self._query_id)} "
                        f"allocated at signature {_fmt_key(key)}, warmed "
                        f"by its first run" if marked else
                        f"{n} allocating entries for one signature "
                        f"{_fmt_key(key)}")
                self.violations.append(
                    f"{site_id}: {what} — budget is {budget} per "
                    f"signature{contract}")

    # ---- reporting ---------------------------------------------------
    def summary(self) -> dict:
        with self._meta:
            return {
                "events": self.events,
                "warmup_events": self.warmup_events,
                "repeat_entries": self.repeat_entries,
                "queries": self._query or 0,
                "segments": self.segments,
                "pinned": self.pinned,
                "launches": self.launches,
                "unscoped_events": self.unscoped_events,
                "site_events": dict(self._site_events),
                "site_entries": dict(self._site_entries),
                "site_signatures": {s: len(k) for s, k in
                                    self._site_keys.items()},
                "site_segments": dict(self._site_segments),
                "site_pinned": dict(self._site_pinned),
                "site_launches": {s: dict(d) for s, d in
                                  self._site_launches.items()},
                "unscoped_sites": dict(self._unscoped_sites),
                "unscoped_launches": dict(self._unscoped_launches),
                "engine_launches": dict(self._engine_launches),
                "violations": list(self.violations),
            }

    def report(self) -> str:
        s = self.summary()
        lines = [
            f"retrace sanitizer: {s['events']} allocating events "
            f"({s['warmup_events']} in a signature's first query; "
            f"{s['segments']} segments, {s['pinned']} pinned blocks), "
            f"{s['launches']} kernel launches, "
            f"{s['unscoped_events']} unscoped",
        ]
        for site, n in sorted(s["site_entries"].items()):
            lines.append(
                f"  {site}: {n} entries, "
                f"{s['site_signatures'].get(site, 0)} signatures, "
                f"{s['site_segments'].get(site, 0)} segments, "
                f"{s['site_pinned'].get(site, 0)} pinned, launches "
                f"{s['site_launches'].get(site, {})}")
        if s["violations"]:
            lines.append(f"RETRACE BUDGET VIOLATIONS "
                         f"({len(s['violations'])}):")
            lines.extend(f"  {v}" for v in s["violations"])
        else:
            lines.append("no retrace-budget violations")
        return "\n".join(lines)


def _fmt_key(key: object, limit: int = 120) -> str:
    try:
        s = repr(key)
    except Exception:
        s = "<unreprable>"
    return s if len(s) <= limit else s[:limit] + "…"


def _engine_frame() -> Optional[str]:
    """file:line of the innermost daft_tpu_torch frame (outside this
    package's analysis machinery), for unscoped-event attribution."""
    f = sys._getframe(1)
    while f is not None:
        af = os.path.abspath(f.f_code.co_filename)
        if af.startswith(_PKG_ROOT + os.sep) \
                and not af.startswith(_ANALYSIS_DIR + os.sep):
            rel = os.path.relpath(af, os.path.dirname(_PKG_ROOT))
            return f"unscoped:{rel.replace(os.sep, '/')}:{f.f_lineno}"
        f = f.f_back
    return None


# ----------------------------------------------------------- global state

_global: Optional[RetraceSanitizer] = None
_enabled = False


class _Scope:
    """One scope guard per dispatch; none when the sanitizer is off (the
    module hands out ``_NOOP`` instead)."""

    __slots__ = ("_site", "_key")

    def __init__(self, site_id: str, key: object):
        self._site = site_id
        self._key = key

    def __enter__(self):
        san = _global
        if san is not None:
            san.push(self._site, self._key)
        return self

    def __exit__(self, *exc):
        san = _global
        if san is not None:
            san.pop()
        return False


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopScope()


def dispatch_scope(site_id: str, key: object):
    """Enter around a device dispatch: allocation events inside are
    charged to ``(site_id, key)``. The shared no-op singleton when
    disarmed — zero allocation on the hot path."""
    if not _enabled:
        return _NOOP
    return _Scope(site_id, key)


def note_query(identity: object = None) -> None:
    """The runner starting a query named ``identity`` (its logical plan's
    content id, its scans named by their files): a no-op when disarmed."""
    san = _global
    if _enabled and san is not None:
        san.begin_query(identity)


def note_launch(kernel: str) -> None:
    """A kernel wrapper's launch hook (a no-op when disarmed)."""
    san = _global
    if _enabled and san is not None:
        san.note_launch(kernel)


def enabled_by_env() -> bool:
    from .. import knobs
    return knobs.env_bool("DAFT_TORCH_SANITIZE") \
        and knobs.env_int("DAFT_TORCH_SANITIZE_RETRACE") > 0


def budget_multiplier_from_env() -> int:
    from .. import knobs
    return max(knobs.env_int("DAFT_TORCH_SANITIZE_RETRACE"), 1)


def enable(multiplier: Optional[int] = None) -> None:
    """Arm the global sanitizer, measuring the card's allocator. Idempotent;
    ``daft_tpu_torch/__init__`` arms it beside the lock sanitizer."""
    global _global, _enabled
    if _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- single-threaded
    # bootstrap: enable() runs in __init__ (or a test) before engine threads
    _global = RetraceSanitizer(
        multiplier if multiplier is not None
        else budget_multiplier_from_env(), measure=device_memory_counts)
    # daft-lint: allow(unguarded-global-mutation) -- same bootstrap; the
    # flag flips only after the sanitizer is fully constructed
    _enabled = True


def disable() -> None:
    global _global, _enabled
    if not _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- mirror of enable():
    # teardown runs on the single main thread
    _enabled = False
    # daft-lint: allow(unguarded-global-mutation) -- same teardown; the
    # hooks no-op on a None global either way
    _global = None


def is_enabled() -> bool:
    return _enabled


def sanitizer() -> Optional[RetraceSanitizer]:
    return _global


def summary() -> dict:
    return _global.summary() if _global is not None else {}


def report() -> str:
    return _global.report() if _global is not None \
        else "retrace sanitizer: disabled"


# -------------------------------------------- observability integration

def counters_snapshot() -> Dict[str, float]:
    """Monotonic counters for per-query deltas (snapshot at query start,
    diff at finish)."""
    san = _global
    if not _enabled or san is None:
        return {}
    s = san.summary()
    return {"events": s["events"],
            "warmup_events": s["warmup_events"],
            "segments": s["segments"],
            "pinned": s["pinned"],
            "launches": s["launches"],
            "unscoped_events": s["unscoped_events"],
            "violations": len(s["violations"])}


def counters_delta(before: Dict[str, float],
                   after: Dict[str, float]) -> Dict[str, float]:
    out = {k: round(after.get(k, 0) - before.get(k, 0), 6)
           for k in after}
    # total violations is a level, not a delta — report the absolute too
    san = _global
    if _enabled and san is not None:
        out["total_violations"] = len(san.summary()["violations"])
    return out
