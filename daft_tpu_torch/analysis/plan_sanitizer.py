"""Runtime plan sanitizer of the port (opt-in:
``DAFT_TORCH_SANITIZE_PLAN=1``).

The port's copy of ``daft_tpu/analysis/plan_sanitizer.py``.
``rule_plans`` proves statically that every plan node and optimizer rule
has a declared contract; this sanitizer proves the contracts hold while
queries run:

- **Optimizer rules** — after every ``Rule.apply`` the root schema must
  equal the pre-apply schema (names and dtypes, in order) for every rule
  ``plan_contracts.RULE_CONTRACTS`` registers as schema-preserving; an
  unregistered rule applying at runtime is itself a violation.
- **Exchange membership** — at every hash exchange the executor yields
  through, a head sample of each output partition is re-hashed with the
  engine's own ``partition_by_hash`` and must land back in the partition
  it was emitted as: a spill/IPC round trip that drifts a dtype re-hashes
  the same value differently.
- **Sort order** — after Sort/TopN, each output partition's key columns
  must equal re-sorting that partition with the engine's comparator
  (NaN-tolerant; key columns only, so unstable tie order is fine).
- **Row conservation** — where the registry declares it, output rows must
  equal the sum of the node's input rows, checked only when the node and
  all its children ran exactly once and drained to completion.
- **Grace-join pairs** — a bucket pair read back from the spill stores must
  re-hash into its own bucket (:func:`check_grace_pair`).

Hooks: the optimizer loop (``logical/optimizer.py``), the executor's
``_exec_node`` and the push engine's node streams (:func:`wrap_node`,
before the stats instrumentation), and the grace join
(``execution/out_of_core.py``). Per-query deltas land in
``explain(analyze=True)``, the flight recorder and ``/metrics`` through
the ``plansan`` plane.

Off by default and allocation-free when off: :func:`wrap_node` returns its
iterator unchanged and the other hooks return at once.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

from . import plan_contracts

#: cap on remembered violations (each is a string; a broken rewrite in a
#: tight loop should not OOM the test session before it can fail it)
MAX_VIOLATIONS = 100

#: cap on per-node-execution conservation records kept at once
_MAX_RECORDS = 65536


#: head rows of each partition the membership and order checks re-verify
#: (the reference's default sample)
SAMPLE_ROWS = 64


class _NodeRecord:
    __slots__ = ("rows", "parts", "starts", "completed", "ref")

    def __init__(self, node):
        self.rows = 0
        self.parts = 0
        self.starts = 0
        self.completed = False
        # identity guard: records are keyed by id(node), and CPython
        # recycles ids of freed nodes — a dead ref means the key was
        # reused by a DIFFERENT node and the record is stale
        try:
            self.ref = weakref.ref(node)
        except TypeError:
            self.ref = None


class PlanSanitizer:
    """Plan-contract runtime checks + violation accounting. One global
    instance backs the armed session; tests may build their own and
    drive the check methods directly."""

    def __init__(self, sample_rows: Optional[int] = None):
        self._meta = threading.Lock()
        self.sample_rows = sample_rows
        # monotonic counters (the observability plane)
        self.rule_checks = 0
        self.membership_parts = 0
        self.membership_rows = 0
        self.order_parts = 0
        self.conservation_checks = 0
        self.violations: List[str] = []
        # per-node-execution books, keyed by id(node): conservation needs
        # the child counts a sibling wrap recorded
        self._records: Dict[int, _NodeRecord] = {}

    def _violate(self, msg: str) -> None:
        with self._meta:
            if len(self.violations) < MAX_VIOLATIONS:
                self.violations.append(msg)

    # ---- optimizer hook ---------------------------------------------
    def check_rule(self, rule_name: str, before, after) -> None:
        """Root-schema equality after one ``Rule.apply``; ``before`` /
        ``after`` are the plan root schemas."""
        with self._meta:
            self.rule_checks += 1
        contract = plan_contracts.RULE_CONTRACTS.get(rule_name)
        if contract is None:
            self._violate(
                f"optimizer rule {rule_name} applied at runtime but is "
                f"not registered in plan_contracts.RULE_CONTRACTS")
            return
        if not contract.schema_preserving:
            return
        bf, af = list(before.fields), list(after.fields)
        if bf != af:
            self._violate(
                f"schema-preserving rule {rule_name} changed the root "
                f"schema: {[(f.name, str(f.dtype)) for f in bf]} -> "
                f"{[(f.name, str(f.dtype)) for f in af]}")

    # ---- executor hook ----------------------------------------------
    def wrap(self, node, it):
        """Wrap one node execution's output iterator with the boundary
        checks the registry declares for its type."""
        contract = plan_contracts.PHYSICAL_NODES.get(type(node).__name__)
        if contract is None:
            return it
        membership = (contract.membership_check
                      and getattr(node, "kind", "") == "hash"
                      and len(getattr(node, "by", ())) > 0
                      and getattr(node, "num_partitions", 1) > 1)
        order = contract.order_check and getattr(node, "sort_by", ())
        conserve = contract.row_conservation
        # even check-free nodes get row/part books: a parent's
        # conservation proof needs its children's counts
        sample_n = self.sample_rows or SAMPLE_ROWS

        def gen():
            rec = self._begin(node)
            samples = [] if membership else None
            try:
                for part in it:
                    rec.rows += len(part)
                    rec.parts += 1
                    if membership \
                            and len(samples) < node.num_partitions:
                        try:
                            samples.append(part.head(sample_n))
                        except Exception:
                            samples.append(None)
                    if order:
                        self._check_order(node, part)
                    yield part
                rec.completed = True
                if membership:
                    self._check_membership(node, rec, samples)
                if conserve:
                    self._check_conservation(node, rec)
            finally:
                self._prune()
        return gen()

    def _begin(self, node) -> _NodeRecord:
        with self._meta:
            rec = self._records.get(id(node))
            if rec is not None and (rec.ref is None
                                    or rec.ref() is not node):
                rec = None  # id recycled onto a different node object
            if rec is None:
                rec = _NodeRecord(node)
                self._records[id(node)] = rec
            else:
                # re-execution of the same node object (AQE rounds,
                # repeated collects): reset the books; conservation
                # only ever compares single-start executions
                rec.rows = 0
                rec.parts = 0
                rec.completed = False
            rec.starts += 1
            return rec

    def _prune(self) -> None:
        with self._meta:
            if len(self._records) > _MAX_RECORDS:
                self._records.clear()

    # ---- membership --------------------------------------------------
    def _check_membership(self, node, rec, samples) -> None:
        """Sampled hash-partition membership: re-hash each output
        partition's head with the engine's own partition_by_hash and
        require it to land back where it was emitted. Skipped when the
        yielded partition count differs from the planned one (AQE bucket
        coalescing re-maps indices — conservation still covers those)."""
        if rec.parts != node.num_partitions:
            return
        n = node.num_partitions
        for i, sample in enumerate(samples):
            if sample is None or len(sample) == 0:
                continue
            try:
                parts = sample.partition_by_hash(list(node.by), n)
            except Exception as exc:
                self._violate(
                    f"Exchange(hash) membership re-hash failed on "
                    f"partition {i}/{n}: {exc!r}")
                return
            with self._meta:
                self.membership_parts += 1
                self.membership_rows += len(sample)
            stray = {j: len(p) for j, p in enumerate(parts)
                     if j != i and len(p) > 0}
            if stray:
                self._violate(
                    f"Exchange(hash) membership violation: "
                    f"{sum(stray.values())} of {len(sample)} sampled "
                    f"rows of output partition {i}/{n} re-hash into "
                    f"partition(s) {sorted(stray)} (keys "
                    f"{[e.name() for e in node.by]}) — partition "
                    f"membership drifted across the boundary")

    # ---- sort order --------------------------------------------------
    def _check_order(self, node, part) -> None:
        """Key columns of an emitted Sort/TopN partition must equal the
        key columns after re-sorting it with the engine's comparator."""
        names = []
        for e in node.sort_by:
            try:
                names.append(e.name())
            except Exception:
                return  # un-named key expression: cannot check cheaply
        try:
            got = part.to_pydict()
            want = part.sort(list(node.sort_by),
                             list(node.descending),
                             list(node.nulls_first)).to_pydict()
        except Exception:
            return
        if any(nm not in got for nm in names):
            return
        with self._meta:
            self.order_parts += 1
        for nm in names:
            if not _values_equal(got[nm], want[nm]):
                self._violate(
                    f"{type(node).__name__} emitted an unsorted "
                    f"partition: key column {nm!r} differs from the "
                    f"engine-sorted order (descending="
                    f"{list(node.descending)}, nulls_first="
                    f"{list(node.nulls_first)})")
                return

    # ---- row conservation -------------------------------------------
    def _check_conservation(self, node, rec: _NodeRecord) -> None:
        """Output rows == sum of input rows, judged only when this node
        and every child executed exactly once and drained fully."""
        if rec.starts != 1:
            return
        with self._meta:
            child_recs = []
            for c in node.children:
                cr = self._records.get(id(c))
                if cr is not None and (cr.ref is None
                                       or cr.ref() is not c):
                    cr = None  # stale record under a recycled id
                child_recs.append(cr)
        total = 0
        for cr in child_recs:
            if cr is None or not cr.completed or cr.starts != 1:
                return  # child bypassed/abandoned/re-run: not judgeable
            total += cr.rows
        with self._meta:
            self.conservation_checks += 1
        if rec.rows != total:
            self._violate(
                f"{type(node).__name__} row-conservation violation: "
                f"{total} rows in, {rec.rows} rows out (registry "
                f"declares this node row-conserving)")

    # ---- reporting ---------------------------------------------------
    def summary(self) -> dict:
        with self._meta:
            return {
                "rule_checks": self.rule_checks,
                "membership_parts": self.membership_parts,
                "membership_rows": self.membership_rows,
                "order_parts": self.order_parts,
                "conservation_checks": self.conservation_checks,
                "violations": list(self.violations),
            }

    def report(self) -> str:
        s = self.summary()
        lines = [
            f"plan sanitizer: {s['rule_checks']} rule applications, "
            f"{s['membership_parts']} membership samples "
            f"({s['membership_rows']} rows re-hashed), "
            f"{s['order_parts']} order checks, "
            f"{s['conservation_checks']} conservation checks",
        ]
        if s["violations"]:
            lines.append(f"PLAN CONTRACT VIOLATIONS "
                         f"({len(s['violations'])}):")
            lines.extend(f"  {v}" for v in s["violations"])
        else:
            lines.append("no plan-contract violations")
        return "\n".join(lines)


def _values_equal(a: list, b: list) -> bool:
    """Element-wise equality, NaN-tolerant (NaN == NaN here: re-sorting
    may not preserve NaN identity but the ordering contract holds)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x == y:
            continue
        if x is None or y is None:
            return False
        if x != x and y != y:  # both NaN
            continue
        return False
    return True


# ----------------------------------------------------------- global state

_global: Optional[PlanSanitizer] = None
_enabled = False


def enabled_by_env() -> bool:
    from .. import knobs
    return knobs.env_bool("DAFT_TORCH_SANITIZE_PLAN")


def enable(sample_rows: Optional[int] = None) -> None:
    """Arm the global sanitizer. Idempotent; ``daft_tpu_torch/__init__``
    arms it beside the lock/retrace sanitizers when the knob is set."""
    global _global, _enabled
    if _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- single-threaded
    # bootstrap: enable() runs in __init__ (or a test) before engine threads
    _global = PlanSanitizer(sample_rows)
    # daft-lint: allow(unguarded-global-mutation) -- same bootstrap; the
    # flag flips only after the sanitizer is fully constructed
    _enabled = True


def disable() -> None:
    global _global, _enabled
    if not _enabled:
        return
    # daft-lint: allow(unguarded-global-mutation) -- mirror of enable():
    # teardown runs on the single main thread at session/test end
    _enabled = False
    # daft-lint: allow(unguarded-global-mutation) -- same teardown; the
    # hooks no-op on a None global either way
    _global = None


def is_enabled() -> bool:
    return _enabled


def sanitizer() -> Optional[PlanSanitizer]:
    return _global


def summary() -> dict:
    return _global.summary() if _global is not None else {}


def report() -> str:
    return _global.report() if _global is not None \
        else "plan sanitizer: disabled"


# ------------------------------------------------------------ engine hooks

def check_rule(rule_name: str, before, after) -> None:
    """Optimizer hook: schema equality after one rule application."""
    san = _global
    if _enabled and san is not None:
        san.check_rule(rule_name, before, after)


def wrap_node(node, it):
    """Executor hook: boundary checks on one node execution's output.
    Returns ``it`` unchanged when disarmed — zero overhead."""
    san = _global
    if not _enabled or san is None:
        return it
    return san.wrap(node, it)


def check_grace_pair(bucket: int, num_buckets: int, by, part) -> None:
    """Grace-join hook: a sampled bucket batch must re-hash into its own
    bucket (depth-0 radix split is contractually ``h % n``, bit-identical
    to ``partition_by_hash``)."""
    san = _global
    if not _enabled or san is None or part is None or len(part) == 0:
        return
    try:
        sample = part.head(san.sample_rows or SAMPLE_ROWS)
        parts = sample.partition_by_hash(list(by), num_buckets)
    except Exception:
        return  # non-expression keys / empty: nothing to judge
    with san._meta:
        san.membership_parts += 1
        san.membership_rows += len(sample)
    stray = {j: len(p) for j, p in enumerate(parts)
             if j != bucket and len(p) > 0}
    if stray:
        san._violate(
            f"grace-join bucket membership violation: "
            f"{sum(stray.values())} of {len(sample)} sampled rows of "
            f"bucket {bucket}/{num_buckets} re-hash into bucket(s) "
            f"{sorted(stray)} — spill round-trip drifted the hash")


# -------------------------------------------- observability integration

def counters_snapshot() -> Dict[str, float]:
    """Monotonic counters for per-query deltas (observability pattern:
    snapshot at query start, diff at finish)."""
    san = _global
    if not _enabled or san is None:
        return {}
    s = san.summary()
    return {"rule_checks": s["rule_checks"],
            "membership_parts": s["membership_parts"],
            "membership_rows": s["membership_rows"],
            "order_parts": s["order_parts"],
            "conservation_checks": s["conservation_checks"],
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
