"""Logical-plan fingerprinting for the serving plane's caches.

The port's copy of ``daft_tpu/logical/fingerprint.py``. A fingerprint
canonicalizes a logical plan into three parts:

- ``structure``: a sha256 over the literal-STRIPPED plan tree (every
  ``lit`` expression becomes a ``?`` placeholder), the frozen
  ``ExecutionConfig`` and the plan environment (below); queries that
  differ only in literal values share a structure, which is what lets
  the serving plane count "same shape, new parameters" submissions;
- ``params``: the bound-parameter vector, the stripped literal values in
  tree order, canonicalized with ``repr``;
- ``sources``: one version token per ``Source`` leaf: the scan's file set
  with per-file ``(size, mtime_ns)`` from ``os.stat`` for local files, or
  the object store's version token (size and etag or last-modified, via
  ``ObjectSource.version``) for remote ones. A file appearing,
  disappearing or changing its version busts both caches; a remote
  object whose store exposes NO version signal keeps the whole plan
  uncacheable (it could change unobservably).

Invalidation rules:

- the **plan cache** keys on ``(structure, params, sources)``: a cached
  physical plan bakes in scan tasks (file lists, row-group pruning), so
  source changes invalidate it as much as literal changes do;
- the **result cache** keys on the same triple;
- any ``ExecutionConfig`` change busts both (every field of the config's
  ``asdict`` is hashed into ``structure``: the port's ``device``,
  ``exchange_path`` and the other fields the reference lacks included);
  process-env ``DAFT_TORCH_*`` knob changes do NOT, as in the reference
  (they are read at execution time), with one exception: the **plan
  environment**, the asked-for device (``backend.device_spec``) and the
  mesh's shard count (``mesh.mesh_size``), which ``translate`` reads to
  plan ``DeviceExchangeAgg``, is hashed into ``structure`` too (the
  reference's device is fixed for its process; the port's is a knob);
- the calibration generation busts both: ``structure`` folds in
  ``device/calibration.plan_token()`` (a quantized digest of every
  actively-overriding learned constant). The separate
  ``history_structure`` EXCLUDES the token: admission history keys must
  stay stable across calibration generations.

Plans are *uncacheable* (``fingerprint()`` returns None, caches bypassed)
when they contain an in-memory source (caching would pin the partitions
and ``id()`` keys can be recycled), a write sink (side effects must
re-run), a scan operator that does not expose its file set, a remote
object without a version, or any expression parameter that is not a
plain value (UDF callables: two functions can repr at one recycled
address).
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
import hashlib
import os
from typing import List, Optional, Tuple

from ..expressions.expressions import Expression
from . import plan as lp


@dataclasses.dataclass(frozen=True)
class PlanFingerprint:
    structure: str                 # sha256 hex of the literal-stripped tree
    params: Tuple[str, ...]        # bound literal vector (repr-canonical)
    sources: Tuple[Tuple, ...]     # per-source version tokens
    # ``structure`` WITHOUT the calibration token: admission history keys
    # must survive calibration-generation flips, unlike cached plans,
    # which bake the calibrated decisions in
    history_structure: str = ""

    @property
    def key(self) -> Tuple:
        """Full cache key: shape + literals + source versions."""
        return (self.structure, self.params, self.sources)


class _Uncacheable(Exception):
    """Internal: this plan must bypass the serving caches."""


_SAFE_PARAM_TYPES = (str, int, float, bool, bytes, type(None))


def _canon_value(v, params: List[str]) -> str:
    if isinstance(v, Expression):
        return _canon_expr(v, params)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_canon_value(x, params) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k!r}:{_canon_value(v[k], params)}" for k in sorted(v)) + "}"
    if isinstance(v, _SAFE_PARAM_TYPES):
        return repr(v)
    # dtypes and other engine value objects repr stably; anything with a
    # default object repr (memory address) is not a stable identity
    r = repr(v)
    if " at 0x" in r or callable(v):
        raise _Uncacheable(f"unstable plan parameter {type(v).__name__}")
    return r


def _canon_lit(v) -> str:
    """Canonicalize a bound literal VALUE. Stricter than ``_canon_value``:
    a literal keys the result cache, so a merely plausible repr is not
    enough (numpy truncates large-array reprs, and arbitrary objects can
    repr a recycled address without the ' at 0x' marker). Only types
    whose repr is a faithful total encoding are allowed."""
    if isinstance(v, _SAFE_PARAM_TYPES):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_canon_lit(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k!r}:{_canon_lit(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (datetime.date, datetime.time, decimal.Decimal)):
        return repr(v)  # datetime.datetime is a date subclass
    raise _Uncacheable(
        f"literal of type {type(v).__name__} has no stable canonical form")


def _canon_expr(e: Expression, params: List[str]) -> str:
    if e.op == "lit":
        params.append(_canon_lit(e.params[0]))
        return "(lit ?)"
    args = ",".join(_canon_expr(a, params) for a in e.args)
    ps = ",".join(_canon_value(p, params) for p in e.params)
    return f"({e.op} [{args}] [{ps}])"


def _source_version(node: lp.Source) -> Tuple:
    if node.partitions is not None:
        raise _Uncacheable("in-memory source")
    op = node.scan_op
    if op is None:
        raise _Uncacheable("source without scan operator")
    paths = getattr(op, "_paths", None) or getattr(op, "paths", None)
    if not paths:
        raise _Uncacheable(
            f"scan operator {type(op).__name__} exposes no file set")
    versions = []
    for p in paths:
        try:
            st = os.stat(p)
            versions.append((p, int(st.st_size), int(st.st_mtime_ns)))
            continue
        except OSError:
            pass
        # a remote object: its store's version token, or the plan stays
        # uncacheable (a cached plan would keep stale row-group ranges and
        # a cached result stale rows if the object changed unobservably)
        ver = None
        if "://" in str(p):
            from ..io.object_io import get_io_client
            ver = get_io_client().version(str(p))
        if ver is None:
            raise _Uncacheable(f"source {p!r} has no version signal")
        versions.append((str(p),) + tuple(ver))
    return (type(op).__name__, tuple(versions))


def _canon_node(node: lp.LogicalPlan, params: List[str],
                sources: List[Tuple]) -> str:
    t = type(node).__name__
    if isinstance(node, lp.Sink):
        raise _Uncacheable("write sink (side effects)")
    if isinstance(node, lp.Source):
        sources.append(_source_version(node))
        pd = node.pushdowns
        filt = _canon_value(pd.filters, params) if pd.filters is not None \
            else "-"
        pfilt = _canon_value(pd.partition_filters, params) \
            if pd.partition_filters is not None else "-"
        return (f"(Source #{len(sources) - 1} cols={pd.columns!r} "
                f"filt={filt} pfilt={pfilt} limit={pd.limit!r})")
    fields = []
    for k in sorted(vars(node)):
        if k.startswith("_") or k in ("materialized_tasks",):
            continue
        fields.append(f"{k}={_canon_value(getattr(node, k), params)}")
    kids = ",".join(_canon_node(c, params, sources) for c in node.children)
    return f"({t} {' '.join(fields)} [{kids}])"


def plan_environment() -> str:
    """What ``translate`` reads besides the plan and the config: the
    asked-for device and the mesh's shard count."""
    from ..device import backend
    from ..parallel import mesh
    return f"device={backend.device_spec()} mesh={mesh.mesh_size()}"


def fingerprint(plan: lp.LogicalPlan,
                exec_config=None) -> Optional[PlanFingerprint]:
    """Fingerprint a logical plan, or None when it must bypass the
    caches. Never raises: an unexpected node shape degrades to
    uncached."""
    from ..device import calibration
    params: List[str] = []
    sources: List[Tuple] = []
    try:
        tree = _canon_node(plan, params, sources)
        env = plan_environment()
    except Exception:
        return None
    cfg = repr(dataclasses.asdict(exec_config)) \
        if exec_config is not None else ""
    base = tree + "\x00" + cfg + "\x00" + env
    history_structure = hashlib.sha256(base.encode()).hexdigest()
    # the calibration-generation token: a plan cached under one set of
    # calibrated constants must not serve after they flip a decision (the
    # token changes, the old entry is never hit again and ages out)
    calib = calibration.plan_token()
    if calib:
        structure = hashlib.sha256(
            (base + "\x00" + calib).encode()).hexdigest()
    else:
        structure = history_structure
    return PlanFingerprint(structure, tuple(params), tuple(sources),
                           history_structure)
