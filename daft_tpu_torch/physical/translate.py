"""Logical → physical translation.

Reference: ``src/daft-local-plan/src/translate.rs:19-434`` (direct lowering,
Aggregate → partial/final split) and
``src/daft-physical-plan/src/physical_planner/translate.rs:639``
(``populate_aggregation_stages``), and the join strategy choice of
``daft_tpu/physical/translate.py``, whose exchange placement the port
keeps: hash exchanges under partitioned joins (marked ``join_side``), under
two-phase aggregates (the partial, then a hash exchange over
``min(nparts, shuffle_aggregation_default_partitions)``, then the final)
and under ``Dedup``; ``Repartition`` as a hash, random, range or split
exchange; a gather under a broadcast side, a cross join's right side and a
global aggregate. The outermost call then proposes fusion regions
(``physical/fusion.py``), as the reference does.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..aggs import AGG_DECOMPOSITION as _DECOMPOSABLE
from ..datatype import DataType
from ..expressions import Expression, col
from ..logical import plan as lp
from ..logical import stats as lstats
from ..schema import Schema
from . import plan as pp


_tl = threading.local()


def translate(plan: lp.LogicalPlan) -> pp.PhysicalPlan:
    """Logical → physical, deduplicating shared subplans (reference:
    ``daft_tpu/physical/translate.py:translate``): logically equal
    subtrees (by ``semantic_id``) map to one physical node whose
    ``shared_consumers`` counts its parents, and the executor runs it once
    for all of them. A query that reads one DataFrame twice (TPC-H Q15's
    ``revenue``, compared with its own maximum) so sees one answer for
    it, whatever order the device's atomics summed in."""
    fresh = not getattr(_tl, "active", False)
    if fresh:
        _tl.active = True
        _tl.memo = {}
    try:
        out = _t(plan)
        if fresh:
            # grow device-eligible operator chains into FusedRegion nodes,
            # outermost call only (reference translate.py:49-52)
            from ..context import get_context
            from . import fusion
            out = fusion.fuse_regions(out, get_context().execution_config)
        return out
    finally:
        if fresh:
            _tl.active = False
            _tl.memo = {}


def _nondeterministic(node: lp.LogicalPlan) -> bool:
    """True when the subtree's output is not a pure function of its
    inputs (an unseeded Sample): such subtrees never merge, two identical
    ``.sample()`` calls are independent draws."""
    if isinstance(node, lp.Sample) and node.seed is None:
        return True
    return any(_nondeterministic(c) for c in node.children)


def _t(node: lp.LogicalPlan) -> pp.PhysicalPlan:
    key = node.semantic_id()
    hit = _tl.memo.get(key)
    if hit is not None:
        hit.shared_consumers = getattr(hit, "shared_consumers", 1) + 1
        return hit
    out = _t_node(node)
    if not _nondeterministic(node):
        _tl.memo[key] = out
    return out


def _nparts(node: lp.LogicalPlan) -> int:
    return max(node.num_partitions(), 1)


def _t_node(node: lp.LogicalPlan) -> pp.PhysicalPlan:
    if isinstance(node, lp.Source):
        if node.partitions is not None:
            return pp.InMemorySource(node.partitions, node.schema())
        tasks = getattr(node, "materialized_tasks", None)
        if tasks is None:
            tasks = node.scan_op.to_scan_tasks(node.pushdowns)
        return pp.ScanSource(tasks, node.schema())
    if isinstance(node, lp.Project):
        return pp.Project(_t(node.children[0]), node.exprs,
                          node.schema())
    if isinstance(node, lp.Filter):
        return pp.Filter(_t(node.children[0]), node.predicate)
    if isinstance(node, lp.Limit):
        return pp.Limit(_t(node.children[0]), node.limit, node.offset)
    if isinstance(node, lp.Sort):
        return pp.Sort(_t(node.children[0]), node.sort_by,
                       node.descending, node.nulls_first)
    if isinstance(node, lp.TopN):
        return pp.TopN(_t(node.children[0]), node.sort_by,
                       node.descending, node.nulls_first, node.limit)
    if isinstance(node, lp.Sample):
        return pp.Sample(_t(node.children[0]), node.fraction, node.size,
                         node.with_replacement, node.seed)
    if isinstance(node, lp.Unpivot):
        return pp.Unpivot(_t(node.children[0]), node.ids, node.values,
                          node.variable_name, node.value_name,
                          node.schema())
    if isinstance(node, lp.Repartition):
        spec = node.spec
        kind = {"hash": "hash", "random": "random", "range": "range",
                "unknown": "split"}[spec.kind]
        return pp.Exchange(_t(node.children[0]), kind, spec.num_partitions,
                           spec.by, spec.descending)
    if isinstance(node, lp.Distinct):
        on = node.on or [col(n) for n in node.schema().column_names]
        ex = pp.Exchange(_t(node.children[0]), "hash",
                         _nparts(node.children[0]), tuple(on),
                         engine_inserted=True)
        return pp.Dedup(ex, on)
    if isinstance(node, lp.Aggregate):
        return _translate_agg(node)
    if isinstance(node, lp.Pivot):
        # every (group, pivot) row of a group must meet in one partition
        gather = pp.Exchange(_t(node.children[0]), "gather", 1)
        return pp.Pivot(gather, node.group_by, node.pivot_col,
                        node.value_col, node.names, node.schema())
    if isinstance(node, lp.Join):
        return _translate_join(node)
    if isinstance(node, lp.Window):
        child = _t(node.children[0])
        if node.partition_by:
            child = pp.Exchange(child, "hash",
                                max(node.children[0].num_partitions(), 1),
                                tuple(node.partition_by))
        else:
            child = pp.Exchange(child, "gather", 1)
        return pp.Window(child, node.window_exprs, node.partition_by,
                         node.order_by, node.descending, node.nulls_first,
                         node.frame, node.schema())
    if isinstance(node, lp.Concat):
        return pp.Concat(_t(node.children[0]), _t(node.children[1]))
    if isinstance(node, lp.MonotonicallyIncreasingId):
        return pp.MonotonicallyIncreasingId(
            _t(node.children[0]), node.column_name, node.schema())
    if isinstance(node, lp.Sink):
        return pp.Write(_t(node.children[0]), node.info, node.schema())
    raise NotImplementedError(f"translate for {node.name()}")


def _estimate_size(node: lp.LogicalPlan) -> Optional[int]:
    """Best-effort size estimate (bytes) for the join strategy choice."""
    if isinstance(node, lp.Source):
        if node.partitions is not None:
            # a SpillBuffer (AQE actuals) knows its bytes without a reload
            sz = getattr(node.partitions, "total_bytes", None)
            if sz is not None:
                return sz
            return sum(p.size_bytes() or 0 for p in node.partitions)
        tasks = getattr(node, "materialized_tasks", None)
        if tasks is None:
            tasks = node.materialized_tasks = \
                node.scan_op.to_scan_tasks(node.pushdowns)
        sizes = [t.size_bytes() for t in tasks]
        return sum(sizes) if all(s is not None for s in sizes) else None
    if isinstance(node, (lp.Filter, lp.Sample)):
        base = _estimate_size(node.children[0])
        return None if base is None else int(base * 0.2)
    if isinstance(node, lp.Limit):
        return 1024 * node.limit  # rough
    if isinstance(node, lp.Aggregate):
        base = _estimate_size(node.children[0])
        return None if base is None else max(int(base * 0.05), 1024)
    if isinstance(node, lp.Distinct):
        # DISTINCT on key columns often barely reduces (TPC-H Q21's
        # (orderkey, suppkey) pairs), so it is priced at half its input
        base = _estimate_size(node.children[0])
        return None if base is None else max(int(base * 0.5), 1024)
    if node.children:
        sizes = [_estimate_size(c) for c in node.children]
        return None if any(s is None for s in sizes) else sum(sizes)
    return None


def _translate_join(node: lp.Join) -> pp.PhysicalPlan:
    """Broadcast a side estimated at most
    ``broadcast_join_size_bytes_threshold`` bytes (the right one first,
    where the join type allows) behind a gather exchange; else a hash
    join, over hash exchanges on both sides when either input has more
    than one partition; or the sort-merge join when asked for. A cross
    join gathers its right side."""
    from ..context import get_context
    left, right = node.children
    pl, pr = _t(left), _t(right)
    if node.how == "cross":
        return pp.CrossJoin(pl, pp.Exchange(pr, "gather", 1), node.schema())
    lsize, rsize = _estimate_size(left), _estimate_size(right)
    strategy = node.strategy
    if strategy is None:
        threshold = get_context().execution_config \
            .broadcast_join_size_bytes_threshold
        if (rsize is not None and rsize <= threshold
                and node.how in ("inner", "left", "semi", "anti")):
            strategy = "broadcast_right"
        elif (lsize is not None and lsize <= threshold
              and node.how in ("inner", "right")):
            strategy = "broadcast_left"
        else:
            strategy = "hash"
    elif strategy == "broadcast":
        strategy = "broadcast_right" if node.how in (
            "inner", "left", "semi", "anti") else "hash"
    if strategy not in ("hash", "broadcast_right", "broadcast_left",
                        "sort_merge"):
        raise ValueError(f"join strategy {strategy!r}: expected hash, "
                         "broadcast, broadcast_right, broadcast_left or "
                         "sort_merge")
    # a broadcast side is joined once per morsel of the other, so it must
    # be a side whose unmatched rows the join drops
    if (strategy == "broadcast_right" and node.how in ("right", "outer")) \
            or (strategy == "broadcast_left"
                and node.how not in ("inner", "right")):
        raise ValueError(f"join strategy {strategy!r} cannot run a "
                         f"{node.how!r} join")
    if strategy == "sort_merge":
        # no exchanges: the executor samples both sides and range-buckets
        # them on one shared boundary set (reference translate.py:224)
        return pp.HashJoin(pl, pr, node.left_on, node.right_on, node.how,
                           node.schema(), "sort_merge")
    if strategy == "hash" and (_nparts(left) > 1 or _nparts(right) > 1):
        n = max(_nparts(left), _nparts(right))
        # join-side exchanges keep identical counts on both sides (never
        # coalesced), but AQE may demote the pair to a broadcast join from
        # measured sizes (``executor._adaptive_hash_join``)
        pl = pp.Exchange(pl, "hash", n, tuple(node.left_on))
        pr = pp.Exchange(pr, "hash", n, tuple(node.right_on))
        pl.join_side = True
        pr.join_side = True
    elif strategy == "broadcast_right":
        pr = pp.Exchange(pr, "gather", 1)
    elif strategy == "broadcast_left":
        pl = pp.Exchange(pl, "gather", 1)
    join = pp.HashJoin(pl, pr, node.left_on, node.right_on, node.how,
                       node.schema(), strategy)
    # size evidence for the grace hash join's first-level radix fanout
    join.left_bytes_est = lsize
    join.right_bytes_est = rsize
    return join


def _translate_agg(node: lp.Aggregate) -> pp.PhysicalPlan:
    from ..aggs import split_agg_expr
    from ..context import get_context
    cfg = get_context().execution_config
    child = node.children[0]
    pchild = _t(child)
    nparts = _nparts(child)
    specs = [split_agg_expr(e) for e in node.aggs]
    if not all(op in _DECOMPOSABLE for op, _, _, _ in specs):
        # no partial/merge split: every row of a group meets in one
        # partition, then one aggregate
        if node.group_by:
            ex = pp.Exchange(
                pchild, "hash",
                min(nparts, cfg.shuffle_aggregation_default_partitions),
                tuple(node.group_by), engine_inserted=True)
        else:
            ex = pp.Exchange(pchild, "gather", 1)
        return pp.Aggregate(ex, node.aggs, node.group_by, node.schema(),
                            "single")

    partial_aggs, final_aggs, final_proj = _split_aggs(node, child.schema())
    p1_schema = _agg_schema(node.group_by, partial_aggs, child.schema())
    p1 = _try_fuse_partial(pchild, partial_aggs, node.group_by, p1_schema)
    if p1 is None:
        p1 = pp.Aggregate(pchild, partial_aggs, node.group_by, p1_schema,
                          "partial")
    gb2 = [col(e.name()) for e in node.group_by]
    f_schema = _agg_schema(gb2, final_aggs, p1_schema)
    est_rows = lstats.estimate(child).rows
    # footer-backed output-cardinality estimate (the reference's
    # translate.py:299-310; the max over keys is a lower bound on the
    # groups) with the raw row estimate beside it; the fused fragment
    # feeds it to the cost model's hash-vs-sort choice (under the mesh
    # exchange too), the push executor to its partitioned-agg admission
    ndvs = [v for v in (lstats.column_ndv_footer(child, e.name(),
                                                 est_rows=est_rows)
                        for e in node.group_by) if v is not None]
    group_ndv = max(ndvs) if ndvs else None
    if isinstance(p1, pp.DeviceFragmentAgg):
        p1.group_ndv, p1.group_rows_est = group_ndv, est_rows
    p2 = _try_mesh_exchange_agg(p1, final_aggs, gb2, p1_schema, f_schema,
                                est_rows)
    if p2 is None:
        if node.group_by:
            ex = pp.Exchange(
                p1, "hash",
                min(nparts, cfg.shuffle_aggregation_default_partitions)
                if nparts > 1 else 1,
                tuple(col(e.name()) for e in node.group_by),
                engine_inserted=True)
        else:
            ex = pp.Exchange(p1, "gather", 1)
        p2 = pp.Aggregate(ex, final_aggs, gb2, f_schema, "final")
        p2.group_ndv, p2.group_rows_est = group_ndv, est_rows
    proj = [col(e.name()) for e in node.group_by] + final_proj
    return pp.Project(p2, proj, node.schema())


def _try_mesh_exchange_agg(p1, final_aggs, gb2, p1_schema: Schema,
                           f_schema: Schema, est_rows=None
                           ) -> Optional[pp.PhysicalPlan]:
    """The shuffle and final merge as one collective program over the
    device mesh (``DeviceExchangeAgg``, reference ``translate.py:315``),
    when statically sound: a grouped (not global) agg, a mesh of two or
    more shards, admission by ``mesh.mesh_admits`` over the estimated
    rows, every group key and partial value either round-tripping the
    device encoding bit-exactly or string/binary (shared dictionary
    codes), and every final op in ``MERGEABLE_OPS``. None otherwise: the
    host exchange and final aggregate run."""
    from ..aggs import split_agg_expr
    from ..device import column as dcol
    from ..parallel import mesh as pmesh
    from ..parallel.exchange import MERGEABLE_OPS
    if not gb2 or pmesh.mesh_size() < 2:
        return None
    row_bytes = 8.0 * max(len(gb2) + len(final_aggs), 1)
    if not pmesh.mesh_admits(est_rows, row_bytes):
        return None

    def exchangeable(dtype) -> bool:
        return (dcol.is_lossless_device_dtype(dtype)
                or dtype.is_string() or dtype.is_binary())

    for g in gb2:
        if not exchangeable(p1_schema[g.name()].dtype):
            return None
    for a in final_aggs:
        op, child_e, _name, _params = split_agg_expr(a)
        if op not in MERGEABLE_OPS:
            return None
        if child_e is None or child_e._unalias().op != "col":
            return None
        if not exchangeable(p1_schema[child_e._unalias().params[0]].dtype):
            return None
    return pp.DeviceExchangeAgg(p1, final_aggs, gb2, f_schema)


def _try_fuse_partial(pchild: pp.PhysicalPlan, partial_aggs, group_by,
                      p1_schema: Schema) -> Optional[pp.PhysicalPlan]:
    """Collapse partial-Agg ← Project* ← Filter* ← Scan into a fused device
    fragment, substituting intermediate projections so every expression is
    over source columns."""
    from ..aggs import split_agg_expr
    from ..logical.optimizer import combine_conjuncts, substitute_columns
    chain = []
    n = pchild
    while isinstance(n, (pp.Project, pp.Filter)):
        chain.append(n)
        n = n.children[0]
    # chain may be empty: fusing projection-exprs + agg over a bare source
    # still collapses to one program (scan-level filters prune earlier)
    if not isinstance(n, (pp.ScanSource, pp.InMemorySource)):
        return None
    mapping = {c: col(c) for c in n.schema().column_names}
    preds = []
    for node2 in reversed(chain):
        if isinstance(node2, pp.Filter):
            preds.append(substitute_columns(node2.predicate, mapping))
        else:
            try:
                mapping = {e.name(): substitute_columns(e._unalias(), mapping)
                           for e in node2.exprs}
            except Exception:
                return None
    try:
        gb2 = [substitute_columns(e._unalias(), mapping).alias(e.name())
               for e in group_by]
        aggs2 = []
        for a in partial_aggs:
            op, child, name, params = split_agg_expr(a)
            if op not in ("sum", "mean", "min", "max", "count", "stddev",
                          "var", "any_value", "bool_and", "bool_or"):
                return None
            if op == "count" and params and params[0] != "valid":
                return None
            c2 = substitute_columns(child, mapping) if child is not None \
                else None
            new_inner = Expression("agg." + op,
                                   (c2,) if c2 is not None else (), params)
            aggs2.append(new_inner.alias(name))
        pred = combine_conjuncts(preds) if preds else None
        # all agg outputs must be decodable without a dictionary
        for a in aggs2:
            f = p1_schema[a.name()]
            if f.dtype.device_repr() is None or f.dtype.is_string() \
                    or f.dtype.is_binary():
                return None
        # string group keys must be source-column passthroughs (their
        # dictionary travels from the encoded input)
        for g in gb2:
            f = p1_schema[g.name()]
            if (f.dtype.is_string() or f.dtype.is_binary()) \
                    and g._unalias().op != "col":
                return None
    except Exception:
        return None
    return pp.DeviceFragmentAgg(n, pred, aggs2, gb2, p1_schema, "partial")


def _agg_schema(group_by, aggs, input_schema: Schema) -> Schema:
    fields = [e.to_field(input_schema) for e in group_by]
    fields += [e.to_field(input_schema) for e in aggs]
    return Schema(fields)


def _split_aggs(node: lp.Aggregate, in_schema: Schema):
    """populate_aggregation_stages: per-agg partial exprs, final exprs over
    partial outputs, and the final projection."""
    partials: List[Expression] = []
    finals: List[Expression] = []
    projs: List[Expression] = []
    seen_partial = {}

    def add_partial(e: Expression) -> str:
        k = e._key()
        if k in seen_partial:
            return seen_partial[k]
        nm = e.name() if e.op == "alias" else f"__p{len(partials)}__{e.name()}"
        seen_partial[k] = nm
        partials.append(e.alias(nm) if e.name() != nm else e)
        return nm

    for e in node.aggs:
        out_name = e.name()
        inner = e._unalias()
        op = inner.op[4:]
        child = inner.args[0] if inner.args else None
        out_field = e.to_field(in_schema)
        if op in ("sum", "min", "max", "any_value", "bool_and", "bool_or",
                  "list", "concat"):
            p = add_partial(Expression(inner.op, inner.args, inner.params)
                            .alias(out_name))
            f_op = {"sum": "agg.sum", "min": "agg.min", "max": "agg.max",
                    "any_value": "agg.any_value", "bool_and": "agg.bool_and",
                    "bool_or": "agg.bool_or", "list": "agg.concat",
                    "concat": "agg.concat"}[op]
            finals.append(Expression(f_op, (col(p),),
                                     inner.params).alias(out_name))
            projs.append(col(out_name))
        elif op == "count":
            p = add_partial(inner.alias(out_name))
            finals.append(col(p).sum().alias(out_name))
            projs.append(col(out_name).cast(DataType.uint64()).alias(out_name))
        elif op == "mean":
            s = add_partial(child.sum().alias(f"__sum_{out_name}__"))
            c = add_partial(child.count().alias(f"__count_{out_name}__"))
            fs = f"__fsum_{out_name}__"
            fc = f"__fcount_{out_name}__"
            finals.append(col(s).sum().alias(fs))
            finals.append(col(c).sum().alias(fc))
            projs.append((col(fs).cast(DataType.float64())
                          / col(fc).cast(DataType.float64())).alias(out_name))
        elif op in ("stddev", "var"):
            s = add_partial(child.sum().alias(f"__sum_{out_name}__"))
            c = add_partial(child.count().alias(f"__count_{out_name}__"))
            s2 = add_partial((child * child).sum().alias(f"__sumsq_{out_name}__"))
            fs, fc, fs2 = (f"__fs_{out_name}__", f"__fc_{out_name}__",
                           f"__fs2_{out_name}__")
            finals.append(col(s).sum().alias(fs))
            finals.append(col(c).sum().alias(fc))
            finals.append(col(s2).sum().alias(fs2))
            mean = col(fs).cast(DataType.float64()) / col(fc).cast(DataType.float64())
            var = (col(fs2).cast(DataType.float64())
                   / col(fc).cast(DataType.float64())) - mean * mean
            projs.append((var.sqrt() if op == "stddev" else var).alias(out_name))
        else:
            raise NotImplementedError(f"agg split for {op}")
    return partials, finals, projs
