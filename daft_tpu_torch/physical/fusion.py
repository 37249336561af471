"""FusedRegion planning: whole-query device compilation.

The port's copy of ``daft_tpu/physical/fusion.py``. The translated
physical plan runs operator at a time, and every operator boundary is a
host round trip even when both sides run on the card. This pass walks
the plan and grows *fusion regions*, maximal device-eligible operator
chains, into :class:`plan.FusedRegion` nodes that the executor runs as
ONE torch program per morsel (``device/fragment.py``'s region programs),
so the region's intermediates never come back to the host.

Three region grammars:

- **chain**: ``Filter*/Project*`` over a source — predicate, projection
  and a compaction in the program, one packed fetch of the survivors.
- **topk**: a chain with a ``TopN`` tail — the argsort runs in the
  program and only a static top-k bucket comes back.
- **join_agg**: partial ``Aggregate`` ← ``Project*/Filter*`` ← inner
  single-key broadcast ``HashJoin`` ← chain-over-source probe side — the
  build side is encoded and key-sorted once and stays on the card; each
  probe morsel joins, projects and partially aggregates in one dispatch.

The planner only *proposes* regions: the cost model admits each morsel
(``costmodel.fusion_wins``), and every region keeps its original subtree
as ``fallback``. ``DAFT_TORCH_FUSION=0`` (or ``ExecutionConfig.fusion``)
disables the pass, ``1`` admits every morsel, ``auto`` (the default)
prices each; ``DAFT_TORCH_FUSION_MAX_OPS`` caps how many operators one
region absorbs.
"""

from __future__ import annotations

from typing import List, Optional

from ..expressions import Expression, col
from ..schema import Schema
from . import plan as pp

#: static top-k tail bound: past this the "tiny bucket transfer" premise
#: is gone and the external sort is the right tool anyway
TOPK_MAX_LIMIT = 8192

#: partial-agg ops the region compiler's grouped reduction supports
#: (``runtime._DEVICE_AGGS``, the fused-agg whitelist)
_REGION_AGGS = ("sum", "mean", "min", "max", "count", "stddev", "var",
                "any_value", "bool_and", "bool_or")


def fusion_mode(cfg=None) -> str:
    """``auto`` | ``1`` | ``0`` (normalized)."""
    from .. import knobs
    if cfg is not None:
        mode = str(getattr(cfg, "fusion", "auto") or "auto")
    else:
        mode = "auto"
    env = knobs.env_raw("DAFT_TORCH_FUSION")
    if env is not None:
        mode = env
    mode = mode.strip().lower()
    if mode in ("0", "off", "false"):
        return "0"
    if mode in ("1", "force", "true"):
        return "1"
    return "auto"


def max_region_ops(cfg=None) -> int:
    from .. import knobs
    env = knobs.env_opt_int("DAFT_TORCH_FUSION_MAX_OPS")
    if env is not None:
        return max(int(env), 2)
    if cfg is not None:
        return max(int(getattr(cfg, "fusion_max_ops", 8) or 8), 2)
    return 8


def fuse_regions(plan: pp.PhysicalPlan, cfg) -> pp.PhysicalPlan:
    """Rewrite the translated physical plan, replacing eligible subtrees
    with FusedRegion nodes. Identity-memoized so SHARED subplans (translate's
    semantic-id dedup) stay shared after the rewrite."""
    if fusion_mode(cfg) == "0":
        return plan
    from ..device import backend
    if backend.host_tier_only():
        return plan
    memo: dict = {}
    return _walk(plan, cfg, memo)


def _walk(node: pp.PhysicalPlan, cfg, memo: dict) -> pp.PhysicalPlan:
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    region = _match(node, cfg)
    out = region if region is not None else node
    if region is None:
        # only descend when the node itself did not fuse: a region's
        # fallback keeps the ORIGINAL children untouched
        node.children = [_walk(c, cfg, memo) for c in node.children]
    memo[id(node)] = out
    return out


def _match(node: pp.PhysicalPlan, cfg) -> Optional[pp.FusedRegion]:
    # shared subtrees materialize once and stream to every consumer —
    # folding one into a region would re-execute it per consumer
    if getattr(node, "shared_consumers", 1) > 1:
        return None
    if isinstance(node, pp.TopN):
        return _match_topk(node, cfg)
    if isinstance(node, (pp.Project, pp.Filter)):
        return _match_chain(node, cfg)
    if isinstance(node, pp.Aggregate):
        return _match_join_agg(node, cfg)
    return None


# ------------------------------------------------------------------ chains

def _collect_chain(n: pp.PhysicalPlan, max_ops: int):
    """Walk a Filter*/Project* chain down to a source. Returns
    ``(source, chain_top_down)`` or None. Stops at shared interior nodes
    (materialize-once contract) and at the region-size cap."""
    chain: List[pp.PhysicalPlan] = []
    while isinstance(n, (pp.Project, pp.Filter)) \
            and getattr(n, "shared_consumers", 1) <= 1 \
            and len(chain) < max_ops:
        chain.append(n)
        n = n.children[0]
    if not isinstance(n, (pp.ScanSource, pp.InMemorySource)):
        return None
    return n, chain


def _substitute_chain(source, chain, out_names: List[str]):
    """Fold a top-down Project/Filter chain into (exprs, predicate) over
    SOURCE columns (the fused fragment's substitution). Returns
    ``(exprs, predicate)`` or None when an expression resists
    substitution."""
    from ..logical.optimizer import combine_conjuncts, substitute_columns
    mapping = {c: col(c) for c in source.schema().column_names}
    preds = []
    try:
        for nd in reversed(chain):
            if isinstance(nd, pp.Filter):
                preds.append(substitute_columns(nd.predicate, mapping))
            else:
                mapping = {e.name(): substitute_columns(e._unalias(), mapping)
                           for e in nd.exprs}
        exprs = [mapping[nm].alias(nm) if nm in mapping else None
                 for nm in out_names]
        if any(e is None for e in exprs):
            return None
        pred = combine_conjuncts(preds) if preds else None
    except Exception:
        return None
    return exprs, pred


def _decodable(field, expr: Expression) -> bool:
    """Region outputs must come back through the packed transfer: device
    repr, or a string/binary passthrough riding its source dictionary."""
    from ..device import runtime as drt
    if field.dtype.is_string() or field.dtype.is_binary():
        return drt._string_out_source(expr) is not None
    return field.dtype.device_repr() is not None


def _match_chain(node, cfg) -> Optional[pp.FusedRegion]:
    found = _collect_chain(node, max_region_ops(cfg))
    if found is None:
        return None
    source, chain = found
    # a single projection/filter is the per-operator path already — a
    # region only pays off when it ELIMINATES a stage boundary
    if len(chain) < 2:
        return None
    out_names = node.schema().column_names
    sub = _substitute_chain(source, chain, out_names)
    if sub is None:
        return None
    exprs, pred = sub
    schema = node.schema()
    try:
        for e, nm in zip(exprs, out_names):
            if not _decodable(schema[nm], e):
                return None
    except Exception:
        return None
    names = tuple(type(nd).__name__.lower() for nd in chain) + ("scan",)
    return pp.FusedRegion("chain", source, exprs, pred, schema,
                          fallback=node, fused_ops=names)


def _match_topk(node: pp.TopN, cfg) -> Optional[pp.FusedRegion]:
    if not node.sort_by or node.limit is None \
            or not (0 < node.limit <= TOPK_MAX_LIMIT):
        return None
    found = _collect_chain(node.children[0], max_region_ops(cfg) - 1)
    if found is None:
        return None
    source, chain = found
    # unlike plain chains a bare TopN-over-scan already saves the full-
    # table transfer (argsort in-program, static k bucket out), so an
    # empty chain still fuses
    out_names = node.schema().column_names
    sub = _substitute_chain(source, chain, out_names)
    if sub is None:
        return None
    exprs, pred = sub
    sub_keys = _substitute_chain(source, chain,
                                 [e.name() for e in node.sort_by])
    if sub_keys is None:
        return None
    sort_exprs = sub_keys[0]
    schema = node.schema()
    try:
        for e, nm in zip(exprs, out_names):
            if not _decodable(schema[nm], e):
                return None
        src_schema = source.schema()
        for e in sort_exprs:
            f = e.to_field(src_schema)
            if f.dtype.is_string() or f.dtype.is_binary():
                from ..device import runtime as drt
                if drt._string_out_source(e) is None:
                    return None
            elif f.dtype.device_repr() is None:
                return None
    except Exception:
        return None
    names = ("topn",) + tuple(type(nd).__name__.lower() for nd in chain) \
        + ("scan",)
    return pp.FusedRegion(
        "topk", source, exprs, pred, schema, fallback=node, fused_ops=names,
        sort_by=tuple(sort_exprs),
        descending=tuple(bool(d) for d in node.descending),
        nulls_first=tuple(bool(x) for x in node.nulls_first),
        limit=int(node.limit))


# ---------------------------------------------------------------- join_agg

def _match_join_agg(node: pp.Aggregate, cfg) -> Optional[pp.FusedRegion]:
    """Partial-Agg ← Project*/Filter* ← inner single-key broadcast
    HashJoin ← chain-over-scan probe. The build subplan executes on host
    (it is small — that is what made it broadcast) and is encoded ONCE;
    probe morsels stream through the single fused program."""
    from ..aggs import split_agg_expr
    from ..logical.optimizer import combine_conjuncts, substitute_columns
    if node.mode != "partial" or not node.group_by:
        return None
    max_ops = max_region_ops(cfg)
    mid: List[pp.PhysicalPlan] = []
    n = node.children[0]
    while isinstance(n, (pp.Project, pp.Filter)) \
            and getattr(n, "shared_consumers", 1) <= 1 \
            and len(mid) < max_ops:
        mid.append(n)
        n = n.children[0]
    if not isinstance(n, pp.HashJoin) or n.how != "inner" \
            or n.strategy != "broadcast_right" \
            or getattr(n, "shared_consumers", 1) > 1:
        return None
    if len(n.left_on) != 1 or len(n.right_on) != 1:
        return None
    join = n
    found = _collect_chain(join.children[0], max_ops)
    if found is None:
        return None
    source, probe_chain = found
    if len(mid) + len(probe_chain) + 3 > max_ops:
        return None
    build = join.children[1]

    # join keys must be passthrough int-ish columns: the in-program join
    # compares raw planes, and string codes are NOT comparable across two
    # independently encoded tables
    src_schema = source.schema()
    build_schema = build.schema()

    def _key_col(e: Expression, schema: Schema) -> Optional[str]:
        inner = e._unalias()
        if inner.op != "col":
            return None
        nm = inner.params[0]
        try:
            dt = schema[nm].dtype
        except Exception:
            return None
        if dt.is_string() or dt.is_binary() or dt.device_repr() is None:
            return None
        return nm

    # probe-side join key substituted through the probe chain
    sub_key = _substitute_chain(source, probe_chain,
                                [e.name() for e in join.left_on])
    if sub_key is None:
        return None
    lkey = _key_col(sub_key[0][0], src_schema)
    rkey = _key_col(join.right_on[0], build_schema)
    if lkey is None or rkey is None:
        return None

    # probe chain folds to (probe exprs, probe predicate) over source cols.
    # Joined-plane namespace = probe chain outputs ∪ build columns; names
    # must be disjoint or the substitution would be ambiguous.
    probe_out = join.children[0].schema().column_names
    build_out = build_schema.column_names
    if set(probe_out) & set(build_out):
        return None
    # the program's joined plane dict is keyed by RAW column name over
    # src ∪ build schemas; a shared name would alias two planes (and
    # break the needs-cols split in get_fused_join_agg) — decline
    if set(src_schema.column_names) & set(build_out):
        return None
    sub_probe = _substitute_chain(source, probe_chain, probe_out)
    if sub_probe is None:
        return None
    probe_exprs, probe_pred = sub_probe
    probe_map = {nm: e._unalias() for nm, e in zip(probe_out, probe_exprs)}
    # every probe-side joined column must be a source passthrough: the
    # program gathers RAW source planes by the join's left index, so a
    # computed projection would be lost (computed cols ride the mid-chain
    # substitution below instead, evaluated AFTER the gather)
    for nm, e in probe_map.items():
        if e.op != "col":
            return None

    # mid chain (between join and agg) folds over the joined namespace
    mapping = {nm: col(probe_map[nm].params[0]) for nm in probe_out}
    mapping.update({nm: col(nm) for nm in build_out})
    post_preds: List[Expression] = []
    try:
        for nd in reversed(mid):
            if isinstance(nd, pp.Filter):
                post_preds.append(substitute_columns(nd.predicate, mapping))
            else:
                mapping = {e.name(): substitute_columns(e._unalias(), mapping)
                           for e in nd.exprs}
        gb2 = [substitute_columns(e._unalias(), mapping).alias(e.name())
               for e in node.group_by]
        aggs2 = []
        for a in node.aggs:
            op, child, name, params = split_agg_expr(a)
            if op not in _REGION_AGGS:
                return None
            if op == "count" and params and params[0] != "valid":
                return None
            c2 = substitute_columns(child, mapping) if child is not None \
                else None
            inner = Expression("agg." + op, (c2,) if c2 is not None else (),
                               params)
            aggs2.append(inner.alias(name))
        post_pred = combine_conjuncts(post_preds) if post_preds else None
    except Exception:
        return None

    # outputs must decode without per-table dictionaries: string planes
    # gathered across the join would need dictionary routing the packed
    # block does not carry — decline them (q3's keys are ints/dates)
    p1_schema = node.schema()
    try:
        for g in gb2:
            f = p1_schema[g.name()]
            if f.dtype.is_string() or f.dtype.is_binary() \
                    or f.dtype.device_repr() is None:
                return None
        for a in aggs2:
            f = p1_schema[a.name()]
            if f.dtype.is_string() or f.dtype.is_binary() \
                    or f.dtype.device_repr() is None:
                return None
    except Exception:
        return None
    names = ("aggregate",) \
        + tuple(type(nd).__name__.lower() for nd in mid) + ("hashjoin",) \
        + tuple(type(nd).__name__.lower() for nd in probe_chain) + ("scan",)
    region = pp.FusedRegion(
        "join_agg", source, [], probe_pred, p1_schema, fallback=node,
        fused_ops=names, build=build,
        left_on=(col(lkey),), right_on=(col(rkey),),
        aggs=tuple(aggs2), group_by=tuple(gb2), mode="partial")
    region.post_predicate = post_pred
    # the original (pre-fusion) estimates ride along for the gate
    region.group_ndv = getattr(node, "group_ndv", None)
    region.group_rows_est = getattr(node, "group_rows_est", None)
    return region
