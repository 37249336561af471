"""Subquery expressions and their unnest-to-join rewrites.

Reference: ``src/daft-dsl/src/expr/mod.rs:213-292`` models scalar
subqueries, ``InSubquery`` and ``Exists`` as first-class ``Expr`` variants;
``src/daft-logical-plan/src/optimization/rules/unnest_subquery.rs`` rewrites
them into joins. This module (the port's copy of
``daft_tpu/logical/subquery.py``) is designed around the DataFrame
builder instead of a plan-to-plan rule: the SQL planner
parses subqueries into three expression node kinds —

- ``Expression("subquery", (), (info,))``       — scalar subquery
- ``Expression("in_subquery", (lhs,), (info,))`` — ``lhs IN (SELECT …)``
- ``Expression("exists", (), (info,))``          — ``EXISTS (SELECT …)``

— and :func:`apply_where` realizes them while applying a WHERE clause:

- EXISTS / NOT EXISTS      → semi / anti join on the correlation keys
  (uncorrelated: on a constant key against the subquery limited to 1 row)
- IN / NOT IN (SELECT …)   → semi / anti join on (lhs = select item) plus
  correlation keys. NOT IN keeps anti-join semantics: SQL's "any NULL in
  the subquery ⇒ empty result" edge is not modeled (documented caveat,
  same pragmatic rewrite the reference's optimizer performs).
- scalar, uncorrelated     → cross join of the 1-row aggregate
- scalar, correlated       → GROUP BY correlation keys + LEFT JOIN; a
  missing group yields NULL, so comparisons against it are false — SQL's
  empty-subquery-scalar semantics.

Correlation is equality-only (``inner_expr = outer_expr``), the same scope
the reference's rule handles; anything else raises NotImplementedError.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..expressions.expressions import Expression, col, lit

_uid = itertools.count()


class SubqueryInfo:
    """A parsed subquery, pre-unnesting.

    ``df``            — the inner DataFrame: FROM/joins applied, plain
                        (uncorrelated) WHERE conjuncts applied, and — when
                        ``corr`` is empty — fully projected/aggregated.
    ``corr``          — [(inner_expr, outer_expr)] equality correlation
                        pairs extracted from the inner WHERE.
    ``deferred_aggs`` — when correlated and the select list aggregates,
                        the un-applied select expressions (the rewrite
                        groups them by the correlation keys instead).
    ``value_cols``    — output column names of ``df`` (used when the
                        subquery was fully built by the normal path).
    """

    def __init__(self, df, corr, deferred_aggs, value_cols, resid=None,
                 deferred_group_by=None):
        self.df = df
        self.corr = list(corr)
        self.deferred_aggs = list(deferred_aggs or [])
        self.value_cols = list(value_cols or [])
        # correlated NON-equality conjuncts (outer refs as ``outer_col``
        # markers): realized by the rowid-join rewrite in _semi_anti
        self.resid = list(resid or [])
        # the subquery's OWN GROUP BY keys when its aggregation is
        # deferred: the rewrite groups by correlation keys ∪ these
        self.deferred_group_by = list(deferred_group_by or [])

    def __repr__(self):
        return (f"SubqueryInfo(corr={len(self.corr)}, "
                f"deferred={len(self.deferred_aggs)})")


def scalar_expr(info: SubqueryInfo) -> Expression:
    return Expression("subquery", (), (info,))


def in_expr(lhs: Expression, info: SubqueryInfo) -> Expression:
    return Expression("in_subquery", (lhs,), (info,))


def exists_expr(info: SubqueryInfo) -> Expression:
    return Expression("exists", (), (info,))


# ------------------------------------------------------------------ utils

def split_conjuncts(e: Expression) -> List[Expression]:
    u = e._unalias()
    if u.op == "and":
        return split_conjuncts(u.args[0]) + split_conjuncts(u.args[1])
    return [e]


def and_all(es: List[Expression]) -> Expression:
    out = es[0]
    for e in es[1:]:
        out = out & e
    return out


def free_columns(e: Expression) -> set:
    """Column names referenced by e (not descending into subquery infos)."""
    return set(e.column_names())


def contains_subquery(e: Expression) -> bool:
    if e.op in ("subquery", "in_subquery", "exists"):
        return True
    return any(contains_subquery(a) for a in e.args)


def _replace_node(e: Expression, target: Expression,
                  replacement: Expression) -> Expression:
    if e is target:
        return replacement
    if not e.args:
        return e
    return e.with_children(
        [_replace_node(a, target, replacement) for a in e.args])


# -------------------------------------------------------------- rewrites

def _inner_value_expr(info: SubqueryInfo) -> Tuple[object, Expression]:
    """The subquery's single output as (df, value expression over df)."""
    if info.deferred_aggs:
        if len(info.deferred_aggs) != 1:
            raise NotImplementedError(
                "correlated subquery must select exactly one expression")
        return info.df, info.deferred_aggs[0]
    if len(info.value_cols) != 1:
        raise NotImplementedError(
            f"subquery must select exactly one column, got "
            f"{info.value_cols}")
    return info.df, col(info.value_cols[0])


def _realize_deferred(info: SubqueryInfo):
    """Materialize a correlated AGGREGATING subquery: group the inner frame
    by correlation keys ∪ its own GROUP BY keys, apply the deferred select
    aggregate, and project (correlation keys, value). Returns
    (df, corr_key_names, value_name). The GROUP BY keys fall away after
    grouping — each (corr, group) cell contributes one candidate row."""
    rdf, val = _inner_value_expr(info)
    name = f"__subq{next(_uid)}__"
    key_names, keys = [], []
    for inner, _ in info.corr:
        kn = f"__subqk{next(_uid)}__"
        key_names.append(kn)
        keys.append(inner.alias(kn))
    extra = [g.alias(f"__subqg{next(_uid)}__")
             for g in info.deferred_group_by]
    agg = rdf.groupby(*(keys + extra)).agg(val.alias(name))
    agg = agg.select(*([col(k) for k in key_names] + [col(name)]))
    return agg, key_names, name


def _semi_anti(df, info: SubqueryInfo, anti: bool,
               lhs: Optional[Expression] = None):
    """EXISTS/IN → semi join; NOT variants → anti join."""
    if info.resid:
        return _semi_anti_residual(df, info, anti, lhs)
    how = "anti" if anti else "semi"
    if lhs is not None and info.deferred_aggs:
        # lhs IN (SELECT agg(x) … WHERE corr [GROUP BY g]): aggregate
        # first (per corr ∪ g cell), then semi/anti join on
        # (corr keys, aggregated value)
        rdf, key_names, vn = _realize_deferred(info)
        return df.join(rdf,
                       left_on=[o for _, o in info.corr] + [lhs],
                       right_on=[col(k) for k in key_names] + [col(vn)],
                       how=how)
    left_on = [o for _, o in info.corr]
    right_on = [i for i, _ in info.corr]
    rdf = info.df
    if lhs is not None:
        rdf2, val = _inner_value_expr(info)
        left_on = left_on + [lhs]
        right_on = right_on + [val]
        rdf = rdf2
    if not left_on:
        # uncorrelated EXISTS: does the subquery have any row at all?
        k = f"__exists{next(_uid)}__"
        rdf = rdf.limit(1).select(lit(1).alias(k))
        df2 = df.with_column(k, lit(1))
        out = df2.join(rdf, left_on=[col(k)], right_on=[col(k)], how=how)
        return out.exclude(k) if hasattr(out, "exclude") \
            else out.select(*[col(c) for c in df.column_names])
    return df.join(rdf, left_on=left_on, right_on=right_on, how=how)


def _semi_anti_residual(df, info: SubqueryInfo, anti: bool,
                        lhs: Optional[Expression]):
    """EXISTS/IN with non-equality correlated conjuncts (TPC-DS Q16/Q94's
    ``EXISTS (… WHERE inner.k = outer.k AND inner.wh <> outer.wh)``):

    1. tag the outer frame with a monotonic rowid,
    2. inner-join it to the subquery on the EQUALITY correlation keys
       (inner columns renamed first — self-join-safe),
    3. apply the residual predicates over the joined frame,
    4. semi/anti-join the tagged outer on the surviving rowids.

    The reference's unnest rule stops at equality correlation; this
    rewrite is the standard decorrelation via row identity."""
    if info.deferred_aggs:
        raise NotImplementedError(
            "aggregating subquery with non-equality correlation")
    rid = f"__sqrid{next(_uid)}__"
    tagged = df.add_monotonically_increasing_id(rid)
    rdf = info.df
    # rename every inner column so outer references never collide (the
    # motivating queries self-join the same table)
    ren = {c: f"__sqr{next(_uid)}_{c}__" for c in rdf.column_names}
    rdf = rdf.select(*[col(c).alias(n) for c, n in ren.items()])

    def fix_inner(e: Expression) -> Expression:
        if e.op == "col":
            if e.params[0] not in ren:
                # a silent fall-through here would resolve against the
                # OUTER frame and compare a column to itself
                raise ValueError(
                    f"residual-correlation rewrite: inner column "
                    f"{e.params[0]!r} missing from the subquery's "
                    f"projection {sorted(ren)}")
            return col(ren[e.params[0]])
        if e.op == "outer_col":
            return col(e.params[0])
        if not e.args:
            return e
        return e.with_children([fix_inner(a) for a in e.args])

    left_on = [o for _, o in info.corr]
    right_on = [fix_inner(i) for i, _ in info.corr]
    if lhs is not None:
        rdf2, val = _inner_value_expr(info)
        # re-derive the value expression over the renamed frame
        left_on = left_on + [lhs]
        right_on = right_on + [fix_inner(val)]
    joined = tagged.join(rdf, left_on=left_on, right_on=right_on,
                         how="inner") if left_on else \
        tagged.join(rdf, how="cross")
    joined = joined.where(and_all([fix_inner(r) for r in info.resid]))
    matched = joined.select(col(rid)).distinct()
    how = "anti" if anti else "semi"
    out = tagged.join(matched, left_on=[col(rid)], right_on=[col(rid)],
                      how=how)
    return out.exclude(rid)


def _attach_scalar(df, node: Expression) -> Tuple[object, str]:
    """Join the scalar subquery's value onto df under a unique column name;
    returns (new df, value column name)."""
    info: SubqueryInfo = node.params[0]
    name = f"__subq{next(_uid)}__"
    if info.corr:
        if not info.deferred_aggs:
            raise NotImplementedError(
                "correlated scalar subquery must aggregate (e.g. "
                "SELECT avg(x) …); a bare correlated column select has no "
                "single-value semantics the rewrite can preserve")
        agg, key_names, vn = _realize_deferred(info)
        outers = [outer for _, outer in info.corr]
        if info.deferred_group_by:
            # GROUP BY inside the subquery can yield several rows per
            # correlation key; SQL's scalar context requires exactly one —
            # collapse with a runtime cardinality guard (the grouped LEFT
            # JOIN below would otherwise silently duplicate outer rows,
            # which is what the reference's UnnestScalarSubquery does).
            # SQL evaluates the subquery PER OUTER ROW, so the guard only
            # applies to correlation keys some outer row actually holds —
            # semi-join down to those first.
            ref_keys = df.select(
                *[o.alias(k) for o, k in zip(outers, key_names)]).distinct()
            agg = agg.join(ref_keys,
                           left_on=[col(k) for k in key_names],
                           right_on=[col(k) for k in key_names], how="semi")
            agg = _guard_one_per_key(agg, key_names, vn)
        agg = agg.select(*([col(k) for k in key_names] + [col(vn).alias(name)]))
        out = df.join(agg, left_on=outers,
                      right_on=[col(k) for k in key_names], how="left")
        return out, name
    # uncorrelated: the inner df is fully built and 1-col; SQL requires it
    # to be 1-ROW too. A provably-single-row plan (bare aggregate, LIMIT 1)
    # cross-joins directly; anything else gets a runtime cardinality guard
    # so a multi-row subquery raises instead of silently duplicating every
    # outer row (the reference's UnnestScalarSubquery duplicates silently).
    rdf, val = _inner_value_expr(info)
    rdf = rdf.select(val.alias(name))
    if not _provably_single_row(rdf._builder._plan):
        rdf = _guard_single_row(rdf, name)
    return df.join(rdf, how="cross"), name


def _provably_single_row(plan) -> bool:
    """True when the plan yields EXACTLY one row by construction: a global
    (no-groupby) Aggregate, optionally under projections/sorts (which
    preserve cardinality). LIMIT 1 does NOT qualify — it can yield zero
    rows, and a 0-row cross join would silently drop every outer row where
    SQL wants a NULL scalar (the guard emits that NULL)."""
    from . import plan as lp
    node = plan
    while isinstance(node, (lp.Project, lp.Sort)):
        node = node.children[0]
    return isinstance(node, lp.Aggregate) and not node.group_by


def _guard_one_per_key(agg, key_names: List[str], vn: str):
    """Collapse a (keys…, value) frame to one row per key tuple, raising
    SQL's scalar-cardinality error at execution time when any key holds
    more than one row."""
    from ..datatype import DataType
    from ..udf import udf
    dtype = agg.schema()[vn].dtype
    cnt = f"__subqcnt{next(_uid)}__"
    one = agg.groupby(*[col(k) for k in key_names]).agg(
        col(vn).any_value().alias(vn), col(vn).count("all").alias(cnt))

    @udf(return_dtype=dtype)
    def _check_one(vals, counts):
        if any(c is not None and c > 1 for c in counts.to_pylist()):
            raise ValueError(
                "correlated scalar subquery produced more than one row "
                "for an outer row (its GROUP BY is finer than the "
                "correlation)")
        return vals.to_pylist()

    return one.select(*([col(k) for k in key_names]
                        + [_check_one(col(vn), col(cnt)).alias(vn)]))


def _guard_single_row(rdf, name: str):
    """Collapse to one row carrying (value, row count), then project a
    checked value: count > 1 raises SQL's scalar-cardinality error at
    execution time."""
    from ..datatype import DataType
    from ..udf import udf
    dtype = rdf.schema()[name].dtype
    cnt = f"__subqcnt{next(_uid)}__"
    one = rdf.agg(col(name).agg_list().alias(name),
                  col(name).count("all").alias(cnt))

    @udf(return_dtype=dtype)
    def _check_single(vals, counts):
        # an empty subquery relation can surface its count as NULL through
        # the exchange path (same guard _check_one already carries)
        n = (counts.to_pylist()[0] if len(counts) else 0) or 0
        if n > 1:
            raise ValueError(
                f"scalar subquery produced {n} rows, expected at most 1")
        lst = vals.to_pylist()[0] if len(vals) else []
        return [lst[0] if lst else None]

    return one.select(_check_single(col(name), col(cnt)).alias(name))


def realize_scalars(df, e: Expression) -> Tuple[object, Expression]:
    """Attach every scalar subquery nested in ``e`` onto ``df`` (cross
    join for uncorrelated, grouped left join for correlated) and return
    (new df, e with each subquery node replaced by its attached column).
    The single entry point for scalar realization — WHERE conjuncts, the
    SELECT list, and post-aggregation projections all route here."""
    while True:
        node = _find_scalar(e)
        if node is None:
            return df, e
        df, name = _attach_scalar(df, node)
        e = _replace_node(e, node, col(name))


def _rewrite_conjunct(df, conj: Expression) -> Tuple[Optional[Expression],
                                                     object]:
    """Realize the subquery nodes of one conjunct against df. Returns
    (residual predicate or None, new df)."""
    u = conj._unalias()
    neg = False
    while u.op == "not":
        neg = not neg
        u = u.args[0]._unalias()
    if u.op == "exists":
        return None, _semi_anti(df, u.params[0], anti=neg)
    if u.op == "in_subquery":
        if contains_subquery(u.args[0]):
            raise NotImplementedError("subquery inside IN's left operand")
        return None, _semi_anti(df, u.params[0], anti=neg, lhs=u.args[0])
    # EXISTS/IN nested inside the conjunct (a disjunction like TPC-DS
    # Q10/Q35's ``EXISTS (…) OR EXISTS (…)``) → mark joins
    df, conj = realize_marks(df, conj)
    # scalar subqueries nested anywhere in the conjunct
    df, out = realize_scalars(df, conj)
    return out, df


def _attach_mark(df, node: Expression) -> Tuple[object, Expression]:
    """EXISTS/IN nested in a boolean expression → a mark (boolean) column:
    left-join the outer frame onto the DISTINCT correlation/value keys of
    the subquery tagged TRUE; unmatched rows coalesce to FALSE (exact for
    EXISTS — it never yields NULL). IN-subquery marks route to
    :func:`_attach_in_mark`, which preserves SQL's three-valued logic
    (NULL lhs / NULL-bearing sets yield NULL, visible under negation of
    the enclosing disjunction)."""
    info: SubqueryInfo = node.params[0]
    lhs = node.args[0] if node.op == "in_subquery" else None
    if info.resid:
        raise NotImplementedError(
            "EXISTS with non-equality correlation inside a disjunction")
    if info.deferred_aggs:
        raise NotImplementedError(
            "aggregating subquery inside a disjunction")
    if lhs is not None:
        rdf2, val = _inner_value_expr(info)
        return _attach_in_mark(df, info, lhs, rdf2, val)
    mark = f"__mark{next(_uid)}__"
    left_on = [o for _, o in info.corr]
    right_on = [i for i, _ in info.corr]
    rdf = info.df
    if not left_on:
        # uncorrelated EXISTS in a disjunction: single TRUE/absent flag
        k = f"__markk{next(_uid)}__"
        flag = rdf.limit(1).select(lit(1).alias(k), lit(True).alias(mark))
        out = df.with_column(k, lit(1)).join(
            flag, left_on=[col(k)], right_on=[col(k)], how="left")
        return out.exclude(k), col(mark).fill_null(lit(False))
    knames = []
    keyed_cols = []
    for e in right_on:
        kn = f"__markk{next(_uid)}__"
        knames.append(kn)
        keyed_cols.append(e.alias(kn))
    keyed = rdf.select(*keyed_cols).distinct() \
        .with_column(mark, lit(True))
    out = df.join(keyed, left_on=left_on,
                  right_on=[col(k) for k in knames], how="left")
    return out, col(mark).fill_null(lit(False))


def _attach_in_mark(df, info: SubqueryInfo, lhs: Expression, rdf,
                    val: Expression) -> Tuple[object, Expression]:
    """Null-aware mark for ``lhs IN (SELECT val …)`` nested in a boolean
    expression. SQL three-valued semantics, exactly:

      TRUE  — some element of the (correlation-filtered) set equals lhs
      FALSE — the set is empty, or nothing matches and neither lhs nor
              the set contains NULL
      NULL  — no match, set non-empty, and lhs IS NULL or set has NULL

    Realized as two left joins: one on (corr keys + value) for the match
    mark, one on corr keys alone carrying per-group (row count, has-NULL)
    so unmatched rows can distinguish FALSE from NULL. ``fill_null(False)``
    alone collapses the NULL outcomes to FALSE, which flips rows kept by a
    negated disjunction like ``NOT (p OR x IN (SELECT …))``."""
    mark = f"__mark{next(_uid)}__"
    gnull = f"__markn{next(_uid)}__"
    gcnt = f"__markc{next(_uid)}__"
    vn = f"__markv{next(_uid)}__"
    left_keys = [o for _, o in info.corr]
    inner_keys = [i for i, _ in info.corr]

    def _aliased(exprs):
        names = [f"__markk{next(_uid)}__" for _ in exprs]
        return names, [e.alias(n) for e, n in zip(exprs, names)]

    knames, keyed_cols = _aliased(inner_keys + [val])
    keyed = rdf.select(*keyed_cols).distinct().with_column(mark, lit(True))
    out = df.join(keyed, left_on=left_keys + [lhs],
                  right_on=[col(k) for k in knames], how="left")

    gnames, gcols = _aliased(inner_keys)
    ginfo = rdf.select(*(gcols + [val.alias(vn)]))
    if gnames:
        ginfo = ginfo.groupby(*[col(g) for g in gnames]).agg(
            col(vn).is_null().bool_or().alias(gnull),
            col(vn).count("all").alias(gcnt))
        out = out.join(ginfo, left_on=left_keys,
                       right_on=[col(g) for g in gnames], how="left")
    else:
        ginfo = ginfo.agg(col(vn).is_null().bool_or().alias(gnull),
                          col(vn).count("all").alias(gcnt))
        out = out.join(ginfo, how="cross")

    matched = col(mark).fill_null(lit(False))
    nonempty = col(gcnt).fill_null(lit(0)) > lit(0)
    unknown = lhs.is_null() | col(gnull).fill_null(lit(False))
    flag = matched.if_else(
        lit(True), (nonempty & unknown).if_else(lit(None), lit(False)))
    return out, flag


def _find_setpred(e: Expression) -> Optional[Expression]:
    if e.op in ("in_subquery", "exists"):
        return e
    for a in e.args:
        found = _find_setpred(a)
        if found is not None:
            return found
    return None


def realize_marks(df, e: Expression) -> Tuple[object, Expression]:
    """Replace every EXISTS/IN-subquery node nested in ``e`` with a mark
    column (see ``_attach_mark``); the caller filters on the rewritten
    predicate and the helper columns fall away at the next projection."""
    while True:
        node = _find_setpred(e)
        if node is None:
            return df, e
        df, flag = _attach_mark(df, node)
        e = _replace_node(e, node, flag)


def _find_scalar(e: Expression) -> Optional[Expression]:
    if e.op == "subquery":
        return e
    if e.op in ("in_subquery", "exists"):
        raise NotImplementedError(
            "EXISTS/IN subquery must be a top-level conjunct "
            "(optionally negated), not nested in an expression")
    for a in e.args:
        found = _find_scalar(a)
        if found is not None:
            return found
    return None


def apply_where(df, pred: Expression):
    """df.where(pred), realizing any subquery nodes via joins first. Helper
    columns introduced by scalar-subquery joins stay in the frame; SQL's
    projection step (or the caller) drops them.

    Plain conjuncts apply BEFORE the subquery rewrites: the rewrites wrap
    the frame in joins (and, for residual correlation, a monotonic rowid)
    that block the optimizer's cross-join elimination underneath — the
    equality filters must reach the join graph first."""
    if not contains_subquery(pred):
        return df.where(pred)
    conjs = split_conjuncts(pred)
    plain = [c for c in conjs if not contains_subquery(c)]
    if plain:
        df = df.where(and_all(plain))
    residuals = []
    for conj in conjs:
        if not contains_subquery(conj):
            continue
        residual, df = _rewrite_conjunct(df, conj)
        if residual is not None:
            residuals.append(residual)
    if residuals:
        df = df.where(and_all(residuals))
    return df
