"""Rule-based logical optimizer.

Reference: ``src/daft-logical-plan/src/optimization/optimizer.rs:40-215`` —
rule batches with Once/FixedPoint strategies. The port carries the rules the
grouped-aggregation and equi-join slices need (SimplifyExpressions,
PushDownFilter, also into join sides, PushDownProjection, also through
joins, PushDownLimit, MaterializeScans). The reference's join reordering,
semi-join reduction, cross-join elimination and derived-filter rules come
with a later slice (ROADMAP A2); answers do not depend on them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..expressions import Expression, col, lit
from . import plan as lp


class Rule:
    name = "rule"

    def apply(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        raise NotImplementedError


class Batch:
    def __init__(self, name: str, rules: List[Rule], strategy: str = "once",
                 max_passes: int = 5):
        self.name = name
        self.rules = rules
        self.strategy = strategy
        self.max_passes = max_passes


class Optimizer:
    def __init__(self, batches: Optional[List[Batch]] = None):
        self.batches = batches or [
            Batch("simplify", [SimplifyExpressions()], "fixed_point"),
            Batch("pushdowns", [PushDownFilter(), PushDownProjection(),
                                PushDownLimit()], "fixed_point"),
            Batch("materialize", [MaterializeScans()], "once"),
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for batch in self.batches:
            passes = 1 if batch.strategy == "once" else batch.max_passes
            prev_key = None
            for _ in range(passes):
                for rule in batch.rules:
                    plan = rule.apply(plan)
                key = plan.semantic_id()
                if key == prev_key:  # fixed point reached (cycle guard)
                    break
                prev_key = key
        return plan


# ---------------------------------------------------------------------------
# expression helpers

def substitute_columns(e: Expression, mapping: Dict[str, Expression]
                       ) -> Expression:
    if e.op == "col" and e.params[0] in mapping:
        sub = mapping[e.params[0]]
        return sub
    if not e.args:
        return e
    return e.with_children([substitute_columns(c, mapping) for c in e.args])


def split_conjuncts(e: Expression) -> List[Expression]:
    if e.op == "and":
        return split_conjuncts(e.args[0]) + split_conjuncts(e.args[1])
    return [e]


def _split_disjuncts(e: Expression) -> List[Expression]:
    if e.op == "or":
        return _split_disjuncts(e.args[0]) + _split_disjuncts(e.args[1])
    return [e]


def combine_conjuncts(es: List[Expression]) -> Expression:
    out = es[0]
    for e in es[1:]:
        out = out & e
    return out


# ---------------------------------------------------------------------------
# rules

class SimplifyExpressions(Rule):
    """Basic algebraic simplification (reference: daft-algebra simplify_expr)."""

    name = "simplify_expressions"

    def apply(self, plan):
        def fn(node):
            if isinstance(node, lp.Filter):
                return lp.Filter(node.children[0], simplify(node.predicate))
            if isinstance(node, lp.Project):
                return lp.Project(node.children[0],
                                  [simplify(e) for e in node.exprs])
            return node
        return plan.transform_up(fn)


def simplify(e: Expression) -> Expression:
    if e.args:
        e = e.with_children([simplify(c) for c in e.args])
    # not(not(x)) -> x
    if e.op == "not" and e.args[0].op == "not":
        return e.args[0].args[0]
    # OR-common-conjunct factoring: (A & X) | (A & Y) -> A & (X | Y).
    # TPC-DS Q13/Q48-style predicates repeat the JOIN conditions inside
    # every OR branch; factoring them out lets EliminateCrossJoin find the
    # equi keys instead of evaluating a multi-table cross product.
    if e.op == "or":
        branches = _split_disjuncts(e)
        conj_sets = [split_conjuncts(b) for b in branches]
        common = []
        for c in conj_sets[0]:
            if all(any(c.structurally_eq(x) for x in s)
                   for s in conj_sets[1:]) \
                    and not any(c.structurally_eq(x) for x in common):
                common.append(c)
        if common:
            rests = []
            for s in conj_sets:
                rest = [x for x in s
                        if not any(x.structurally_eq(c) for c in common)]
                rests.append(combine_conjuncts(rest) if rest else lit(True))
            if all(r.op == "lit" and r.params[0] is True for r in rests):
                # every branch was fully absorbed (e.g. A | A): the OR is
                # exactly the common part — recursing would loop forever
                return combine_conjuncts(common)
            out = rests[0]
            for r in rests[1:]:
                out = out | r
            return combine_conjuncts(common + [simplify(out)])
    # x == True -> x ; x == False -> not x
    if e.op in ("eq", "neq"):
        l, r = e.args
        for a, b in ((l, r), (r, l)):
            if b.op == "lit" and isinstance(b.params[0], bool):
                truthy = b.params[0] if e.op == "eq" else not b.params[0]
                return a if truthy else Expression("not", (a,))
    # True & x -> x ; False | x -> x
    if e.op == "and":
        l, r = e.args
        for a, b in ((l, r), (r, l)):
            if a.op == "lit" and a.params[0] is True:
                return b
    if e.op == "or":
        l, r = e.args
        for a, b in ((l, r), (r, l)):
            if a.op == "lit" and a.params[0] is False:
                return b
            if a.op == "lit" and a.params[0] is True:
                return a
    return e


class PushDownFilter(Rule):
    name = "push_down_filter"

    def apply(self, plan):
        def fn(node):
            if not isinstance(node, lp.Filter):
                return node
            child = node.children[0]
            pred = node.predicate
            # merge adjacent filters
            if isinstance(child, lp.Filter):
                return lp.Filter(child.children[0], child.predicate & pred)
            # through project (substituting expressions; every expression
            # of the port is deterministic)
            if isinstance(child, lp.Project):
                mapping = {e.name(): e._unalias() for e in child.exprs}
                new_pred = substitute_columns(pred, mapping)
                return lp.Project(
                    lp.Filter(child.children[0], new_pred), child.exprs)
            # through ops that don't change rows' values
            if isinstance(child, lp.Sort):
                pushed = [lp.Filter(c, pred) for c in child.children]
                return child.with_children(pushed)
            if isinstance(child, lp.Join) and child.how in (
                    "inner", "left", "right", "semi", "anti"):
                pushed_join = _push_into_join(child, pred)
                if pushed_join is not None:
                    return pushed_join
            # into the scan's pushdowns
            if isinstance(child, lp.Source) and child.scan_op is not None:
                pd = child.pushdowns
                new_f = pred if pd.filters is None else (pd.filters & pred)
                return child.with_pushdowns(pd.with_filters(new_f))
            return node
        return plan.transform_up(fn)


def _push_into_join(join: lp.Join, pred: Expression
                    ) -> Optional[lp.LogicalPlan]:
    """Move the conjuncts of ``pred`` that read one side only below the
    join, where that side's rows are all kept or dropped as a whole: the
    left side of inner/left/semi/anti, the right side of inner/right
    (prefixed right names map back to the right child's columns). None
    when nothing moves."""
    how = join.how
    l_names = set(join.children[0].schema().column_names)
    r_names = set(join.schema().column_names) - l_names
    rc_names = set(join.children[1].schema().column_names)
    keep, to_l, to_r = [], [], []
    for c in split_conjuncts(pred):
        used = set(c.column_names())
        if used <= l_names and how in ("inner", "left", "semi", "anti"):
            to_l.append(c)
        elif used <= r_names and how in ("inner", "right"):
            mapping = {}
            for nm in used:
                if nm in rc_names:
                    continue
                base = nm[6:] if nm.startswith("right.") else nm
                if base in rc_names:
                    mapping[nm] = col(base)
            to_r.append(substitute_columns(c, mapping))
        else:
            keep.append(c)
    if not (to_l or to_r):
        return None
    newl, newr = join.children
    if to_l:
        newl = lp.Filter(newl, combine_conjuncts(to_l))
    if to_r:
        newr = lp.Filter(newr, combine_conjuncts(to_r))
    new_join = join.with_children([newl, newr])
    return lp.Filter(new_join, combine_conjuncts(keep)) if keep else new_join


class PushDownProjection(Rule):
    """Column pruning: push required-column sets into scans and collapse
    redundant projections."""

    name = "push_down_projection"

    def apply(self, plan):
        return self._prune(plan, None)

    def _prune(self, node: lp.LogicalPlan,
               required: Optional[Set[str]]) -> lp.LogicalPlan:
        # `required is None` → all columns needed
        if isinstance(node, lp.Source):
            if (required is not None and node.scan_op is not None
                    and node.pushdowns.columns is None):
                avail = node._source_schema.column_names
                filt_cols = set()
                if node.pushdowns.filters is not None:
                    filt_cols = set(node.pushdowns.filters.column_names())
                needed = [c for c in avail if c in (required | filt_cols)]
                if len(needed) < len(avail):
                    return node.with_pushdowns(
                        node.pushdowns.with_columns(needed))
            return node
        if isinstance(node, lp.Project):
            child = node.children[0]
            exprs = node.exprs
            if required is not None:
                exprs = [e for e in exprs if e.name() in required] or exprs[:1]
            child_req = set()
            for e in exprs:
                child_req.update(e.column_names())
            # collapse project(project) when outer is pure column selection
            new_child = self._prune(child, child_req)
            if (isinstance(new_child, lp.Project)
                    and all(e._unalias().op == "col" for e in exprs)):
                inner_map = {ie.name(): ie for ie in new_child.exprs}
                merged = []
                ok = True
                for e in exprs:
                    src = e._unalias().params[0]
                    if src not in inner_map:
                        ok = False
                        break
                    ie = inner_map[src]
                    merged.append(ie if e.name() == ie.name()
                                  else ie._unalias().alias(e.name()))
                if ok:
                    return lp.Project(new_child.children[0], merged)
            return lp.Project(new_child, list(exprs))
        if isinstance(node, lp.Filter):
            child_req = None if required is None else \
                required | set(node.predicate.column_names())
            return lp.Filter(self._prune(node.children[0], child_req),
                             node.predicate)
        if isinstance(node, lp.Aggregate):
            child_req = set()
            for e in node.aggs + node.group_by:
                child_req.update(e.column_names())
            return lp.Aggregate(self._prune(node.children[0], child_req),
                                node.aggs, node.group_by)
        if isinstance(node, lp.Join):
            return node.with_children(self._join_requirements(node, required))
        if isinstance(node, lp.Sort):
            child_req = None if required is None else \
                required | {c for e in node.sort_by for c in e.column_names()}
            return node.with_children(
                [self._prune(node.children[0], child_req)])
        if isinstance(node, lp.TopN):
            child_req = None if required is None else \
                required | {c for e in node.sort_by for c in e.column_names()}
            return node.with_children(
                [self._prune(node.children[0], child_req)])
        # other nodes: require everything below
        return node.with_children(
            [self._prune(c, None) for c in node.children])

    def _join_requirements(self, node: lp.Join, required: Optional[Set[str]]
                           ) -> List[lp.LogicalPlan]:
        """Each side pruned to the output columns it supplies plus its
        join keys (a prefixed ``right.x`` is the right child's ``x``)."""
        left, right = node.children
        if required is None:
            return [self._prune(left, None), self._prune(right, None)]
        l_names = set(left.schema().column_names)
        r_names = set(right.schema().column_names)
        l_req: Set[str] = set()
        r_req: Set[str] = set()
        for nm in required:
            if nm in l_names:
                l_req.add(nm)
            elif nm in r_names:
                r_req.add(nm)
            else:
                r_req.add(nm[6:] if nm.startswith("right.") else nm)
        for e in node.left_on:
            l_req.update(e.column_names())
        for e in node.right_on:
            r_req.update(e.column_names())
        return [self._prune(left, l_req), self._prune(right, r_req)]


class PushDownLimit(Rule):
    name = "push_down_limit"

    def apply(self, plan):
        def fn(node):
            if not isinstance(node, lp.Limit) or node.offset:
                return node
            child = node.children[0]
            if isinstance(child, lp.Limit):
                return lp.Limit(child.children[0],
                                min(node.limit, child.limit))
            if isinstance(child, (lp.Project,)):
                return child.with_children(
                    [lp.Limit(child.children[0], node.limit)])
            if isinstance(child, lp.Sort):
                return lp.TopN(child.children[0], child.sort_by,
                               child.descending, child.nulls_first, node.limit)
            if isinstance(child, lp.Source) and child.scan_op is not None \
                    and child.pushdowns.filters is None:
                pd = child.pushdowns
                new_l = node.limit if pd.limit is None \
                    else min(pd.limit, node.limit)
                return lp.Limit(child.with_pushdowns(pd.with_limit(new_l)),
                                node.limit)
            return node
        return plan.transform_up(fn)


class MaterializeScans(Rule):
    """Turn glob-scan sources into concrete scan-task lists
    (reference: MaterializeScans + EnrichWithStats)."""

    name = "materialize_scans"

    def apply(self, plan):
        def fn(node):
            if isinstance(node, lp.Source) and node.scan_op is not None \
                    and getattr(node, "materialized_tasks", None) is None:
                # rules never mutate pushdowns in place (they build new
                # Source nodes), so a cached list — e.g. from the stats
                # pass during join reordering — is still valid here
                node.materialized_tasks = \
                    node.scan_op.to_scan_tasks(node.pushdowns)
            return node
        return plan.transform_up(fn)
