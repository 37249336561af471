"""Rule-based logical optimizer.

Reference: ``src/daft-logical-plan/src/optimization/optimizer.rs:40-215`` —
rule batches with Once/FixedPoint strategies. The batch list and every rule
are the reference's (``daft_tpu/logical/optimizer.py``): SimplifyExpressions,
the pushdowns (filter, projection, limit, also into and through joins), the
join rules (EliminateCrossJoin, SimplifyNullFilteredJoin,
PushDownAntiSemiJoin, PushDownJoinPredicate, FilterNullJoinKey,
ReorderJoins, SemiJoinReduction) and MaterializeScans, so a query plans to
the reference's join tree. A ``Window`` node takes the reference's
generic arms (every column required below it, no filter pushed through
it), and so does ``Sample``; ``Repartition`` takes the reference's arms
and DropRepartition.
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
            Batch("pushdowns", [EliminateCrossJoin(),
                                SimplifyNullFilteredJoin(),
                                PushDownFilter(),
                                PushDownAntiSemiJoin(),
                                PushDownProjection(), PushDownLimit(),
                                DropRepartition()],
                  "fixed_point"),
            # key-derived filters once pushdowns settle: they ADD filters,
            # so they run in their own once-batch (idempotent by structural
            # dedupe) followed by a pushdown sweep to sink the new
            # predicates into scans
            Batch("derived_filters", [PushDownJoinPredicate(),
                                      FilterNullJoinKey()], "once"),
            # EliminateCrossJoin rides every pushdown sweep: filter motion
            # can re-form Filter(CrossJoin) patterns after the first batch
            # settled
            Batch("derived_pushdown", [EliminateCrossJoin(),
                                       PushDownFilter(),
                                       PushDownProjection()],
                  "fixed_point"),
            Batch("joins", [ReorderJoins()], "once"),
            # after the join order settles: key-set transfer into
            # duplicate-collapsing probe sides (its semi joins then get
            # their own pushdown sweep below)
            Batch("semi_reduction", [SemiJoinReduction()], "once"),
            Batch("post_join_pushdowns", [EliminateCrossJoin(),
                                          PushDownFilter(),
                                          PushDownProjection()],
                  "fixed_point"),
            Batch("materialize", [MaterializeScans()], "once"),
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        from ..analysis import plan_sanitizer
        sanitize = plan_sanitizer.is_enabled()
        for batch in self.batches:
            passes = 1 if batch.strategy == "once" else batch.max_passes
            prev_key = None
            for _ in range(passes):
                for rule in batch.rules:
                    if sanitize:
                        before = plan.schema()
                        plan = rule.apply(plan)
                        plan_sanitizer.check_rule(
                            type(rule).__name__, before, plan.schema())
                    else:
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


def _has_effectful(e: Expression) -> bool:
    """A UDF may be stateful or nondeterministic, and ``apply`` and
    ``explode`` change cardinality or cost: filters are not pushed through
    them, nor hoisted above a reordered join tree."""
    if e.op in ("py_apply", "explode", "udf"):
        return True
    return any(_has_effectful(c) for c in e.args)


def unconverted_cross_joins(plan: lp.LogicalPlan) -> int:
    """Cross joins left in an optimized plan whose sides are both
    relations (a comma join that ``EliminateCrossJoin`` did not turn into
    an equi-join). A cross join with a one-row aggregate (an uncorrelated
    scalar subquery) is not counted: it is the plan's own."""
    from .subquery import _provably_single_row
    n = sum(unconverted_cross_joins(c) for c in plan.children)
    if isinstance(plan, lp.Join) and plan.how == "cross" \
            and not any(_provably_single_row(c) for c in plan.children):
        n += 1
    return n


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
            # through project (substituting expressions), if deterministic
            if isinstance(child, lp.Project):
                mapping = {}
                ok = True
                for e in child.exprs:
                    inner = e._unalias()
                    if _has_effectful(inner) \
                            and e.name() in pred.column_names():
                        ok = False
                        break
                    mapping[e.name()] = inner
                if ok:
                    new_pred = substitute_columns(pred, mapping)
                    return lp.Project(
                        lp.Filter(child.children[0], new_pred), child.exprs)
            # through ops that don't change rows' values
            if isinstance(child, (lp.Sort, lp.Repartition, lp.Concat)):
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
        if isinstance(node, (lp.Project, lp.UDFProject)):
            child = node.children[0]
            exprs = node.exprs
            if required is not None:
                exprs = [e for e in exprs if e.name() in required] or exprs[:1]
            child_req = set()
            for e in exprs:
                child_req.update(e.column_names())
            # collapse project(project) when outer is pure column selection
            new_child = self._prune(child, child_req)
            if (isinstance(node, lp.Project)
                    and isinstance(new_child, lp.Project)
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
            if isinstance(node, lp.UDFProject):
                return lp.UDFProject(new_child, list(exprs), node.concurrency)
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
        if isinstance(node, lp.Repartition):
            child_req = None if required is None else \
                required | {c for e in node.spec.by for c in e.column_names()}
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


class DropRepartition(Rule):
    """``repartition(repartition(x))`` → ``repartition(x)``; a hash
    repartition onto the clustering its child already has → the child."""
    name = "drop_repartition"

    def apply(self, plan):
        def fn(node):
            if isinstance(node, lp.Repartition):
                child = node.children[0]
                if isinstance(child, lp.Repartition):
                    return lp.Repartition(child.children[0], node.spec)
                cs = child.clustering_spec()
                if (node.spec.kind == "hash" and cs.kind == "hash"
                        and cs.num_partitions == node.spec.num_partitions
                        and [e._key() for e in cs.by]
                        == [e._key() for e in node.spec.by]):
                    return child
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


class EliminateCrossJoin(Rule):
    """Filter(CrossJoin) with equi-conjuncts spanning both sides → inner
    Join (reference: ``optimization/rules/eliminate_cross_join.rs``). The
    remaining conjuncts stay in a Filter above the new join."""

    name = "eliminate_cross_join"

    def apply(self, plan):
        # one bottom-up pass peels ONE cross layer: converting an upper
        # cross creates the Filter(CrossJoin) pattern below it only after
        # that lower node was already visited. A 17-relation comma join
        # (TPC-DS Q64) needs ~n passes — iterate to a local fixed point
        # rather than relying on the batch's bounded sweep count.
        for _ in range(64):
            new = self._apply_once(plan)
            if new.semantic_id() == plan.semantic_id():
                return new
            plan = new
        return plan

    def _apply_once(self, plan):
        def fn(node):
            if not isinstance(node, lp.Filter):
                return node
            # collapse a stack of Filters (apply_where and the subquery
            # rewrites emit separate .where() calls) so every conjunct is
            # visible to the conversion at once — Q64's 17-relation comma
            # join leaves Filter(Filter(CrossJoin)) otherwise
            preds = [node.predicate]
            child = node.children[0]
            while isinstance(child, lp.Filter):
                preds.append(child.predicate)
                child = child.children[0]
            if not (isinstance(child, lp.Join) and child.how == "cross"):
                return node
            predicate = combine_conjuncts(
                [c for p in preds for c in split_conjuncts(p)])
            lchild, rchild = child.children
            l_names = set(lchild.schema().column_names)
            r_names = set(rchild.schema().column_names)
            left_on, right_on = [], []
            l_only, r_only, rest = [], [], []
            for c in split_conjuncts(predicate):
                if c.op == "eq":
                    a, b = c.args
                    if a.op == "col" and b.op == "col":
                        an, bn = a.params[0], b.params[0]
                        if an in l_names and bn in r_names:
                            left_on.append(a)
                            right_on.append(b)
                            continue
                        if bn in l_names and an in r_names:
                            left_on.append(b)
                            right_on.append(a)
                            continue
                # side-contained conjuncts sink INTO the cross's child —
                # a nested cross (3+-relation comma join, TPC-DS Q18/Q25
                # shape) only converts once its own equis sit directly
                # above it
                refs = set(c.column_names())
                if refs and refs <= l_names:
                    l_only.append(c)
                    continue
                if refs and refs <= r_names:
                    r_only.append(c)
                    continue
                rest.append(c)
            if not left_on and not l_only and not r_only:
                return node
            if l_only:
                lchild = lp.Filter(lchild, combine_conjuncts(l_only))
            if r_only:
                rchild = lp.Filter(rchild, combine_conjuncts(r_only))
            how = "inner" if left_on else "cross"
            join = lp.Join(lchild, rchild, left_on, right_on, how,
                           child.strategy, child.prefix, child.suffix)
            return lp.Filter(join, combine_conjuncts(rest)) if rest else join
        return plan.transform_up(fn)


class ReorderJoins(Rule):
    """Greedy left-deep reordering of inner equi-join trees by estimated
    cardinality (reference: brute-force DP + naive-left-deep in
    ``optimization/rules/reorder_joins/``; here: greedy smallest-first over
    the join graph using ``stats.estimate``, which is O(n²) and picks the
    same orders on TPC-H shapes). Only applies when every key is a plain
    column and relation column names are globally disjoint, so the output
    column SET is order-independent; a final Project restores the original
    column order."""

    name = "reorder_joins"

    def apply(self, plan):
        # top-down, acting only at MAXIMAL inner-join roots: reordering an
        # inner subtree first would wrap it in a Project that blocks
        # flattening at every ancestor join, leaving 4+-relation chains
        # only partially ordered. A Filter directly above the join tree
        # contributes its equality conjuncts as join edges — comma joins
        # (TPC-DS Q64's 17-relation FROM) parse as crosses whose linking
        # equalities live in WHERE, and some links only connect relations
        # that sit far apart in the written order.
        def rec(node, parent_eligible: bool):
            if isinstance(node, lp.Filter) and not parent_eligible \
                    and self._eligible(node.children[0]):
                out = self._try_reorder(node.children[0], node.predicate)
                if out is not None:
                    return out
            elig = self._eligible(node)
            if elig and not parent_eligible:
                out = self._try_reorder(node)
                if out is not None:
                    return out
            return node.with_children(
                [rec(c, elig) for c in node.children])

        return rec(plan, False)

    @staticmethod
    def _eligible(node) -> bool:
        return (isinstance(node, lp.Join)
                and node.how in ("inner", "cross")
                and node.strategy is None
                and all(e.op == "col" for e in node.left_on)
                and all(e.op == "col" for e in node.right_on))

    # -- flatten a maximal inner-equi-join tree ------------------------
    def _flatten(self, node, rels, edges, filters=None):
        if self._eligible(node):
            self._flatten(node.children[0], rels, edges, filters)
            self._flatten(node.children[1], rels, edges, filters)
            for le, re_ in zip(node.left_on, node.right_on):
                edges.append((le.params[0], re_.params[0]))
        elif (filters is not None and isinstance(node, lp.Filter)
              and not _has_effectful(node.predicate)):
            # look through filters interleaved in the join chain: inner
            # joins commute with filters, their cross-relation equalities
            # are join edges in disguise, and PushDownFilter re-sinks the
            # single-relation remainder after the reorder. Effectful
            # (nondeterministic/stateful-UDF) predicates stay opaque —
            # hoisting one above the rebuilt tree would re-evaluate it
            # over the larger joined row set, changing results and
            # invocation counts (same guard as PushDownFilter).
            filters.append(node.predicate)
            self._flatten(node.children[0], rels, edges, filters)
        else:
            rels.append(node)

    def _try_reorder(self, node, filter_pred: Optional[Expression] = None):
        if not self._eligible(node):
            return None
        rels: List[lp.LogicalPlan] = []
        edges: List[tuple] = []
        inner_filters: List[Expression] = []
        self._flatten(node, rels, edges, inner_filters)
        if len(rels) < 3:
            return None
        # column ownership must be unambiguous and globally disjoint
        owner: Dict[str, int] = {}
        for i, r in enumerate(rels):
            for nm in r.schema().column_names:
                if nm in owner:
                    return None
                owner[nm] = i
        for ln, rn in edges:
            if ln not in owner or rn not in owner:
                return None
        # harvest cross-relation equality conjuncts from the Filter above
        # the tree and from filters interleaved inside it; everything else
        # stays as a residual filter on top
        had_cross = self._has_cross(node)
        rest_conjs: List[Expression] = []
        harvested = 0
        preds = ([filter_pred] if filter_pred is not None else []) \
            + inner_filters
        for p in preds:
            for c in split_conjuncts(p):
                u = c._unalias()
                if u.op == "eq":
                    a, b = u.args
                    if a.op == "col" and b.op == "col" \
                            and a.params[0] in owner \
                            and b.params[0] in owner \
                            and owner[a.params[0]] != owner[b.params[0]]:
                        edges.append((a.params[0], b.params[0]))
                        harvested += 1
                        continue
                rest_conjs.append(c)
        from . import stats as lstats
        sizes = []
        for r in rels:
            s = lstats.estimate(r)
            if s.rows is None:
                return None
            sizes.append(max(s.rows, 1.0))
        # greedy by estimated RESULT cardinality: |T ⋈ R| ≈
        # |T|·|R| / max(ndv(keys)) — base-size-only greedy walks straight
        # into m:n low-cardinality joins (TPC-H Q5's s_nationkey =
        # c_nationkey made a 60M-row intermediate of 10k × 150k suppliers
        # × customers through 25 nations). NDVs come from parquet footer
        # min/max (stats.column_ndv); a missing ndv falls back to the
        # relation's rows (near-unique key ⇒ FK-shaped).
        n = len(rels)
        ndv_cache: Dict[tuple, float] = {}

        def ndv(i: int, name: str) -> float:
            key = (i, name)
            if key not in ndv_cache:
                v = lstats.column_ndv(rels[i], name, est_rows=sizes[i])
                ndv_cache[key] = max(v if v is not None else sizes[i], 1.0)
            return ndv_cache[key]

        adj: Dict[int, List[tuple]] = {i: [] for i in range(n)}
        for ln, rn in edges:
            a, b = owner[ln], owner[rn]
            adj[a].append((b, ln, rn))
            adj[b].append((a, rn, ln))
        start = min(range(n), key=lambda i: sizes[i])
        in_set = {start}
        order = [start]
        tree_rows = sizes[start]
        while len(in_set) < n:
            # frontier: candidate → most selective (max-ndv) edge into it
            frontier: Dict[int, float] = {}
            for i in in_set:
                for j, mine, theirs in adj[i]:
                    if j in in_set:
                        continue
                    sel = max(ndv(i, mine), ndv(j, theirs))
                    frontier[j] = max(frontier.get(j, 1.0), sel)
            if not frontier:
                return None  # disconnected graph: leave as written
            best = min(frontier,
                       key=lambda j: tree_rows * sizes[j] / frontier[j])
            in_set.add(best)
            order.append(best)
            tree_rows = max(tree_rows * sizes[best] / frontier[best], 1.0)
        # already in this order with nothing to convert: leave residual
        # filters alone — rebuilding would churn a Project + filter hoist
        # for PushDownFilter to undo
        if order == list(range(n)) and not had_cross and not harvested:
            return None
        # rebuild left-deep (relations may hold nested join trees of their
        # own, e.g. under aggregates — reorder those independently)
        rels = [self.apply(r) for r in rels]
        placed = {order[0]}
        tree = rels[order[0]]
        for idx in order[1:]:
            lkeys, rkeys = [], []
            for j, mine, theirs in adj[idx]:
                if j in placed:
                    lkeys.append(col(theirs))
                    rkeys.append(col(mine))
            placed.add(idx)
            tree = lp.Join(tree, rels[idx], lkeys, rkeys, "inner")
        out_names = node.schema().column_names
        if set(out_names) != set(tree.schema().column_names):
            return None  # safety: must be a pure permutation
        out = lp.Project(tree, [col(nm) for nm in out_names])
        if rest_conjs:
            out = lp.Filter(out, combine_conjuncts(rest_conjs))
        return out

    def _has_cross(self, node) -> bool:
        if isinstance(node, lp.Filter):
            return self._has_cross(node.children[0])
        if not self._eligible(node):
            return False
        return node.how == "cross" \
            or self._has_cross(node.children[0]) \
            or self._has_cross(node.children[1])


def _null_rejecting_cols(conj: Expression) -> set:
    """Columns for which the conjunct cannot hold when they are NULL
    (comparison semantics propagate NULL → filter drops the row). A
    conjunct containing null-tolerant ops (is_null / fill_null /
    coalesce / is_in) contributes nothing."""
    # if_else (CASE) can take a branch that never touches the null column;
    # eq_null_safe is definite on nulls by definition
    tolerant = {"is_null", "fill_null", "coalesce", "is_in", "or", "not",
                "if_else", "eq_null_safe"}

    def has_tolerant(e: Expression) -> bool:
        return e.op in tolerant or any(has_tolerant(c) for c in e.args)

    u = conj._unalias()
    if has_tolerant(u):
        return set()
    if u.op in ("eq", "neq", "lt", "le", "gt", "ge", "between",
                "not_null"):
        return set(u.column_names())
    return set()


class SimplifyNullFilteredJoin(Rule):
    """Filter(outer Join) whose predicate null-rejects a column from the
    null-producing side → strengthen the join (left/right → inner, outer →
    left/right/inner): the filter would drop every unmatched row anyway,
    and inner joins unlock reordering + broadcast (reference:
    ``optimization/rules/simplify_null_filtered_join.rs``)."""

    name = "simplify_null_filtered_join"

    def apply(self, plan):
        def fn(node):
            if not isinstance(node, lp.Filter):
                return node
            child = node.children[0]
            if not (isinstance(child, lp.Join)
                    and child.how in ("left", "right", "outer")):
                return node
            l_names = set(child.children[0].schema().column_names)
            out_names = set(child.schema().column_names)
            r_out = out_names - l_names
            rejected: set = set()
            for c in split_conjuncts(node.predicate):
                rejected |= _null_rejecting_cols(c)
            rejects_left = bool(rejected & l_names)
            rejects_right = bool(rejected & r_out)
            how = child.how
            if how == "left" and rejects_right:
                how = "inner"
            elif how == "right" and rejects_left:
                how = "inner"
            elif how == "outer":
                # rejecting a RIGHT column kills LEFT-unmatched rows
                # (their right columns are NULL) → what remains is a
                # RIGHT join, and vice versa
                if rejects_left and rejects_right:
                    how = "inner"
                elif rejects_right:
                    how = "right"
                elif rejects_left:
                    how = "left"
            if how == child.how:
                return node
            join = lp.Join(child.children[0], child.children[1],
                           child.left_on, child.right_on, how,
                           child.strategy, child.prefix, child.suffix)
            return lp.Filter(join, node.predicate)
        return plan.transform_up(fn)


class PushDownAntiSemiJoin(Rule):
    """Sink semi/anti joins below the left side's Projects and Sorts so
    they filter before wide projections / orderings run (the join output
    schema IS the left schema, so the rewrite is a pure reordering;
    reference: ``optimization/rules/push_down_anti_semi_join.rs``)."""

    name = "push_down_anti_semi_join"

    def apply(self, plan):
        def fn(node):
            if not (isinstance(node, lp.Join)
                    and node.how in ("semi", "anti")):
                return node
            child = node.children[0]
            if isinstance(child, lp.Sort):
                join = lp.Join(child.children[0], node.children[1],
                               node.left_on, node.right_on, node.how,
                               node.strategy)
                return child.with_children([join])
            if isinstance(child, lp.Project):
                # keys must be pure passthroughs of the project's input
                mapping = {}
                for e in child.exprs:
                    inner = e._unalias()
                    if inner.op == "col":
                        mapping[e.name()] = inner
                remapped = []
                for k in node.left_on:
                    ku = k._unalias()
                    if ku.op != "col" or ku.params[0] not in mapping:
                        return node
                    remapped.append(mapping[ku.params[0]])
                join = lp.Join(child.children[0], node.children[1],
                               remapped, node.right_on, node.how,
                               node.strategy)
                return child.with_children([join])
            return node
        return plan.transform_up(fn)


class FilterNullJoinKey(Rule):
    """Null join keys can never match an equi join: pre-filter them on
    the sides whose unmatched rows are NOT preserved (both for inner and
    semi; the probe side of left/right; the right side of anti). Shrinks
    shuffle and build input (reference:
    ``optimization/rules/filter_null_join_key.rs``)."""

    name = "filter_null_join_key"

    def apply(self, plan):
        def not_null_pred(keys):
            preds = [k.not_null() for k in keys
                     if k._unalias().op == "col"]
            return combine_conjuncts(preds) if preds else None

        def already_filtered(child, pred) -> bool:
            return (isinstance(child, lp.Filter)
                    and all(any(c.structurally_eq(ex) for ex in
                                split_conjuncts(child.predicate))
                            for c in split_conjuncts(pred)))

        def fn(node):
            if not isinstance(node, lp.Join) or not node.left_on:
                return node
            filter_left = node.how in ("inner", "semi")
            filter_right = node.how in ("inner", "left", "semi", "anti")
            if node.how == "right":
                filter_left = True
            newl, newr = node.children
            changed = False
            if filter_left:
                p = not_null_pred(node.left_on)
                if p is not None and not already_filtered(newl, p):
                    newl = lp.Filter(newl, p)
                    changed = True
            if filter_right:
                p = not_null_pred(node.right_on)
                if p is not None and not already_filtered(newr, p):
                    newr = lp.Filter(newr, p)
                    changed = True
            if not changed:
                return node
            return node.with_children([newl, newr])
        return plan.transform_up(fn)


class SemiJoinReduction(Rule):
    """Sideways information passing for joins whose probe side collapses
    duplicates: ``Join(A, [Project/Filter]* Distinct/Aggregate(S))`` with
    S estimated much larger than A → pre-filter S with a semi join on
    A's DISTINCT join keys, so the Distinct/Aggregate processes only the
    join-relevant fraction.

    Identity-preserving for inner / semi / anti / left-preserving joins:
    an S row dropped by the key filter can only produce reduced-side rows
    whose join key has no partner in A — rows those join types ignore.
    TPC-H Q21 is the motivating shape: the EXISTS/NOT-EXISTS branches
    each run DISTINCT over the full 6M-row lineitem projection, of which
    ~3% survive the join against the Saudi/failed-order base; with the
    reduction the dedups see only that fraction. The duplicated A
    subtree costs nothing extra at runtime: the executor's subplan
    sharing streams one execution to both consumers.

    Reference analogue: Daft has no sideways information passing; its
    optimizer stops at predicate transfer across keys
    (``optimization/rules/``) — this rule generalizes that to key-SET
    transfer, the classic magic-sets/bloom-reduction rewrite.
    """

    name = "semi_join_reduction"
    MIN_ROWS = 500_000      # don't churn small plans
    RATIO = 4.0             # reduced side must be ≥4x the key side

    def apply(self, plan):
        from . import stats as lstats

        def fn(node):
            if not isinstance(node, lp.Join):
                return node
            # which sides may be reduced without changing semantics:
            # the side whose unmatched rows the join DROPS
            reducible = {"inner": (True, True), "semi": (False, True),
                         "anti": (False, True), "left": (False, True),
                         "right": (True, False)}.get(node.how)
            if reducible is None:
                return node
            newl, newr = node.children
            if reducible[1]:
                newr = self._reduce(newr, node.right_on, newl,
                                    node.left_on, lstats) or newr
            if reducible[0]:
                newl = self._reduce(newl, node.left_on, newr,
                                    node.right_on, lstats) or newl
            if newl is node.children[0] and newr is node.children[1]:
                return node
            return node.with_children([newl, newr])

        return plan.transform_up(fn)

    def _reduce(self, side, side_keys, other, other_keys, lstats):
        """Rewrite ``side`` (the collapsing subtree) or return None."""
        if not all(e.op == "col" for e in side_keys) \
                or not all(e.op == "col" for e in other_keys):
            return None
        # walk down through col-only Projects and Filters to a
        # Distinct / grouped Aggregate, tracking key renames
        chain = []
        keys = [e.params[0] for e in side_keys]
        node = side
        # a UDF in the chain may be stateful/nondeterministic — its
        # values (or a filter's verdicts) over a reduced input could
        # differ
        def has_udf(e):
            return e.op == "udf" or any(has_udf(a) for a in e.args)

        while True:
            if isinstance(node, lp.Filter):
                if has_udf(node.predicate):
                    return None
                chain.append(node)
                node = node.children[0]
                continue
            if isinstance(node, lp.Project):
                if any(has_udf(e) for e in node.exprs):
                    return None
                mapped = []
                byname = {e.name(): e._unalias() for e in node.exprs}
                for k in keys:
                    src = byname.get(k)
                    if src is None or src.op != "col":
                        return None
                    mapped.append(src.params[0])
                keys = mapped
                chain.append(node)
                node = node.children[0]
                continue
            break
        if isinstance(node, lp.Distinct):
            if node.on is not None:
                return None  # keyed dedup: dropped rows are observable
            collapse = node
        elif isinstance(node, lp.Aggregate) and node.group_by:
            # map each join key through the aggregate by OUTPUT name:
            # an aliased group key (GROUP BY b AS a) must filter the
            # SOURCE column b, and every key must resolve unambiguously
            out_to_src = {}
            for g in node.group_by:
                u = g._unalias()
                if u.op == "col":
                    out_to_src.setdefault(g.name(), u.params[0])
            mapped = []
            for k in keys:
                src = out_to_src.get(k)
                if src is None:
                    return None  # not a plain-column group key
                mapped.append(src)
            keys = mapped
            collapse = node
        else:
            return None
        s = collapse.children[0]
        # the Project chain may rename ABOVE the collapse too — map keys
        # through the collapse (Distinct/Agg group keys pass unchanged)
        s_stats = lstats.estimate(s)
        o_stats = lstats.estimate(other)
        if s_stats.rows is None or o_stats.rows is None:
            return None
        if s_stats.rows < self.MIN_ROWS \
                or s_stats.rows < self.RATIO * o_stats.rows:
            return None
        # distinct key projection of the other side, renamed to fresh
        # names (S usually shares column names with A — Q21 self-joins).
        # The tag derives from the CONTENT (key side + key names), not a
        # global counter: identical reducible subtrees must rewrite to
        # identical plans or the executor's semantic-id subplan sharing
        # would run the shared key side once per textual copy
        import hashlib
        tag = hashlib.md5(repr(
            (other.semantic_id(), [e.params[0] for e in other_keys],
             keys)).encode()).hexdigest()[:8]
        knames = [f"__sjr{tag}_{i}__" for i in range(len(other_keys))]
        kproj = lp.Distinct(lp.Project(
            other, [col(e.params[0]).alias(n)
                    for e, n in zip(other_keys, knames)]))
        filtered = lp.Join(s, kproj, [col(k) for k in keys],
                           [col(n) for n in knames], "semi")
        # rebuild the collapse + chain over the filtered source
        out = collapse.with_children([filtered])
        for n in reversed(chain):
            out = n.with_children([out])
        return out


class PushDownJoinPredicate(Rule):
    """Predicate transfer across equi-join keys: a literal comparison
    pinned to one side's key column holds identically for the other
    side's key (rows can only match on equal key values), so clone it
    across — both shuffle inputs shrink (reference:
    ``optimization/rules/push_down_join_predicate.rs``)."""

    name = "push_down_join_predicate"

    _OPS = ("eq", "lt", "le", "gt", "ge", "between", "is_in")

    def apply(self, plan):
        def key_conjuncts(child, key_name):
            """Literal-only conjuncts of an immediate Filter over exactly
            the key column."""
            if not isinstance(child, lp.Filter):
                return []
            out = []
            for c in split_conjuncts(child.predicate):
                u = c._unalias()
                if u.op in self._OPS and set(u.column_names()) == {key_name} \
                        and all(a.op != "col" or a.params[0] == key_name
                                for a in u.args):
                    out.append(c)
            return out

        def fn(node):
            if not (isinstance(node, lp.Join)
                    and node.how in ("inner", "semi")):
                return node
            newl, newr = node.children
            add_l, add_r = [], []
            for lk, rk in zip(node.left_on, node.right_on):
                lu, ru = lk._unalias(), rk._unalias()
                if lu.op != "col" or ru.op != "col":
                    continue
                for c in key_conjuncts(newl, lu.params[0]):
                    t = substitute_columns(c, {lu.params[0]: ru})
                    add_r.append(t)
                for c in key_conjuncts(newr, ru.params[0]):
                    t = substitute_columns(c, {ru.params[0]: lu})
                    add_l.append(t)

            def extend(child, extra):
                if not extra:
                    return child, False
                existing = split_conjuncts(child.predicate) \
                    if isinstance(child, lp.Filter) else []
                fresh = [e for e in extra
                         if not any(e.structurally_eq(x) for x in existing)]
                if not fresh:
                    return child, False
                base = child.children[0] if isinstance(child, lp.Filter) \
                    else child
                return lp.Filter(base, combine_conjuncts(
                    existing + fresh)), True

            newl, cl = extend(newl, add_l)
            newr, cr = extend(newr, add_r)
            if not (cl or cr):
                return node
            return node.with_children([newl, newr])
        return plan.transform_up(fn)
