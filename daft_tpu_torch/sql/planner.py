"""Hand-written SQL frontend: tokenizer + recursive-descent parser → LogicalPlan.

Capability mirror of ``src/daft-sql`` (planner over sqlparser-rs;
``planner.rs``): SELECT with CTEs, derived tables, JOIN chains (ON/USING,
inner/left/right/full/cross/semi/anti), WHERE / GROUP BY / HAVING / ORDER BY /
LIMIT / OFFSET, DISTINCT, UNION [ALL], scalar + aggregate expressions (CASE,
CAST, BETWEEN, IN, LIKE, IS NULL, EXTRACT, INTERVAL, date literals), and a
function library mapped onto the expression DSL. No third-party SQL dependency
exists in this environment, so the parser is first-party.

The port's copy of ``daft_tpu/sql/planner.py``, window functions (``OVER``:
partition and order keys, ``ROWS`` / ``RANGE`` frames, windows over
aggregates and over grouping sets) and the tokenize functions included.
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, List, Optional, Tuple

from ..datatype import DataType, TimeUnit
from ..expressions import Expression, col, lit, coalesce

# ---------------------------------------------------------------------------
# tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|<>|!=|\|\||::|[-+*/%(),.<>=])
""", re.VERBOSE)


class Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def tokenize(s: str) -> List[Tok]:
    out = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if m is None:
            raise ValueError(f"SQL tokenize error at {s[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "ident":
            out.append(Tok("ident", text))
        elif kind == "qident":
            out.append(Tok("ident", text[1:-1].replace('""', '"')))
        elif kind == "str":
            out.append(Tok("str", text[1:-1].replace("''", "'")))
        else:
            out.append(Tok(kind, text))
    out.append(Tok("eof", ""))
    return out


_AGG_FUNCS = {"sum", "avg", "mean", "min", "max", "count", "count_distinct",
              "stddev", "stddev_pop", "var", "variance", "any_value",
              "approx_count_distinct", "list_agg", "string_agg", "skew"}


class Scope:
    """Name resolution: alias → {sql column name → actual frame column}."""

    def __init__(self):
        self.tables: Dict[str, Dict[str, str]] = {}
        self.order: List[str] = []

    def add(self, alias: str, columns: List[str],
            actual: Optional[Dict[str, str]] = None):
        self.tables[alias] = {c.lower(): (actual[c] if actual else c)
                              for c in columns}
        self.order.append(alias)

    def prefix_right(self, collided: List[str]):
        """After a join, right-side collided columns become right.<name>."""
        last = self.order[-1]
        m = self.tables[last]
        for sqlname, act in list(m.items()):
            if act in collided:
                m[sqlname] = "right." + act

    def resolve(self, name: str, alias: Optional[str] = None) -> str:
        if alias is not None:
            t = self.tables.get(alias.lower())
            if t is None or name.lower() not in t:
                raise ValueError(f"unknown column {alias}.{name}")
            return t[name.lower()]
        for a in self.order:
            if name.lower() in self.tables[a]:
                return self.tables[a][name.lower()]
        raise ValueError(f"unknown column {name}")

    def all_columns(self) -> List[str]:
        seen, out = set(), []
        for a in self.order:
            for act in self.tables[a].values():
                if act not in seen:
                    seen.add(act)
                    out.append(act)
        return out


class _SubCtx:
    """Per-subquery parse context: the enclosing scope for correlated name
    resolution plus what the unnesting rewrite needs (see
    ``logical/subquery.py``)."""

    __slots__ = ("outer_scope", "corr", "resid", "deferred_aggs",
                 "deferred_group_by", "value_names", "owned", "cte_depth")

    def __init__(self, outer_scope: Scope, cte_depth: int = 0):
        self.outer_scope = outer_scope
        self.corr = []            # [(inner_expr, outer_expr)]
        self.resid = []           # correlated NON-equality conjuncts
        #                           (outer_col markers intact)
        self.deferred_aggs = []   # select exprs when agg is deferred
        self.deferred_group_by = []  # the subquery's own GROUP BY keys
        self.value_names = []     # projected output names of the sub root
        self.owned = False        # claimed by the subquery's root SELECT
        self.cte_depth = cte_depth  # root select lives at this CTE depth


class SQLPlanner:
    def __init__(self, tables: Dict[str, "object"], session=None):
        self.tables = {k.lower(): v for k, v in tables.items()}
        self.session = session
        self.toks: List[Tok] = []
        self.i = 0
        self._sub_stack: List[_SubCtx] = []
        self._cur_ctes: Dict[str, "object"] = {}
        self._cte_depth = 0

    # -- public ------------------------------------------------------------
    def plan_query(self, query: str):
        self.toks = tokenize(query)
        self.i = 0
        df = self._query(dict(self.tables))
        self._expect_eof()
        return df

    def plan_statement(self, query: str):
        """Statement router (reference: ``src/daft-sql``'s statement layer
        + ``exec.rs``): DDL/DML — CREATE [TEMP] TABLE … AS, INSERT INTO,
        DROP TABLE, SHOW TABLES, DESCRIBE, USE — execute against the bound
        session; anything else plans as a query."""
        self.toks = tokenize(query)
        self.i = 0
        if self._peek_kw("CREATE"):
            return self._create_stmt()
        if self._peek_kw("INSERT", "INTO"):
            return self._insert_stmt()
        if self._peek_kw("DROP", "TABLE"):
            return self._drop_stmt()
        if self._peek_kw("SHOW", "TABLES"):
            return self._show_tables_stmt()
        if self._peek_kw("DESCRIBE"):
            return self._describe_stmt()
        if self._peek_kw("USE"):
            return self._use_stmt()
        return self.plan_query(query)

    # -- statements --------------------------------------------------------
    def _need_session(self, what: str):
        if self.session is None:
            raise ValueError(
                f"{what} needs a session (daft_tpu_torch.Session)")
        return self.session

    def _ident_chain(self) -> List[str]:
        parts = [self._next().text]
        while self._kw("."):
            parts.append(self._next().text)
        return parts

    def _create_stmt(self):
        self._expect("CREATE")
        replace = self._kw("OR", "REPLACE")
        temp = self._kw("TEMP") or self._kw("TEMPORARY")
        self._expect("TABLE")
        if_not_exists = self._kw("IF", "NOT", "EXISTS")
        parts = self._ident_chain()
        self._expect("AS")
        rest = self.toks[self.i:]
        self.toks = rest
        self.i = 0
        df = self._query(dict(self.tables))
        self._expect_eof()
        sess = self._need_session("CREATE TABLE")
        from ..catalog import Identifier
        if temp:
            if len(parts) != 1:
                raise ValueError("temp table names are unqualified")
            # only the TEMP namespace matters here: temp tables shadow
            # catalog tables by design, so a catalog name never blocks one
            exists = parts[0] in sess._tables
            if exists and if_not_exists:
                return df  # no-op, existing table preserved
            if exists and not replace:
                raise ValueError(f"table {parts[0]!r} already exists")
            sess.create_temp_table(parts[0], df)
            return df
        # a leading part naming an attached catalog addresses that catalog
        # (same resolution as Session.get_table)
        if len(parts) > 1 and sess.has_catalog(parts[0]):
            target = sess.get_catalog(parts[0])
            ident = Identifier(*parts[1:])
        else:
            target = sess
            ident = Identifier(*parts)
        if if_not_exists:
            target.create_table_if_not_exists(ident, df)
        elif replace:
            try:
                target.drop_table(ident)
            except Exception:
                pass
            target.create_table(ident, df)
        else:
            target.create_table(ident, df)
        return df

    def _insert_stmt(self):
        self._expect("INSERT")
        self._expect("INTO")
        parts = self._ident_chain()
        mode = "append"
        if self._kw("OVERWRITE"):
            mode = "overwrite"
        rest = self.toks[self.i:]
        self.toks = rest
        self.i = 0
        df = self._query(dict(self.tables))
        self._expect_eof()
        sess = self._need_session("INSERT INTO")
        sess.get_table(".".join(parts)).write(df, mode=mode)
        return df

    def _drop_stmt(self):
        from ..catalog import NotFoundError
        self._expect("DROP")
        self._expect("TABLE")
        if_exists = self._kw("IF", "EXISTS")
        parts = self._ident_chain()
        self._expect_eof()
        sess = self._need_session("DROP TABLE")
        try:
            sess.drop_table(".".join(parts))
        except NotFoundError:
            # IF EXISTS only forgives absence — IO/permission failures
            # still surface
            if not if_exists:
                raise
        return None

    def _show_tables_stmt(self):
        import fnmatch

        from .. import dataframe as _df
        self._expect("SHOW")
        self._expect("TABLES")
        pattern = None
        if self._kw("LIKE"):
            # SQL LIKE wildcards → fnmatch (%→*, _→?)
            raw = self._next().text.strip("'\"")
            pattern = raw.replace("%", "*").replace("_", "?")
        self._expect_eof()
        sess = self._need_session("SHOW TABLES")
        names = [str(t) for t in sess.list_tables(None)]
        if pattern is not None:
            names = [n for n in names if fnmatch.fnmatchcase(n, pattern)]
        return _df.from_pydict({"table": names})

    def _describe_stmt(self):
        from .. import dataframe as _df
        self._expect("DESCRIBE")
        parts = self._ident_chain()
        self._expect_eof()
        sess = self._need_session("DESCRIBE")
        schema = sess.get_table(".".join(parts)).schema()
        return _df.from_pydict({
            "column": [f.name for f in schema],
            "type": [str(f.dtype) for f in schema]})

    def _use_stmt(self):
        self._expect("USE")
        parts = self._ident_chain()
        self._expect_eof()
        self._need_session("USE").use(".".join(parts))
        return None

    def plan_expression(self, text: str) -> Expression:
        self.toks = tokenize(text)
        self.i = 0
        e = self._expr(scope=None)
        self._expect_eof()
        return e

    # -- cursor ------------------------------------------------------------
    def _peek(self, k: int = 0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def _next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _kw(self, *words: str) -> bool:
        """Consume keyword/punctuation sequence if present (case-insensitive).
        String/quoted-identifier tokens never match keywords."""
        save = self.i
        for w in words:
            t = self._peek()
            if w.isalpha():
                ok = t.kind == "ident" and t.text.upper() == w
            else:
                ok = t.kind == "op" and t.text == w
            if ok:
                self.i += 1
            else:
                self.i = save
                return False
        return True

    def _peek_kw(self, *words: str) -> bool:
        save = self.i
        ok = self._kw(*words)
        self.i = save
        return ok

    def _expect(self, text: str):
        t = self._next()
        if t.text.upper() != text.upper():
            raise ValueError(f"expected {text!r}, got {t.text!r}")

    def _expect_eof(self):
        if self._peek().kind != "eof":
            raise ValueError(f"unexpected trailing SQL: {self._peek().text!r}")

    # -- query -------------------------------------------------------------
    def _query(self, ctes: Dict[str, "object"]):
        if self._kw("WITH"):
            while True:
                name = self._next().text
                self._expect("AS")
                self._expect("(")
                # a CTE body must not claim an enclosing subquery's context
                # (the subquery's ROOT select owns it) — see _select
                self._cte_depth += 1
                try:
                    sub = self._query(dict(ctes))
                finally:
                    self._cte_depth -= 1
                self._expect(")")
                ctes[name.lower()] = sub
                if not self._kw(","):
                    break
        left = self._select_operand(ctes)
        while self._peek_kw("UNION") or self._peek_kw("INTERSECT") \
                or self._peek_kw("EXCEPT"):
            if self._kw("UNION"):
                all_ = self._kw("ALL")
                right = self._positional(left, self._select_operand(ctes))
                left = left.union_all(right) if all_ else left.union(right)
            elif self._kw("INTERSECT"):
                right = self._positional(left, self._select_operand(ctes))
                left = left.intersect(right)
            else:
                self._kw("EXCEPT")
                right = self._positional(left, self._select_operand(ctes))
                left = left.except_distinct(right)
        return left

    @staticmethod
    def _positional(left, right):
        """SQL set operations match columns by POSITION; rename the right
        operand's columns to the left's so the engine's name-based concat
        applies (reference resolves set-op schemas positionally too)."""
        lc, rc = list(left.column_names), list(right.column_names)
        if len(lc) != len(rc):
            raise ValueError(
                f"set operation operands have different column counts: "
                f"{len(lc)} vs {len(rc)}")
        if lc != rc:
            right = right.select(*[col(r).alias(l)
                                   for l, r in zip(lc, rc)])
        return right

    def _select_operand(self, ctes):
        """One set-operation operand: a SELECT, or a parenthesized query
        — ``(SELECT …) EXCEPT (SELECT …)`` — which may itself hold set
        ops."""
        if self._peek().text == "(" and \
                self._peek(1).text.upper() in ("SELECT", "WITH", "("):
            self._kw("(")
            sub = self._query(dict(ctes))
            self._expect(")")
            return sub
        return self._select(ctes)

    def _select(self, ctes):
        from ..dataframe import DataFrame
        prev_ctes = self._cur_ctes
        self._cur_ctes = ctes
        # the first SELECT parsed under a fresh subquery context is that
        # subquery's root: correlation pairs and deferred aggregates attach
        # to it (nested derived tables/subqueries push their own contexts)
        sub_ctx = None
        if self._sub_stack and not self._sub_stack[-1].owned \
                and self._sub_stack[-1].cte_depth == self._cte_depth:
            sub_ctx = self._sub_stack[-1]
            sub_ctx.owned = True
        try:
            return self._select_inner(ctes, sub_ctx)
        finally:
            self._cur_ctes = prev_ctes

    def _select_inner(self, ctes, sub_ctx):
        from ..dataframe import DataFrame
        self._expect("SELECT")
        distinct = self._kw("DISTINCT")
        proj: List[Tuple[Optional[Expression], Optional[str]]] = []
        while True:
            if self._peek().text == "*":
                self._next()
                proj.append((None, "*"))
            elif self._peek().kind == "ident" and self._peek(1).text == "." \
                    and self._peek(2).text == "*":
                alias = self._next().text
                self._next()
                self._next()
                proj.append((None, f"{alias}.*"))
            else:
                e = None  # parsed after FROM for scope; remember token span
                start = self.i
                self._skip_expr()
                out_alias = None
                if self._kw("AS"):
                    out_alias = self._next().text
                elif self._peek().kind == "ident" and \
                        self._peek().text.upper() not in (
                            "FROM", "WHERE", "GROUP", "ORDER", "LIMIT",
                            "HAVING", "UNION", "INTERSECT", "EXCEPT",
                            "OFFSET"):
                    out_alias = self._next().text
                proj.append(((start, self.i - (1 if out_alias and
                                               not self._prev_was_as(start) else 0)),
                             out_alias))
            if not self._kw(","):
                break

        # FROM -----------------------------------------------------------
        scope = Scope()
        if self._kw("FROM"):
            df = self._table_expr(ctes, scope)
        else:
            df = DataFrame.__new__(DataFrame)  # dummy; no-FROM SELECT
            from ..dataframe import from_pydict
            df = from_pydict({"__dummy__": [0]})
            scope.add("__dummy__", ["__dummy__"])

        where = None
        if self._kw("WHERE"):
            where = self._expr(scope)
        group_by = []
        grouping_sets = None  # list of key-lists when ROLLUP/CUBE/SETS used
        if self._kw("GROUP"):
            self._expect("BY")
            items = []
            while True:
                if self._peek_kw("ROLLUP", "("):
                    self._kw("ROLLUP", "(")
                    items.append(("rollup", self._expr_list(scope)))
                    self._expect(")")
                elif self._peek_kw("CUBE", "("):
                    self._kw("CUBE", "(")
                    items.append(("cube", self._expr_list(scope)))
                    self._expect(")")
                elif self._peek_kw("GROUPING", "SETS", "("):
                    self._kw("GROUPING", "SETS", "(")
                    sets = []
                    while True:
                        if self._kw("("):
                            ks = [] if self._peek().text == ")" \
                                else self._expr_list(scope)
                            self._expect(")")
                            sets.append(ks)
                        else:
                            sets.append([self._expr(scope)])
                        if not self._kw(","):
                            break
                    self._expect(")")
                    items.append(("sets", sets))
                else:
                    items.append(("plain", [self._expr(scope)]))
                if not self._kw(","):
                    break
            group_by, grouping_sets = _expand_group_items(items)
        having = None
        if self._kw("HAVING"):
            having = self._expr(scope)
        order_by = []
        descs = []
        if self._kw("ORDER"):
            self._expect("BY")
            lenient = _LenientScope(scope)
            while True:
                order_by.append(self._expr(lenient))
                if self._kw("DESC"):
                    descs.append(True)
                else:
                    self._kw("ASC")
                    descs.append(False)
                if not self._kw(","):
                    break
        limit = None
        offset = 0
        if self._kw("LIMIT"):
            limit = int(self._next().text)
        if self._kw("OFFSET"):
            offset = int(self._next().text)

        # re-parse projection expressions with full scope ------------------
        exprs: List[Expression] = []
        bare_alias: dict = {}  # exprs index → deferred bare-name alias
        save = self.i
        for item, alias in proj:
            if item is None:
                if alias == "*":
                    exprs.extend(col(c) for c in scope.all_columns())
                else:
                    a = alias.split(".")[0]
                    for actual in scope.tables[a.lower()].values():
                        exprs.append(col(actual))
                continue
            start, end = item
            self.i = start
            e = self._expr(scope)
            if alias is None and self.i == end - 1 \
                    and self._peek().kind == "ident":
                # implicit alias (``SELECT x total``): _skip_expr ran to
                # the delimiter, so exactly one trailing bare ident inside
                # the recorded span is the AS-less output name
                alias = self._next().text
            if alias is None and e.op in ("col", "outer_col") \
                    and end - start == 3 \
                    and self.toks[start + 1].text == "." \
                    and e.params[0] != self.toks[end - 1].text:
                # SQL names an unaliased qualified reference by its BARE
                # column name (``SELECT t.customer_id`` → customer_id) —
                # self-join collision renames must not leak internal
                # ``right.x`` names into the output schema. DEFERRED:
                # applied below only when the bare name doesn't collide
                # with another SELECT item's output name (``SELECT a.x,
                # b.x FROM t a JOIN t b`` must keep planning as
                # x / right.x, not raise on two ``x`` outputs)
                bare_alias[len(exprs)] = self.toks[end - 1].text
            if alias is not None:
                e = e.alias(alias)
            exprs.append(e)
        self.i = save
        if bare_alias:
            names = [bare_alias.get(i, e.name())
                     for i, e in enumerate(exprs)]
            for i, nm in bare_alias.items():
                if names.count(nm) == 1:
                    exprs[i] = exprs[i].alias(nm)
        # ORDER BY <integer> is a SELECT-list ordinal (SQL standard), not
        # a constant sort key (which would be a silent no-op sort)
        for j, o in enumerate(order_by):
            u = o._unalias()
            if u.op == "lit" and type(u.params[0]) is int \
                    and 1 <= u.params[0] <= len(exprs):
                order_by[j] = col(exprs[u.params[0] - 1].name())

        # assemble plan ----------------------------------------------------
        from ..logical import subquery as subq
        if where is not None:
            df = self._apply_where(df, where, sub_ctx)
        agg_mode = bool(group_by) or any(_has_agg(e) for e in exprs) \
            or (having is not None and _has_agg(having))
        if having is not None and not agg_mode:
            # HAVING binds to a grouped query; without GROUP BY or any
            # aggregate, silently dropping it would return unfiltered rows
            raise NotImplementedError(
                "HAVING without GROUP BY or aggregates")
        if sub_ctx is not None:
            sub_ctx.value_names = [e.name() for e in exprs]
            if sub_ctx.corr and agg_mode:
                # correlated aggregating subquery: the unnesting rewrite
                # re-aggregates grouped by the correlation keys ∪ the
                # subquery's own GROUP BY keys — defer both. Clauses that
                # would apply AFTER the aggregate cannot be deferred
                # faithfully: refuse rather than silently drop.
                if group_by and grouping_sets is not None:
                    raise NotImplementedError(
                        "correlated subquery with ROLLUP/GROUPING SETS")
                if having is not None or distinct or order_by \
                        or limit is not None or offset:
                    raise NotImplementedError(
                        "correlated aggregating subquery with "
                        "HAVING/DISTINCT/ORDER BY/LIMIT")
                sub_ctx.deferred_aggs = exprs
                sub_ctx.deferred_group_by = list(group_by)
                return df
            if (sub_ctx.corr or sub_ctx.resid) and not agg_mode:
                # the correlation keys AND any inner columns the residual
                # predicates reference must survive the projection for the
                # unnest join (e.g. EXISTS(SELECT 1 FROM t WHERE k = outer
                # AND t.wh <> outer.wh) needs t.wh)
                names = {e.name() for e in exprs}
                needed = set()
                for inner, _ in sub_ctx.corr:
                    needed |= subq.free_columns(inner)
                for r in sub_ctx.resid:
                    needed |= subq.free_columns(r)  # col() refs only —
                    # outer_col markers are a distinct op, not collected
                avail_here = set(df.column_names)
                for c in sorted(needed):
                    if c not in names and c in avail_here:
                        exprs.append(col(c))
                        names.add(c)
        if agg_mode:
            # select-list scalar subqueries in an aggregating query attach
            # POST-aggregation (they are uncorrelated 1-row values; a
            # correlated one would need the pre-agg frame — unsupported).
            # Applies to plain GROUP BY and ROLLUP/GROUPING SETS alike.
            sub_exprs = [e for e in exprs if subq.contains_subquery(e)]
            for e in sub_exprs:
                if _has_agg(e):
                    raise NotImplementedError(
                        "select item mixing aggregates and scalar "
                        "subqueries")
            placeholders = {id(e): lit(None).alias(e.name())
                            for e in sub_exprs}
            lower_exprs = [placeholders.get(id(e), e) for e in exprs]
            if grouping_sets is not None:
                df = self._lower_grouping_sets(df, group_by, grouping_sets,
                                               lower_exprs, having)
            else:
                df = self._lower_aggregate(df, group_by, lower_exprs,
                                           having)
            if sub_exprs:
                df = self._attach_select_subqueries(
                    df, exprs, only_ids={id(e) for e in sub_exprs})
        else:
            if any(subq.contains_subquery(e) for e in exprs):
                df, exprs = self._inline_select_subqueries(df, exprs)
            # hidden sort keys: SQL allows ordering by non-projected inputs
            hidden = []
            if order_by:
                out_names = {e.name() for e in exprs}
                for j, o in enumerate(order_by):
                    bound = _rebind_order(o, exprs)
                    if bound.op == "col" and bound.params[0] in out_names:
                        order_by[j] = bound
                    elif not (o.op == "col" and o.params[0] in out_names):
                        h = o.alias(f"__ord{j}__")
                        hidden.append(h)
                        order_by[j] = col(h.name())
            df = df.select(*(exprs + hidden))
            if distinct and not hidden:
                df = df.distinct()
            if order_by:
                df = df.sort(order_by, desc=descs)
            if hidden:
                df = df.select(*[col(e.name()) for e in exprs])
                if distinct:
                    df = df.distinct()
            order_by = []
        if distinct and (agg_mode):
            df = df.distinct()
        if order_by:
            # order keys may reference output aliases
            df = df.sort([_rebind_order(o, exprs) for o in order_by],
                         desc=descs)
        if limit is not None:
            df = df.limit(limit, offset)
        elif offset:
            df = df.offset(offset)
        return df

    def _attach_select_subqueries(self, df, exprs, only_ids):
        """Post-aggregation realization of select-list scalar subqueries:
        the aggregate was lowered with NULL placeholders for these items;
        attach each subquery's 1-row value (cross join) and re-project the
        output in order (reference: subqueries are plain Expr variants
        usable anywhere, ``src/daft-dsl/src/expr/mod.rs:213-292``)."""
        from ..logical import subquery as subq
        final = []
        for e in exprs:
            if id(e) in only_ids:
                name = e.name()
                df, e = subq.realize_scalars(df, e)
                final.append(e._unalias().alias(name))
            else:
                final.append(col(e.name()))
        return df.select(*final)

    def _inline_select_subqueries(self, df, exprs):
        """Pre-projection realization for non-aggregating selects:
        supports correlated subqueries too (the outer frame is intact)."""
        from ..logical import subquery as subq
        out = []
        for e in exprs:
            if subq.contains_subquery(e):
                name = e.name()
                df, e = subq.realize_scalars(df, e)
                e = e._unalias().alias(name)
            out.append(e)
        return df, out

    def _expr_list(self, scope) -> List[Expression]:
        out = [self._expr(scope)]
        while self._kw(","):
            out.append(self._expr(scope))
        return out

    def _pull_window_aggs(self, exprs):
        """Decompose select items that mix GROUP BY aggregates with OVER()
        windows — ``SUM(SUM(x)) OVER (…)``, ``RANK() OVER (ORDER BY
        SUM(x))``, ``SUM(x)*100/SUM(SUM(x)) OVER (PARTITION BY c)`` —
        into hidden aggregate outputs plus a post-aggregation expression
        that references them. Returns (new exprs, hidden agg exprs).
        Reference treats windows-over-aggregates the same way: the inner
        aggregate runs at the groupby, the window over the grouped frame
        (``src/daft-sql/src/modules/window.rs``)."""
        hidden: List[Expression] = []

        def mk_hidden(a: Expression) -> Expression:
            for h in hidden:
                if h._unalias().structurally_eq(a):
                    return col(h.name())
            nm = f"__wagg{len(hidden)}__"
            hidden.append(a.alias(nm))
            return col(nm)

        def pull_below(e):
            if not isinstance(e, Expression):
                return e
            if e.op.startswith("agg."):
                return mk_hidden(e)
            if not e.args:
                return e
            return e.with_children([pull_below(a) for a in e.args])

        def fix(e: Expression) -> Expression:
            if e.op == "window":
                inner = e.args[0]
                # the window's own function node stays (it computes over
                # the grouped frame); aggregates in its ARGUMENTS ran at
                # the groupby and become hidden columns
                if inner.args:
                    inner = inner.with_children(
                        [pull_below(a) for a in inner.args])
                spec = e.params[0]._copy()
                spec._partition_by = [pull_below(p)
                                      for p in spec._partition_by]
                spec._order_by = [pull_below(o) for o in spec._order_by]
                return Expression("window", (inner,), (spec,))
            if e.op.startswith("agg."):
                return mk_hidden(e)
            if not e.args:
                return e
            return e.with_children([fix(a) for a in e.args])

        out = [fix(e) if _contains_window(e) else e for e in exprs]
        return out, hidden

    def _lower_aggregate(self, df, gb_keys, exprs, having):
        """GROUP BY lowering for ONE grouping-key set: groupby + aggregate
        + HAVING filter + output projection (group keys by name, aggregates
        by alias, residual expressions — literals from ROLLUP null-fill or
        expressions over key columns — evaluated over the grouped frame).

        A HAVING with subqueries (TPC-H Q11's ``HAVING SUM(…) > (SELECT
        …)``) splits: its aggregate subtrees become hidden agg outputs and
        the residual predicate — subqueries included — applies as a WHERE
        over the grouped frame via the unnest machinery."""
        from ..logical import subquery as subq
        exprs, wagg_hidden = self._pull_window_aggs(exprs)
        agg_exprs = [e for e in exprs if _has_agg(e)] + wagg_hidden
        having_resid = None
        if having is not None:
            if subq.contains_subquery(having):
                hidden_aggs: List[Expression] = []

                def pull_aggs(e):
                    if e.op.startswith("agg."):
                        nm = f"__hv{len(hidden_aggs)}__"
                        hidden_aggs.append(e.alias(nm))
                        return col(nm)
                    if not e.args:
                        return e
                    return e.with_children([pull_aggs(a) for a in e.args])

                having_resid = pull_aggs(having)
                agg_exprs = agg_exprs + hidden_aggs
            else:
                agg_exprs = agg_exprs + [having.alias("__having__")]
        gdf = df.groupby(*gb_keys).agg(*agg_exprs) if gb_keys \
            else df.agg(*agg_exprs)
        if having_resid is not None:
            gdf = subq.apply_where(gdf, having_resid)
        elif having is not None:
            gdf = gdf.where(col("__having__"))
        sel = []
        for e in exprs:
            if _has_agg(e):
                sel.append(col(e.name()))
                continue
            inner = e._unalias()
            matched = None
            for g in gb_keys:
                if inner.structurally_eq(g) or e.structurally_eq(g):
                    matched = g.name()
                    break
            if matched is not None:
                sel.append(col(matched).alias(e.name())
                           if matched != e.name() else col(matched))
            elif inner.op == "col" and inner.params[0] in \
                    [g.name() for g in gb_keys]:
                sel.append(e)  # references an aliased group key by name
            else:
                # literal (ROLLUP null-fill) or expression over group-key
                # columns: evaluate against the grouped frame
                sel.append(e)
        return gdf.select(*sel)

    def _lower_grouping_sets(self, df, all_keys, sets, exprs, having):
        """ROLLUP / CUBE / GROUPING SETS → union of per-set aggregates
        (reference: planner.rs:390-401 lowers ROLLUP the same way). Keys
        absent from a set surface as typed NULLs — SQL's super-aggregate
        rows — and ``GROUPING(key)`` resolves to a literal 0/1 per branch,
        composing with any downstream expression for free.

        Window items (TPC-DS Q70/Q86's ``RANK() OVER (PARTITION BY
        GROUPING(a)+GROUPING(b) …)``) must rank over the UNION of
        branches, so each window's inputs (aggregates, grouping literals,
        spec expressions) are computed per branch as hidden columns and
        the window itself evaluates after the union."""
        if any(_contains_window(e) for e in exprs):
            return self._lower_grouping_sets_windows(df, all_keys, sets,
                                                     exprs, having)
        schema = df.schema()
        frames = []
        for S in sets:
            present = list(S)
            exprs_b = [self._subst_rollup(e, all_keys, present, schema)
                       for e in exprs]
            having_b = self._subst_rollup(having, all_keys, present,
                                          schema) if having is not None \
                else None
            frames.append(self._lower_aggregate(df, list(S), exprs_b,
                                                having_b))
        out = frames[0]
        for f in frames[1:]:
            out = out.union_all_by_name(f)
        return out

    def _lower_grouping_sets_windows(self, df, all_keys, sets, exprs,
                                     having):
        """Grouping-sets lowering when the select list holds window items:
        1. pull aggregates out of window nodes (hidden agg columns),
        2. extract each window's spec/argument expressions into hidden
           per-branch projections (GROUPING() → per-branch literal there),
        3. per-branch aggregate over [non-window items + hidden columns],
        4. union branches, evaluate the rebuilt windows, project."""
        exprs, wagg_hidden = self._pull_window_aggs(exprs)
        subs: List[Expression] = []
        spec_cols: set = set()  # plain columns referenced only in specs

        def mk_sub(e: Expression) -> Expression:
            if e.op == "col":
                spec_cols.add(e.params[0])
                return e  # already a frame column (hidden agg or key)
            for h in subs:
                if h._unalias().structurally_eq(e):
                    return col(h.name())
            nm = f"__wsub{len(subs)}__"
            subs.append(e.alias(nm))
            return col(nm)

        def extract(e: Expression) -> Expression:
            if e.op == "window":
                inner = e.args[0]
                if inner.args:
                    inner = inner.with_children(
                        [mk_sub(a) for a in inner.args])
                spec = e.params[0]._copy()
                spec._partition_by = [mk_sub(p)
                                      for p in spec._partition_by]
                spec._order_by = [mk_sub(o) for o in spec._order_by]
                return Expression("window", (inner,), (spec,))
            if not e.args:
                return e
            return e.with_children([extract(a) for a in e.args])

        final: List[Expression] = []       # post-union projection
        branch_items: List[Expression] = []  # per-branch select items
        for e in exprs:
            if _contains_window(e):
                final.append(extract(e)._unalias().alias(e.name()))
            else:
                branch_items.append(e)
                final.append(col(e.name()))
        # window items may also reference plain columns (keys, hidden agg
        # outputs) — ensure every free column of the rebuilt windows is in
        # the branch output
        have = {e.name() for e in branch_items} | \
               {e.name() for e in wagg_hidden} | \
               {e.name() for e in subs}
        need = set(spec_cols)  # Expression.column_names() walks args,
        for e in final:        # not the window spec stored in params
            need |= set(e.column_names())
        for c in sorted(need - have):
            branch_items.append(col(c))
        branch_items = branch_items + wagg_hidden + subs

        schema = df.schema()
        frames = []
        for S in sets:
            present = list(S)
            exprs_b = [self._subst_rollup(e, all_keys, present, schema)
                       for e in branch_items]
            having_b = self._subst_rollup(having, all_keys, present,
                                          schema) if having is not None \
                else None
            frames.append(self._lower_aggregate(df, list(S), exprs_b,
                                                having_b))
        out = frames[0]
        for f in frames[1:]:
            out = out.union_all_by_name(f)
        return out.select(*final)

    def _subst_rollup(self, e, all_keys, present, schema):
        """Per-branch rewrite: GROUPING(k) → 0/1 literal; references to
        keys OUTSIDE this grouping set → NULL cast to the key's type.

        The NULL substitution applies only to PROJECTED key references —
        never inside aggregate arguments: SQL's super-aggregate row
        computes ``count(a)`` over the real rows (nulling there returned
        count=0 on the grand total)."""
        if e.op == "sql.grouping":
            k = e.args[0]._unalias()
            is_present = any(k.structurally_eq(p._unalias())
                             for p in present)
            return lit(0 if is_present else 1)
        if e.op.startswith("agg."):
            return e
        u = e._unalias()
        if any(u.structurally_eq(k._unalias()) for k in all_keys):
            if not any(u.structurally_eq(p._unalias()) for p in present):
                dtype = u.to_field(schema).dtype
                return lit(None).cast(dtype).alias(e.name())
            return e
        if not e.args:
            return e
        return e.with_children([
            self._subst_rollup(a, all_keys, present, schema)
            for a in e.args])

    def _apply_where(self, df, where, sub_ctx):
        """Apply a WHERE clause: realize subquery nodes via unnest joins,
        and — inside a subquery — lift equality conjuncts that reference
        enclosing-scope columns into the context's correlation keys."""
        from ..logical import subquery as subq
        if sub_ctx is None and not subq.contains_subquery(where):
            return df.where(where)
        avail = set(df.column_names)

        def has_outer(e) -> bool:
            return e.op == "outer_col" or any(has_outer(a) for a in e.args)

        def unmark(e):
            """outer_col marker → plain col (for exprs that will evaluate
            against the ENCLOSING frame as join keys)."""
            if e.op == "outer_col":
                return col(e.params[0])
            if not e.args:
                return e
            return e.with_children([unmark(a) for a in e.args])

        plain = []
        for conj in subq.split_conjuncts(where):
            free = subq.free_columns(conj)
            outer = has_outer(conj)
            if not outer and (free <= avail or sub_ctx is None):
                plain.append(conj)
                continue
            u = conj._unalias()
            if sub_ctx is not None and outer \
                    and not subq.contains_subquery(u):
                if u.op == "eq":
                    a, b = u.args
                    lifted = False
                    for inner, outer_e in ((a, b), (b, a)):
                        if has_outer(inner):
                            continue
                        if subq.free_columns(inner) <= avail \
                                and has_outer(outer_e) \
                                and not subq.free_columns(outer_e):
                            sub_ctx.corr.append((inner, unmark(outer_e)))
                            lifted = True
                            break
                    if lifted:
                        continue
                # non-equality correlation (e.g. EXISTS … AND inner.wh <>
                # outer.wh, TPC-DS Q16/Q94): kept as a residual conjunct,
                # applied by the rowid-join rewrite in logical/subquery.py
                if subq.free_columns(conj) <= avail:
                    sub_ctx.resid.append(conj)
                    continue
            raise NotImplementedError(
                f"correlated predicate {conj!r}: equality correlation or "
                "single-level non-equality residuals (no nested subquery) "
                "are supported")
        if not plain:
            return df
        return subq.apply_where(df, subq.and_all(plain))

    def _parse_subquery(self, scope):
        """Parse ``(SELECT …)`` appearing as an expression operand; `scope`
        is the enclosing query's scope (for correlated name fallback)."""
        from ..logical import subquery as subq
        ctx = _SubCtx(scope if scope is not None else Scope(),
                      self._cte_depth)
        self._sub_stack.append(ctx)
        try:
            df = self._query(dict(self._cur_ctes))
        finally:
            self._sub_stack.pop()
        return subq.SubqueryInfo(
            df, ctx.corr, ctx.deferred_aggs,
            ctx.value_names if ctx.value_names else list(df.column_names),
            resid=ctx.resid, deferred_group_by=ctx.deferred_group_by)

    def _resolve_col(self, scope, name, alias=None) -> Expression:
        """Scope resolution with correlated fallback: a name unknown to the
        current scope may belong to an enclosing query's scope when we are
        inside a subquery. Outer references come back as marked
        ``outer_col`` nodes — the actual name alone cannot distinguish
        them when inner and outer tables share column names (e.g.
        ``item j`` correlated with outer ``item i`` on i_category)."""
        try:
            return col(scope.resolve(name, alias))
        except ValueError:
            for ctx in reversed(self._sub_stack):
                try:
                    actual = ctx.outer_scope.resolve(name, alias)
                except ValueError:
                    continue
                return Expression("outer_col", (), (actual,))
            raise

    def _prev_was_as(self, start: int) -> bool:
        return False

    def _skip_expr(self):
        """Skip over one projection expression (balanced parens) without
        resolving names — it is re-parsed once the FROM scope is known."""
        depth = 0
        while True:
            t = self._peek()
            if t.kind == "eof":
                return
            up = t.text.upper()
            if depth == 0 and (t.text == "," or up in (
                    "FROM", "WHERE", "GROUP", "ORDER", "LIMIT", "HAVING",
                    "UNION", "INTERSECT", "EXCEPT", "OFFSET")):
                return
            if depth == 0 and t.kind == "ident" and up == "AS":
                return
            if depth == 0 and t.kind == "ident" and self._peek(1).kind == "eof":
                self._next()
                return
            if t.text == "(":
                depth += 1
            elif t.text == ")":
                if depth == 0:
                    return
                depth -= 1
            self._next()

    # -- FROM clause -------------------------------------------------------
    def _table_expr(self, ctes, scope: Scope):
        df = self._table_factor(ctes, scope)
        while True:
            how = None
            if self._kw("CROSS", "JOIN"):
                how = "cross"
            elif self._kw("INNER", "JOIN") or self._peek_kw("JOIN"):
                self._kw("JOIN")
                how = "inner"
            elif self._kw("LEFT", "OUTER", "JOIN") or self._kw("LEFT", "JOIN"):
                how = "left"
            elif self._kw("RIGHT", "OUTER", "JOIN") or self._kw("RIGHT", "JOIN"):
                how = "right"
            elif self._kw("FULL", "OUTER", "JOIN") or self._kw("FULL", "JOIN"):
                how = "outer"
            elif self._kw("LEFT", "SEMI", "JOIN") or self._kw("SEMI", "JOIN"):
                how = "semi"
            elif self._kw("LEFT", "ANTI", "JOIN") or self._kw("ANTI", "JOIN"):
                how = "anti"
            elif self._kw(","):
                how = "cross"
            else:
                break
            right_scope = Scope()
            rdf = self._table_factor(ctes, right_scope)
            # rename colliding right columns BEFORE the ON condition
            # parses, so every later resolution sees final actual names
            # (self-join chains of any depth stay unambiguous)
            rdf, rename = self._rename_collisions(rdf, scope, right_scope)
            if how == "cross" and not self._peek_kw("ON"):
                df = self._merge_join(df, rdf, scope, right_scope, "cross",
                                      [], [], None, rename)
                continue
            if self._kw("USING"):
                self._expect("(")
                cols_u = []
                while True:
                    cols_u.append(self._next().text)
                    if not self._kw(","):
                        break
                self._expect(")")
                lo = [col(scope.resolve(c)) for c in cols_u]
                ro = [col(right_scope.resolve(c)) for c in cols_u]
                df = self._merge_join(df, rdf, scope, right_scope, how, lo,
                                      ro, None, rename, using=True)
                continue
            self._expect("ON")
            cond = self._expr_joined(scope, right_scope)
            lo, ro, residual = _split_join_condition(cond, scope, right_scope)
            df = self._merge_join(df, rdf, scope, right_scope,
                                  how if how != "cross" else "inner",
                                  lo, ro, residual, rename)
        return df

    def _rename_collisions(self, rdf, scope: Scope, right_scope: Scope):
        """Alias right-side columns that collide with the accumulated left
        scope to unique ``right[N].<name>`` actuals, updating the right
        scope in place. Keeps every plan's column names globally distinct
        (the optimizer's join rules rely on that) and makes self-join
        chains of any depth unambiguous."""
        lcols = set(scope.all_columns())

        def uniq(c: str) -> str:
            base = "right." + c
            n = 2
            while base in lcols:
                base = f"right{n}.{c}"
                n += 1
            return base

        rename = {c: uniq(c) for c in right_scope.all_columns()
                  if c in lcols}
        if rename:
            rdf = rdf.select(*[col(c).alias(rename.get(c, c))
                               for c in rdf.column_names])
            for alias in right_scope.order:
                right_scope.tables[alias] = {
                    sql: rename.get(act, act)
                    for sql, act in right_scope.tables[alias].items()}
        return rdf, rename

    def _merge_join(self, df, rdf, scope: Scope, right_scope: Scope, how,
                    lo, ro, residual, rename=None, using=False):
        """Join pre-renamed sides (see ``_rename_collisions``); the scope
        maps SQL names to the renamed actuals. Same-SQL-named equi keys
        resolve to the left copy (SQL's merged-key behavior)."""
        unrename = {v: k for k, v in (rename or {}).items()}
        ro_names = [e.name() for e in ro]
        lo_names = [e.name() for e in lo]
        out = None
        if residual is not None and how in ("left", "right", "outer"):
            # an outer join's ON residual filters the MATCH, not the rows:
            # a side-local residual pre-filters that side (equivalent);
            # one touching the preserved side (or both) needs true
            # theta-join semantics — lowered via row identity below
            resid_cols = set(residual.column_names())
            if how == "left" and resid_cols <= set(rdf.column_names):
                rdf = rdf.where(residual)
                residual = None
            elif how == "right" and resid_cols <= set(df.column_names):
                df = df.where(residual)
                residual = None
            else:
                out = self._theta_outer_join(df, rdf, lo, ro, residual,
                                             how)
                residual = None
        if out is None and how == "outer" and not using:
            # the DataFrame tier follows the reference and COALESCES outer
            # join keys; SQL's ON-join semantics keep both sides (a
            # right-only row has NULL left keys — TPC-DS Q97's channel
            # buckets depend on it), so SQL full-outer ON-joins take the
            # row-identity lowering. USING keeps the coalesce — that IS
            # its required semantics (COALESCE(l.k, r.k) as one column).
            out = self._theta_outer_join(df, rdf, lo, ro, None, how)
        theta = out is not None
        if theta:
            pass
        elif how == "cross":
            out = df.join(rdf, how="cross")
        else:
            out = df.join(rdf, left_on=lo, right_on=ro, how=how)
        for alias in right_scope.order:
            m = {}
            for sqlname, act in right_scope.tables[alias].items():
                if how in ("semi", "anti"):
                    continue
                # theta lowering keeps BOTH key copies with exact SQL
                # semantics (each side's copy is NULL on the other side's
                # missing piece) — the merged-key remap would resolve the
                # preserved side's key to a NULL left copy
                if act in ro_names and how not in ("outer",) and not theta:
                    ki = ro_names.index(act)
                    orig = unrename.get(act, act)
                    if ki < len(lo_names) and lo_names[ki] == orig:
                        m[sqlname] = lo_names[ki]  # merged key: left copy
                        continue
                m[sqlname] = act
            scope.tables[alias] = m
            scope.order.append(alias)
        if residual is not None:
            out = out.where(residual)
        return out

    def _theta_outer_join(self, df, rdf, lo, ro, residual, how):
        """LEFT/RIGHT/FULL OUTER join whose ON residual touches the
        preserved side (or both sides) — true theta-join semantics via row
        identity: the match set is the inner equi-join filtered by the
        residual; preserved rows with no surviving match re-enter with
        NULLs on the other side. The reference covers these through
        plan-level join predicates
        (``src/daft-logical-plan/src/optimization/rules/`` — the
        EliminateCrossJoin / join-predicate push family)."""
        from ..logical.subquery import _uid
        left_cols = list(df.column_names)
        right_cols = list(rdf.column_names)
        lrid = f"__thrid{next(_uid)}__"
        rrid = f"__thrid{next(_uid)}__"
        tl = df.add_monotonically_increasing_id(lrid)
        tr = rdf.add_monotonically_increasing_id(rrid)
        if lo:
            inner = tl.join(tr, left_on=lo, right_on=ro, how="inner")
        else:
            inner = tl.join(tr, how="cross")
        if residual is not None:
            inner = inner.where(residual)
        lsch, rsch = df.schema(), rdf.schema()
        both = [col(c) for c in left_cols + right_cols]
        pieces = [inner.select(*both)]
        if how in ("left", "outer"):
            missing = tl.join(inner.select(col(lrid)).distinct(),
                              left_on=[col(lrid)], right_on=[col(lrid)],
                              how="anti")
            pieces.append(missing.select(
                *([col(c) for c in left_cols]
                  + [lit(None).cast(rsch[c].dtype).alias(c)
                     for c in right_cols])))
        if how in ("right", "outer"):
            missing = tr.join(inner.select(col(rrid)).distinct(),
                              left_on=[col(rrid)], right_on=[col(rrid)],
                              how="anti")
            pieces.append(missing.select(
                *([lit(None).cast(lsch[c].dtype).alias(c)
                   for c in left_cols]
                  + [col(c) for c in right_cols])))
        out = pieces[0]
        for p in pieces[1:]:
            out = out.concat(p)
        return out

    def _table_factor(self, ctes, scope: Scope):
        if self._kw("("):
            sub = self._query(dict(ctes))
            self._expect(")")
            alias = None
            if self._kw("AS"):
                alias = self._next().text
            elif self._peek().kind == "ident" and \
                    self._peek().text.upper() not in _CLAUSE_WORDS:
                alias = self._next().text
            alias = alias or f"__subq{len(scope.order)}__"
            scope.add(alias, sub.column_names)
            return sub
        name = self._next().text
        # qualified names: cat.ns.table → single dotted lookup key
        while self._peek().text == "." and self.toks[self.i + 1].kind == "ident":
            self._next()
            name += "." + self._next().text
        # table functions: read_parquet('...') etc.
        if self._peek().text == "(" and name.lower() in (
                "read_parquet", "read_csv", "read_json"):
            self._next()
            path = self._next().text
            self._expect(")")
            from .. import io as _io
            df = getattr(_io, name.lower())(path)
        else:
            key = name.lower()
            df = ctes[key] if key in ctes else self.tables.get(key)
            if df is None and self.session is not None:
                from ..catalog import NotFoundError
                for candidate in (name, key):
                    try:
                        df = self.session.get_table(candidate).read()
                        break
                    except NotFoundError:
                        pass
            if df is None:
                raise ValueError(f"unknown table {name!r}")
            name = name.rsplit(".", 1)[-1]
        alias = None
        if self._kw("AS"):
            alias = self._next().text
        elif self._peek().kind == "ident" and \
                self._peek().text.upper() not in _CLAUSE_WORDS:
            alias = self._next().text
        scope.add((alias or name), df.column_names)
        return df

    # -- expressions -------------------------------------------------------
    def _expr_joined(self, left_scope: Scope, right_scope: Scope) -> Expression:
        merged = Scope()
        merged.tables = {**right_scope.tables, **left_scope.tables}
        merged.order = left_scope.order + right_scope.order
        return self._expr(merged)

    def _expr(self, scope: Optional[Scope]) -> Expression:
        return self._or_expr(scope)

    def _or_expr(self, scope) -> Expression:
        e = self._and_expr(scope)
        while self._kw("OR"):
            e = e | self._and_expr(scope)
        return e

    def _and_expr(self, scope) -> Expression:
        e = self._not_expr(scope)
        while self._kw("AND"):
            e = e & self._not_expr(scope)
        return e

    def _not_expr(self, scope) -> Expression:
        if self._kw("NOT"):
            return ~self._not_expr(scope)
        return self._cmp_expr(scope)

    def _cmp_expr(self, scope) -> Expression:
        e = self._add_expr(scope)
        while True:
            t = self._peek()
            if t.text in ("=", "<", ">", "<=", ">=", "<>", "!="):
                self._next()
                r = self._add_expr(scope)
                e = {"=": e == r, "<": e < r, ">": e > r, "<=": e <= r,
                     ">=": e >= r, "<>": e != r, "!=": e != r}[t.text]
                continue
            neg = False
            save = self.i
            if self._kw("NOT"):
                neg = True
            if self._kw("BETWEEN"):
                lo = self._add_expr(scope)
                self._expect("AND")
                hi = self._add_expr(scope)
                b = e.between(lo, hi)
                e = ~b if neg else b
                continue
            if self._kw("IN"):
                self._expect("(")
                if self._peek_kw("SELECT") or self._peek_kw("WITH"):
                    from ..logical import subquery as subq
                    info = self._parse_subquery(scope)
                    self._expect(")")
                    b = subq.in_expr(e, info)
                    e = ~b if neg else b
                    continue
                items = []
                while True:
                    items.append(self._expr(scope))
                    if not self._kw(","):
                        break
                self._expect(")")
                b = e.is_in([i.params[0] if i.op == "lit" else i
                             for i in items])
                e = ~b if neg else b
                continue
            if self._kw("LIKE"):
                pat = self._next().text
                rx = "^" + re.escape(pat).replace("%", ".*").replace("_", ".") \
                    + "$"
                b = e.str.match(rx)
                e = ~b if neg else b
                continue
            if self._kw("IS"):
                isnot = self._kw("NOT")
                self._expect("NULL")
                e = e.not_null() if isnot else e.is_null()
                continue
            if neg:
                self.i = save
            break
        return e

    def _add_expr(self, scope) -> Expression:
        e = self._mul_expr(scope)
        while True:
            t = self._peek().text
            if t == "+":
                self._next()
                e = e + self._mul_expr(scope)
            elif t == "-":
                self._next()
                e = e - self._mul_expr(scope)
            elif t == "||":
                self._next()
                e = e.str.concat(self._mul_expr(scope))
            else:
                return e

    def _mul_expr(self, scope) -> Expression:
        e = self._unary_expr(scope)
        while True:
            t = self._peek().text
            if t == "*":
                self._next()
                e = e * self._unary_expr(scope)
            elif t == "/":
                self._next()
                e = e / self._unary_expr(scope)
            elif t == "%":
                self._next()
                e = e % self._unary_expr(scope)
            else:
                return e

    def _unary_expr(self, scope) -> Expression:
        if self._peek().text == "-":
            self._next()
            return -self._unary_expr(scope)
        if self._peek().text == "+":
            self._next()
            return self._unary_expr(scope)
        e = self._primary(scope)
        while self._peek().text == "::":
            self._next()
            tname = self._next().text
            e = e.cast(_sql_type(tname, self))
        return e

    def _primary(self, scope) -> Expression:
        t = self._next()
        if t.text == "(":
            if self._peek_kw("SELECT") or self._peek_kw("WITH"):
                from ..logical import subquery as subq
                info = self._parse_subquery(scope)
                self._expect(")")
                return subq.scalar_expr(info)
            e = self._expr(scope)
            self._expect(")")
            return e
        if t.kind == "num":
            txt = t.text
            return lit(float(txt)) if ("." in txt or "e" in txt.lower()) \
                else lit(int(txt))
        if t.kind == "str":
            return lit(t.text)
        if t.kind != "ident":
            raise ValueError(f"unexpected token {t.text!r} in expression")
        up = t.text.upper()
        if up == "NULL":
            return lit(None)
        if up == "TRUE":
            return lit(True)
        if up == "FALSE":
            return lit(False)
        if up == "DATE":
            s = self._next().text
            y, m, d = s.split("-")
            return lit(datetime.date(int(y), int(m), int(d)))
        if up == "TIMESTAMP":
            s = self._next().text
            return lit(datetime.datetime.fromisoformat(s))
        if up == "INTERVAL":
            s = self._next().text
            qty, unit = s.split(" ", 1) if " " in s else (s, self._next().text)
            return _interval(int(qty), unit)
        if up == "EXISTS" and self._peek().text == "(":
            from ..logical import subquery as subq
            self._next()
            info = self._parse_subquery(scope)
            self._expect(")")
            return subq.exists_expr(info)
        if up == "CASE":
            return self._case(scope)
        if up == "CAST":
            self._expect("(")
            e = self._expr(scope)
            self._expect("AS")
            tname = self._next().text
            dt = _sql_type(tname, self)
            self._expect(")")
            return e.cast(dt)
        if up == "EXTRACT":
            self._expect("(")
            part = self._next().text.lower()
            self._expect("FROM")
            e = self._expr(scope)
            self._expect(")")
            return getattr(e.dt, part)()
        # function call?
        if self._peek().text == "(":
            return self._function(t.text, scope)
        # qualified identifier
        if self._peek().text == ".":
            self._next()
            colname = self._next().text
            if scope is None:
                return col(colname)
            return self._resolve_col(scope, colname, t.text)
        if scope is None:
            return col(t.text)
        return self._resolve_col(scope, t.text)

    def _case(self, scope) -> Expression:
        base = None
        if not self._peek_kw("WHEN"):
            base = self._expr(scope)
        branches = []
        while self._kw("WHEN"):
            cond = self._expr(scope)
            self._expect("THEN")
            val = self._expr(scope)
            branches.append((cond, val))
        default = lit(None)
        if self._kw("ELSE"):
            default = self._expr(scope)
        self._expect("END")
        out = default
        for cond, val in reversed(branches):
            c = (base == cond) if base is not None else cond
            out = c.if_else(val, out)
        return out

    def _function(self, name: str, scope) -> Expression:
        self._expect("(")
        fn = name.lower()
        distinct = False
        if fn == "count" and self._peek().text == "*":
            self._next()
            self._expect(")")
            return lit(1).count("all").alias("count")
        if self._kw("DISTINCT"):
            distinct = True
        args: List[Expression] = []
        if self._peek().text != ")":
            while True:
                args.append(self._expr(scope))
                if not self._kw(","):
                    break
        self._expect(")")
        if self._peek_kw("OVER"):
            return self._window_call(fn, args, scope)
        try:
            return _apply_function(fn, args, distinct)
        except ValueError as e:
            # not a built-in: fall back to session-attached UDFs (built-ins
            # keep precedence so attaching e.g. "sum" can't shadow SUM)
            if (str(e).startswith("unknown SQL function")
                    and self.session is not None
                    and fn in self.session._functions):
                if distinct:
                    raise ValueError(
                        f"DISTINCT is not supported for attached UDF {fn!r}")
                return self.session._functions[fn](*args)
            raise

    # -- window functions --------------------------------------------------
    _WINDOW_FNS = {"row_number", "rank", "dense_rank", "lag", "lead",
                   "sum", "avg", "mean", "min", "max", "count", "ntile"}

    def _window_call(self, fn: str, args: List[Expression],
                     scope) -> Expression:
        """``fn(args) OVER (PARTITION BY … ORDER BY … [frame])`` →
        Expression.over(Window) on the DataFrame window path
        (reference: ``src/daft-sql/src/modules/window.rs``)."""
        from ..window import Window
        self._kw("OVER")
        self._expect("(")
        w = Window()
        if self._kw("PARTITION"):
            self._expect("BY")
            parts = []
            while True:
                parts.append(self._expr(scope))
                if not self._kw(","):
                    break
            w = w.partition_by(*parts)
        if self._kw("ORDER"):
            self._expect("BY")
            obs, descs = [], []
            while True:
                obs.append(self._expr(scope))
                if self._kw("DESC"):
                    descs.append(True)
                else:
                    self._kw("ASC")
                    descs.append(False)
                if not self._kw(","):
                    break
            w = w.order_by(*obs, desc=descs)
        if self._peek_kw("ROWS") or self._peek_kw("RANGE"):
            mode = self._next().text.lower()
            w = self._window_frame(w, mode)
        self._expect(")")

        if fn not in self._WINDOW_FNS:
            raise ValueError(f"unsupported window function {fn!r}")
        if fn == "row_number":
            from ..functions import row_number
            return row_number().over(w)
        if fn == "rank":
            from ..functions import rank
            return rank().over(w)
        if fn == "dense_rank":
            from ..functions import dense_rank
            return dense_rank().over(w)
        if fn in ("lag", "lead"):
            if not args:
                raise ValueError(f"{fn} requires an argument")
            offset = 1
            default = None
            if len(args) >= 2:
                if args[1].op != "lit":
                    raise ValueError(f"{fn} offset must be a literal")
                offset = int(args[1].params[0])
            if len(args) >= 3:
                default = args[2]
            base = args[0]
            e = base.lag(offset, default) if fn == "lag" \
                else base.lead(offset, default)
            return e.over(w)
        # windowed aggregates
        agg = _apply_function("avg" if fn == "mean" else fn, args, False)
        return agg.over(w)

    def _window_frame(self, w, mode: str):
        from ..window import Window
        self._expect("BETWEEN")

        def bound():
            if self._kw("UNBOUNDED"):
                if self._kw("PRECEDING"):
                    return Window.unbounded_preceding
                self._expect("FOLLOWING")
                return Window.unbounded_following
            if self._kw("CURRENT"):
                self._expect("ROW")
                return 0
            n = int(self._next().text)
            if self._kw("PRECEDING"):
                return -n
            self._expect("FOLLOWING")
            return n

        lo = bound()
        self._expect("AND")
        hi = bound()
        if mode == "rows":
            return w.rows_between(lo, hi)
        return w.range_between(lo, hi)

class _LenientScope:
    """ORDER BY may reference projection output aliases not yet in scope."""

    def __init__(self, scope: Scope):
        self._scope = scope
        self.tables = scope.tables
        self.order = scope.order

    def resolve(self, name: str, alias: Optional[str] = None) -> str:
        try:
            return self._scope.resolve(name, alias)
        except ValueError:
            return name

    def all_columns(self):
        return self._scope.all_columns()


_CLAUSE_WORDS = {"ON", "USING", "WHERE", "GROUP", "ORDER", "LIMIT", "HAVING",
                 "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "UNION",
                 "INTERSECT", "EXCEPT", "AS", "SEMI", "ANTI", "OFFSET",
                 "OUTER", "AND", "OR", "NOT", "SELECT", "FROM", "WITH", "BY"}


def _interval(qty: int, unit: str) -> Expression:
    unit = unit.lower().rstrip("s")
    kw = {"year": "years", "month": "months", "day": "days", "hour": "hours",
          "minute": "minutes", "second": "seconds"}[unit]
    from ..expressions.expressions import interval
    return interval(**{kw: qty})


def _sql_type(name: str, planner: SQLPlanner) -> DataType:
    n = name.lower()
    m = {"int": DataType.int32, "integer": DataType.int32,
         "bigint": DataType.int64, "smallint": DataType.int16,
         "tinyint": DataType.int8, "float": DataType.float32,
         "real": DataType.float32, "double": DataType.float64,
         "text": DataType.string, "varchar": DataType.string,
         "string": DataType.string, "boolean": DataType.bool,
         "bool": DataType.bool, "date": DataType.date,
         "binary": DataType.binary, "bytea": DataType.binary,
         "timestamp": lambda: DataType.timestamp(TimeUnit.us)}
    if n == "decimal" or n == "numeric":
        if planner._peek().text == "(":
            planner._next()
            p = int(planner._next().text)
            planner._expect(",")
            s = int(planner._next().text)
            planner._expect(")")
            return DataType.decimal128(p, s)
        return DataType.decimal128(38, 10)
    if n in ("varchar", "char") and planner._peek().text == "(":
        planner._next()
        planner._next()
        planner._expect(")")
        return DataType.string()
    if n not in m:
        raise ValueError(f"unknown SQL type {name!r}")
    return m[n]()


def _expand_group_items(items):
    """GROUP BY item list → (all keys in first-appearance order, grouping
    sets or None). A plain-only list returns ``(keys, None)`` — the single
    groupby fast path. Mixed items cross-product per SQL:
    ``GROUP BY x, ROLLUP(a, b)`` → sets {x,a,b}, {x,a}, {x}."""
    if all(kind == "plain" for kind, _ in items):
        return [p[0] for _, p in items], None
    import itertools as it
    base: List[List[Expression]] = [[]]
    for kind, payload in items:
        if kind == "plain":
            opts = [[payload[0]]]
        elif kind == "rollup":
            opts = [list(payload[:i]) for i in range(len(payload), -1, -1)]
        elif kind == "cube":
            opts = [list(c) for r in range(len(payload), -1, -1)
                    for c in it.combinations(payload, r)]
        else:  # explicit GROUPING SETS
            opts = [list(s) for s in payload]
        base = [b + o for b in base for o in opts]

    def dedupe(ks):
        out = []
        for k in ks:
            if not any(k._unalias().structurally_eq(x._unalias())
                       for x in out):
                out.append(k)
        return out

    all_keys = dedupe([k for kind, payload in items
                       for k in (payload if kind != "sets"
                                 else [x for s in payload for x in s])])
    uniq, seen = [], set()
    for S in base:
        S = dedupe(S)
        sk = tuple(sorted(a._unalias()._key() for a in S))
        if sk not in seen:
            seen.add(sk)
            uniq.append(S)
    return all_keys, uniq


def _apply_function(fn: str, args: List[Expression],
                    distinct: bool) -> Expression:
    a = args[0] if args else None
    if fn == "grouping":
        # GROUPING(key) marker: resolved to a per-branch literal (0 = key
        # grouped, 1 = super-aggregate NULL) by the ROLLUP/CUBE/GROUPING
        # SETS lowering; reaching execution unresolved is an error.
        return Expression("sql.grouping", (a,))
    if fn in ("sum",):
        return a.sum()
    if fn in ("avg", "mean"):
        return a.mean()
    if fn == "min":
        return a.min()
    if fn == "max":
        return a.max()
    if fn == "count":
        return a.count_distinct() if distinct else a.count()
    if fn in ("stddev", "stddev_pop"):
        return a.stddev()
    if fn in ("var", "variance"):
        return a.var()
    if fn == "any_value":
        return a.any_value()
    if fn == "approx_count_distinct":
        return a.approx_count_distinct()
    if fn == "abs":
        return abs(a)
    if fn == "round":
        return a.round(int(args[1].params[0]) if len(args) > 1 else 0)
    if fn in ("ceil", "ceiling"):
        return a.ceil()
    if fn == "floor":
        return a.floor()
    if fn == "sqrt":
        return a.sqrt()
    if fn in ("ln",):
        return a.ln()
    if fn == "log":
        return a.log10() if len(args) == 1 else args[1].log(args[0].params[0])
    if fn == "exp":
        return a.exp()
    if fn == "power" or fn == "pow":
        return a ** args[1]
    if fn == "coalesce":
        return coalesce(*args)
    if fn == "nullif":
        return (a == args[1]).if_else(lit(None), a)
    if fn == "upper":
        return a.str.upper()
    if fn == "lower":
        return a.str.lower()
    if fn in ("length", "char_length"):
        return a.str.length()
    if fn == "trim":
        return a.str.strip()
    if fn == "ltrim":
        return a.str.lstrip()
    if fn == "rtrim":
        return a.str.rstrip()
    if fn == "reverse":
        return a.str.reverse()
    if fn in ("substr", "substring"):
        start = args[1] - 1  # SQL is 1-based
        length = args[2] if len(args) > 2 else None
        return a.str.substr(start, length)
    if fn == "replace":
        return a.str.replace(args[1], args[2])
    if fn == "starts_with":
        return a.str.startswith(args[1])
    if fn == "ends_with":
        return a.str.endswith(args[1])
    if fn == "contains":
        return a.str.contains(args[1])
    if fn == "concat":
        out = args[0]
        for x in args[1:]:
            out = out.str.concat(x)
        return out
    if fn == "split":
        return a.str.split(args[1])
    if fn in ("regexp_match",):
        return a.str.match(args[1].params[0])
    if fn in ("regexp_extract",):
        return a.str.extract(args[1], 0)
    if fn in ("regexp_extract_all",):
        return a.str.extract_all(args[1], 0)
    if fn in ("regexp_replace",):
        return a.str.replace(args[1], args[2], regex=True)
    if fn in ("lpad", "rpad"):
        length = args[1]
        pad = args[2] if len(args) > 2 else Expression._lit(" ")
        ns = a.str
        return (ns.lpad if fn == "lpad" else ns.rpad)(length, pad)
    if fn == "repeat":
        return a.str.repeat(args[1])
    if fn == "normalize":
        return a.str.normalize()
    if fn in ("starts_with", "startswith"):
        return a.str.startswith(args[1])
    if fn in ("ends_with", "endswith"):
        return a.str.endswith(args[1])
    if fn in ("ltrim",):
        return a.str.lstrip()
    if fn in ("rtrim",):
        return a.str.rstrip()
    if fn in ("trim",):
        return a.str.strip()
    if fn == "reverse":
        return a.str.reverse()
    if fn == "capitalize":
        return a.str.capitalize()
    if fn in ("left",):
        return a.str.left(args[1])
    if fn in ("right",):
        return a.str.right(args[1])
    if fn in ("find", "instr"):
        return a.str.find(args[1])
    if fn == "count_matches":
        return a.str.count_matches(args[1].params[0])
    if fn == "tokenize_encode":
        return a.str.tokenize_encode(args[1].params[0])
    if fn == "tokenize_decode":
        return a.str.tokenize_decode(args[1].params[0])
    if fn in ("year", "month", "day", "hour", "minute", "second", "quarter"):
        return getattr(a.dt, fn)()
    if fn == "day_of_week" or fn == "dayofweek":
        return a.dt.day_of_week()
    if fn == "date_trunc":
        return args[1].dt.truncate(args[0].params[0])
    if fn == "to_date":
        return a.str.to_date(args[1].params[0] if len(args) > 1 else "%Y-%m-%d")
    if fn == "if" or fn == "iif":
        return a.if_else(args[1], args[2])
    if fn == "greatest":
        from ..functions import columns_max
        return columns_max(*args)
    if fn == "least":
        from ..functions import columns_min
        return columns_min(*args)
    if fn == "hash":
        return a.hash()
    if fn == "row_number":
        from ..functions import row_number
        return row_number()
    if fn == "rank":
        from ..functions import rank
        return rank()
    if fn == "dense_rank":
        from ..functions import dense_rank
        return dense_rank()
    if fn == "list_value_counts":
        return a.list.value_counts()
    raise ValueError(f"unknown SQL function {fn!r}")


def _has_agg(e: Expression) -> bool:
    # an aggregate INSIDE an OVER(...) window is not a groupby aggregate —
    # it rides the Window plan node instead
    if e.op == "window":
        return False
    if e.op.startswith("agg."):
        return True
    return any(_has_agg(c) for c in e.args)


def _contains_window(e: Expression) -> bool:
    if e.op == "window":
        return True
    return any(_contains_window(c) for c in e.args)


def _split_join_condition(cond: Expression, left_scope: Scope,
                          right_scope: Scope):
    """ON clause → (left_on, right_on, residual_filter)."""
    from ..logical.optimizer import split_conjuncts, combine_conjuncts
    left_cols = set()
    for a in left_scope.order:
        left_cols.update(left_scope.tables[a].values())
    right_cols = set()
    for a in right_scope.order:
        right_cols.update(right_scope.tables[a].values())
    lo, ro, rest = [], [], []
    for c in split_conjuncts(cond):
        if c.op == "eq":
            l, r = c.args
            lc, rc = set(l.column_names()), set(r.column_names())
            if lc <= left_cols and rc <= right_cols:
                lo.append(l)
                ro.append(r)
                continue
            if lc <= right_cols and rc <= left_cols:
                lo.append(r)
                ro.append(l)
                continue
        rest.append(c)
    if not lo:
        raise ValueError("join ON clause needs at least one equality "
                         "between left and right columns")
    residual = combine_conjuncts(rest) if rest else None
    return lo, ro, residual


def _rebind_order(e: Expression, proj: List[Expression]) -> Expression:
    """ORDER BY may reference either output aliases or projected expressions."""
    for p in proj:
        if e.structurally_eq(p._unalias()) or e.structurally_eq(p):
            return col(p.name())
        if e.op == "col" and e.params[0] == p.name():
            return e
    if _contains_grouping(e):
        # ``ORDER BY CASE WHEN GROUPING(a)+GROUPING(b) = 0 THEN a END``
        # (TPC-DS Q70/Q86): GROUPING() exists only inside the per-branch
        # rollup lowering — rebind any subtree that matches a projected
        # item's body to that output column (``lochierarchy``-style)
        def sub(x: Expression) -> Expression:
            for p in proj:
                if x.structurally_eq(p._unalias()):
                    return col(p.name())
            if not x.args:
                return x
            return x.with_children([sub(a) for a in x.args])
        e = sub(e)
        if _contains_grouping(e):
            raise NotImplementedError(
                "GROUPING() in ORDER BY must match a projected "
                "expression (e.g. project it AS lochierarchy)")
    return e


def _contains_grouping(e: Expression) -> bool:
    if e.op == "sql.grouping":
        return True
    return any(_contains_grouping(c) for c in e.args)
