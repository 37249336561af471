"""Spark Connect relation/expression → daft_tpu_torch translation.

The port's copy of ``daft_tpu/connect/analyzer.py``. Reference
capability: the embedded Spark Connect server's analyzer
(``src/daft-connect/src/spark_analyzer/mod.rs`` translates Spark relation
protos into the engine's LogicalPlan; function-name mapping in
``src/daft-connect/src/functions/``). Here the target is the port's
DataFrame/Expression API directly — every supported ``Relation`` variant maps
onto the equivalent DataFrame verb and unresolved Spark function names map
onto Expression methods. Unsupported variants raise ``Unsupported`` which the
server surfaces as grpc UNIMPLEMENTED.
"""

from __future__ import annotations

import datetime
import io
from typing import Dict, List, Optional

import pyarrow as pa

from . import spark_connect_subset_pb2 as pb


class Unsupported(Exception):
    """Relation / expression / function outside the implemented subset."""


def _require(cond: bool, what: str):
    if not cond:
        raise Unsupported(what)


class SparkAnalyzer:
    """Translates one session's plans. ``views`` maps temp-view names to
    daft_tpu_torch DataFrames (populated by CreateDataFrameViewCommand)."""

    def __init__(self, views: Optional[Dict[str, object]] = None):
        self.views = views if views is not None else {}

    # ------------------------------------------------------------- plans
    def plan_to_df(self, plan: pb.Plan):
        _require(plan.WhichOneof("op_type") == "root",
                 "only Plan.root is executable as a query")
        return self.relation_to_df(plan.root)

    def relation_to_df(self, rel: pb.Relation):
        kind = rel.WhichOneof("rel_type")
        _require(kind is not None,
                 "relation outside the supported subset (unknown rel_type)")
        fn = getattr(self, f"_rel_{kind}", None)
        _require(fn is not None, f"relation type {kind!r}")
        return fn(getattr(rel, kind))

    # ----------------------------------------------------- relation impls
    def _rel_range(self, r: pb.Range):
        from ..dataframe import range as df_range
        start = r.start if r.HasField("start") else 0
        step = r.step or 1
        nparts = r.num_partitions if r.HasField("num_partitions") else 1
        return df_range(start, r.end, step, partitions=max(nparts, 1))

    def _rel_sql(self, r: pb.SQL):
        import daft_tpu_torch as dt
        from ..sql.sql import SQLCatalog
        if self.views:
            return dt.sql(r.query, catalog=SQLCatalog(dict(self.views)))
        return dt.sql(r.query)

    def _rel_read(self, r: pb.Read):
        import daft_tpu_torch as dt
        which = r.WhichOneof("read_type")
        if which == "named_table":
            name = r.named_table.unparsed_identifier
            if name in self.views:
                return self.views[name]
            from .. import session as sess
            return sess.read_table(name)
        _require(which == "data_source", "read without source")
        ds = r.data_source
        fmt = (ds.format or "parquet").lower()
        paths = list(ds.paths)
        _require(bool(paths), "read.data_source without paths")
        readers = {"parquet": dt.read_parquet, "csv": dt.read_csv,
                   "json": dt.read_json}
        _require(fmt in readers, f"read format {fmt!r}")
        return readers[fmt](paths if len(paths) > 1 else paths[0])

    def _rel_local_relation(self, r: pb.LocalRelation):
        import daft_tpu_torch as dt
        if not r.HasField("data"):
            # schema-only: an empty frame with the declared columns
            _require(r.HasField("schema"),
                     "LocalRelation without data or schema")
            proto = parse_ddl(r.schema)
            _require(proto.WhichOneof("kind") == "struct",
                     "LocalRelation schema must be a struct DDL")
            cols = {f.name: pa.array([], type=proto_to_dtype(
                f.data_type).to_arrow()) for f in proto.struct.fields}
            return dt.from_arrow(pa.table(cols))
        with pa.ipc.open_stream(pa.BufferReader(r.data)) as rd:
            table = rd.read_all()
        return dt.from_arrow(table)

    def _rel_to_schema(self, r: pb.ToSchema):
        """Cast to the declared struct schema, column by name (pyspark's
        createDataFrame-with-schema path)."""
        from daft_tpu_torch import col
        df = self.relation_to_df(r.input)
        _require(r.schema.WhichOneof("kind") == "struct",
                 "to_schema needs a struct DataType")
        exprs = []
        for f in r.schema.struct.fields:
            _require(f.name in df.column_names,
                     f"to_schema: column {f.name!r} missing")
            exprs.append(col(f.name).cast(
                proto_to_dtype(f.data_type)).alias(f.name))
        return df.select(*exprs)

    def _rel_html_string(self, r: pb.HtmlString):
        """Spark's _repr_html_ path: one row, one column of rendered HTML.
        Cell values and headers are escaped — data must never inject
        markup."""
        import html as _html

        import daft_tpu_torch as dt
        rows, names, truncated = self._fetch_rows(r.input, r.num_rows)
        out = ["<table border='1'>", "<tr>"]
        out += [f"<th>{_html.escape(n)}</th>" for n in names]
        out.append("</tr>")
        for row in rows:
            out.append("<tr>" + "".join(
                f"<td>{_html.escape(_fmt_cell(row[c], r.truncate))}</td>"
                for c in names) + "</tr>")
        out.append("</table>")
        if truncated:
            out.append(f"only showing top {r.num_rows} rows")
        return dt.from_pydict({"html_string": ["\n".join(out) + "\n"]})

    def _fetch_rows(self, input_rel: pb.Relation, num_rows: int):
        """Shared show/html prologue: first num_rows(+1 to detect
        truncation) rows as dicts plus column names."""
        df = self.relation_to_df(input_rel).limit(num_rows + 1)
        rows = df.to_pylist()
        truncated = len(rows) > num_rows
        return rows[:num_rows], df.column_names, truncated

    def _rel_project(self, r: pb.Project):
        df = self.relation_to_df(r.input)
        cols = []
        for e in r.expressions:
            if e.WhichOneof("expr_type") == "unresolved_star":
                cols.extend(df.columns)
            else:
                cols.append(self.expr(e))
        return df.select(*cols)

    def _rel_filter(self, r: pb.Filter):
        return self.relation_to_df(r.input).where(self.expr(r.condition))

    def _rel_limit(self, r: pb.Limit):
        return self.relation_to_df(r.input).limit(r.limit)

    def _rel_offset(self, r: pb.Offset):
        return self.relation_to_df(r.input).offset(r.offset)

    def _rel_tail(self, r: pb.Tail):
        df = self.relation_to_df(r.input)
        n = df.count_rows()
        return df.limit(r.limit, offset=max(n - r.limit, 0))

    def _rel_sort(self, r: pb.Sort):
        df = self.relation_to_df(r.input)
        by, desc = [], []
        for o in r.order:
            by.append(self.expr(o.child))
            desc.append(o.direction ==
                        pb.Expression.SortOrder.SORT_DIRECTION_DESCENDING)
        return df.sort(by, desc=desc)

    def _rel_aggregate(self, r: pb.Aggregate):
        df = self.relation_to_df(r.input)
        _require(r.group_type in (
            pb.Aggregate.GROUP_TYPE_GROUPBY,
            pb.Aggregate.GROUP_TYPE_UNSPECIFIED),
            "only GROUPBY aggregation (no rollup/cube/pivot)")
        aggs = [self.expr(e) for e in r.aggregate_expressions]
        if r.grouping_expressions:
            keys = [self.expr(e) for e in r.grouping_expressions]
            return df.groupby(*keys).agg(*aggs)
        return df.agg(*aggs)

    def _rel_join(self, r: pb.Join):
        left = self.relation_to_df(r.left)
        right = self.relation_to_df(r.right)
        J = pb.Join.JoinType
        how = {J.JOIN_TYPE_INNER: "inner", J.JOIN_TYPE_FULL_OUTER: "outer",
               J.JOIN_TYPE_LEFT_OUTER: "left", J.JOIN_TYPE_RIGHT_OUTER:
               "right", J.JOIN_TYPE_LEFT_ANTI: "anti",
               J.JOIN_TYPE_LEFT_SEMI: "semi", J.JOIN_TYPE_CROSS: "cross",
               J.JOIN_TYPE_UNSPECIFIED: "inner"}.get(r.join_type)
        _require(how is not None, f"join type {r.join_type}")
        if how == "cross":
            return left.join(right, how="cross")
        if r.using_columns:
            on = list(r.using_columns)
            return left.join(right, on=on, how=how)
        _require(r.HasField("join_condition"),
                 "join without using_columns or condition")
        lk, rk = self._equi_keys(r.join_condition)
        return left.join(right, left_on=lk, right_on=rk, how=how)

    def _equi_keys(self, cond: pb.Expression):
        """Decompose `a == b [AND c == d ...]` into left/right key lists."""
        lk: List = []
        rk: List = []

        def walk(e: pb.Expression):
            _require(e.WhichOneof("expr_type") == "unresolved_function",
                     "non-equi join condition")
            f = e.unresolved_function
            if f.function_name in ("and", "AND"):
                for a in f.arguments:
                    walk(a)
                return
            _require(f.function_name not in ("eqNullSafe", "<=>"),
                     "null-safe equality (<=>) join keys: NULL <=> NULL "
                     "must match, which hash join keys do not honor")
            _require(f.function_name in ("==", "="),
                     f"join condition operator {f.function_name!r}")
            _require(len(f.arguments) == 2, "binary equality expected")
            lk.append(self.expr(f.arguments[0]))
            rk.append(self.expr(f.arguments[1]))

        walk(cond)
        return lk, rk

    def _rel_set_op(self, r: pb.SetOperation):
        left = self.relation_to_df(r.left_input)
        right = self.relation_to_df(r.right_input)
        T = pb.SetOperation.SetOpType
        is_all = r.is_all if r.HasField("is_all") else False
        if r.set_op_type == T.SET_OP_TYPE_UNION:
            return left.union_all(right) if is_all else left.union(right)
        if r.set_op_type == T.SET_OP_TYPE_INTERSECT:
            return (left.intersect_all(right) if is_all
                    else left.intersect(right))
        if r.set_op_type == T.SET_OP_TYPE_EXCEPT:
            return (left.except_all(right) if is_all
                    else left.except_distinct(right))
        raise Unsupported(f"set op {r.set_op_type}")

    def _rel_deduplicate(self, r: pb.Deduplicate):
        df = self.relation_to_df(r.input)
        if r.column_names:
            return df.distinct(*r.column_names)
        return df.distinct()

    def _rel_sample(self, r: pb.Sample):
        df = self.relation_to_df(r.input)
        frac = r.upper_bound - r.lower_bound
        seed = r.seed if r.HasField("seed") else None
        with_rep = (r.with_replacement if r.HasField("with_replacement")
                    else False)
        return df.sample(fraction=frac, with_replacement=with_rep, seed=seed)

    def _rel_repartition(self, r: pb.Repartition):
        df = self.relation_to_df(r.input)
        shuffle = r.shuffle if r.HasField("shuffle") else False
        if shuffle:
            return df.repartition(r.num_partitions)
        return df.into_partitions(r.num_partitions)

    def _rel_subquery_alias(self, r: pb.SubqueryAlias):
        return self.relation_to_df(r.input)

    def _rel_to_df(self, r: pb.ToDF):
        df = self.relation_to_df(r.input)
        old = df.column_names
        _require(len(old) == len(r.column_names),
                 f"toDF with {len(r.column_names)} names on "
                 f"{len(old)} columns")
        return df.with_columns_renamed(dict(zip(old, r.column_names)))

    def _rel_with_columns_renamed(self, r: pb.WithColumnsRenamed):
        df = self.relation_to_df(r.input)
        mapping = {rn.col_name: rn.new_col_name for rn in r.renames}
        return df.with_columns_renamed(mapping)

    def _rel_with_columns(self, r: pb.WithColumns):
        df = self.relation_to_df(r.input)
        cols = {}
        for a in r.aliases:
            _require(len(a.name) == 1, "multi-name alias in withColumns")
            cols[a.name[0]] = self.expr(a.expr)
        # one simultaneous with_columns: every expression binds against the
        # INPUT schema (Spark's withColumns semantics), not left-to-right
        return df.with_columns(cols)

    def _rel_drop(self, r: pb.Drop):
        df = self.relation_to_df(r.input)
        names = list(r.column_names)
        for e in r.columns:
            _require(e.WhichOneof("expr_type") == "unresolved_attribute",
                     "drop with non-column expression")
            names.append(e.unresolved_attribute.unparsed_identifier)
        return df.exclude(*names)

    def _rel_show_string(self, r: pb.ShowString):
        """Renders like Spark's show(): a one-row, one-column table holding
        the formatted text."""
        import daft_tpu_torch as dt
        rows, names, truncated = self._fetch_rows(r.input, r.num_rows)
        cells = [[_fmt_cell(row[c], r.truncate) for c in names]
                 for row in rows]
        widths = [max([len(n)] + [len(c[i]) for c in cells])
                  for i, n in enumerate(names)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep,
               "|" + "|".join(f" {n:<{w}} " for n, w in zip(names, widths))
               + "|", sep]
        for c in cells:
            out.append("|" + "|".join(
                f" {v:<{w}} " for v, w in zip(c, widths)) + "|")
        out.append(sep)
        if truncated:
            out.append(f"only showing top {r.num_rows} rows")
        return dt.from_pydict({"show_string": ["\n".join(out) + "\n"]})

    # ------------------------------------------------------- expressions
    def expr(self, e: pb.Expression):
        kind = e.WhichOneof("expr_type")
        _require(kind is not None, "expression outside supported subset")
        fn = getattr(self, f"_expr_{kind}", None)
        _require(fn is not None, f"expression type {kind!r}")
        return fn(getattr(e, kind))

    def _expr_literal(self, lit: pb.Expression.Literal):
        from daft_tpu_torch import lit as L
        which = lit.WhichOneof("literal_type")
        _require(which is not None, "empty literal")
        if which == "null":
            return L(None)
        v = getattr(lit, which)
        if which == "date":
            v = datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
        elif which in ("timestamp", "timestamp_ntz"):
            v = (datetime.datetime(1970, 1, 1)
                 + datetime.timedelta(microseconds=v))
        return L(v)

    def _expr_unresolved_attribute(self,
                                   a: pb.Expression.UnresolvedAttribute):
        from daft_tpu_torch import col
        return col(a.unparsed_identifier)

    def _expr_alias(self, a: pb.Expression.Alias):
        _require(len(a.name) == 1, "multi-name alias")
        return self.expr(a.expr).alias(a.name[0])

    def _expr_cast(self, c: pb.Expression.Cast):
        inner = self.expr(c.expr)
        which = c.WhichOneof("cast_to_type")
        if which == "type_str":
            dtype = _parse_spark_type_str(c.type_str)
        else:
            dtype = proto_to_dtype(c.type)
        return inner.cast(dtype)

    def _expr_expression_string(self, s: pb.Expression.ExpressionString):
        from daft_tpu_torch import sql_expr
        return sql_expr(s.expression)

    def _expr_sort_order(self, o: pb.Expression.SortOrder):
        # bare sort order outside Sort: evaluate the child
        return self.expr(o.child)

    def _expr_unresolved_function(self,
                                  f: pb.Expression.UnresolvedFunction):
        name = f.function_name
        # count(*) / count(1) → count rows; must short-circuit BEFORE
        # translating arguments (a bare star has no expression form)
        if name == "count" and (not f.arguments or _is_star_or_one(
                f.arguments[0])):
            return _count_all()
        args = [self.expr(a) for a in f.arguments]
        if f.is_distinct:
            _require(name in ("count",), f"DISTINCT {name}")
            return args[0].count_distinct()
        fn = _FUNCTIONS.get(name)
        _require(fn is not None, f"function {name!r}")
        return fn(*args)


def _fmt_cell(v, truncate: int) -> str:
    """Spark's show()/htmlString cell rendering: NULL text + truncation."""
    s = "NULL" if v is None else str(v)
    if truncate <= 0 or len(s) <= truncate:
        return s
    return s[:max(truncate - 3, 1)] + "..."


def _count_all():
    from daft_tpu_torch import lit
    return lit(1).count("all").alias("count")


def _is_star_or_one(e: pb.Expression) -> bool:
    k = e.WhichOneof("expr_type")
    if k == "unresolved_star":
        return True
    if k == "literal":
        lt = e.literal.WhichOneof("literal_type")
        return lt in ("integer", "long") and getattr(e.literal, lt) == 1
    return False


def _null_safe_eq(a, b):
    """Spark `<=>`: never NULL — and_kleene(NULL, False)=False makes each
    disjunct definite before the OR."""
    return (a.is_null() & b.is_null()) \
        | ((a == b) & a.not_null() & b.not_null())


# Spark unresolved function name → daft_tpu_torch Expression builder. pyspark's
# Column operators arrive as the operator symbol; pyspark.sql.functions
# arrive by name.
_FUNCTIONS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b=None: (-a) if b is None else a - b,
    "negative": lambda a: -a,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<=>": lambda a, b: _null_safe_eq(a, b),
    "eqNullSafe": lambda a, b: _null_safe_eq(a, b),
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "not": lambda a: ~a,
    "!": lambda a: ~a,
    "isnull": lambda a: a.is_null(),
    "isnotnull": lambda a: a.not_null(),
    "in": lambda a, *vs: a.is_in(list(vs)),
    "between": lambda a, lo, hi: a.between(lo, hi),
    "abs": lambda a: abs(a),
    "sum": lambda a: a.sum(),
    "avg": lambda a: a.mean(),
    "mean": lambda a: a.mean(),
    "min": lambda a: a.min(),
    "max": lambda a: a.max(),
    "count": lambda a: a.count(),
    "stddev": lambda a: a.stddev(),
    "stddev_samp": lambda a: a.stddev(),
    "first": lambda a: a.any_value(),
    "any_value": lambda a: a.any_value(),
    "collect_list": lambda a: a.agg_list(),
    "coalesce": lambda *a: _coalesce(*a),
    "upper": lambda a: a.str.upper(),
    "lower": lambda a: a.str.lower(),
    "length": lambda a: a.str.length(),
    "contains": lambda a, b: a.str.contains(b),
    "startswith": lambda a, b: a.str.startswith(b),
    "endswith": lambda a, b: a.str.endswith(b),
    "concat": lambda *a: _concat(*a),
    "substr": lambda a, start, length=None: _substr(a, start, length),
    "substring": lambda a, start, length=None: _substr(a, start, length),
    "like": lambda a, p: a.str.match(_like_to_regex(p)),
    "rlike": lambda a, p: a.str.match(_expr_literal_str(p)),
    "year": lambda a: a.dt.year(),
    "month": lambda a: a.dt.month(),
    "dayofmonth": lambda a: a.dt.day(),
    "hour": lambda a: a.dt.hour(),
    "minute": lambda a: a.dt.minute(),
    "second": lambda a: a.dt.second(),
    "sqrt": lambda a: a ** 0.5,
    "power": lambda a, b: a ** b,
    "pow": lambda a, b: a ** b,
    "floor": lambda a: a.floor(),
    "ceil": lambda a: a.ceil(),
    "round": lambda a, n=None: a.round(n) if n is not None else a.round(),
}


def _coalesce(*args):
    from ..expressions import coalesce
    return coalesce(*args)


def _concat(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _expr_literal_str(e) -> str:
    """Extract a python string from a lit() expression argument."""
    _require(getattr(e, "op", None) == "lit" and
             isinstance(e.params[0], str), "string literal expected")
    return e.params[0]


def _like_to_regex(p) -> str:
    import re
    pat = _expr_literal_str(p)
    return "^" + re.escape(pat).replace("%", ".*").replace("_", ".") + "$"


def _substr(a, start, length):
    # Spark substr is 1-based
    s = start - 1
    if length is None:
        return a.str.substr(s)
    return a.str.substr(s, length)


# ---------------------------------------------------------------- types

def dtype_to_proto(dtype) -> pb.DataType:
    """daft_tpu_torch DataType → Spark Connect DataType proto."""
    from ..datatype import DataType as DT
    k = dtype.kind
    simple = {
        "null": "null", "bool": "boolean", "int8": "byte", "int16": "short",
        "int32": "integer", "int64": "long", "uint8": "short",
        "uint16": "integer", "uint32": "long", "uint64": "long",
        "float32": "float", "float64": "double", "string": "string",
        "binary": "binary", "fixed_size_binary": "binary", "date": "date",
        "timestamp": "timestamp",
    }
    out = pb.DataType()
    if k in simple:
        getattr(out, simple[k]).SetInParent()
        return out
    if k == "decimal128":
        out.decimal.precision = dtype.precision
        out.decimal.scale = dtype.scale
        return out
    if k in ("list", "fixed_size_list", "embedding"):
        out.array.element_type.CopyFrom(dtype_to_proto(dtype.inner))
        out.array.contains_null = True
        return out
    if k == "struct":
        for name, ft in dtype.fields.items():
            f = out.struct.fields.add()
            f.name = name
            f.data_type.CopyFrom(dtype_to_proto(ft))
            f.nullable = True
        return out
    if k == "map":
        out.map.key_type.CopyFrom(dtype_to_proto(dtype.key_type))
        out.map.value_type.CopyFrom(dtype_to_proto(dtype.value_type))
        out.map.value_contains_null = True
        return out
    out.unparsed.data_type_string = str(dtype)
    return out


def proto_to_dtype(t: pb.DataType):
    """Spark Connect DataType proto → daft_tpu_torch DataType."""
    from ..datatype import DataType as DT
    kind = t.WhichOneof("kind")
    _require(kind is not None, "empty DataType")
    simple = {
        "null": DT.null, "boolean": DT.bool, "byte": DT.int8,
        "short": DT.int16, "integer": DT.int32, "long": DT.int64,
        "float": DT.float32, "double": DT.float64, "string": DT.string,
        "binary": DT.binary, "date": DT.date, "timestamp": DT.timestamp,
        "timestamp_ntz": DT.timestamp,
    }
    if kind in simple:
        return simple[kind]()
    if kind == "decimal":
        d = t.decimal
        return DT.decimal128(d.precision if d.HasField("precision") else 10,
                             d.scale if d.HasField("scale") else 0)
    if kind == "array":
        return DT.list(proto_to_dtype(t.array.element_type))
    if kind == "struct":
        return DT.struct({f.name: proto_to_dtype(f.data_type)
                          for f in t.struct.fields})
    if kind == "map":
        return DT.map(proto_to_dtype(t.map.key_type),
                      proto_to_dtype(t.map.value_type))
    if kind == "unparsed":
        return _parse_spark_type_str(t.unparsed.data_type_string)
    raise Unsupported(f"DataType {kind!r}")


_TYPE_STRS = {
    "boolean": "bool", "bool": "bool", "tinyint": "int8", "byte": "int8",
    "smallint": "int16", "short": "int16", "int": "int32",
    "integer": "int32", "bigint": "int64", "long": "int64",
    "float": "float32", "real": "float32", "double": "float64",
    "string": "string", "varchar": "string", "binary": "binary",
    "date": "date", "timestamp": "timestamp", "void": "null",
}


def _parse_spark_type_str(s: str):
    from ..datatype import DataType as DT
    base = s.strip().lower()
    if base.startswith("array<") and base.endswith(">"):
        return DT.list(_parse_spark_type_str(base[6:-1]))
    if base.startswith("decimal"):
        import re
        m = re.match(r"decimal\((\d+),\s*(\d+)\)", base)
        if m:
            return DT.decimal128(int(m.group(1)), int(m.group(2)))
        return DT.decimal128(10, 0)
    name = _TYPE_STRS.get(base.split("(")[0])
    _require(name is not None, f"type string {s!r}")
    return getattr(DT, name)()


def parse_ddl(ddl: str) -> pb.DataType:
    """`a INT, b STRING` (or a single type string) → DataType proto."""
    ddl = ddl.strip()
    try:  # a bare type string first — "decimal(10,2)" contains a comma
        return dtype_to_proto(_parse_spark_type_str(ddl))
    except Unsupported:
        pass
    out = pb.DataType()
    for part in _split_top_level(ddl):
        toks = part.strip().split(None, 1)
        _require(len(toks) == 2, f"DDL field {part!r}")
        f = out.struct.fields.add()
        f.name = toks[0].strip("`")
        f.data_type.CopyFrom(dtype_to_proto(_parse_spark_type_str(toks[1])))
        f.nullable = True
    return out


def _split_top_level(s: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def schema_to_proto(schema) -> pb.DataType:
    """daft_tpu_torch Schema → Spark struct DataType."""
    out = pb.DataType()
    for f in schema:
        sf = out.struct.fields.add()
        sf.name = f.name
        sf.data_type.CopyFrom(dtype_to_proto(f.dtype))
        sf.nullable = True
    return out
