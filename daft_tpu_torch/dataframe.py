"""DataFrame: the lazy user-facing API.

Reference: ``daft/dataframe/dataframe.py:108``. Each method extends the
logical plan via LogicalPlanBuilder; execution happens on collect/show/
iteration through the runner ``context.get_runner`` picks
(``runners/native_runner.py``: optimize, translate, then the push
pipeline or the interpreter; or ``runners/distributed_runner.py``). The port carries
the methods of the grouped-aggregation, join, TPC-H, SQL, out-of-core and
A5b slices (select/filter/with_column/sort/limit/distinct/agg/groupby/join,
cross joins included, concat and the set operations with their ``all``
and by-name forms, pivot/unpivot, drop_nan/drop_null, describe/summarize,
repartition, into_partitions and sample, monotonically increasing ids,
window expressions routed into ``Window`` nodes, explain and
``explain(analyze=True)``, num_partitions) and the writes
(``write_parquet``/``write_csv``/``write_json``/``write_sink``);
``explode``, the list aggregations and the lake-format writes come later
(ROADMAP A8).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

from .datatype import DataType
from .expressions import Expression, col, lit
from .logical.builder import LogicalPlanBuilder
from .micropartition import MicroPartition
from .runners.runner import PartitionSet
from .schema import Schema

ColumnInput = Union[str, Expression]

_range = range  # the module-level `range` below (daft.range) shadows the builtin


class DataFrame:
    def __init__(self, builder: LogicalPlanBuilder):
        self._builder = builder
        self._result: Optional[PartitionSet] = None
        #: the ``observability.RuntimeStatsContext`` of the collect
        self._stats = None

    # ---- meta ------------------------------------------------------------
    @property
    def builder(self) -> LogicalPlanBuilder:
        return self._builder

    def schema(self) -> Schema:
        return self._builder.schema()

    @property
    def column_names(self) -> List[str]:
        return self._builder.schema().column_names

    @property
    def columns(self) -> List[Expression]:
        return [col(n) for n in self.column_names]

    def __contains__(self, name: str) -> bool:
        return name in self._builder.schema()

    def __getitem__(self, key) -> Expression:
        if isinstance(key, str):
            if key != "*" and key not in self._builder.schema():
                raise ValueError(f"unknown column {key!r}")
            return col(key)
        if isinstance(key, int):
            return col(self.column_names[key])
        raise TypeError(f"cannot index DataFrame with {key!r}")

    def explain(self, show_all: bool = False, analyze: bool = False) -> None:
        """Print the unoptimized logical plan, and with ``show_all`` the
        optimized one too. ``analyze=True`` runs the query (once: a
        collected frame keeps its stats) and prints the physical plan
        annotated with per-operator rows and times, then the query's
        ``device kernels``, ``io``, ``spill``, ``adaptive`` and
        ``governor`` blocks and, when traced, its trace line
        (``observability.RuntimeStatsContext.render``; reference:
        ``physical_planner/planner.rs:614``)."""
        if analyze:
            self.collect()
            print("== Physical Plan (analyzed) ==")
            if self._stats is not None:
                print(self._stats.render())
            else:
                print("(no runtime stats recorded for this query)")
            return
        print("== Unoptimized Logical Plan ==")
        print(self._builder.repr_ascii())
        if show_all:
            print("\n== Optimized Logical Plan ==")
            print(self._builder.optimize().repr_ascii())

    def num_partitions(self) -> int:
        return self._builder.plan.num_partitions()

    def __repr__(self):
        if self._result is not None:
            return self._preview_str()
        return f"DataFrame({self.schema()!r})\n(unmaterialized — call .collect() or .show())"

    # ---- transformations -------------------------------------------------
    def select(self, *columns: ColumnInput) -> "DataFrame":
        rewritten, hoisted = _hoist_nested_windows(columns)
        if hoisted:
            # a window nested inside a scalar expression (``x * 100 /
            # SUM(x) OVER (...)``) computes in its own Window node first;
            # the outer expression then reads the temp column
            wdf = self.with_columns(hoisted)
            return DataFrame(wdf.select(*rewritten)._builder)
        win = [c for c in columns if isinstance(c, Expression)
               and c._unalias().op == "window"]
        if win:
            # window expressions go through Window nodes, then project
            wdf = self.with_columns({e.name(): e for e in win})
            keep = [col(c.name()) if (isinstance(c, Expression)
                                      and c._unalias().op == "window") else c
                    for c in columns]
            return DataFrame(wdf._builder.select(keep))
        return DataFrame(self._builder.select(list(columns)))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        return self.with_columns({name: expr})

    def with_columns(self, columns: Dict[str, Expression]) -> "DataFrame":
        exprs = [e.alias(n) for n, e in columns.items()]
        window_exprs = [e for e in exprs if e._unalias().op == "window"]
        if window_exprs:
            plain = [e for e in exprs if e._unalias().op != "window"]
            b = self._builder
            if plain:
                b = b.with_columns(plain)
            # one Window node per distinct spec, chained (the reference's
            # ExtractWindowFunction groups by WindowSpec the same way)
            by_spec: Dict[str, List[Expression]] = {}
            for e in window_exprs:
                by_spec.setdefault(repr(e._unalias().params[0]),
                                   []).append(e)
            for group in by_spec.values():
                w = group[0]._unalias().params[0]
                b = b.window(group, w._partition_by, w._order_by,
                             w._descending, w._nulls_first, w._frame)
            return DataFrame(b)
        return DataFrame(self._builder.with_columns(exprs))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame(self._builder.with_columns_renamed({old: new}))

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame(self._builder.with_columns_renamed(mapping))

    def exclude(self, *names: str) -> "DataFrame":
        return DataFrame(self._builder.exclude(list(names)))

    def where(self, predicate: Union[Expression, str]) -> "DataFrame":
        if isinstance(predicate, str):
            from .sql import sql_expr
            predicate = sql_expr(predicate)
        return DataFrame(self._builder.filter(predicate))

    filter = where

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self._builder.limit(n, offset))

    def offset(self, n: int) -> "DataFrame":
        return DataFrame(self._builder.limit(2 ** 62, n))

    def head(self, n: int = 10) -> "DataFrame":
        return self.limit(n)

    def unpivot(self, ids, values=None, variable_name: str = "variable",
                value_name: str = "value") -> "DataFrame":
        """Wide to long: per row, one row per column of ``values`` (every
        column not in ``ids`` when None)."""
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        values = values if values is None or isinstance(
            values, (list, tuple)) else [values]
        return DataFrame(self._builder.unpivot(ids, values, variable_name,
                                               value_name))

    melt = unpivot

    def sort(self, by, desc: Union[bool, List[bool]] = False,
             nulls_first=None) -> "DataFrame":
        by = by if isinstance(by, (list, tuple)) else [by]
        return DataFrame(self._builder.sort(by, desc, nulls_first))

    def distinct(self, *on: ColumnInput) -> "DataFrame":
        """Rows unique over ``on`` (every column when none is given)."""
        return DataFrame(self._builder.distinct(list(on) if on else None))

    def _drop_where(self, cols, default_names, term_of) -> "DataFrame":
        names = [c.name() for c in _flatten_cols(cols)] or default_names
        pred = None
        for n in names:
            term = term_of(n)
            pred = term if pred is None else pred & term
        return self if pred is None else self.where(pred)

    def drop_nan(self, *cols: ColumnInput) -> "DataFrame":
        """Drop rows where any of ``cols`` (default: all float columns) is
        NaN; nulls stay."""
        return self._drop_where(
            cols, [f.name for f in self.schema() if f.dtype.is_floating()],
            lambda n: ~col(n).float.is_nan() | col(n).is_null())

    def drop_null(self, *cols: ColumnInput) -> "DataFrame":
        """Drop rows where any of ``cols`` (default: all columns) is
        null."""
        return self._drop_where(cols, self.column_names,
                                lambda n: col(n).not_null())

    def sample(self, fraction: Optional[float] = None,
               size: Optional[int] = None, with_replacement: bool = False,
               seed: Optional[int] = None) -> "DataFrame":
        return DataFrame(self._builder.sample(fraction, size,
                                              with_replacement, seed))

    def repartition(self, num: Optional[int],
                    *cols: ColumnInput) -> "DataFrame":
        """``num`` partitions by the hash of ``cols``, or at random when
        no column is given."""
        if cols:
            return DataFrame(self._builder.hash_repartition(num, list(cols)))
        return DataFrame(self._builder.random_shuffle(num))

    def into_partitions(self, num: int) -> "DataFrame":
        """``num`` partitions split by position, row order kept."""
        return DataFrame(self._builder.into_partitions(num))

    def pipe(self, func, *args, **kwargs):
        """``df.pipe(f, ...)`` → ``f(df, ...)`` (reference parity)."""
        return func(self, *args, **kwargs)

    def transform(self, func, *args, **kwargs) -> "DataFrame":
        out = func(self, *args, **kwargs)
        assert isinstance(out, DataFrame)
        return out

    def concat(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.concat(other._builder))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.union(other._builder, all=False))

    def union_all(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.union(other._builder, all=True))

    def _aligned_by_name(self, other: "DataFrame") -> "DataFrame":
        mine, theirs = self.column_names, other.column_names
        if set(mine) != set(theirs):
            raise ValueError(
                f"union_by_name: column sets differ "
                f"({sorted(set(mine) ^ set(theirs))})")
        return other.select(*[col(n) for n in mine])

    def union_by_name(self, other: "DataFrame") -> "DataFrame":
        """Set union matching columns by name, in any order."""
        return self.union(self._aligned_by_name(other))

    def union_all_by_name(self, other: "DataFrame") -> "DataFrame":
        return self.union_all(self._aligned_by_name(other))

    def intersect(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.intersect(other._builder))

    def intersect_all(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.intersect(other._builder, all=True))

    def except_distinct(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.except_(other._builder))

    def except_all(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.except_(other._builder, all=True))

    def pivot(self, group_by, pivot_col, value_col, agg_fn: str,
              names: Optional[List[str]] = None) -> "DataFrame":
        """One row per group, one column per pivot value (``names``, or
        every distinct value of ``pivot_col``), each holding
        ``value_col.<agg_fn>()`` over the group's rows at that value."""
        gb = group_by if isinstance(group_by, (list, tuple)) else [group_by]
        return DataFrame(self._builder.pivot(gb, pivot_col, value_col,
                                             agg_fn, names))

    def add_monotonically_increasing_id(self, column_name=None) -> "DataFrame":
        return DataFrame(
            self._builder.add_monotonically_increasing_id(column_name))

    def join(self, other: "DataFrame",
             on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             left_on=None, right_on=None, how: str = "inner",
             strategy: Optional[str] = None, prefix: Optional[str] = None,
             suffix: Optional[str] = None) -> "DataFrame":
        """Equi-join with ``other``: ``how`` is inner, left, right, outer,
        semi or anti; ``strategy`` None (chosen from size estimates),
        ``hash``, ``broadcast``, ``broadcast_left`` or
        ``broadcast_right``. ``how="cross"`` takes no keys and pairs every
        row with every row of ``other``."""
        if on is not None:
            left_on = right_on = on
        if how != "cross" and left_on is None:
            raise ValueError("join requires `on` or `left_on`/`right_on`")
        lo = left_on if isinstance(left_on, (list, tuple)) else [left_on]
        ro = right_on if isinstance(right_on, (list, tuple)) else [right_on]
        return DataFrame(self._builder.join(other._builder, lo, ro, how,
                                            strategy, prefix, suffix))

    # ---- aggregations ----------------------------------------------------
    def agg(self, *to_agg) -> "DataFrame":
        exprs = _flatten_exprs(to_agg)
        return DataFrame(self._builder.aggregate(exprs, []))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        return GroupedDataFrame(self, _flatten_cols(group_by))

    group_by = groupby

    def _agg_all(self, op: str) -> "DataFrame":
        exprs = []
        for f in self.schema():
            e = getattr(col(f.name), op, None)
            if e is None:
                continue
            try:
                agg_e = e()
                agg_e.to_field(self.schema())
                exprs.append(agg_e)
            except Exception:
                continue
        return DataFrame(self._builder.aggregate(exprs, []))

    def sum(self, *cols: ColumnInput) -> "DataFrame":
        if not cols:
            return self._agg_all("sum")
        return self.agg(*[_c(c).sum() for c in _flatten_cols(cols)])

    def mean(self, *cols: ColumnInput) -> "DataFrame":
        if not cols:
            return self._agg_all("mean")
        return self.agg(*[_c(c).mean() for c in _flatten_cols(cols)])

    def min(self, *cols):
        if not cols:
            return self._agg_all("min")
        return self.agg(*[_c(c).min() for c in _flatten_cols(cols)])

    def max(self, *cols):
        if not cols:
            return self._agg_all("max")
        return self.agg(*[_c(c).max() for c in _flatten_cols(cols)])

    def any_value(self, *cols):
        return self.agg(*[_c(c).any_value() for c in _flatten_cols(cols)])

    def count(self, *cols) -> "DataFrame":
        if not cols:
            return self.agg(lit(1).count("all").alias("count"))
        return self.agg(*[_c(c).count() for c in _flatten_cols(cols)])

    def stddev(self, *cols):
        return self.agg(*[_c(c).stddev() for c in _flatten_cols(cols)])

    def count_rows(self) -> int:
        d = self.count().to_pydict()
        return int(d["count"][0])

    def __len__(self) -> int:
        if self._result is not None:
            return len(self._result)
        return self.count_rows()

    def describe(self) -> "DataFrame":
        """One row of summary statistics: per column its count and
        distinct count, and for a numeric column its mean, min and max."""
        aggs = []
        for f in self.schema():
            c = col(f.name)
            aggs.append(c.count().cast(DataType.uint64())
                        .alias(f"{f.name}_count"))
            aggs.append(c.count_distinct().alias(f"{f.name}_unique"))
            if f.dtype.is_numeric():
                aggs.append(c.mean().alias(f"{f.name}_mean"))
                aggs.append(c.min().alias(f"{f.name}_min"))
                aggs.append(c.max().alias(f"{f.name}_max"))
        return DataFrame(self._builder.aggregate(aggs, []))

    def summarize(self) -> "DataFrame":
        return self.describe()

    # ---- writes ----------------------------------------------------------
    def write_parquet(self, root_dir: str, compression: str = "snappy",
                      write_mode: str = "append", partition_cols=None,
                      io_config=None) -> "DataFrame":
        """Write the rows as parquet files under ``root_dir`` (hive
        directories per value of ``partition_cols``); the result holds
        the written paths (reference ``dataframe.py:386``)."""
        return self._write("parquet", root_dir, write_mode, partition_cols,
                           {"compression": compression})

    def write_csv(self, root_dir: str, write_mode: str = "append",
                  partition_cols=None, io_config=None) -> "DataFrame":
        return self._write("csv", root_dir, write_mode, partition_cols, {})

    def write_json(self, root_dir: str, write_mode: str = "append",
                   partition_cols=None, io_config=None) -> "DataFrame":
        return self._write("json", root_dir, write_mode, partition_cols, {})

    def _write(self, kind, root_dir, mode, partition_cols, options):
        pc_list = None
        if partition_cols is not None:
            pc_list = partition_cols \
                if isinstance(partition_cols, (list, tuple)) \
                else [partition_cols]
        return DataFrame(self._builder.table_write(
            kind, root_dir, pc_list, mode, options)).collect()

    def write_sink(self, sink) -> "DataFrame":
        """Drive a user ``io.DataSink`` with the rows."""
        return DataFrame(self._builder.write_sink(sink)).collect()

    # ---- execution -------------------------------------------------------
    def collect(self, num_preview_rows: Optional[int] = 8) -> "DataFrame":
        if self._result is None:
            from . import observability as obs
            from .context import get_runner
            self._result = get_runner().run(self._builder)
            # this thread drained the query, so its own record is this
            # query's, whatever else finished meanwhile
            self._stats = obs.last_query_stats_local()
            # downstream queries read from the materialized result
            self._builder = LogicalPlanBuilder.from_in_memory(
                self._result.partitions, self._result.schema)
        return self

    def _materialize(self) -> PartitionSet:
        self.collect()
        return self._result

    def iter_partitions(self) -> Iterator[MicroPartition]:
        if self._result is not None:
            yield from self._result.partitions
            return
        from .context import get_runner
        yield from get_runner().run_iter(self._builder)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for p in self.iter_partitions():
            for b in p.batches():
                cols = {c.name(): c.to_pylist() for c in b.columns()}
                for i in _range(len(b)):
                    yield {k: v[i] for k, v in cols.items()}

    def __iter__(self):
        return self.iter_rows()

    def show(self, n: int = 8) -> None:
        rows = self.limit(n)._materialize().to_recordbatch()
        print(rows.to_pandas().to_string())

    def _preview_str(self) -> str:
        rb = self._result.to_recordbatch()
        pdf = rb.head(8).to_pandas()
        return f"{pdf}\n({len(rb)} rows)"

    # ---- conversions -----------------------------------------------------
    def to_pydict(self) -> Dict[str, list]:
        return self._materialize().to_recordbatch().to_pydict()

    def to_pylist(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def to_arrow(self) -> pa.Table:
        return self._materialize().to_recordbatch().to_arrow_table()

    def to_pandas(self):
        return self._materialize().to_recordbatch().to_pandas()

    def to_arrow_iter(self) -> Iterator[pa.RecordBatch]:
        """Stream results as Arrow record batches without materializing a
        combined copy per partition (reference:
        ``DataFrame.to_arrow_iter``)."""
        for p in self.iter_partitions():
            for rb in p.batches():
                yield from rb.to_arrow_table().to_batches()


class GroupedDataFrame:
    """Reference: ``daft/dataframe/dataframe.py`` GroupedDataFrame."""

    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self.df = df
        self.group_by = group_by

    def agg(self, *to_agg) -> DataFrame:
        exprs = _flatten_exprs(to_agg)
        return DataFrame(self.df._builder.aggregate(exprs, self.group_by))

    def _agg_all(self, op: str) -> DataFrame:
        gb_names = {e.name() for e in self.group_by}
        exprs = []
        for f in self.df.schema():
            if f.name in gb_names:
                continue
            try:
                e = getattr(col(f.name), op)()
                e.to_field(self.df.schema())
                exprs.append(e)
            except Exception:
                continue
        return DataFrame(self.df._builder.aggregate(exprs, self.group_by))

    def sum(self, *cols):
        if not cols:
            return self._agg_all("sum")
        return self.agg(*[_c(c).sum() for c in _flatten_cols(cols)])

    def mean(self, *cols):
        if not cols:
            return self._agg_all("mean")
        return self.agg(*[_c(c).mean() for c in _flatten_cols(cols)])

    def min(self, *cols):
        if not cols:
            return self._agg_all("min")
        return self.agg(*[_c(c).min() for c in _flatten_cols(cols)])

    def max(self, *cols):
        if not cols:
            return self._agg_all("max")
        return self.agg(*[_c(c).max() for c in _flatten_cols(cols)])

    def any_value(self, *cols):
        return self.agg(*[_c(c).any_value() for c in _flatten_cols(cols)])

    def count(self, *cols):
        if not cols:
            gb_names = {e.name() for e in self.group_by}
            exprs = [col(f.name).count() for f in self.df.schema()
                     if f.name not in gb_names]
            return self.agg(*exprs)
        return self.agg(*[_c(c).count() for c in _flatten_cols(cols)])

    def stddev(self, *cols):
        return self.agg(*[_c(c).stddev() for c in _flatten_cols(cols)])


def _c(x: ColumnInput) -> Expression:
    return col(x) if isinstance(x, str) else x


def _flatten_cols(cols) -> List[Expression]:
    out = []
    for c in cols:
        if isinstance(c, (list, tuple)):
            out.extend(_c(x) for x in c)
        else:
            out.append(_c(c))
    return out


def _flatten_exprs(to_agg) -> List[Expression]:
    out = []
    for a in to_agg:
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


# ---------------------------------------------------------------------------
# constructors (daft.from_* family)


def _hoist_nested_windows(columns):
    """Hoist OVER() subtrees buried inside scalar expressions into temp
    columns (the reference's ``ExtractWindowFunction``); top-level window
    expressions stay for ``select``'s Window routing. → (rewritten
    columns, {temp name: window expression})."""
    hoisted: Dict[str, Expression] = {}

    def walk(e: Expression, top: bool) -> Expression:
        inner = e._unalias()
        if inner.op == "window":
            if top:
                return e
            name = f"__win_h{len(hoisted)}"
            hoisted[name] = inner
            return col(name)
        new_args = tuple(walk(c, False) for c in e.args)
        # identity compare: Expression.__eq__ builds an eq-expression
        if all(a is b for a, b in zip(new_args, e.args)):
            return e
        return e.with_children(new_args)

    out = [walk(c, True) if isinstance(c, Expression) else c
           for c in columns]
    return out, hoisted


def from_pydict(data: Dict[str, Any]) -> DataFrame:
    mp = MicroPartition.from_pydict(data)
    return DataFrame(LogicalPlanBuilder.from_in_memory([mp], mp.schema))


def from_pylist(rows: List[Dict[str, Any]]) -> DataFrame:
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    return from_pydict({k: [r.get(k) for r in rows] for k in keys})


def from_arrow(t) -> DataFrame:
    if isinstance(t, pa.RecordBatch):
        t = pa.Table.from_batches([t])
    mp = MicroPartition.from_arrow_table(t)
    return DataFrame(LogicalPlanBuilder.from_in_memory([mp], mp.schema))


def from_pandas(pdf) -> DataFrame:
    return from_arrow(pa.Table.from_pandas(pdf, preserve_index=False))


def from_glob_path(path: str, io_config=None) -> DataFrame:
    """The files a glob matches as a DataFrame of ``path``, ``size``
    (bytes, None for a remote file) and ``num_rows`` (reference
    ``dataframe.py:681``)."""
    import os

    from .io.scan import glob_paths
    paths = glob_paths(path, io_config)
    sizes = [os.path.getsize(p) if os.path.exists(p) else None
             for p in paths]
    return from_pydict({"path": paths, "size": sizes,
                        "num_rows": [None] * len(paths)})


def range(start: int, end: Optional[int] = None, step: int = 1
          ) -> DataFrame:
    if end is None:
        start, end = 0, start
    return from_pydict({"id": np.arange(start, end, step)})
