"""DataFrame: the lazy user-facing API.

Reference: ``daft/dataframe/dataframe.py:108``. Each method extends the
logical plan via LogicalPlanBuilder; execution happens on collect/show/
iteration through ``execution.executor.run_plan``. The port carries the
methods of the grouped-aggregation and equi-join slices (select/filter/
with_column/sort/limit/agg/groupby/join); cross joins, windows and writes
come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

from .expressions import Expression, col, lit
from .logical.builder import LogicalPlanBuilder
from .micropartition import MicroPartition
from .execution.executor import PartitionSet, run_plan
from .schema import Schema

ColumnInput = Union[str, Expression]

_range = range  # the module-level `range` below (daft.range) shadows the builtin


class DataFrame:
    def __init__(self, builder: LogicalPlanBuilder):
        self._builder = builder
        self._result: Optional[PartitionSet] = None

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

    def __repr__(self):
        if self._result is not None:
            return self._preview_str()
        return f"DataFrame({self.schema()!r})\n(unmaterialized — call .collect() or .show())"

    # ---- transformations -------------------------------------------------
    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(self._builder.select(list(columns)))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        return self.with_columns({name: expr})

    def with_columns(self, columns: Dict[str, Expression]) -> "DataFrame":
        exprs = [e.alias(n) for n, e in columns.items()]
        return DataFrame(self._builder.with_columns(exprs))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame(self._builder.with_columns_renamed({old: new}))

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame(self._builder.with_columns_renamed(mapping))

    def exclude(self, *names: str) -> "DataFrame":
        return DataFrame(self._builder.exclude(list(names)))

    def where(self, predicate: Expression) -> "DataFrame":
        return DataFrame(self._builder.filter(predicate))

    filter = where

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self._builder.limit(n, offset))

    def offset(self, n: int) -> "DataFrame":
        return DataFrame(self._builder.limit(2 ** 62, n))

    def head(self, n: int = 10) -> "DataFrame":
        return self.limit(n)

    def sort(self, by, desc: Union[bool, List[bool]] = False,
             nulls_first=None) -> "DataFrame":
        by = by if isinstance(by, (list, tuple)) else [by]
        return DataFrame(self._builder.sort(by, desc, nulls_first))

    def pipe(self, func, *args, **kwargs):
        """``df.pipe(f, ...)`` → ``f(df, ...)`` (reference parity)."""
        return func(self, *args, **kwargs)

    def transform(self, func, *args, **kwargs) -> "DataFrame":
        out = func(self, *args, **kwargs)
        assert isinstance(out, DataFrame)
        return out

    def join(self, other: "DataFrame",
             on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             left_on=None, right_on=None, how: str = "inner",
             strategy: Optional[str] = None, prefix: Optional[str] = None,
             suffix: Optional[str] = None) -> "DataFrame":
        """Equi-join with ``other``: ``how`` is inner, left, right, outer,
        semi or anti; ``strategy`` None (chosen from size estimates),
        ``hash``, ``broadcast``, ``broadcast_left`` or
        ``broadcast_right``."""
        if how == "cross":
            raise NotImplementedError(
                "cross join is not ported yet (ROADMAP A2: cross and "
                "sort-merge join)")
        if on is not None:
            left_on = right_on = on
        if left_on is None:
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

    # ---- execution -------------------------------------------------------
    def collect(self, num_preview_rows: Optional[int] = 8) -> "DataFrame":
        if self._result is None:
            self._result = PartitionSet(list(run_plan(self._builder)),
                                        self._builder.schema())
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
        yield from run_plan(self._builder)

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


def range(start: int, end: Optional[int] = None, step: int = 1
          ) -> DataFrame:
    if end is None:
        start, end = 0, start
    return from_pydict({"id": np.arange(start, end, step)})
