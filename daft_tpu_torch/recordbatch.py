"""RecordBatch: schema + equal-length Series, with the relational kernel surface.

Capability mirror of the reference's ``daft-recordbatch``
(``src/daft-recordbatch/src/lib.rs:63`` and kernels in ``ops/``: agg, joins,
sort, partition, explode, pivot/unpivot). Two execution tiers:

- host tier here, over Arrow C++ compute (``pa.TableGroupBy``,
  ``pc.sort_indices`` — all native C++);
- the torch device tier in ``daft_tpu_torch.device``: the executor's
  fused filter→project→aggregate fragments, a join's index generation
  (:meth:`RecordBatch.hash_join`, ``joins.py``), and the per-operator
  paths that :meth:`eval_expression_list`, :meth:`filter`,
  :meth:`argsort` and :meth:`agg` try first (``device/runtime.py``;
  None from them means the host tier runs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .expressions import Expression, col
from .expressions.evaluator import eval_expression
from .schema import Schema
from .series import Series


class RecordBatch:
    __slots__ = ("_schema", "_columns", "_len")

    def __init__(self, schema: Schema, columns: List[Series], length: int):
        self._schema = schema
        self._columns = columns
        self._len = length

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_series(cls, columns: List[Series]) -> "RecordBatch":
        if not columns:
            return cls.empty()
        n = max(len(c) for c in columns)
        columns = [c.broadcast(n) if len(c) == 1 and n != 1 else c for c in columns]
        assert all(len(c) == n for c in columns), "column length mismatch"
        return cls(Schema([c.field() for c in columns]), columns, n)

    @classmethod
    def from_pydict(cls, data: Dict[str, Any]) -> "RecordBatch":
        cols = []
        for name, v in data.items():
            if isinstance(v, Series):
                cols.append(v.rename(name))
            elif isinstance(v, np.ndarray):
                cols.append(Series.from_numpy(v, name))
            elif isinstance(v, (pa.Array, pa.ChunkedArray)):
                cols.append(Series.from_arrow(v, name))
            else:
                cols.append(Series.from_pylist(list(v), name))
        return cls.from_series(cols)

    @classmethod
    def from_arrow_table(cls, t: pa.Table) -> "RecordBatch":
        cols = [Series.from_arrow(t.column(i), t.column_names[i])
                for i in range(t.num_columns)]
        if not cols:
            b = cls.empty()
            return cls(b._schema, b._columns, t.num_rows)
        return cls.from_series(cols)

    @classmethod
    def from_arrow_record_batch(cls, rb: pa.RecordBatch) -> "RecordBatch":
        return cls.from_arrow_table(pa.Table.from_batches([rb]))

    @classmethod
    def empty(cls, schema: Optional[Schema] = None) -> "RecordBatch":
        schema = schema or Schema.empty()
        return cls(schema, [Series.empty(f.name, f.dtype) for f in schema], 0)

    # ---- basic -----------------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self._schema

    def __len__(self) -> int:
        return self._len

    def num_columns(self) -> int:
        return len(self._columns)

    def column_names(self) -> List[str]:
        return self._schema.column_names

    def get_column(self, name: str) -> Series:
        return self._columns[self._schema.index_of(name)]

    def columns(self) -> List[Series]:
        return list(self._columns)

    def size_bytes(self) -> int:
        total = 0
        for c in self._columns:
            if c.is_pyobject():
                total += len(c) * 64
            else:
                total += c.to_arrow().nbytes
        return total

    # ---- conversions -----------------------------------------------------
    def to_arrow_table(self) -> pa.Table:
        arrays, fields = [], []
        for c in self._columns:
            if c.is_pyobject():
                raise ValueError(
                    f"cannot convert Python-object column {c.name()!r} to arrow")
            arrays.append(c.to_arrow())
            fields.append(c.field().to_arrow())
        if not arrays:
            return pa.table({})
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))

    def to_pydict(self) -> Dict[str, list]:
        return {c.name(): c.to_pylist() for c in self._columns}

    def to_pandas(self):
        import pandas as pd
        data = {c.name(): (c.to_pylist() if c.is_pyobject()
                           else c.to_arrow().to_pandas()) for c in self._columns}
        return pd.DataFrame(data)

    # ---- expression eval -------------------------------------------------
    def _cols_dict(self) -> Dict[str, Series]:
        return {c.name(): c for c in self._columns}

    def eval_expression_list(self, exprs: Sequence[Expression]) -> "RecordBatch":
        """Evaluate a projection: on the device when the whole projection
        compiles for it (``device/runtime.try_eval_projection``), else
        with Arrow host compute."""
        from .device import runtime as device_runtime
        out = device_runtime.try_eval_projection(self, list(exprs))
        if out is not None:
            return out
        cols = self._cols_dict()
        return RecordBatch.from_series(
            [eval_expression(e, cols, self._len) for e in exprs])

    def eval_expression(self, e: Expression) -> Series:
        return eval_expression(e, self._cols_dict(), self._len)

    # ---- row selection ---------------------------------------------------
    def filter(self, predicate: Union[Expression, Series]) -> "RecordBatch":
        if isinstance(predicate, Expression):
            from .device import runtime as device_runtime
            m_np = device_runtime.try_eval_predicate(self, predicate)
            if m_np is not None:
                mask = Series.from_arrow(pa.array(m_np), "mask")
            else:
                mask = self.eval_expression(predicate)
        else:
            mask = predicate
        m = pc.fill_null(mask.to_arrow().cast(pa.bool_()), False)
        return RecordBatch(self._schema,
                           [c.filter(Series.from_arrow(m, "m")) for c in self._columns],
                           int(pc.sum(m).as_py() or 0))

    def take(self, indices: Union[Series, np.ndarray]) -> "RecordBatch":
        idx = indices.to_numpy() if isinstance(indices, Series) else np.asarray(indices)
        return RecordBatch(self._schema, [c.take(idx) for c in self._columns],
                           len(idx))

    def slice(self, start: int, end: int) -> "RecordBatch":
        cols = [c.slice(start, end) for c in self._columns]
        # a batch without columns (a count's scan) keeps its row count
        n = len(cols[0]) if cols else \
            max(0, min(end, self._len) - max(start, 0))
        return RecordBatch(self._schema, cols, n)

    def head(self, n: int) -> "RecordBatch":
        return self.slice(0, n)

    def sample(self, fraction: Optional[float] = None, size: Optional[int] = None,
               with_replacement: bool = False, seed: Optional[int] = None) -> "RecordBatch":
        k = int(self._len * fraction) if fraction is not None else int(size or 0)
        rng = np.random.default_rng(seed)
        if with_replacement:
            idx = rng.integers(0, max(self._len, 1), size=k)
        else:
            k = min(k, self._len)
            idx = rng.permutation(self._len)[:k]
        return self.take(np.sort(idx))

    @classmethod
    def concat(cls, batches: List["RecordBatch"]) -> "RecordBatch":
        batches = [b for b in batches]
        assert batches, "concat of empty list"
        first = batches[0]
        if len(batches) == 1:
            return first
        cols = []
        for i, f in enumerate(first._schema):
            cols.append(Series.concat([b._columns[b._schema.index_of(f.name)]
                                       for b in batches]))
        return cls(first._schema, cols, sum(len(b) for b in batches))

    def union(self, other: "RecordBatch") -> "RecordBatch":
        assert len(self) == len(other)
        return RecordBatch.from_series(self._columns + other._columns)

    # ---- sort ------------------------------------------------------------
    def argsort(self, sort_keys: Sequence[Expression],
                descending: Optional[Sequence[bool]] = None,
                nulls_first: Optional[Sequence[bool]] = None) -> np.ndarray:
        ks = [self.eval_expression(e) for e in sort_keys]
        descending = descending or [False] * len(ks)
        nulls_first = nulls_first or list(descending)
        from .device import runtime as device_runtime
        idx = device_runtime.try_argsort(ks, descending, nulls_first)
        if idx is not None:
            return idx
        # emulate per-key null placement with an explicit null-rank plane per key
        cols, keys = {}, []
        for i, (k, d, nf) in enumerate(zip(ks, descending, nulls_first)):
            arr = k.to_arrow()
            cols[f"n{i}"] = pc.if_else(pc.is_valid(arr),
                                       pa.scalar(1 if nf else 0, pa.int8()),
                                       pa.scalar(0 if nf else 1, pa.int8()))
            cols[f"k{i}"] = arr
            keys.append((f"n{i}", "ascending"))
            keys.append((f"k{i}", "descending" if d else "ascending"))
        tbl = pa.table(cols)
        out = pc.sort_indices(tbl, sort_keys=keys, null_placement="at_end")
        return out.to_numpy()

    def sort(self, sort_keys: Sequence[Expression],
             descending: Optional[Sequence[bool]] = None,
             nulls_first: Optional[Sequence[bool]] = None) -> "RecordBatch":
        return self.take(self.argsort(sort_keys, descending, nulls_first))

    def top_n(self, sort_keys: Sequence[Expression], n: int,
              descending: Optional[Sequence[bool]] = None,
              nulls_first: Optional[Sequence[bool]] = None) -> "RecordBatch":
        idx = self.argsort(sort_keys, descending, nulls_first)[:n]
        return self.take(idx)

    # ---- aggregation -----------------------------------------------------
    def agg(self, to_agg: Sequence[Expression],
            group_by: Sequence[Expression] = ()) -> "RecordBatch":
        """Global or grouped aggregation: on the device where
        ``device/runtime.try_agg`` takes it, else Arrow C++
        ``TableGroupBy``.
        Mirrors ``src/daft-recordbatch/src/ops/agg.rs:12-29``.
        """
        from .aggs import agg_recordbatch
        return agg_recordbatch(self, list(to_agg), list(group_by))

    # ---- joins -----------------------------------------------------------
    def hash_join(self, right: "RecordBatch", left_on: Sequence[Expression],
                  right_on: Sequence[Expression], how: str = "inner"
                  ) -> "RecordBatch":
        """Equi-join (inner/left/right/outer/semi/anti); see ``joins.py``
        for where the index generation runs."""
        from .joins import join_recordbatch
        return join_recordbatch(self, right, list(left_on), list(right_on),
                                how)

    def cross_join(self, right: "RecordBatch") -> "RecordBatch":
        """Every row of ``self`` with every row of ``right``, left-major."""
        n_l, n_r = len(self), len(right)
        li = np.repeat(np.arange(n_l), n_r)
        ri = np.tile(np.arange(n_r), n_l)
        return RecordBatch.from_series([c.take(li) for c in self._columns]
                                       + [c.take(ri) for c in right._columns])

    def distinct(self, on: Optional[Sequence[Expression]] = None) -> "RecordBatch":
        on = list(on) if on else [col(n) for n in self.column_names()]
        keys = RecordBatch.from_series(
            [self.eval_expression(e) for e in on])
        tbl = keys.to_arrow_table()
        # group-by all key cols with a first-row index agg
        tbl = tbl.append_column("__row__", pa.array(np.arange(self._len)))
        g = tbl.group_by([c for c in tbl.column_names if c != "__row__"],
                         use_threads=False)
        first = g.aggregate([("__row__", "min")])
        idx = first.column("__row___min").to_numpy()
        return self.take(np.sort(idx))

    # ---- explode ---------------------------------------------------------
    def explode(self, exprs: Sequence[Expression]) -> "RecordBatch":
        """One row per list element of the ``.explode()`` expressions, the
        other columns repeated; a null or empty list gives one null row
        (reference: ``daft_tpu/recordbatch.py:explode``,
        ``src/daft-recordbatch/src/ops/explode.rs``). The first list sets
        each row's repeat count, as in the reference."""
        exploded = []
        for e in exprs:
            inner = e._unalias()
            if inner.op != "explode":
                raise ValueError("explode expects .explode() expressions")
            exploded.append(
                self.eval_expression(inner.args[0]).rename(e.name()))
        arr0 = exploded[0].to_arrow()
        lengths = pc.fill_null(pc.list_value_length(arr0), 1) \
            .to_numpy(zero_copy_only=False).astype(np.int64)
        lengths = np.maximum(lengths, 1)  # null/empty lists -> 1 null row
        repeat_idx = np.repeat(np.arange(self._len), lengths)
        by_name = {s.name(): s for s in exploded}
        out_cols = []
        for c in self._columns:
            match = by_name.get(c.name())
            out_cols.append(_explode_series(match, lengths)
                            if match is not None else c.take(repeat_idx))
        for s in exploded:
            if s.name() not in self._schema:
                out_cols.append(_explode_series(s, lengths))
        return RecordBatch.from_series(out_cols)

    # ---- partitioning ----------------------------------------------------
    def pivot(self, group_by: Sequence[Expression], pivot_col: Expression,
              value_col: Expression, names: List[str]) -> "RecordBatch":
        from .aggs import pivot_recordbatch
        return pivot_recordbatch(self, list(group_by), pivot_col, value_col,
                                 names)

    def unpivot(self, ids: Sequence[Expression], values: Sequence[Expression],
                variable_name: str = "variable",
                value_name: str = "value") -> "RecordBatch":
        """One row per (input row, value column): the ids, the value
        column's name and its value cast to the values' supertype; all
        rows of the first value column, then of the next."""
        from .expressions.typing import supertype
        id_batch = RecordBatch.from_series(
            [self.eval_expression(e) for e in ids])
        val_series = [self.eval_expression(e) for e in values]
        out_dt = val_series[0].datatype()
        for v in val_series[1:]:
            out_dt = supertype(out_dt, v.datatype())
        parts = []
        for v in val_series:
            parts.append(RecordBatch.from_series(
                id_batch._columns
                + [Series.from_pylist([v.name()] * self._len, variable_name),
                   v.cast(out_dt).rename(value_name)]))
        return RecordBatch.concat(parts)

    def partition_by_hash(self, exprs: Sequence[Expression],
                          num_partitions: int) -> List["RecordBatch"]:
        """Rows split by ``hash(keys) % num_partitions``, each piece in
        row order (reference: ``daft_tpu/recordbatch.py:partition_by_hash``,
        the same hash, so a row lands in the same partition)."""
        if self._len == 0:
            return [self.slice(0, 0) for _ in range(num_partitions)]
        keys = [self.eval_expression(e) for e in exprs]
        h = keys[0].hash()
        for k in keys[1:]:
            h = k.hash(seed=h)
        pid = (h.to_numpy() % np.uint64(num_partitions)).astype(np.int64)
        return self._split_by_pid(pid, num_partitions)

    def partition_by_random(self, num_partitions: int,
                            seed: int) -> List["RecordBatch"]:
        """Rows to partitions drawn uniformly from ``seed`` (reference
        ``daft_tpu/recordbatch.py:partition_by_random``: the same draws)."""
        rng = np.random.default_rng(seed)
        pid = rng.integers(0, num_partitions, size=self._len)
        return self._split_by_pid(pid, num_partitions)

    def partition_by_range(self, partition_keys: Sequence[Expression],
                           boundaries: "RecordBatch",
                           descending: List[bool],
                           nulls_first: Optional[List[bool]] = None
                           ) -> List["RecordBatch"]:
        """``len(boundaries) + 1`` partitions: row r goes to the number of
        boundaries it sorts strictly after, in the order of ``descending``
        and ``nulls_first`` (default: nulls last ascending, first
        descending — the reference's ``_cmp_vals``). The reference compares
        row by row in Python (``daft_tpu/recordbatch.py:354``); here the
        rows and boundaries sort together once (rows before equal
        boundaries), and each row's partition is the count of boundaries
        ahead of it — the same assignment."""
        nparts = len(boundaries) + 1
        if self._len == 0:
            return [self.slice(0, 0) for _ in range(nparts)]
        if nparts == 1:
            return [self]
        keys = [self.eval_expression(e) for e in partition_keys]
        nulls_first = list(nulls_first) if nulls_first is not None \
            else list(descending)
        nb = len(boundaries)
        cols, order_keys = {}, []
        for j, (k, d, nf) in enumerate(zip(keys, descending, nulls_first)):
            b = boundaries.columns()[j].cast(k.datatype()).to_arrow()
            arr = pa.concat_arrays([_plain(k.to_arrow()), _plain(b)])
            cols[f"n{j}"] = pc.if_else(pc.is_valid(arr),
                                       pa.scalar(1 if nf else 0, pa.int8()),
                                       pa.scalar(0 if nf else 1, pa.int8()))
            cols[f"k{j}"] = arr
            order_keys.append((f"n{j}", "ascending"))
            order_keys.append((f"k{j}", "descending" if d else "ascending"))
        # the tie-break: a row sorts before a boundary equal to it
        cols["b"] = pa.array(np.concatenate(
            [np.zeros(self._len, np.int8), np.ones(nb, np.int8)]))
        order_keys.append(("b", "ascending"))
        order = pc.sort_indices(pa.table(cols),
                                sort_keys=order_keys).to_numpy()
        is_b = order >= self._len
        ahead = np.cumsum(is_b) - is_b
        pid = np.empty(self._len, dtype=np.int64)
        pid[order[~is_b]] = ahead[~is_b]
        return self._split_by_pid(pid, nparts)

    def partition_by_value(self, exprs: Sequence[Expression]
                           ) -> "tuple[List[RecordBatch], RecordBatch]":
        """One batch per distinct key of ``exprs`` and a batch of those
        keys, one row per part (the hive-partitioned write's split)."""
        keys = RecordBatch.from_series([self.eval_expression(e)
                                        for e in exprs])
        tbl = keys.to_arrow_table().append_column(
            "__row__", pa.array(np.arange(self._len)))
        g = tbl.group_by([c for c in tbl.column_names if c != "__row__"],
                         use_threads=False).aggregate([("__row__", "list")])
        parts = []
        for i in range(g.num_rows):
            idx = np.asarray(g.column("__row___list")[i].as_py())
            parts.append(self.take(idx))
        pvalues = RecordBatch.from_arrow_table(
            g.drop_columns(["__row___list"]))
        return parts, pvalues

    def _split_by_pid(self, pid: np.ndarray, n: int) -> List["RecordBatch"]:
        from . import native
        # one counting sort into a stable gather list (the native library,
        # or its twin, a stable argsort): each part keeps row order
        counts, order = native.fanout_pid(pid, n)
        sorted_batch = self.take(order)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [sorted_batch.slice(int(offsets[i]), int(offsets[i + 1]))
                for i in range(n)]

    # ---- misc ------------------------------------------------------------

    def add_monotonically_increasing_id(self, partition_num: int,
                                        column_name: str) -> "RecordBatch":
        """64-bit ids: upper 28 bits partition, lower 36 row index
        (reference: daft-recordbatch monotonically_increasing_id)."""
        ids = (np.uint64(partition_num) << np.uint64(36)) + \
            np.arange(self._len, dtype=np.uint64)
        s = Series.from_arrow(pa.array(ids), column_name)
        return RecordBatch.from_series([s] + self._columns)

    def cast_to_schema(self, schema: Schema) -> "RecordBatch":
        cols = []
        for f in schema:
            if f.name in self._schema:
                cols.append(self.get_column(f.name).cast(f.dtype))
            else:
                cols.append(Series.full_null(f.name, f.dtype, self._len))
        return RecordBatch(schema, cols, self._len)

    def __repr__(self):
        return repr(self.to_pandas()) if self._len <= 20 else \
            repr(self.head(10).to_pandas()) + f"\n… ({self._len} rows)"


def _explode_series(s: Series, lengths: np.ndarray) -> Series:
    """The list column ``s`` flattened, a null or empty list one null row
    (``lengths`` holds each row's output count, at least 1): the
    reference's per-row ``_explode_series`` with Arrow kernels."""
    inner_dt = s.datatype().inner if s.datatype().is_list() \
        else s.datatype()
    arr = s.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if not (pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type)
            or pa.types.is_fixed_size_list(arr.type)):
        out = []
        for v in arr.to_pylist():
            if not v:
                out.append(None)
            else:
                out.extend(v)
        return Series.from_pylist(out, s.name(), dtype=inner_dt)
    n = len(arr)
    own = pc.fill_null(pc.list_value_length(arr), 0) \
        .to_numpy(zero_copy_only=False).astype(np.int64)
    # list_flatten drops null lists' slots and keeps null elements
    flat = pc.list_flatten(arr)
    if len(flat) == int(lengths.sum()):
        out = flat
    else:
        # rows whose list is null or empty take one null slot: gather the
        # flattened values with -1 (null) at those rows
        starts = np.concatenate([[0], np.cumsum(own)[:-1]]) if n else own
        pos = np.repeat(starts - np.cumsum(
            np.concatenate([[0], lengths[:-1]])), lengths) + \
            np.arange(int(lengths.sum()))
        empty = np.repeat(own == 0, lengths)
        idx = pa.array(np.where(empty, 0, pos), mask=empty)
        out = flat.take(idx) if len(flat) else pa.nulls(len(idx), flat.type)
    return Series.from_arrow(out, s.name()).cast(inner_dt)


def _plain(arr):
    """``arr`` without dictionary encoding (a sort key's values)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_decode()
    return arr
