"""MicroPartition: lazily-materialized unit of data movement.

Reference: ``src/daft-micropartition/src/micropartition.rs:36-90`` —
``TableState::{Unloaded(ScanTask), Loaded(Vec<RecordBatch>)}``; an unloaded
partition carries its scan task + stats and materializes on first touch. All
logical ops are mirrored at this level so unloaded partitions can flow through
the executor with metadata-only handling.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa

from .expressions import Expression
from .recordbatch import RecordBatch
from .schema import Schema


class MicroPartition:
    """Either loaded batches or a thunk that produces them (a ScanTask)."""

    def __init__(self, schema: Schema,
                 batches: Optional[List[RecordBatch]] = None,
                 scan_task: Optional[Any] = None,
                 metadata_num_rows: Optional[int] = None,
                 metadata_size_bytes: Optional[int] = None):
        assert (batches is None) != (scan_task is None)
        self._schema = schema
        self._batches = batches
        self._scan_task = scan_task
        self._meta_rows = metadata_num_rows
        self._meta_bytes = metadata_size_bytes
        self._lock = threading.Lock()

    def __getstate__(self):
        # partitions cross process boundaries (remote workers); the load
        # lock is per-process state
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_recordbatch(cls, rb: RecordBatch) -> "MicroPartition":
        return cls(rb.schema, batches=[rb])

    @classmethod
    def from_recordbatches(cls, rbs: List[RecordBatch],
                           schema: Optional[Schema] = None) -> "MicroPartition":
        assert rbs or schema is not None
        return cls(schema or rbs[0].schema, batches=list(rbs))

    @classmethod
    def from_scan_task(cls, scan_task) -> "MicroPartition":
        return cls(scan_task.materialized_schema(), scan_task=scan_task,
                   metadata_num_rows=scan_task.num_rows(),
                   metadata_size_bytes=scan_task.size_bytes())

    @classmethod
    def empty(cls, schema: Optional[Schema] = None) -> "MicroPartition":
        schema = schema or Schema.empty()
        return cls(schema, batches=[RecordBatch.empty(schema)])

    @classmethod
    def from_pydict(cls, data: Dict[str, Any]) -> "MicroPartition":
        return cls.from_recordbatch(RecordBatch.from_pydict(data))

    @classmethod
    def from_arrow_table(cls, t: pa.Table) -> "MicroPartition":
        return cls.from_recordbatch(RecordBatch.from_arrow_table(t))

    # ---- state -----------------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self._schema

    def is_loaded(self) -> bool:
        return self._batches is not None

    def _load(self) -> List[RecordBatch]:
        with self._lock:
            if self._batches is None:
                batches = self._scan_task.execute()
                self._batches = [b.cast_to_schema(self._schema) for b in batches]
                self._scan_task = None
            return self._batches

    def combined(self) -> RecordBatch:
        bs = self._load()
        if len(bs) == 1:
            return bs[0]
        if not bs:
            return RecordBatch.empty(self._schema)
        merged = RecordBatch.concat(bs)
        with self._lock:
            self._batches = [merged]
        return merged

    def batches(self) -> List[RecordBatch]:
        return list(self._load())

    def __len__(self) -> int:
        if self._batches is None and self._meta_rows is not None:
            return self._meta_rows
        return sum(len(b) for b in self._load())

    def size_bytes(self) -> int:
        if self._batches is None and self._meta_bytes is not None:
            return self._meta_bytes
        return sum(b.size_bytes() for b in self._load())

    def metadata_num_rows(self) -> Optional[int]:
        """Row count without forcing a load (None if unknown)."""
        if self._batches is not None:
            return sum(len(b) for b in self._batches)
        return self._meta_rows

    # ---- mirrored ops (load-on-touch) -----------------------------------
    def eval_expression_list(self, exprs: Sequence[Expression]) -> "MicroPartition":
        out = self.combined().eval_expression_list(list(exprs))
        return MicroPartition.from_recordbatch(out)

    def filter(self, predicate: Expression) -> "MicroPartition":
        return MicroPartition.from_recordbatch(self.combined().filter(predicate))

    def head(self, n: int) -> "MicroPartition":
        return MicroPartition.from_recordbatch(self.combined().head(n))

    def sample(self, **kwargs) -> "MicroPartition":
        return MicroPartition.from_recordbatch(self.combined().sample(**kwargs))

    def sort(self, keys, descending=None, nulls_first=None) -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().sort(keys, descending, nulls_first))

    def agg(self, to_agg, group_by=()) -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().agg(to_agg, group_by))

    def hash_join(self, right: "MicroPartition", left_on, right_on,
                  how="inner") -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().hash_join(right.combined(), left_on, right_on,
                                      how))

    def cross_join(self, right: "MicroPartition") -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().cross_join(right.combined()))

    def distinct(self, on=None) -> "MicroPartition":
        return MicroPartition.from_recordbatch(self.combined().distinct(on))

    def explode(self, exprs) -> "MicroPartition":
        return MicroPartition.from_recordbatch(self.combined().explode(exprs))

    def unpivot(self, ids, values, variable_name,
                value_name) -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().unpivot(ids, values, variable_name, value_name))

    def pivot(self, group_by, pivot_col, value_col,
              names) -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().pivot(group_by, pivot_col, value_col, names))

    def add_monotonically_increasing_id(self, partition_num: int,
                                        column_name: str
                                        ) -> "MicroPartition":
        return MicroPartition.from_recordbatch(
            self.combined().add_monotonically_increasing_id(partition_num,
                                                            column_name))

    def concat(self, others: List["MicroPartition"]) -> "MicroPartition":
        batches = self.batches()
        for o in others:
            batches.extend(o.batches())
        return MicroPartition.from_recordbatches(batches, self._schema)

    def partition_by_hash(self, exprs, num_partitions
                          ) -> List["MicroPartition"]:
        return [MicroPartition.from_recordbatch(b)
                for b in self.combined().partition_by_hash(exprs,
                                                           num_partitions)]

    def partition_by_random(self, num_partitions, seed
                            ) -> List["MicroPartition"]:
        return [MicroPartition.from_recordbatch(b) for b in
                self.combined().partition_by_random(num_partitions, seed)]

    def partition_by_range(self, keys, boundaries, descending,
                           nulls_first=None) -> List["MicroPartition"]:
        return [MicroPartition.from_recordbatch(b) for b in
                self.combined().partition_by_range(keys, boundaries,
                                                   descending, nulls_first)]

    def cast_to_schema(self, schema: Schema) -> "MicroPartition":
        if self._batches is None:
            return MicroPartition(schema, scan_task=self._scan_task,
                                  metadata_num_rows=self._meta_rows,
                                  metadata_size_bytes=self._meta_bytes)
        return MicroPartition.from_recordbatches(
            [b.cast_to_schema(schema) for b in self._batches], schema)

    def to_arrow_table(self) -> pa.Table:
        return self.combined().to_arrow_table()

    def to_pydict(self) -> Dict[str, list]:
        return self.combined().to_pydict()

    def __repr__(self):
        state = "Loaded" if self.is_loaded() else "Unloaded"
        return f"MicroPartition[{state}]({self._schema}, rows={self.metadata_num_rows()})"
