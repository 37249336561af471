"""Runner abstraction and the materialized result.

Reference: ``daft_tpu/runners/runner.py`` (``daft/runners/runner.py:25-70``:
run / run_iter / run_iter_tables, and ``PartitionSet``). The reference's
``PartitionSetCache`` is not ported: no caller of the port reads it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from ..micropartition import MicroPartition
from ..recordbatch import RecordBatch
from ..schema import Schema


class PartitionSet:
    """Materialized query result: an ordered list of MicroPartitions."""

    def __init__(self, partitions: List[MicroPartition], schema: Schema):
        self.partitions = partitions
        self.schema = schema

    def num_partitions(self) -> int:
        return len(self.partitions)

    def __len__(self) -> int:
        return sum(len(p) for p in self.partitions)

    def to_recordbatch(self) -> RecordBatch:
        batches = []
        for p in self.partitions:
            batches.extend(p.batches())
        batches = [b for b in batches if len(b)] or batches[:1]
        if not batches:
            return RecordBatch.empty(self.schema)
        return RecordBatch.concat(batches).cast_to_schema(self.schema)


class Runner:
    def run(self, builder) -> PartitionSet:
        return PartitionSet(list(self.run_iter(builder)), builder.schema())

    def run_iter(self, builder,
                 results_buffer_size: Optional[int] = None
                 ) -> Iterator[MicroPartition]:
        raise NotImplementedError

    def run_iter_tables(self, builder,
                        results_buffer_size: Optional[int] = None
                        ) -> Iterator[RecordBatch]:
        for p in self.run_iter(builder, results_buffer_size):
            for b in p.batches():
                if len(b):
                    yield b
