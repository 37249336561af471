"""User-defined data sinks (reference: ``daft/io/sink.py:31`` DataSink
ABC). The port's copy of ``daft_tpu/io/sink.py``."""

from __future__ import annotations

import dataclasses
from typing import Generic, Iterator, List, TypeVar

from ..micropartition import MicroPartition
from ..schema import Schema

T = TypeVar("T")


@dataclasses.dataclass
class WriteResult(Generic[T]):
    result: T
    bytes_written: int = 0
    rows_written: int = 0


class DataSink(Generic[T]):
    """Custom write destination; drive with ``DataFrame.write_sink``."""

    def name(self) -> str:
        return type(self).__name__

    def schema(self) -> Schema:
        from ..datatype import DataType
        from ..schema import Field
        return Schema([Field("write_results", DataType.python())])

    def start(self) -> None:
        pass

    def write(self, micropartitions: Iterator[MicroPartition]) -> Iterator[WriteResult[T]]:
        raise NotImplementedError

    def finalize(self, write_results: List[WriteResult[T]]) -> MicroPartition:
        from ..series import Series
        from ..recordbatch import RecordBatch
        s = Series.from_pyobjects([w.result for w in write_results],
                                  "write_results")
        return MicroPartition.from_recordbatch(RecordBatch.from_series([s]))
