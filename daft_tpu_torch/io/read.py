"""Public read entry points (reference: ``daft/io/_parquet.py``)."""

from __future__ import annotations

from typing import List, Union

from .scan import GlobScanOperator


def read_parquet(path: Union[str, List[str]]):
    """Lazily read local Parquet file(s) into a DataFrame
    (reference: ``daft/io/_parquet.py:20``)."""
    from ..dataframe import DataFrame
    from ..logical.builder import LogicalPlanBuilder
    return DataFrame(LogicalPlanBuilder.from_scan(GlobScanOperator(path)))
