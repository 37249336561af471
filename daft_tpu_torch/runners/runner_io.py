"""Planning-time materialization helpers (reference:
``daft_tpu/runners/runner_io.py``): the pivot's distinct-values probe."""

from __future__ import annotations

from typing import List


def materialize_for_planning(builder) -> List:
    """Run a small plan eagerly through the process's runner (as every
    query runs) and return its single column as a pylist."""
    from ..context import get_runner
    rb = get_runner().run(builder).to_recordbatch()
    return rb.get_column(rb.column_names()[0]).to_pylist()
