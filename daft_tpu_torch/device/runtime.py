"""Device-tier bookkeeping shared by the fused fragments: dispatch
counters, the per-batch scalar preparation, and the helpers that route
string dictionaries from the encoded inputs to the decoded outputs.

The port keeps the agg half of ``daft_tpu/device/runtime.py`` and the
join counters. Its per-operator device paths (projection, predicate,
argsort, agg outside a fragment) and their cost gates come with later
slices.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import pyarrow as pa
import torch

from ..expressions.expressions import Expression
from . import column as dcol

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Bump a dispatch counter: ``dense`` / ``hash`` / ``sort`` /
    ``global`` per fused dispatch by strategy, ``host_morsels`` per morsel
    a DeviceFragmentAgg ran on the host; ``join_hash`` / ``join_sort`` per
    device join dispatch by strategy (an overflow re-dispatch counts
    again), ``host_joins`` per equi-join index generation on the host."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


def _string_out_source(e: Expression) -> Optional[str]:
    """If expr output is a passthrough of a column, its source name."""
    inner = e._unalias()
    return inner.params[0] if inner.op == "col" else None


def _prep_scalars(c, dt: dcol.DeviceTable):
    """Per-batch scalar arguments (string-literal ranks) of a compiled
    program, on the table's device."""
    scalars = []
    for spec in c.scalar_specs:
        d = dt.columns[spec.col].dictionary
        if d is None:
            d = pa.array([], type=pa.large_string())
        scalars.append(torch.as_tensor(spec.fn(d), device=dt.device))
    return tuple(scalars)


def key_dictionary(e: Expression, field, dt: dcol.DeviceTable
                   ) -> Optional[pa.Array]:
    """The dictionary a string group key decodes through: its source
    column's."""
    if field.dtype.is_string() or field.dtype.is_binary():
        return dt.columns[_string_out_source(e)].dictionary
    return None
