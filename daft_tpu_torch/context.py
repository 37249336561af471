"""Global context: the frozen-per-query execution config.

Reference: ``src/common/daft-config/src/lib.rs:40-100`` and
``daft/context.py:156-269``. The port keeps the fields its slice reads and
the one runner it has (``execution/executor.py:run_plan``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Frozen-per-query execution knobs."""

    #: rows per morsel for host operators; a device fragment takes one
    #: whole source-file batch instead (see ``_exec_DeviceFragmentAgg``)
    default_morsel_size: int = 128 * 1024
    #: ``"cuda"`` / ``"cpu"`` / ``"0"`` (host tier only); None defers to
    #: ``DAFT_TORCH_DEVICE`` and then to ``"cuda"``
    device: Optional[str] = None
    #: a join side whose estimated size is at most this many bytes is
    #: gathered once and joined against each morsel of the other side
    broadcast_join_size_bytes_threshold: int = 10 * 1024 * 1024
    #: in-flight device slots of the fused-agg pipeline (0 = synchronous);
    #: ``DAFT_TORCH_DEVICE_INFLIGHT`` wins when set
    device_inflight: int = 2
    #: fusion regions: ``auto`` (priced per morsel), ``1`` (admit every
    #: one) or ``0`` (none planned); ``DAFT_TORCH_FUSION`` wins when set
    fusion: str = "auto"
    #: most operators one fusion region absorbs;
    #: ``DAFT_TORCH_FUSION_MAX_OPS`` wins when set
    fusion_max_ops: int = 8


class Context:
    def __init__(self):
        self.execution_config = ExecutionConfig()


_context: Optional[Context] = None
_context_lock = threading.Lock()


def get_context() -> Context:
    global _context
    with _context_lock:
        if _context is None:
            _context = Context()
        return _context


def set_execution_config(config: Optional[ExecutionConfig] = None,
                         **kwargs) -> Context:
    ctx = get_context()
    base = config or ctx.execution_config
    ctx.execution_config = dataclasses.replace(base, **kwargs)
    return ctx


@contextlib.contextmanager
def execution_config_ctx(**kwargs):
    ctx = get_context()
    old = ctx.execution_config
    try:
        ctx.execution_config = dataclasses.replace(old, **kwargs)
        yield ctx
    finally:
        ctx.execution_config = old
