"""Global context: the frozen-per-query execution config.

Reference: ``src/common/daft-config/src/lib.rs:40-100`` and
``daft/context.py:156-269``. The port keeps the fields its engine reads.
Queries run through the runner :func:`get_runner` picks:
``runners/native_runner.py`` by default, ``runners/distributed_runner.py``
under ``DAFT_TORCH_RUNNER=distributed`` or after :func:`set_runner`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Frozen-per-query execution knobs."""

    #: a scan merges small adjacent files into one task until it holds
    #: this many bytes (footer sizes), never past the maximum; a whole
    #: file above the maximum splits into row-group ranges
    #: (``io/scan.py``)
    scan_tasks_min_size_bytes: int = 96 * 1024 * 1024
    scan_tasks_max_size_bytes: int = 384 * 1024 * 1024
    #: the scan's IO (``io/read_planner.py``); the ``DAFT_TORCH_IO_*`` and
    #: ``DAFT_TORCH_SCAN_PREFETCH`` knobs win when set: the hole a range
    #: coalesce absorbs, the request floor, the concurrent range GETs per
    #: object, planned (coalesced) remote parquet reads, the scan tasks
    #: resolved ahead, the chunk of the streaming CSV/JSON reader and the
    #: head bytes of a remote CSV/JSON schema inference
    io_coalesce_gap: int = 1 << 20
    io_min_request: int = 8 << 20
    io_range_parallelism: int = 8
    io_planned_reads: bool = True
    scan_prefetch: int = 2
    io_stream_chunk: int = 8 << 20
    io_infer_bytes: int = 1 << 20
    #: rows per morsel for host operators; a device fragment takes one
    #: whole scan task's batch instead (see ``_exec_DeviceFragmentAgg``)
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
    #: the local engine: ``push`` (``execution/pipeline.py``) or
    #: ``interp`` (``execution/executor.py`` alone);
    #: ``DAFT_TORCH_LOCAL_EXECUTOR`` wins when set
    local_executor: str = "push"
    #: the runner's stage-by-stage re-planning loop and the executor's
    #: adaptive join demotion and shuffle coalescing
    enable_aqe: bool = False
    #: keys sampled per morsel for a sort's or range exchange's boundaries
    sample_size_for_sort: int = 20
    #: a streaming breaker's bucket size target (also AQE's shuffle target)
    target_partition_size_bytes: int = 512 * 1024 * 1024
    #: hash exchange strategy: ``auto``/``naive`` (the bucket store) or
    #: ``spill_cache`` (every bucket on disk)
    shuffle_algorithm: str = "auto"
    #: the most partitions an aggregation's hash exchange fans out to
    shuffle_aggregation_default_partitions: int = 200
    #: out of core (``execution/out_of_core.py``); the ``DAFT_TORCH_SPILL_*``
    #: knobs win when set
    spill_join: str = "auto"
    spill_agg: str = "auto"
    spill_partitions: int = 0
    spill_max_depth: int = 3
    spill_compression: str = ""
    spill_io_parallelism: int = 4
    #: the RSS governor's watermarks (``execution/governor.py``);
    #: ``DAFT_TORCH_GOVERNOR_HIGH`` / ``_LOW`` win when set
    governor_high: float = 0.85
    governor_low: float = 0.70
    #: the distributed tier (``distributed/``): which workers share a
    #: device mesh (``name=w0,w1;name2=w2``; empty = autodetect), the hash
    #: boundaries' exchange path (``auto``, ``collective``,
    #: ``hierarchical`` or ``flight``) and the runtime re-planner;
    #: ``DAFT_TORCH_WORKER_TOPOLOGY`` / ``_EXCHANGE_PATH`` / ``_ADAPTIVE``
    #: win when set
    worker_topology: str = ""
    exchange_path: str = "auto"
    adaptive: bool = False
    #: the serving plane (``serving/scheduler.py``): worker slots, the
    #: queued-query cap, the queue and admission wait bound (s), and the
    #: plan and result caches' byte budgets; the ``DAFT_TORCH_SERVE_*``
    #: knobs win when set
    serve_concurrency: int = 4
    serve_queue_depth: int = 64
    serve_queue_timeout: float = 30.0
    serve_plan_cache_bytes: int = 64 << 20
    serve_result_cache_bytes: int = 64 << 20


class Context:
    def __init__(self):
        self._lock = threading.Lock()
        self._runner = None
        self.execution_config = ExecutionConfig()

    def get_or_create_runner(self):
        """The process's runner: the one :func:`set_runner` installed,
        else the one ``DAFT_TORCH_RUNNER`` names (``native``, the
        default, or ``distributed``), made once (reference
        ``daft_tpu/context.py:172-188``)."""
        with self._lock:
            if self._runner is None:
                from . import knobs
                name = knobs.env_str("DAFT_TORCH_RUNNER").lower()
                if name in ("native", "py"):
                    from .runners.native_runner import get_runner
                    self._runner = get_runner()
                elif name in ("torch_distributed", "distributed"):
                    from .runners.distributed_runner import \
                        DistributedRunner
                    self._runner = DistributedRunner()
                else:
                    raise ValueError(
                        f"DAFT_TORCH_RUNNER={name!r}: expected 'native' or "
                        "'distributed'")
            return self._runner

    def set_runner(self, runner) -> None:
        """Install ``runner`` (a ``Runner``; None goes back to the
        ``DAFT_TORCH_RUNNER`` choice at the next query). The caller owns
        the runner it replaces (``DistributedRunner.shutdown`` stops its
        workers)."""
        with self._lock:
            self._runner = runner


_context: Optional[Context] = None
_context_lock = threading.Lock()


def get_context() -> Context:
    global _context
    with _context_lock:
        if _context is None:
            _context = Context()
        return _context


def get_runner():
    """The runner queries run through (:meth:`Context.get_or_create_runner`)."""
    return get_context().get_or_create_runner()


def set_runner(runner) -> None:
    """Install the process's runner: ``set_runner(DistributedRunner(4))``,
    or ``set_runner(None)`` to go back to ``DAFT_TORCH_RUNNER``."""
    get_context().set_runner(runner)


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
