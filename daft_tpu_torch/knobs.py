"""The port's environment knobs, all under the ``DAFT_TORCH_`` prefix: the
single declarative registry (the reference's ``daft_tpu/analysis/knobs.py``).

Every knob is declared here once: name, parse type, default, owning module,
README table group and a one-line doc. Runtime code reads knobs through the
typed accessors (``env_int`` / ``env_opt_int``, ``env_float`` /
``env_opt_float``, ``env_bool``, ``env_bytes``, ``env_str``, and ``env_raw``
where presence matters), so each knob has one parse site:
``analysis/rule_knobs.py`` flags raw ``os.environ`` reads of a
``DAFT_TORCH_*`` name, an unregistered name, an accessor whose type is not
the registered one, and a registered name that appears nowhere. The
README's port knob tables are generated from this registry (``python -m
daft_tpu_torch.analysis --knob-docs --write``), between the port's own
markers (``<!-- torch-knob-table:<group> BEGIN -->``); the reference's
tables are not touched.

Read at call time (never cached at import), so a test can set one with
``monkeypatch.setenv``. A knob whose default is None is unset unless the
environment names it (:func:`env_raw` returns None). Knobs mirrored by an
``ExecutionConfig`` field name it in ``config_field``: the variable wins
when set.

This module must stay import-light (os and dataclasses only): the whole
port imports it, the lock sanitizer's arming included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str           # full variable name (DAFT_TORCH_...)
    type: str           # "int" | "float" | "bool" | "str" | "bytes"
    default: object     # parsed-type default; None = unset
    module: str         # owning module (repo-relative path)
    group: str          # README table group (one generated table each)
    doc: str            # one-line effect description for the table
    config_field: str = ""   # mirrored ExecutionConfig field, if any
    default_str: str = ""    # display override for the docs table


def _k(name, type_, default, module, group, doc, config_field="",
       default_str=""):
    return Knob(name, type_, default, module, group, doc, config_field,
                default_str)


_KNOBS: List[Knob] = [
    # -------------------------------------------------------- core
    _k("DAFT_TORCH_DEVICE", "str", 'cuda', "daft_tpu_torch/context.py",
           "core", '`cuda` (default), `cpu`, or `0` for the host tier only; an '
           'explicit `ExecutionConfig.device` wins',
           config_field='device'),
    _k("DAFT_TORCH_DEVICE_MIN_ROWS", "int", None, "daft_tpu_torch/device/runtime.py",
           "core", 'unset (default): the cost model prices each per-operator '
           'dispatch (projection, predicate, argsort, agg outside a fused '
           'fragment); set: a batch of at least this many rows runs on the '
           'device and a smaller one on the host tier (`host_ops`), '
           'without pricing (`DAFT_TORCH_DEVICE_FORCE` trumps it), and a '
           'fused-agg morsel of fewer rows runs on the host '
           '(`host_morsels`) before any pricing', default_str='cost model'),
    _k("DAFT_TORCH_DEVICE_FORCE", "str", None, "daft_tpu_torch/device/costmodel.py",
           "core", '`1`/`device`: every priced decision picks the device; '
           '`0`/`host`: the host; unset: the cost model decides'),
    _k("DAFT_TORCH_DEVICE_JOIN", "str", None, "daft_tpu_torch/joins.py",
           "core", "`1`: every equi-join's index generation runs on the device; "
           '`0`: on the host; unset: when both sides hold at least 8,192 '
           'rows together and `costmodel.join_wins` prices the device '
           'cheaper', default_str='cost model'),
    _k("DAFT_TORCH_LOCAL_EXECUTOR", "str", None, "daft_tpu_torch/context.py",
           "core", '`push` (the push pipeline, `execution/pipeline.py`) or '
           '`interp` (the pull interpreter); unset defers to '
           '`ExecutionConfig.local_executor` (default `push`)',
           config_field='local_executor'),
    # ----------------------------------------------------- kernels
    _k("DAFT_TORCH_KERNEL_GROUPBY", "str", 'auto', "daft_tpu_torch/device/costmodel.py",
           "kernels", "grouped-agg strategy: `auto` (dense, else the cost model's "
           'hash or sort), or force `dense`/`hash`/`sort`'),
    _k("DAFT_TORCH_KERNEL_HASH_NDV_FRAC", "float", 0.5, "daft_tpu_torch/device/costmodel.py",
           "kernels", '`auto` group-bys take sort when the footer NDV estimate '
           "exceeds this fraction of the dispatch's rows (near-unique "
           'keys)'),
    _k("DAFT_TORCH_KERNEL_HASH_LOAD", "float", 0.5, "daft_tpu_torch/device/hash_kernels.py",
           "kernels", 'max hash-table load factor: the table holds `out_cap / load` '
           'slots (clamped to [0.05, 0.95])'),
    _k("DAFT_TORCH_KERNEL_MAX_TABLE", "int", 1 << 20, "daft_tpu_torch/device/hash_kernels.py",
           "kernels", 'hash-agg table slot ceiling; larger group budgets take sort '
           '(joins have none: their tables live in device memory)', default_str='2^20'),
    _k("DAFT_TORCH_KERNEL_HASH_MAX_BITS", "int", 128, "daft_tpu_torch/device/hash_kernels.py",
           "kernels", 'widest packed key set (bits, ≤128) the hash kernel accepts'),
    _k("DAFT_TORCH_KERNEL_JOIN", "str", 'auto', "daft_tpu_torch/device/costmodel.py",
           "kernels", 'device equi-join strategy: `auto` (hash on a card, sort on CPU '
           'tensors), or force `hash` (build/probe kernels) / `sort` '
           '(torch sort join)'),
    # ------------------------------------------------------ device
    _k("DAFT_TORCH_DEVICE_INFLIGHT", "str", '', "daft_tpu_torch/device/pipeline.py",
           "device", 'in-flight device slots of the fused-agg pipeline (0 = the '
           'synchronous path; at most 64); unset defers to '
           '`ExecutionConfig.device_inflight` (default 2)',
           config_field='device_inflight', default_str='unset'),
    _k("DAFT_TORCH_DEVICE_CACHE_BYTES", "int", 8 * 1024 ** 3, "daft_tpu_torch/device/cache.py",
           "device", 'byte budget of the device column cache (encoded scan columns '
           'kept on the card across queries, LRU); the residency registry '
           'of decoded planes gets 1/8 of it', default_str='8GiB'),
    _k("DAFT_TORCH_CACHE_INVEST", "bool", True, "daft_tpu_torch/device/costmodel.py",
           "device", 'price a cacheable fused-agg upload as an investment the device '
           'column cache repays (bounded by `INVEST_MAX_RATIO`); `0`: '
           'every upload must beat the host outright'),
    _k("DAFT_TORCH_FUSION", "str", None, "daft_tpu_torch/physical/fusion.py",
           "device", 'fusion regions (`physical/fusion.py`): `auto` prices each '
           'region morsel (`costmodel.fusion_wins`), `1` admits every one, '
           '`0` plans none; unset defers to `ExecutionConfig.fusion` '
           '(default `auto`)',
           config_field='fusion'),
    _k("DAFT_TORCH_FUSION_MAX_OPS", "int", None, "daft_tpu_torch/physical/fusion.py",
           "device", 'most operators one fusion region absorbs (at least 2); unset '
           'defers to `ExecutionConfig.fusion_max_ops` (default 8)',
           config_field='fusion_max_ops'),
    _k("DAFT_TORCH_AOT_WARMUP", "bool", False, "daft_tpu_torch/device/warmup.py",
           "device", '`1`: `warmup.maybe_warmup_session` builds the CUDA library and '
           'launches each kernel and strategy once per capacity class, and '
           'every fusion region program seen so far'),
    # -------------------------------------------------- cost-model
    _k("DAFT_TORCH_LINK_RTT_MS", "float", None, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'host↔device round trip (ms): with `_UP_MBPS` / `_DOWN_MBPS`, '
           'skips the link measurement', default_str='measured'),
    _k("DAFT_TORCH_LINK_UP_MBPS", "float", None, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'host→device rate (MB/s) the cost model prices with', default_str='measured'),
    _k("DAFT_TORCH_LINK_DOWN_MBPS", "float", None, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'device→host rate (MB/s) the cost model prices with', default_str='measured'),
    _k("DAFT_TORCH_LINK_CACHE", "bool", True, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'reuse a measured link profile stored for this card and host '
           '(`0`: measure in every process)'),
    _k("DAFT_TORCH_LINK_CACHE_PATH", "str", None, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'file of the stored link profile (default '
           '`daft_tpu_torch/_build/link_profile.json`)'),
    _k("DAFT_TORCH_DISPATCH_LOG", "str", None, "daft_tpu_torch/device/costmodel.py",
           "cost-model", 'append one JSON line per cost-model decision to this file'),
    _k("DAFT_TORCH_CALIBRATION", "bool", False, "daft_tpu_torch/device/calibration.py",
           "cost-model", "`1`: learn the cost model's device rates from real dispatches "
           '(EWMA) and price with them past the sample floor'),
    _k("DAFT_TORCH_CALIBRATION_DIR", "str", None, "daft_tpu_torch/device/calibration.py",
           "cost-model", 'directory of the learned profile, one file per card and host '
           '(unset: kept in memory only)'),
    _k("DAFT_TORCH_CALIBRATION_ALPHA", "float", 0.2, "daft_tpu_torch/device/calibration.py",
           "cost-model", 'EWMA weight of one new observation (clamped to [1e-3, 1])'),
    _k("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "int", 8, "daft_tpu_torch/device/calibration.py",
           "cost-model", 'observations before a learned value replaces its default'),
    # ------------------------------------------------------- spill
    _k("DAFT_TORCH_MEMORY_LIMIT", "bytes", None, "daft_tpu_torch/execution/memory.py",
           "spill", 'host byte budget of the pipeline breakers (e.g. `4GB`, '
           '`512MiB`, `400KB`); past it they spill to Arrow IPC files; '
           'unset: a quarter of physical RAM; a malformed value is an '
           'error', default_str='¼ of RAM'),
    _k("DAFT_TORCH_SPILL_DIR", "str", None, "daft_tpu_torch/execution/memory.py",
           "spill", 'directory of the spill files (default: a fresh temporary '
           'directory)', default_str='tmpdir'),
    _k("DAFT_TORCH_SPILL_JOIN", "str", None, "daft_tpu_torch/execution/out_of_core.py",
           "spill", "`auto` (the cost model's `spill_plan` decision), `1` (force "
           "the grace hash join's partitioned pairs) or `0` (materialize "
           'both sides and re-fan them); unset defers to '
           '`ExecutionConfig.spill_join`',
           config_field='spill_join'),
    _k("DAFT_TORCH_SPILL_AGG", "str", None, "daft_tpu_torch/execution/out_of_core.py",
           "spill", '`auto`, `1` (force the spilling partitioned-agg reducer) or '
           '`0` (decline it); unset defers to `ExecutionConfig.spill_agg`',
           config_field='spill_agg'),
    _k("DAFT_TORCH_SPILL_PARTITIONS", "int", None, "daft_tpu_torch/execution/out_of_core.py",
           "spill", 'non-zero: the first-level radix fanout of a grace join or '
           'spilling reducer (0 or unset: planner evidence decides)',
           config_field='spill_partitions'),
    _k("DAFT_TORCH_SPILL_MAX_DEPTH", "int", None, "daft_tpu_torch/execution/out_of_core.py",
           "spill", 'rotated-radix recursion bound of an oversized bucket (default '
           '`ExecutionConfig.spill_max_depth`, 3)',
           config_field='spill_max_depth'),
    _k("DAFT_TORCH_SPILL_COMPRESSION", "str", None, "daft_tpu_torch/execution/memory.py",
           "spill", 'spill-file codec: `lz4` (default), `zstd` or `none`',
           config_field='spill_compression'),
    _k("DAFT_TORCH_SPILL_IO_PARALLELISM", "int", None, "daft_tpu_torch/execution/spill_io.py",
           "spill", 'concurrent spill writes and bucket reads (default 4, at most '
           '8); `0`: serial writes under the store lock',
           config_field='spill_io_parallelism'),
    _k("DAFT_TORCH_GOVERNOR", "bool", True, "daft_tpu_torch/execution/governor.py",
           "spill", '`0` turns the RSS governor off (it acts only under a memory '
           'limit)'),
    _k("DAFT_TORCH_GOVERNOR_HIGH", "float", None, "daft_tpu_torch/execution/governor.py",
           "spill", 'RSS fraction of the memory limit that enters the pressured '
           'state (default 0.85)',
           config_field='governor_high'),
    _k("DAFT_TORCH_GOVERNOR_LOW", "float", None, "daft_tpu_torch/execution/governor.py",
           "spill", 'RSS fraction that leaves it again (default 0.70, clamped under '
           'the high mark)',
           config_field='governor_low'),
    # ----------------------------------------------------- io-scan
    _k("DAFT_TORCH_IO_COALESCE_GAP", "bytes", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'hole tolerance of byte-range coalescing (bytes, suffixes like '
           '`1MiB` accepted); unset defers to '
           '`ExecutionConfig.io_coalesce_gap` (1MiB)',
           config_field='io_coalesce_gap'),
    _k("DAFT_TORCH_IO_MIN_REQUEST", "bytes", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'request floor: a coalesced range request under it absorbs its '
           'neighbour across a hole under it; unset defers to '
           '`ExecutionConfig.io_min_request` (8MiB)',
           config_field='io_min_request'),
    _k("DAFT_TORCH_IO_RANGE_PARALLELISM", "int", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'concurrent range GETs per object; unset defers to '
           '`ExecutionConfig.io_range_parallelism` (8)',
           config_field='io_range_parallelism'),
    _k("DAFT_TORCH_IO_PLANNED_READS", "bool", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", "`0`: remote parquet reads take pyarrow's own ranged GETs per "
           'column chunk instead of the planned, coalesced ranges; unset '
           'defers to `ExecutionConfig.io_planned_reads` (on)',
           config_field='io_planned_reads'),
    _k("DAFT_TORCH_SCAN_PREFETCH", "int", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'scan tasks the scan source resolves ahead of the one it drains '
           '(`0`: whole-task loads on the shared pool); unset defers to '
           '`ExecutionConfig.scan_prefetch` (2)',
           config_field='scan_prefetch'),
    _k("DAFT_TORCH_IO_STREAM_CHUNK", "bytes", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'chunk of the streaming remote CSV/JSON reader; unset defers to '
           '`ExecutionConfig.io_stream_chunk` (8MiB)',
           config_field='io_stream_chunk'),
    _k("DAFT_TORCH_IO_INFER_BYTES", "bytes", None, "daft_tpu_torch/io/read_planner.py",
           "io-scan", 'head bytes read to infer a remote CSV/JSON schema (`0`: the '
           'whole object); unset defers to '
           '`ExecutionConfig.io_infer_bytes` (1MiB)',
           config_field='io_infer_bytes'),
    # ----------------------------------------------------- serving
    _k("DAFT_TORCH_SERVE_CONCURRENCY", "int", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "worker slots of the query scheduler (queries RUNNING at once); "
       "unset defers to `ExecutionConfig.serve_concurrency` (4)",
       config_field="serve_concurrency"),
    _k("DAFT_TORCH_SERVE_QUEUE_DEPTH", "int", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "most queued (not yet running) queries before a submission is "
       "rejected `queue_full`; unset defers to "
       "`ExecutionConfig.serve_queue_depth` (64)",
       config_field="serve_queue_depth"),
    _k("DAFT_TORCH_SERVE_QUEUE_TIMEOUT", "float", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "seconds a query may wait (in the queue, then again in admission) "
       "before it is rejected `queue_timeout` (`0` waits forever); unset "
       "defers to `ExecutionConfig.serve_queue_timeout` (30)",
       config_field="serve_queue_timeout"),
    _k("DAFT_TORCH_SERVE_PLAN_CACHE_BYTES", "bytes", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "LRU budget of the plan cache (optimized and translated plans "
       "keyed by plan fingerprint; `0` disables); unset defers to "
       "`ExecutionConfig.serve_plan_cache_bytes` (64MiB)",
       config_field="serve_plan_cache_bytes"),
    _k("DAFT_TORCH_SERVE_RESULT_CACHE_BYTES", "bytes", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "LRU budget of the result cache (materialized results of identical "
       "literal-inclusive fingerprints over unchanged sources; `0` "
       "disables); unset defers to "
       "`ExecutionConfig.serve_result_cache_bytes` (64MiB)",
       config_field="serve_result_cache_bytes"),
    _k("DAFT_TORCH_SERVE_MEMORY", "bytes", None,
       "daft_tpu_torch/serving/scheduler.py", "serving",
       "admission byte budget shared by concurrent queries (default: "
       "`DAFT_TORCH_MEMORY_LIMIT`, else the breaker budget; `0` disables "
       "admission)", default_str="memory limit"),
    # ----------------------------------------------- observability
    _k("DAFT_TORCH_TRACE", "bool", False, "daft_tpu_torch/tracing.py",
           "observability", '`1`: the query-wide tracing plane, one span tree per query '
           'across the planner, pipeline stages, scan producers and device '
           'dispatches (`tracing.py`), exported as Chrome trace JSON and '
           'OTLP spans'),
    _k("DAFT_TORCH_TRACE_SAMPLE", "float", 1.0, "daft_tpu_torch/tracing.py",
           "observability", 'fraction of queries traced when tracing is on (a deterministic '
           'per-query draw hashed from the trace key)'),
    _k("DAFT_TORCH_TRACE_DIR", "str", None, "daft_tpu_torch/tracing.py",
           "observability", 'directory receiving one perfetto-loadable `trace_<id>.json` '
           'per traced query (unset: traces stay in memory for the OTLP '
           'and flight-recorder exports)'),
    _k("DAFT_TORCH_TRACE_MAX_SPANS", "int", 8192, "daft_tpu_torch/tracing.py",
           "observability", 'per-query span-buffer bound; spans past it are counted as '
           'dropped'),
    _k("DAFT_TORCH_CHROME_TRACE", "str", None, "daft_tpu_torch/observability.py",
           "observability", "`1` or a path: a chrome://tracing JSON of the last execution's "
           'per-operator batches (`1`: '
           '`<tmpdir>/daft_torch_trace_<pid>.json`)'),
    _k("DAFT_TORCH_PROGRESS", "bool", False, "daft_tpu_torch/observability.py",
           "observability", "`1`: a tqdm partition-progress bar over the query's output"),
    _k("DAFT_TORCH_PROFILE_DIR", "str", None, "daft_tpu_torch/observability.py",
           "observability", 'directory receiving a torch.profiler capture per query (CPU '
           'activity, plus CUDA on a card) as a Kineto chrome trace '
           '`profile_<pid>_<n>.json`'),
    _k("DAFT_TORCH_OTLP_ENDPOINT", "str", None, "daft_tpu_torch/observability.py",
           "observability", "OTLP/HTTP collector receiving each query's operator counters "
           '(`/v1/metrics`) and, when traced, its spans (`/v1/traces`)'),
    _k("DAFT_TORCH_OTLP_TIMEOUT", "float", 5.0, "daft_tpu_torch/observability.py",
           "observability", 'seconds an OTLP export POST may take; a hung or failing '
           'collector is counted in `otlp_export_errors`, never raised'),
    _k("DAFT_TORCH_QUERY_LOG", "str", None, "daft_tpu_torch/tracing.py",
           "observability", "flight-recorder JSONL path: every query's stat blocks, trace "
           'summary and slow flag (served at `/api/history`)'),
    _k("DAFT_TORCH_QUERY_LOG_BYTES", "bytes", 16 << 20, "daft_tpu_torch/tracing.py",
           "observability", 'flight-recorder rotation cap: past it the JSONL rotates to '
           '`<path>.1` (one generation kept)', default_str='16MiB'),
    _k("DAFT_TORCH_SLOW_QUERY_MS", "float", 0.0, "daft_tpu_torch/tracing.py",
           "observability", 'wall time past which a flight-recorder entry is flagged `slow` '
           '(`0`: never)'),
    # ------------------------------------------------- distributed
    _k("DAFT_TORCH_RUNNER", "str", "native", "daft_tpu_torch/context.py",
       "distributed", "`native` (the local engine) or `distributed` (the "
       "stage runner over in-process workers, "
       "`runners/distributed_runner.py`); `set_runner` wins"),
    _k("DAFT_TORCH_NUM_WORKERS", "int", 0,
       "daft_tpu_torch/runners/distributed_runner.py", "distributed",
       "distributed-runner worker count (`0` = auto from the CPU count)",
       default_str="auto"),
    _k("DAFT_TORCH_MESH_DEVICES", "int", None,
       "daft_tpu_torch/parallel/mesh.py", "distributed",
       "shards of the device mesh, placed round-robin over the visible "
       "devices of the query's device type (all on `cuda:0` with one card, "
       "all on `cpu` under `DAFT_TORCH_DEVICE=cpu`); unset: one per visible "
       "CUDA device, so one card (or none) means no mesh",
       default_str="device count"),
    _k("DAFT_TORCH_MESH_MIN_ROWS", "int", None,
       "daft_tpu_torch/parallel/mesh.py", "distributed",
       "force-override of mesh admission: `0` forces the mesh path, `N` "
       "needs at least N rows; unset: the cost model prices the collective "
       "from the measured shard-to-shard copy rate "
       "(`DAFT_TORCH_ICI_MBPS`)", default_str="cost model"),
    _k("DAFT_TORCH_ICI_MBPS", "float", None,
       "daft_tpu_torch/device/costmodel.py", "distributed",
       "override the measured shard-to-shard exchange rate (MB/s) that "
       "mesh admission and the exchange-path choice price against",
       default_str="measured"),
    _k("DAFT_TORCH_ADAPTIVE", "bool", False,
       "daft_tpu_torch/distributed/replan.py", "distributed",
       "`1`: the distributed runtime re-planner folds each boundary's "
       "measured rows, bytes and key NDV into the stages not yet "
       "dispatched", config_field="adaptive"),
    _k("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "str", "flight",
       "daft_tpu_torch/distributed/scheduler.py", "distributed",
       "`driver` routes stage boundaries through the driver instead of "
       "the worker-to-worker shuffle plane"),
    _k("DAFT_TORCH_SHUFFLE_TRANSPORT", "str", "flight",
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "`flight` (Arrow Flight, where `pyarrow.flight` imports) or `http` "
       "partition transport"),
    _k("DAFT_TORCH_SHUFFLE_HOST", "str", "127.0.0.1",
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "bind address of the per-process partition server (`0.0.0.0` "
       "serves other hosts)"),
    _k("DAFT_TORCH_SHUFFLE_ADVERTISE", "str", None,
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "address peers are told to fetch from (default: the bind host, or "
       "`127.0.0.1` when bound to `0.0.0.0`)", default_str="bind host"),
    _k("DAFT_TORCH_SHUFFLE_COMPRESSION", "str", "lz4",
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "`lz4`/`zstd`/`none` IPC buffer compression of shuffle spill and "
       "wire; `none` where the codec is missing from the pyarrow build"),
    _k("DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM", "int", 4,
       "daft_tpu_torch/distributed/worker.py", "distributed",
       "per-source fetch concurrency of a reduce task's stage input; "
       "`DAFT_TORCH_CHAOS_SERIALIZE=1` forces 1 and an active "
       "`DAFT_TORCH_FAULT_SPEC` defaults it to 1"),
    _k("DAFT_TORCH_SHUFFLE_COMBINE", "str", "auto",
       "daft_tpu_torch/distributed/scheduler.py", "distributed",
       "map-side combine: `auto` (cost-model gated), `1` force, `0` off"),
    _k("DAFT_TORCH_SHUFFLE_WIRE_MBPS", "float", 1000.0,
       "daft_tpu_torch/device/costmodel.py", "distributed",
       "wire bandwidth the combine and exchange-path cost models assume"),
    _k("DAFT_TORCH_WORKER_TOPOLOGY", "str", None,
       "daft_tpu_torch/distributed/topology.py", "distributed",
       "mesh-group spec `name=w0,w1;name2=w2` naming which workers share "
       "a device mesh; unset autodetects (all in-process workers share "
       "the process mesh when one is up, else each worker is its own "
       "group)", config_field="worker_topology", default_str="autodetect"),
    _k("DAFT_TORCH_EXCHANGE_PATH", "str", "auto",
       "daft_tpu_torch/distributed/topology.py", "distributed",
       "hash-boundary exchange path: `collective` (the mesh all_to_all), "
       "`hierarchical` (collective inside a mesh, one stream per mesh), "
       "`flight` (per-worker streams) or `auto` (topology and cost model; "
       "chaos serialization forces `flight`)",
       config_field="exchange_path"),
    _k("DAFT_TORCH_SHUFFLE_TIMEOUT", "float", 600.0,
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "seconds a partition fetch may take before it fails as retryable"),
    _k("DAFT_TORCH_SHUFFLE_TTL", "float", 86400.0,
       "daft_tpu_torch/distributed/shuffle_service.py", "distributed",
       "idle seconds before an orphaned shuffle directory is swept when "
       "the first shuffle server of a process starts"),
    # -------------------------------------------------- resilience
    _k("DAFT_TORCH_FAULT_SPEC", "str", None,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "comma-separated `site:rate[:N][:sticky]` seeded fault-injection "
       "spec (`task`/`fetch`/`crash`/`rpc` sites)"),
    _k("DAFT_TORCH_FAULT_SEED", "str", "0",
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "seed hashed into every fault-injection decision (same seed, same "
       "fault events)"),
    _k("DAFT_TORCH_CHAOS_SERIALIZE", "bool", False,
       "daft_tpu_torch/distributed/worker.py", "resilience",
       "`1` runs one task (with its retries) at a time and takes the "
       "sequential fetch and scan paths, so chaos runs replay "
       "bit-identically"),
    _k("DAFT_TORCH_MAX_RETRIES", "int", 3,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "bounded per-task retry budget"),
    _k("DAFT_TORCH_RETRY_BACKOFF", "float", 0.05,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "retry backoff base seconds (deterministic jitter on top)"),
    _k("DAFT_TORCH_RETRY_BACKOFF_CAP", "float", 2.0,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "retry backoff cap seconds"),
    _k("DAFT_TORCH_QUARANTINE_AFTER", "int", 3,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "consecutive failures that quarantine a worker"),
    _k("DAFT_TORCH_QUARANTINE_S", "float", 30.0,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "quarantine seconds (timed re-admission; placement never empties)"),
    _k("DAFT_TORCH_TASK_TIMEOUT", "float", 0.0,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "seconds before a hung task attempt is abandoned as retryable "
       "(`0` = off)"),
    _k("DAFT_TORCH_SPECULATIVE_MULTIPLIER", "float", 4.0,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "speculation trigger: this multiple of the median finished "
       "sibling's duration (`0` = off)"),
    _k("DAFT_TORCH_SPECULATIVE_MIN_S", "float", 0.5,
       "daft_tpu_torch/distributed/resilience.py", "resilience",
       "minimum task age before speculation is considered"),
    _k("DAFT_TORCH_WORKER_TIMEOUT", "float", 3600.0,
       "daft_tpu_torch/distributed/remote_worker.py", "resilience",
       "remote-worker RPC timeout seconds"),
    # ---------------------------------------------------- analysis
    _k("DAFT_TORCH_FUZZ_SEED", "int", 0, "daft_tpu_torch/analysis/plan_fuzzer.py",
           "analysis", 'base seed of the plan fuzzer (`python -m '
           'daft_tpu_torch.analysis --fuzz`)'),
    _k("DAFT_TORCH_FUZZ_COUNT", "int", 50, "daft_tpu_torch/analysis/plan_fuzzer.py",
           "analysis", 'seeds per plan-fuzzer run'),
    # ---------------------------------------------------- analysis
    _k("DAFT_TORCH_SANITIZE", "bool", False,
       "daft_tpu_torch/analysis/lock_sanitizer.py", "analysis",
       "`1`: the lock-order sanitizer wraps every lock, condition and "
       "queue the engine creates (armed in `daft_tpu_torch/__init__.py`, "
       "before any engine import) and records its acquisition-order graph, "
       "contention and sleeps under a lock"),
    _k("DAFT_TORCH_SANITIZE_RETRACE", "int", 0,
       "daft_tpu_torch/analysis/retrace_sanitizer.py", "analysis",
       "with `DAFT_TORCH_SANITIZE=1`, a positive value arms the retrace "
       "sanitizer: a query's repeat that allocates (new caching-allocator "
       "segments or pinned blocks) at a signature its first run warmed is "
       "a violation; where no query is marked, the value multiplies the "
       "budget of allocating entries per signature"),
    _k("DAFT_TORCH_SANITIZE_PLAN", "bool", False,
       "daft_tpu_torch/analysis/plan_sanitizer.py", "analysis",
       "`1`: the plan sanitizer checks each optimizer rule's schema "
       "contract, hash-exchange membership, sort order, row conservation "
       "and the grace join's bucket pairs while queries run"),
]

REGISTRY: Dict[str, Knob] = {k.name: k for k in _KNOBS}

#: README table groups, in registry order
GROUPS: List[str] = []
for _kn in _KNOBS:
    if _kn.group not in GROUPS:
        GROUPS.append(_kn.group)

#: accessor → the registered type it parses (``env_raw`` reads any type)
ACCESSOR_TYPES = {
    "env_int": "int", "env_opt_int": "int", "env_float": "float",
    "env_opt_float": "float", "env_bool": "bool", "env_bytes": "bytes",
    "env_str": "str",
}


class UnknownKnobError(KeyError):
    pass


def _checked(name: str, expect_type: Optional[str] = None) -> Knob:
    k = REGISTRY.get(name)
    if k is None:
        raise UnknownKnobError(
            f"{name} is not in the knob registry (daft_tpu_torch/knobs.py) "
            f"— register it before reading it")
    if expect_type is not None and k.type != expect_type:
        raise TypeError(
            f"{name} is registered as type {k.type!r} but was read as "
            f"{expect_type!r} — one knob, one parse")
    return k


def env_raw(name: str) -> Optional[str]:
    """The knob's value as set, or None when unset or empty."""
    _checked(name)
    v = os.environ.get(name)
    return None if v is None or v.strip() == "" else v.strip()


def env_str(name: str) -> str:
    k = _checked(name, "str")
    v = env_raw(name)
    if v is not None:
        return v
    return "" if k.default is None else str(k.default)


def env_int(name: str) -> int:
    _checked(name, "int")
    v = env_raw(name)
    return int(REGISTRY[name].default) if v is None else int(v)


def env_float(name: str) -> float:
    _checked(name, "float")
    v = env_raw(name)
    return float(REGISTRY[name].default) if v is None else float(v)


def env_opt_int(name: str) -> Optional[int]:
    _checked(name, "int")
    v = env_raw(name)
    return None if v is None else int(v)


def env_opt_float(name: str) -> Optional[float]:
    _checked(name, "float")
    v = env_raw(name)
    return None if v is None else float(v)


def env_bytes(name: str) -> int:
    """A byte count with an optional suffix (`16MiB`, `4GB`, `400KB`)."""
    from .execution.memory import parse_bytes
    k = _checked(name, "bytes")
    v = env_raw(name)
    return int(k.default) if v is None else parse_bytes(v)


def env_bool(name: str) -> bool:
    k = _checked(name, "bool")
    v = env_raw(name)
    if v is None:
        return bool(k.default)
    return v.lower() in ("1", "true", "on", "yes")


# ------------------------------------------------------------------ docs

_TABLE_HEADER = "| env var | type | default | effect |\n| --- | --- | --- | --- |"


def _default_cell(k: Knob) -> str:
    if k.default_str:
        return f"`{k.default_str}`"
    if k.default is None or k.default == "":
        return "unset"
    if k.type == "bool":
        return "`1`" if k.default else "`0`"
    return f"`{k.default}`"


def knob_table_markdown(group: str) -> str:
    """One generated markdown table for a registry group."""
    rows = [_TABLE_HEADER]
    for k in _KNOBS:
        if k.group != group:
            continue
        doc = k.doc.replace("|", "\\|")
        if k.config_field:
            doc += f" (mirrors `ExecutionConfig.{k.config_field}`)"
        rows.append(f"| `{k.name}` | {k.type} | {_default_cell(k)} | {doc} |")
    return "\n".join(rows)


def _marker(group: str, end: bool) -> str:
    word = "END" if end else "BEGIN"
    return f"<!-- torch-knob-table:{group} {word} -->"


def knob_block(group: str) -> str:
    """A full generated README block, markers included."""
    return (f"{_marker(group, False)}\n"
            f"<!-- generated by `python -m daft_tpu_torch.analysis "
            f"--knob-docs --write`; edit daft_tpu_torch/knobs.py, not this "
            f"table -->\n{knob_table_markdown(group)}\n{_marker(group, True)}")


def readme_drift(readme_text: str) -> List[str]:
    """Drift problems between the registry and the README's generated port
    knob tables (empty list = in sync)."""
    problems = []
    for group in GROUPS:
        begin, end = _marker(group, False), _marker(group, True)
        i, j = readme_text.find(begin), readme_text.find(end)
        if i < 0 or j < 0:
            problems.append(
                f"README is missing the generated port knob table for group "
                f"{group!r} (markers {begin} … {end})")
            continue
        if readme_text[i:j + len(end)] != knob_block(group):
            problems.append(
                f"README port knob table for group {group!r} is stale — "
                f"regenerate with `python -m daft_tpu_torch.analysis "
                f"--knob-docs --write`")
    return problems


def update_readme(readme_path: str, write: bool = True) -> bool:
    """Rewrite every generated port knob-table block of the README from the
    registry. True when the file changed (or would change)."""
    with open(readme_path, encoding="utf-8") as f:
        text = f.read()
    new = text
    for group in GROUPS:
        begin, end = _marker(group, False), _marker(group, True)
        i, j = new.find(begin), new.find(end)
        if i < 0 or j < 0:
            continue
        new = new[:i] + knob_block(group) + new[j + len(end):]
    changed = new != text
    if changed and write:
        with open(readme_path, "w", encoding="utf-8") as f:
            f.write(new)
    return changed
