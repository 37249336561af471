"""The port's environment knobs, all under the ``DAFT_TORCH_`` prefix.

Read at call time (never cached at import), so a test can set one with
``monkeypatch.setenv``. A knob whose default is None is unset unless the
environment names it (:func:`env_raw` returns None).
"""

from __future__ import annotations

import os
from typing import Optional

#: name → (default, help)
REGISTRY = {
    "DAFT_TORCH_DEVICE": (
        "cuda", "`cuda` (default), `cpu`, or `0` for the host tier only; "
        "an explicit `ExecutionConfig.device` wins"),
    "DAFT_TORCH_DEVICE_MIN_ROWS": (
        None, "unset (default): the cost model prices each per-operator "
        "dispatch (projection, predicate, argsort, agg outside a fused "
        "fragment); set: a batch of at least this many rows runs on the "
        "device and a smaller one on the host tier (`host_ops`), without "
        "pricing (`DAFT_TORCH_DEVICE_FORCE` trumps it), and a fused-agg "
        "morsel of fewer rows runs on the host (`host_morsels`) before "
        "any pricing"),
    "DAFT_TORCH_DEVICE_FORCE": (
        None, "`1`/`device`: every priced decision picks the device; "
        "`0`/`host`: the host; unset: the cost model decides"),
    "DAFT_TORCH_DEVICE_JOIN": (
        None, "`1`: every equi-join's index generation runs on the "
        "device; `0`: on the host; unset: when both sides hold at least "
        "8,192 rows together and `costmodel.join_wins` prices the device "
        "cheaper"),
    "DAFT_TORCH_KERNEL_GROUPBY": (
        "auto", "grouped-agg strategy: `auto` (dense, else the cost "
        "model's hash or sort), or force `dense`/`hash`/`sort`"),
    "DAFT_TORCH_KERNEL_HASH_NDV_FRAC": (
        0.5, "`auto` group-bys take sort when the footer NDV estimate "
        "exceeds this fraction of the dispatch's rows (near-unique keys)"),
    "DAFT_TORCH_KERNEL_HASH_LOAD": (
        0.5, "max hash-table load factor: the table holds `out_cap / load` "
        "slots (clamped to [0.05, 0.95])"),
    "DAFT_TORCH_KERNEL_MAX_TABLE": (
        1 << 20, "hash-agg table slot ceiling; larger group budgets take "
        "sort (joins have none: their tables live in device memory)"),
    "DAFT_TORCH_KERNEL_HASH_MAX_BITS": (
        128, "widest packed key set (bits, ≤128) the hash kernel accepts"),
    "DAFT_TORCH_KERNEL_JOIN": (
        "auto", "device equi-join strategy: `auto` (hash on a card, sort "
        "on CPU tensors), or force `hash` (build/probe kernels) / `sort` "
        "(torch sort join)"),
    "DAFT_TORCH_DEVICE_INFLIGHT": (
        "", "in-flight device slots of the fused-agg pipeline (0 = the "
        "synchronous path; at most 64); unset defers to "
        "`ExecutionConfig.device_inflight` (default 2)"),
    "DAFT_TORCH_DEVICE_CACHE_BYTES": (
        8 * 1024 ** 3, "byte budget of the device column cache (encoded "
        "scan columns kept on the card across queries, LRU); the "
        "residency registry of decoded planes gets 1/8 of it"),
    "DAFT_TORCH_CACHE_INVEST": (
        "1", "price a cacheable fused-agg upload as an investment the "
        "device column cache repays (bounded by `INVEST_MAX_RATIO`); `0`: "
        "every upload must beat the host outright"),
    "DAFT_TORCH_LINK_RTT_MS": (
        None, "host↔device round trip (ms): with `_UP_MBPS` / "
        "`_DOWN_MBPS`, skips the link measurement"),
    "DAFT_TORCH_LINK_UP_MBPS": (
        None, "host→device rate (MB/s) the cost model prices with"),
    "DAFT_TORCH_LINK_DOWN_MBPS": (
        None, "device→host rate (MB/s) the cost model prices with"),
    "DAFT_TORCH_LINK_CACHE": (
        "1", "reuse a measured link profile stored for this card and host "
        "(`0`: measure in every process)"),
    "DAFT_TORCH_LINK_CACHE_PATH": (
        None, "file of the stored link profile (default "
        "`daft_tpu_torch/_build/link_profile.json`)"),
    "DAFT_TORCH_DISPATCH_LOG": (
        None, "append one JSON line per cost-model decision to this file"),
    "DAFT_TORCH_CALIBRATION": (
        "0", "`1`: learn the cost model's device rates from real "
        "dispatches (EWMA) and price with them past the sample floor"),
    "DAFT_TORCH_CALIBRATION_DIR": (
        None, "directory of the learned profile, one file per card and "
        "host (unset: kept in memory only)"),
    "DAFT_TORCH_CALIBRATION_ALPHA": (
        0.2, "EWMA weight of one new observation (clamped to [1e-3, 1])"),
    "DAFT_TORCH_CALIBRATION_MIN_SAMPLES": (
        8, "observations before a learned value replaces its default"),
    "DAFT_TORCH_FUSION": (
        None, "fusion regions (`physical/fusion.py`): `auto` prices each "
        "region morsel (`costmodel.fusion_wins`), `1` admits every one, "
        "`0` plans none; unset defers to `ExecutionConfig.fusion` "
        "(default `auto`)"),
    "DAFT_TORCH_FUSION_MAX_OPS": (
        None, "most operators one fusion region absorbs (at least 2); "
        "unset defers to `ExecutionConfig.fusion_max_ops` (default 8)"),
    "DAFT_TORCH_AOT_WARMUP": (
        "0", "`1`: `warmup.maybe_warmup_session` builds the CUDA library "
        "and launches each kernel and strategy once per capacity class, "
        "and every fusion region program seen so far"),
    "DAFT_TORCH_LOCAL_EXECUTOR": (
        None, "`push` (the push pipeline, `execution/pipeline.py`) or "
        "`interp` (the pull interpreter); unset defers to "
        "`ExecutionConfig.local_executor` (default `push`)"),
    "DAFT_TORCH_MEMORY_LIMIT": (
        None, "host byte budget of the pipeline breakers (e.g. `4GB`, "
        "`512MiB`, `400KB`); past it they spill to Arrow IPC files; unset: "
        "a quarter of physical RAM; a malformed value is an error"),
    "DAFT_TORCH_SPILL_DIR": (
        None, "directory of the spill files (default: a fresh temporary "
        "directory)"),
    "DAFT_TORCH_SPILL_JOIN": (
        None, "`auto` (the cost model's `spill_plan` decision), `1` (force "
        "the grace hash join's partitioned pairs) or `0` (materialize "
        "both sides and re-fan them); unset defers to "
        "`ExecutionConfig.spill_join`"),
    "DAFT_TORCH_SPILL_AGG": (
        None, "`auto`, `1` (force the spilling partitioned-agg reducer) or "
        "`0` (decline it); unset defers to `ExecutionConfig.spill_agg`"),
    "DAFT_TORCH_SPILL_PARTITIONS": (
        None, "non-zero: the first-level radix fanout of a grace join or "
        "spilling reducer (0 or unset: planner evidence decides)"),
    "DAFT_TORCH_SPILL_MAX_DEPTH": (
        None, "rotated-radix recursion bound of an oversized bucket "
        "(default `ExecutionConfig.spill_max_depth`, 3)"),
    "DAFT_TORCH_SPILL_COMPRESSION": (
        None, "spill-file codec: `lz4` (default), `zstd` or `none`"),
    "DAFT_TORCH_SPILL_IO_PARALLELISM": (
        None, "concurrent spill writes and bucket reads (default 4, at "
        "most 8); `0`: serial writes under the store lock"),
    "DAFT_TORCH_GOVERNOR": (
        "1", "`0` turns the RSS governor off (it acts only under a memory "
        "limit)"),
    "DAFT_TORCH_GOVERNOR_HIGH": (
        None, "RSS fraction of the memory limit that enters the pressured "
        "state (default 0.85)"),
    "DAFT_TORCH_FUZZ_SEED": (
        0, "base seed of the plan fuzzer (`python -m "
        "daft_tpu_torch.analysis --fuzz`)"),
    "DAFT_TORCH_FUZZ_COUNT": (
        50, "seeds per plan-fuzzer run"),
    "DAFT_TORCH_IO_COALESCE_GAP": (
        None, "hole tolerance of byte-range coalescing (bytes, suffixes "
        "like `1MiB` accepted); unset defers to "
        "`ExecutionConfig.io_coalesce_gap` (1MiB)"),
    "DAFT_TORCH_IO_MIN_REQUEST": (
        None, "request floor: a coalesced range request under it absorbs "
        "its neighbour across a hole under it; unset defers to "
        "`ExecutionConfig.io_min_request` (8MiB)"),
    "DAFT_TORCH_IO_RANGE_PARALLELISM": (
        None, "concurrent range GETs per object; unset defers to "
        "`ExecutionConfig.io_range_parallelism` (8)"),
    "DAFT_TORCH_IO_PLANNED_READS": (
        None, "`0`: remote parquet reads take pyarrow's own ranged GETs "
        "per column chunk instead of the planned, coalesced ranges; unset "
        "defers to `ExecutionConfig.io_planned_reads` (on)"),
    "DAFT_TORCH_SCAN_PREFETCH": (
        None, "scan tasks the scan source resolves ahead of the one it "
        "drains (`0`: whole-task loads on the shared pool); unset defers "
        "to `ExecutionConfig.scan_prefetch` (2)"),
    "DAFT_TORCH_IO_STREAM_CHUNK": (
        None, "chunk of the streaming remote CSV/JSON reader; unset "
        "defers to `ExecutionConfig.io_stream_chunk` (8MiB)"),
    "DAFT_TORCH_IO_INFER_BYTES": (
        None, "head bytes read to infer a remote CSV/JSON schema (`0`: "
        "the whole object); unset defers to "
        "`ExecutionConfig.io_infer_bytes` (1MiB)"),
    "DAFT_TORCH_GOVERNOR_LOW": (
        None, "RSS fraction that leaves it again (default 0.70, clamped "
        "under the high mark)"),
}


def env_raw(name: str) -> Optional[str]:
    """The knob's value as set, or None when unset or empty."""
    if name not in REGISTRY:
        raise KeyError(name)
    v = os.environ.get(name)
    return None if v is None or v.strip() == "" else v.strip()


def env_str(name: str) -> str:
    v = env_raw(name)
    return str(REGISTRY[name][0]) if v is None else v


def env_int(name: str) -> int:
    return int(env_str(name))


def env_float(name: str) -> float:
    return float(env_str(name))


def env_opt_int(name: str) -> Optional[int]:
    v = env_raw(name)
    return None if v is None else int(v)


def env_opt_float(name: str) -> Optional[float]:
    v = env_raw(name)
    return None if v is None else float(v)


def env_bool(name: str) -> bool:
    return env_str(name).lower() in ("1", "true", "on", "yes")
