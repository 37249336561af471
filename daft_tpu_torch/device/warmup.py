"""Session warm-up: build the CUDA library and launch every kernel and
strategy once per capacity class before the first query needs them
(``DAFT_TORCH_AOT_WARMUP=1``).

The torch rewrite of ``daft_tpu/device/warmup.py``. What a cold first query
pays on the card is not XLA compilation but the ``nvcc`` build of
``csrc/*.cu`` (``cuda_build.library``, seconds) and each kernel's first
launch (module load, the caching allocator's first blocks). So the
warm-up builds the library once and makes one launch of each kernel and
torch strategy per capacity class, off the query path:

- :func:`warmup_kernels` — the packed argsort (1 and 2 keys), the sort,
  hash and dense grouped aggs, the global agg, the compaction, and the
  hash and sort joins, on zeroed planes of each class;
- :func:`warmup_fragments` — every fused-agg program compiled so far
  (``fragment.fused_programs()``), per strategy, at the first rung's group
  budget. Programs with dictionary-shaped inputs (string columns, string
  literals) or a column type without a zero plane are skipped and
  counted: their shapes are not knowable ahead of data.

- :func:`warmup_regions` — every fusion-region program compiled so far
  (``fragment.fused_region_programs()``) at each shape's first width
  rung; a join_agg program on the probe = build diagonal of its capacity
  grid (other pairs launch cold in their query).

A failure raises: a kernel that does not launch at warm-up would not
launch in a query either.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import knobs

#: the warm-up grid's capacities: morsel-sized batches below the bottom are
#: cheap to launch cold; the top is the fused fragment's file capacity
_DEFAULT_MAX_CAPACITY = 1 << 20
_DEFAULT_MIN_CAPACITY = 1 << 10

_session_lock = threading.Lock()
_session_done = False


def size_classes(max_capacity: int, min_capacity: int) -> List[int]:
    """The power-of-two capacities in ``[min_capacity, max_capacity]``
    (``column.bucket_capacity``'s ladder)."""
    from .column import bucket_capacity
    out = []
    c = bucket_capacity(min_capacity)
    while c <= max_capacity:
        out.append(c)
        c *= 2
    return out


def warmup_kernels(classes: List[int], device: torch.device
                   ) -> Dict[str, int]:
    """One launch of each kernel and strategy per capacity class →
    ``{"programs": n}``."""
    from . import hash_kernels as hk, join_kernels as jk, kernels as K
    programs = 0
    for cap in classes:
        k = torch.zeros(cap, dtype=torch.int64, device=device)
        k32 = torch.zeros(cap, dtype=torch.int32, device=device)
        v = torch.zeros(cap, dtype=torch.float64, device=device)
        b = torch.ones(cap, dtype=torch.bool, device=device)
        out_cap = min(128, cap)
        grid = [
            lambda: K.argsort_kernel((k,), (b,), b, (False,), (False,)),
            lambda: K.argsort_kernel((k, v), (b, b), b, (False,) * 2,
                                     (False,) * 2),
            lambda: K.grouped_agg_block_impl((k,), (b,), (v,), (b,), b,
                                             ("sum",), out_cap),
            lambda: hk.hash_grouped_agg_impl((k,), (b,), (v,), (b,), b,
                                             ("sum",), out_cap),
            lambda: K.grouped_agg_dense_impl((k32,), (b,), (v,), (b,), b,
                                             ("sum",), out_cap, (4,)),
            lambda: K.global_agg_impl((v,), (b,), b, ("sum",)),
            lambda: K.compaction_perm(b),
            lambda: jk.hash_join_impl(k, b, b, k, b, b, cap),
            lambda: K.join_fused_impl(k, b, b, k, b, b, cap),
        ]
        for fn in grid:
            fn()
            programs += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"programs": programs}


def _zero_batch(schema, names, n: int):
    """A RecordBatch of ``n`` zero rows of the named columns, or None when
    a column's type has no zero plane here (strings, decimals)."""
    import pyarrow as pa

    from ..recordbatch import RecordBatch
    cols = {}
    for nm in names:
        t = schema[nm].dtype.to_arrow()
        if pa.types.is_boolean(t):
            cols[nm] = pa.array(np.zeros(n, dtype=bool))
        elif pa.types.is_integer(t) or pa.types.is_floating(t):
            cols[nm] = pa.array(np.zeros(n, dtype=t.to_pandas_dtype()))
        elif pa.types.is_date32(t):
            cols[nm] = pa.array(np.zeros(n, dtype=np.int32)).cast(t)
        else:
            return None
    return RecordBatch.from_arrow_table(pa.table(cols))


def warmup_fragments(classes: List[int], device: torch.device,
                     progs: Optional[list] = None) -> Dict[str, int]:
    """One dispatch of every fused program seen so far per capacity class
    and strategy (sort, and hash for a grouped program whose key set
    packs) → program / skip counts."""
    from . import column as dcol, fragment
    progs = fragment.fused_programs() if progs is None else progs
    programs = skipped = 0
    for prog in progs:
        needs = prog.compiled.needs_cols
        if prog.compiled.scalar_specs or _zero_batch(
                prog.in_schema, needs, 1) is None:
            skipped += 1
            continue
        strategies = ["sort"]
        if prog.nk and not prog.hash_unfit \
                and fragment.hash_kernels.hash_pack_words(
                    prog.key_plane_dtypes()) is not None:
            strategies.append("hash")
        for cap in classes:
            with dcol.uncounted():
                dt = dcol.encode_batch(_zero_batch(prog.in_schema, needs,
                                                   cap), needs, device)
            dcol.use_on_current_stream(dt)
            arrays = {n: c.data for n, c in dt.columns.items()}
            valids = {n: c.validity for n, c in dt.columns.items()}
            for strategy in strategies:
                prog.run_planes(arrays, valids, dt.row_mask, (),
                                min(fragment._OUT_CAP0, cap), strategy)
                programs += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"programs": programs, "skipped": skipped}


def warmup_regions(classes: List[int], device: torch.device,
                   progs: Optional[list] = None) -> Dict[str, int]:
    """One dispatch of every fusion-region program seen so far per
    capacity class (reference ``warmup.py:120``): chain and topk at their
    first width rung, join_agg with a zeroed build side of the same
    capacity (W = the capacity, the first group bucket). Programs whose
    inputs are dictionary-shaped (string literals, string columns) are
    skipped and counted."""
    from . import column as dcol, fragment, kernels
    progs = fragment.fused_region_programs() if progs is None else progs
    programs = skipped = 0
    for prog in progs:
        is_join = isinstance(prog, fragment.FusedJoinAggProgram)
        if is_join:
            needs = prog.probe_cols()
            bneeds = list(dict.fromkeys([prog.rkey]
                                        + list(prog.build_needs)))
            specs = list(prog.c_post.scalar_specs) + list(
                prog.c_pred.scalar_specs if prog.c_pred is not None
                else ())
            zero_ok = _zero_batch(prog.src_schema, needs, 1) is not None \
                and _zero_batch(prog.build_schema, bneeds, 1) is not None
        else:
            needs = prog.compiled.needs_cols
            specs = prog.compiled.scalar_specs
            zero_ok = _zero_batch(prog.in_schema, needs, 1) is not None
        if specs or not zero_ok:
            skipped += 1
            continue
        for cap in classes:
            with dcol.uncounted():
                if is_join:
                    dt = dcol.encode_batch(_zero_batch(
                        prog.src_schema, needs, cap), needs, device)
                    bdt = dcol.encode_batch(_zero_batch(
                        prog.build_schema, bneeds, cap), bneeds, device)
                else:
                    dt = dcol.encode_batch(_zero_batch(
                        prog.in_schema, needs, cap), needs, device)
            dcol.use_on_current_stream(dt)
            arrays = {n: c.data for n, c in dt.columns.items()}
            valids = {n: c.validity for n, c in dt.columns.items()}
            if is_join:
                dcol.use_on_current_stream(bdt)
                k = bdt.columns[prog.rkey]
                build = fragment.RegionBuild(bdt, *kernels.join_sort_impl(
                    k.data, k.validity, bdt.row_mask))
                prog.run_planes(arrays, valids, dt.row_mask, (), build, (),
                                cap, min(fragment._OUT_CAP0, cap))
            else:
                prog.run_planes(arrays, valids, dt.row_mask, (),
                                fragment.region_start_w(prog, dt))
            programs += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"programs": programs, "skipped": skipped}


def warmup_session(max_capacity: int = _DEFAULT_MAX_CAPACITY,
                   min_capacity: int = _DEFAULT_MIN_CAPACITY,
                   kernels: bool = True, fragments: bool = True,
                   regions: bool = True,
                   device: Optional[torch.device] = None
                   ) -> Dict[str, object]:
    """The whole warm-up on ``device`` (default: this query's), over the
    size-class ladder → a stats dict."""
    from ..analysis import retrace_sanitizer
    from . import backend, cuda_build
    device = backend.resolve_device() if device is None else device
    if device is None:
        return {"device": None}
    with retrace_sanitizer.dispatch_scope(
            "warmup.aot", (max_capacity, min_capacity)):
        return _warmup(max_capacity, min_capacity, kernels, fragments,
                       regions, device)


def _warmup(max_capacity: int, min_capacity: int, kernels: bool,
            fragments: bool, regions: bool, device: torch.device
            ) -> Dict[str, object]:
    from . import cuda_build
    t0 = time.perf_counter()
    classes = size_classes(max_capacity, min_capacity)
    stats: Dict[str, object] = {"device": str(device),
                                "size_classes": classes}
    if device.type == "cuda":
        t = time.perf_counter()
        cuda_build.library()
        stats["library_s"] = time.perf_counter() - t
    if kernels:
        stats["kernels"] = warmup_kernels(classes, device)
    if fragments:
        stats["fragments"] = warmup_fragments(classes, device)
    if regions:
        stats["regions"] = warmup_regions(classes, device)
    stats["seconds"] = time.perf_counter() - t0
    return stats


def warmup_enabled() -> bool:
    return knobs.env_bool("DAFT_TORCH_AOT_WARMUP")


def maybe_warmup_session() -> Optional[Dict[str, object]]:
    """The knob-gated warm-up, at most once per process (the executor
    calls it before a query's first dispatch); None when it is off or has
    run."""
    global _session_done
    if not warmup_enabled() or _session_done:
        return None
    with _session_lock:
        if _session_done:
            return None
        stats = warmup_session()
        _session_done = True
        return stats
