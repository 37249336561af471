#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. the card's name and power limit, and its device-to-device copy
   bandwidth (the yardstick the kernel's bound is also given against);
   the cost model's link profile measured afresh on this machine (RTT,
   up and down rates through the port's pinned staging and copy stream;
   ``DAFT_TORCH_LINK_CACHE=0``: no stored profile from another machine)
   and every constant the model prices with, on one ``costmodel`` line;
2. build of the CUDA kernels from ``daft_tpu_torch/csrc`` (one ``nvcc``
   per source for sm_90a, all at once, linked into a shared library
   loaded with ctypes; its seconds and ``-Xptxas -v`` lines are
   printed);
3. kernel phase: the hash grouped-agg table build against its plain torch
   version on the card, at the main path's shape (C = 2^20 rows, ~751k
   live), over 1-word and 2-word keys, null keys, every agg state kind,
   int64/f32/f64/bool values with nulls and NaN, an overflow case, a
   table-full case, 4 groups (in a shared-memory and a global table),
   sorted keys, and one case on each side of the shared-memory rule;
4. join-kernel phase: the hash-join build and probe against their plain
   torch versions on the card (and the joined pairs against the torch
   sort join), at the shape of TPC-H Q3's lineitem join (C_r = 2^22 build
   rows, ~3.2M live; C_l = 2^18 probe rows), plus duplicate-heavy, NULL-
   key, overflow (total > cap), empty-side and int64-edge-key cases, one
   key holding every build row (2^20), keys clustered in runs that
   straddle warp, block and sort-chunk boundaries, and all-distinct keys
   over 2^22 build rows;
5. grouped-aggregation path: TPC-H SF1 generated from a seed into
   ``.cache/``, then Q1 (dense strategy), an int64-keyed group-by on
   ``l_suppkey`` (hash, 2-word keys), a date-keyed group-by on
   ``l_shipdate`` (hash, 1-word keys) and Q6 (keyless), through
   ``daft_tpu_torch.read_parquet`` on ``cuda`` (the pipelined path,
   window 2, the device column cache empty); every answer is held
   against pyarrow on the same files, and the port's counters must show
   the kernels ran, every query went through the pipeline and no morsel
   fell to the host tier;
5b. pipeline phase: the same four queries three ways, 2 runs each (a
   depth cut that makes room for the memory-bounded phase):
   window 0 (the synchronous path) and window 2 with the device column
   cache cleared before each run (cold walls, comparable with the warm
   walls of versions without the cache), then window 2 on a warm cache
   (cached walls); every answer equal to pyarrow's and across the ways;
   checks that Q1 had at least 2 slots in flight under window 2, every
   staging buffer is pinned, the warm runs copy no scan column to the
   card, slots acquired equal slots released, and the first dispatch of
   each hash-agg rung of the pipelined runs equals the plain build;
   ``pipeline`` lines with the walls and counters, and Q1 traced under
   ways 1 and 2 (the card's idle share, ``pipeline trace`` lines);
6. join path: TPC-H Q3 at SF1 (customer ⋈ orders ⋈ lineitem, then a
   group-by and a top 10) through the same entry points, one counted cold
   run and 2 warm repeats (one for the forced-broadcast variant); the
   answer is held against pyarrow (``pa.Table.join`` plus ``group_by``)
   and the counters must show every
   join on the device with the hash strategy (no host join), one build
   launch per device join and one probe launch per dispatch;
7. TPC-H 22 phase: all 22 queries as DataFrame code
   (``daft_tpu_torch/benchmarking/tpch_queries.py``) at the same SF1
   data, at the default knobs (the cost model decides host against card
   and hash against sort): per query a counted cold run (the device
   column cache cleared before it; no warm run: a depth cut that makes
   room for the memory-bounded phase), held to the port's host tier
   (``device="0"``) on the
   same files in the same process (keys, counts and strings exact,
   floats at relative 1e-9), then a counted dispatch pass with
   ``DAFT_TORCH_DEVICE_MIN_ROWS=4096`` (the per-operator paths at the
   row floor the port had before its cost model) held to the same
   answer; one line per query with the walls, the dispatch counters, the
   cost model's decision counts and the kernel launches of both counted
   runs (``--dispatch-log DIR`` also writes each cold run's decisions
   as JSON lines, one file per query). Q1 keeps its 8 dense dispatches;
   the fused morsels of a default run on the host are exactly those the
   cost model priced there (``fused_agg_upload`` decisions); in the
   dispatch pass (where the explicit floor also leaves the fused fragment
   unpriced, its rule before the cost model) no fused morsel falls to the
   host, Q3's group-by never takes the hash table and runs on the card
   with sort (at a 1-row floor when the pass keeps each of its partial
   aggregates, one per co-partitioned join pair, under 4,096 rows), and
   an argsort and a
   per-operator hash group-by are dispatched;
7b. TPC-H SQL phase: the same 22 queries as SQL text through
   ``daft_tpu_torch.sql`` (``daft_tpu_torch/benchmarking/tpch_sql.py``:
   the SQL frontend, subquery decorrelation and the join rules), per
   query one counted cold run (depth cut to make room for the pipeline
   phase: no warm run) at phase 7's dispatch setting, held to phase 7's
   answer (floats at relative 1e-6: the two forms write some
   expressions differently); one ``tpchsql`` line per query with the
   wall beside the DataFrame form's dispatch-pass wall, the counters,
   the join strategies and the cross joins left (must be 0); no fused
   morsel may fall to the host;
7c. TPC-DS phase: all 99 TPC-DS queries as SQL
   (``daft_tpu_torch/benchmarking/tpcds_sql.py``) over
   ``benchmarking/tpcds/datagen.py`` at scale 1.0 (500,000
   ``store_sales`` rows, into ``.cache/``), at the default knobs (the
   cost model and ``DAFT_TORCH_FUSION=auto`` decide): per query a counted
   cold run (the device column cache cleared), held to the port's host
   tier by the query's ``ORDER BY`` keys (``tpcds_sql.ORDER_KEYS``): the
   keys row for row, the rows inside each run of equal keys as a multiset
   (the push executor orders tied rows by their arrival), and, only where
   the host tier's answer without the ``LIMIT`` shows the cut splitting a
   run of equal keys, the last run as a multiset drawn from that whole
   run (floats at relative 1e-9; a rank over float keys may break a tie the host kept
   where the card summed the keys in another order, by less than the
   tie's size: ``order`` says which held); one ``tpcds`` line per query with the
   walls, counters, fusion-region counters and decisions;
7d. TPC-DS dispatch pass: the 15 window queries, the 8 queries whose
   plans hold join_agg fusion regions and TPC-H Q17 (SF1), with
   ``DAFT_TORCH_DEVICE_FORCE=1`` and ``DAFT_TORCH_FUSION=1``, held to the
   host tier as in 7c; one ``tpcds dispatch`` line per query (regions planned,
   join_agg dispatches, climbs of each ladder, declines by cause); a
   query whose planned region dispatched no time fails the phase; the
   device launches of one join_agg dispatch (``torch.profiler``);
7e. region phase: the chain and topk fusion regions over an in-memory
   table of 2^22 rows (int64, float64, a dictionary string column; 32
   partitions), with every region admitted, held to the same queries at
   ``DAFT_TORCH_FUSION=0``; walls (medians of 2 runs, a depth cut that
   makes room for the memory-bounded phase), dispatches and the launches
   of one dispatch;
7f. memory-bounded phase (the push engine, ``cuda``, the SF1 files):
   under ``DAFT_TORCH_MEMORY_LIMIT=64MiB`` TPC-H Q1, Q3, Q9, Q18, Q21 and
   a full ``ORDER BY l_orderkey, l_linenumber`` over lineitem (the
   external sort), each held to the same query unbounded in this process
   (floats at relative 1e-9, the rest exact); each spills bytes (Q1 takes
   the spilling reducer, whose 4 groups never outgrow it), and Q3, Q9 and
   Q21 join bucket pairs on the card, every join priced onto the card run
   there; Q3 with its lineitem join at ``strategy="sort_merge"`` equal to
   the hash plan (its bucket pairs launch the join kernels); Q5 and Q8 at
   ``enable_aqe=True`` equal to the default run with at least one
   re-plan; Q1 and Q3 under ``push`` and ``interp`` (``ooc`` lines with
   the walls, spill counters, launches and counters); the hash and join
   rungs of these runs that no earlier phase held go to phase 8 (``pass``
   ``spill``);
7g. pivot phase (the SF1 ``lineitem``, about 6M rows): group by
   ``l_returnflag``, pivot on ``l_shipmode`` (7 values) with
   ``sum(l_extendedprice)``, then unpivot the 7 columns back; the card's
   wide answer held to the host tier's (``device="0"``: keys exact, sums
   at relative 1e-9), the long one to a plain ``groupby(l_returnflag,
   l_shipmode)`` on the card; the same pivot with
   ``DAFT_TORCH_KERNEL_GROUPBY=hash`` must launch the hash-agg kernel and
   give the same answer; ``pivot`` lines with the walls, the
   pre-aggregation's strategy counters and its launches (its new rungs:
   ``pass`` ``pivot``);
7h. fuzz phase: the differential plan fuzzer
   (``daft_tpu_torch/analysis/plan_fuzzer.py``) in the modes optimized,
   device, bounded, fused and replanned on the card, each against the
   port's own unoptimized host run, at least 100 seeds per mode and
   about 30 s in all (a depth cut that makes room for the serving
   phase); any mismatch or error fails the script after its
   minimized repro is printed; the device mode must launch every kernel;
   one ``fuzz`` line per mode (seeds, mismatches, errors, launches, wall)
   and a ``fuzz new rungs`` line (its kernel rungs that no earlier phase
   held, ``pass`` ``fuzz``);
7i. remote scan phase: Q1, the ``l_suppkey`` group-by, Q6 and Q3 over
   the SF1 parquet served by a local HTTP object store (a stdlib
   ``ThreadingHTTPServer`` in a child process, so its request threads
   do not contend for the scan's interpreter lock,
   ``daft_tpu_torch/benchmarking/http_store.py``: HEAD and ranged GETs
   read by seeking in the files, 15 ms per request, the default of
   ``bench.py``'s scan bench), cold, two ways: the defaults (planned,
   coalesced range reads and the prefetch-pipelined scan, window 2) and
   ``DAFT_TORCH_IO_PLANNED_READS=0`` with ``DAFT_TORCH_SCAN_PREFETCH=0``,
   3 rounds with the ways' order turned each round; each answer held to
   pyarrow over the local files as on the main path; one ``remote`` line
   per query and way (the median wall and every wall, the first run's
   server GETs, scan counters, ``scan_task_us`` against
   ``scan_span_us`` and kernel launches); the phase fails if the planned way falls back to
   the naive read, the group-by launches no hash-agg build or Q3 no join
   build and probe; then Q1's answer written with ``write_parquet`` and
   ``write_csv`` and read back (equal), and three columns of one
   lineitem file written hive-partitioned by ``l_returnflag`` and read
   back with ``hive_partitioning=True`` (per-flag counts equal the
   source's); its new rungs go to phase 8 (``pass`` ``remote``);
7j. observability phase: Q1, the ``l_suppkey`` group-by and Q3, cold,
   through ``explain(analyze=True)`` with ``DAFT_TORCH_TRACE=1``, a trace
   directory and ``DAFT_TORCH_PROFILE_DIR`` (a torch.profiler capture per
   query): answers held to pyarrow, the analyzed root's rows equal to the
   answer's, each exported Chrome trace valid with no orphan span, one
   ``device:grouped_agg`` / ``device:join`` span per dispatch of the
   query's ``device kernels`` block, the group-by's hash dispatches equal
   to its hash-agg launches, Q3's 16 join builds and 16 probes, and in
   the profiler's trace one range per call of each hand-written kernel's
   wrapper, as many as it counted launches, each call's first kernel
   there by name or as a launch whose kernel record the profiler dropped
   (counted in the ``obs`` line; at least one by name); Q1 and the
   group-by at once on two threads, each ``device kernels`` block equal
   to its solo run's (``obs concurrent``); the dashboard launched on
   localhost and its ``/metrics`` parsed strictly, its kernel dispatch
   counters at least this phase's (``obs metrics``); tracing's overhead
   on Q1 (warm cache) and Q3, off against on, 3 interleaved pairs (a
   depth cut that makes room for the serving phase)
   (``obs overhead``: medians and ranges, not gated); one ``lanes`` line
   for each of TPC-H Q2, Q3, Q4, Q5, Q8, Q9, Q17 and Q20, cold and traced
   (span time summed per lane, the five span names and the five
   operators with the most time); its new rungs go to phase 8 (``pass``
   ``obs``);
7k. sanitizers armed: a child process (the lock patch must come before
   the port's imports) with ``DAFT_TORCH_SANITIZE=1``,
   ``DAFT_TORCH_SANITIZE_PLAN=1`` and ``DAFT_TORCH_SANITIZE_RETRACE=1``
   runs Q1, the ``l_suppkey`` group-by, Q3 and Q9 twice each at the
   default knobs (the second run on the warm device column cache: a
   steady signature must allocate no new device memory), then Q3 under
   ``DAFT_TORCH_MEMORY_LIMIT=64MiB`` (grace pairs, spill-store locks);
   every answer equal to the unarmed phases' (pyarrow for Q1 and the
   group-by, phase 7's for Q3 and Q9), 0 lock-order cycles, 0 plan-
   contract violations, 0 retrace-budget violations, and the three
   kernels launched under their declared dispatch sites (none unscoped);
   ``sanitize`` lines: locks tracked, edges, contended acquisitions,
   sleeps under a lock, plan checks by kind, per site its signatures,
   segments and pinned blocks allocated in first and repeat runs and its
   kernel launches, and per query the armed walls beside the unarmed
   ones (a cost, no target); its new rungs go to phase 8 (``pass``
   ``sanitize``);
7l. distributed and mesh (``daft_tpu_torch/parallel/``,
   ``distributed/``, ``runners/distributed_runner.py``), SF1: (a) the mesh
   of 4 shards on the card (``DAFT_TORCH_MESH_DEVICES=4``,
   ``DAFT_TORCH_MESH_MIN_ROWS=0``): Q1 and the ``l_suppkey`` group-by plan
   ``DeviceExchangeAgg`` and equal pyarrow, their partials crossing the
   mesh, the group-by's partial fragment launching the hash-agg build;
   lineitem and orders each repartitioned 4 ways on the order key over
   the mesh (at least 2 mesh repartitions) then joined, the join kernels
   launching, equal to the host tier; a range-partitioned sort of the 6M
   ``l_extendedprice`` values over the mesh, globally ordered; a broadcast
   join (``l_suppkey`` sharded, a fifth of the suppliers replicated) with
   the host's pairs; a window over a mesh repartition equal to the host
   tier; then Q1 and the group-by with ``MESH_MIN_ROWS`` unset, the cost
   model's ``mesh_exchange`` decisions and the measured mesh rate and
   dispatch printed (no target); (b) ``DAFT_TORCH_RUNNER=distributed``
   with 4 in-process workers: Q1, the group-by, Q3 and Q9 cold, held to
   pyarrow (Q1, group-by, Q3) and to phase 7's answer (Q9), the group-by
   launching hash-agg builds, Q3 and Q9 join builds and probes with no
   join on the host and no device-cache eviction; stages, tasks, shuffle
   bytes written and fetched and the walls beside phase 7's; (c) Q3
   through two remote worker processes (``python -m
   daft_tpu_torch.distributed.remote_worker``), equal to (b)'s, the
   transport named (Flight or HTTP), each child's device ``cuda`` and its
   kernel launches from its ``/status``; (d) Q3 through (b)'s runner under
   ``DAFT_TORCH_FAULT_SPEC=task:0.05,fetch:0.02`` (seed 5, serialized,
   8 retries a task):
   the answer unchanged, recovery counters above 0, the same fault
   events twice; (e) the plan fuzzer's ``combined`` mode, 100 seeds, 0
   mismatches. ``dist`` lines; its new rungs go to phase 8 (``pass``
   ``dist``);
7m. serving (``daft_tpu_torch/serving/``, ``logical/fingerprint.py``),
   SF1, a ``QueryScheduler`` of 4 worker slots on ``cuda``: (a) 4
   closed-loop clients in 3 sessions for 30 s, each rotating over Q1, the
   ``l_suppkey`` group-by, Q6 at one of 4 seeded (year, discount) pairs,
   Q3 and a point lookup (``l_orderkey == k``, 4 columns, ``limit 10``)
   at one of 8 seeded keys, every cache on; (b) the same clients for 2
   rotations each with the result cache off (plan-cache hits, every
   query run on the card); (c) (b)'s submissions through one worker (the
   serial-equivalent wall); (d) a running Q3 cancelled once its first
   join build launched, then Q3 again; (e) the clients of (b) for one
   rotation at ``DAFT_TORCH_DEVICE_MIN_ROWS=1``, so the per-operator
   projection, predicate, argsort and agg dispatch from concurrent
   queries (each must dispatch). Every answer held (Q1, the
   group-by and Q6 to pyarrow as on the main path, Q3 to phase 6's, a
   lookup's rows to pyarrow's as a multiset); 0 failed queries and 0
   rejections, 0 admitted bytes outstanding after each drain, (a)'s plan
   and result caches hit at least once, the cancelled handle
   ``cancelled`` with its admission returned, the three kernels
   launched under the scheduler, no host join and no host morsel where
   phase 7's runs of these queries had none, and the device memory left
   after the schedulers shut down within the column cache's and the
   residency registry's budgets. ``serve`` lines per run (QPS, p50/p99
   latency, queue wait, cold against repeat per query, the scheduler's
   counters, launches), ``serve cancel``, ``serve memory`` and ``serve
   summary`` (cache hit rates, structure hits, the projection compile
   cache, (b)'s wall over (c)'s); its new rungs go to phase 8 (``pass``
   ``serve``);
8. the hash build against its plain version at the inputs of every
   distinct hash rung of the main path and of the TPC-H 22 phase's
   dispatch pass
   (query, T, key words), and of every rung of the SQL phase, the TPC-DS
   phase and its dispatch pass and the memory-bounded phase whose shape
   no earlier phase held; the
   join kernels at Q3's lineitem join and at every distinct join rung of
   the TPC-H 22 phase (query, C_r, T, C_l, cap) of that pass and every
   SQL-phase, TPC-DS and memory-bounded rung of a shape no earlier phase
   held, each checked as in the join-kernel phase, then timed (rows name
   their ``pass``: ``tpcds`` or ``tpcds_dispatch`` for the TPC-DS ones,
   ``spill`` for the memory-bounded ones, ``pivot``, ``fuzz``,
   ``remote``, ``obs``, ``sanitize``, ``dist`` and ``serve`` for the last
   seven phases);
   every entry point
   ``analysis/dispatch_registry.py`` declares must have launched and been
   held against its plain twin in the run;
9. a ``{"kernels": [...]}`` line with each kernel's launches, times and
   bound (one row per hash rung and per join rung; Q3's join rows also
   with their device activities and host time per call), the script's
   total wall, then the card line and the final ``{"ok": true, ...}``
   line.

Join kernels compare exactly (integer outputs): the build as a map from
key to its rows in order (the slot layout is the kernel's own), the probe
and the joined pairs element for element.

Float tolerances: on the card, atomics sum in an order that changes from run
to run, so a float sum is held to |got - exact| <= 2 * n * eps * sum(|x|)
per group (n rows, eps of the sum's type, exact = f64 sum of the same
values), the worst case of any summation order. Query answers are held to
pyarrow at relative 1e-9 (sums, means), 1e-6 for stddev (the reference's
one-pass sum-of-squares formula loses digits to cancellation); keys, counts,
min/max and first values must match exactly.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# the port's own yardstick: the ledger's roofline reads the same rate
from daft_tpu_torch.device.mfu import HBM_BPS as HBM_BYTES_PER_S

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_C = 1 << 20
MAIN_LIVE = 751_000


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median per-call device time of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> float:
    """Host time of one call of ``fn``: ``reps`` calls enqueued back to
    back (the card runs behind), per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def device_activities(fn, n: int = 3):
    """Device activities (kernels, memsets, copies) of one call of ``fn``
    from ``torch.profiler``: name -> [count, ms] per call (mean of
    ``n``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: [e.count / n, e.self_device_time_total / n / 1e3]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")}


def copy_bandwidth() -> float:
    """Device-to-device copy rate, bytes/s (read + write counted)."""
    import torch
    n = 1 << 28  # 1 GiB of float32
    src = torch.empty(n, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    return 2 * n * 4 / (ms / 1e3)


# ------------------------------------------------------------ kernel phase

def rows_until_full(words, live, T: int) -> int:
    """Live rows up to the one whose key is the T-th distinct key in row
    order (all live rows when there are fewer than T keys): what a build
    that stops once its table is full must read."""
    import torch
    rows = torch.nonzero(live).flatten()
    key = words[0][rows] if len(words) == 1 \
        else torch.stack([w[rows] for w in words], 1)
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if rows.numel() else 0
    if n < T:
        return int(rows.numel())
    first = torch.full((n,), live.shape[0], dtype=torch.int64,
                       device=live.device).scatter_reduce(0, inv, rows,
                                                          "amin")
    return int((rows <= torch.sort(first).values[T - 1]).sum())


def build_bytes(words, live, vals, contribs, specs, T: int) -> int:
    """Bytes the table build must move. Read once: the live mask (C
    bytes), and for each live row it aggregates its key words and each
    value and contrib plane the distinct planes read (by buffer: the
    compiler hands one tensor to every agg over one column; a count or
    `first` reads no value). Written once: per slot the key words, `occ`,
    `frow` and each distinct plane (specs that compute the same plane
    count once, as the kernel builds it once), and the count. A table
    that fills aggregates only the rows up to the one that claims its
    last slot (:func:`rows_until_full`)."""
    from daft_tpu_torch.device import hash_kernels as hk
    distinct, _ = hk.plane_aliases(specs, vals, contribs)
    uniq = [specs[i] for i in distinct]
    read = {}
    for vi, _, kind, _ in uniq:
        read[contribs[vi].data_ptr()] = 1
        if kind not in ("cnt", "first"):
            read[vals[vi].data_ptr()] = vals[vi].element_size()
    n_rows = rows_until_full(words, live, T)
    inp = live.shape[0] + n_rows * (8 * len(words) + sum(read.values()))
    out = T * (8 * len(words) + 1 + 8 + sum(
        hk._plane_dtype(kind, dt).itemsize for _, _, kind, dt in uniq)) + 8
    return inp + out


def make_case(rng, C: int, live_n: int, key_kind: str, ndv: int,
              ops, val_kinds, null_frac: float = 0.05,
              sorted_keys: bool = False, one_column: bool = False):
    """Seeded inputs for one build case, as numpy planes. ``sorted_keys``
    sorts the keys (long runs of one key, as a clustered column gives);
    ``one_column`` hands every agg the same value and validity planes, as
    the compiler does for aggs over one column."""
    live = np.zeros(C, dtype=np.bool_)
    live[:live_n] = True
    if key_kind == "int64":
        keys = rng.integers(1, ndv + 1, C).astype(np.int64) * 7919 - 10**12
    else:  # int32 / date days
        keys = (rng.integers(0, ndv, C) + 8036).astype(np.int32)
    if sorted_keys:
        keys = np.sort(keys)
    kvalid = rng.random(C) >= null_frac
    vals, vvalids = [], []
    for vk in val_kinds[:1] if one_column else val_kinds:
        if vk == "f64":
            v = rng.normal(100.0, 50.0, C)
            v[rng.random(C) < 0.001] = np.nan
            v[rng.random(C) < 0.001] = -0.0
        elif vk == "f32":
            v = rng.normal(10.0, 5.0, C).astype(np.float32)
            v[rng.random(C) < 0.001] = np.nan
        elif vk == "i64":
            v = rng.integers(-10**12, 10**12, C).astype(np.int64)
        else:  # bool
            v = rng.random(C) < 0.5
        vals.append(v)
        vvalids.append(rng.random(C) >= null_frac)
    if one_column:
        vals, vvalids = vals * len(ops), vvalids * len(ops)
    return dict(keys=keys, kvalid=kvalid, live=live, vals=vals,
                vvalids=vvalids, ops=tuple(ops))


def case_tensors(case, device):
    """The case on ``device``: one tensor per distinct numpy plane, so
    aggs over one column share their value and contrib tensors."""
    import torch
    from daft_tpu_torch.device import hash_kernels as hk
    made = {}

    def t(a):
        if id(a) not in made:
            made[id(a)] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return made[id(a)]
    live = t(case["live"])
    keys = (t(case["keys"]),)
    kvalid = (t(case["kvalid"]),)
    words = hk.key_words(keys, kvalid, live)
    vals = [t(v) for v in case["vals"]]
    masked = {}
    for m in case["vvalids"]:
        if id(m) not in masked:
            masked[id(m)] = t(m) & live
    contribs = [masked[id(m)] for m in case["vvalids"]]
    specs = hk.agg_state_specs(case["ops"], [v.dtype for v in vals])
    return words, live, vals, contribs, specs


def _by_key(out):
    """{key words tuple: slot} over occupied slots of a build result."""
    tk, occ = out[0], out[1].cpu().numpy()
    w = [x.cpu().numpy() for x in tk]
    slots = np.nonzero(occ)[0]
    return {tuple(int(x[s]) for x in w): int(s) for s in slots}


def compare_builds(got, ref, specs, words, live, vals, contribs, T: int):
    """Kernel result vs plain result, as sets keyed by the key words.
    Returns the max abs error over the float sum planes."""
    import torch
    from daft_tpu_torch.device import hash_kernels as hk
    g_got, g_ref = int(got[4]), int(ref[4])
    if g_got != g_ref:
        raise AssertionError(f"group count {g_got} != plain {g_ref}")
    if g_ref >= T:
        # table full: which keys won slots depends on claim order; the
        # overflow signal (the count) is the contract
        return 0.0
    kg, kr = _by_key(got), _by_key(ref)
    if set(kg) != set(kr):
        raise AssertionError("occupied key sets differ")
    keys = list(kr)
    sg = torch.tensor([kg[k] for k in keys], device=live.device)
    sr = torch.tensor([kr[k] for k in keys], device=live.device)
    if not torch.equal(got[2][sg], ref[2][sr]):
        raise AssertionError("frow differs")
    f64 = torch.float64
    max_err = 0.0
    for i, (vi, op, kind, dt) in enumerate(specs):
        a, b = got[3][i][sg], ref[3][i][sr]
        if kind in ("sum", "sumsq") and dt.is_floating_point:
            # exact: the f64 sum of the values this plane accumulates (in
            # the plane's own type), and the sum of their magnitudes
            xs = vals[vi].to(dt)
            x = (xs * xs if kind == "sumsq" else xs).to(f64)
            ex = hk.hash_agg_build_plain(
                words, live, [x, x.abs()], [contribs[vi]] * 2,
                [(0, "sum", "sum", f64), (1, "sum", "sum", f64),
                 (0, "count", "cnt", torch.int32)], T)
            exact, absum, n = (p[sr] for p in ex[3])
            err = (a.to(f64) - exact).abs()
            bound = 2 * n.to(f64) * torch.finfo(dt).eps * absum
            fin = ~torch.isnan(exact)
            if not torch.equal(torch.isnan(a), ~fin) \
                    or bool((err[fin] > bound[fin]).any()):
                raise AssertionError(f"spec {i} ({op}/{kind}) float sum "
                                     "outside 2*n*eps*sum|x|")
            if bool(fin.any()):
                max_err = max(max_err, float(err[fin].max()))
        elif dt.is_floating_point:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            same &= (torch.signbit(a) == torch.signbit(b)) | torch.isnan(a)
            if not bool(same.all()):
                raise AssertionError(f"spec {i} ({op}/{kind}) differs")
        elif not torch.equal(a, b):
            raise AssertionError(f"spec {i} ({op}/{kind}) differs")
    return max_err


def build_path(words, vals, contribs, specs, T: int) -> str:
    """Which path the build takes for these inputs: "shared" (block-local
    pre-aggregation) or "global" (:func:`hash_kernels.uses_shared_table`
    over the distinct planes, on this card)."""
    import torch
    from daft_tpu_torch.device import hash_kernels as hk
    distinct, _ = hk.plane_aliases(specs, vals, contribs)
    dts = [hk._plane_dtype(specs[i][2], specs[i][3]) for i in distinct]
    return "shared" if hk.uses_shared_table(
        T, len(words), dts, words[0].shape[0],
        hk.device_info(torch.cuda.current_device())) else "global"


def kernel_phase(rng, bw: float, C: int, live_n: int):
    """Kernel vs plain on the card over the coverage cases."""
    from daft_tpu_torch.device import hash_kernels as hk
    all_ops = ("count", "sum", "mean", "var", "stddev", "min", "max",
               "any_value", "bool_and", "bool_or")
    kinds = ("f64", "f32", "i64", "f64", "f32", "f64", "f32", "i64",
             "bool", "bool")
    extra_ops = ("min", "max", "any_value", "sum", "min", "max")
    extra_kinds = ("i64", "i64", "f64", "bool", "bool", "f32")
    rule_ops = ("sum", "min", "max", "any_value")
    big = 1 << 21
    # (name, key kind, ndv, ops, value kinds, T, sorted keys, one column,
    #  expected path or None, rows)
    cases = [
        ("1word_int32_nullkeys", "int32", 2500, all_ops, kinds, 4096,
         False, False, None, C),
        ("2word_int64_nullkeys", "int64", 10_000, all_ops, kinds, 32768,
         False, False, None, C),
        ("1word_extra_kinds", "int32", 500, extra_ops, extra_kinds, 1024,
         False, False, "shared", C),
        ("overflow_ndv_gt_out_cap", "int64", 5000, ("sum", "count"),
         ("f64", "i64"), 8192, False, False, None, C),
        ("table_full", "int32", 10_000, ("sum", "max"), ("f64", "f32"),
         4096, False, False, None, C),
        # a T = 256 table filled by 10,000 keys in a block's shared memory
        ("table_full_shared", "int32", 10_000, ("sum", "max", "count"),
         ("f64", "f32", "i64"), 256, False, False, "shared", C),
        # 4 groups (and the null key) over 750k rows: every row of a warp
        # shares a few slots, in a shared-memory and a global table
        ("few_groups", "int32", 4, all_ops, kinds, 128, False, False,
         "shared", C),
        ("few_groups_global_table", "int64", 4, all_ops, kinds, 1 << 16,
         False, False, "global", C),
        # a clustered key column: runs of ~300 rows of one key
        ("sorted_keys", "int32", 2500, all_ops, kinds, 8192, True, False,
         "global", C),
        # one f64 column, 1-word keys, T = 2048 over 2^21 rows: count + sum
        # + min + max + first is 36 B a slot, 56 B with the key, first row
        # and state (114,688 B: two blocks fit the H100's 233,472 B SM);
        # `var` adds a sumsq plane (64 B a slot, 131,072 B: one block)
        ("rule_shared_side", "int32", 1000, rule_ops, ("f64",) * 4, 2048,
         False, True, "shared", big),
        ("rule_global_side", "int32", 1000, rule_ops + ("var",),
         ("f64",) * 5, 2048, False, True, "global", big),
    ]
    out = []
    for name, kk, ndv, ops, vk, T, srt, one, want, rows in cases:
        n_live = live_n * (rows // C)
        case = make_case(rng, rows, n_live, kk, ndv, ops, vk,
                         sorted_keys=srt, one_column=one)
        words, live, vals, contribs, specs = case_tensors(case, "cuda")
        path = build_path(words, vals, contribs, specs, T)
        if want is not None and path != want:
            raise AssertionError(f"{name}: build path {path}, not {want}")
        got = hk.hash_agg_build(words, live, vals, contribs, specs, T)
        ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs, T)
        err = compare_builds(got, ref, specs, words, live, vals, contribs, T)
        g = int(got[4])
        if name.startswith("table_full") and g != T:
            raise AssertionError(f"{name}: count {g} != T {T}")
        if name == "overflow_ndv_gt_out_cap" and not (2048 < g < T):
            raise AssertionError(f"overflow: count {g} not in (2048, {T})")
        ms = cuda_ms(lambda: hk.hash_agg_build(
            words, live, vals, contribs, specs, T))
        plain_ms = cuda_ms(lambda: hk.hash_agg_build_plain(
            words, live, vals, contribs, specs, T), reps=10, warm=1)
        nbytes = build_bytes(words, live, vals, contribs, specs, T)
        rec = dict(case=name, C=rows, live=n_live, T=T, words=len(words),
                   groups=g, specs=len(specs),
                   planes=len(hk.plane_aliases(specs, vals, contribs)[0]),
                   path=path, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_measured_bw_ms=nbytes / bw * 1e3, library_ms=None)
        log("kernel case " + json.dumps(rec))
        out.append(rec)
    return out


# ------------------------------------------------------- join-kernel phase

JOIN_C_R, JOIN_LIVE_R, JOIN_C_L = 1 << 22, 3_200_000, 1 << 18
I64_MIN = -(1 << 63)


def join_build_bytes(live, T: int) -> int:
    """Bytes the join build must move: the live mask (C bytes) and each
    live row's key (8 B) read once; the table's key (T+1 slots, 8 B),
    offset (T+2, 4 B) and row (C, 4 B) planes written once."""
    C = live.shape[0]
    return C + 8 * int(live.sum()) + 8 * (T + 1) + 4 * (T + 2) + 4 * C


def join_probe_bytes(live, packed, cap: int) -> int:
    """Bytes the probe must move: the live mask (C bytes); per live row
    its key, its slot's key and the slot's two offsets (24 B); per
    emitted pair the right row id it reads (4 B); written once: the
    per-row counts (4 B) and the pairs (8 B each). The packed matrix's
    slots past the total are unspecified, so they are not charged."""
    C = live.shape[0]
    n_out = min(int(packed[2, :C].sum()), cap)
    return C + 24 * int(live.sum()) + 4 * n_out + 4 * C + 8 * n_out


def join_cases(rng, C_r: int, live_r: int, C_l: int):
    """Seeded join-kernel cases (numpy planes; ``live`` already folds
    validity and padding in): the first has Q3's lineitem-join shape,
    the rest cover duplicate-heavy keys (segments long enough for the
    shared- and global-memory segment sorts), NULL keys, overflow, empty
    sides and keys at the int64 edges (INT64_MIN is the table's free-slot
    marker)."""
    def pad(a, C, fill=0):
        out = np.full(C, fill, dtype=a.dtype)
        out[:len(a)] = a
        return out

    cases = []
    # lineitem-like build: 1-7 rows per order key, in key order
    n_orders = live_r // 4
    r = np.repeat(np.arange(n_orders, dtype=np.int64) * 4 + 1,
                  rng.integers(1, 8, n_orders))[:live_r]
    n_l = C_l * 9 // 16
    l_keys = rng.permutation(2 * n_orders)[:n_l].astype(np.int64) * 4 + 1
    cases.append(dict(
        name="q3_lineitem_join_shape", r_code=pad(r, C_r),
        r_live=np.arange(C_r) < len(r), l_code=pad(l_keys, C_l),
        l_live=np.arange(C_l) < n_l, cap=C_r))
    # duplicate-heavy: 16 keys with ~2.5% of the rows each, 256 with ~0.1%,
    # the rest spread thin; build rows in random order
    heavy = rng.integers(0, 16, C_r * 4 // 10)
    medium = rng.integers(16, 272, C_r * 3 // 10)
    thin = rng.integers(272, 272 + C_r, C_r - len(heavy) - len(medium))
    r = rng.permutation(np.concatenate([heavy, medium, thin])) \
        .astype(np.int64)
    n_probe = max(C_l // 256, 64)
    cases.append(dict(
        name="duplicate_heavy", r_code=r, r_live=np.ones(C_r, bool),
        l_code=rng.integers(0, 300, n_probe).astype(np.int64),
        l_live=np.ones(n_probe, bool), cap=C_r * 4))
    # NULL keys on both sides (20%), foreign-key shaped
    cases.append(dict(
        name="null_keys", r_code=rng.permutation(C_r).astype(np.int64),
        r_live=rng.random(C_r) >= 0.2,
        l_code=rng.integers(0, 2 * C_r, C_l).astype(np.int64),
        l_live=rng.random(C_l) >= 0.2, cap=max(C_r, C_l)))
    # overflow: ~64 build rows per key, cap a third of the total
    c_o = C_r // 64
    cases.append(dict(
        name="overflow_total_gt_cap",
        r_code=rng.integers(0, c_o // 64, c_o).astype(np.int64),
        r_live=np.ones(c_o, bool),
        l_code=rng.integers(0, c_o // 64, c_o // 4).astype(np.int64),
        l_live=np.ones(c_o // 4, bool), cap=c_o // 4 * 64 // 3))
    small = C_l // 16
    cases.append(dict(
        name="empty_build", r_code=rng.integers(0, 99, small).astype(
            np.int64), r_live=np.zeros(small, bool),
        l_code=rng.integers(0, 99, small).astype(np.int64),
        l_live=np.ones(small, bool), cap=small))
    cases.append(dict(
        name="empty_probe", r_code=rng.integers(0, 99, small).astype(
            np.int64), r_live=np.ones(small, bool),
        l_code=rng.integers(0, 99, small).astype(np.int64),
        l_live=np.zeros(small, bool), cap=small))
    pool = np.array([I64_MIN, I64_MIN + 1, -1, 0, 1, (1 << 63) - 2,
                     (1 << 63) - 1], dtype=np.int64)
    c_e = C_l // 4
    cases.append(dict(
        name="int64_edge_keys", r_code=pool[rng.integers(0, 7, c_e)],
        r_live=rng.random(c_e) >= 0.1, l_code=pool[rng.integers(0, 7, 64)],
        l_live=np.ones(64, bool), cap=c_e * 16))
    cases.extend(join_cases_skewed(rng, C_r, live_r))
    return cases


#: run lengths of the clustered case: inside a warp, across warps (33, 63,
#: 257), across 256-thread blocks and across 4096-row sort chunks
CLUSTER_RUNS = np.array([1, 2, 5, 7, 31, 32, 33, 63, 257, 1000, 5000, 9000])
CLUSTER_P = np.array([20, 15, 15, 15, 10, 5, 5, 5, 4, 3, 2, 1]) / 100


def join_cases_skewed(rng, C_r: int, live_r: int):
    """The cases that skew the build: one key holding every build row (a
    quarter of ``C_r``, one segment of many sort chunks), keys clustered
    in runs whose lengths and starts straddle warp, block and chunk
    boundaries (build rows in key order, as lineitem's are), and all
    distinct keys over every row of ``C_r`` (one claim per row)."""
    cases = []
    c_1 = C_r // 4
    l_1 = np.where(np.arange(64) % 16 == 0, 7, rng.integers(8, 99, 64))
    cases.append(dict(
        name="one_key_all_rows", r_code=np.full(c_1, 7, dtype=np.int64),
        r_live=np.ones(c_1, bool), l_code=l_1.astype(np.int64),
        l_live=np.ones(64, bool), cap=4 * c_1 - 3))
    runs = rng.choice(CLUSTER_RUNS, live_r // 8, p=CLUSTER_P)
    r = np.repeat(np.arange(len(runs), dtype=np.int64) * 3 + 5, runs)
    r = r[rng.integers(0, 40):][:live_r]  # the first run starts anywhere
    n_l = max(C_r // 256, 64)
    cases.append(dict(
        name="clustered_runs", r_code=np.pad(r, (0, C_r - len(r))),
        r_live=np.arange(C_r) < len(r),
        l_code=(rng.integers(0, 2 * (r[-1] // 3), n_l) * 3 + 5)
        .astype(np.int64), l_live=rng.random(n_l) >= 0.1, cap=C_r))
    cases.append(dict(
        name="all_distinct", r_code=rng.permutation(C_r).astype(np.int64),
        r_live=np.ones(C_r, bool),
        l_code=rng.integers(0, 2 * C_r, C_r // 16).astype(np.int64),
        l_live=np.ones(C_r // 16, bool), cap=C_r // 16))
    return cases


def _table_order(table, code, n_live: int):
    """(key, slot, row) per filled row-plane entry of a build result, and
    the stable order that sorts the entries by key. Raises where an entry
    sits in another key's slot, a slot's rows do not ascend, or the rows
    past the live count are not -1."""
    import torch
    off = table.off.to(torch.int64)
    e = torch.arange(n_live, device=off.device)
    slot = torch.searchsorted(off, e, right=True) - 1
    key = table.tk[slot]
    row = table.rows[:n_live].to(torch.int64)
    if not torch.equal(key, code[row]):
        raise AssertionError("build: a row sits in another key's slot")
    if bool(((slot[1:] == slot[:-1]) & (row[1:] <= row[:-1])).any()):
        raise AssertionError("build: a slot's rows do not ascend")
    if not bool((table.rows[n_live:] == -1).all()):
        raise AssertionError("build: row plane past the live rows")
    cnt = off[1:] - off[:-1]
    free = torch.nonzero(cnt[:-1] == 0).flatten()
    if not bool((table.tk[free] == I64_MIN).all()):
        raise AssertionError("build: a free slot holds a key")
    return key, row, torch.sort(key, stable=True).indices


def check_join_case(case):
    """Kernels vs plain versions on the card for one case: the build as a
    key → ordered rows map (with the info counters), the probe of the
    kernel's table element for element against the plain probe of both
    tables, and the pairs against the torch sort join. Returns the
    tensors and the result's sizes."""
    import torch
    from daft_tpu_torch.device import join_kernels as jk, kernels as K
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    r_code, r_live = t(case["r_code"]), t(case["r_live"])
    l_code, l_live = t(case["l_code"]), t(case["l_live"])
    cap = case["cap"]
    T = jk.join_table_capacity(r_code.shape[0])
    got = jk.hash_join_build_cuda(r_code, r_live, T)
    ref = jk.hash_join_build_plain(r_code, r_live, T)
    n_live = int(r_live.sum())
    if int(got.n_keys) != int(ref.n_keys) or int(got.unplaced) != 0:
        raise AssertionError(f"{case['name']}: {int(got.n_keys)} keys, "
                             f"plain {int(ref.n_keys)}; "
                             f"{int(got.unplaced)} rows without a slot")
    kg, rg, og = _table_order(got, r_code, n_live)
    kr, rr, orr = _table_order(ref, r_code, n_live)
    if not (torch.equal(kg[og], kr[orr]) and torch.equal(rg[og], rr[orr])):
        raise AssertionError(f"{case['name']}: build key → rows differ")
    packed = jk.hash_join_probe_cuda(l_code, l_live, got, cap)
    for table in (got, ref):
        if not torch.equal(packed, jk.hash_join_probe_plain(
                l_code, l_live, table, cap)):
            raise AssertionError(f"{case['name']}: probe differs")
    C_l = l_code.shape[0]
    ones_l = torch.ones(C_l, dtype=torch.bool, device=l_code.device)
    ones_r = torch.ones_like(r_live)
    srt = K.join_fused_impl(l_code, l_live, ones_l, r_code, r_live, ones_r,
                            cap)
    total = int(packed[2, :C_l].sum())
    n = min(total, cap)
    if not (torch.equal(packed[2, :C_l], srt[2, :C_l])
            and torch.equal(packed[:2, :n], srt[:2, :n])):
        raise AssertionError(f"{case['name']}: pairs differ from the sort "
                             "join")
    return dict(r_code=r_code, r_live=r_live, l_code=l_code, l_live=l_live,
                T=T, cap=cap, table=got, packed=packed, total=total,
                keys=int(got.n_keys), n_live_r=n_live)


def time_join(c, bw: float):
    """Kernel, plain and sort-join times (CUDA events) for one checked
    case, with the byte bounds."""
    from daft_tpu_torch.device import join_kernels as jk, kernels as K
    import torch
    r_code, r_live, l_code, l_live = c["r_code"], c["r_live"], \
        c["l_code"], c["l_live"]
    T, cap, table = c["T"], c["cap"], c["table"]
    b_bytes = join_build_bytes(r_live, T)
    p_bytes = join_probe_bytes(l_live, c["packed"], cap)
    ones_l = torch.ones_like(l_live)
    ones_r = torch.ones_like(r_live)
    return dict(
        build_ms=cuda_ms(lambda: jk.hash_join_build_cuda(r_code, r_live, T)),
        build_host_ms=host_ms(lambda: jk.hash_join_build_cuda(
            r_code, r_live, T)),
        probe_host_ms=host_ms(lambda: jk.hash_join_probe_cuda(
            l_code, l_live, table, cap)),
        build_plain_ms=cuda_ms(lambda: jk.hash_join_build_plain(
            r_code, r_live, T), reps=5, warm=1),
        build_bytes=b_bytes, build_bound_ms=b_bytes / HBM_BYTES_PER_S * 1e3,
        build_bound_measured_bw_ms=b_bytes / bw * 1e3,
        probe_ms=cuda_ms(lambda: jk.hash_join_probe_cuda(
            l_code, l_live, table, cap)),
        probe_plain_ms=cuda_ms(lambda: jk.hash_join_probe_plain(
            l_code, l_live, table, cap), reps=5, warm=1),
        probe_bytes=p_bytes, probe_bound_ms=p_bytes / HBM_BYTES_PER_S * 1e3,
        probe_bound_measured_bw_ms=p_bytes / bw * 1e3,
        sort_join_ms=cuda_ms(lambda: K.join_fused_impl(
            l_code, l_live, ones_l, r_code, r_live, ones_r, cap), reps=5,
            warm=1))


def join_kernel_phase(rng, bw: float):
    """Join kernels vs plain on the card over the coverage cases."""
    out = []
    for case in join_cases(rng, JOIN_C_R, JOIN_LIVE_R, JOIN_C_L):
        c = check_join_case(case)
        rec = dict(case=case["name"], C_r=c["r_code"].shape[0],
                   live_r=c["n_live_r"], C_l=c["l_code"].shape[0],
                   live_l=int(c["l_live"].sum()), T=c["T"], cap=c["cap"],
                   keys=c["keys"], total=c["total"], **time_join(c, bw))
        log("join kernel case " + json.dumps(rec))
        out.append(rec)
    return out


# --------------------------------------------------------------- main path

def tpch_root(sf: float) -> str:
    from benchmarking.tpch.datagen import generate_tpch
    root = os.path.join(HERE, ".cache", f"tpch_sf{sf:g}")
    li = os.path.join(root, "lineitem")
    if not (os.path.isdir(li) and os.listdir(li)):
        t0 = time.perf_counter()
        generate_tpch(root, scale_factor=sf, num_parts=8, seed=42)
        log(f"datagen sf={sf:g}: {time.perf_counter() - t0:.3f} s")
    return root


def _close(a, b, rel: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def check_table(name, got: dict, ref: dict, key_cols, exact_cols,
                rel_cols, rel: float = 1e-9, loose_cols=()):
    """Row-aligned comparison after sorting both by the key columns."""
    n = len(ref[key_cols[0]]) if key_cols else 1
    if any(len(v) != n for v in got.values()):
        raise AssertionError(f"{name}: row count {len(next(iter(got.values())))} != {n}")
    for c in key_cols + exact_cols:
        if list(got[c]) != list(ref[c]):
            raise AssertionError(f"{name}: column {c} differs")
    for c in rel_cols:
        for a, b in zip(got[c], ref[c]):
            if not _close(a, b, rel):
                raise AssertionError(f"{name}: {c} {a} vs {b}")
    for c in loose_cols:
        for a, b in zip(got[c], ref[c]):
            if not _close(a, b, 1e-6):
                raise AssertionError(f"{name}: {c} {a} vs {b}")


def pyarrow_answers(root: str):
    """The four queries computed independently with pyarrow."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.dataset as ds
    li = ds.dataset(os.path.join(root, "lineitem"), format="parquet") \
        .to_table(columns=["l_returnflag", "l_linestatus", "l_quantity",
                           "l_extendedprice", "l_discount", "l_tax",
                           "l_shipdate", "l_suppkey"])
    out = {}
    # Q1
    t = li.filter(pc.less_equal(li["l_shipdate"],
                                pa.scalar(datetime.date(1998, 9, 2))))
    disc = pc.multiply(t["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), t["l_discount"]))
    charge = pc.multiply(disc, pc.add(pa.scalar(1.0), t["l_tax"]))
    t = t.append_column("disc", disc).append_column("charge", charge)
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("disc", "sum"),
        ("charge", "sum"), ("l_quantity", "mean"),
        ("l_extendedprice", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count")]).sort_by([("l_returnflag", "ascending"),
                                           ("l_linestatus", "ascending")])
    out["q1"] = {
        "l_returnflag": g["l_returnflag"].to_pylist(),
        "l_linestatus": g["l_linestatus"].to_pylist(),
        "sum_qty": g["l_quantity_sum"].to_pylist(),
        "sum_base_price": g["l_extendedprice_sum"].to_pylist(),
        "sum_disc_price": g["disc_sum"].to_pylist(),
        "sum_charge": g["charge_sum"].to_pylist(),
        "avg_qty": g["l_quantity_mean"].to_pylist(),
        "avg_price": g["l_extendedprice_mean"].to_pylist(),
        "avg_disc": g["l_discount_mean"].to_pylist(),
        "count_order": g["l_quantity_count"].to_pylist()}
    # suppkey group-by
    g = li.group_by("l_suppkey").aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "mean"),
        ("l_discount", "count"), ("l_quantity", "min"),
        ("l_extendedprice", "max"),
        ("l_extendedprice", "stddev", pc.VarianceOptions(ddof=0))]) \
        .sort_by("l_suppkey")
    out["suppkey_agg"] = {
        "l_suppkey": g["l_suppkey"].to_pylist(),
        "sum_qty": g["l_quantity_sum"].to_pylist(),
        "avg_price": g["l_extendedprice_mean"].to_pylist(),
        "n": g["l_discount_count"].to_pylist(),
        "min_qty": g["l_quantity_min"].to_pylist(),
        "max_price": g["l_extendedprice_max"].to_pylist(),
        "std_price": g["l_extendedprice_stddev"].to_pylist()}
    pairs = li.group_by(["l_suppkey", "l_discount"]).aggregate([])
    out["suppkey_disc_pairs"] = set(zip(pairs["l_suppkey"].to_pylist(),
                                        pairs["l_discount"].to_pylist()))
    # shipdate group-by
    g = li.group_by("l_shipdate").aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("l_discount", "mean"), ("l_quantity", "count"),
        ("l_discount", "max")]).sort_by("l_shipdate")
    out["shipdate_agg"] = {
        "l_shipdate": g["l_shipdate"].to_pylist(),
        "sum_qty": g["l_quantity_sum"].to_pylist(),
        "sum_price": g["l_extendedprice_sum"].to_pylist(),
        "avg_disc": g["l_discount_mean"].to_pylist(),
        "n": g["l_quantity_count"].to_pylist(),
        "max_disc": g["l_discount_max"].to_pylist()}
    # Q6
    sd = li["l_shipdate"]
    m = pc.and_(pc.and_(
        pc.greater_equal(sd, pa.scalar(datetime.date(1994, 1, 1))),
        pc.less(sd, pa.scalar(datetime.date(1995, 1, 1)))),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.05),
                        pc.less_equal(li["l_discount"], 0.07)),
                pc.less(li["l_quantity"], 24.0)))
    t = li.filter(m)
    out["q6"] = {"revenue": [pc.sum(pc.multiply(
        t["l_extendedprice"], t["l_discount"])).as_py()]}
    out["rows"] = li.num_rows
    return out


def check_answer(name: str, got: dict, ref: dict):
    if name == "q1":
        check_table(name, got, ref["q1"], ["l_returnflag", "l_linestatus"],
                    ["count_order"],
                    ["sum_qty", "sum_base_price", "sum_disc_price",
                     "sum_charge", "avg_qty", "avg_price", "avg_disc"])
    elif name == "q6":
        check_table(name, got, ref["q6"], [], [], ["revenue"])
    elif name == "suppkey_agg":
        r = ref["suppkey_agg"]
        check_table(name, {k: got[k] for k in r}, r, ["l_suppkey"],
                    ["n", "min_qty", "max_price"], ["sum_qty", "avg_price"],
                    loose_cols=["std_price"])
        for k, v in zip(got["l_suppkey"], got["any_disc"]):
            if (k, v) not in ref["suppkey_disc_pairs"]:
                raise AssertionError(f"{name}: any_value {v} not a value "
                                     f"of group {k}")
    else:
        check_table(name, got, ref["shipdate_agg"], ["l_shipdate"],
                    ["n", "max_disc"], ["sum_qty", "sum_price", "avg_disc"])


EXPECT = {"q1": ("dense",), "suppkey_agg": ("hash",),
          "shipdate_agg": ("hash",), "q6": ("global",)}


def main_path(root: str):
    """Drive the port's entry points once with counters zeroed (the counted
    run: the pipelined path, window 2, the device column cache empty) and
    check answers and counters. The walls are the pipeline phase's."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cache, hash_kernels as hk, pipeline
    from daft_tpu_torch.device import runtime
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    t0 = time.perf_counter()
    ref = pyarrow_answers(root)
    log(f"pyarrow reference answers: {time.perf_counter() - t0:.3f} s")
    if pipeline.inflight_window() != 2:
        raise AssertionError("the main path runs at the default window 2")
    cache.get_cache().clear()
    recorded, events = [], []
    orig = hk.hash_agg_build
    query = [None]

    def recording(words, live, vals, contribs, specs, T):
        recorded.append((query[0], (words, live, vals, contribs, specs, T)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(words, live, vals, contribs, specs, T)
        b.record()
        events.append((a, b))
        return out
    hk.hash_agg_build = recording
    results = {}
    # ---- the counted run: every count zeroed just before, read just after
    runtime.reset_counters()
    hk.reset_launches()
    per_query = {}
    try:
        for name in ("q1", "suppkey_agg", "shipdate_agg", "q6"):
            query[0] = name
            c0, l0, e0 = runtime.counters(), hk.launches, len(events)
            t0 = time.perf_counter()
            got = Q.QUERIES[name](get).to_pydict()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            c1 = runtime.counters()
            delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
            # a maximum, not a count: the most slots in flight so far
            delta.pop("pipeline_peak_inflight", None)
            per_query[name] = dict(
                counters=delta, launches=hk.launches - l0, cold_s=cold,
                kernel_ms=sum(a.elapsed_time(b) for a, b in events[e0:]),
                kernel_rungs=[(int(a[1].sum()), a[5])
                              for _, a in recorded[e0:]])
            results[name] = got
    finally:
        hk.hash_agg_build = orig
    main_launches = hk.launches
    counters = runtime.counters()
    # every distinct rung (query, T, key words): its first inputs, and the
    # counted run's launches and summed event time there
    rungs = {}
    for (q, a), (e0, e1) in zip(recorded, events):
        r = rungs.setdefault((q, a[5], len(a[0])),
                             dict(args=a, launches=0, ms_sum=0.0,
                                  pass_="default"))
        r["launches"] += 1
        r["ms_sum"] += e0.elapsed_time(e1)
    for name, got in results.items():
        check_answer(name, got, ref)
        pq = per_query[name]
        for s in EXPECT[name]:
            if pq["counters"].get(s, 0) <= 0:
                raise AssertionError(f"{name}: no {s} dispatch ({pq})")
        if pq["counters"].get("host_morsels", 0) != 0:
            raise AssertionError(f"{name}: host-tier morsels {pq}")
        if name in ("suppkey_agg", "shipdate_agg") and pq["launches"] <= 0:
            raise AssertionError(f"{name}: hash kernel never launched")
        c = pq["counters"]
        if c.get("pipeline_slots", 0) < 1 or c.get("pipeline_slots_acquired") \
                != c.get("pipeline_slots_released"):
            raise AssertionError(f"{name}: not through the pipeline ({c})")
        log(f"main path {name}: answer matches pyarrow; " + json.dumps(pq))
    if main_launches <= 0:
        raise AssertionError("hash kernel launched no time on the main path")
    if sum(r["launches"] for r in rungs.values()) != main_launches:
        raise AssertionError(f"hash launches {main_launches} != the builds "
                             "recorded at the rungs")
    # the dispatch pass: the four queries again with the per-operator
    # paths at the 4,096-row floor (answers held to pyarrow), so a rung
    # the cost model now keeps on the host (l_shipdate's final merge) is
    # still held and timed in phase 8, marked with its pass
    n0 = len(recorded)
    hk.hash_agg_build = recording
    try:
        with _env(**DISPATCH_PASS):
            for name in ("q1", "suppkey_agg", "shipdate_agg", "q6"):
                query[0] = name
                _clear_device_cache()
                check_answer(name, Q.QUERIES[name](get).to_pydict(), ref)
    finally:
        hk.hash_agg_build = orig
    for (q, a), (e0, e1) in zip(recorded[n0:], events[n0:]):
        key = (q, a[5], len(a[0]))
        if key in rungs and rungs[key]["pass_"] == "default":
            continue
        r = rungs.setdefault(key, dict(args=a, launches=0, ms_sum=0.0,
                                       pass_="floor4096"))
        r["launches"] += 1
        r["ms_sum"] += e0.elapsed_time(e1)
    log("main path dispatch pass: answers match pyarrow; rungs held only "
        "there: " + json.dumps([list(k) for k, r in rungs.items()
                                if r["pass_"] != "default"]))
    return dict(counters=counters, launches=main_launches,
                per_query=per_query,
                kernel_ms_sum=sum(a.elapsed_time(b) for a, b in events),
                rungs=rungs, ref=ref)


# ----------------------------------------------------------- pipeline phase

#: (way, window, clear the device column cache before each run)
PIPE_WAYS = (("sync", 0, True), ("piped_cold", 2, True),
             ("piped_warm", 2, False))


def traced_idle(fn):
    """One run of ``fn`` under ``torch.profiler``: the traced wall, the
    card's busy seconds summed over its activities (kernels, copies,
    memsets; as in the ``--profile`` trace) and as the union of their
    intervals (activities on several streams overlap), and the idle share
    of the wall by each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summed = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("Activity Buffer")) / 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("Activity Buffer"))
    union, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    union /= 1e6
    return dict(traced_wall_s=wall, busy_summed_s=summed,
                busy_union_s=union if spans else None,
                idle_share_summed=1.0 - summed / wall,
                idle_share_union=1.0 - union / wall if spans else None,
                activities=len(spans))


def _scan_task_count(df) -> int:
    """The scan tasks of ``df``'s physical plan: its files merged or split
    to the configured task sizes, as the reference plans them."""
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    n = [0]

    def walk(node):
        if isinstance(node, pp.ScanSource):
            n[0] += len(node.tasks)
        for c in node.children:
            walk(c)
    walk(translate(df.builder.optimize().plan))
    return n[0]


def pipeline_phase(root: str, ref: dict, reps: int):
    """Q1, ``l_suppkey``, ``l_shipdate`` and Q6 at SF1, each run three
    ways, ``reps`` runs each: window 0 (the synchronous path) and window 2
    with the device column cache cleared before each run (cold walls, as
    versions without the cache measured), then window 2 on the cache
    those runs left
    (warm). Every answer equals pyarrow's and the first way's (keys and
    counts exact, floats at 1e-9). Checks: at least 2 slots in flight at
    once in Q1 under window 2; every staging buffer pinned; the warm runs
    hit the cache for every task and copy no scan column to the card;
    slots acquired = released in every run; the first dispatch of each
    hash-agg rung of the pipelined runs equals the plain build. Then Q1
    traced under ways 1 and 2 (the card's idle share)."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cache, column, hash_kernels as hk
    from daft_tpu_torch.device import pipeline, runtime
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    import threading
    pinned, pin_lock = [0, 0], threading.Lock()
    orig_up, orig_build = column._upload, hk.hash_agg_build
    rungs, label = {}, [None]

    def watch_upload(planes, capacity, device):
        # encodes run on pool threads: count under a lock
        out = orig_up(planes, capacity, device)
        if out[2] is not None:
            # staging buffers are numpy arrays over pooled pinned buffers
            n = sum(bool(torch.from_numpy(a).is_pinned()) for a in out[2])
            with pin_lock:
                pinned[0] += n
                pinned[1] += len(out[2])
        return out

    def first_build(words, live, vals, contribs, specs, T):
        if label[0] is not None:
            rungs.setdefault((label[0], T, len(words)),
                             (words, live, vals, contribs, specs, T))
        return orig_build(words, live, vals, contribs, specs, T)

    def run_once(name: str, way: str, window: int) -> dict:
        """One run: its answer checked, its counters returned."""
        runtime.reset_counters()
        t0 = time.perf_counter()
        got = Q.QUERIES[name](get).to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = runtime.counters()
        check_answer(name, got, ref)
        _same_answer(f"{name} {way}", got, answers.setdefault(name, got))
        bad = []
        if c.get("pipeline_slots_acquired", 0) != \
                c.get("pipeline_slots_released", 0):
            bad.append("slots unbalanced")
        if c.get("host_morsels", 0):
            bad.append("host morsels")
        tasks = n_tasks[name]
        if way == "piped_warm" and (c.get("cache_hits", 0) != tasks
                                    or c.get("cache_misses", 0)
                                    or c.get("scan_bytes_up", 0)):
            bad.append("not every task served from the cache")
        if way != "piped_warm" and c.get("cache_misses", 0) != tasks:
            bad.append("cache not cleared")
        if window and c.get("pipeline_slots", 0) < 1:
            bad.append("no pipeline slot")
        if bad:
            raise AssertionError(f"{name} {way}: {bad} ({c})")
        c["wall_s"] = wall
        return c

    def summed(runs) -> dict:
        """The runs' counters of the pipeline, the cache, the registry
        and the transfers, summed (the peak in flight: its maximum)."""
        out = {}
        for c in runs:
            for k, v in c.items():
                if not (k.startswith(("pipeline_", "cache_", "residency_"))
                        or k in ("scan_bytes_up", "bytes_up", "h2d_copies",
                                 "bytes_down", "d2h_copies")):
                    continue
                out[k] = max(out.get(k, 0), v) \
                    if k == "pipeline_peak_inflight" else out.get(k, 0) + v
        return out

    rows = ref["rows"]
    walls, answers, stats = {}, {}, {}
    # one cache entry set per scan task: a filtered scan keeps its 8
    # files apart, an unfiltered one merges them (``io/scan.py``)
    n_tasks = {name: _scan_task_count(Q.QUERIES[name](get))
               for name in ("q1", "suppkey_agg", "shipdate_agg", "q6")}
    log("pipeline scan tasks " + json.dumps(n_tasks))
    column._upload, hk.hash_agg_build = watch_upload, first_build
    try:
        # per query the three ways in turn: the warm way runs on the cache
        # the cold way's last run left
        for name in ("q1", "suppkey_agg", "shipdate_agg", "q6"):
            for way, window, clear in PIPE_WAYS:
                label[0] = f"pipeline {name}" if window else None
                runs = []
                with dtt.execution_config_ctx(device_inflight=window):
                    for _ in range(reps):
                        if clear:
                            cache.get_cache().clear()
                        runs.append(run_once(name, way, window))
                agg = summed(runs)
                peak = agg.get("pipeline_peak_inflight", 0)
                if name == "q1" and window and peak < 2:
                    raise AssertionError(f"q1 {way}: at most {peak} slots "
                                         "in flight")
                ws = [c["wall_s"] for c in runs]
                walls[(name, way)], stats[(name, way)] = ws, agg
                log("pipeline " + json.dumps(dict(
                    query=name, way=way, window=window, cache_cleared=clear,
                    walls_s=ws, median_s=statistics.median(ws),
                    rows_per_s=rows / statistics.median(ws),
                    counters_summed=agg)))
    finally:
        column._upload, hk.hash_agg_build = orig_up, orig_build
    if pinned[1] == 0 or pinned[0] != pinned[1]:
        raise AssertionError(f"staging buffers pinned: {pinned[0]} of "
                             f"{pinned[1]}")
    log(f"pipeline staging buffers: {pinned[1]} copies, all pinned")
    if not any(k[0] in ("pipeline suppkey_agg", "pipeline shipdate_agg")
               for k in rungs):
        raise AssertionError("no hash-agg rung reached from the pipeline")
    for (q, T, n_words), a in rungs.items():
        got = hk.hash_agg_build(*a)
        plain = hk.hash_agg_build_plain(*a)
        err = compare_builds(got, plain, a[4], a[0], a[1], a[2], a[3], T)
        log("pipeline rung " + json.dumps(dict(
            query=q, T=T, words=n_words, live=int(a[1].sum()),
            groups=int(got[4]), max_abs_err=err)) + ": equals the plain "
            "build")
    summary = {way: summed(stats[(n, way)] for n in (
        "q1", "suppkey_agg", "shipdate_agg", "q6")) for way, _, _ in PIPE_WAYS}
    log("pipeline counters " + json.dumps(summary))
    log("pipeline cache now " + json.dumps(cache.get_cache().stats())
        + "; residency now " + json.dumps(pipeline.residency_counters()))
    idle = {}
    for way, window, _ in PIPE_WAYS[:2]:
        with dtt.execution_config_ctx(device_inflight=window):
            cache.get_cache().clear()
            idle[way] = traced_idle(lambda: Q.q1(get).to_pydict())
        log("pipeline trace q1 " + json.dumps(dict(way=way, **idle[way])))
    return dict(walls=walls, stats=summary, idle=idle)


# --------------------------------------------------------------- join path

Q3_DATE = datetime.date(1995, 3, 15)


def q3_reference(root: str):
    """Q3 computed independently with pyarrow (``Table.join`` and
    ``group_by``) on the same files, and the filtered input sizes."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.dataset as ds

    def read(t, cols):
        return ds.dataset(os.path.join(root, t), format="parquet") \
            .to_table(columns=cols)
    c = read("customer", ["c_custkey", "c_mktsegment"])
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING"))
    o = read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                        "o_shippriority"])
    o = o.filter(pc.less(o["o_orderdate"], pa.scalar(Q3_DATE)))
    li = read("lineitem", ["l_orderkey", "l_extendedprice", "l_discount",
                           "l_shipdate"])
    li = li.filter(pc.greater(li["l_shipdate"], pa.scalar(Q3_DATE)))
    co = c.join(o, keys="c_custkey", right_keys="o_custkey",
                join_type="inner")
    j = co.join(li, keys="o_orderkey", right_keys="l_orderkey",
                join_type="inner")
    vol = pc.multiply(j["l_extendedprice"],
                      pc.subtract(pa.scalar(1.0), j["l_discount"]))
    g = j.append_column("volume", vol) \
        .group_by(["o_orderkey", "o_orderdate", "o_shippriority"]) \
        .aggregate([("volume", "sum")]) \
        .sort_by([("volume_sum", "descending"),
                  ("o_orderdate", "ascending")]).slice(0, 10)
    ans = {"o_orderkey": g["o_orderkey"].to_pylist(),
           "revenue": g["volume_sum"].to_pylist(),
           "o_orderdate": g["o_orderdate"].to_pylist(),
           "o_shippriority": g["o_shippriority"].to_pylist()}
    sizes = dict(customer=c.num_rows, orders=o.num_rows,
                 lineitem=li.num_rows, customer_orders=co.num_rows,
                 joined=j.num_rows)
    return ans, sizes


def q3_path(root: str, reps: int, ref=None, threshold=None,
            label: str = "q3"):
    """Drive Q3 once with every count zeroed just before (the counted
    run), check the answer and the counters, then time warm repeats.
    Each counted build/probe launch is timed with CUDA events (a join's
    device section runs alone: ``joins._device_lock``). ``threshold``
    overrides the broadcast threshold for the whole run (the
    forced-broadcast variant, where each morsel of the streamed side
    rebuilds the broadcast side's table)."""
    import contextlib
    import daft_tpu_torch as dtt
    with (dtt.execution_config_ctx(
            broadcast_join_size_bytes_threshold=threshold)
          if threshold is not None else contextlib.nullcontext()):
        return _q3_path(root, reps, ref, label)


def _q3_path(root: str, reps: int, ref, label: str):
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch import joins
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import hash_kernels as hk, runtime
    from daft_tpu_torch.device import join_kernels as jk
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    if ref is None:
        t0 = time.perf_counter()
        ref = q3_reference(root)
        log(f"q3 pyarrow reference: {time.perf_counter() - t0:.3f} s; "
            f"filtered/joined rows {json.dumps(ref[1])}")
    ref_ans = ref[0]
    strategies = []

    def walk(n):
        if isinstance(n, pp.HashJoin):
            strategies.append(n.strategy)
        for ch in n.children:
            walk(ch)
    walk(translate(Q.q3(get).builder.optimize().plan))
    log(f"{label} plan: join strategies (top join first) {strategies}")

    builds, probes = [], []
    orig_b, orig_p = jk.hash_join_build_cuda, jk.hash_join_probe_cuda

    def timed(fn, store, *a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a)
        e1.record()
        store.append((a, out, e0, e1))
        return out
    jk.hash_join_build_cuda = lambda *a: timed(orig_b, builds, *a)
    jk.hash_join_probe_cuda = lambda *a: timed(orig_p, probes, *a)
    orig_m, joined = joins._device_match_indices, []

    def counted(*a, **k):
        joined.append(1)
        return orig_m(*a, **k)
    joins._device_match_indices = counted
    # ---- the counted run: every count zeroed just before, read just after
    runtime.reset_counters()
    hk.reset_launches()
    jk.reset_launches()
    try:
        t0 = time.perf_counter()
        got = Q.q3(get).to_pydict()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    finally:
        jk.hash_join_build_cuda, jk.hash_join_probe_cuda = orig_b, orig_p
        joins._device_match_indices = orig_m
    counters = runtime.counters()
    launches = dict(jk.launches)
    check_table(label, got, ref_ans, ["o_orderkey"],
                ["o_orderdate", "o_shippriority"], ["revenue"])
    n_hash = counters.get("join_hash", 0)
    if counters.get("host_joins", 0) or counters.get("join_sort", 0) \
            or n_hash < len(strategies):
        raise AssertionError(f"{label}: joins not all on the device with "
                             f"the hash strategy: {counters}")
    # one build per device join, one probe per dispatch (an overflow
    # re-dispatch probes the same table again)
    if launches["hash_join_build"] != len(joined) \
            or launches["hash_join_probe"] != n_hash:
        raise AssertionError(f"{label}: launches {launches}, hash "
                             f"dispatches {n_hash}, device joins "
                             f"{len(joined)}")
    shapes = [dict(C_l=a[0].shape[0], live_l=int(a[1].sum()),
                   C_r=a[2].rows.shape[0], T=a[2].T, cap=a[3],
                   total=int(out[2, :a[0].shape[0]].sum()))
              for a, out, _, _ in probes]
    each = {"hash_join_build": [e0.elapsed_time(e1) for *_, e0, e1 in builds],
            "hash_join_probe": [e0.elapsed_time(e1) for *_, e0, e1 in probes]}
    kernel_ms = {k: sum(v) for k, v in each.items()}
    rec = dict(counters=counters, launches=launches, joins=len(joined),
               cold_s=cold, kernel_ms=kernel_ms, kernel_ms_each=each,
               dispatches=shapes)
    log(f"join path {label}: answer matches pyarrow; " + json.dumps(rec))
    # ---- warm timings (not counted)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        Q.q3(get).to_pydict()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    w = statistics.median(walls)
    rows = sum(pq_rows(os.path.join(root, t))
               for t in ("customer", "orders", "lineitem"))
    log(f"join path {label}: warm {w:.6f} s (median of {reps}), "
        f"{rows / w:.1f} scanned rows/s ({rows} rows in the three tables)"
        f"; walls {walls}")
    # the largest dispatch (the lineitem join) for the kernel timing
    a, table, *_ = max(builds, key=lambda b: b[0][0].shape[0])
    probe = next(p for p in probes if p[0][2] is table)
    rec.update(warm_s=w, walls=walls, rows=rows, rows_per_s=rows / w,
               strategies=strategies, main_build=(a, table),
               main_probe=probe[0], ref=ref)
    return rec


def pq_rows(path: str) -> int:
    import pyarrow.dataset as ds
    return ds.dataset(path, format="parquet").count_rows()


def join_main_path_timing(q3, bw: float):
    """Kernels vs plain on the exact inputs of Q3's largest dispatch (the
    lineitem join): checked as in the join-kernel phase, then timed."""
    (r_code, r_live, T), _ = q3["main_build"]
    l_code, l_live, _, cap = q3["main_probe"]
    c = check_join_case(dict(name="q3_main_path", r_code=r_code.cpu().numpy(),
                             r_live=r_live.cpu().numpy(),
                             l_code=l_code.cpu().numpy(),
                             l_live=l_live.cpu().numpy(), cap=cap))
    from daft_tpu_torch.device import join_kernels as jk
    rec = dict(C_r=r_code.shape[0], live_r=c["n_live_r"],
               C_l=l_code.shape[0], live_l=int(l_live.sum()), T=T, cap=cap,
               keys=c["keys"], total=c["total"], **time_join(c, bw))
    for pre, fn in (
            ("build", lambda: jk.hash_join_build_cuda(r_code, r_live, T)),
            ("probe", lambda: jk.hash_join_probe_cuda(
                l_code, l_live, c["table"], cap))):
        rec[f"{pre}_launches_per_call"] = sum(
            n for n, _ in device_activities(fn).values())
    log("join kernels at main-path inputs " + json.dumps(rec))
    return rec


def join_rung_timing(rungs, bw: float):
    """Join kernels vs plain on the exact inputs of each distinct join
    rung of the TPC-H 22 phase (the first dispatch of each): the build as
    key → ordered rows, the probe element for element, the pairs against
    the torch sort join (as in the join-kernel phase), then timed, with
    the byte bounds of those inputs."""
    out = []
    for (query, C_r, T, C_l, cap), r in rungs.items():
        r_code, r_live, _ = r["build"]
        l_code, l_live, _ = r["probe"]
        c = check_join_case(dict(
            name=f"{query} join rung", r_code=r_code.cpu().numpy(),
            r_live=r_live.cpu().numpy(), l_code=l_code.cpu().numpy(),
            l_live=l_live.cpu().numpy(), cap=cap))
        rec = dict(query=query, C_r=C_r, live_r=c["n_live_r"], C_l=C_l,
                   live_l=int(c["l_live"].sum()), T=T, cap=cap,
                   keys=c["keys"], total=c["total"],
                   pass_=r.get("pass_", "floor4096"),
                   launches=r["launches"], main_path_ms_sum=r["ms_sum"],
                   **time_join(c, bw))
        log("join kernels at tpch22 rung " + json.dumps(rec))
        out.append(rec)
    return out


def main_path_kernel_timing(rungs, bw: float):
    """Kernel vs plain on the exact inputs of each distinct hash rung of
    the main path (the first dispatch of each): checked, then timed, with
    the byte bound of those inputs."""
    from daft_tpu_torch.device import hash_kernels as hk
    out = []
    for (query, T, n_words), r in rungs.items():
        words, live, vals, contribs, specs, _ = r["args"]
        got = hk.hash_agg_build(words, live, vals, contribs, specs, T)
        ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs, T)
        err = compare_builds(got, ref, specs, words, live, vals, contribs, T)
        ms = cuda_ms(lambda: hk.hash_agg_build(
            words, live, vals, contribs, specs, T))
        plain_ms = cuda_ms(lambda: hk.hash_agg_build_plain(
            words, live, vals, contribs, specs, T), warm=1)
        nbytes = build_bytes(words, live, vals, contribs, specs, T)
        rec = dict(query=query, C=live.shape[0], live=int(live.sum()), T=T,
                   words=n_words, groups=int(got[4]), specs=len(specs),
                   planes=len(hk.plane_aliases(specs, vals, contribs)[0]),
                   path=build_path(words, vals, contribs, specs, T),
                   launches=r["launches"], main_path_ms_sum=r["ms_sum"],
                   pass_=r.get("pass_", "default"),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_measured_bw_ms=nbytes / bw * 1e3)
        log("kernel at main-path inputs " + json.dumps(rec))
        out.append(rec)
    return out


TPCH22_COUNTERS = ("projection", "predicate", "argsort", "agg_hash",
                   "agg_sort", "agg_global", "dense", "hash", "sort",
                   "global", "join_hash", "host_joins", "host_ops",
                   "host_morsels", "op_bytes_up")


def _same_answer(name: str, got: dict, ref: dict, rel: float = 1e-9):
    """Row for row: keys, counts, integers and strings exact, floats at
    relative ``rel`` (NaN equal to NaN)."""
    if list(got) != list(ref):
        raise AssertionError(f"{name}: columns {list(got)} != {list(ref)}")
    for c in ref:
        if len(got[c]) != len(ref[c]):
            raise AssertionError(f"{name}: {c} has {len(got[c])} rows, "
                                 f"not {len(ref[c])}")
        for a, b in zip(got[c], ref[c]):
            ok = (_close(a, b, rel) or (a != a and b != b)) \
                if isinstance(a, float) and isinstance(b, float) else a == b
            if not ok:
                raise AssertionError(f"{name}: {c} {a!r} vs {b!r}")


def _canonical_rows(d: dict) -> list:
    """The rows of an answer sorted by a canonical key (floats rounded to
    9 significant digits for the key only; None first)."""
    def key(v):
        if v is None:
            return (0, "")
        if isinstance(v, float):
            return (1, float(f"{v:.9g}") if v == v else float("inf"))
        return (2, repr(v))
    cols = list(d)
    rows = list(zip(*(d[c] for c in cols))) if cols else []
    return sorted(rows, key=lambda r: tuple(key(v) for v in r))


def _same_rows(name: str, got: dict, ref: dict, keys=(), limit=None,
               rel: float = 1e-9, unlimited=None) -> str:
    """Held by the query's ``ORDER BY`` keys (``tpcds_sql.same_order``):
    the keys row for row, and the rows inside each run of equal keys as a
    multiset (the push executor orders tied rows by their arrival) →
    ``"ordered"`` when no run holds two rows, else ``"ties"``. Where that
    fails on an answer that reaches the query's ``LIMIT``, ``unlimited()``
    (the host tier's answer without the ``LIMIT``) must show a run of
    equal keys that the cut splits; then the last run's rows are held as a
    multiset drawn from that whole run (``tpcds_sql.cut_run``) →
    ``"cut ties"``. Any other difference fails. Never sorts whole rows."""
    from daft_tpu_torch.benchmarking import tpcds_sql as DS
    n = len(next(iter(ref.values()), []))
    try:
        runs = DS.same_order(got, ref, keys, rel)
    except AssertionError as e:
        pool = None
        if limit is not None and n == limit and unlimited is not None:
            pool = DS.cut_run(unlimited(), keys, limit, rel)
        if pool is None:
            raise AssertionError(f"{name}: {e}") from None
        try:
            DS.same_order(got, ref, keys, rel, cut_pool=pool)
        except AssertionError as e2:
            raise AssertionError(
                f"{name} (the LIMIT {limit} cuts a run of {len(pool)} tied "
                f"rows): {e2}") from None
        log(f"{name}: the LIMIT {limit} cuts a run of {len(pool)} rows "
            "tied on the ORDER BY keys; the last run held against it")
        return "cut ties"
    return "ties" if any(e - s > 1 for s, e in runs) else "ordered"


def _same_rows_up_to_rank_ties(name: str, got: dict, ref: dict, tie=None,
                               keys=(), limit=None, unlimited=None,
                               rel: float = 1e-9) -> str:
    """``_same_rows``; or, for a query ``tpcds_sql.RANK_TIES`` names
    (``tie`` = its rank column, partition columns and float order
    columns), the answer its rank window gives where the card summed the
    order values in another order (atomics) and so broke a tie the host
    kept: every other column agrees (rows sorted, floats at relative
    ``rel``), and each row's rank differs from the host's by less than
    the number of host rows of its partition whose order values equal its
    own within ``rel`` → ``"rank ties"``. Any other mismatch fails."""
    try:
        return _same_rows(name, got, ref, keys, limit, rel, unlimited)
    except AssertionError:
        if tie is None or list(got) != list(ref):
            raise
        err = sys.exc_info()[1]
    rank, part, order = tie
    rest = [c for c in ref if c != rank]
    if not order or not all(any(isinstance(v, float) for v in ref[c])
                            for c in order):
        raise AssertionError(f"{name}: the order columns {list(order)} of "
                             f"{rank} hold no float") from err
    g = _canonical_rows({c: got[c] for c in rest + [rank]})
    w = _canonical_rows({c: ref[c] for c in rest + [rank]})
    _same_answer(f"{name} (rows sorted, {rank} aside)",
                 {c: [r[i] for r in g] for i, c in enumerate(rest)},
                 {c: [r[i] for r in w] for i, c in enumerate(rest)}, rel)
    pi = [rest.index(c) for c in part]
    oi = [rest.index(c) for c in order]

    def near(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and _close(a, b, rel))
    for gr, wr in zip(g, w):
        peers = sum(all(o[i] == wr[i] for i in pi)
                    and all(near(o[i], wr[i]) for i in oi) for o in w)
        a, b = gr[-1], wr[-1]
        if (a is None) != (b is None) or (
                a is not None and abs(a - b) >= peers):
            raise AssertionError(f"{name}: {rank} {a} vs {b} with {peers} "
                                 "tied rows in its partition") from err
    return "rank ties"


def _clear_device_cache():
    from daft_tpu_torch.device import cache
    cache.get_cache().clear()


class _env:
    """Environment variables set for a block, put back after."""

    def __init__(self, **kv):
        self.kv, self.saved = kv, {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: phase 7's dispatch pass (and the SQL phase): the rules the port had
#: before its cost model, the per-operator paths at the 4,096-row floor and
#: the fused fragment unpriced
DISPATCH_PASS = dict(DAFT_TORCH_DEVICE_MIN_ROWS="4096")


def _priced_host_morsels(name: str, counts: dict, decisions: dict):
    """The fused morsels that ran on the host are exactly those the cost
    model priced there (its ``fused_agg_upload`` decisions for the host):
    none went there for a reason the model did not price."""
    host = sum(decisions.get(k, {}).get("host", 0)
               for k in ("fused_agg_upload", "fused_agg_upload_invest"))
    if counts.get("host_morsels", 0) != host:
        raise AssertionError(f"{name}: {counts.get('host_morsels')} host "
                             f"morsels, {host} priced to the host "
                             f"({decisions})")


class KernelRecorder:
    """Records every hash-agg build and every join build and probe of the
    counted runs, with CUDA events around each launch, and folds them
    into rungs: hash (query, T, key words), join (query, C_r, T, C_l,
    cap), each keeping its first dispatch's inputs, its launches and the
    summed event times (a join's device section runs alone:
    ``joins._device_lock``)."""

    def __init__(self, pass_: str = "default"):
        #: the run the rungs come from: ``default`` (the cost model) or
        #: ``floor4096`` (the dispatch pass)
        self.pass_ = pass_
        self.recorded, self.events = [], []
        # the wrappers may run on several threads at once (phase 7m's
        # scheduler): a build's inputs and its events are appended as a pair
        self._lock = threading.Lock()
        self.jbuilds, self.jprobes, self.join_rungs = {}, [], {}

    def counted(self, label: str, fn, clear: bool = True):
        """``fn()`` with every count zeroed just before and read just
        after → (answer, wall s, counters, launches); ``clear=False``
        keeps the device column cache (a repeat run)."""
        import torch
        from daft_tpu_torch.device import hash_kernels as hk, runtime
        from daft_tpu_torch.device import join_kernels as jk
        orig = hk.hash_agg_build
        orig_b, orig_p = jk.hash_join_build_cuda, jk.hash_join_probe_cuda

        def timed(f, *a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = f(*a)
            e1.record()
            return out, (e0, e1)

        def recording(*a):
            out, ev = timed(orig, *a)
            with self._lock:
                self.recorded.append((label, a))
                self.events.append(ev)
            return out

        def recording_build(code, live, T):
            out, ev = timed(orig_b, code, live, T)
            self.jbuilds[id(out)] = ((code, live, T), out, ev)
            return out

        def recording_probe(code, live, table, cap):
            out, ev = timed(orig_p, code, live, table, cap)
            self.jprobes.append(((code, live, table, cap), ev))
            return out
        from daft_tpu_torch.device import costmodel
        hk.hash_agg_build = recording
        jk.hash_join_build_cuda = recording_build
        jk.hash_join_probe_cuda = recording_probe
        if clear:
            _clear_device_cache()
        runtime.reset_counters()
        costmodel.reset_decision_counts()
        hk.reset_launches()
        jk.reset_launches()
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            hk.hash_agg_build = orig
            jk.hash_join_build_cuda = orig_b
            jk.hash_join_probe_cuda = orig_p
        counts = runtime.counters()
        #: the cost model's decisions of this run
        self.decisions = costmodel.decision_counts_snapshot()
        launches = dict(hash_agg_build=hk.launches, **jk.launches)
        _join_rungs(label, self.jbuilds, self.jprobes, self.join_rungs)
        self.jbuilds.clear()
        self.jprobes.clear()
        return out, wall, counts, launches

    def to_host(self, device: str = "cpu") -> None:
        """Move every recorded input to the CPU (or back to ``device``),
        so that the recorder keeps none of a run's device memory alive
        into the next run."""
        self.recorded = [(q, _moved(a, device)) for q, a in self.recorded]
        for r in self.join_rungs.values():
            r["build"] = _moved(r["build"], device)
            r["probe"] = _moved(r["probe"], device)

    def hash_rungs(self) -> dict:
        rungs = {}
        for (q, a), (e0, e1) in zip(self.recorded, self.events):
            r = rungs.setdefault((q, a[5], len(a[0])),
                                 dict(args=a, launches=0, ms_sum=0.0,
                                      pass_=self.pass_))
            r["launches"] += 1
            r["ms_sum"] += e0.elapsed_time(e1)
        return rungs

    def check_totals(self, phase: str, totals: dict,
                     require_each: bool = True):
        if totals["hash_agg_build"] != len(self.recorded):
            raise AssertionError(f"{phase}: hash launches != recorded "
                                 "builds")
        for k in ("hash_agg_build", "hash_join_build", "hash_join_probe"):
            if require_each and totals[k] < 1:
                raise AssertionError(f"{phase}: {k} launched no time")
        for k in ("hash_join_build", "hash_join_probe"):
            if sum(r["launches"][k] for r in self.join_rungs.values()) \
                    != totals[k]:
                raise AssertionError(f"{phase}: {k} launches != recorded "
                                     "calls")


def tpch22_phase(root: str, dispatch_log=None):
    """All 22 TPC-H queries as DataFrame code on the card. At the default
    knobs (the cost model decides): per query a counted cold run (every
    count zeroed just before, read just after; no warm run, for time),
    held to the port's host tier on the same files in the same process.
    Then the dispatch pass, per query a counted cold run with
    ``DISPATCH_PASS``, held to the same answer: its hash-agg builds and
    join builds and probes are recorded per rung for the kernel timing.
    Asserts Q1 kept its 8 dense dispatches, the host morsels of each
    default run are exactly those the cost model priced there, and in the
    dispatch pass no fused morsel fell to the host, Q3's group-by never
    took the hash table and ran on the device with the sort strategy
    (in the pass, or in one more run at a 1-row floor when the pass kept
    every partial aggregate under its floor), an argsort was dispatched
    and a per-operator group-by took the hash table."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec_d, rec_k = KernelRecorder(), KernelRecorder("floor4096")
    per_query, totals, ftotals, answers = {}, {}, {}, {}
    for q in range(1, 23):
        name = f"q{q}"
        run = lambda: Q.ALL[q](get).to_pydict()  # noqa: E731
        logged = _env(DAFT_TORCH_DISPATCH_LOG=os.path.join(
            dispatch_log, f"{name}.jsonl")) if dispatch_log else _env()
        with logged:
            cold, cold_s, counts, launches = rec_d.counted(
                f"tpch22 {name}", run)
        decisions = rec_d.decisions
        # the host tier after the card's run, so its files are as warm
        with dtt.execution_config_ctx(device="0"):
            t0 = time.perf_counter()
            host = run()
            host_s = time.perf_counter() - t0
        with _env(**DISPATCH_PASS):
            fl, fl_s, fcounts, flaunches = rec_k.counted(
                f"tpch22 {name}", run)
        _same_answer(f"{name} cold", cold, host)
        _same_answer(f"{name} dispatch pass", fl, host)
        _priced_host_morsels(f"{name} cold", counts, decisions)
        answers[q] = cold
        rec = dict(query=name, cold_s=cold_s, host_s=host_s,
                   rows=len(next(iter(host.values()))),
                   counters={k: counts.get(k, 0) for k in TPCH22_COUNTERS},
                   decisions=decisions, launches=launches,
                   floor4096_cold_s=fl_s,
                   floor4096_counters={k: fcounts.get(k, 0)
                                       for k in TPCH22_COUNTERS},
                   floor4096_launches=flaunches)
        per_query[name] = rec
        for k, v in list(rec["counters"].items()) + list(launches.items()):
            totals[k] = totals.get(k, 0) + v
        for k, v in list(rec["floor4096_counters"].items()) \
                + list(flaunches.items()):
            ftotals[k] = ftotals.get(k, 0) + v
        log("tpch22 " + json.dumps(rec))
    q1 = per_query["q1"]["counters"]
    q3 = per_query["q3"]["floor4096_counters"]
    if q1["dense"] != 8 or q1["agg_hash"] or q1["agg_sort"]:
        raise AssertionError(f"q1 changed route: {q1}")
    # Q3's three group keys (int64, date, int32) pack 131 bits, past the
    # hash table's 128: its group-by takes the sort strategy on the card,
    # as the reference's width check routes it. Since the port plans the
    # reference's exchanges its partial aggregates run per co-partitioned
    # join pair, each under the pass's 4,096-row floor at SF1, so when the
    # pass keeps them all on the host one run at a 1-row floor holds the
    # route
    if q3["agg_hash"]:
        raise AssertionError(f"q3's group-by took the hash table: {q3}")
    if q3["agg_sort"] < 1:
        from daft_tpu_torch.device import runtime
        runtime.reset_counters()
        with _env(DAFT_TORCH_DEVICE_MIN_ROWS="1"):
            got = Q.q3(get).to_pydict()
        c = runtime.counters()
        _same_answer("q3 at a 1-row floor", got, answers[3])
        log("tpch22 q3 at a 1-row floor " + json.dumps(
            {k: c.get(k, 0) for k in TPCH22_COUNTERS}))
        if c.get("agg_sort", 0) < 1 or c.get("agg_hash", 0):
            raise AssertionError(f"q3's group-by did not run on the card "
                                 f"with the sort strategy: {c}")
    for k in ("argsort", "agg_hash", "projection", "predicate"):
        if ftotals[k] < 1:
            raise AssertionError(f"tpch22: no {k} dispatch ({ftotals})")
    if ftotals["host_morsels"]:
        raise AssertionError(f"tpch22 dispatch pass: host-tier morsels "
                             f"({ftotals})")
    rec_k.check_totals("tpch22", ftotals)
    sums = {k: sum(r[k] for r in per_query.values())
            for k in ("cold_s", "host_s", "floor4096_cold_s")}
    log("tpch22 totals " + json.dumps(totals) + "; dispatch pass "
        + json.dumps(ftotals) + "; walls summed " + json.dumps(sums))
    return dict(per_query=per_query, totals=totals, floor_totals=ftotals,
                rungs=rec_k.hash_rungs(), join_rungs=rec_k.join_rungs,
                answers=answers, sums=sums)


def tpchsql_phase(root: str, t22: dict):
    """All 22 TPC-H queries as SQL text (``daft_tpu_torch.sql`` over the
    port's copy of the texts, ``daft_tpu_torch/benchmarking/tpch_sql.py``) on the card:
    per query a counted cold run, held to the TPC-H
    22 phase's answer for that query (keys, counts and strings exact,
    floats at relative 1e-6, where the two forms write an expression
    differently); every comma join turned into an equi-join (no cross
    join left but a scalar subquery's one-row one) and no fused morsel on
    the host. Hash-agg and join launches are recorded per rung; the
    rungs whose shape the TPC-H 22 phase did not already hold are
    returned for phase 8."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_sql
    from daft_tpu_torch.logical.optimizer import unconverted_cross_joins
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec_k = KernelRecorder("floor4096")
    per_query, totals = {}, {}
    for q in range(1, 23):
        name = f"q{q}"
        plan = tpch_sql.run(q, get).builder.optimize().plan
        crosses = unconverted_cross_joins(plan)
        strategies = []

        def walk(n):
            if isinstance(n, (pp.HashJoin, pp.CrossJoin)):
                strategies.append(getattr(n, "strategy", "cross"))
            for ch in n.children:
                walk(ch)
        walk(translate(plan))
        with _env(**DISPATCH_PASS):
            cold, cold_s, counts, launches = rec_k.counted(
                f"tpchsql {name}", lambda: tpch_sql.run(q, get).to_pydict())
        want = t22["answers"][q]
        if len(cold) != len(want):
            raise AssertionError(f"sql {name}: {list(cold)} against "
                                 f"{list(want)}")
        # the SQL texts name some output columns differently: compare by
        # position
        _same_answer(f"sql {name} cold", dict(zip(want, cold.values())),
                     want, rel=1e-6)
        rec = dict(query=name, cold_s=cold_s,
                   df_cold_s=t22["per_query"][name]["floor4096_cold_s"],
                   rows=len(next(iter(want.values()))),
                   counters={k: counts.get(k, 0) for k in TPCH22_COUNTERS},
                   launches=launches, join_strategies=strategies,
                   cross_joins_left=crosses)
        per_query[name] = rec
        for k, v in list(rec["counters"].items()) + list(launches.items()):
            totals[k] = totals.get(k, 0) + v
        log("tpchsql " + json.dumps(rec))
        if crosses:
            raise AssertionError(f"sql {name}: {crosses} cross joins left")
    if totals["host_morsels"]:
        raise AssertionError(f"tpchsql: host-tier morsels ({totals})")
    rec_k.check_totals("tpchsql", totals)
    held = {k[1:] for k in t22["rungs"]}
    jheld = {k[1:] for k in t22["join_rungs"]}
    rungs = {k: v for k, v in rec_k.hash_rungs().items()
             if k[1:] not in held}
    join_rungs = {k: v for k, v in rec_k.join_rungs.items()
                  if k[1:] not in jheld}
    log("tpchsql totals " + json.dumps(totals) + "; cold walls summed "
        f"{sum(r['cold_s'] for r in per_query.values()):.6f} s, the "
        "DataFrame forms' "
        f"{sum(r['df_cold_s'] for r in per_query.values()):.6f} s; rungs "
        f"not held by the TPC-H 22 phase: {len(rungs)} hash, "
        f"{len(join_rungs)} join")
    return dict(per_query=per_query, totals=totals, rungs=rungs,
                join_rungs=join_rungs)


def _join_rungs(query: str, builds: dict, probes: list, rungs: dict):
    """Fold one counted run's join launches into rungs keyed by (query,
    C_r, T, C_l, cap): each rung keeps the first dispatch's inputs, its
    probe launches and each build whose table it probed first, with the
    summed event times."""
    first_probe = set()
    for (code, live, table, cap), (e0, e1) in probes:
        b_args, _, (b0, b1) = builds[id(table)]
        r = rungs.setdefault(
            (query, b_args[0].shape[0], b_args[2], code.shape[0], cap),
            dict(build=b_args, probe=(code, live, cap),
                 launches={"hash_join_build": 0, "hash_join_probe": 0},
                 ms_sum={"hash_join_build": 0.0, "hash_join_probe": 0.0}))
        r["launches"]["hash_join_probe"] += 1
        r["ms_sum"]["hash_join_probe"] += e0.elapsed_time(e1)
        if id(table) not in first_probe:
            first_probe.add(id(table))
            r["launches"]["hash_join_build"] += 1
            r["ms_sum"]["hash_join_build"] += b0.elapsed_time(b1)
    if len(first_probe) != len(builds):
        raise AssertionError(f"{query}: a join table was never probed")


# ------------------------------------------------- memory-bounded phase

#: phase 7f's host budget (``DAFT_TORCH_MEMORY_LIMIT``): small enough
#: that every breaker of the spilled queries outgrows it at SF1
OOC_LIMIT = "64MiB"


def _q3_sort_merge(get):
    """TPC-H Q3 with its lineitem join at ``strategy="sort_merge"``."""
    import daft_tpu_torch as dtt
    col, lit = dtt.col, dtt.lit
    cust = get("customer").where(col("c_mktsegment") == "BUILDING")
    orders = get("orders").where(col("o_orderdate") < lit(Q3_DATE))
    li = get("lineitem").where(col("l_shipdate") > lit(Q3_DATE))
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey")
            .join(li, left_on="o_orderkey", right_on="l_orderkey",
                  strategy="sort_merge")
            .with_column("volume",
                         col("l_extendedprice") * (1 - col("l_discount")))
            .groupby(col("o_orderkey"), col("o_orderdate"),
                     col("o_shippriority"))
            .agg(col("volume").sum().alias("revenue"))
            .sort([col("revenue"), col("o_orderdate")], desc=[True, False])
            .limit(10)
            .select("o_orderkey", "revenue", "o_orderdate",
                    "o_shippriority"))


def _order_by_lineitem(get):
    return get("lineitem").sort(["l_orderkey", "l_linenumber"])


def ooc_phase(root: str):
    """Memory-bounded execution on the SF1 files of phases 5-7, push
    engine, ``cuda``. Forced spill: under ``DAFT_TORCH_MEMORY_LIMIT``
    (``OOC_LIMIT``) TPC-H Q1, Q3, Q9, Q18 and Q21 and a full ``ORDER BY
    l_orderkey, l_linenumber`` over lineitem (the external sort), each
    held to the same query unbounded in this process (keys, counts and
    strings exact, floats at relative 1e-9; the sort's Arrow table
    equal); each must spill bytes (Q1 instead must take the spilling
    reducer: its one breaker holds 4 groups, which no budget can spill),
    and Q3, Q9 and Q21 must join pairs on the card (join launches > 0) with
    every join the cost model priced onto the card run there. Then Q3
    with its lineitem join at ``strategy="sort_merge"`` against the hash
    plan's answer (its bucket pairs launch the join kernels); Q5 and Q8
    at ``enable_aqe=True`` against the default run, with at least one
    re-plan; Q1 and Q3 under ``push`` and ``interp``, walls side by side.
    Slots acquired = released in every counted run. Every counted run's
    hash and join dispatches are recorded per rung (``pass`` ``spill``)."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch import joins
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.execution import memory
    from daft_tpu_torch.physical import adaptive
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec = KernelRecorder("spill")
    device_joins = [0]
    orig_m = joins._device_match_indices

    def counted_join(*a, **k):
        device_joins[0] += 1
        return orig_m(*a, **k)

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def slots_balanced(name, counts):
        if counts.get("pipeline_slots_acquired", 0) \
                != counts.get("pipeline_slots_released", 0):
            raise AssertionError(f"{name}: device slots unbalanced "
                                 f"({counts})")

    def counted(name, fn):
        """``rec.counted`` of ``fn`` with the spill counters and the
        device joins diffed over the same run."""
        device_joins[0] = 0
        joins._device_match_indices = counted_join
        b0 = memory.spill_counters_snapshot()
        try:
            out, s, counts, launches = rec.counted(name, fn)
        finally:
            joins._device_match_indices = orig_m
        return out, s, counts, launches, memory.spill_counters_delta(b0), \
            device_joins[0]

    t_phase = time.perf_counter()
    spilled = [("q1", Q.q1), ("q3", Q.q3), ("q9", Q.q9), ("q18", Q.q18),
               ("q21", Q.q21), ("order_by", _order_by_lineitem)]
    answers = {}
    for name, q in spilled:
        sort = name == "order_by"
        run = (lambda q=q: q(get).to_arrow()) if sort \
            else (lambda q=q: q(get).to_pydict())
        _clear_device_cache()
        want, unbounded_s = wall(run)
        with _env(DAFT_TORCH_MEMORY_LIMIT=OOC_LIMIT):
            got, s, counts, launches, spill, djoins = counted(
                f"ooc {name}", run)
        decisions = rec.decisions
        if sort:
            if not got.equals(want):
                raise AssertionError("ooc order_by: the spilled sort differs "
                                     "from the unbounded one")
        else:
            _same_answer(f"ooc {name}", got, want)
            answers[name] = want
        if name == "q1":
            if not spill.get("agg_reducers_spilling"):
                raise AssertionError(f"ooc q1: the spilling reducer did not "
                                     f"run ({spill})")
        elif spill.get("bytes_written", 0) <= 0:
            raise AssertionError(f"ooc {name}: nothing spilled under "
                                 f"{OOC_LIMIT} ({spill})")
        priced = decisions.get("join", {}).get("device", 0)
        if name in ("q3", "q9", "q21"):
            if launches["hash_join_build"] < 1 or djoins < 1:
                raise AssertionError(f"ooc {name}: no join pair on the card "
                                     f"({launches}, {counts})")
        if djoins != priced:
            raise AssertionError(f"ooc {name}: {priced} joins priced onto "
                                 f"the card, {djoins} ran there")
        slots_balanced(f"ooc {name}", counts)
        log("ooc " + json.dumps(dict(
            query=name, limit=OOC_LIMIT, spilled_s=s,
            unbounded_s=unbounded_s, spill=spill, device_joins=djoins,
            launches=launches,
            counters={k: counts.get(k, 0) for k in TPCH22_COUNTERS},
            decisions=decisions)))
    # ---- the sort-merge join
    _clear_device_cache()
    got, s, counts, launches, spill, djoins = counted(
        "ooc q3 sort_merge", lambda: _q3_sort_merge(get).to_pydict())
    _same_answer("ooc q3 sort_merge", got, answers["q3"])
    if launches["hash_join_build"] < 1 or launches["hash_join_probe"] < 1:
        raise AssertionError(f"ooc q3 sort_merge: the bucket pairs launched "
                             f"no join kernel ({launches}, {counts})")
    slots_balanced("ooc q3 sort_merge", counts)
    log("ooc " + json.dumps(dict(
        query="q3 sort_merge", wall_s=s, spill=spill, device_joins=djoins,
        launches=launches,
        counters={k: counts.get(k, 0) for k in TPCH22_COUNTERS})))
    # ---- AQE
    for q in (5, 8):
        _clear_device_cache()
        want, default_s = wall(lambda: Q.ALL[q](get).to_pydict())
        a0 = adaptive.counters_snapshot()
        with dtt.execution_config_ctx(enable_aqe=True):
            got, s, counts, launches, spill, djoins = counted(
                f"ooc aqe q{q}", lambda: Q.ALL[q](get).to_pydict())
        replans = adaptive.counters_delta(a0)
        _same_answer(f"ooc aqe q{q}", got, want)
        if replans.get("replans", 0) < 1:
            raise AssertionError(f"ooc aqe q{q}: no re-plan ({replans})")
        slots_balanced(f"ooc aqe q{q}", counts)
        log("ooc " + json.dumps(dict(
            query=f"q{q} aqe", aqe_s=s, default_s=default_s,
            adaptive=replans, report=adaptive.last_planner()
            .explain_analyze().splitlines()[1:], launches=launches)))
    # ---- push against interp
    for name in ("q1", "q3"):
        row = {}
        for engine in ("push", "interp"):
            _clear_device_cache()
            with _env(DAFT_TORCH_LOCAL_EXECUTOR=engine):
                got, s, counts, launches, spill, djoins = counted(
                    f"ooc {name} {engine}", lambda: Q.QUERIES[name](get)
                    .to_pydict())
            _same_answer(f"ooc {name} {engine}", got, answers[name])
            slots_balanced(f"ooc {name} {engine}", counts)
            row[engine] = dict(wall_s=s, launches=launches,
                               counters={k: counts.get(k, 0)
                                         for k in TPCH22_COUNTERS})
        log("ooc " + json.dumps(dict(query=f"{name} push vs interp", **row)))
    log(f"ooc phase wall: {time.perf_counter() - t_phase:.3f} s")
    return dict(rec=rec)


# ------------------------------------------------------------ pivot

def _by_flag(d: dict, modes) -> dict:
    """A pivot's answer with its rows sorted by ``l_returnflag`` and its
    pivot columns by name (their order is the distinct query's)."""
    order = sorted(range(len(d["l_returnflag"])),
                   key=lambda i: d["l_returnflag"][i])
    return {c: [d[c][i] for i in order]
            for c in ["l_returnflag"] + sorted(modes)}


def pivot_phase(root: str):
    """Phase 7g: ``lineitem`` at SF1 pivoted by ``l_shipmode`` per
    ``l_returnflag`` on the card, against the host tier, then unpivoted
    back against a plain group-by; the same pivot through the hash-agg
    kernel."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch import col
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec = KernelRecorder("pivot")

    def pivot():
        return get("lineitem").pivot("l_returnflag", "l_shipmode",
                                     "l_extendedprice", "sum")

    def wide_answer():
        d = pivot().to_pydict()
        return d, [c for c in d if c != "l_returnflag"]

    t_phase = time.perf_counter()
    (wide, modes), dev_s, counts, launches = rec.counted("pivot", wide_answer)
    if len(modes) != 7 or len(wide["l_returnflag"]) != 3:
        raise AssertionError(f"pivot: {len(wide['l_returnflag'])} flags x "
                             f"{modes}, not 3 x 7 ship modes")
    with dtt.execution_config_ctx(device="0"):
        t0 = time.perf_counter()
        host, host_modes = wide_answer()
        host_s = time.perf_counter() - t0
    if sorted(host_modes) != sorted(modes):
        raise AssertionError(f"pivot: ship modes {modes} vs host "
                             f"{host_modes}")
    _same_answer("pivot vs host tier", _by_flag(wide, modes),
                 _by_flag(host, modes))
    # forced through the hand-written hash-agg kernel
    with _env(DAFT_TORCH_KERNEL_GROUPBY="hash"):
        (hwide, hmodes), hash_s, hcounts, hlaunches = rec.counted(
            "pivot hash", wide_answer)
    if hlaunches["hash_agg_build"] < 1:
        raise AssertionError(f"pivot hash: the hash-agg kernel launched no "
                             f"time ({hlaunches}, {hcounts})")
    _same_answer("pivot hash vs host tier", _by_flag(hwide, hmodes),
                 _by_flag(host, modes))
    # back to long, against a plain group-by on the card
    t0 = time.perf_counter()
    long = dtt.from_pydict(wide).unpivot(
        "l_returnflag", modes, "l_shipmode", "s") \
        .where(col("s").not_null()).to_pydict()
    unpivot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = get("lineitem").groupby("l_returnflag", "l_shipmode").agg(
        col("l_extendedprice").sum().alias("s")).to_pydict()
    groupby_s = time.perf_counter() - t0

    def keyed(d):
        return {(f, m): v for f, m, v in zip(d["l_returnflag"],
                                             d["l_shipmode"], d["s"])}
    lk, pk = keyed(long), keyed(plain)
    if sorted(lk) != sorted(pk) or len(lk) != len(long["s"]):
        raise AssertionError(f"unpivot: groups {sorted(lk)} vs "
                             f"{sorted(pk)}")
    for k in pk:
        if not _close(lk[k], pk[k], 1e-9):
            raise AssertionError(f"unpivot {k}: {lk[k]!r} vs {pk[k]!r}")
    strategies = ("dense", "hash", "sort", "agg_hash", "agg_sort",
                  "host_morsels", "host_ops")
    log("pivot " + json.dumps(dict(
        rows=pq_rows(os.path.join(root, "lineitem")), flags=3,
        ship_modes=sorted(modes), device_s=dev_s, host_s=host_s,
        hash_s=hash_s, unpivot_s=unpivot_s, groupby_s=groupby_s,
        long_rows=len(long["s"]),
        strategy={k: counts.get(k, 0) for k in strategies},
        launches=launches,
        hash_strategy={k: hcounts.get(k, 0) for k in strategies},
        hash_launches=hlaunches)))
    log(f"pivot phase wall: {time.perf_counter() - t_phase:.3f} s")
    return dict(rec=rec)


# ------------------------------------------------------------ fuzz

#: phase 7h: the fuzzer's modes on the card, the least seeds per mode, and
#: the phase's time budget (more seeds run while it lasts)
FUZZ_MODES = ("optimized", "device", "bounded", "fused", "replanned")
FUZZ_MIN_SEEDS = 100
FUZZ_BUDGET_S = 30.0


def fuzz_phase():
    """Phase 7h: the differential plan fuzzer on the card, each mode
    against the port's own unoptimized host run (``run_reference``), with
    the plan sanitizer armed (each line's ``sanitizer_violations``)."""
    from daft_tpu_torch.analysis import plan_fuzzer as PF
    rec = KernelRecorder("fuzz")
    t_phase = time.perf_counter()
    per_mode, failed = {}, []
    totals = dict(hash_agg_build=0, hash_join_build=0, hash_join_probe=0)
    for mode in FUZZ_MODES:
        res, wall, _, launches = rec.counted(
            f"fuzz {mode}", lambda: PF.run_fuzz(
                count=FUZZ_MIN_SEEDS, seed=0, modes=(mode,),
                budget_s=FUZZ_BUDGET_S / len(FUZZ_MODES)))
        mode_launches = {k: launches[k] for k in totals}
        _add(totals, mode_launches)
        c = res.per_mode[mode]
        per_mode[mode] = dict(mode=mode, seeds=res.seeds_run,
                              compared=c["cases"],
                              mismatches=c["mismatches"],
                              errors=c["errors"] + len(res.errors),
                              sanitizer_violations=res.sanitizer_violations,
                              launches=mode_launches, wall_s=wall)
        log("fuzz " + json.dumps(per_mode[mode]))
        for m in res.mismatches:
            log("fuzz MISMATCH\n" + m.repro())
        for e in res.errors:
            log(f"fuzz error: {e}")
        for v in res.sanitizer_detail:
            log(f"fuzz plan-sanitizer violation: {v}")
        if res.mismatches or res.errors or res.sanitizer_violations:
            failed.append(mode)
    if failed:
        raise AssertionError(f"fuzz: mismatches, errors or plan-sanitizer "
                             f"violations in {failed}")
    dev = per_mode["device"]["launches"]
    if min(dev.values()) < 1:
        raise AssertionError(f"fuzz device mode: a kernel launched no time "
                             f"({dev})")
    rec.check_totals("fuzz", totals, require_each=False)
    log(f"fuzz phase wall: {time.perf_counter() - t_phase:.3f} s")
    return dict(rec=rec, per_mode=per_mode)


# ------------------------------------------------------------ remote scan

#: phase 7i: the object store's fixed delay per request (the default of
#: ``bench.py``'s scan bench, ``BENCH_SCAN_DELAY_MS``: an object store's
#: round trip), the rounds (one cold run of each query each way per
#: round), and the two ways each query runs
REMOTE_DELAY_S = 0.015
REMOTE_ROUNDS = 3
REMOTE_WAYS = {
    "planned": {},
    "naive": dict(DAFT_TORCH_IO_PLANNED_READS="0",
                  DAFT_TORCH_SCAN_PREFETCH="0")}
REMOTE_COUNTERS = ("gets", "ranges_planned", "range_requests",
                   "bytes_fetched", "bytes_used", "prefetch_tasks",
                   "planned_read_fallbacks")


def remote_phase(root: str, ref: dict, q3_ref, card: str):
    """Phase 7i: Q1, the ``l_suppkey`` group-by, Q6 and Q3 over the SF1
    parquet served by a local HTTP object store (``FileStore``: HEAD and
    ranged GETs read by seeking in the files, ``REMOTE_DELAY_S`` per
    request), cold, each way of ``REMOTE_WAYS``: the defaults (planned
    range reads, prefetch 2) and the naive reads with no prefetch;
    ``REMOTE_ROUNDS`` rounds, the ways' order turned each round. Every
    answer is held to pyarrow over the local files as on the main path;
    then the write path (:func:`remote_write`)."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.benchmarking.http_store import FileStore
    from daft_tpu_torch.io import read_planner as rp
    rec = KernelRecorder("remote")
    t_phase = time.perf_counter()
    runs = {}
    with FileStore(root, delay_s=REMOTE_DELAY_S) as store:
        urls = {t: store.urls(t) for t in
                ("lineitem", "orders", "customer")}
        get = lambda t: dtt.read_parquet(urls[t])  # noqa: E731
        for rnd in range(REMOTE_ROUNDS):
            ways = list(REMOTE_WAYS)[::1 if rnd % 2 == 0 else -1]
            for name in ("q1", "suppkey_agg", "q6", "q3"):
                for way in ways:
                    with _env(**REMOTE_WAYS[way]):
                        g0, b0 = store.counts(), rp.scan_counters_snapshot()
                        got, wall, counts, launches = rec.counted(
                            f"remote {name} {way}",
                            lambda: Q.QUERIES[name](get).to_pydict())
                        d, g1 = rp.scan_counters_delta(b0), store.counts()
                    if name == "q3":
                        check_table(f"remote q3 {way}", got, q3_ref[0],
                                    ["o_orderkey"],
                                    ["o_orderdate", "o_shippriority"],
                                    ["revenue"])
                    else:
                        check_answer(name, got, ref)
                    if way == "planned" and (d.get("planned_read_fallbacks")
                                             or not d.get("range_requests")):
                        raise AssertionError(f"remote {name}: the planned "
                                             f"reads fell back ({d})")
                    if name == "suppkey_agg" \
                            and launches["hash_agg_build"] < 1:
                        raise AssertionError(
                            f"remote {name} {way}: the hash-agg kernel "
                            f"launched no time ({counts})")
                    if name == "q3" and min(launches["hash_join_build"],
                                            launches["hash_join_probe"]) < 1:
                        raise AssertionError(
                            f"remote q3 {way}: the join kernels did not "
                            f"launch ({launches}, {counts})")
                    runs.setdefault((name, way), []).append(dict(
                        wall=wall, scan=d, launches=launches, counts=counts,
                        gets=g1["gets"] - g0["gets"],
                        heads=g1["heads"] - g0["heads"],
                        sent=g1["bytes_sent"] - g0["bytes_sent"]))
    lines = []
    for (name, way), rs in runs.items():
        first, d = rs[0], rs[0]["scan"]
        line = dict(
            query=name, way=way, card=card,
            wall_s=statistics.median(r["wall"] for r in rs),
            walls=[r["wall"] for r in rs], server_gets=first["gets"],
            server_heads=first["heads"], server_bytes=first["sent"],
            scan={k: d.get(k, 0) for k in REMOTE_COUNTERS},
            scan_task_us=d.get("scan_task_us", 0),
            scan_span_us=d.get("scan_span_us", 0),
            launches=first["launches"],
            strategy={k: first["counts"].get(k, 0) for k in (
                "dense", "hash", "sort", "global", "join_hash",
                "join_sort", "host_joins", "host_morsels")})
        log("remote " + json.dumps(line))
        lines.append(line)
    write = remote_write(root, ref, card)
    log(f"remote phase wall: {time.perf_counter() - t_phase:.3f} s")
    return dict(rec=rec, lines=lines, write=write)


def remote_write(root: str, ref: dict, card: str) -> dict:
    """Phase 7i's write path: Q1's answer as parquet and as CSV, read
    back equal (and equal to pyarrow's); three columns of one lineitem
    file hive-partitioned by ``l_returnflag``, read back with the
    source's per-flag counts."""
    import tempfile

    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_write") as out:
        # one answer, written twice (a second run of Q1 could sum its
        # floats in another order on the card)
        q1 = Q.q1(lambda t: dtt.read_parquet(os.path.join(root, t))) \
            .collect()
        keys = ["l_returnflag", "l_linestatus"]
        res_pq = q1.write_parquet(os.path.join(out, "q1_pq")).to_pydict()
        res_csv = q1.write_csv(os.path.join(out, "q1_csv")).to_pydict()
        back_pq = dtt.read_parquet(os.path.join(out, "q1_pq")) \
            .sort(keys).to_pydict()
        back_csv = dtt.read_csv(os.path.join(out, "q1_csv", "*.csv")) \
            .sort(keys).to_pydict()
        _same_answer("write q1 csv vs parquet", back_csv, back_pq, rel=0.0)
        check_answer("q1", back_pq, ref)
        # one lineitem file, three columns, hive-partitioned by its flag
        src = sorted(os.listdir(os.path.join(root, "lineitem")))[0]
        li = dtt.read_parquet(os.path.join(root, "lineitem", src)) \
            .select("l_returnflag", "l_orderkey", "l_extendedprice")
        res_part = li.write_parquet(os.path.join(out, "li_part"),
                                    partition_cols=["l_returnflag"]) \
            .to_pydict()
        back = dtt.read_parquet(os.path.join(out, "li_part", "**",
                                             "*.parquet"),
                                hive_partitioning=True)
        counts_back = back.groupby("l_returnflag").agg(
            dtt.col("l_orderkey").count().alias("n")).sort(
            "l_returnflag").to_pydict()
        counts_src = li.groupby("l_returnflag").agg(
            dtt.col("l_orderkey").count().alias("n")).sort(
            "l_returnflag").to_pydict()
        if counts_back != counts_src or len(counts_src["n"]) != 3:
            raise AssertionError(f"hive write: {counts_back} vs "
                                 f"{counts_src}")
        flags = sorted(os.listdir(os.path.join(out, "li_part")))
    write = dict(card=card, wall_s=time.perf_counter() - t0,
                 q1_parquet_files=len(res_pq["path"]),
                 q1_csv_files=len(res_csv["path"]),
                 partitioned_files=len(res_part["path"]),
                 partition_dirs=flags, rows_per_flag=counts_src)
    log("remote write " + json.dumps(write))
    return write


# ------------------------------------------------------------ observability

#: phase 7j: the queries traced and profiled cold; per wrapper, its
#: entry (the profiler range around each call,
#: ``observability.kernel_range``) and the hand-written kernels it
#: launches as the profiler names them, the first one launched once per
#: call that launches any; the overhead pairs; and the queries of the
#: per-query lanes (those the push engine's partitioned plans slowed the
#: most against the gathered ones)
OBS_QUERIES = ("q1", "suppkey_agg", "q3")
OBS_KERNELS = {
    "hash_agg_build": ("daft_hash_agg_build", (
        "hash_agg_init_kernel", "hash_agg_build_kernel")),
    "hash_join_build": ("daft_hash_join_build", (
        "build_init_kernel", "build_count_kernel", "build_scan_kernel",
        "build_scatter_kernel", "build_order_kernel", "build_merge_kernel")),
    "hash_join_probe": ("daft_hash_join_probe", (
        "probe_count_kernel", "probe_emit_kernel"))}
OBS_PAIRS = 3
OBS_LANE_QUERIES = (2, 3, 4, 5, 8, 9, 17, 20)


def _dk_counts(stats) -> dict:
    """A query's ``device kernels`` block as {family: (dispatches,
    rows)}: what two runs of one query must share (not the seconds)."""
    return {k: (d["dispatches"], d["rows"])
            for k, d in sorted(stats.device_kernels.items())}


def _profile_kernels(path: str) -> dict:
    """Per wrapper, from an exported torch.profiler trace: ``calls``, its
    entry's ranges; ``named``, the events of its first kernel by name;
    ``lost``, calls whose first launch (a ``cudaLaunchKernel`` inside the
    range) has no kernel record, which the profiler dropped; ``empty``,
    calls with no launch record (a probe of 0 rows, or a launch whose
    runtime record the profiler dropped); ``orphans``, the named first
    kernels with no launch record (so counted in ``named`` and, by their
    call, in ``empty``); ``kernel_us``, the summed time of its kernels by
    name."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    recorded = {e["args"]["correlation"] for e in events
                if e.get("cat") == "kernel" and "correlation" in
                e.get("args", {})}
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaLaunchKernel"]
    launched = {e["args"].get("correlation") for e in runtime}
    out = {}
    for w, (entry, knames) in OBS_KERNELS.items():
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == f"daft_torch::{entry}"]
        lost = empty = 0
        for r in ranges:
            inside = sorted((e["ts"], e["args"].get("correlation"))
                            for e in runtime if e["tid"] == r["tid"]
                            and r["ts"] <= e["ts"] <= r["ts"] + r["dur"])
            if not inside:
                empty += 1
            elif inside[0][1] not in recorded:
                lost += 1
        named, orphans, us = 0, 0, 0.0
        for e in events:
            name = e.get("name", "")
            if e.get("cat") == "kernel" and any(k in name for k in knames):
                if knames[0] in name:
                    named += 1
                    orphans += e.get("args", {}).get("correlation") \
                        not in launched
                us += float(e.get("dur", 0))
        out[w] = dict(calls=len(ranges), named=named, lost=lost,
                      empty=empty, orphans=orphans, kernel_us=us)
    return out


def _log_profile_mismatch(path: str, name: str, wrapper: str) -> None:
    """For a capture whose calls disagree with the launch count: the
    wrapper's kernel events with their times, against the capture's first
    and last event."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ts = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
    kern = [(e["ts"], e.get("dur"), e.get("name", "")[:60]) for e in events
            if e.get("cat") == "kernel"
            and any(k in e.get("name", "") for k in OBS_KERNELS[wrapper][1])]
    log("obs mismatch " + json.dumps(dict(
        query=name, wrapper=wrapper, first_ts=min(ts), last_ts=max(ts),
        events=len(events), kernels=kern)))


def _lanes(rec) -> dict:
    """Span time summed per lane and the five span names with the most
    summed time (the root excluded), in ms."""
    lanes, names = {}, {}
    for sp in rec.spans():
        if sp["name"] == "query":
            continue
        ms = sp["dur_us"] / 1e3
        lanes[sp["lane"]] = lanes.get(sp["lane"], 0.0) + ms
        names[sp["name"]] = names.get(sp["name"], 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    return dict(lanes_ms=lanes, top5_ms=dict(top))


def obs_phase(root: str, ref: dict, q3_ref, card: str):
    """Phase 7j: the observability plane on the card. Q1, the
    ``l_suppkey`` group-by and Q3, cold, through ``explain(analyze=True)``
    with ``DAFT_TORCH_TRACE=1``, a trace directory and
    ``DAFT_TORCH_PROFILE_DIR``: answers held to pyarrow, the analyzed
    root's rows equal to the answer's, valid Chrome traces with no orphan
    span, one ``device:grouped_agg`` / ``device:join`` span per dispatch of
    the query's ``device kernels`` block, the hash dispatches of the
    group-by equal to the hash-agg launches, Q3's 16 join builds and
    probes, and each hand-written kernel's calls in the profiler's trace
    (:func:`_profile_kernels`) equal to its wrapper's launch count. Then
    Q1 and the group-by at once on two threads (each block equal to its
    solo run's), the dashboard's ``/metrics`` scraped with the strict
    parser (its kernel counters at least this phase's dispatches), the
    overhead of tracing (Q1 on a warm cache and Q3, off against on,
    interleaved pairs; reported, not gated), and one ``lanes`` line per
    query of ``OBS_LANE_QUERIES``."""
    import contextlib
    import io as _io
    import tempfile
    import threading
    import urllib.request

    import daft_tpu_torch as dtt
    from daft_tpu_torch import dashboard, tracing
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec_k = KernelRecorder("obs")
    t_phase = time.perf_counter()
    solo, phase_dispatches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs") as tmp:
        tdir, pdir = os.path.join(tmp, "trace"), os.path.join(tmp, "prof")
        with _env(DAFT_TORCH_TRACE="1", DAFT_TORCH_TRACE_DIR=tdir,
                  DAFT_TORCH_PROFILE_DIR=pdir):
            for name in OBS_QUERIES:
                df = Q.QUERIES[name](get)
                printed = _io.StringIO()

                def run():
                    with contextlib.redirect_stdout(printed):
                        df.explain(analyze=True)
                    return df.to_pydict()
                got, wall, counts, launches = rec_k.counted(
                    f"obs {name}", run)
                if name == "q3":
                    check_table("obs q3", got, q3_ref[0], ["o_orderkey"],
                                ["o_orderdate", "o_shippriority"],
                                ["revenue"])
                else:
                    check_answer(name, got, ref)
                st = df._stats
                n_rows = len(next(iter(got.values())))
                root_rows = st._ops[id(st.plan)].rows_out
                if root_rows != n_rows:
                    raise AssertionError(f"obs {name}: analyzed root rows "
                                         f"{root_rows} != {n_rows}")
                text = printed.getvalue()
                for head in ("== Physical Plan (analyzed) ==",
                             "device kernels", "trace: id="):
                    if head not in text:
                        raise AssertionError(f"obs {name}: no {head!r} in "
                                             f"the render:\n{text}")
                rec = st.trace_ctx.recorder
                path = os.path.join(tdir, f"trace_{rec.trace_id}.json")
                with open(path) as f:
                    doc = json.load(f)
                bad = tracing.validate_chrome_trace(doc)
                orphans = tracing.orphan_spans(rec)
                if bad or orphans or rec.dropped:
                    raise AssertionError(f"obs {name}: trace problems "
                                         f"{bad[:5]}, orphans "
                                         f"{orphans[:5]}, dropped "
                                         f"{rec.dropped}")
                dk = st.device_kernels
                spans = {}
                for sp in rec.spans():
                    if sp["lane"] == "device":
                        spans[sp["name"]] = spans.get(sp["name"], 0) + 1
                for kind in ("grouped_agg", "join"):
                    want = dk.get(kind, {}).get("dispatches", 0)
                    if spans.get(f"device:{kind}", 0) != want:
                        raise AssertionError(
                            f"obs {name}: {spans.get(f'device:{kind}', 0)}"
                            f" device:{kind} spans, {want} dispatches")
                hash_n = int(st._plane("device_kernels").get(
                    "grouped_agg\x00strategy_hash", 0))
                if name == "suppkey_agg" and \
                        hash_n != launches["hash_agg_build"]:
                    raise AssertionError(
                        f"obs {name}: {hash_n} hash dispatches, "
                        f"{launches['hash_agg_build']} hash-agg launches")
                if name == "q3" and (launches["hash_join_build"] != 16
                                     or launches["hash_join_probe"] != 16):
                    raise AssertionError(f"obs q3: join launches "
                                         f"{launches}, expected 16 and 16")
                if not st.profile_path:
                    raise AssertionError(f"obs {name}: no profiler trace")
                # every wrapper call in the capture, each launch seen by
                # its kernel's name or as a launch whose kernel or launch
                # record the profiler dropped (counted, shown in the line;
                # a named kernel whose launch record was dropped is in
                # both ``named`` and ``empty``)
                prof = _profile_kernels(st.profile_path)
                for w, p in prof.items():
                    n = launches[w]
                    if p["calls"] != n or p["named"] - p["orphans"] \
                            + p["lost"] + p["empty"] != n or \
                            (n and not p["named"]):
                        _log_profile_mismatch(st.profile_path, name, w)
                        raise AssertionError(
                            f"obs {name}: the profiler shows {p} for the "
                            f"{w} wrapper, which counted {n} launches")
                solo[name] = _dk_counts(st)
                for k, (n, _rows) in solo[name].items():
                    phase_dispatches[k] = phase_dispatches.get(k, 0) + n
                log("obs " + json.dumps(dict(
                    query=name, card=card, wall_s=wall,
                    analyzed_root_rows=root_rows, spans=len(rec.spans()),
                    device_spans=spans, device_kernels=solo[name],
                    hash_dispatches=hash_n, launches=launches,
                    profile_kernels=prof,
                    profile_bytes=os.path.getsize(st.profile_path),
                    trace_bytes=os.path.getsize(path),
                    render_blocks=[ln for ln in text.splitlines()
                                   if ln and not ln.startswith(" ")
                                   and ln.endswith(":")])))
        # two queries at once: each block equal to its solo run's
        got, errors = {}, []
        barrier = threading.Barrier(2)

        def one(name):
            try:
                df = Q.QUERIES[name](get)
                barrier.wait()
                df.collect()
                got[name] = _dk_counts(df._stats)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)
        _clear_device_cache()
        threads = [threading.Thread(target=one, args=(n,))
                   for n in ("q1", "suppkey_agg")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for name in ("q1", "suppkey_agg"):
            if got[name] != solo[name]:
                raise AssertionError(f"obs concurrent {name}: "
                                     f"{got[name]} != solo {solo[name]}")
            for k, (n, _rows) in got[name].items():
                phase_dispatches[k] = phase_dispatches.get(k, 0) + n
        log("obs concurrent " + json.dumps(dict(card=card, **got)))
    # the dashboard's Prometheus scrape, strictly parsed
    port = dashboard.launch(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            metrics = tracing.parse_prometheus_text(r.read().decode())
    finally:
        dashboard.shutdown()
    for kind, n in phase_dispatches.items():
        name = f"daft_torch_kernel_{kind}_dispatches_total"
        if metrics.get(name, 0) < n:
            raise AssertionError(f"/metrics {name} = {metrics.get(name)} "
                                 f"< this phase's {n}")
    log("obs metrics " + json.dumps(dict(
        n_metrics=len(metrics), phase_dispatches=phase_dispatches,
        kernel={k: v for k, v in metrics.items()
                if k.startswith("daft_torch_kernel_")})))
    # tracing's cost: Q1 on a warm device cache and Q3, off against on
    # (span recording and the trace file), interleaved pairs
    over = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs") as tdir:
        for name in ("q1", "q3"):
            Q.QUERIES[name](get).to_pydict()   # warm
            walls = {"off": [], "on": []}
            for i in range(OBS_PAIRS):
                for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                    env = dict(DAFT_TORCH_TRACE="1",
                               DAFT_TORCH_TRACE_DIR=tdir) \
                        if mode == "on" else dict(DAFT_TORCH_TRACE="0")
                    with _env(**env):
                        t0 = time.perf_counter()
                        Q.QUERIES[name](get).to_pydict()
                        walls[mode].append(time.perf_counter() - t0)
            over[name] = {m: dict(median_s=statistics.median(w),
                                  min_s=min(w), max_s=max(w), walls=w)
                          for m, w in walls.items()}
            over[name]["on_over_off"] = over[name]["on"]["median_s"] / \
                over[name]["off"]["median_s"]
    log("obs overhead " + json.dumps(dict(card=card, pairs=OBS_PAIRS,
                                          **over)))
    # where each of the queries the partitioned plans slowed spends its
    # time, by lane
    with _env(DAFT_TORCH_TRACE="1"):
        for q in OBS_LANE_QUERIES:
            _clear_device_cache()
            df = Q.ALL[q](get)
            t0 = time.perf_counter()
            df.collect()
            wall = time.perf_counter() - t0
            st = df._stats
            ops = sorted(((s["name"], s["attrs"]["self_us"] / 1e3)
                          for s in st.trace_ctx.recorder.spans()
                          if s["name"].startswith("op:")),
                         key=lambda kv: -kv[1])[:5]
            log("lanes " + json.dumps(dict(
                query=f"q{q}", card=card, wall_s=wall,
                **_lanes(st.trace_ctx.recorder),
                top5_op_self_ms=[list(o) for o in ops],
                device_kernels=_dk_counts(st))))
    log(f"obs phase wall: {time.perf_counter() - t_phase:.3f} s")
    return dict(rec=rec_k, solo=solo, overhead=over)



# ------------------------------------------------------- sanitizers armed

#: phase 7k: the queries run twice armed (a first run on a cleared device
#: column cache, then a repeat on the warm one), the memory-bounded Q3's
#: host budget, the knobs that arm the three sanitizers, and the child's
#: time limit
SANITIZE_QUERIES = ("q1", "suppkey_agg", "q3", "q9")
SANITIZE_LIMIT = "64MiB"
SANITIZE_ENV = dict(DAFT_TORCH_SANITIZE="1", DAFT_TORCH_SANITIZE_PLAN="1",
                    DAFT_TORCH_SANITIZE_RETRACE="1")
SANITIZE_TIMEOUT_S = 300
#: the hand-written kernels' own retrace sites (each wrapper's scope)
KERNEL_SITES = {"hash_agg_build": "hash_agg.build",
                "hash_join_build": "hash_join.build",
                "hash_join_probe": "hash_join.probe"}


def _sanitize_query(name: str):
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    return Q.QUERIES[name] if name in Q.QUERIES else Q.ALL[int(name[1:])]


def _site_delta(before: dict, after: dict) -> dict:
    """Per retrace site, what one run added: entries, new segments, new
    pinned blocks and the hand-written kernels' launches."""
    out = {}
    for site, n in after["site_entries"].items():
        d = dict(entries=n - before["site_entries"].get(site, 0),
                 segments=after["site_segments"].get(site, 0)
                 - before["site_segments"].get(site, 0),
                 pinned=after["site_pinned"].get(site, 0)
                 - before["site_pinned"].get(site, 0))
        launches = {k: v - before["site_launches"].get(site, {}).get(k, 0)
                    for k, v in after["site_launches"].get(site, {}).items()}
        d["launches"] = {k: v for k, v in launches.items() if v}
        if d["entries"] or d["segments"] or d["pinned"] or d["launches"]:
            out[site] = d
    return out


def _moved(x, device: str):
    """``x`` with every tensor in its lists and plain tuples on
    ``device`` (a rung's recorded inputs, across the child process)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, list):
        return [_moved(v, device) for v in x]
    if type(x) is tuple:
        return tuple(_moved(v, device) for v in x)
    return x


def _host_blocks():
    """(pinned blocks torch's host allocator made so far, of them the
    port's transfer pool's buffers)."""
    import torch
    from daft_tpu_torch.device import column
    return (torch.cuda.host_memory_stats().get("num_host_alloc", 0),
            column._pinned.counters["allocated"])


def sanitize_child(root: str, out_dir: str) -> int:
    """Phase 7k's armed process (``--sanitize-child``): the sanitizers were
    armed by ``daft_tpu_torch/__init__`` before any engine import. Writes
    the answers (pickle) and the recorded rungs' inputs (torch, on the
    CPU) to ``out_dir`` and prints one ``SANITIZE_RESULT`` JSON line."""
    import gc
    import pickle
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.analysis import (lock_sanitizer as LS,
                                         plan_sanitizer as PS,
                                         retrace_sanitizer as RS)
    from daft_tpu_torch.device import cuda_build
    from daft_tpu_torch.execution import memory
    armed = [LS.is_enabled(), PS.is_enabled(), RS.is_enabled()]
    if not all(armed):
        raise AssertionError(f"sanitize: not armed {armed}")
    cuda_build.library()
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec = KernelRecorder("sanitize")
    runs, answers = {}, {}
    for name in SANITIZE_QUERIES:
        run = lambda name=name: _sanitize_query(name)(get).to_pydict()  # noqa: E731,E501
        for way, clear in (("first", True), ("repeat", False)):
            s0, p0 = RS.summary(), PS.summary()
            h0 = _host_blocks()
            ans, wall, _, launches = rec.counted(f"sanitize {name}", run,
                                                 clear=clear)
            h1 = _host_blocks()
            # the repeat must find the first run's blocks free: the
            # recorded inputs moved off the card, the garbage cycles that
            # still hold device planes or pooled pinned buffers collected
            # and the card idle
            rec.to_host()
            gc.collect()
            torch.cuda.synchronize()
            s1, p1 = RS.summary(), PS.summary()
            answers[(name, way)] = ans
            runs[f"{name} {way}"] = dict(
                wall_s=wall, launches=launches,
                events=s1["events"] - s0["events"],
                repeat_entries=s1["repeat_entries"] - s0["repeat_entries"],
                sites=_site_delta(s0, s1),
                # pinned blocks the whole process allocated in the run,
                # and how many of them were the transfer pool's
                host_blocks=h1[0] - h0[0], pool_buffers=h1[1] - h0[1],
                plan_checks={k: p1[k] - p0[k] for k in (
                    "rule_checks", "membership_parts", "order_parts",
                    "conservation_checks")})
    # Q3 under a host budget: grace pairs and the spill stores' locks
    sp0 = memory.spill_counters_snapshot()
    s0, p0 = RS.summary(), PS.summary()
    with _env(DAFT_TORCH_MEMORY_LIMIT=SANITIZE_LIMIT):
        ans, wall, _, launches = rec.counted(
            "sanitize q3 bounded",
            lambda: _sanitize_query("q3")(get).to_pydict())
    s1, p1 = RS.summary(), PS.summary()
    answers[("q3", "bounded")] = ans
    runs["q3 bounded"] = dict(
        wall_s=wall, launches=launches, events=s1["events"] - s0["events"],
        repeat_entries=s1["repeat_entries"] - s0["repeat_entries"],
        sites=_site_delta(s0, s1),
        spill=memory.spill_counters_delta(sp0),
        plan_checks={k: p1[k] - p0[k] for k in (
            "rule_checks", "membership_parts", "order_parts",
            "conservation_checks")})
    hash_rungs = {k: dict(v, args=_moved(v["args"], "cpu"))
                  for k, v in rec.hash_rungs().items()}
    join_rungs = {k: dict(v, build=_moved(v["build"], "cpu"),
                          probe=_moved(v["probe"], "cpu"))
                  for k, v in rec.join_rungs.items()}
    torch.save({"hash": hash_rungs, "join": join_rungs},
               os.path.join(out_dir, "rungs.pt"))
    with open(os.path.join(out_dir, "answers.pkl"), "wb") as f:
        pickle.dump(answers, f)
    lock = LS.summary()
    sites = sorted(LS.sanitizer()._sites)
    by_module = {}
    for s in sites:
        m = s.rsplit(":", 1)[0]
        by_module[m] = by_module.get(m, 0) + 1
    keys = sorted(RS.sanitizer()._key_events.items(), key=lambda kv: -kv[1])
    print("SANITIZE_RESULT " + json.dumps(dict(
        runs=runs, lock=lock, lock_sites_by_module=by_module,
        # (query, site, signature) once queries are marked, else
        # (site, signature)
        allocating_keys=[[k[-2], repr(k[-1]), n] for k, n in keys
                         if n > 1][:12],
        plan=PS.summary(), retrace=RS.summary(),
        # cudaMalloc failures the allocator answered by freeing its
        # cached blocks: each one makes later runs allocate anew
        alloc_retries=torch.cuda.memory_stats().get("num_alloc_retries", 0),
        jax="jax" in sys.modules)), flush=True)
    return 0


class _Rungs:
    """Rungs recorded in another process, shaped as a
    :class:`KernelRecorder`'s for phase 8."""

    def __init__(self, hash_rungs: dict, join_rungs: dict, pass_: str):
        self._hash, self.join_rungs, self.pass_ = hash_rungs, join_rungs, \
            pass_

    def hash_rungs(self) -> dict:
        return self._hash


def sanitize_phase(root: str, ref: dict, mp: dict, t22: dict):
    """Phase 7k: the sanitizers armed in a child process over Q1, the
    ``l_suppkey`` group-by, Q3 and Q9 (twice each) and Q3 under a host
    budget; answers held to the unarmed phases', 0 cycles, 0 plan and 0
    retrace-budget violations, every kernel launch under its declared
    site. Returns the rungs for phase 8 (``pass`` ``sanitize``)."""
    import gc
    import pickle
    import torch
    out = os.path.join(HERE, ".cache", "sanitize")
    os.makedirs(out, exist_ok=True)
    # the armed child shares the card: this process's idle blocks (the
    # column cache, the caching allocator's pools of the earlier phases)
    # must not leave the child so little room that its allocator frees
    # its own pools between a query's first run and the repeat, which
    # would then allocate anew at signatures the first run warmed
    reserved0 = torch.cuda.memory_reserved()
    _clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()
    log("sanitize parent memory " + json.dumps(dict(
        reserved_before=reserved0,
        reserved_after=torch.cuda.memory_reserved(),
        free_total=list(torch.cuda.mem_get_info()))))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sanitize-child",
         root, out], env=dict(os.environ, **SANITIZE_ENV), cwd=HERE,
        capture_output=True, text=True, timeout=SANITIZE_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    line = next((x for x in r.stdout.splitlines()
                 if x.startswith("SANITIZE_RESULT ")), None)
    if r.returncode != 0 or line is None:
        log("sanitize child stdout tail:\n" + r.stdout[-4000:])
        log("sanitize child stderr tail:\n" + r.stderr[-6000:])
        raise AssertionError(f"sanitize: the armed child failed "
                             f"(exit {r.returncode})")
    res = json.loads(line[len("SANITIZE_RESULT "):])
    with open(os.path.join(out, "answers.pkl"), "rb") as f:
        answers = pickle.load(f)
    # ---- answers: the unarmed phases'
    for (name, way), got in sorted(answers.items()):
        label = f"sanitize {name} {way}"
        if name in ("q1", "suppkey_agg"):
            check_answer(name, got, ref)
        else:
            _same_answer(label, got, t22["answers"][int(name[1:])])
    # ---- the lines
    lock, plan, retrace = res["lock"], res["plan"], res["retrace"]
    log("sanitize locks " + json.dumps(dict(
        locks=lock["locks"], edges=lock["edges"],
        cycles=len(lock["cycles"]), acquisitions=lock["acquisitions"],
        contended=lock["contended"],
        blocking_while_held=lock["blocking_while_held"],
        blocking_sites=lock["blocking_sites"][:8],
        sites_by_module=res["lock_sites_by_module"])))
    log("sanitize plan " + json.dumps(dict(
        {k: plan[k] for k in ("rule_checks", "membership_parts",
                              "membership_rows", "order_parts",
                              "conservation_checks")},
        violations=len(plan["violations"]))))
    per_site = {}
    for run, rr in res["runs"].items():
        way = "repeat" if run.endswith("repeat") else "first"
        for site, d in rr["sites"].items():
            ps = per_site.setdefault(site, dict(
                signatures=retrace["site_signatures"].get(site, 0),
                entries=retrace["site_entries"].get(site, 0),
                segments_first=0, segments_repeat=0, pinned_first=0,
                pinned_repeat=0,
                launches=retrace["site_launches"].get(site, {})))
            ps[f"segments_{way}"] += d["segments"]
            ps[f"pinned_{way}"] += d["pinned"]
    for site, ps in sorted(per_site.items()):
        log(f"sanitize site {site} " + json.dumps(ps))
    log("sanitize retrace " + json.dumps(dict(
        events=retrace["events"], warmup_events=retrace["warmup_events"],
        repeat_entries=retrace["repeat_entries"],
        queries=retrace["queries"], segments=retrace["segments"],
        pinned=retrace["pinned"], launches=retrace["launches"],
        unscoped_events=retrace["unscoped_events"],
        engine_launches=retrace["engine_launches"],
        unscoped_sites=dict(sorted(
            retrace["unscoped_sites"].items(),
            key=lambda kv: -kv[1])[:6]),
        repeat_run_segments=sum(
            d["segments"] for run, rr in res["runs"].items()
            if run.endswith("repeat") for d in rr["sites"].values()),
        repeat_run_pinned=sum(
            d["pinned"] for run, rr in res["runs"].items()
            if run.endswith("repeat") for d in rr["sites"].values()),
        alloc_retries=res["alloc_retries"],
        violations=len(retrace["violations"]))))
    unarmed = {"q1": mp["per_query"]["q1"]["cold_s"],
               "suppkey_agg": mp["per_query"]["suppkey_agg"]["cold_s"],
               "q3": t22["per_query"]["q3"]["cold_s"],
               "q9": t22["per_query"]["q9"]["cold_s"]}
    for name in SANITIZE_QUERIES:
        first, rep = res["runs"][f"{name} first"], res["runs"][f"{name} repeat"]
        log(f"sanitize {name} " + json.dumps(dict(
            armed_first_s=first["wall_s"], armed_repeat_s=rep["wall_s"],
            unarmed_cold_s=unarmed[name],
            launches_first=first["launches"],
            events_first=first["events"], events_repeat=rep["events"],
            host_blocks=[first["host_blocks"], rep["host_blocks"]],
            pool_buffers=[first["pool_buffers"], rep["pool_buffers"]],
            repeat_entries=rep["repeat_entries"],
            plan_checks=first["plan_checks"])))
    b = res["runs"]["q3 bounded"]
    log("sanitize allocating keys " + json.dumps(res["allocating_keys"]))
    log("sanitize q3 bounded " + json.dumps(dict(
        limit=SANITIZE_LIMIT, armed_s=b["wall_s"], launches=b["launches"],
        events=b["events"], repeat_entries=b["repeat_entries"],
        plan_checks=b["plan_checks"],
        spill={k: b["spill"].get(k, 0) for k in (
            "bytes_written", "joins_partitioned", "partitions_spilled")})))
    # ---- the sanitizers' verdicts, after their lines
    if res["jax"]:
        raise AssertionError("sanitize: the armed child imported jax")
    if lock["cycles"]:
        raise AssertionError(f"sanitize: lock-order cycles {lock['cycles']}")
    if plan["violations"]:
        raise AssertionError(f"sanitize: plan violations "
                             f"{plan['violations']}")
    if retrace["violations"]:
        raise AssertionError(f"sanitize: retrace-budget violations "
                             f"{retrace['violations']}")
    if lock["locks"] < 1 or plan["rule_checks"] < 1:
        raise AssertionError("sanitize: a sanitizer saw nothing")
    # the repeat budget held something: each query's repeat was known as
    # a repeat (its identity stable across runs) and met signatures its
    # first run warmed
    for name in SANITIZE_QUERIES:
        rr = res["runs"][f"{name} repeat"]
        if rr["repeat_entries"] < 1 or res["runs"][f"{name} first"][
                "repeat_entries"]:
            raise AssertionError(f"sanitize: {name}'s repeat met "
                                 f"{rr['repeat_entries']} warmed signatures")
    # ---- every kernel launch under its wrapper's declared site and under
    # an engine path's site (fragment.*, joins.*, runtime.*), none unscoped
    totals = dict(hash_agg_build=0, hash_join_build=0, hash_join_probe=0)
    for rr in res["runs"].values():
        _add(totals, {k: rr["launches"][k] for k in totals})
    for k, site in KERNEL_SITES.items():
        under = retrace["site_launches"].get(site, {}).get(site, 0)
        engine = retrace["engine_launches"].get(site, 0)
        if totals[k] < 1 or under != totals[k] or engine != totals[k]:
            raise AssertionError(f"sanitize: {k} launched {totals[k]} "
                                 f"times, {under} under {site}, {engine} "
                                 f"under an engine site")
    if retrace["unscoped_launches"]:
        raise AssertionError(f"sanitize: launches outside any declared "
                             f"site {retrace['unscoped_launches']}")
    if not res["runs"]["q3 bounded"]["spill"].get("bytes_written"):
        raise AssertionError("sanitize: the bounded Q3 spilled nothing")
    rungs = torch.load(os.path.join(out, "rungs.pt"))
    hash_rungs = {k: dict(v, args=_moved(v["args"], "cuda"))
                  for k, v in rungs["hash"].items()}
    join_rungs = {k: dict(v, build=_moved(v["build"], "cuda"),
                          probe=_moved(v["probe"], "cuda"))
                  for k, v in rungs["join"].items()}
    log(f"sanitize phase wall: {child_s:.3f} s (the child process, its "
        f"start and imports included)")
    return dict(rec=_Rungs(hash_rungs, join_rungs, "sanitize"), res=res)


# ------------------------------------------------------------ TPC-DS

# ------------------------------------------------- distributed and mesh

#: phase 7l: the mesh's shards (all on the one card), the distributed
#: runner's in-process workers, the remote worker processes, the chaos
#: run's fault spec and seed, and the combined-mode fuzz seeds
DIST_SHARDS = 4
DIST_WORKERS = 4
DIST_REMOTES = 2
DIST_FAULT_SPEC = "task:0.05,fetch:0.02"
DIST_FAULT_SEED = "5"
DIST_FUZZ_SEEDS = 100
#: the mesh window query reads the rows with l_orderkey below this
#: (about a tenth of SF1 lineitem): its host-tier oracle is the slow part
DIST_WINDOW_ORDERKEY = 600_000


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _sorted_rows(d: dict) -> list:
    cols = list(d)
    return sorted(zip(*(d[c] for c in cols)))


def _dist_mesh(root: str, ref: dict, rec, card: str) -> dict:
    """7l (a): the mesh of ``DIST_SHARDS`` shards on the card."""
    import pyarrow.dataset as ds
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.benchmarking.mesh_dryrun import _repartition_spy
    from daft_tpu_torch.device import backend, costmodel
    from daft_tpu_torch.distributed import shuffle_service as ss
    from daft_tpu_torch.parallel import exchange, mesh as pmesh
    from daft_tpu_torch.physical import plan as pp, translate as pt
    get = lambda t: dtt.read_parquet(f"{root}/{t}/*.parquet")  # noqa
    n = DIST_SHARDS
    out = {}

    def has(node, t):
        return isinstance(node, t) or any(has(c, t) for c in node.children)

    with _env(DAFT_TORCH_MESH_DEVICES=str(n), DAFT_TORCH_MESH_MIN_ROWS="0"):
        pmesh.reset_for_tests()
        mesh = pmesh.get_mesh()
        dev = backend.resolve_device()
        assert mesh is not None and mesh.size == n and \
            all(d.type == dev.type for d in mesh.devices), mesh
        for name in ("q1", "suppkey_agg"):
            df = Q.QUERIES[name](get)
            if not has(pt.translate(df._builder.optimize().plan),
                       pp.DeviceExchangeAgg):
                raise AssertionError(f"mesh {name}: no DeviceExchangeAgg")
            s0 = ss.shuffle_counters_snapshot()
            x0 = exchange.exchange_cache_counters()
            got, wall, counts, launches = rec.counted(
                f"dist mesh {name}",
                lambda: Q.QUERIES[name](get).to_pydict())
            check_answer(name, got, ref)
            sh = ss.shuffle_counters_delta(s0)
            if not sh.get("ici_exchanges"):
                raise AssertionError(f"mesh {name}: no mesh exchange ({sh})")
            if name == "suppkey_agg" and launches["hash_agg_build"] < 1:
                raise AssertionError("mesh suppkey_agg: the partial "
                                     "fragment launched no hash-agg build")
            x1 = exchange.exchange_cache_counters()
            out[name] = dict(wall_s=wall, launches=launches,
                             ici_bytes=sh.get("ici_bytes", 0),
                             ici_rows=sh.get("ici_rows", 0),
                             programs={k: x1[k] - x0.get(k, 0) for k in x1})
        # the repartitioned join: both inputs repartition over the mesh
        li_cols = ["l_orderkey", "l_extendedprice", "l_discount"]

        def repart_join(dt_=dtt):
            li = get("lineitem").select(*li_cols).repartition(n, "l_orderkey")
            od = get("orders").select("o_orderkey", "o_orderpriority") \
                .repartition(n, "o_orderkey")
            return li.join(od, left_on="l_orderkey", right_on="o_orderkey") \
                .groupby("o_orderpriority").agg(
                    dt_.col("l_extendedprice").sum().alias("rev"),
                    dt_.col("l_orderkey").count().alias("n")) \
                .sort("o_orderpriority").to_pydict()

        with _repartition_spy() as calls:
            got, wall, counts, launches = rec.counted("dist mesh join",
                                                      repart_join)
        if calls["n"] < 2:
            raise AssertionError(f"mesh join: {calls['n']} mesh "
                                 "repartitions, expected at least 2")
        if min(launches["hash_join_build"],
               launches["hash_join_probe"]) < 1:
            raise AssertionError(f"mesh join: the join kernels did not "
                                 f"launch ({launches}, {counts})")
        with dtt.execution_config_ctx(device="0"):
            want = repart_join()
        _same_answer("mesh join", got, want)
        out["repartition_join"] = dict(wall_s=wall, repartitions=calls["n"],
                                       launches=launches)
        # the range-partitioned sort of l_extendedprice
        price = ds.dataset(os.path.join(root, "lineitem"), format="parquet") \
            .to_table(columns=["l_extendedprice"]).column(0).to_numpy()
        total = len(price)
        C = -(-total // n)
        keys = np.zeros(n * C)
        keys[:total] = price
        live = np.arange(n * C) < total
        bounds = np.quantile(price, [i / n for i in range(1, n)])
        pid = np.searchsorted(bounds, keys).astype(np.int32)
        sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
        import torch
        _sync()
        t0 = time.perf_counter()
        (pk,), _, m2 = exchange.sharded_hash_repartition(
            mesh, (sb(keys),), (sb(live),), sb(live), sb(pid))
        merged = torch.cat([torch.sort(k[m]).values for k, m in zip(pk, m2)])
        _sync()
        sort_wall = time.perf_counter() - t0
        merged = merged.cpu().numpy()
        if merged.shape[0] != total or not np.all(np.diff(merged) >= 0) \
                or not np.array_equal(merged, np.sort(price)):
            raise AssertionError("mesh range sort: not globally ordered")
        out["range_sort"] = dict(rows=total, wall_s=sort_wall)
        # the broadcast join: l_suppkey sharded, 1/5 of the suppliers
        # replicated
        sk = ds.dataset(os.path.join(root, "lineitem"), format="parquet") \
            .to_table(columns=["l_suppkey"]).column(0).to_numpy() \
            .astype(np.int64)
        sup = ds.dataset(os.path.join(root, "supplier"), format="parquet") \
            .to_table(columns=["s_suppkey"]).column(0).to_numpy() \
            .astype(np.int64)
        build = sup[sup % 5 == 0]
        lk = np.zeros(n * C, dtype=np.int64)
        lk[:len(sk)] = sk
        rv = np.ones(len(build), dtype=bool)
        rep = lambda a: exchange.replicate(mesh, a)  # noqa: E731
        _sync()
        t0 = time.perf_counter()
        li_, ri_, ok_ = exchange.sharded_broadcast_join(
            mesh, sb(lk), sb(live), sb(live), rep(build), rep(rv), rep(rv),
            C)
        _sync()
        bj_wall = time.perf_counter() - t0
        matched = 0
        for i in range(n):
            okm = ok_[i].cpu().numpy()
            a = li_[i].cpu().numpy()[okm].astype(np.int64) + i * C
            b = ri_[i].cpu().numpy()[okm]
            if not np.array_equal(lk[a], build[b]):
                raise AssertionError("mesh broadcast join: a pair's keys "
                                     "differ")
            matched += int(okm.sum())
        want_m = int(np.isin(sk, build).sum())
        if matched != want_m:
            raise AssertionError(f"mesh broadcast join: {matched} pairs, "
                                 f"the host finds {want_m}")
        out["broadcast_join"] = dict(probe_rows=len(sk),
                                     build_rows=len(build), pairs=matched,
                                     wall_s=bj_wall)
        # a window whose partition_by repartition rides the mesh

        def window():
            w = get("lineitem").where(
                dtt.col("l_orderkey") < DIST_WINDOW_ORDERKEY).select(
                "l_suppkey", "l_orderkey", "l_linenumber", "l_quantity") \
                .repartition(n, "l_suppkey")
            return w.select(
                "l_orderkey", "l_linenumber",
                dtt.col("l_quantity").sum().over(
                    dtt.Window().partition_by("l_suppkey")).alias("tot")) \
                .to_pydict()

        with _repartition_spy() as calls:
            t0 = time.perf_counter()
            got = window()
            w_wall = time.perf_counter() - t0
        if calls["n"] < 1:
            raise AssertionError("mesh window: the repartition skipped the "
                                 "mesh")
        with dtt.execution_config_ctx(device="0"):
            want = window()
        if _sorted_rows(got) != _sorted_rows(want):
            raise AssertionError("mesh window: differs from the host tier")
        out["window"] = dict(rows=len(got["tot"]), wall_s=w_wall,
                             repartitions=calls["n"])
    # Q1 and the group-by with admission priced by the cost model
    with _env(DAFT_TORCH_MESH_DEVICES=str(n)):
        pmesh.reset_for_tests()
        costmodel.reset_ici_for_tests()
        priced = {}
        for name in ("q1", "suppkey_agg"):
            costmodel.reset_decision_counts()
            s0 = ss.shuffle_counters_snapshot()
            got = Q.QUERIES[name](get).to_pydict()
            check_answer(name, got, ref)
            priced[name] = dict(
                decisions=costmodel.decision_counts_snapshot().get(
                    "mesh_exchange", {}),
                ici_exchanges=ss.shuffle_counters_delta(s0).get(
                    "ici_exchanges", 0))
        out["priced"] = dict(queries=priced,
                             ici_bps=costmodel.ici_bps(),
                             mesh_dispatch_s=costmodel.mesh_dispatch_s())
    pmesh.reset_for_tests()
    return out


def _dist_runner(root: str, mp: dict, q3_ref, t22: dict, rec) -> dict:
    """7l (b): the distributed runner with ``DIST_WORKERS`` in-process
    workers, cold runs; each wall printed beside the native runner's cold
    wall of the same query (phase 7's, the main path's for the group-by)."""
    ref = mp["ref"]
    import daft_tpu_torch as dtt
    from daft_tpu_torch import context
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cache, pipeline
    from daft_tpu_torch.distributed import StagePlan
    from daft_tpu_torch.distributed import shuffle_service as ss
    from daft_tpu_torch.distributed import worker as dw
    from daft_tpu_torch.physical.translate import translate
    from daft_tpu_torch.runners.distributed_runner import DistributedRunner
    get = lambda t: dtt.read_parquet(f"{root}/{t}/*.parquet")  # noqa
    runs = {"q1": lambda: Q.q1(get), "suppkey_agg": lambda: Q.suppkey_agg(get),
            "q3": lambda: Q.ALL[3](get), "q9": lambda: Q.ALL[9](get)}
    tasks = {"n": 0}
    orig_run = dw.run_task

    def counting(task):
        tasks["n"] += 1
        return orig_run(task)

    out, answers = {}, {}
    dtt.set_runner(None)
    with _env(DAFT_TORCH_RUNNER="distributed",
              DAFT_TORCH_NUM_WORKERS=str(DIST_WORKERS)):
        runner = context.get_runner()
        assert isinstance(runner, DistributedRunner) and \
            runner.num_workers == DIST_WORKERS
        dw.run_task = counting
        try:
            for name, q in runs.items():
                stages = len(StagePlan.from_physical(translate(
                    q()._builder.optimize().plan)).stages)
                tasks["n"] = 0
                s0 = ss.shuffle_counters_snapshot()
                ev0 = cache.get_cache().stats().get("evictions", 0)
                got, wall, counts, launches = rec.counted(
                    f"dist runner {name}", lambda: q().to_pydict())
                sh = ss.shuffle_counters_delta(s0)
                evictions = cache.get_cache().stats().get(
                    "evictions", 0) - ev0
                if name in ("q1", "suppkey_agg"):
                    check_answer(name, got, ref)
                elif name == "q3":
                    check_table("dist q3", got, q3_ref[0], ["o_orderkey"],
                                ["o_orderdate", "o_shippriority"],
                                ["revenue"])
                else:
                    _same_answer("dist q9", got, t22["answers"][9])
                if name == "suppkey_agg" and launches["hash_agg_build"] < 1:
                    raise AssertionError("dist suppkey_agg: no hash-agg "
                                         f"build ({counts})")
                if name in ("q3", "q9"):
                    if min(launches["hash_join_build"],
                           launches["hash_join_probe"]) < 1:
                        raise AssertionError(f"dist {name}: the join "
                                             f"kernels did not launch "
                                             f"({launches}, {counts})")
                    if counts.get("host_joins", 0):
                        raise AssertionError(f"dist {name}: "
                                             f"{counts['host_joins']} joins "
                                             f"fell to the host ({counts})")
                if evictions:
                    raise AssertionError(f"dist {name}: {evictions} device "
                                         "cache evictions mid-query")
                answers[name] = got
                native = (t22["per_query"].get(name)
                          or mp["per_query"].get(name) or {}).get("cold_s")
                out[name] = dict(
                    wall_s=wall, native_cold_s=native, stages=stages,
                    tasks=tasks["n"], launches=launches,
                    bytes_written=sh.get("bytes_written", 0),
                    bytes_fetched=sh.get("bytes_fetched", 0),
                    fetches=sh.get("fetches", 0),
                    combine_rows=[sh.get("combine_rows_in", 0),
                                  sh.get("combine_rows_out", 0)],
                    exchange_paths={k[len("exchange_path_"):]: v
                                    for k, v in sh.items()
                                    if k.startswith("exchange_path_")},
                    counters={k: counts.get(k, 0) for k in (
                        "dense", "hash", "sort", "join_hash", "join_sort",
                        "host_joins", "host_morsels")})
        finally:
            dw.run_task = orig_run
    out["stream_sets"] = len(pipeline._stream_sets.get(0, []))
    return dict(lines=out, answers=answers, runner=runner)


def _dist_remote(root: str, answers: dict) -> dict:
    """7l (c): Q3 through ``DIST_REMOTES`` remote worker processes."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import backend
    from daft_tpu_torch.distributed import (LeastLoadedScheduler, StagePlan,
                                            StageRunner, WorkerManager)
    from daft_tpu_torch.distributed import scheduler as sched
    from daft_tpu_torch.distributed.remote_worker import (RemoteWorker,
                                                          fetch_status)
    from daft_tpu_torch.distributed.worker import ShuffleResult
    from daft_tpu_torch.physical.translate import translate
    get = lambda t: dtt.read_parquet(f"{root}/{t}/*.parquet")  # noqa
    env = dict(os.environ)
    env.pop("DAFT_TORCH_RUNNER", None)
    procs, addrs = [], []
    receipts = []
    orig_collect = sched.StageRunner._collect

    def spy(self, tasks):
        res = orig_collect(self, tasks)
        receipts.extend(r for r in res if isinstance(r, ShuffleResult))
        return res

    try:
        t0 = time.perf_counter()
        for _ in range(DIST_REMOTES):
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "daft_tpu_torch.distributed.remote_worker", "--port", "0",
                 "--host", "127.0.0.1", "--slots", "2"],
                stdout=subprocess.PIPE, text=True, env=env, cwd=HERE)
            procs.append(p)
        for p in procs:
            line = p.stdout.readline().strip()
            if not line.startswith("daft-torch worker on http://"):
                raise AssertionError(f"remote worker did not start: {line!r}")
            addrs.append(line.split()[-1])
        start_s = time.perf_counter() - t0
        sp = StagePlan.from_physical(translate(
            Q.ALL[3](get)._builder.optimize().plan))
        mgr = WorkerManager([RemoteWorker(f"remote-{i}", a)
                             for i, a in enumerate(addrs)])
        sched.StageRunner._collect = spy
        try:
            t0 = time.perf_counter()
            parts = list(StageRunner(mgr, LeastLoadedScheduler()).run(sp))
            wall = time.perf_counter() - t0
        finally:
            sched.StageRunner._collect = orig_collect
            mgr.shutdown()
        got = parts[0].concat(parts[1:]).to_pydict() if len(parts) > 1 \
            else parts[0].to_pydict()
        _same_answer("remote workers q3", got, answers["q3"])
        status = [fetch_status(a) for a in addrs]
        want_dev = backend.resolve_device().type
        for st in status:
            if st["device"] != want_dev:
                raise AssertionError(f"remote worker ran on {st}, not "
                                     f"{want_dev}")
        joins = sum(st["launches"]["hash_join_build"] for st in status)
        if joins < 1:
            raise AssertionError(f"remote q3: no join build in the workers "
                                 f"({status})")
        schemes = sorted({r.address.split(":")[0] for r in receipts})
        transport = "flight" if schemes == ["grpc"] else \
            ("http" if schemes == ["http"] else ",".join(schemes))
        return dict(workers=len(addrs), start_s=start_s, wall_s=wall,
                    transport=transport, receipts=len(receipts),
                    children=[dict(pid=st["pid"], device=st["device"],
                                   launches=st["launches"])
                              for st in status])
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _dist_chaos(root: str, answers: dict, runner, rec) -> dict:
    """7l (d): Q3 through (b)'s runner under a fixed seeded fault spec,
    twice."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.distributed import resilience as rz
    get = lambda t: dtt.read_parquet(f"{root}/{t}/*.parquet")  # noqa
    runs = []
    dtt.set_runner(runner)
    try:
        with _env(DAFT_TORCH_FAULT_SPEC=DIST_FAULT_SPEC,
                  DAFT_TORCH_FAULT_SEED=DIST_FAULT_SEED,
                  DAFT_TORCH_CHAOS_SERIALIZE="1",
                  DAFT_TORCH_MAX_RETRIES="8",
                  DAFT_TORCH_RETRY_BACKOFF="0.01",
                  DAFT_TORCH_SPECULATIVE_MULTIPLIER="0"):
            for i in range(2):
                rz.reset_for_tests()
                got, wall, counts, launches = rec.counted(
                    f"dist chaos q3 #{i}",
                    lambda: Q.ALL[3](get).to_pydict())
                _same_answer(f"chaos q3 #{i}", got, answers["q3"])
                runs.append(dict(wall_s=wall, launches=launches,
                                 recovery=rz.counters_snapshot(),
                                 events=sorted(rz.fault_events())))
    finally:
        dtt.set_runner(None)
        rz.reset_for_tests()
    if runs[0]["events"] != runs[1]["events"]:
        raise AssertionError("chaos: the same seed gave other fault events")
    rec0 = runs[0]["recovery"]
    if not rec0.get("retries") or not any(
            k.startswith("injected_") for k in rec0):
        raise AssertionError(f"chaos: no recovery ({rec0})")
    return dict(spec=DIST_FAULT_SPEC, seed=DIST_FAULT_SEED,
                events=runs[0]["events"], recovery=rec0,
                walls=[r["wall_s"] for r in runs],
                launches=runs[0]["launches"])


def dist_phase(root: str, mp: dict, q3_ref, t22: dict, card: str) -> dict:
    """Phase 7l: the mesh on the card, the distributed runner with
    in-process and remote workers, a seeded chaos run and the fuzzer's
    ``combined`` mode (see the module docstring)."""
    from daft_tpu_torch.analysis import plan_fuzzer as PF
    rec = KernelRecorder("dist")
    t_phase = time.perf_counter()
    mesh = _dist_mesh(root, mp["ref"], rec, card)
    for k, v in mesh.items():
        log("dist mesh " + json.dumps(dict(run=k, card=card, **v)))
    done_a = time.perf_counter() - t_phase
    runner = _dist_runner(root, mp, q3_ref, t22, rec)
    for k, v in runner["lines"].items():
        log("dist runner " + json.dumps(
            dict(query=k, card=card, **v) if isinstance(v, dict)
            else dict(query=k, value=v)))
    remote = _dist_remote(root, runner["answers"])
    log("dist remote " + json.dumps(dict(card=card, **remote)))
    chaos = _dist_chaos(root, runner["answers"], runner["runner"], rec)
    runner["runner"].shutdown()
    log("dist chaos " + json.dumps(dict(card=card, **chaos)))
    res, wall, _, launches = rec.counted(
        "dist fuzz combined", lambda: PF.run_fuzz(
            count=DIST_FUZZ_SEEDS, seed=0, modes=("combined",)))
    c = res.per_mode["combined"]
    fz = dict(mode="combined", seeds=res.seeds_run, compared=c["cases"],
              mismatches=c["mismatches"], errors=c["errors"] + len(res.errors),
              sanitizer_violations=res.sanitizer_violations,
              launches=launches, wall_s=wall)
    log("dist fuzz " + json.dumps(fz))
    for m in res.mismatches:
        log("dist fuzz MISMATCH\n" + m.repro())
    if res.seeds_run < DIST_FUZZ_SEEDS or res.mismatches or res.errors \
            or res.sanitizer_violations:
        raise AssertionError(f"dist fuzz combined: {fz}")
    log(f"dist phase wall: {time.perf_counter() - t_phase:.3f} s "
        f"(mesh {done_a:.3f} s)")
    return dict(rec=rec, mesh=mesh, runner=runner["lines"], remote=remote,
                chaos=chaos, fuzz=fz)


# ------------------------------------------------------------ serving

#: phase 7m: the scheduler's worker slots (one closed-loop client each),
#: the sessions the clients share, (a)'s duration, the rotations each
#: client of (b) submits, Q6's (year, discount) pairs and the number of
#: seeded ``l_orderkey`` lookup keys
SERVE_CONCURRENCY = 4
SERVE_SESSIONS = 3
SERVE_MIX_S = 30.0
SERVE_ROTATIONS = 2
SERVE_Q6 = ((1994, 0.06), (1995, 0.05), (1993, 0.07), (1996, 0.04))
SERVE_LOOKUPS = 8
SERVE_MIX = ("q1", "suppkey_agg", "q6", "q3", "lookup")
SERVE_LOOKUP_COLS = ("l_orderkey", "l_partkey", "l_quantity",
                     "l_extendedprice")


def _serve_q6(get, year: int, disc: float):
    """TPC-H Q6 at one (year, discount) pair."""
    from daft_tpu_torch import col, lit
    lo, hi = round(disc - 0.01, 2), round(disc + 0.01, 2)
    return (get("lineitem").where(
        (col("l_shipdate") >= lit(datetime.date(year, 1, 1)))
        & (col("l_shipdate") < lit(datetime.date(year + 1, 1, 1)))
        & col("l_discount").between(lo, hi) & (col("l_quantity") < 24))
        .agg((col("l_extendedprice") * col("l_discount")).sum()
             .alias("revenue")))


def _serve_lookup(get, key: int):
    from daft_tpu_torch import col
    return (get("lineitem").where(col("l_orderkey") == key)
            .select(*SERVE_LOOKUP_COLS).limit(10))


def serve_references(root: str, seed: int = 16) -> dict:
    """pyarrow's answers to the parameterized queries of the serving mix:
    Q6 at each pair of ``SERVE_Q6`` and the lookups at ``SERVE_LOOKUPS``
    seeded keys of ``lineitem``."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.dataset as ds
    li = ds.dataset(os.path.join(root, "lineitem"), format="parquet") \
        .to_table(columns=list(SERVE_LOOKUP_COLS)
                  + ["l_shipdate", "l_discount"])
    q6 = {}
    for year, disc in SERVE_Q6:
        lo, hi = round(disc - 0.01, 2), round(disc + 0.01, 2)
        sd = li["l_shipdate"]
        m = pc.and_(pc.and_(
            pc.greater_equal(sd, pa.scalar(datetime.date(year, 1, 1))),
            pc.less(sd, pa.scalar(datetime.date(year + 1, 1, 1)))),
            pc.and_(pc.and_(pc.greater_equal(li["l_discount"], lo),
                            pc.less_equal(li["l_discount"], hi)),
                    pc.less(li["l_quantity"], 24.0)))
        t = li.filter(m)
        q6[(year, disc)] = {"revenue": [pc.sum(pc.multiply(
            t["l_extendedprice"], t["l_discount"])).as_py()]}
    keys = np.unique(li["l_orderkey"].to_numpy())
    rng = np.random.default_rng(seed)
    lookups = {}
    for k in sorted(int(x) for x in rng.choice(keys, SERVE_LOOKUPS,
                                               replace=False)):
        t = li.filter(pc.equal(li["l_orderkey"], k))
        lookups[k] = sorted(zip(*(t[c].to_pylist()
                                  for c in SERVE_LOOKUP_COLS)))
    return dict(q6=q6, lookups=lookups)


class _ServeClient:
    """One closed-loop client: submits the next query of the mix, waits
    for its answer, submits the next. Client ``i`` starts its rotation at
    query ``i`` (so the slots run different queries at once) and draws
    Q6's pair and the lookup key from its own seeded generator."""

    def __init__(self, i: int, get, sched, refs: dict, seed: int):
        self.i, self.get, self.sched, self.refs = i, get, sched, refs
        self.session = f"s{i % SERVE_SESSIONS}"
        self.rng = np.random.default_rng(seed + i)
        self.n = i
        self.records = []

    def next_query(self):
        from daft_tpu_torch.benchmarking import tpch_queries as Q
        name = SERVE_MIX[self.n % len(SERVE_MIX)]
        self.n += 1
        if name == "q6":
            year, disc = SERVE_Q6[int(self.rng.integers(len(SERVE_Q6)))]
            return name, (year, disc), _serve_q6(self.get, year, disc)
        if name == "lookup":
            keys = sorted(self.refs["lookups"])
            k = keys[int(self.rng.integers(len(keys)))]
            return name, k, _serve_lookup(self.get, k)
        return name, None, Q.QUERIES[name](self.get)

    def run_one(self):
        name, param, df = self.next_query()
        t0 = time.perf_counter()
        h = self.sched.submit(df, session=self.session)
        try:
            ps = h.result(timeout=600)
        except BaseException as e:  # noqa: BLE001 — every failure is shown
            log(f"serve: {name} {param} failed in state {h.state}: "
                f"{type(e).__name__}: {e}")
            raise
        self.records.append(dict(
            name=name, param=param, submitted_s=t0,
            latency_s=time.perf_counter() - t0,
            queue_wait_s=h.queue_wait_s, ps=ps,
            serving=dict(h.stats.serving) if h.stats is not None else {}))


def _serve_check(records, ref: dict, q3_ref, refs: dict) -> int:
    """Hold every answer: Q1, the group-by and Q6 to pyarrow by
    ``check_answer``, Q3 to phase 6's answer, a lookup's rows as a
    multiset to pyarrow's. A result served twice from the cache is one
    object and is checked once. Returns the answers checked."""
    seen = {}
    for r in records:
        key = id(r["ps"])
        if key in seen:
            continue
        seen[key] = r["ps"]
        got = r["ps"].to_recordbatch().to_pydict()
        name, param = r["name"], r["param"]
        if name == "q3":
            _same_answer("serve q3", got, q3_ref[0])
        elif name == "q6":
            check_table(f"serve q6 {param}", got, refs["q6"][param], [], [],
                        ["revenue"])
        elif name == "lookup":
            rows = sorted(zip(*(got[c] for c in SERVE_LOOKUP_COLS)))
            if rows != refs["lookups"][param]:
                raise AssertionError(f"serve lookup {param}: {rows} != "
                                     f"{refs['lookups'][param]}")
        else:
            check_answer(name, got, ref)
    return len(seen)


def _serve_stats(records, wall_s: float) -> dict:
    lat = sorted(r["latency_s"] for r in records)
    qw = sorted(r["queue_wait_s"] for r in records)

    def pct(xs, p):
        return xs[min(int(p * len(xs)), len(xs) - 1)] if xs else None
    cold_repeat = {}
    records = sorted(records, key=lambda r: r["submitted_s"])
    for name in SERVE_MIX:
        ls = [r["latency_s"] for r in records if r["name"] == name]
        if ls:
            cold_repeat[name] = dict(
                n=len(ls), cold_s=ls[0],
                repeat_mean_s=statistics.mean(ls[1:]) if len(ls) > 1
                else None)
    return dict(queries=len(records), wall_s=wall_s,
                qps=len(records) / wall_s if wall_s else None,
                p50_s=pct(lat, 0.50), p99_s=pct(lat, 0.99),
                queue_wait_mean_s=statistics.mean(qw) if qw else None,
                queue_wait_p99_s=pct(qw, 0.99), cold_repeat=cold_repeat)


def _serve_clients(sched, get, refs, seed: int, duration_s=None,
                   rotations=None):
    """Run ``SERVE_CONCURRENCY`` closed-loop clients against ``sched`` for
    ``duration_s`` or ``rotations`` turns of the mix each → (records,
    wall). A client's failure fails the phase (re-raised here)."""
    clients = [_ServeClient(i, get, sched, refs, seed)
               for i in range(SERVE_CONCURRENCY)]
    errors = []

    def loop(c):
        try:
            if duration_s is not None:
                end = time.perf_counter() + duration_s
                while time.perf_counter() < end:
                    c.run_one()
            else:
                for _ in range(rotations * len(SERVE_MIX)):
                    c.run_one()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=loop, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"serve: {len(errors)} client(s) failed: "
                             f"{errors[0]!r}") from errors[0]
    return [r for c in clients for r in c.records], wall


def _serve_cancel(get, q3_ref) -> dict:
    """(d): a running Q3 cancelled once its first join build launched,
    then Q3 again through the same scheduler."""
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import join_kernels as jk
    from daft_tpu_torch.serving import QueryCancelled, QueryScheduler
    sched = QueryScheduler(concurrency=SERVE_CONCURRENCY,
                           result_cache_bytes=0)
    built = threading.Event()
    orig = jk.hash_join_build_cuda

    def marking(*a):
        out = orig(*a)
        built.set()
        return out
    jk.hash_join_build_cuda = marking
    try:
        h = sched.submit(Q.q3(get), session="cancel")
        if not built.wait(120):
            raise AssertionError(f"serve cancel: Q3 launched no join build "
                                 f"(state {h.state})")
        held = sched.admission.outstanding
        t0 = time.perf_counter()
        h.cancel("phase 7m cancel")
        try:
            h.result(timeout=120)
            raise AssertionError("serve cancel: Q3 finished after its "
                                 "cancel")
        except QueryCancelled:
            pass
        unwind_s = time.perf_counter() - t0
        if h.state != "cancelled":
            raise AssertionError(f"serve cancel: state {h.state}")
        deadline = time.monotonic() + 30
        while sched.admission.outstanding and time.monotonic() < deadline:
            time.sleep(0.01)
        back = sched.admission.outstanding
        if back != 0:
            raise AssertionError(f"serve cancel: {back} admitted bytes "
                                 "not released")
        jk.hash_join_build_cuda = orig
        t0 = time.perf_counter()
        again = sched.submit(Q.q3(get), session="cancel").result(timeout=300)
        repeat_s = time.perf_counter() - t0
        _same_answer("serve q3 after the cancel",
                     again.to_recordbatch().to_pydict(), q3_ref[0])
        snap = sched.counters_snapshot()
    finally:
        jk.hash_join_build_cuda = orig
        sched.shutdown()
    return dict(state=h.state, admitted_while_running=held,
                admitted_after=back, unwind_s=unwind_s, repeat_s=repeat_s,
                cancelled=snap.get("cancelled", 0),
                completed=snap.get("completed", 0))


def serve_host_free(counters: dict) -> dict:
    """The host fallbacks the native cold runs of the served queries had
    none of, from each run's counters by query name: ``host_joins`` (Q3)
    and ``host_morsels`` (Q1, the group-by, Q6, Q3)."""
    return dict(
        host_joins=counters["q3"].get("host_joins", 0) == 0,
        host_morsels=all(counters[q].get("host_morsels", 0) == 0
                         for q in ("q1", "suppkey_agg", "q6", "q3")))


def serve_phase(root: str, ref: dict, q3_ref, host_free: dict,
                card: str) -> dict:
    """Phase 7m: the serving plane on the card (see the module
    docstring). ``host_free`` says which host fallbacks the native runs
    of these queries had none of (``host_joins``, ``host_morsels``): the
    served runs must have none of them either. Returns the rungs for
    phase 8 (``pass`` ``serve``)."""
    import gc
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.device import cache, pipeline, runtime
    from daft_tpu_torch.serving import QueryScheduler
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    t_phase = time.perf_counter()
    refs = serve_references(root)
    rec = KernelRecorder("serve")
    _clear_device_cache()
    gc.collect()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    compile0 = runtime.compile_cache_counters()
    lines, snaps, launches, counts = {}, {}, {}, {}

    def run(label, concurrency=SERVE_CONCURRENCY, result_cache_bytes=None,
            env=None, **kw):
        sched = QueryScheduler(concurrency=concurrency,
                               result_cache_bytes=result_cache_bytes)
        try:
            with _env(**(env or {})):
                (records, wall), _, c, l = rec.counted(
                    f"serve {label}",
                    lambda: _serve_clients(sched, get, refs, seed=16, **kw),
                    clear=label == "a")
            sched.drain(timeout_s=30.0)
            snap = sched.counters_snapshot()
            outstanding = sched.admission.outstanding
        finally:
            sched.shutdown()
        n_checked = _serve_check(records, ref, q3_ref, refs)
        if snap.get("failed", 0) or any(
                v for k, v in snap.items() if k.startswith("rejected_")):
            raise AssertionError(f"serve {label}: failed or rejected "
                                 f"queries {snap}")
        if outstanding != 0:
            raise AssertionError(f"serve {label}: {outstanding} admitted "
                                 "bytes outstanding after the drain")
        for k in ("host_joins", "host_morsels"):
            if host_free.get(k) and c.get(k, 0):
                raise AssertionError(f"serve {label}: {c[k]} {k} where the "
                                     f"native runs had none ({c})")
        st = _serve_stats(records, wall)
        st.update(answers_checked=n_checked, launches=l,
                  counters={k: c.get(k, 0) for k in TPCH22_COUNTERS},
                  scheduler={k: v for k, v in snap.items()
                             if not k.endswith("_us")},
                  outstanding_after_drain=outstanding)
        lines[label], snaps[label], launches[label], counts[label] = \
            st, snap, l, c
        log("serve " + json.dumps(dict(run=label, card=card, **st)))
        return st

    # (a) the mixed traffic, every cache on
    run("a", duration_s=SERVE_MIX_S)
    sa = snaps["a"]
    for k in ("result_cache_hits", "plan_cache_hits"):
        if sa.get(k, 0) < 1:
            raise AssertionError(f"serve a: no {k} ({sa})")
    # (b) every query executed: the plan cache on, the result cache off
    b = run("b", rotations=SERVE_ROTATIONS, result_cache_bytes=0)
    # (c) (b)'s submissions (the same seeded clients) through one worker
    c = run("c", rotations=SERVE_ROTATIONS, result_cache_bytes=0,
            concurrency=1)
    for k in ("hash_agg_build", "hash_join_build", "hash_join_probe"):
        if launches["a"][k] + launches["b"][k] < 1:
            raise AssertionError(f"serve: {k} launched no time under the "
                                 f"scheduler ({launches})")
    # (e) the per-operator paths (projection, predicate, argsort, agg)
    # dispatched from concurrent queries: at a 1-row floor every batch goes
    # to the card, each path's device section under the one lock
    e = run("e", rotations=1, result_cache_bytes=0,
            env=dict(DAFT_TORCH_DEVICE_MIN_ROWS="1"))
    ops = counts["e"]
    for k in ("projection", "predicate", "argsort"):
        if ops.get(k, 0) < 1:
            raise AssertionError(f"serve e: no {k} dispatch ({ops})")
    if ops.get("agg_hash", 0) + ops.get("agg_sort", 0) \
            + ops.get("agg_global", 0) < 1:
        raise AssertionError(f"serve e: no per-operator agg ({ops})")
    rec.check_totals("serve", {k: sum(launches[x][k] for x in launches)
                               for k in launches["a"]}, require_each=False)
    # (d) a cancel mid-flight, then the repeat
    d = _serve_cancel(get, q3_ref)
    log("serve cancel " + json.dumps(dict(card=card, **d)))
    # the device memory the phase leaves: the column cache and the
    # residency registry hold what they hold within their budgets (the
    # schedulers, their result caches and their PartitionSets are gone)
    rec.to_host()
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    res = pipeline.residency_counters()
    mem = dict(allocated_before=alloc0, allocated_after=alloc,
               cache_bytes=cache.get_cache().stats()["bytes"],
               cache_budget=cache.budget(), residency_bytes=res["bytes"],
               residency_budget=pipeline._res_budget())
    log("serve memory " + json.dumps(dict(card=card, **mem)))
    if alloc - alloc0 > mem["cache_budget"] + mem["residency_budget"]:
        raise AssertionError(f"serve: device memory left past the column "
                             f"cache's and residency's budgets ({mem})")
    rec.to_host("cuda")  # phase 8 runs the kernels on them
    compile1 = runtime.compile_cache_counters()
    summary = dict(
        card=card, qps_a=lines["a"]["qps"], p50_a_s=lines["a"]["p50_s"],
        p99_a_s=lines["a"]["p99_s"],
        plan_cache_hit_rate_a=sa["plan_cache_hits"] / max(
            sa["plan_cache_hits"] + sa["plan_cache_misses"], 1),
        result_cache_hit_rate_a=sa["result_cache_hits"] / max(
            sa["result_cache_hits"] + sa["result_cache_misses"], 1),
        plan_cache_structure_hits={k: v.get("plan_cache_structure_hits", 0)
                                   for k, v in snaps.items()},
        compile_cache_counters={k: compile1.get(k, 0) - compile0.get(k, 0)
                                for k in compile1},
        launches=launches, wall_b_s=b["wall_s"], wall_c_s=c["wall_s"],
        wall_e_s=e["wall_s"],
        b_over_c=b["wall_s"] / c["wall_s"] if c["wall_s"] else None,
        phase_s=time.perf_counter() - t_phase)
    log("serve summary " + json.dumps(summary))
    log(f"serve phase wall: {summary['phase_s']:.3f} s")
    return dict(rec=rec, lines=lines, cancel=d, memory=mem,
                summary=summary)


def tpcds_root(scale: float) -> str:
    from benchmarking.tpcds.datagen import generate_tpcds
    root = os.path.join(HERE, ".cache", f"tpcds_s{scale:g}")
    ss = os.path.join(root, "store_sales")
    if not (os.path.isdir(ss) and os.listdir(ss)):
        t0 = time.perf_counter()
        generate_tpcds(root, scale=scale, seed=0)
        log(f"tpcds datagen scale={scale:g}: "
            f"{time.perf_counter() - t0:.3f} s")
    return root


def _add(totals: dict, *items):
    for d in items:
        for k, v in d.items():
            totals[k] = totals.get(k, 0) + v


def _region_plan(df) -> list:
    """The fusion regions the port's planner proposes for ``df``."""
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    found, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, pp.FusedRegion):
            found.append([n.shape, list(n.fused_ops)])
        for c in n.children:
            walk(c)
    walk(translate(df.builder.optimize().plan))
    return found


def _host_unlimited(q: int, get) -> dict:
    """TPC-DS query ``q`` without its final ``LIMIT`` on the host tier."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpcds_sql as DS
    with dtt.execution_config_ctx(device="0"):
        return DS.run(q, get, cut=False).to_pydict()


def tpcds_phase(root: str):
    """All 99 TPC-DS queries as SQL (``daft_tpu_torch/benchmarking/
    tpcds_sql.py``) on the card at the default knobs (the cost model and
    ``DAFT_TORCH_FUSION=auto`` decide): per query one counted cold run
    (the device column cache cleared, every count zeroed just before and
    read just after), then the host tier (``device="0"``) on the same
    files; the answers equal row for row (floats at relative 1e-9). One
    ``tpcds`` line per query: walls, counters, fusion-region counters,
    the cost model's decisions, kernel launches."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpcds_sql as DS
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec_k = KernelRecorder("tpcds")
    per_query, totals, answers = {}, {}, {}
    for q in sorted(DS.ALL):
        dev, dev_s, counts, launches = rec_k.counted(
            f"tpcds q{q}", lambda: DS.run(q, get).to_pydict())
        decisions = rec_k.decisions
        with dtt.execution_config_ctx(device="0"):
            t0 = time.perf_counter()
            host = DS.run(q, get).to_pydict()
            host_s = time.perf_counter() - t0
        order = _same_rows_up_to_rank_ties(
            f"tpcds q{q}", dev, host, DS.RANK_TIES.get(q), DS.ORDER_KEYS[q],
            DS.limit_of(q), lambda q=q: _host_unlimited(q, get))
        answers[q] = host
        rec = dict(query=q, order=order, device_s=dev_s, host_s=host_s,
                   rows=len(next(iter(host.values()), [])),
                   counters={k: counts.get(k, 0) for k in TPCH22_COUNTERS},
                   regions=DS.region_counters(counts), decisions=decisions,
                   launches=launches)
        per_query[q] = rec
        _add(totals, rec["counters"], launches, rec["regions"])
        log("tpcds " + json.dumps(rec))
    rec_k.check_totals("tpcds", totals, require_each=False)
    sums = {k: sum(r[k] for r in per_query.values())
            for k in ("device_s", "host_s")}
    log("tpcds totals " + json.dumps(totals) + "; walls summed "
        + json.dumps(sums) + "; window queries' walls summed "
        + json.dumps({k: sum(per_query[q][k] for q in DS.WINDOW_QUERIES)
                      for k in ("device_s", "host_s")}))
    return dict(per_query=per_query, totals=totals, answers=answers,
                rec=rec_k, sums=sums)


def _replay_join_agg(tok):
    """The fused program of a drained join_agg dispatch, on its final
    rung's inputs, as a no-argument call."""
    from daft_tpu_torch.device import fragment, runtime
    prog, dt, build = tok.prog, tok.dt, tok.build
    arrays = {n: c.data for n, c in dt.columns.items()}
    valids = {n: c.validity for n, c in dt.columns.items()}
    p_sc = runtime._prep_scalars(prog.c_pred, dt) \
        if prog.c_pred is not None else ()
    post = fragment._prep_scalars_joined(prog.c_post, dt, build.dt)
    return lambda: prog.run_planes(arrays, valids, dt.row_mask, p_sc, build,
                                   post, tok.W, tok.out_cap)


def _replay_region(tok):
    """The same for a drained chain/topk dispatch."""
    from daft_tpu_torch.device import runtime
    prog, dt = tok.prog, tok.dt
    arrays = {n: c.data for n, c in dt.columns.items()}
    valids = {n: c.validity for n, c in dt.columns.items()}
    sc = runtime._prep_scalars(prog.compiled, dt)
    return lambda: prog.run_planes(arrays, valids, dt.row_mask, sc,
                                   tok.out_w)


def region_dispatch_profile(label: str, call) -> dict:
    """Device activities (``torch.profiler``) and the CUDA-event time of
    one region dispatch replayed on its own inputs: how many launches one
    fused torch program makes."""
    acts = device_activities(call)
    return dict(region=label, ms=cuda_ms(call),
                launches_per_dispatch=sum(n for n, _ in acts.values()),
                kernels_per_dispatch=sum(
                    n for k, (n, _) in acts.items()
                    if not k.startswith(("Memset", "Memcpy"))),
                top=sorted(([k[:60], n, ms] for k, (n, ms) in acts.items()),
                           key=lambda r: -r[2])[:5])


class _Capture:
    """Keeps the first token each query hands a region dispatcher (the
    drain finishes it in place), so its program can be replayed."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.first = owner, attr, {}
        self.orig = getattr(owner, attr)
        self.query = None

    def __enter__(self):
        def wrapped(tok, _orig=self.orig):
            self.first.setdefault(self.query, tok)
            return _orig(tok)
        setattr(self.owner, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def tpcds_dispatch_pass(root: str, ds_answers: dict, tpch: str,
                        t22_answers: dict):
    """The window queries and the fusion-region queries of TPC-DS, and
    TPC-H Q17 (DataFrame form, SF1), with every priced decision on the
    card (``DAFT_TORCH_DEVICE_FORCE=1``: each window's argsort too) and
    every region admitted (``DAFT_TORCH_FUSION=1``), per query a counted
    cold run held to the host tier's answer. One ``tpcds dispatch`` line
    per query: the regions the planner proposed, the join_agg dispatches,
    the climbs of each ladder and the declines by cause. A query whose
    plan holds a region that dispatched no time fails the phase. Then the
    torch launches of one join_agg dispatch (``torch.profiler``)."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.benchmarking import tpcds_sql as DS
    from daft_tpu_torch.device import fragment
    ds_get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    h_get = lambda t: dtt.read_parquet(os.path.join(tpch, t))  # noqa: E731
    jobs = [(f"tpcds q{q}", lambda q=q: DS.run(q, ds_get), ds_answers[q],
             (DS.RANK_TIES.get(q), DS.ORDER_KEYS[q], DS.limit_of(q),
              lambda q=q: _host_unlimited(q, ds_get)))
            for q in sorted(set(DS.WINDOW_QUERIES) | set(DS.REGION_QUERIES))]
    # Q17's answer is one row
    jobs.append(("tpch q17", lambda: Q.ALL[17](h_get), t22_answers[17],
                 (None, (), None, None)))
    rec_k = KernelRecorder("tpcds_dispatch")
    per_query, totals = {}, {}
    with _env(DAFT_TORCH_DEVICE_FORCE="1", DAFT_TORCH_FUSION="1"), \
            _Capture(fragment, "_dispatch_join_agg") as cap:
        for name, make, want, tie in jobs:
            planned = _region_plan(make())
            cap.query = name
            got, wall, counts, launches = rec_k.counted(
                name, lambda: make().to_pydict())
            order = _same_rows_up_to_rank_ties(f"dispatch {name}", got,
                                               want, *tie)
            regions = DS.region_counters(counts)
            rec = dict(query=name, order=order, cold_s=wall,
                       planned_regions=planned,
                       join_agg_dispatches=regions.get(
                           "region_join_agg", 0),
                       w_climbs=regions.get("region_join_agg_w_climbs", 0),
                       group_climbs=regions.get(
                           "region_join_agg_group_climbs", 0),
                       declined={k[len("region_declined_"):]: v
                                 for k, v in regions.items()
                                 if k.startswith("region_declined_")},
                       argsort=counts.get("argsort", 0),
                       counters={k: counts.get(k, 0)
                                 for k in TPCH22_COUNTERS},
                       launches=launches)
            per_query[name] = rec
            _add(totals, rec["counters"], launches, regions)
            log("tpcds dispatch " + json.dumps(rec))
            if planned and not rec["join_agg_dispatches"]:
                raise AssertionError(f"{name}: its plan holds {planned} "
                                     "and no region dispatched")
    rec_k.check_totals("tpcds dispatch", totals)
    if not totals.get("region_join_agg"):
        raise AssertionError("tpcds dispatch: no join_agg dispatch")
    log("tpcds dispatch totals " + json.dumps(totals))
    name, tok = max(cap.first.items(), key=lambda kv: kv[1].dt.capacity)
    prof = region_dispatch_profile(f"join_agg ({name}, C="
                                   f"{tok.dt.capacity}, W={tok.W}, "
                                   f"out_cap={tok.out_cap})",
                                   _replay_join_agg(tok))
    log("region launches " + json.dumps(prof))
    return dict(per_query=per_query, totals=totals, rec=rec_k,
                profiles=[prof])


REGION_ROWS = 1 << 22


def region_phase(reps: int):
    """The chain and topk regions, which the suites' plans never hold (the
    optimizer pushes their predicates into the scans), over an in-memory
    table of 2^22 rows (int64, float64 and a dictionary-encoded string
    column; 32 morsels of 131,072 rows): a chain (a filter keeping ~1/4 of
    the rows, then a projection) and a topk (a sort on the float column,
    limit 100), each with every region admitted (``DAFT_TORCH_FUSION=1``)
    and held to the same query at ``DAFT_TORCH_FUSION=0`` (the per-operator
    tier); walls (median of ``reps`` after a warm-up), dispatches, and the
    torch launches of one dispatch."""
    import pyarrow as pa
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch import col
    from daft_tpu_torch.device import fragment, runtime
    rng = np.random.default_rng(7)
    n = REGION_ROWS
    words = pa.array(["AAAA", "BBBB", "CCCC", "DDDD", "EEEE", "FFFF"])
    tbl = pa.table({
        "i": rng.integers(0, 1000, n).astype(np.int64),
        "f": rng.normal(size=n),
        "s": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, len(words), n).astype(np.int32)),
            words)})
    # 32 in-memory partitions: one region dispatch each
    from daft_tpu_torch.dataframe import DataFrame
    from daft_tpu_torch.logical.builder import LogicalPlanBuilder
    from daft_tpu_torch.micropartition import MicroPartition
    step = n // 32
    parts = [MicroPartition.from_arrow_table(tbl.slice(i, step))
             for i in range(0, n, step)]
    df = DataFrame(LogicalPlanBuilder.from_in_memory(parts,
                                                     parts[0].schema))
    queries = {
        "chain": lambda: df.where(col("i") < 250).select(
            (col("f") * 2.0 + 1.0).alias("f2"), col("i"), col("s")),
        "topk": lambda: df.sort(col("f"), desc=True).limit(100)}
    out = []
    for name, make in queries.items():
        planned = _region_plan(make())
        if [r[0] for r in planned] != [name]:
            raise AssertionError(f"region {name}: planned {planned}")
        walls, answers, counts = {}, {}, {}
        for mode in ("1", "0"):
            with _env(DAFT_TORCH_FUSION=mode):
                make().to_arrow()      # warm-up, not timed
                ws = []
                for _ in range(reps):
                    runtime.reset_counters()
                    t0 = time.perf_counter()
                    # an Arrow table: the wall is the query's, not a
                    # conversion of a million rows to Python objects
                    answers[mode] = make().to_arrow()
                    torch.cuda.synchronize()
                    ws.append(time.perf_counter() - t0)
                walls[mode], counts[mode] = ws, runtime.counters()
        # the same expressions over the same rows: equal to the bit
        if not answers["1"].equals(answers["0"]):
            raise AssertionError(f"region {name}: the fused answer differs "
                                 "from the per-operator tier's")
        dispatched = counts["1"].get(f"region_{name}", 0)
        if dispatched < 1 or any(k.startswith("region_")
                                 for k in counts["0"]):
            raise AssertionError(f"region {name}: {counts}")
        with _env(DAFT_TORCH_FUSION="1"), \
                _Capture(fragment, "_dispatch_region") as cap:
            cap.query = name
            make().to_arrow()
        tok = cap.first[name]
        prof = region_dispatch_profile(
            f"{name} (C={tok.dt.capacity}, w={tok.out_w})",
            _replay_region(tok))
        rec = dict(region=name, rows=n, planned=planned,
                   out_rows=answers["1"].num_rows,
                   fused_walls_s=walls["1"],
                   fused_median_s=statistics.median(walls["1"]),
                   per_operator_walls_s=walls["0"],
                   per_operator_median_s=statistics.median(walls["0"]),
                   dispatches=dispatched,
                   w_climbs=counts["1"].get("region_w_climbs", 0),
                   declined={k: v for k, v in counts["1"].items()
                             if k.startswith("region_declined_")},
                   per_operator_counters={
                       k: counts["0"].get(k, 0) for k in TPCH22_COUNTERS},
                   profile=prof)
        log("region " + json.dumps(rec))
        out.append(rec)
    return out


def profile_phase(root: str):
    """One traced run of each main-path query and of Q3 (``--profile``):
    host-side time per stage (wall time spent inside each stage; scan
    loads run on pool threads and overlap the rest; Q3's broadcast joins
    run on pool threads too), and the card's busy time from
    ``torch.profiler`` against the traced wall, split into host-to-device
    copies, device-to-host copies, memsets and kernels. Tracing adds its
    own cost: compare the traced wall with the untraced warm wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import daft_tpu_torch as dtt
    from daft_tpu_torch import joins
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import column, fragment
    from daft_tpu_torch.io import readers, scan
    from daft_tpu_torch.recordbatch import RecordBatch
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    agg_stages = {"scan": (scan.ScanTask, "execute"),
                  "encode_h2d": (column, "encode_batch"),
                  "dispatch": (fragment, "submit_fused_agg_tables"),
                  "fetch_decode_ladder": (fragment,
                                          "drain_fused_agg_tables")}
    # Q3's scans stream through the prefetch-pipelined scan source: its
    # stage is each file's parquet read on the producers
    join_stages = {"scan": (readers, "_read_parquet_path"),
                   "factorize": (joins, "_factorize_pair"),
                   "device_h2d_kernels_d2h": (joins, "_device_match_indices"),
                   "take": (joins, "_take_nullable"),
                   "agg": (RecordBatch, "agg")}
    for name in ("q1", "suppkey_agg", "shipdate_agg", "q6", "q3"):
        stages = join_stages if name == "q3" else agg_stages
        acc = {k: 0.0 for k in stages}
        saved = {}
        for key, (owner, attr) in stages.items():
            fn = saved[key] = getattr(owner, attr)

            def timed(*a, _fn=fn, _key=key, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    acc[_key] += time.perf_counter() - t0
            setattr(owner, attr, timed)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                Q.QUERIES[name](get).to_pydict()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for key, (owner, attr) in stages.items():
                setattr(owner, attr, saved[key])
        # device-side events only (kernels, copies, memsets): an aten op's
        # entry repeats the time of the kernels it launched
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")]
        split = {"h2d": 0.0, "d2h": 0.0, "memset": 0.0, "kernels": 0.0}
        for e in dev:
            k = "h2d" if "HtoD" in e.key else "d2h" if "DtoH" in e.key \
                else "memset" if e.key.startswith("Memset") else "kernels"
            split[k] += e.self_device_time_total / 1e6
        busy = sum(split.values())
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        log("profile " + json.dumps({
            "query": name, "traced_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "device_split_s": split,
            "host_stages_s": acc,
            "top_device_ms": [[e.key[:70], e.self_device_time_total / 1e3,
                               e.count] for e in top]}))


def check_registry(kernels: list) -> None:
    """Every kernel entry point ``analysis/dispatch_registry.py`` declares
    launched in this run and was held against its plain twin (its rows in
    the ``kernels`` line, each with an error measured against the plain
    version); the card query entry was called."""
    from daft_tpu_torch.analysis import dispatch_registry as DR
    from daft_tpu_torch.device import hash_kernels as hk
    out = {}
    for e in DR.ENTRIES:
        if e.kind != "kernel":
            info = hk.device_info.cache_info()
            if info.hits + info.misses < 1:
                raise AssertionError(f"registry: {e.entry} never called")
            out[e.entry] = "called"
            continue
        rows = [k for k in kernels if k["name"].split()[0] == e.wrapper[1]]
        if not rows or sum(k["launches"] for k in rows) < 1 or any(
                k["max_abs_err"] is None for k in rows):
            raise AssertionError(f"registry: {e.entry} ({e.wrapper[1]}) "
                                 f"was not launched and held against "
                                 f"{e.plain[1]}")
        out[e.entry] = dict(rows=len(rows),
                            launches=sum(k["launches"] for k in rows))
    log("registry " + json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one run of each main-path query and "
                         "of Q3")
    ap.add_argument("--dispatch-log", default=None, metavar="DIR",
                    help="write the cost model's decisions of each TPC-H "
                         "22 cold run to DIR/q<N>.jsonl")
    ap.add_argument("--sanitize-child", nargs=2, default=None,
                    metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sanitize_child:
        return sanitize_child(*args.sanitize_child)
    # the link profile this run prices with is measured here, on this
    # machine, never read from a store another machine may have written
    os.environ["DAFT_TORCH_LINK_CACHE"] = "0"
    if args.dispatch_log:
        os.makedirs(args.dispatch_log, exist_ok=True)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # fails here (no output yet) when run outside a checkout of the repo
    import daft_tpu_torch  # noqa: F401
    from benchmarking.tpch import datagen  # noqa: F401
    from daft_tpu_torch.device import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    bw = copy_bandwidth()
    log(f"device-to-device copy bandwidth: {bw / 1e9:.1f} GB/s")
    from daft_tpu_torch.device import calibration, costmodel
    t0 = time.perf_counter()
    lp = costmodel.link_profile()
    log("costmodel " + json.dumps({
        "card": card, "link": {"rtt_s": lp.rtt_s, "up_bps": lp.up_bps,
                               "down_bps": lp.down_bps},
        "link_measure_s": time.perf_counter() - t0,
        "constants": costmodel.constants(),
        "calibrated": calibration.calibrated_names()}))

    from daft_tpu_torch.analysis import dispatch_registry
    bad = dispatch_registry.findings()
    if bad:
        raise AssertionError(f"dispatch registry: {bad}")
    t0 = time.perf_counter()
    cuda_build.library()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s (one nvcc for "
        f"each of {len(cuda_build.sources())} sources, all at once, for "
        "sm_90a, one link; loaded with "
        "ctypes)")
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry" in line or "stack frame" in line \
                or "registers" in line:
            log(f"  {line.strip()}")

    def done(phase: str) -> None:
        log(f"phase {phase} done at "
            f"{time.perf_counter() - t_start:.3f} s")

    rng = np.random.default_rng(args.seed)
    kernel_phase(rng, bw, MAIN_C, MAIN_LIVE)
    join_kernel_phase(rng, bw)
    done("3-4")

    root = tpch_root(args.sf)
    mp = main_path(root)
    # depth cut for the memory-bounded phase: at most 2 runs per way
    pipeline_phase(root, mp["ref"], min(args.reps, 2))
    done("5-5b")
    # depth cut for the memory-bounded phase: at most 2 warm repeats
    q3 = q3_path(root, min(args.reps, 2))
    # every join forced to broadcast: the broadcast side's table is
    # rebuilt for each morsel of the other side, as in the reference
    # (one warm run: depth cut to make room for the pipeline phase)
    q3_path(root, 1, ref=q3["ref"], threshold=1 << 40,
            label="q3 forced broadcast")
    done("6")
    t22 = tpch22_phase(root, args.dispatch_log)
    done("7")
    tsql = tpchsql_phase(root, t22)
    done("7b")
    ds_root = tpcds_root(1.0)
    tds = tpcds_phase(ds_root)
    done("7c")
    tdp = tpcds_dispatch_pass(ds_root, tds["answers"], root, t22["answers"])
    region_phase(min(args.reps, 2))  # depth cut, as above
    done("7d-7e")
    ooc = ooc_phase(root)
    done("7f")
    piv = pivot_phase(root)
    done("7g")
    fz = fuzz_phase()
    done("7h")
    rem = remote_phase(root, mp["ref"], q3["ref"], card)
    done("7i")
    ob = obs_phase(root, mp["ref"], q3["ref"], card)
    done("7j")
    san = sanitize_phase(root, mp["ref"], mp, t22)
    done("7k")
    dist = dist_phase(root, mp, q3["ref"], t22, card)
    done("7l")
    srv = serve_phase(root, mp["ref"], q3["ref"], serve_host_free(dict(
        {q: t22["per_query"][q]["counters"] for q in ("q1", "q3", "q6")},
        suppkey_agg=mp["per_query"]["suppkey_agg"]["counters"])), card)
    done("7m")
    # the TPC-DS, memory-bounded, pivot, fuzz and remote rungs whose shape
    # no earlier phase held
    held = {k[1:] for r in (mp["rungs"], t22["rungs"], tsql["rungs"])
            for k in r}
    jheld = {k[1:] for r in (t22["join_rungs"], tsql["join_rungs"])
             for k in r}
    ds_rungs, ds_jrungs = {}, {}
    fuzz_new = {m: {"hash": 0, "join": 0} for m in FUZZ_MODES}
    for rec_k in (tds["rec"], tdp["rec"], ooc["rec"], piv["rec"],
                  fz["rec"], rem["rec"], ob["rec"], san["rec"],
                  dist["rec"], srv["rec"]):
        for k, v in rec_k.hash_rungs().items():
            if k[1:] not in held:
                held.add(k[1:])
                ds_rungs[k] = v
                if rec_k is fz["rec"]:
                    fuzz_new[k[0].split()[-1]]["hash"] += 1
        for k, v in rec_k.join_rungs.items():
            if k[1:] not in jheld:
                jheld.add(k[1:])
                ds_jrungs[k] = dict(v, pass_=rec_k.pass_)
                if rec_k is fz["rec"]:
                    fuzz_new[k[0].split()[-1]]["join"] += 1
    log(f"tpcds, ooc, pivot, fuzz, remote, obs, sanitize, dist and serve "
        f"rungs not held by earlier phases: {len(ds_rungs)} hash, "
        f"{len(ds_jrungs)} join")
    log("sanitize new rungs " + json.dumps(dict(
        hash=sorted(str(list(k)) for k in ds_rungs
                    if k[0].startswith("sanitize")),
        join=sorted(str(list(k)) for k in ds_jrungs
                    if k[0].startswith("sanitize")))))
    log("remote new rungs " + json.dumps(dict(
        hash=sorted(str(list(k)) for k in ds_rungs
                    if k[0].startswith("remote")),
        join=sorted(str(list(k)) for k in ds_jrungs
                    if k[0].startswith("remote")))))
    log("fuzz new rungs " + json.dumps(fuzz_new))
    for pre in ("dist", "serve"):
        log(f"{pre} new rungs " + json.dumps(dict(
            hash=sorted(str(list(k)) for k in ds_rungs
                        if k[0].startswith(pre)),
            join=sorted(str(list(k)) for k in ds_jrungs
                        if k[0].startswith(pre)))))
    krecs = main_path_kernel_timing(mp["rungs"], bw)
    krecs += main_path_kernel_timing(t22["rungs"], bw)
    krecs += main_path_kernel_timing(tsql["rungs"], bw)
    krecs += main_path_kernel_timing(ds_rungs, bw)
    jrec = join_main_path_timing(q3, bw)
    jrecs = join_rung_timing(t22["join_rungs"], bw)
    jrecs += join_rung_timing(tsql["join_rungs"], bw)
    jrecs += join_rung_timing(ds_jrungs, bw)
    if args.profile:
        profile_phase(root)

    # one row per distinct hash rung of the main path
    kernels = [{
        "name": f"hash_agg_build ({k['query']}, T={k['T']})",
        "route": "cuda", "source": "daft_tpu_torch/csrc/hash_agg.cu",
        "replaces": "daft_tpu/device/pallas_kernels.py:192",
        "launches": k["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "path": k["path"],
        # the run whose launches these are: the default (cost model) or
        # the dispatch pass at the 4,096-row floor
        "pass": k["pass_"],
        # device time of the counted run's launches at this rung, summed
        "main_path_ms_sum": k["main_path_ms_sum"],
        # no single PyTorch call computes a hash group-by with these
        # count/sum/sumsq/min/max/first planes and the overflow count
        "library_ms": None} for k in krecs]
    for kname, pre, line in (("hash_join_build", "build", 455),
                             ("hash_join_probe", "probe", 533)):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "daft_tpu_torch/csrc/hash_join.cu",
            "replaces": f"daft_tpu/device/pallas_kernels.py:{line}",
            "launches": q3["launches"][kname],
            # integer outputs, compared exactly
            "max_abs_err": 0.0,
            "ms": jrec[f"{pre}_ms"], "plain_ms": jrec[f"{pre}_plain_ms"],
            "bound_ms": jrec[f"{pre}_bound_ms"], "bound_by": "bytes",
            "main_path_ms_sum": q3["kernel_ms"][kname], "pass": "default",
            # device activities (kernels, memsets) of one call, and the
            # host time of one call enqueued back to back
            "launches_per_call": jrec[f"{pre}_launches_per_call"],
            "host_ms": jrec[f"{pre}_host_ms"],
            # the torch sort join (build + probe + expand) on the same
            # inputs, for comparison; it is the port's `sort` strategy
            "sort_join_ms": jrec["sort_join_ms"],
            # no single PyTorch call generates join index pairs
            "library_ms": None})
    # one row per kernel per distinct join rung of the TPC-H 22 phase
    for j in jrecs:
        for kname, pre, line in (("hash_join_build", "build", 455),
                                 ("hash_join_probe", "probe", 533)):
            if not j["launches"][kname]:
                continue  # an overflow rung re-probes an earlier table
            kernels.append({
                "name": f"{kname} ({j['query']}, C_r={j['C_r']}, "
                        f"C_l={j['C_l']}, cap={j['cap']})",
                "route": "cuda",
                "source": "daft_tpu_torch/csrc/hash_join.cu",
                "replaces": f"daft_tpu/device/pallas_kernels.py:{line}",
                "launches": j["launches"][kname], "max_abs_err": 0.0,
                "ms": j[f"{pre}_ms"], "plain_ms": j[f"{pre}_plain_ms"],
                "bound_ms": j[f"{pre}_bound_ms"], "bound_by": "bytes",
                "main_path_ms_sum": j["main_path_ms_sum"][kname],
                "pass": j.get("pass_", "floor4096"),
                "host_ms": j[f"{pre}_host_ms"],
                "sort_join_ms": j["sort_join_ms"], "library_ms": None})
    check_registry(kernels)
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke total wall: {time.perf_counter() - t_start:.3f} s")
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
