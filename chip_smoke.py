#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. the card's name and power limit, and its device-to-device copy
   bandwidth (the yardstick the kernel's bound is also given against);
2. build of the CUDA kernels from ``daft_tpu_torch/csrc`` (one ``nvcc``
   for sm_90a into a shared library loaded with ctypes; its seconds and
   ``-Xptxas -v`` lines are printed);
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
   ``daft_tpu_torch.read_parquet`` on ``cuda``; every answer is held
   against pyarrow on the same files, and the port's counters must show
   the kernels ran and no morsel fell to the host tier;
6. join path: TPC-H Q3 at SF1 (customer ⋈ orders ⋈ lineitem, then a
   group-by and a top 10) through the same entry points, one counted cold
   run and warm repeats; the answer is held against pyarrow
   (``pa.Table.join`` plus ``group_by``) and the counters must show every
   join on the device with the hash strategy (no host join), one build
   launch per device join and one probe launch per dispatch;
7. the hash build against its plain version at the inputs of every
   distinct hash rung of the main path (query, T, key words), and the
   join kernels at Q3's lineitem join;
8. a ``{"kernels": [...]}`` line with each kernel's launches, times and
   bound (one row per hash rung; the join kernels also with their device
   activities and host time per call), then the card line and the final
   ``{"ok": true, ...}`` line.

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
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate (700 W)
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


def main_path(root: str, reps: int):
    """Drive the port's entry points once with counters zeroed (the counted
    run), check answers and counters, then time warm repeats."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import hash_kernels as hk, runtime
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    t0 = time.perf_counter()
    ref = pyarrow_answers(root)
    log(f"pyarrow reference answers: {time.perf_counter() - t0:.3f} s")
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
                             dict(args=a, launches=0, ms_sum=0.0))
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
        log(f"main path {name}: answer matches pyarrow; " + json.dumps(pq))
    if main_launches <= 0:
        raise AssertionError("hash kernel launched no time on the main path")
    if sum(r["launches"] for r in rungs.values()) != main_launches:
        raise AssertionError(f"hash launches {main_launches} != the builds "
                             "recorded at the rungs")
    # ---- warm timings (not counted)
    rows = ref["rows"]
    timings = {}
    for name in ("q1", "suppkey_agg", "shipdate_agg", "q6"):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            Q.QUERIES[name](get).to_pydict()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        w = statistics.median(walls)
        timings[name] = dict(warm_s=w, rows=rows, rows_per_s=rows / w,
                             walls=walls)
        log(f"main path {name}: warm {w:.6f} s (median of {reps}), "
            f"{rows / w:.1f} lineitem rows/s")
    return dict(counters=counters, launches=main_launches,
                per_query=per_query, timings=timings,
                kernel_ms_sum=sum(a.elapsed_time(b) for a, b in events),
                rungs=rungs)


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
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_measured_bw_ms=nbytes / bw * 1e3)
        log("kernel at main-path inputs " + json.dumps(rec))
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
    from daft_tpu_torch.io import scan
    from daft_tpu_torch.recordbatch import RecordBatch
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    agg_stages = {"scan": (scan.ScanTask, "execute"),
                  "encode_h2d": (column, "encode_batch"),
                  "dispatch": (fragment, "submit_fused_agg_table"),
                  "fetch_decode_ladder": (fragment, "drain_fused_agg_table")}
    join_stages = {"scan": (scan.ScanTask, "execute"),
                   "factorize": (joins, "_factorize_pair"),
                   "device_h2d_kernels_d2h": (joins, "_device_match_indices"),
                   "take": (joins, "_take_nullable"),
                   "host_agg": (RecordBatch, "agg")}
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one run of each main-path query and "
                         "of Q3")
    args = ap.parse_args()

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

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s (one nvcc of "
        f"{len(cuda_build.sources())} sources for sm_90a, loaded with "
        "ctypes)")
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry" in line or "stack frame" in line \
                or "registers" in line:
            log(f"  {line.strip()}")

    rng = np.random.default_rng(args.seed)
    kernel_phase(rng, bw, MAIN_C, MAIN_LIVE)
    join_kernel_phase(rng, bw)

    root = tpch_root(args.sf)
    mp = main_path(root, args.reps)
    q3 = q3_path(root, args.reps)
    # every join forced to broadcast: the broadcast side's table is
    # rebuilt for each morsel of the other side, as in the reference
    q3_path(root, args.reps, ref=q3["ref"], threshold=1 << 40,
            label="q3 forced broadcast")
    krecs = main_path_kernel_timing(mp["rungs"], bw)
    jrec = join_main_path_timing(q3, bw)
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
            "main_path_ms_sum": q3["kernel_ms"][kname],
            # device activities (kernels, memsets) of one call, and the
            # host time of one call enqueued back to back
            "launches_per_call": jrec[f"{pre}_launches_per_call"],
            "host_ms": jrec[f"{pre}_host_ms"],
            # the torch sort join (build + probe + expand) on the same
            # inputs, for comparison; it is the port's `sort` strategy
            "sort_join_ms": jrec["sort_join_ms"],
            # no single PyTorch call generates join index pairs
            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
