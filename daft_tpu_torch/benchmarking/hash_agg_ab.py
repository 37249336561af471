"""The hash grouped-agg table build (``csrc/hash_agg.cu``) against a
baseline build kernel, on one CUDA card, at the main path's inputs.

The baseline is the one-thread-per-row kernel of commit 5a469ee (one
global atomic per plane per row, a ``torch.zeros``/``torch.full`` per
plane around it). Its source is not in the tree; write it out first:

    git show 5a469ee:daft_tpu_torch/csrc/hash_agg.cu > daft_tpu_torch/_build/hash_agg_base.cu
    python3 -m daft_tpu_torch.benchmarking.hash_agg_ab \\
        --baseline-source daft_tpu_torch/_build/hash_agg_base.cu

It builds the baseline with ``nvcc`` under its own symbol, with the wrapper
it had (kept here), and then:

1. prints ``-Xptxas -v`` (registers, stack frame, spills) of the build
   kernels of both libraries;
2. runs the ``l_suppkey`` and ``l_shipdate`` group-bys of TPC-H SF1 (from
   ``chip_smoke.tpch_root``) once, recording every table build's inputs;
3. per distinct rung (query, T, key words): both builds checked against
   the plain version, then timed in turns (baseline, new, new, baseline;
   CUDA events, median), with the plain time and the byte bound
   (``chip_smoke.build_bytes``), the host time of one call (calls
   enqueued back to back), and a ``torch.profiler`` split of one
   call's device time into the build's own kernels, memsets and other
   kernels (fills, conversions), with the kernels' names;
4. replays all recorded builds through each kernel, summing the events;
5. sweeps C = 2^20 with 750k live rows: distinct planes 1 → 14 at 2,500
   groups, then groups 4 → 10,000 at 9 planes;
6. times the new build's two paths on the same inputs (the shared-memory
   rule forced each way) at T = 256 and 1,024, from 5 groups to a table
   that fills.

``--baseline-only`` times the baseline alone (the main path's inputs are
then recorded through the plain version on the card). Every result is a
JSON line on stdout and in ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import cuda_build
from ..device import hash_kernels as hk

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ------------------------------------------------------------- the baseline

_B_VTYPE = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
            torch.int32: 3, torch.int64: 4, torch.float32: 5,
            torch.float64: 6}
_B_KIND = {"cnt": 0, "sum": 1, "sumsq": 2, "min": 3, "max": 4, "first": 5}
_B_PTYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
            torch.float64: 3}


def baseline_library(src: str):
    out = os.path.join(cuda_build.BUILD_DIR, "libdaft_hash_agg_base.so")
    t0 = time.perf_counter()
    log = cuda_build.compile_library(
        [src], out, ["-Ddaft_hash_agg_build=daft_hash_agg_build_base"])
    secs = time.perf_counter() - t0
    lib = ctypes.CDLL(out)
    fn = lib.daft_hash_agg_build_base
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return fn, log, secs


def _base_plane_dtype(kind, dt):
    if kind == "first":
        return torch.int32
    if dt in (torch.int8, torch.int16, torch.uint8):
        return torch.int32
    return dt


def baseline_build(fn, words, live, vals, contribs, specs, T):
    """The baseline's wrapper: every plane allocated and filled on its
    own, the kernel, then the conversions the post-pass needs."""
    C = live.shape[0]
    dev = live.device
    tk = [torch.zeros(T, dtype=torch.int64, device=dev) for _ in words]
    state = torch.zeros(T, dtype=torch.int32, device=dev)
    frow = torch.full((T,), C, dtype=torch.int32, device=dev)
    info = torch.zeros(8, dtype=torch.int32, device=dev)
    kplanes = []
    for vi, op, kind, dt in specs:
        fill = C if kind == "first" else hk._identity(kind, dt)
        kplanes.append(torch.full((T,), fill, device=dev,
                                  dtype=_base_plane_dtype(kind, dt)))
    i32 = lambda xs: np.array(xs, dtype=np.int32)  # noqa: E731
    u64 = lambda xs: np.array(xs, dtype=np.uint64)  # noqa: E731
    kinds = i32([_B_KIND[s[2]] for s in specs])
    vt = i32([_B_VTYPE[vals[s[0]].dtype] for s in specs])
    pt = i32([_B_PTYPE[p.dtype] for p in kplanes])
    vp = u64([vals[s[0]].data_ptr() for s in specs])
    cp = u64([contribs[s[0]].data_ptr() for s in specs])
    pp = u64([p.data_ptr() for p in kplanes])
    two = len(words) == 2
    rc = fn(words[0].data_ptr(), words[1].data_ptr() if two else 0,
            live.data_ptr(), C, len(words), T, tk[0].data_ptr(),
            tk[1].data_ptr() if two else 0, state.data_ptr(),
            frow.data_ptr(), info.data_ptr(), len(specs), kinds.ctypes.data,
            vt.ctypes.data, pt.ctypes.data, vp.ctypes.data, cp.ctypes.data,
            pp.ctypes.data, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline build refused ({rc})")
    planes = [p.to(torch.int64) if s[2] == "first" else p.to(s[3])
              for s, p in zip(specs, kplanes)]
    return tk, state == 2, frow.to(torch.int64), planes, \
        info[0].to(torch.int64)


# ---------------------------------------------------------------- helpers

def ptxas_lines(log: str):
    """The ``-Xptxas -v`` lines of the build kernels (the function line
    and its registers/stack/spill lines)."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "hash_agg" in line
        if keep:
            out.append(line.strip())
    return out


def device_split(fn, n: int = 5):
    """``torch.profiler`` device time of one call of ``fn`` (mean of
    ``n``), ms: the build's own kernels, memsets, other kernels; and per
    device activity its launches and ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {"build_kernels_ms": 0.0, "memset_ms": 0.0,
             "other_kernels_ms": 0.0}
    names = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith("Activity Buffer"):
            continue
        k = "memset_ms" if e.key.startswith("Memset") else \
            "build_kernels_ms" if "hash_agg" in e.key else \
            "other_kernels_ms"
        split[k] += e.self_device_time_total / n / 1e3
        names[e.key[:90]] = [e.count / n, e.self_device_time_total / n / 1e3]
    split["launches_per_call"] = sum(c for c, _ in names.values())
    split["device_activities"] = names   # name: [per call, ms per call]
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-source", required=True)
    ap.add_argument("--baseline-only", action="store_true")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        cuda_build.BUILD_DIR, "hash_agg_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_agg_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    results = []

    def emit(kind, **rec):
        rec = {"what": kind, **rec}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    emit("card", card=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    base_fn, base_log, base_s = baseline_library(args.baseline_source)
    emit("build", library="baseline", seconds=base_s,
         ptxas=ptxas_lines(base_log))
    new = not args.baseline_only
    if new:
        cuda_build.library()
        emit("build", library="new", seconds=cuda_build.build_seconds,
             ptxas=ptxas_lines(cuda_build.build_log),
             device=hk.device_info(torch.cuda.current_device())._asdict())

    # ---- the main path's inputs: every table build of the two group-bys
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    root = cs.tpch_root(args.sf)
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    records = []
    orig_build, orig_cuda = hk.hash_agg_build, hk.hash_agg_build_cuda
    query = [None]

    def recording(*a):
        records.append((query[0],) + a)
        return orig_build(*a)
    hk.hash_agg_build = recording
    if not new:
        hk.hash_agg_build_cuda = hk.hash_agg_build_plain
    try:
        for q in ("suppkey_agg", "shipdate_agg"):
            query[0] = q
            Q.QUERIES[q](get).to_pydict()
    finally:
        hk.hash_agg_build, hk.hash_agg_build_cuda = orig_build, orig_cuda
    torch.cuda.synchronize()

    def runners(words, live, vals, contribs, specs, T):
        fns = {"baseline": lambda: baseline_build(
            base_fn, words, live, vals, contribs, specs, T)}
        if new:
            fns["new"] = lambda: hk.hash_agg_build(
                words, live, vals, contribs, specs, T)
        return fns

    def measure(label, words, live, vals, contribs, specs, T, reps,
                profile=True, **extra):
        ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs, T)
        fns = runners(words, live, vals, contribs, specs, T)
        rec = dict(label, groups=int(ref[4]), C=live.shape[0],
                   live=int(live.sum()), T=T, words=len(words),
                   specs=len(specs),
                   distinct_planes=len(hk.plane_aliases(
                       specs, vals, contribs)[0]), **extra)
        for name, fn in fns.items():
            rec[f"{name}_max_abs_err"] = cs.compare_builds(
                fn(), ref, specs, words, live, vals, contribs, T)
        order = list(fns) + list(fns)[::-1]
        times = {k: [] for k in fns}
        for name in order:
            times[name].append(cs.cuda_ms(fns[name], reps=reps))
        for name, ts in times.items():
            rec[f"{name}_ms"] = min(ts)
            rec[f"{name}_ms_turns"] = ts
            # host time of one call: calls enqueued back to back
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fns[name]()
            rec[f"{name}_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
        rec["plain_ms"] = cs.cuda_ms(lambda: hk.hash_agg_build_plain(
            words, live, vals, contribs, specs, T), reps=5, warm=1)
        nbytes = cs.build_bytes(words, live, vals, contribs, specs, T)
        rec.update(bytes=nbytes, bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3)
        if profile:
            for name, fn in fns.items():
                rec[f"{name}_profile"] = device_split(fn)
        return rec

    # ---- every distinct rung
    rungs = {}
    for r in records:
        key = (r[0], r[6], len(r[1]))
        rungs.setdefault(key, []).append(r)
    for (q, T, nw), rs in rungs.items():
        emit("rung", **measure(dict(query=q), *rs[0][1:], reps=args.reps,
                               launches=len(rs)))

    # ---- replay of every recorded build, summed (in turns)
    for name in (["baseline", "new", "new", "baseline"] if new
                 else ["baseline", "baseline"]):
        torch.cuda.synchronize()
        evs = []
        for r in records:
            fn = runners(*r[1:])[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        emit("replay", kernel=name, launches=len(records),
             ms_sum=sum(a.elapsed_time(b) for a, b in evs))

    # ---- sweeps at C = 2^20, 750k live rows (1-word keys)
    rng = np.random.default_rng(args.seed)
    kinds = ("cnt", "sum", "min", "max", "sumsq", "first")
    C, live_n = cs.MAIN_C, 750_000

    def sweep_case(n_planes, groups):
        case = cs.make_case(rng, C, live_n, "int32", groups,
                            ("sum",) * n_planes, ("f64",) * n_planes)
        words, live, vals, contribs, _ = cs.case_tensors(case, "cuda")
        specs = [(i, "sweep", kinds[i % len(kinds)],
                  torch.int32 if kinds[i % len(kinds)] == "cnt"
                  else torch.float64) for i in range(n_planes)]
        return words, live, vals, contribs, specs, hk.table_capacity(groups)
    for n_planes in (1, 2, 4, 7, 9, 14):
        emit("sweep_planes", **measure(
            dict(sweep="planes"), *sweep_case(n_planes, 2500),
            reps=args.reps // 2, profile=False))
    for groups in (4, 64, 500, 2500, 10_000):
        emit("sweep_groups", **measure(
            dict(sweep="groups"), *sweep_case(9, groups),
            reps=args.reps // 2, profile=False))
    # ---- both paths of the new build on the same inputs (the rule forced
    # each way), where the table fits shared memory
    if new:
        rule = hk.uses_shared_table
        ops = ("sum", "sum", "mean", "count", "count", "max")
        for T, groups in ((256, 5), (256, 64), (256, 200), (256, 2500),
                          (1024, 5), (1024, 256), (1024, 500), (1024, 5000)):
            case = cs.make_case(rng, C, live_n, "int32", groups, ops,
                                ("f64",) * len(ops))
            words, live, vals, contribs, specs = cs.case_tensors(case, "cuda")
            ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs,
                                          T)
            rec = dict(T=T, groups=int(ref[4]), natural=cs.build_path(
                words, vals, contribs, specs, T))
            try:
                for path in ("shared", "global", "global", "shared"):
                    hk.uses_shared_table = lambda *a, _p=path: _p == "shared"
                    hk._plan.cache_clear()
                    fn = lambda: hk.hash_agg_build(  # noqa: E731
                        words, live, vals, contribs, specs, T)
                    cs.compare_builds(fn(), ref, specs, words, live, vals,
                                      contribs, T)
                    rec.setdefault(f"{path}_ms", []).append(
                        cs.cuda_ms(fn, reps=args.reps // 2))
                    rec.setdefault(f"{path}_device_ms", []).append(
                        device_split(fn)["build_kernels_ms"])
            finally:
                hk.uses_shared_table = rule
                hk._plan.cache_clear()
            emit("paths", **rec)
    emit("done", card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
