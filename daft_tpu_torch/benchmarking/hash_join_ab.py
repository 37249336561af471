"""The hash-join build and probe (``csrc/hash_join.cu``) against the
kernels of commit 187aff2, on one CUDA card, in the same call.

The baseline is the four-entry kernel set of that commit: claim/count, a
torch cumsum, scatter, a sort of every segment (one thread up to 32 rows,
one block beyond), and a probe of count, cumsum and emit, with the planes
filled by torch around them. Its source is not in the tree; write it out
first:

    git show 187aff2:daft_tpu_torch/csrc/hash_join.cu > daft_tpu_torch/_build/hash_join_base.cu
    python3 -m daft_tpu_torch.benchmarking.hash_join_ab \\
        --baseline-source daft_tpu_torch/_build/hash_join_base.cu

It builds the baseline with ``nvcc`` under its own symbols, with the
wrapper it had (kept here), and a second copy of it without the one
atomic per claimed slot on a single counter (``baseline_nocount``: the
attribution of that atomic alone; its key count is not kept). Then:

1. prints ``-Xptxas -v`` (registers, stack frame, spills) of the join
   kernels of each library;
2. runs TPC-H Q3 at SF1 (from ``chip_smoke.tpch_root``) once as planned and
   once with every join forced to broadcast, recording every build's and
   probe's inputs;
3. at the inputs of Q3's two joins and of ``chip_smoke.join_cases``
   (full size): every build checked against the plain version (key →
   ordered rows, the key count) and every probe element for element, then
   timed in turns (baseline, new, new, baseline; CUDA events, median),
   with the host time of one call (calls enqueued back to back), one
   call's device activities from ``torch.profiler`` (kernel names, their
   device time, launches per call) and the byte bounds of ``chip_smoke``;
4. replays the forced-broadcast run's 16 builds and probes through each
   kernel set in turns, summing the events.

Every result is a JSON line on stdout and in ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import cuda_build
from ..device import join_kernels as jk

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ------------------------------------------------------------- the baseline

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BASE_ENTRIES = {
    "daft_hash_join_build_claim": [_P, _P, _L, _I, _P, _P, _P, _P, _P],
    "daft_hash_join_build_scatter": [_P, _L, _I, _P, _P, _P, _P, _P, _P],
    "daft_hash_join_probe_count": [_P, _P, _L, _I, _P, _P, _P, _P, _P],
    "daft_hash_join_probe_emit": [_P, _P, _P, _L, _P, _P, _L, _P, _P, _P],
}


class Baseline:
    """The baseline kernels under the symbol suffix ``suffix``, driven by
    the wrapper they had."""

    def __init__(self, src: str, suffix: str):
        out = os.path.join(cuda_build.BUILD_DIR,
                           f"libdaft_hash_join{suffix}.so")
        t0 = time.perf_counter()
        self.log = cuda_build.compile_library(
            [src], out, [f"-D{e}={e}{suffix}" for e in _BASE_ENTRIES])
        self.seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        self.fn = {}
        for name, argtypes in _BASE_ENTRIES.items():
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.fn[name] = fn

    def build(self, code, live, T):
        C = code.shape[0]
        dev = code.device
        i32 = dict(dtype=torch.int32, device=dev)
        tk = torch.full((T + 1,), jk.EMPTY, dtype=torch.int64, device=dev)
        cnt = torch.zeros(T + 1, **i32)
        off = torch.zeros(T + 2, **i32)
        slot_of = torch.empty(C, **i32)
        fill = torch.zeros(T + 1, **i32)
        rows = torch.full((C,), -1, **i32)
        long_list = torch.empty(T + 1, **i32)
        info = torch.zeros(4, **i32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(self.fn["daft_hash_join_build_claim"](
            code.data_ptr(), live.data_ptr(), C, T, tk.data_ptr(),
            cnt.data_ptr(), slot_of.data_ptr(), info.data_ptr(), stream),
            "baseline build")
        torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
        cuda_build.check(self.fn["daft_hash_join_build_scatter"](
            slot_of.data_ptr(), C, T, off.data_ptr(), fill.data_ptr(),
            rows.data_ptr(), long_list.data_ptr(), info.data_ptr(), stream),
            "baseline build")
        return jk.JoinTable(tk, off, rows, info[0], info[1], T)

    def probe(self, code, live, table, cap):
        C = code.shape[0]
        dev = code.device
        packed = torch.zeros((3, max(cap, C)), dtype=torch.int32, device=dev)
        pslot = torch.empty(C, dtype=torch.int32, device=dev)
        incl = torch.empty(C, dtype=torch.int64, device=dev)
        counts = packed[2, :C]
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(self.fn["daft_hash_join_probe_count"](
            code.data_ptr(), live.data_ptr(), C, table.T,
            table.tk.data_ptr(), table.off.data_ptr(), pslot.data_ptr(),
            counts.data_ptr(), stream), "baseline probe")
        torch.cumsum(counts, 0, dtype=torch.int64, out=incl)
        cuda_build.check(self.fn["daft_hash_join_probe_emit"](
            pslot.data_ptr(), counts.data_ptr(), incl.data_ptr(), C,
            table.off.data_ptr(), table.rows.data_ptr(), cap,
            packed[0].data_ptr(), packed[1].data_ptr(), stream),
            "baseline probe")
        return packed


def without_claim_count(src: str) -> str:
    """The baseline's source without its atomic on the claim counter
    (``info[0]``, one per claimed slot)."""
    with open(src) as f:
        text = f.read()
    cut = text.replace("atomicAdd(&info[0], 1);", ";")
    if cut == text:
        raise RuntimeError(f"{src}: no claim counter atomic to remove")
    out = os.path.join(cuda_build.BUILD_DIR, "hash_join_base_nocount.cu")
    with open(out, "w") as f:
        f.write(cut)
    return out


# ---------------------------------------------------------------- helpers

def ptxas_lines(log: str):
    """The ``-Xptxas -v`` lines of the join kernels."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "hash_join" in line
        if keep:
            out.append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-source", required=True)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        cuda_build.BUILD_DIR, "hash_join_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_join_ab: no CUDA device", file=sys.stderr)
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
    base = Baseline(args.baseline_source, "_base")
    nocount = Baseline(without_claim_count(args.baseline_source), "_nocount")
    for name, b in (("baseline", base), ("baseline_nocount", nocount)):
        emit("build", library=name, seconds=b.seconds,
             ptxas=ptxas_lines(b.log))
    cuda_build.library()
    emit("build", library="new", seconds=cuda_build.build_seconds,
         ptxas=ptxas_lines(cuda_build.build_log))

    builders = {"baseline": base.build, "baseline_nocount": nocount.build,
                "new": jk.hash_join_build_cuda}
    probers = {"baseline": base.probe, "new": jk.hash_join_probe_cuda}

    # ---- the main path's inputs: every build and probe of Q3, as planned
    # and with every join forced to broadcast
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    root = cs.tpch_root(args.sf)
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    orig_b, orig_p = jk.hash_join_build_cuda, jk.hash_join_probe_cuda
    recorded = {}

    def run_q3(label, threshold):
        calls = recorded[label] = []

        def build(code, live, T):
            table = orig_b(code, live, T)
            calls.append([code, live, T, table])
            return table

        def probe(code, live, table, cap):
            next(c for c in calls if c[3] is table).append((code, live, cap))
            return orig_p(code, live, table, cap)
        jk.hash_join_build_cuda, jk.hash_join_probe_cuda = build, probe
        try:
            with (dtt.execution_config_ctx(
                    broadcast_join_size_bytes_threshold=threshold)
                  if threshold else contextlib.nullcontext()):
                Q.q3(get).to_pydict()
        finally:
            jk.hash_join_build_cuda, jk.hash_join_probe_cuda = orig_b, orig_p
        torch.cuda.synchronize()
    run_q3("q3", None)
    run_q3("q3_forced_broadcast", 1 << 40)

    def check_build(name, table, ref, r_code, n_live):
        kg, rg, og = cs._table_order(table, r_code, n_live)
        kr, rr, orr = cs._table_order(ref, r_code, n_live)
        if not (torch.equal(kg[og], kr[orr]) and torch.equal(rg[og], rr[orr])):
            raise AssertionError(f"{name}: build key → rows differ")
        if name != "baseline_nocount" and int(table.n_keys) != int(ref.n_keys):
            raise AssertionError(f"{name}: key count differs")

    def turns(fns, reps):
        order = list(fns) + list(fns)[::-1]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cs.cuda_ms(fns[k], reps=reps))
        return times

    def measure(label, r_code, r_live, T, l_code, l_live, cap):
        ref = jk.hash_join_build_plain(r_code, r_live, T)
        ref_packed = jk.hash_join_probe_plain(l_code, l_live, ref, cap)
        n_live = int(r_live.sum())
        rec = dict(label, C_r=r_code.shape[0], live_r=n_live,
                   C_l=l_code.shape[0], live_l=int(l_live.sum()), T=T,
                   cap=cap, keys=int(ref.n_keys),
                   total=int(ref_packed[2].sum()))
        tables = {}
        for name, b in builders.items():
            tables[name] = b(r_code, r_live, T)
            check_build(name, tables[name], ref, r_code, n_live)
        for name, p in probers.items():
            if not torch.equal(p(l_code, l_live, tables[name], cap),
                               ref_packed):
                raise AssertionError(f"{name}: probe differs")
        bfns = {k: (lambda b=b: b(r_code, r_live, T))
                for k, b in builders.items()}
        pfns = {k: (lambda p=p, t=tables[k]: p(l_code, l_live, t, cap))
                for k, p in probers.items()}
        for kind, fns in (("build", bfns), ("probe", pfns)):
            for name, ts in turns(fns, args.reps).items():
                rec[f"{kind}_{name}_ms"] = min(ts)
                rec[f"{kind}_{name}_ms_turns"] = ts
                rec[f"{kind}_{name}_host_ms"] = cs.host_ms(fns[name],
                                                           args.reps)
                acts = cs.device_activities(fns[name], 5)
                rec[f"{kind}_{name}_device_ms"] = sum(
                    ms for _, ms in acts.values())
                rec[f"{kind}_{name}_launches_per_call"] = sum(
                    c for c, _ in acts.values())
                rec[f"{kind}_{name}_device_activities"] = acts
        b_bytes = cs.join_build_bytes(r_live, T)
        p_bytes = cs.join_probe_bytes(l_live, ref_packed, cap)
        rec.update(build_bound_ms=b_bytes / cs.HBM_BYTES_PER_S * 1e3,
                   probe_bound_ms=p_bytes / cs.HBM_BYTES_PER_S * 1e3)
        return rec

    for i, c in enumerate(recorded["q3"]):
        emit("q3_join", **measure(dict(join=i + 1), *c[:3], *c[4]))
    rng = np.random.default_rng(args.seed)
    for case in cs.join_cases(rng, cs.JOIN_C_R, cs.JOIN_LIVE_R,
                              cs.JOIN_C_L):
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).cuda()
        r_code, r_live = t(case["r_code"]), t(case["r_live"])
        emit("case", **measure(
            dict(case=case["name"]), r_code, r_live,
            jk.join_table_capacity(r_code.shape[0]), t(case["l_code"]),
            t(case["l_live"]), case["cap"]))

    # ---- the forced-broadcast run's builds and probes replayed, in turns
    calls = recorded["q3_forced_broadcast"]
    for name in ("baseline", "new", "new", "baseline"):
        torch.cuda.synchronize()
        evs = {"build": [], "probe": []}
        for r_code, r_live, T, _, *probes in calls:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            table = builders[name](r_code, r_live, T)
            ev[1].record()
            for l_code, l_live, cap in probes:
                probers[name](l_code, l_live, table, cap)
            ev[2].record()
            evs["build"].append((ev[0], ev[1]))
            evs["probe"].append((ev[1], ev[2]))
        torch.cuda.synchronize()
        emit("replay_forced_broadcast", kernels=name, builds=len(calls),
             probes=sum(len(c) - 4 for c in calls),
             **{f"{k}_ms_sum": sum(a.elapsed_time(b) for a, b in v)
                for k, v in evs.items()})
    emit("done", card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
