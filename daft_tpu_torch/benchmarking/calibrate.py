"""Measure the cost model's constants (``device/costmodel.py``) on this
machine: the card's link and kernel rates and the host tier's rates.

    python3 -m daft_tpu_torch.benchmarking.calibrate [--rows N] [--out FILE]
        [--only spill_disk|pil_resize]

Runs on ``cuda`` (``--device cpu`` rehearses the script on CPU tensors:
its numbers are the CPU's and name it). Prints one JSON line each for:

- ``card``: ``nvidia-smi``'s name and power limit, torch's versions;
- ``link``: one fresh ``costmodel._measure`` (RTT, up and down rates
  through the port's pinned staging and copy stream);
- ``mfu``: ``mfu.report(N)``, every kernel family on device-resident
  inputs at N rows (default 2^20, the fused fragment's capacity);
- ``op_floor``: ``op_floor.measure`` of each per-operator path at 256
  rows and at N rows (host and device walls, medians of ``--reps``
  rounds in turns);
- ``host_vector``: the host tier's evaluation of two arithmetic
  projections and two predicates (the expression alone: a filter's
  take, which both tiers run on the host, is left out) at N rows, median
  of ``--reps``;
- ``host_join``: the host tier's index generation
  (``joins.match_indices``, forced to the host) over two N-row sides of
  keys drawn from N / 2 values, median of 5;
- ``region_join_agg``: the join_agg fusion region's program (one probe
  partition of n rows joined to a 1,024-row build and summed into 64
  groups, ``DAFT_TORCH_FUSION=1``) at ``REGION_ROWS``: the device time
  of one dispatch (the ledger's ``region`` seconds over its dispatches),
  median of ``--reps`` runs;
- ``spill_disk``: one N-row batch (``op_floor.make_batch`` plus a
  dictionary-coded string column) written to an Arrow IPC spill file
  through ``execution.memory.SpillBuffer`` (budget 1 byte, so every
  append spills; the default codec, lz4) and read back, medians of
  ``--reps``; ``SPILL_DISK_BPS`` is the batch's logical bytes over the
  mean of the write and read walls (per byte per direction, as
  ``costmodel.spill_plan_wins`` charges it). ``--only spill_disk`` runs
  the card line and this line alone;
- ``pil_resize``: where Pillow imports, the per-image host path of
  ``image.resize`` (``PIL.Image.resize``, one core) over ``PIL_IMAGES``
  seeded 64x64 RGB images resized to 32x32, median of ``--reps``;
  ``HOST_PIL_BPS`` is their input bytes over the wall (the reference's
  shape for the constant); ``{"pillow": false}`` without Pillow.
  ``--only pil_resize`` runs the card line and this line alone;
- ``constants``: what the measurements give the cost model, each with its
  derivation — ``HOST_VECTOR_BPS`` (the median over the four
  ``host_vector`` expressions of (Arrow bytes in + bytes out) / wall),
  ``HOST_AGG_BPS`` (the geometric mean over the grouped and global aggs
  of Arrow bytes in / host wall: one coarse rate for two families a few
  times apart), ``HOST_SORT_ROWS_PER_S`` (key-rows / host wall),
  ``HOST_JOIN_ROWS_PER_S`` (rows of both sides / wall); ``DEV_*`` rates
  from ``mfu`` (encoded bytes or rows over kernel time); and
  ``DEV_DISPATCH_S``, the median over the five paths of the device wall
  at 256 rows less two round trips; ``DEV_REGION_DISPATCH_S`` and
  ``DEV_REGION_JOIN_AGG_ROWS_PER_S``, the line through the region's two
  points (its fixed time per dispatch, most of it the ~120 launches of
  its torch ops, and its rate per probe row).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np

from .. import col, knobs
from ..device import costmodel, mfu, runtime
from . import op_floor

#: per operator: the columns a host pass touches, output bytes per row
_OP_COLS = {"argsort": (("k", "x"), 0), "agg_grouped": (("k", "x"), 0),
            "agg_global": (("x",), 0)}

#: the host vector passes: (name, expression, columns read, output bytes
#: per row). ``k % 7`` (op_floor's second projection) is left out: the
#: host has no native modulo and would time a Python fallback.
_VECTOR = (
    ("x * 2 + y", lambda: (col("x") * 2 + col("y")), ("x", "y"), 8),
    ("x * (1 - x)", lambda: (col("x") * (1 - col("x"))), ("x",), 8),
    ("x > 0.5", lambda: col("x") > 0.5, ("x",), 1),
    ("x > 0.5 & y < 100 & k > 3",
     lambda: (col("x") > 0.5) & (col("y") < 100) & (col("k") > 3),
     ("x", "y", "k"), 1))


def card_line(device) -> dict:
    import torch
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": mfu.device_name(device)}
    if device.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return out


def host_vector(n: int, reps: int) -> list:
    """The host tier's evaluation of each ``_VECTOR`` expression."""
    import daft_tpu_torch as dtt
    batch = op_floor.make_batch(n, 0)
    out = []
    with dtt.execution_config_ctx(device="0"):
        for name, expr, cols, out_per_row in _VECTOR:
            e = expr().alias("out")
            batch.eval_expression_list([e])
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                batch.eval_expression_list([e])
                walls.append(time.perf_counter() - t0)
            nbytes = sum(int(batch.get_column(c).to_arrow().nbytes)
                         for c in cols) + n * out_per_row
            out.append({"expr": name, "rows": n, "bytes": nbytes,
                        "host_s": statistics.median(walls)})
    return out


def host_join(n: int, reps: int = 5) -> dict:
    """The host tier's index generation over two n-row sides."""
    import os

    from .. import joins
    rng = np.random.default_rng(4)
    lg = rng.integers(0, max(n // 2, 1), n)
    rg = rng.integers(0, max(n // 2, 1), n)
    ones = np.ones(n, dtype=bool)
    saved = knobs.env_raw("DAFT_TORCH_DEVICE_JOIN")
    os.environ["DAFT_TORCH_DEVICE_JOIN"] = "0"
    try:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            joins.match_indices(lg, rg, ones, ones)
            walls.append(time.perf_counter() - t0)
    finally:
        if saved is None:
            del os.environ["DAFT_TORCH_DEVICE_JOIN"]
        else:
            os.environ["DAFT_TORCH_DEVICE_JOIN"] = saved
    return {"rows": 2 * n, "host_s": statistics.median(walls)}


#: the probe sizes of ``region_join_agg``: a small morsel, and the 128Ki
#: rows of a TPC-DS scan morsel
REGION_ROWS = (1 << 12, 1 << 17)


def region_join_agg(n: int, reps: int) -> dict:
    """Device seconds per dispatch of the join_agg region program over an
    n-row probe (the ledger's ``region`` family, CUDA events around the
    dispatch)."""
    import os

    import daft_tpu_torch as dtt
    rng = np.random.default_rng(5)
    probe = dtt.from_pydict({"k": rng.integers(0, 1024, n),
                             "x": rng.random(n)})
    build = dtt.from_pydict({"k2": np.arange(1024, dtype=np.int64),
                             "g": np.arange(1024, dtype=np.int64) % 64,
                             "w": rng.random(1024)})

    def run():
        j = probe.join(build, left_on=col("k"), right_on=col("k2"),
                       how="inner")
        j.groupby(col("g")).agg(
            (col("x") * col("w")).sum().alias("s")).to_pydict()
    saved = knobs.env_raw("DAFT_TORCH_FUSION")
    os.environ["DAFT_TORCH_FUSION"] = "1"
    try:
        runtime.reset_counters()
        run()
        if not runtime.counters().get("region_join_agg"):
            raise RuntimeError("calibrate: the join_agg region did not "
                               "dispatch")
        per = []
        for _ in range(reps):
            costmodel.ledger_reset()
            run()
            fam = costmodel.ledger_snapshot()["region"]
            per.append(fam["seconds"] / fam["dispatches"])
    finally:
        if saved is None:
            del os.environ["DAFT_TORCH_FUSION"]
        else:
            os.environ["DAFT_TORCH_FUSION"] = saved
    return {"rows": n, "dispatch_s": statistics.median(per)}


def spill_disk(n: int, reps: int) -> dict:
    """Write and read walls of one n-row batch through a spilling
    ``SpillBuffer`` (see the module docstring)."""
    import pyarrow as pa

    from ..execution import memory
    from ..micropartition import MicroPartition
    from ..recordbatch import RecordBatch
    t = op_floor.make_batch(n, 0).to_arrow_table()
    words = pa.array([f"w{i % 4096}" for i in range(n)]).dictionary_encode()
    mp = MicroPartition.from_recordbatch(
        RecordBatch.from_arrow_table(t.append_column("s", words)))
    nbytes = mp.size_bytes()
    writes, reads = [], []
    for _ in range(reps):
        with memory.SpillBuffer(budget=1) as buf:
            t0 = time.perf_counter()
            buf.append(mp)
            writes.append(time.perf_counter() - t0)
            if not buf.bytes_spilled:
                raise RuntimeError("calibrate: the batch did not spill")
            t0 = time.perf_counter()
            back = buf[0]
            reads.append(time.perf_counter() - t0)
            if len(back) != n:
                raise RuntimeError("calibrate: the spilled batch came back "
                                   f"with {len(back)} rows, not {n}")
    w, r = statistics.median(writes), statistics.median(reads)
    return {"rows": n, "bytes": nbytes, "codec": memory.spill_compression(),
            "write_s": w, "read_s": r,
            "SPILL_DISK_BPS": nbytes / ((w + r) / 2)}


#: images of ``pil_resize``
PIL_IMAGES = 2048


def pil_resize(reps: int) -> dict:
    """Input bytes per second of per-image PIL resizes (see the module
    docstring)."""
    try:
        from PIL import Image
    except ImportError:
        return {"pillow": False}
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(PIL_IMAGES)]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for a in imgs:
            np.asarray(Image.fromarray(a).resize((32, 32)))
        walls.append(time.perf_counter() - t0)
    w = statistics.median(walls)
    nbytes = sum(a.nbytes for a in imgs)
    return {"pillow": True, "images": PIL_IMAGES, "src": [64, 64, 3],
            "dst": [32, 32, 3], "wall_s": w, "HOST_PIL_BPS": nbytes / w}


def derive(link, rep, small, big, hv, hj, n: int, reg, sd) -> dict:
    """The constants, from the measurements (see the module docstring)."""
    batch = op_floor.make_batch(n, 0)

    def host_rate(op):
        cols, out_per_row = _OP_COLS[op]
        nbytes = sum(int(batch.get_column(c).to_arrow().nbytes)
                     for c in cols) + n * out_per_row
        return nbytes / (big[op]["host_ms"] / 1e3)

    disp = [max(small[op]["device_ms"] / 1e3 - 2 * link.rtt_s, 1e-6)
            for op in op_floor.OPS]
    region_s_per_row = max(
        (reg[1]["dispatch_s"] - reg[0]["dispatch_s"])
        / (reg[1]["rows"] - reg[0]["rows"]), 1e-12)
    return {
        "HOST_VECTOR_BPS": statistics.median(
            [r["bytes"] / r["host_s"] for r in hv]),
        "HOST_AGG_BPS": statistics.geometric_mean(
            [host_rate("agg_grouped"), host_rate("agg_global")]),
        "HOST_SORT_ROWS_PER_S": 2 * n / (big["argsort"]["host_ms"] / 1e3),
        "HOST_JOIN_ROWS_PER_S": hj["rows"] / hj["host_s"],
        "DEV_VECTOR_BPS": rep["vector"]["input_bps"],
        "DEV_AGG_BPS": rep["grouped_agg"]["input_bps"],
        "DEV_AGG_HASH_BPS": rep["grouped_agg_hash"]["input_bps"],
        "DEV_AGG_DENSE_BPS": rep["grouped_agg_dense"]["input_bps"],
        "DEV_SORT_ROWS_PER_S": rep["argsort"]["key_rows_per_s"],
        "DEV_JOIN_ROWS_PER_S": rep["join"]["rows_per_s"],
        "DEV_JOIN_HASH_ROWS_PER_S": rep["join_hash"]["rows_per_s"],
        "DEV_DISPATCH_S": statistics.median(disp),
        "DEV_REGION_DISPATCH_S": max(
            reg[0]["dispatch_s"] - reg[0]["rows"] * region_s_per_row, 0.0),
        "DEV_REGION_JOIN_AGG_ROWS_PER_S": 1.0 / region_s_per_row,
        "SPILL_DISK_BPS": sd["SPILL_DISK_BPS"],
    }


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("spill_disk", "pil_resize"),
                    default=None,
                    help="run the card line and this line alone")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    import os
    os.environ["DAFT_TORCH_DEVICE"] = args.device
    lines = []

    def emit(kind, rec):
        line = json.dumps({kind: rec}, default=float)
        print(line, flush=True)
        lines.append(line)

    emit("card", card_line(device))
    if args.only == "pil_resize":
        emit("pil_resize", pil_resize(args.reps))
        return _write(args.out, lines)
    sd = spill_disk(args.rows, args.reps)
    emit("spill_disk", sd)
    if args.only == "spill_disk":
        return _write(args.out, lines)
    if device.type == "cuda":
        link = costmodel._measure(device)
    else:
        link = costmodel._SHARED_MEMORY
    emit("link", {"rtt_s": link.rtt_s, "up_bps": link.up_bps,
                  "down_bps": link.down_bps})
    rep = mfu.report(args.rows, device)
    emit("mfu", rep)
    small, big = {}, {}
    for op in op_floor.OPS:
        small[op] = op_floor.measure(op, 256, args.reps, 0)
        big[op] = op_floor.measure(op, args.rows, args.reps, 0)
        emit("op_floor", [small[op], big[op]])
    hv = host_vector(args.rows, args.reps)
    emit("host_vector", hv)
    hj = host_join(args.rows)
    emit("host_join", hj)
    reg = [region_join_agg(n, args.reps) for n in REGION_ROWS]
    emit("region_join_agg", reg)
    emit("pil_resize", pil_resize(args.reps))
    emit("constants", derive(link, rep, small, big, hv, hj, args.rows, reg,
                             sd))
    runtime.reset_counters()
    return _write(args.out, lines)


def _write(out, lines) -> int:
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
