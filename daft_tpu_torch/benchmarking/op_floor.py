"""The per-operator device paths against the host tier by batch size: where
the row floor ``DAFT_TORCH_DEVICE_MIN_ROWS`` would sit for each operator,
and what the cost model (``device/costmodel.py``) decides there.

    python3 -m daft_tpu_torch.benchmarking.op_floor [--out FILE]

For each row count (2^8 to 2^22, by 4) it makes one seeded batch (an
int64 key with rows/16 distinct values, a float64 and an int32 column,
no nulls) and runs each per-operator path of ``device/runtime.py`` through
the ``RecordBatch`` methods a query calls:

- ``projection``: ``x * 2 + y`` and ``k % 7``;
- ``predicate``: ``x > 0.5``;
- ``argsort``: by ``(k, x)``;
- ``agg_grouped``: sum, mean and count of ``x`` grouped by ``k``
  (``agg_hash`` while the table for the batch's capacity fits
  ``DAFT_TORCH_KERNEL_MAX_TABLE``, else ``agg_sort``: each line names the
  strategy that ran);
- ``agg_global``: sum, mean and max of ``x``.

Each runs on the host tier (the floor above the batch), on the device
tier (the floor at 0) and at the default knobs (the floor unset: the cost
model decides), in turns host, device, model, model, device, host, for
``--reps`` rounds; the wall of one call is the median of its tier's
calls (host clock: the device tier's call ends with its result on the
host). The device tier includes the upload of the batch's planes and the
fetch of the result, as on the main path. Each device call must count its
dispatch, and its answer must equal the host tier's (permutations and
masks exactly, groups as sets, floats at relative 1e-9). Beside the
walls, the cost model's decision for the batch (``model_device``) and the
host and device seconds it predicted (``model_host_ms``,
``model_dev_ms``, from its decision log), and whether it picked the tier
whose measured wall was the smaller (``model_right``).

Prints one JSON line per (operator, rows) and a last ``crossover`` line:
per operator, the least row count measured from which the device tier's
wall is below the host tier's at that count and every larger one (null
if none), and the sizes at which the cost model picked the slower tier.
Runs on ``cuda`` unless ``DAFT_TORCH_DEVICE`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import tempfile
import time

import numpy as np
import pyarrow as pa

from .. import col
from ..device import runtime
from ..recordbatch import RecordBatch

ROWS = [1 << s for s in range(8, 23, 2)]
REL = 1e-9


def make_batch(n: int, seed: int) -> RecordBatch:
    rng = np.random.default_rng(seed)
    return RecordBatch.from_arrow_table(pa.table({
        "k": rng.integers(0, max(n // 16, 1), n),
        "x": rng.random(n),
        "y": rng.integers(-1000, 1000, n).astype(np.int32)}))


OPS = {
    "projection": lambda b: b.eval_expression_list(
        [(col("x") * 2 + col("y")).alias("z"), (col("k") % 7).alias("m")]),
    "predicate": lambda b: b.filter(col("x") > 0.5),
    "argsort": lambda b: b.argsort([col("k"), col("x")]),
    "agg_grouped": lambda b: b.agg(
        [col("x").sum().alias("s"), col("x").mean().alias("m"),
         col("x").count().alias("c")], [col("k")]),
    "agg_global": lambda b: b.agg(
        [col("x").sum().alias("s"), col("x").mean().alias("m"),
         col("x").max().alias("mx")]),
}

#: the cost model's decision kind each operator's gate logs
DECISIONS = {"projection": "row_output", "predicate": "row_output",
             "argsort": "argsort", "agg_grouped": "agg_upload",
             "agg_global": "agg_upload"}

#: the dispatch counter(s) each operator's device path bumps
COUNTERS = {"projection": ("projection",), "predicate": ("predicate",),
            "argsort": ("argsort",), "agg_grouped": ("agg_hash", "agg_sort"),
            "agg_global": ("agg_global",)}


def _rows(out) -> list:
    """An answer as a sorted list of rows (a permutation as itself)."""
    if not isinstance(out, RecordBatch):
        return np.asarray(out).tolist()
    d = out.to_pydict()
    return sorted(zip(*d.values()))


def _same(a: list, b: list) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra if isinstance(ra, tuple) else (ra,),
                        rb if isinstance(rb, tuple) else (rb,)):
            if isinstance(x, float) and isinstance(y, float):
                if not math.isclose(x, y, rel_tol=REL, abs_tol=0.0):
                    return False
            elif x != y:
                return False
    return True


def _call(op: str, batch: RecordBatch, floor, log=None):
    """One call of ``op`` with the row floor at ``floor`` (None: unset,
    the cost model decides; its decisions go to ``log`` when given); the
    knobs are put back after: (answer, wall seconds)."""
    saved = {k: os.environ.get(k) for k in ("DAFT_TORCH_DEVICE_MIN_ROWS",
                                            "DAFT_TORCH_DISPATCH_LOG")}
    if floor is None:
        os.environ.pop("DAFT_TORCH_DEVICE_MIN_ROWS", None)
    else:
        os.environ["DAFT_TORCH_DEVICE_MIN_ROWS"] = str(floor)
    if log is not None:
        os.environ["DAFT_TORCH_DISPATCH_LOG"] = log
    try:
        t0 = time.perf_counter()
        out = OPS[op](batch)
        return out, time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _model_decision(op: str, batch: RecordBatch) -> dict:
    """The cost model's decision for one call of ``op`` at the default
    knobs, read back from its decision log."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "decisions.jsonl")
        _call(op, batch, None, log=path)
        recs = [json.loads(x) for x in open(path)] \
            if os.path.exists(path) else []
    mine = [r for r in recs if r["kind"] == DECISIONS[op]]
    if len(mine) != 1:
        raise AssertionError(f"{op} at {len(batch)} rows: {len(mine)} "
                             f"{DECISIONS[op]} decisions ({recs})")
    r = mine[0]
    return dict(model_device=r["device"], model_host_ms=r["host_s"] * 1e3,
                model_dev_ms=r["dev_s"] * 1e3)


def measure(op: str, n: int, reps: int, seed: int) -> dict:
    batch = make_batch(n, seed)
    host_floor = n + 1
    host_out, _ = _call(op, batch, host_floor)
    runtime.reset_counters()
    dev_out, _ = _call(op, batch, 0)   # warm: compiles, builds the kernels
    ran = [k for k in COUNTERS[op] if runtime.counters().get(k, 0) == 1]
    if len(ran) != 1:
        raise AssertionError(f"{op} at {n} rows: the device path did not "
                             f"run ({runtime.counters()})")
    if not _same(_rows(dev_out), _rows(host_out)):
        raise AssertionError(f"{op} at {n} rows: device answer differs")
    model = _model_decision(op, batch)
    walls = {"host": [], "device": [], "model": []}
    floors = {"host": host_floor, "device": 0, "model": None}
    for _ in range(reps):
        for tier in ("host", "device", "model", "model", "device", "host"):
            _, t = _call(op, batch, floors[tier])
            walls[tier].append(t)
    h, d = statistics.median(walls["host"]), statistics.median(walls["device"])
    return dict(op=op, rows=n, dispatch=ran[0], host_ms=h * 1e3,
                device_ms=d * 1e3, device_over_host=d / h,
                model_ms=statistics.median(walls["model"]) * 1e3,
                model_right=model["model_device"] == (d < h),
                calls_per_tier=2 * reps, **model)


def mispredicts(recs: list) -> dict:
    """Per operator, the row counts at which the cost model picked the
    tier whose measured wall was the larger."""
    return {op: [r["rows"] for r in recs
                 if r["op"] == op and not r.get("model_right", True)]
            for op in OPS}


def crossover(recs: list) -> dict:
    out = {}
    for op in OPS:
        mine = sorted((r for r in recs if r["op"] == op),
                      key=lambda r: r["rows"])
        at = None
        for r in reversed(mine):
            if r["device_ms"] >= r["host_ms"]:
                break
            at = r["rows"]
        out[op] = at
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rows", type=int, default=ROWS[-1])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    recs = []
    for n in (r for r in ROWS if r <= args.max_rows):
        for op in OPS:
            rec = measure(op, n, args.reps, args.seed)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    line = json.dumps({"crossover": crossover(recs),
                       "model_picked_slower": mispredicts(recs)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n" + line
                    + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
