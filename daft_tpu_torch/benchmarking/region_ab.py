"""Walls of the TPC-DS queries whose plans hold ``join_agg`` fusion
regions, at the default knobs, under one or more ``DAFT_TORCH_FUSION``
settings, for an A/B of fusion against the per-operator path and of two
commits on one card.

    python3 daft_tpu_torch/benchmarking/region_ab.py [--tree DIR]
        [--fusion auto,0] [--label NAME] [--out FILE]

Imports ``daft_tpu_torch`` from ``DIR`` (default: the checkout this file
is in), so an older commit unpacked with ``git archive`` runs its own
engine; the query texts are this checkout's ``tpcds_sql.py``, and the
data TPC-DS at scale 1.0 in this checkout's ``.cache/tpcds_s1`` (what
``chip_smoke.py`` generates; made here if missing). Per query: one
untimed run under each setting, then :data:`REPS` rounds that run the
settings in turns (the first of each round alternating), the device
column cache cleared before each run; each answer
held to the first setting's (``chip_smoke._same_rows``). A query the
tree cannot plan (an older commit without windows) is skipped and named.
Prints one JSON line per query (walls, medians, region dispatches and
declines, the cost model's ``fusion`` decisions) and a last ``totals``
line (the sums of the medians over the queries every setting ran). Run
two trees in separate processes, in turns: parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: timed runs per query and setting (the walls' median)
REPS = 3


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def tpcds_root() -> str:
    root = os.path.join(HERE, ".cache", "tpcds_s1")
    ss = os.path.join(root, "store_sales")
    if not (os.path.isdir(ss) and os.listdir(ss)):
        sys.path.insert(0, HERE)
        from benchmarking.tpcds.datagen import generate_tpcds
        generate_tpcds(root, scale=1.0, seed=0)
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--fusion", default="auto,0")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    root = tpcds_root()
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("region_ab: no CUDA device")
    import daft_tpu_torch as dtt
    from daft_tpu_torch.device import cache, costmodel, runtime
    if os.path.dirname(os.path.abspath(dtt.__file__)) \
            != os.path.join(tree, "daft_tpu_torch"):
        raise SystemExit(f"region_ab: imported {dtt.__file__}, not {tree}")
    here_bench = os.path.join(HERE, "daft_tpu_torch", "benchmarking")
    DS = _load("daft_tpu_torch.benchmarking.tpcds_sql",
               os.path.join(here_bench, "tpcds_sql.py"))
    smoke = _load("_region_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    settings = args.fusion.split(",")
    label = args.label or tree

    def run(q: int, fusion: str):
        os.environ["DAFT_TORCH_FUSION"] = fusion
        cache.get_cache().clear()
        runtime.reset_counters()
        costmodel.reset_decision_counts()
        t0 = time.perf_counter()
        out = DS.run(q, get).to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        regions = {k: v for k, v in runtime.counters().items()
                   if k.startswith("region_")}
        return out, wall, regions, costmodel.decision_counts_snapshot().get(
            "fusion", {})

    lines, sums, skipped = [], {s: 0.0 for s in settings}, []
    for q in DS.REGION_QUERIES:
        try:
            want = run(q, settings[0])[0]
        except NotImplementedError as exc:
            skipped.append(q)
            lines.append(json.dumps({"label": label, "query": q,
                                     "skipped": str(exc)}))
            print(lines[-1], flush=True)
            continue
        for s in settings[1:]:
            run(q, s)
        rec = {"label": label, "query": q}
        walls = {s: [] for s in settings}
        for i in range(REPS):
            for s in settings[::-1] if i % 2 else settings:
                got, wall, regions, fusion = run(q, s)
                smoke._same_rows(f"q{q} fusion={s}", got, want)
                walls[s].append(wall)
                rec[f"regions_{s}"], rec[f"fusion_{s}"] = regions, fusion
        for s in settings:
            rec[f"walls_{s}"] = walls[s]
            rec[f"median_{s}"] = statistics.median(walls[s])
            sums[s] += rec[f"median_{s}"]
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines.append(json.dumps({"totals": dict(
        label=label, card=card, reps=REPS, skipped=skipped,
        **{f"median_{s}": v for s, v in sums.items()})}))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
