"""TPC-H warm walls of one checkout of this repo, for an A/B of two
commits, or of two local engines, on one card.

    python3 daft_tpu_torch/benchmarking/tpch22_ab.py [--tree DIR]
        [--engine push|interp] [--queries 1,3,...] [--reps N] [--host]
        [--label NAME] [--out FILE]

Imports ``daft_tpu_torch`` and ``chip_smoke.py`` from ``DIR`` (default:
the checkout this file is in), so an older commit unpacked with ``git
archive`` runs its own code; the SF1 data comes from ``DIR/.cache``
(``chip_smoke.tpch_root``; link both trees' ``.cache`` to one directory
to generate it once). ``--engine`` sets ``DAFT_TORCH_LOCAL_EXECUTOR``
(a commit older than the push engine ignores it). Runs each query of
``benchmarking/tpch_queries.py`` (default: all 22) once untimed, then
``N`` times at the default knobs with the device column cache cleared
before each run (chip_smoke's phase 7 warm runs), and with ``--host``
``N`` times on the host tier (``device="0"``). Prints one JSON line per
query (the walls and their medians) and a last ``totals`` line (the sums
of the medians). Run the trees and engines in separate processes, in
turns: parent, change, change, parent, ...
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--engine", default=None, choices=("push", "interp"))
    ap.add_argument("--queries", default=",".join(map(str, range(1, 23))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if args.engine is not None:
        os.environ["DAFT_TORCH_LOCAL_EXECUTOR"] = args.engine
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tpch22_ab: no CUDA device")
    import chip_smoke
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cache
    if os.path.dirname(os.path.abspath(dtt.__file__)) \
            != os.path.join(tree, "daft_tpu_torch"):
        raise SystemExit(f"tpch22_ab: imported {dtt.__file__}, not {tree}")
    root = chip_smoke.tpch_root(1.0)
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    label = args.label or " ".join(filter(None, (tree, args.engine)))

    def wall(q: int) -> float:
        cache.get_cache().clear()
        t0 = time.perf_counter()
        Q.ALL[q](get).to_pydict()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    lines, sums = [], {"warm_s": 0.0, "host_s": 0.0}
    for q in [int(x) for x in args.queries.split(",")]:
        wall(q)
        rec = {"label": label, "query": f"q{q}",
               "warm_walls": [wall(q) for _ in range(args.reps)]}
        rec["warm_s"] = statistics.median(rec["warm_walls"])
        sums["warm_s"] += rec["warm_s"]
        if args.host:
            with dtt.execution_config_ctx(device="0"):
                rec["host_walls"] = [wall(q) for _ in range(args.reps)]
            rec["host_s"] = statistics.median(rec["host_walls"])
            sums["host_s"] += rec["host_s"]
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines.append(json.dumps({"totals": dict(label=label, card=card,
                                            reps=args.reps, **sums)}))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
