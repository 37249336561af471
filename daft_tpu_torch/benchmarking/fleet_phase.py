"""Phase 7n of ``chip_smoke.py`` alone: Spark Connect, the serving fleet
and the PySpark shim on the card.

    python3 daft_tpu_torch/benchmarking/fleet_phase.py [--runs N]

From the repository root on a machine with a CUDA card. Prints the
``env`` line, builds the kernels, generates the SF1 files into ``.cache/``
(``chip_smoke.tpch_root``), runs Q1, the ``l_suppkey`` group-by, Q6 and Q3
once cold on the native runner (the slowest of them stands in for 7m's
slowest cold query in the fleet's deadlines), then
``chip_smoke.connect_fleet_phase`` ``--runs`` times (its ``connect`` and
``fleet`` lines), then holds the Connect runs' hash and join rungs
against the plain versions as phase 8 does. Every step runs through
``chip_smoke.run_phase``: a failing one prints ``phase <name> FAILED``.
Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    env = cs.env_probe()
    cs.log("env " + json.dumps(env))
    os.environ["DAFT_TORCH_LINK_CACHE"] = "0"
    import subprocess

    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cuda_build
    t_start = time.perf_counter()

    def phase(name, fn):
        return cs.run_phase(name, fn, t_start)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(f"card: {card}")
    phase("build", cuda_build.library)
    root = phase("data", lambda: cs.tpch_root(1.0))
    ref = phase("pyarrow", lambda: cs.pyarrow_answers(root))
    q3_ref = phase("q3 pyarrow", lambda: cs.q3_reference(root))
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731

    def native():
        rec = cs.KernelRecorder("native")
        cold = {}
        for name in ("q1", "suppkey_agg", "q6", "q3"):
            _, wall, _, _ = rec.counted(
                f"native {name}", lambda: Q.QUERIES[name](get).to_pydict())
            cold[name] = wall
        cs.log("native cold " + json.dumps(cold))
        return cold
    cold = phase("native", native)
    walls = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = phase(f"7n run {i + 1}", lambda: cs.connect_fleet_phase(
            root, ref, q3_ref, env, max(cold.values()), card))
        walls.append(time.perf_counter() - t0)
    cs.log("7n walls " + json.dumps(dict(card=card, walls_s=walls)))

    def held():
        bw = cs.copy_bandwidth()
        hash_recs = cs.main_path_kernel_timing(out["rec"].hash_rungs(), bw)
        join_recs = cs.join_rung_timing(
            {k: dict(v, pass_="connect")
             for k, v in out["rec"].join_rungs.items()}, bw)
        cs.log(f"connect rungs held: {len(hash_recs)} hash, "
               f"{len(join_recs)} join")
    phase("8", held)
    return 0


if __name__ == "__main__":
    sys.exit(main())
