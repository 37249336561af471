"""Phase 7m of ``chip_smoke.py`` alone: the serving plane on the card.

    python3 daft_tpu_torch/benchmarking/serve_phase.py

From the repository root on a machine with a CUDA card. Builds the
kernels, generates the SF1 files into ``.cache/`` (``chip_smoke.tpch_root``),
runs Q1, the ``l_suppkey`` group-by, Q6 and Q3 once cold on the native
runner (which host fallbacks they had none of is what the served runs
are held to), then ``chip_smoke.serve_phase`` (its ``serve`` lines), then
holds the phase's hash and join rungs against the plain versions as
phase 8 does. Exits non-zero when a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    os.environ["DAFT_TORCH_LINK_CACHE"] = "0"
    import subprocess

    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import cuda_build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(f"card: {card}")
    t0 = time.perf_counter()
    cuda_build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    root = cs.tpch_root(1.0)
    ref = cs.pyarrow_answers(root)
    q3_ref = cs.q3_reference(root)
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    rec = cs.KernelRecorder("native")
    per = {}
    for name in ("q1", "suppkey_agg", "q6", "q3"):
        _, wall, counts, _ = rec.counted(
            f"native {name}", lambda: Q.QUERIES[name](get).to_pydict())
        per[name] = {"counters": counts, "cold_s": wall}
    cs.log("native cold " + json.dumps(
        {k: dict(cold_s=v["cold_s"],
                 host_joins=v["counters"].get("host_joins", 0),
                 host_morsels=v["counters"].get("host_morsels", 0))
         for k, v in per.items()}))
    t0 = time.perf_counter()
    srv = cs.serve_phase(root, ref, q3_ref, cs.serve_host_free(
        {k: v["counters"] for k, v in per.items()}), card)
    cs.log(f"phase 7m: {time.perf_counter() - t0:.3f} s")
    bw = cs.copy_bandwidth()
    hash_recs = cs.main_path_kernel_timing(srv["rec"].hash_rungs(), bw)
    join_recs = cs.join_rung_timing(
        {k: dict(v, pass_="serve") for k, v in srv["rec"].join_rungs.items()},
        bw)
    cs.log(f"serve rungs held: {len(hash_recs)} hash, {len(join_recs)} join")
    return 0


if __name__ == "__main__":
    sys.exit(main())
