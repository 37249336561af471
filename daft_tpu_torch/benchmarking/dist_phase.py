"""Phase 7l of ``chip_smoke.py`` alone: the mesh and the distributed tier.

    python3 daft_tpu_torch/benchmarking/dist_phase.py

From the repository root on a machine with a CUDA card. Builds the
kernels, generates the SF1 files into ``.cache/`` (``chip_smoke.tpch_root``),
runs Q1, the ``l_suppkey`` group-by, Q3 and Q9 once cold on the native
runner (the walls the distributed runs are printed beside; Q9's answer is
what they are held to), then ``chip_smoke.dist_phase`` (its ``dist`` lines), then holds the
phase's hash and join rungs against the plain versions as phase 8 does.
Exits non-zero when a check fails.
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
    get = lambda t: dtt.read_parquet(f"{root}/{t}/*.parquet")  # noqa: E731
    t22 = {"per_query": {}, "answers": {}}
    mp = {"per_query": {}, "ref": ref}
    for name, q in (("q1", Q.ALL[1]), ("suppkey_agg", Q.suppkey_agg),
                    ("q3", Q.ALL[3]), ("q9", Q.ALL[9])):
        cs._clear_device_cache()
        t0 = time.perf_counter()
        ans = q(get).to_pydict()
        t22["per_query"][name] = {"cold_s": time.perf_counter() - t0}
        if name != "suppkey_agg":
            t22["answers"][int(name[1:])] = ans
    cs.log("native cold " + json.dumps(
        {k: v["cold_s"] for k, v in t22["per_query"].items()}))
    t0 = time.perf_counter()
    dist = cs.dist_phase(root, mp, q3_ref, t22, card)
    cs.log(f"phase 7l: {time.perf_counter() - t0:.3f} s")
    bw = cs.copy_bandwidth()
    hash_recs = cs.main_path_kernel_timing(dist["rec"].hash_rungs(), bw)
    join_recs = cs.join_rung_timing(
        {k: dict(v, pass_="dist") for k, v in dist["rec"].join_rungs.items()},
        bw)
    cs.log(f"dist rungs held: {len(hash_recs)} hash, {len(join_recs)} join")
    return 0


if __name__ == "__main__":
    sys.exit(main())
