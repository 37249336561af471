"""Phase 7k of ``chip_smoke.py`` alone: the sanitizers armed over TPC-H.

    python3 daft_tpu_torch/benchmarking/sanitize_phase.py

From the repository root on a machine with a CUDA card. Builds the
kernels, generates the SF1 files into ``.cache/`` (``chip_smoke.tpch_root``),
runs Q1, the ``l_suppkey`` group-by, Q3 and Q9 once unarmed (their cold
walls and the answers the armed runs are held to; Q1 and the group-by also
to pyarrow), then ``chip_smoke.sanitize_phase`` (the armed child process and
its ``sanitize`` lines), then holds the armed runs' hash and join rungs
against the plain versions as phase 8 does. Exits non-zero when a check
fails.
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
    import daft_tpu_torch as dtt
    from daft_tpu_torch.device import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    root = cs.tpch_root(1.0)
    ref = cs.pyarrow_answers(root)
    get = lambda t: dtt.read_parquet(os.path.join(root, t))  # noqa: E731
    mp = {"per_query": {}}
    t22 = {"per_query": {}, "answers": {}}
    for name in ("q1", "suppkey_agg", "q3", "q9"):
        cs._clear_device_cache()
        t0 = time.perf_counter()
        ans = cs._sanitize_query(name)(get).to_pydict()
        wall = time.perf_counter() - t0
        if name in ("q1", "suppkey_agg"):
            cs.check_answer(name, ans, ref)
            mp["per_query"][name] = {"cold_s": wall}
        else:
            t22["answers"][int(name[1:])] = ans
            t22["per_query"][name] = {"cold_s": wall}
    cs.log("unarmed cold " + json.dumps(
        {**{k: v["cold_s"] for k, v in mp["per_query"].items()},
         **{k: v["cold_s"] for k, v in t22["per_query"].items()}}))
    san = cs.sanitize_phase(root, ref, mp, t22)
    bw = cs.copy_bandwidth()
    hash_recs = cs.main_path_kernel_timing(san["rec"].hash_rungs(), bw)
    join_recs = cs.join_rung_timing(san["rec"].join_rungs, bw)
    cs.log(f"sanitize rungs held: {len(hash_recs)} hash, {len(join_recs)} "
           f"join")
    return 0


if __name__ == "__main__":
    sys.exit(main())
