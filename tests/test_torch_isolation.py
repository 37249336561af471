"""The port stands alone: it imports neither JAX nor the daft_tpu package,
and it never quietly leaves the card for the CPU."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name == "daft_tpu" or name.startswith("daft_tpu.")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dp, dns, fns in os.walk(os.path.join(REPO, "daft_tpu_torch")):
        dns[:] = [d for d in dns if d not in ("__pycache__", "_build")]
        out += [os.path.join(dp, f) for f in fns
                if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_no_jax_or_daft_tpu_import_in_the_port_sources():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        if not path.endswith(".py"):   # kernel sources: their includes
            bad += [f"{path}: {ln}" for ln in src.splitlines()
                    if ln.strip().startswith("#include")
                    and ("jax" in ln or "daft_tpu/" in ln)]
            continue
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                bad += [f"{path}: {a.name}" for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module and _forbidden(node.module):
                bad.append(f"{path}: {node.module}")
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    _forbidden(str(node.args[0].value)):
                bad.append(f"{path}: dynamic {node.args[0].value}")
    assert len(_port_files()) > 10
    assert bad == []


_Q6_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_DEVICE_FORCE"] = "1"
from benchmarking.tpch.datagen import generate_tpch
import daft_tpu_torch
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.device import runtime
root = tempfile.mkdtemp()
generate_tpch(root, scale_factor=0.0005, num_parts=1)
out = Q.q6(lambda t: daft_tpu_torch.read_parquet(os.path.join(root, t)))
rev = out.to_pydict()["revenue"][0]
assert rev is not None and rev > 0, rev
assert runtime.counters().get("global", 0) > 0, runtime.counters()
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_q6_runs_without_jax_or_daft_tpu_in_sys_modules():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _Q6_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_Q3_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_DEVICE_FORCE"] = "1"
os.environ["DAFT_TORCH_KERNEL_JOIN"] = "hash"
from benchmarking.tpch.datagen import generate_tpch
import daft_tpu_torch
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.device import runtime
root = tempfile.mkdtemp()
generate_tpch(root, scale_factor=0.004, num_parts=1)
out = Q.q3(lambda t: daft_tpu_torch.read_parquet(os.path.join(root, t)))
d = out.to_pydict()
assert len(d["o_orderkey"]) == 10 and d["revenue"][0] > 0, d
assert runtime.counters().get("join_hash", 0) > 0, runtime.counters()
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_q3_join_runs_without_jax_or_daft_tpu_in_sys_modules():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _Q3_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_OPS_SCRIPT = r"""
import os, sys
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_DEVICE_MIN_ROWS"] = "0"
os.environ["DAFT_TORCH_KERNEL_GROUPBY"] = "hash"
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.device import runtime
a = daft_tpu_torch.from_pydict({"k": [1, 2, 2, 3, 3, 3], "s": list("abbccc"),
                                "v": [1.0, 2.0, 2.0, 3.0, 4.0, 5.0]})
b = daft_tpu_torch.from_pydict({"w": [10, 20]})
out = (a.distinct("k", "s").join(b, how="cross")
       .with_column("x", col("k") * col("w"))
       .where(col("x") > 15)
       .groupby("s").agg(col("x").sum().alias("sx"))
       .sort("s", desc=True)).to_pydict()
assert out == {"s": ["c", "b", "a"], "sx": [90, 60, 20]}, out
c = runtime.counters()
for k in ("projection", "predicate", "agg_hash", "argsort"):
    assert c.get(k, 0) > 0, (k, c)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_distinct_cross_join_and_operator_paths_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _OPS_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_entry_point_raises_without_cuda_and_without_cpu_request(
        monkeypatch):
    import torch
    import daft_tpu_torch
    from daft_tpu_torch.device import backend
    monkeypatch.delenv("DAFT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    q = df.groupby("k").agg(daft_tpu_torch.col("v").sum())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.to_pydict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device()
    # asking for the CPU runs it there
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    assert sorted(q.to_pydict()["v"]) == [2.0, 4.0]
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        monkeypatch.delenv("DAFT_TORCH_DEVICE")
        assert backend.resolve_device() == torch.device("cpu")


_SQL_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
import pyarrow as pa, pyarrow.parquet as pq
import daft_tpu_torch
cust = daft_tpu_torch.from_pydict({"c_id": [1, 2, 3, 4],
                                   "c_bal": [100.0, 5.0, 60.0, 40.0]})
orders = daft_tpu_torch.from_pydict({"o_cust": [1, 1, 2, 3, 3],
                                     "o_total": [20.0, 30.0, 7.0, 55.0, 5.0]})
out = daft_tpu_torch.sql(
    "SELECT c_id FROM cust WHERE c_bal > "
    "(SELECT 2 * avg(o_total) FROM orders WHERE o_cust = c_id) "
    "AND EXISTS (SELECT 1 FROM orders o2 WHERE o2.o_cust = c_id "
    "AND o2.o_total <> 20.0) ORDER BY c_id").to_pydict()
assert out == {"c_id": [1]}, out
d = tempfile.mkdtemp()
pq.write_table(pa.table({"x": [3, 1, 2]}), os.path.join(d, "t.parquet"))
out = daft_tpu_torch.sql(
    f"SELECT sum(x) AS s FROM read_parquet('{d}/*.parquet')").to_pydict()
assert out == {"s": [6]}, out
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_sql_subquery_and_table_function_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _SQL_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_PIPE_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_DEVICE_INFLIGHT"] = "2"
os.environ["DAFT_TORCH_DEVICE_FORCE"] = "1"
from benchmarking.tpch.datagen import generate_tpch
import daft_tpu_torch
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.device import runtime
root = tempfile.mkdtemp()
generate_tpch(root, scale_factor=0.001, num_parts=4)
get = lambda t: daft_tpu_torch.read_parquet(os.path.join(root, t))
cold = Q.q1(get).to_pydict()
c = runtime.counters()
assert c["pipeline_slots"] >= 2 and c["cache_puts"] == 4, c
runtime.reset_counters()
warm = Q.q1(get).to_pydict()
c = runtime.counters()
assert c["cache_hits"] == 4 and c.get("scan_bytes_up", 0) == 0, c
assert c["pipeline_slots_acquired"] == c["pipeline_slots_released"], c
assert cold == warm and len(cold["l_returnflag"]) == 4, cold
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_pipelined_cached_query_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PIPE_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_COSTMODEL_SCRIPT = r"""
import json, os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
for k in ("DAFT_TORCH_DEVICE_MIN_ROWS", "DAFT_TORCH_DEVICE_FORCE",
          "DAFT_TORCH_DEVICE_JOIN", "DAFT_TORCH_KERNEL_JOIN",
          "DAFT_TORCH_KERNEL_GROUPBY"):
    os.environ.pop(k, None)
log = os.path.join(tempfile.mkdtemp(), "dispatch.jsonl")
os.environ["DAFT_TORCH_DISPATCH_LOG"] = log
from benchmarking.tpch.datagen import generate_tpch
import daft_tpu_torch
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.device import costmodel
root = tempfile.mkdtemp()
generate_tpch(root, scale_factor=0.004, num_parts=1)
get = lambda t: daft_tpu_torch.read_parquet(os.path.join(root, t))
got = Q.q3(get).to_pydict()
counts = costmodel.decision_counts_snapshot()
with daft_tpu_torch.execution_config_ctx(device="0"):
    host = Q.q3(get).to_pydict()
assert got == host and len(got["o_orderkey"]) == 10, (got, host)
for kind in ("row_output", "join", "agg_upload", "argsort"):
    assert sum(counts.get(kind, {}).values()) > 0, (kind, counts)
recs = [json.loads(x) for x in open(log)]
assert len(recs) == sum(sum(v.values()) for v in counts.values())
assert all({"kind", "device", "host_s", "dev_s"} <= set(r) for r in recs)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_cost_model_decides_without_jax():
    """Q3 at the default knobs on CPU tensors: the per-operator paths
    (projections, predicates, the aggregations' uploads, the argsorts) and
    the lineitem join are priced by the port's cost model (``decision_counts`` and the JSONL log hold
    every decision), the answer is the host tier's, and neither JAX nor
    the daft_tpu package is imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _COSTMODEL_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_WINDOW_REGION_SCRIPT = r"""
import os, sys
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_DEVICE_FORCE"] = "1"
os.environ["DAFT_TORCH_FUSION"] = "1"
import numpy as np
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.device import runtime
t = daft_tpu_torch.from_pydict({"g": ["a", "a", "b", "b", "b"],
                                "v": [3.0, 1.0, 5.0, 4.0, 6.0]})
out = daft_tpu_torch.sql(
    "SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v DESC) AS r, "
    "sum(v) OVER (PARTITION BY g) AS s FROM t ORDER BY g, v",
    t=t).to_pydict()
assert out["r"] == [2, 1, 3, 2, 1] and out["s"] == [4.0, 4.0, 15.0,
                                                    15.0, 15.0], out
rng = np.random.default_rng(0)
probe = daft_tpu_torch.from_pydict({
    "k": rng.integers(0, 20, 5000).astype(np.int64),
    "x": rng.normal(size=5000)})
build = daft_tpu_torch.from_pydict({
    "k2": np.arange(20, dtype=np.int64),
    "g": np.arange(20, dtype=np.int64) % 3})
q = probe.join(build, left_on=col("k"), right_on=col("k2")).groupby(
    "g").agg(col("x").count().alias("n")).sort("g")
assert sum(q.to_pydict()["n"]) == 5000
assert runtime.counters().get("region_join_agg", 0) >= 1, runtime.counters()
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_window_and_fused_region_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _WINDOW_REGION_SCRIPT],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_OUT_OF_CORE_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
os.environ["DAFT_TORCH_MEMORY_LIMIT"] = "400KB"
os.environ["DAFT_TORCH_SPILL_DIR"] = tempfile.mkdtemp()
os.environ["DAFT_TORCH_LOCAL_EXECUTOR"] = "push"
import numpy as np
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.execution import memory
from daft_tpu_torch.physical import adaptive
rng = np.random.default_rng(0)
n = 40_000
left = daft_tpu_torch.from_pydict({"k": rng.integers(0, 5_000, n),
                                   "v": np.arange(n)})
right = daft_tpu_torch.from_pydict({"k": np.arange(5_000),
                                    "w": np.arange(5_000) * 2})
b0 = memory.spill_counters_snapshot()
j = left.join(right, on="k", strategy="hash").to_pydict()
assert len(j["k"]) == n, len(j["k"])
s = left.sort(["k", "v"]).to_pydict()
assert s["k"] == sorted(s["k"])
d = memory.spill_counters_delta(b0)
assert d.get("joins_partitioned", 0) >= 1 and d.get("bytes_written", 0) > 0, d
daft_tpu_torch.set_execution_config(enable_aqe=True)
a = left.into_partitions(4).join(right.into_partitions(2), on="k",
                                 strategy="hash").groupby("w") \
    .agg(col("v").count()).to_pydict()
assert sum(a["v"]) == n, a
assert adaptive.counters_snapshot().get("replans", 0) >= 1
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_spilled_grace_join_sort_and_aqe_run_without_jax():
    """A grace join and an external sort under a 400KB budget and an AQE
    query, all through the push executor, import neither JAX nor
    daft_tpu."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _OUT_OF_CORE_SCRIPT],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_REMOTE_IO_SCRIPT = r"""
import os, sys, tempfile
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
import pyarrow as pa, pyarrow.parquet as pq
import daft_tpu_torch
from daft_tpu_torch.benchmarking.http_store import FileStore
from daft_tpu_torch.io import read_planner as rp
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "pq"))
for i in range(3):
    pq.write_table(pa.table({"g": ["a", "b", "a", "c"][i:] + ["a"] * i,
                             "v": [float(i * 10 + j) for j in range(4)]}),
                   os.path.join(root, "pq", f"p{i}.parquet"),
                   row_group_size=2)
with open(os.path.join(root, "t.csv"), "w") as f:
    f.write("k,s\n1,x\n2,y\n")
with FileStore(root) as store:
    before = rp.scan_counters_snapshot()
    df = daft_tpu_torch.read_parquet(store.urls("pq"))
    out = df.where(daft_tpu_torch.col("v") > 5.0).groupby("g") \
        .agg(daft_tpu_torch.col("v").sum()).sort("g").to_pydict()
    assert out["g"] == ["a", "b", "c"], out
    assert rp.scan_counters_delta(before).get("range_requests", 0) > 0
    assert daft_tpu_torch.read_csv(f"{store.url}/t.csv").to_pydict() \
        == {"k": [1, 2], "s": ["x", "y"]}
    res = df.write_parquet(os.path.join(root, "out"),
                           partition_cols=["g"]).to_pydict()
assert sorted(set(res["g"])) == ["a", "b", "c"], res
back = daft_tpu_torch.read_parquet(os.path.join(root, "out", "**",
                                                "*.parquet"),
                                   hive_partitioning=True)
assert len(back.to_pydict()["v"]) == 12
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_remote_read_and_partitioned_write_run_without_jax():
    """Parquet and CSV read from a local HTTP store through the port's
    planned reads and prefetch-pipelined scan, and a hive-partitioned
    parquet write, import neither JAX nor daft_tpu."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _REMOTE_IO_SCRIPT],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout
