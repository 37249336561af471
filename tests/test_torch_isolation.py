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
