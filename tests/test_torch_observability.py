"""The port's runtime stats, ``explain(analyze=True)``, exports and the
per-query profiler capture (``daft_tpu_torch/observability.py``) against
the reference's (``tests/test_observability.py``).

- The reference's fourteen cases, each run through the port (on CPU
  tensors, ``DAFT_TORCH_DEVICE=cpu``; the host tier where the reference
  runs its host exchange path): collected stats, an unfused filter's rows,
  the analyzed render, the Chrome trace file, non-negative exclusive
  times, a collected frame's own stats, the AQE planner's coalesced
  shuffle, fused partitioned agg and broadcast demotion, a user
  repartition left alone, the dashboard's history, the CLI, the per-query
  capture (the reference's XPlane trace is a ``torch.profiler`` capture
  here) and the OTLP counters.
- Parity: the per-operator rows of every physical node equal the
  reference's for the 22 TPC-H queries (SF 0.003), and
  ``explain(analyze=True)`` prints the same block headers and operator
  names. Both packages plan one scan task per file and run two workers
  per stage: the rows of an operator below a partitioned-agg reducer
  depend on how many reducers there are, which the port sets to
  ``min(workers, partitions)`` (so two, as the reference's two).
"""

import json
import os
import re

import pytest

import daft_tpu
import daft_tpu_torch as dt
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch
from daft_tpu import observability as ref_obs
from daft_tpu_torch import col
from daft_tpu_torch import observability as obs
from daft_tpu_torch.physical import adaptive


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    for k in ("CHROME_TRACE", "PROFILE_DIR", "OTLP_ENDPOINT", "TRACE",
              "QUERY_LOG"):
        monkeypatch.delenv("DAFT_TORCH_" + k, raising=False)
        monkeypatch.delenv("DAFT_TPU_" + k, raising=False)


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_obs")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


# ------------------------------------------------ the reference's cases

def test_runtime_stats_collected():
    df = (dt.from_pydict({"x": list(range(1000)),
                          "g": [i % 10 for i in range(1000)]})
          .where(col("x") > 99)
          .groupby("g").agg(col("x").sum().alias("s")))
    df.collect()
    stats = obs.last_query_stats()
    assert stats is not None and stats is df._stats
    d = stats.as_dict()
    assert stats.wall_us is not None and stats.wall_us > 0
    # source emits all 1000 rows; final agg emits 10 groups
    src = [v for k, v in d.items() if "Source" in k]
    assert src and src[0]["rows_out"] == 1000
    root = [v for k, v in d.items() if "Agg" in k]
    assert any(v["rows_out"] == 10 for v in root)


def test_runtime_stats_unfused_filter():
    df = dt.from_pydict({"x": list(range(1000))}).where(col("x") > 99)
    df.collect()
    d = obs.last_query_stats().as_dict()
    filters = [v for k, v in d.items() if k.startswith("Filter")]
    assert filters and filters[0]["rows_out"] == 900


def test_explain_analyze_renders(capsys):
    df = dt.from_pydict({"x": [1, 2, 3]}).where(col("x") > 1)
    df.explain(analyze=True)
    out = capsys.readouterr().out
    assert "== Physical Plan (analyzed) ==" in out
    assert "rows_out=2" in out
    assert "query wall time" in out


def test_chrome_trace_written(tmp_path, monkeypatch):
    path = str(tmp_path / "trace.json")
    monkeypatch.setenv("DAFT_TORCH_CHROME_TRACE", path)
    df = dt.from_pydict({"x": list(range(100))}).where(col("x") % 2 == 0)
    df.collect()
    with open(path) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert "Filter" in names
    for e in trace["traceEvents"]:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)


def test_stats_exclusive_time_nonneg():
    df = dt.from_pydict({"x": list(range(500))}).with_column(
        "y", col("x") * 2).where(col("y") > 10)
    df.collect()
    stats = obs.last_query_stats()
    for v in stats.as_dict().values():
        assert v["exclusive_us"] >= 0
        assert v["inclusive_us"] >= v["exclusive_us"]


def test_explain_analyze_not_stale(capsys):
    df1 = dt.from_pydict({"x": [1, 2, 3]}).where(col("x") > 1)
    df1.collect()
    # another query runs afterwards…
    dt.from_pydict({"y": list(range(50))}).where(col("y") > 10).collect()
    # …but df1's analysis must show df1's stats (2 rows), not the later one
    df1.explain(analyze=True)
    out = capsys.readouterr().out
    assert "rows_out=2" in out and "rows_out=39" not in out


def test_aqe_coalesces_small_shuffles(monkeypatch):
    """With AQE on, an engine-inserted shuffle over tiny data coalesces to
    fewer partitions, sized by the materialized bytes."""
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")  # host exchange path
    df = dt.from_pydict({"k": [i % 5 for i in range(100)],
                         "v": [float(i) for i in range(100)]})
    df = df.into_partitions(8)
    # count_distinct is non-decomposable: a single-stage agg over a real
    # engine-inserted hash exchange
    with dt.execution_config_ctx(enable_aqe=True,
                                 target_partition_size_bytes=1 << 30,
                                 local_executor="interp"):
        out = df.groupby("k").agg(col("v").count_distinct().alias("s")) \
            .sort("k").to_pydict()
    assert out["k"] == [0, 1, 2, 3, 4]
    planner = adaptive.last_planner()
    assert planner is not None and planner.history
    # tiny data against a 1GB target → coalesced to 1 partition
    assert planner.history[-1].partitions == 1
    assert "→1 parts" in planner.history[-1].decision
    assert "Adaptive execution" in planner.explain_analyze()


def test_aqe_records_fused_partitioned_agg(monkeypatch):
    """Mergeable grouped aggs skip the shuffle through the fused
    partitioned-agg stage; with AQE on the elision is in the adaptive
    history."""
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    df = dt.from_pydict({"k": [i % 5 for i in range(100)],
                         "v": [float(i) for i in range(100)]})
    df = df.into_partitions(8)
    with dt.execution_config_ctx(enable_aqe=True,
                                 target_partition_size_bytes=1 << 30):
        out = df.groupby("k").agg(col("v").sum().alias("s")) \
            .sort("k").to_pydict()
    assert out["k"] == [0, 1, 2, 3, 4]
    assert out["s"] == [sum(float(i) for i in range(100) if i % 5 == k)
                        for k in range(5)]
    planner = adaptive.last_planner()
    assert planner is not None and planner.history
    assert any("fused partitioned agg" in s.decision
               for s in planner.history)


def test_aqe_demotes_hash_join_to_broadcast(monkeypatch):
    """With AQE on, a planned hash-hash join whose measured build side
    fits the broadcast threshold broadcasts it; a zero threshold keeps
    the hash-hash plan."""
    from daft_tpu_torch.physical import plan as pp
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    big = dt.from_pydict(
        {"k": [i % 10 for i in range(20_000)],
         "v": list(range(20_000))}).into_partitions(4)
    small = dt.from_pydict(
        {"k": [i % 1000 for i in range(10_000)],
         "w": [f"n{i % 1000}" for i in range(10_000)]}) \
        .into_partitions(4).where(col("k") == 0)
    with dt.execution_config_ctx(enable_aqe=True,
                                 broadcast_join_size_bytes_threshold=4096):
        out = big.join(small, on="k").groupby("w") \
            .agg(col("v").sum().alias("s")).sort("w").to_pydict()
    assert out["w"] == ["n0"]
    assert out["s"] == [sum(range(0, 20_000, 10)) * 10]

    def final_strategies(planner):
        found = []

        def walk(n):
            if isinstance(n, pp.HashJoin):
                found.append(n.strategy)
            for c in n.children:
                walk(c)
        walk(planner.final_plan)
        return found

    planner = adaptive.last_planner()
    assert planner is not None
    decisions = [h.decision for h in planner.history
                 if "join input" in h.decision]
    assert decisions, planner.explain_analyze()
    assert any(s in ("broadcast_right", "broadcast_left")
               for s in final_strategies(planner)), planner.final_plan
    with dt.execution_config_ctx(enable_aqe=True,
                                 broadcast_join_size_bytes_threshold=0):
        out2 = big.join(small, on="k").groupby("w") \
            .agg(col("v").sum().alias("s")).sort("w").to_pydict()
    assert out2 == out
    planner = adaptive.last_planner()
    assert all(s == "hash" for s in final_strategies(planner)), \
        final_strategies(planner)


def test_user_repartition_not_adapted():
    df = dt.from_pydict({"k": list(range(50))})
    with dt.execution_config_ctx(enable_aqe=True,
                                 target_partition_size_bytes=1 << 30):
        out = df.repartition(6, col("k"))
        assert out.num_partitions() == 6
        got = out.to_pydict()
    assert sorted(got["k"]) == list(range(50))


def test_dashboard_serves_query_history():
    import urllib.request

    from daft_tpu_torch import dashboard

    port = dashboard.launch(0)
    try:
        df = dt.from_pydict({"x": [1, 2, 3]})
        df.select((col("x") * 2).alias("y")).to_pydict()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            page = r.read().decode()
        assert "daft-tpu-torch queries" in page
        assert "query 1" in page
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/queries", timeout=10) as r:
            data = json.loads(r.read())
        assert data and "operators" in data[0]
    finally:
        dashboard.shutdown()


def test_cli_version_and_dashboard_entry(capsys):
    from daft_tpu_torch.cli import main
    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == dt.__version__
    with pytest.raises(SystemExit):
        main(["bogus"])


def test_profile_capture_per_query(tmp_path, monkeypatch):
    """``DAFT_TORCH_PROFILE_DIR`` captures a torch.profiler trace around
    each query's execution (CPU activity here; CUDA too on a card),
    exported as a Kineto chrome trace, without disturbing results; a
    second query while the first holds the process-wide profiler runs
    without a capture."""
    monkeypatch.setenv("DAFT_TORCH_PROFILE_DIR", str(tmp_path))
    df = dt.from_pydict({"x": list(range(100))}).where(col("x") % 2 == 0)
    assert df.count_rows() == 50
    files = os.listdir(tmp_path)
    assert files, "no profiler trace written"
    path = obs.last_query_stats().profile_path
    assert path and os.path.basename(path) in files
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    holder = obs.ProfileCapture(str(tmp_path))
    try:
        assert holder.active
        second = obs.ProfileCapture(str(tmp_path))
        assert not second.active and second.stop() is None
    finally:
        holder.stop()


def test_otlp_export_posts_operator_counters(monkeypatch):
    """Per-operator counters export as OTLP/HTTP JSON metrics when
    ``DAFT_TORCH_OTLP_ENDPOINT`` is set."""
    import http.server
    import threading

    received = []
    done = threading.Event()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append((self.path, json.loads(body)))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"{}")
            done.set()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv("DAFT_TORCH_OTLP_ENDPOINT",
                           f"http://127.0.0.1:{srv.server_port}")
        out = (dt.from_pydict({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
               .groupby("k").agg(col("v").sum().alias("s"))
               .sort("k").to_pydict())
        assert out["k"] == [1, 2]
        assert done.wait(10), "no OTLP POST arrived"
    finally:
        srv.shutdown()
    path, payload = received[0]
    assert path == "/v1/metrics"
    scope = payload["resourceMetrics"][0]["scopeMetrics"][0]
    names = {m["name"] for m in scope["metrics"]}
    assert names == {"daft_torch.operator.rows_out",
                     "daft_torch.operator.batches_out",
                     "daft_torch.operator.cpu_us"}
    rows = next(m for m in scope["metrics"]
                if m["name"] == "daft_torch.operator.rows_out")
    ops = {a["value"]["stringValue"]
           for p in rows["sum"]["dataPoints"]
           for a in p["attributes"] if a["key"] == "operator"}
    assert any("Agg" in o for o in ops), ops


# ------------------------------------------------------------- parity

@pytest.fixture
def same_topology(monkeypatch):
    """One scan task per file and two workers per stage in both packages
    (module docstring); the reference without its device mesh, as the
    plan-parity tests run it."""
    from daft_tpu.execution import pipeline as ref_pipe
    from daft_tpu.parallel import mesh
    from daft_tpu_torch.execution import pipeline as pipe
    monkeypatch.setattr(mesh, "mesh_size", lambda: 1)
    monkeypatch.setattr(ref_pipe, "_default_workers", lambda: 2)
    monkeypatch.setattr(pipe, "_default_workers", lambda: 2)
    old = daft_tpu.get_context().execution_config
    daft_tpu.set_execution_config(scan_tasks_min_size_bytes=0)
    with dt.execution_config_ctx(scan_tasks_min_size_bytes=0):
        yield
    daft_tpu.set_execution_config(old)


def _node_rows(stats):
    """(depth, node type, rows_out or None) per physical node, in plan
    order."""
    out = []

    def walk(n, depth):
        st = stats._ops.get(id(n))
        out.append((depth, type(n).__name__,
                    None if st is None else st.rows_out))
        for c in n.children:
            walk(c, depth + 1)
    walk(stats.plan, 0)
    return out


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_operator_rows_equal_the_reference(tpch_root, same_topology, q):
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    RQ.ALL[q](_reader(daft_tpu, tpch_root)).collect()
    want = _node_rows(ref_obs.last_query_stats())
    df = Q.ALL[q](_reader(dt, tpch_root))
    df.collect()
    got = _node_rows(df._stats)
    assert got == want
    root_rows = got[0][2]
    assert root_rows == len(df)


def _render_shape(text):
    """The analyzed render's block headers and (depth, operator) lines."""
    heads, ops = [], []
    for ln in text.splitlines():
        m = re.match(r"^( *)(\w+): rows_out=", ln)
        if m:
            ops.append((len(m.group(1)) // 2, m.group(2)))
        elif not ln.startswith(" ") and ln.endswith(":") \
                or ln.startswith("trace: id="):
            heads.append(ln.split(" id=")[0])
    return heads, ops


def test_explain_analyze_prints_the_reference_blocks(
        tpch_root, tmp_path, monkeypatch, same_topology, capsys):
    """A spilled, traced, device-forced Q3: the same block headers
    (device kernels, spill, memory governor, io, trace) and the same
    operator lines as the reference's render."""
    from daft_tpu.execution import memory as ref_memory
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.execution import memory
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        monkeypatch.setenv(pre + "TRACE", "1")
        monkeypatch.setenv(pre + "DEVICE_FORCE", "1")
        monkeypatch.setenv(pre + "KERNEL_GROUPBY", "sort")
        monkeypatch.setenv(pre + "KERNEL_JOIN", "sort")
        monkeypatch.setenv(pre + "MEMORY_LIMIT", "64KB")
        monkeypatch.setenv(pre + "SPILL_DIR", str(tmp_path / pre))
    memory._spill_dir = ref_memory._spill_dir = None
    try:
        RQ.ALL[3](_reader(daft_tpu, tpch_root)).explain(analyze=True)
        want = capsys.readouterr().out
        Q.ALL[3](_reader(dt, tpch_root)).explain(analyze=True)
        got = capsys.readouterr().out
    finally:
        memory._spill_dir = ref_memory._spill_dir = None
    wh, wo = _render_shape(want)
    gh, go = _render_shape(got)
    assert go == wo
    assert gh == wh
    for head in ("device kernels", "spill (out-of-core tier):",
                 "memory governor:", "trace:"):
        assert any(h.startswith(head) for h in gh), (head, gh)
