"""The port's tracing plane (``daft_tpu_torch/tracing.py``) against the
reference's (``tests/test_tracing.py``).

- The reference's own cases, each run through the port: tracing off by
  default and under sampling 0, pure span ids (the same ids as the
  reference's), the bounded recorder, a local query's trace exported as
  Chrome JSON with the registry emptied after the export, the wire-header
  round trip, the remote span merge with its clock offset, the Chrome
  validator, the strict Prometheus parser, the flight recorder's record,
  rotation and history endpoint, the dashboard's bounded history, OTLP
  against a hung collector, a collector that answers 500 and a collector
  that takes a traced query's spans, and the aborted trace of a planner
  failure.
- Parity: TPC-H Q1 and Q3 (SF 0.003, one scan task per file, the device
  dispatch forced on both sides with the sort strategies) and a grace
  hash join spilled under a 400KB budget, traced through both packages.
  Each span is compared as (name, lane, parent's name) in a multiset:
  the planner, scan and spill lanes, the ``op:*`` spans and the ``dev:*``
  lanes exactly; the ``device`` lane as counts per span name. Two stage
  topologies of the port's push pipeline differ by design, so the
  ``pipeline:stage`` spans compare by stage kind: a chain of map
  operators runs as one stage, and the partitioned-agg stage runs
  ``min(workers, partitions)`` reducers. Both packages run with two
  workers, which the three-file exchanges admit, so the reducer counts
  match too; the chain stays the one difference. Times are never
  compared.
- The ``/metrics`` names equal the reference's, the prefix swapped, less
  the planes that wait for their modules (named in ``prometheus_text``),
  with a shared serving scheduler running in each package, so the
  serving gauges and counters are held too.
- The reference's serving cases: the ``/metrics`` serving gauges, the
  ``serve:queue`` / ``serve:run`` spans of a scheduled query, a failed
  scheduled query still exported (flight recorder and trace), and a
  cancelled queued query's trace closed.
- Port-only: a thread kept across queries carries no trace into the next
  query; two queries at once each see only their own dispatches.

The reference's chaos and distributed trace cases (the remote worker's
span shipping, its concurrent tasks) are in
``tests/test_torch_resilience.py``.
"""

import collections
import glob
import json
import os
import re
import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch as dt
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch
from daft_tpu import observability as ref_obs
from daft_tpu import tracing as ref_tracing
from daft_tpu_torch import col
from daft_tpu_torch import observability as obs
from daft_tpu_torch import tracing

_KNOBS = ("TRACE", "TRACE_SAMPLE", "TRACE_DIR", "TRACE_MAX_SPANS",
          "OTLP_ENDPOINT", "OTLP_TIMEOUT", "QUERY_LOG", "QUERY_LOG_BYTES",
          "SLOW_QUERY_MS", "CHROME_TRACE", "PROFILE_DIR")


@pytest.fixture(autouse=True)
def _clean_tracing(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    for k in _KNOBS:
        monkeypatch.delenv("DAFT_TORCH_" + k, raising=False)
        monkeypatch.delenv("DAFT_TPU_" + k, raising=False)
    tracing.reset_for_tests()
    yield
    tracing.reset_for_tests()


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_tracing")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


def _small_query():
    return dt.from_pydict({"x": [1, 2, 3]}).where(col("x") > 1)


# ------------------------------------------------------------ gating

def test_tracing_off_by_default():
    df = _small_query()
    df.collect()
    stats = df._stats
    assert stats.trace_ctx is None
    assert stats.trace_summary == {}
    # span sites are no-ops on untraced threads
    assert tracing.current() is None
    assert tracing.span("anything") is tracing._NOOP


def test_sampling_zero_traces_nothing(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    monkeypatch.setenv("DAFT_TORCH_TRACE_SAMPLE", "0.0")
    df = _small_query()
    df.collect()
    assert df._stats.trace_ctx is None
    with tracing._reg_lock:
        assert tracing._recorders == {}


def test_span_ids_are_pure_functions_of_keys():
    assert tracing.span_id_from("task:s0.t1") == \
        tracing.span_id_from("task:s0.t1")
    assert tracing.span_id_from("task:s0.t1") != \
        tracing.span_id_from("task:s0.t2")
    assert len(tracing.span_id_from("x")) == 16
    # the reference mints the same ids from the same keys
    for key in ("query", "op:Filter", "stage:dsp-Project", "scan.t3"):
        assert tracing.span_id_from(key) == ref_tracing.span_id_from(key)


def test_recorder_bounded():
    rec = tracing.SpanRecorder("t" * 32, max_spans=5)
    for i in range(10):
        rec.add("s", tracing.span_id_from(f"k{i}"), None, i, 1)
    assert len(rec.spans()) == 5
    assert rec.dropped == 5
    assert rec.summary()["dropped"] == 5


def test_events_attach_and_drain():
    """Zero-duration events land under the attached context (none on an
    untraced thread), ``run_attached`` carries a context into a call, and
    ``drain`` hands the buffered spans over once."""
    rec = tracing.SpanRecorder("ef" * 16)
    ctx = tracing.SpanContext(rec, rec.root_id)
    tracing.event("ignored")
    with tracing.attach(ctx):
        tracing.event("cancel", attrs={"why": "test"})
        with tracing.span("outer", lane="planner"):
            tracing.event("inner")
    assert tracing.current() is None
    tracing.run_attached(ctx, tracing.event, "shipped", lane="worker:w")
    got = rec.drain()
    byname = {s["name"]: s for s in got}
    assert set(byname) == {"cancel", "outer", "inner", "shipped"}
    assert byname["inner"]["parent_id"] == byname["outer"]["span_id"]
    assert byname["cancel"]["dur_us"] == 0
    assert byname["cancel"]["attrs"] == {"why": "test"}
    assert rec.drain() == [] and rec.spans() == []


# ----------------------------------------------------- local tracing

def test_local_query_trace_exports_chrome(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    monkeypatch.setenv("DAFT_TORCH_TRACE_DIR", str(tmp_path))
    df = (dt.from_pydict({"x": list(range(500)),
                          "g": [i % 5 for i in range(500)]})
          .where(col("x") > 10).groupby("g").agg(col("x").sum().alias("s")))
    df.collect()
    stats = df._stats
    assert stats.trace_ctx is not None
    assert stats.trace_summary.get("spans", 0) > 0
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert files, "no chrome trace exported"
    with open(files[0]) as f:
        doc = json.load(f)
    assert tracing.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "query" in names
    assert "plan:optimize" in names and "plan:translate" in names
    assert "pipeline:stage" in names
    assert any(n.startswith("op:") for n in names)
    assert tracing.orphan_spans(stats.trace_ctx.recorder) == []
    # explain(analyze=True) renders the trace line
    assert "trace: id=" in stats.render()


def test_trace_registry_unregisters_after_export(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    df = _small_query()
    df.collect()
    rec = df._stats.trace_ctx.recorder
    assert rec.exported
    assert tracing.recorder_for(rec.trace_id) is None


def test_aqe_query_is_one_trace(monkeypatch):
    """The AQE loop's join-input materializations run in a nested scope:
    one trace for the query, its planner spans per round, exported once
    at the end."""
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    left = dt.from_pydict({"k": [i % 10 for i in range(200)],
                           "v": list(range(200))})
    right = dt.from_pydict({"k": list(range(10)), "w": list(range(10))}) \
        .where(col("k") < 5)
    with dt.execution_config_ctx(enable_aqe=True):
        df = left.join(right, on="k")
        df.collect()
    assert len(df) == 100
    rec = df._stats.trace_ctx.recorder
    names = collections.Counter(s["name"] for s in rec.spans())
    assert names["query"] == 1
    assert names["plan:translate"] >= 2 and names["plan:optimize"] >= 2
    assert tracing.orphan_spans(rec) == []
    with tracing._reg_lock:
        assert tracing._recorders == {}


# ------------------------------------------------------ wire context

def test_wire_headers_roundtrip():
    rec = tracing.SpanRecorder("ab" * 16)
    tracing.register_recorder(rec)
    ctx = tracing.SpanContext(rec, rec.root_id)
    hdrs = tracing.wire_headers(ctx)
    assert hdrs["X-Daft-Trace-Id"] == rec.trace_id
    back = tracing.context_from_headers(hdrs)
    assert back is not None
    assert back.recorder is rec and back.span_id == rec.root_id
    # unknown trace (other process) → None
    tracing.unregister_recorder(rec.trace_id)
    assert tracing.context_from_headers(hdrs) is None
    assert tracing.context_from_headers({}) is None


def test_remote_span_merge_applies_clock_offset():
    rec = tracing.SpanRecorder("cd" * 16)
    remote = [{"name": "task:run", "span_id": tracing.span_id_from("r"),
               "parent_id": rec.root_id, "ts_us": 1_000_000,
               "dur_us": 5, "lane": "worker:w9"}]
    rec.add_remote(remote, offset_us=250, worker="http://w9:1")
    s = rec.spans()[0]
    assert s["ts_us"] == 1_000_250
    assert rec.summary()["clock_offsets_us"] == {"http://w9:1": 250}
    # malformed remote spans are counted, not raised
    rec.add_remote([{"nope": 1}], 0, "w")
    assert rec.dropped == 1


# ------------------------------------------------------ chrome schema

def test_chrome_validator_catches_bad_traces():
    assert tracing.validate_chrome_trace({}) == \
        ["traceEvents is not a list"]
    bad_phase = {"traceEvents": [
        {"name": "x", "ph": "Q", "pid": 1, "tid": 1}]}
    assert tracing.validate_chrome_trace(bad_phase)
    neg_ts = {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": -5, "dur": 1}]}
    assert tracing.validate_chrome_trace(neg_ts)
    non_monotonic = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 10, "dur": 1},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5, "dur": 1}]}
    assert any("non-monotonic" in p
               for p in tracing.validate_chrome_trace(non_monotonic))
    unmatched = {"traceEvents": [
        {"name": "a", "ph": "B", "pid": 1, "tid": 1, "ts": 1}]}
    assert any("unmatched B" in p
               for p in tracing.validate_chrome_trace(unmatched))
    ok = {"traceEvents": [
        {"name": "a", "ph": "B", "pid": 1, "tid": 1, "ts": 1},
        {"name": "a", "ph": "E", "pid": 1, "tid": 1, "ts": 2}]}
    assert tracing.validate_chrome_trace(ok) == []


# ---------------------------------------------------------- /metrics

def test_prometheus_text_parses_strictly():
    text = tracing.prometheus_text()
    metrics = tracing.parse_prometheus_text(text)
    assert "daft_torch_flight_recorder_queries_total" in metrics
    assert "daft_torch_traces_active" in metrics
    for bad in ("no value\n", "0badname 1\n", "m 1 2 3\n", "m notanum\n",
                "# TYPE m sometype\n"):
        with pytest.raises(ValueError):
            tracing.parse_prometheus_text(bad)


#: name stems of the reference's sanitizer planes, whose counters depend on
#: what armed them earlier in the process
_WAITING = ("daft_tpu_retrace_", "daft_tpu_plansan_")


def _force_both(monkeypatch):
    """The device dispatch forced in both packages, the sort strategies
    (the port's on CPU tensors), hash joins through the device path."""
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        monkeypatch.setenv(pre + "DEVICE_FORCE", "1")
        monkeypatch.setenv(pre + "DEVICE_JOIN", "1")
        monkeypatch.setenv(pre + "KERNEL_GROUPBY", "sort")
        monkeypatch.setenv(pre + "KERNEL_JOIN", "sort")


@pytest.fixture
def same_topology(monkeypatch):
    """Both packages at one scan task per file and two workers per stage
    (see the module docstring); the reference without its device mesh,
    as the port's plan-parity tests run it."""
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


def test_metric_names_equal_the_reference(tpch_root, monkeypatch,
                                          same_topology):
    """Fresh planes in both packages, the same forced Q1 and Q3 through
    each, and Q1 once more through a shared serving scheduler in each:
    the same metric names, the prefix swapped, less the waiting
    planes."""
    from daft_tpu.device import costmodel as ref_cm
    from daft_tpu.execution import governor as ref_gov
    from daft_tpu.execution import memory as ref_mem
    from daft_tpu.io import read_planner as ref_rp
    from daft_tpu.physical import adaptive as ref_ad
    from daft_tpu_torch.device import costmodel as cm
    from daft_tpu_torch.execution import governor as gov
    from daft_tpu_torch.execution import memory as mem
    from daft_tpu_torch.io import read_planner as rp
    from daft_tpu_torch.physical import adaptive as ad
    from daft_tpu.distributed import resilience as ref_rz
    from daft_tpu.distributed import shuffle_service as ref_ss
    from daft_tpu_torch.distributed import resilience as rz
    from daft_tpu_torch.distributed import shuffle_service as ss
    from daft_tpu.fleet import state_sync as ref_fleet
    from daft_tpu_torch.fleet import state_sync as fleet
    for m, attr in ((ref_fleet, "_counters"), (fleet, "_counters"),
                    (ref_ss, "_shuffle_counters"),
                    (ss, "_shuffle_counters"),
                    (ref_rz, "_counters"), (rz, "_counters"),
                    (ref_rp, "_counters"), (rp, "_counters"),
                    (ref_mem, "_spill_counters"), (mem, "_spill_counters"),
                    (ref_gov, "_counters"), (gov, "_counters"),
                    (ref_ad, "_counters"), (ad, "_counters"),
                    (ref_cm, "kernel_ledger"), (cm, "kernel_ledger"),
                    (ref_obs, "_obs_counters"), (obs, "_obs_counters")):
        monkeypatch.setattr(m, attr, {})
    _force_both(monkeypatch)
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    for q in (1, 3):
        RQ.ALL[q](_reader(daft_tpu, tpch_root)).collect()
        Q.ALL[q](_reader(dt, tpch_root)).collect()
    import daft_tpu.serving as ref_serving
    from daft_tpu_torch import serving
    scheds = []
    for mod, q in ((ref_serving, RQ.ALL[1](_reader(daft_tpu, tpch_root))),
                   (serving, Q.ALL[1](_reader(dt, tpch_root)))):
        sched = mod.QueryScheduler(concurrency=1)
        scheds.append(sched)
        monkeypatch.setattr(mod, "_shared", sched)
        sched.submit(q).result(timeout=120)
    ref = {n.replace("daft_tpu_", "daft_torch_", 1)
           for n in ref_tracing.parse_prometheus_text(
               ref_tracing.prometheus_text())
           if not n.startswith(_WAITING)}
    got = set(tracing.parse_prometheus_text(tracing.prometheus_text()))
    for sched in scheds:
        sched.shutdown()
    assert any(n.startswith("daft_torch_kernel_") for n in got)
    assert any(n.startswith("daft_torch_io_") for n in got)
    assert "daft_torch_serving_completed_total" in got
    assert got == ref


def test_metrics_endpoint_serves_the_kernel_counters(monkeypatch):
    import urllib.request

    from daft_tpu_torch import dashboard
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    port = dashboard.launch(0)
    try:
        dt.from_pydict({"x": list(range(100)),
                        "g": [i % 4 for i in range(100)]}) \
            .groupby("g").agg(col("x").sum().alias("s")).collect()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        metrics = tracing.parse_prometheus_text(text)
        assert metrics.get(
            "daft_torch_kernel_grouped_agg_dispatches_total", 0) >= 1
        assert "daft_torch_rss_peak_bytes" in metrics
    finally:
        dashboard.shutdown()


def test_metrics_endpoint_and_serving_gauges(monkeypatch):
    import urllib.request

    from daft_tpu_torch import dashboard, serving

    sched = serving.QueryScheduler(concurrency=1)
    monkeypatch.setattr(serving, "_shared", sched)
    port = dashboard.launch(0)
    try:
        df = dt.from_pydict({"x": list(range(100)),
                             "g": [i % 4 for i in range(100)]}) \
            .groupby("g").agg(col("x").sum().alias("s"))
        sched.submit(df).result(timeout=60)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        metrics = tracing.parse_prometheus_text(text)
        assert metrics.get("daft_torch_serving_completed_total", 0) >= 1
        assert "daft_torch_serving_queue_depth" in metrics
        assert "daft_torch_serving_running" in metrics
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/serving", timeout=10) as r:
            view = json.loads(r.read().decode())
        assert view["concurrency"] == 1
        assert view["counters"]["completed"] >= 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            assert "serving queue (live)" in r.read().decode()
    finally:
        dashboard.shutdown()
        monkeypatch.setattr(serving, "_shared", None)
        sched.shutdown()


# ----------------------------------------------------- flight recorder

def test_flight_recorder_records_and_rotates(tmp_path, monkeypatch):
    path = str(tmp_path / "queries.jsonl")
    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG", path)
    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG_BYTES", "4000")
    monkeypatch.setenv("DAFT_TORCH_SLOW_QUERY_MS", "0.000001")
    dt.from_pydict({"x": list(range(50))}).where(col("x") > 5).collect()
    entries = tracing.flight_history()
    assert entries, "no flight-recorder entry for the query"
    e = entries[0]
    assert e["wall_us"] > 0 and "operators" in e
    assert e["slow"] is True  # any query beats a 1ns threshold
    # rotation: write entries past the byte cap
    for i in range(100):
        tracing.flight_record({"i": i, "pad": "x" * 128})
    assert os.path.exists(path + ".1"), "no rotated generation"
    assert os.path.getsize(path) <= 4000
    # history reads across generations, newest first
    hist = tracing.flight_history(limit=10)
    assert len(hist) == 10 and hist[0]["i"] == 99


def test_flight_recorder_history_endpoint(tmp_path, monkeypatch):
    import urllib.request

    from daft_tpu_torch import dashboard

    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG",
                       str(tmp_path / "queries.jsonl"))
    _small_query().collect()
    port = dashboard.launch(0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/history", timeout=10) as r:
            hist = json.loads(r.read())
        assert hist and "wall_us" in hist[0]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=10) as r:
            page = r.read().decode()
        assert "flight recorder" in page
    finally:
        dashboard.shutdown()


def test_calibration_ingests_the_flight_history(tmp_path, monkeypatch):
    """A fresh process with calibration on seeds its profile from the
    flight recorder's ``device_kernels`` blocks, once."""
    from daft_tpu_torch.device import calibration
    path = str(tmp_path / "queries.jsonl")
    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG", path)
    tracing.flight_record({"device_kernels": {"grouped_agg": {
        "dispatches": 4, "rows": 1 << 22, "bytes": float(1 << 28),
        "seconds": 0.05, "strategy": "sort"}}})
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    calibration.reset_for_tests()
    try:
        assert calibration.ingest_flight_history() == 1
        assert calibration.ingest_flight_history() == 0   # latched
        assert calibration.profile_entries()
    finally:
        monkeypatch.delenv("DAFT_TORCH_CALIBRATION")
        calibration.reset_for_tests()


# ------------------------------------------------- dashboard history cap

def test_dashboard_history_bounded_by_count_and_bytes(monkeypatch):
    from daft_tpu_torch import dashboard

    monkeypatch.setattr(dashboard, "_history", [])
    monkeypatch.setattr(dashboard, "_history_bytes", [])
    monkeypatch.setattr(dashboard, "_MAX_HISTORY", 10)
    monkeypatch.setattr(dashboard, "_MAX_HISTORY_BYTES", 3000)

    class FakeStats:
        def as_dict(self):
            return {"Op": {"rows_out": 1}}

        def render(self, plan=None):
            return "explain " + "y" * 400  # ~420B entries

    for _ in range(50):
        dashboard.broadcast_query(FakeStats())
    assert len(dashboard._history) <= 10
    assert sum(dashboard._history_bytes) <= 3000
    # byte cap binds before the count cap with these sizes
    assert len(dashboard._history) < 10
    # the newest entry always survives
    assert dashboard._history[-1]["explain"].startswith("explain")


# -------------------------------------------------- otlp hardening

class _StubCollector:
    """OTLP collector stub: mode 'ok' | 'hang' | '500'."""

    def __init__(self, mode):
        import http.server

        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                if stub.mode == "hang":
                    stub.hung.wait(20)
                    return
                stub.received.append((self.path, json.loads(body)))
                code = 500 if stub.mode == "500" else 200
                self.send_response(code)
                self.end_headers()
                self.wfile.write(b"{}")
                stub.got.set()

            def log_message(self, *a):
                pass

        self.mode = mode
        self.received = []
        self.got = threading.Event()
        self.hung = threading.Event()
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                   Handler)
        threading.Thread(target=self.srv.serve_forever,
                         daemon=True).start()

    @property
    def endpoint(self):
        return f"http://127.0.0.1:{self.srv.server_port}"

    def shutdown(self):
        self.hung.set()
        self.srv.shutdown()


def _wait_errors_above(before):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if obs.obs_counters_snapshot().get(
                "otlp_export_errors", 0) > before:
            return True
        time.sleep(0.05)
    return False


def test_otlp_hung_collector_never_stalls_query(monkeypatch):
    stub = _StubCollector("hang")
    try:
        monkeypatch.setenv("DAFT_TORCH_OTLP_ENDPOINT", stub.endpoint)
        monkeypatch.setenv("DAFT_TORCH_OTLP_TIMEOUT", "0.3")
        before = obs.obs_counters_snapshot().get("otlp_export_errors", 0)
        t0 = time.monotonic()
        out = _small_query().count_rows()
        elapsed = time.monotonic() - t0
        assert out == 2
        # the query path never blocks on the hung POST
        assert elapsed < 10
        assert _wait_errors_above(before)
    finally:
        stub.shutdown()


def test_otlp_500_counted_not_raised(monkeypatch):
    stub = _StubCollector("500")
    try:
        monkeypatch.setenv("DAFT_TORCH_OTLP_ENDPOINT", stub.endpoint)
        before = obs.obs_counters_snapshot().get("otlp_export_errors", 0)
        _small_query().collect()
        assert _wait_errors_above(before)
    finally:
        stub.shutdown()


def test_otlp_spans_posted_for_traced_query(monkeypatch):
    stub = _StubCollector("ok")
    try:
        monkeypatch.setenv("DAFT_TORCH_OTLP_ENDPOINT", stub.endpoint)
        monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
        _small_query().collect()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(p == "/v1/traces" for p, _ in stub.received):
                break
            time.sleep(0.05)
        traces = [b for p, b in stub.received if p == "/v1/traces"]
        assert traces, [p for p, _ in stub.received]
        scope = traces[0]["resourceSpans"][0]["scopeSpans"][0]
        names = {s["name"] for s in scope["spans"]}
        assert "query" in names
        # metrics still export beside spans
        assert any(p == "/v1/metrics" for p, _ in stub.received)
    finally:
        stub.shutdown()


# ---------------------------------------------------- trace lifecycle

# ------------------------------------------------------- serving plane

def test_serving_trace_has_queue_and_run_spans(monkeypatch):
    from daft_tpu_torch import serving

    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    sched = serving.QueryScheduler(concurrency=1)
    try:
        df = dt.from_pydict({"x": list(range(200)),
                             "g": [i % 3 for i in range(200)]}) \
            .groupby("g").agg(col("x").sum().alias("s"))
        h = sched.submit(df, session="traced")
        h.result(timeout=60)
        assert h.trace_ctx is not None
        rec = h.trace_ctx.recorder
        assert rec.exported  # finalized by the scheduler, once
        kinds = {s["name"] for s in rec.spans()}
        assert "serve:queue" in kinds and "serve:run" in kinds
        assert "plan:fingerprint" in kinds
        q = next(s for s in rec.spans() if s["name"] == "serve:queue")
        assert q["attrs"]["session"] == "traced"
        assert tracing.orphan_spans(rec) == []
        # the handle's stats carry the summary for explain and history
        assert h.stats.trace_summary.get("trace_id") == rec.trace_id
    finally:
        sched.shutdown()


def test_serving_failed_query_still_exported(tmp_path, monkeypatch):
    """A FAILED serving query still lands in the flight recorder (with
    the error) and exports its trace with error status; only rejected
    and cancelled queries skip."""
    from daft_tpu_torch import DataType, serving, udf

    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG", str(tmp_path / "q.jsonl"))
    monkeypatch.setenv("DAFT_TORCH_TRACE_DIR", str(tmp_path))

    @udf(return_dtype=DataType.int64())
    def boom(x):
        raise RuntimeError("intentional test failure")

    sched = serving.QueryScheduler(concurrency=1)
    try:
        df = dt.from_pydict({"x": [1, 2, 3]}).select(boom(col("x")))
        h = sched.submit(df)
        with pytest.raises(Exception):
            h.result(timeout=60)
        assert h.state == "failed"
        entries = [e for e in tracing.flight_history()
                   if (e.get("serving") or {}).get("state") == "failed"]
        assert entries, tracing.flight_history()
        assert "intentional test failure" in entries[0]["serving"]["error"]
        assert h.trace_ctx is not None
        rec = h.trace_ctx.recorder
        assert rec.exported
        root = next(s for s in rec.spans() if s["name"] == "query")
        assert root.get("status") == "error"
        assert glob.glob(str(tmp_path / "trace_*.json"))
    finally:
        sched.shutdown()


def test_serving_cancel_event_and_trace_close(monkeypatch):
    """A queued query cancelled before it runs: its trace closes (the
    recorder exported and unregistered) with a ``serve:cancel`` event."""
    from daft_tpu_torch import DataType, serving, udf

    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    gate, started = threading.Event(), threading.Event()

    @udf(return_dtype=DataType.int64())
    def block(s):
        started.set()
        gate.wait(30)
        return s.to_pylist()

    sched = serving.QueryScheduler(concurrency=1)
    try:
        h1 = sched.submit(dt.from_pydict({"x": [1]})
                          .select(block(col("x"))))
        assert started.wait(20)  # h1 holds the only worker
        h2 = sched.submit(dt.from_pydict({"x": [1]}).where(col("x") > 0))
        h2.cancel("test cancel")
        with pytest.raises(Exception):
            h2.result(timeout=30)
        assert h2.state == "cancelled"
        assert h2.trace_ctx is not None
        rec = h2.trace_ctx.recorder
        assert rec.exported  # closed, not leaked
        assert tracing.recorder_for(rec.trace_id) is None
        assert "serve:cancel" in {s["name"] for s in rec.spans()}
        gate.set()
        h1.result(timeout=60)
    finally:
        gate.set()
        sched.shutdown()


def test_planner_failure_aborts_and_unregisters_trace(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")

    def boom(plan):
        raise RuntimeError("translate exploded")

    monkeypatch.setattr("daft_tpu_torch.runners.native_runner.translate",
                        boom)
    df = _small_query()
    with pytest.raises(RuntimeError, match="translate exploded"):
        df.to_pydict()
    # the aborted trace closed and left the registry
    with tracing._reg_lock:
        assert dict(tracing._recorders) == {}


def test_abort_trace_is_idempotent_and_none_safe():
    tracing.abort_trace(None)  # no-op
    rec = tracing.SpanRecorder("t" * 32)
    tracing.register_recorder(rec)
    ctx = tracing.SpanContext(rec, rec.root_id)
    tracing.abort_trace(ctx)
    tracing.abort_trace(ctx)  # second call: already exported, no-op
    assert rec.exported and rec.status == "error"
    with tracing._reg_lock:
        assert rec.trace_id not in tracing._recorders


# ----------------------------------------------- span-tree parity

def _tree(rec):
    spans = rec.spans()
    byid = {s["span_id"]: s for s in spans}
    return collections.Counter(
        (s["name"], s["lane"],
         byid.get(s["parent_id"], {"name": "-"})["name"]) for s in spans)


def _stage_kinds(rec):
    """``pipeline:stage`` spans by stage kind (``wrk-Project``,
    ``drv-HashJoin``, …: the thread name without its worker index)."""
    return {re.sub(r"-\d+$", "", s["attrs"]["thread"])
            for s in rec.spans() if s["name"] == "pipeline:stage"}


def _compare_trees(ref_rec, rec):
    ref, got = _tree(ref_rec), _tree(rec)
    # every lane but ``device`` and the pipeline stages: exactly
    exact = lambda t: collections.Counter(  # noqa: E731
        {k: n for k, n in t.items()
         if k[1] != "device" and k[0] != "pipeline:stage"})
    assert exact(got) == exact(ref)
    # the device lane: the span counts per kind
    dev = lambda t: collections.Counter(  # noqa: E731
        {k[0]: 0 for k in t if k[1] == "device"})
    dref, dgot = dev(ref), dev(got)
    for k, n in ref.items():
        if k[1] == "device":
            dref[k[0]] += n
    for k, n in got.items():
        if k[1] == "device":
            dgot[k[0]] += n
    assert dgot == dref
    # pipeline stages: every one under the query root, the same kinds
    assert {k for k in got if k[0] == "pipeline:stage"} == \
        {("pipeline:stage", "pipeline", "query")}
    assert _stage_kinds(rec) == _stage_kinds(ref_rec)
    assert tracing.orphan_spans(rec) == []


@pytest.mark.parametrize("q", [1, 3])
def test_span_tree_equals_the_reference(tpch_root, monkeypatch,
                                        same_topology, q):
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    _force_both(monkeypatch)
    monkeypatch.setenv("DAFT_TPU_TRACE", "1")
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    RQ.ALL[q](_reader(daft_tpu, tpch_root)).collect()
    ref_rec = ref_obs.last_query_stats().trace_ctx.recorder
    df = Q.ALL[q](_reader(dt, tpch_root))
    df.collect()
    rec = df._stats.trace_ctx.recorder
    _compare_trees(ref_rec, rec)
    if q == 3:   # the scan producers: one span per scan task
        assert _tree(rec)[("scan:prefetch", "scan", "query")] == 9
    # the device spans are the query's dispatches
    dk = df._stats.device_kernels
    for kind in ("grouped_agg", "projection"):
        n = sum(1 for s in rec.spans() if s["name"] == f"device:{kind}")
        assert n == dk[kind]["dispatches"], (kind, n, dk)


def test_spilled_join_span_tree_equals_the_reference(tmp_path,
                                                     monkeypatch):
    import numpy as np
    from daft_tpu.execution import memory as ref_memory
    from daft_tpu.execution import pipeline as ref_pipe
    from daft_tpu_torch.execution import memory
    from daft_tpu_torch.execution import pipeline as pipe
    monkeypatch.setattr(ref_pipe, "_default_workers", lambda: 2)
    monkeypatch.setattr(pipe, "_default_workers", lambda: 2)
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        monkeypatch.setenv(pre + "TRACE", "1")
        monkeypatch.setenv(pre + "MEMORY_LIMIT", "400KB")
        monkeypatch.setenv(pre + "SPILL_DIR", str(tmp_path / pre))
    memory._spill_dir = ref_memory._spill_dir = None
    rng = np.random.default_rng(0)
    n = 30_000
    k = rng.integers(0, 10_000, n).tolist()
    left = {"k": k, "v": list(range(n))}
    right = {"k": k[: n // 2], "w": list(range(n // 2))}

    def q(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), on="k",
                                          strategy="hash")
    try:
        q(daft_tpu).collect()
        ref_st = ref_obs.last_query_stats()
        df = q(dt)
        df.collect()
    finally:
        memory._spill_dir = ref_memory._spill_dir = None
    st = df._stats
    assert st.spill.get("joins_partitioned", 0) >= 1, st.spill
    assert st.spill == ref_st.spill
    _compare_trees(ref_st.trace_ctx.recorder, st.trace_ctx.recorder)


# ------------------------------------------------------------ port-only

def test_kept_stage_threads_carry_no_trace_into_the_next_query(
        monkeypatch):
    """A traced query, then an untraced one on the same kept stage
    threads: the second records no span anywhere, and after both the
    registry is empty."""
    from daft_tpu_torch.execution import pipeline as pipe

    def q():
        df = (dt.from_pydict({"x": list(range(2000)),
                              "g": [i % 7 for i in range(2000)]})
              .where(col("x") > 3).with_column("y", col("x") * 2)
              .groupby("g").agg(col("y").sum().alias("s")))
        df.collect()
        return df

    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    first = q()
    rec = first._stats.trace_ctx.recorder
    n_spans = len(rec.spans())
    assert n_spans > 0
    idle = len(pipe._STAGE_THREADS._idle)
    assert idle > 0
    monkeypatch.delenv("DAFT_TORCH_TRACE")
    second = q()
    assert second._stats.trace_ctx is None
    # the second query's stages ran on the first's threads ...
    assert len(pipe._STAGE_THREADS._idle) == idle
    # ... and added nothing to its trace
    assert len(rec.spans()) == n_spans
    assert tracing.current() is None and obs.current_attribution() is None
    with tracing._reg_lock:
        assert tracing._recorders == {}


def test_concurrent_queries_see_only_their_own_dispatches(tpch_root,
                                                          monkeypatch):
    """Two queries at once, on two threads: each one's ``device kernels``
    block equals its solo run's (the dispatches are credited through the
    dispatching thread's attribution, never the shared ledger's diff)."""
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    get = _reader(dt, tpch_root)

    def suppkey():
        return get("lineitem").groupby("l_suppkey").agg(
            col("l_quantity").sum().alias("q"))

    queries = {"q1": lambda: Q.ALL[1](get), "suppkey": suppkey}

    def kernels(df):
        return {k: (d["dispatches"], d["rows"])
                for k, d in df._stats.device_kernels.items()}

    solo = {}
    for name, make in queries.items():
        df = make()
        df.collect()
        solo[name] = kernels(df)
        assert solo[name], name
    assert solo["q1"] != solo["suppkey"]
    got, errors = {}, []
    barrier = threading.Barrier(len(queries))

    def run(name, make):
        try:
            df = make()
            barrier.wait()
            df.collect()
            got[name] = kernels(df)
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, args=kv)
               for kv in queries.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert got == solo
