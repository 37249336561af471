"""The port's serving plane (``daft_tpu_torch/serving/``) against the
reference's (``tests/test_serving.py``).

28 of the reference's 30 cases, each run through the port on CPU tensors
(``DAFT_TORCH_DEVICE=cpu``). Where a case checks answers, the same files
(written once with pyarrow) or the same in-memory data go through the
reference's ``QueryScheduler`` over ``daft_tpu`` and the port's over
``daft_tpu_torch``: keys, counts and integers must be equal, float sums
equal at relative 1e-9; and the counters both packages count (admission,
the cache hits and misses, rejections by kind) must be equal where the
run is deterministic (one worker, each result awaited before the next
submission). Where concurrency makes a counter timing-dependent, only
its deterministic sum is compared (hits plus misses).

Not here: ``test_operation_retention_ttl_and_byte_sweep`` and
``test_operation_cancel_callbacks_fire`` need Spark Connect's server and
operations, which come with ROADMAP A8b.

Port-only: 8 concurrent submissions of TPC-H Q1, Q3 and a group-by in a
child process with the lock-order sanitizer armed, with 0 cycles and
the unarmed answers, and neither ``jax`` nor ``daft_tpu`` imported.
"""

import http.server
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.parse

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu.serving  # noqa: F401  (the reference's scheduler)
import daft_tpu_torch as dt
from daft_tpu_torch import DataType, col, serving, udf
from daft_tpu_torch.execution.cancellation import (CancelToken,
                                                   QueryCancelled,
                                                   cancel_scope,
                                                   current_token)
from daft_tpu_torch.execution.memory import MemoryManager
from daft_tpu_torch.logical.fingerprint import fingerprint
from daft_tpu_torch.serving import QueryScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (daft_tpu, dt)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        for k in ("SERVE_MEMORY", "MEMORY_LIMIT", "SERVE_CONCURRENCY",
                  "SERVE_QUEUE_DEPTH", "SERVE_QUEUE_TIMEOUT",
                  "SERVE_PLAN_CACHE_BYTES", "SERVE_RESULT_CACHE_BYTES"):
            monkeypatch.delenv(pre + k, raising=False)


def mkdf(d):
    return dt.from_pydict(d)


def _write(root, table):
    os.makedirs(root, exist_ok=True)
    pq.write_table(table, os.path.join(root, "part-0.parquet"))
    return os.path.join(root, "*.parquet")


def _table(n=2000):
    return pa.table({"k": list(range(n)), "g": [i % 7 for i in range(n)],
                     "v": [float(i % 31) for i in range(n)]})


@pytest.fixture
def sched():
    s = QueryScheduler(concurrency=2, queue_timeout_s=20.0)
    yield s
    s.shutdown()


@pytest.fixture
def parquet_table(tmp_path):
    """A small parquet table on local disk (stat-able, so cacheable),
    read by both packages."""
    return _write(str(tmp_path / "t"), _table())


def _agg_query(glob, pkg=dt):
    return pkg.read_parquet(glob).groupby("g") \
        .agg(pkg.col("v").sum().alias("s")).sort("g")


def _answer(h, timeout=60):
    return h.result(timeout).to_recordbatch().to_pydict()


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9) or (a != a and b != b)
    return a == b


def _same(got: dict, want: dict) -> None:
    """Row for row: keys, counts and integers exact, floats at rel 1e-9."""
    assert list(got) == list(want), (list(got), list(want))
    for c in want:
        assert len(got[c]) == len(want[c]), c
        assert all(_close(a, b) for a, b in zip(got[c], want[c])), \
            (c, got[c], want[c])


#: counters both packages keep, compared where a run is deterministic
_COUNTED = ("submitted", "completed", "failed", "cancelled",
            "est_seeded_history", "plan_cache_hits", "plan_cache_misses",
            "plan_cache_evictions", "plan_cache_entries",
            "plan_cache_structure_hits", "result_cache_hits",
            "result_cache_misses", "result_cache_evictions",
            "result_cache_entries", "admitted_bytes_outstanding")


def _counted(snap: dict) -> dict:
    return {k: v for k, v in snap.items()
            if k in _COUNTED or k.startswith("rejected_")}


# ------------------------------------------------------------- scheduler

def test_submit_returns_correct_results(parquet_table):
    """Six submissions over three sessions at two workers in each
    package: the same answers; the result cache looked up six times."""
    runs = {}
    for pkg in PKGS:
        s = pkg.serving.QueryScheduler(concurrency=2, queue_timeout_s=20.0)
        try:
            expected = _agg_query(parquet_table, pkg).to_pydict()
            hs = [s.submit(_agg_query(parquet_table, pkg),
                           session=f"s{i % 3}") for i in range(6)]
            outs = [_answer(h) for h in hs]
            for out, h in zip(outs, hs):
                _same(out, expected)
                assert h.state == "done"
            assert s.admission.outstanding == 0
            runs[pkg.__name__] = (outs, s.counters_snapshot())
        finally:
            s.shutdown()
    (ref_outs, ref_snap), (outs, snap) = runs["daft_tpu"], \
        runs["daft_tpu_torch"]
    for a, b in zip(outs, ref_outs):
        _same(a, b)
    for k in ("submitted", "completed"):
        assert snap[k] == ref_snap[k] == 6
    assert snap["result_cache_hits"] + snap["result_cache_misses"] == \
        ref_snap["result_cache_hits"] + ref_snap["result_cache_misses"] == 6


def test_concurrent_stress_mixed_sessions(parquet_table):
    """12 mixed queries across 3 sessions at 4 workers: each answer equal
    to its solo run and to the reference scheduler's, no admission leak,
    zero lock-order cycles when the sanitizer is armed."""
    answers = {}
    for pkg in PKGS:
        c = pkg.col
        shapes = {
            "agg": lambda: _agg_query(parquet_table, pkg),
            "topk": lambda: pkg.read_parquet(parquet_table)
            .sort("v", desc=True).limit(5).select("k", "v"),
            "lookup": lambda: pkg.read_parquet(parquet_table)
            .where(c("k") == 123).select("k", "g"),
            "mem_join": lambda: pkg.from_pydict({"a": [1, 2, 3],
                                                 "b": [10, 20, 30]})
            .join(pkg.from_pydict({"a": [2, 3, 4], "c": [5, 6, 7]}),
                  on="a").sort("a"),
        }
        expected = {n: fac().to_pydict() for n, fac in shapes.items()}
        s = pkg.serving.QueryScheduler(concurrency=4)
        try:
            names = ["agg", "topk", "lookup", "mem_join"] * 3
            hs = [(n, s.submit(shapes[n](), session=f"sess-{i % 3}"))
                  for i, n in enumerate(names)]
            for n, h in hs:
                got = _answer(h, 120)
                if n == "topk":  # ties in v: the top 5 as a set of values
                    assert sorted(got["v"]) == sorted(expected[n]["v"])
                else:
                    _same(got, expected[n])
            assert s.admission.outstanding == 0
        finally:
            s.shutdown()
        answers[pkg.__name__] = expected
    for n in ("agg", "lookup", "mem_join"):
        _same(answers["daft_tpu_torch"][n], answers["daft_tpu"][n])
    from daft_tpu_torch.analysis import lock_sanitizer
    if lock_sanitizer.is_enabled():
        assert lock_sanitizer.summary()["cycles"] == []


def _gated_query(pkg, gate: threading.Event, started=None, tag=None,
                 order=None):
    """An in-memory query whose single morsel blocks on ``gate`` (and
    optionally records ``tag`` into ``order`` when it runs)."""

    @pkg.udf(return_dtype=pkg.DataType.int64())
    def block(s):
        if started is not None:
            started.set()
        if order is not None:
            order.append(tag)
        gate.wait(30)
        return s.to_pylist()

    return pkg.from_pydict({"a": [1]}).select(block(pkg.col("a")))


def _fair_share_order(pkg) -> list:
    sched = pkg.serving.QueryScheduler(concurrency=1, queue_timeout_s=60.0)
    try:
        gate0, started = threading.Event(), threading.Event()
        blocker = sched.submit(_gated_query(pkg, gate0, started),
                               session="z")
        assert started.wait(20)  # the worker is pinned; the queue builds
        order = []
        done_gate = threading.Event()
        done_gate.set()  # queued queries don't block, only record
        hs = [sched.submit(_gated_query(pkg, done_gate, tag="A",
                                        order=order),
                           session="A", weight=2.0) for _ in range(6)]
        hs += [sched.submit(_gated_query(pkg, done_gate, tag="B",
                                         order=order),
                            session="B", weight=1.0) for _ in range(3)]
        gate0.set()
        blocker.result(60)
        for h in hs:
            h.result(60)
        assert all(h.state == "done" for h in hs)
        return order
    finally:
        sched.shutdown()


def test_weighted_fair_share_ordering():
    """concurrency=1: queued sessions drain by stride (weight 2 gets two
    dispatches for each one of weight 1; FIFO within a session), in the
    same order as the reference's."""
    order = _fair_share_order(dt)
    first6 = order[:6]
    assert first6.count("A") == 4 and first6.count("B") == 2, order
    assert order == _fair_share_order(daft_tpu)


def _priority_order(pkg) -> list:
    sched = pkg.serving.QueryScheduler(concurrency=1, queue_timeout_s=60.0)
    try:
        gate0, started = threading.Event(), threading.Event()
        blocker = sched.submit(_gated_query(pkg, gate0, started),
                               session="z")
        assert started.wait(20)
        order = []
        open_gate = threading.Event()
        open_gate.set()
        lo = sched.submit(_gated_query(pkg, open_gate, tag="lo",
                                       order=order),
                          session="s", priority=0)
        hi = sched.submit(_gated_query(pkg, open_gate, tag="hi",
                                       order=order),
                          session="s2", priority=5)
        gate0.set()
        blocker.result(60)
        lo.result(60)
        hi.result(60)
        return order
    finally:
        sched.shutdown()


def test_priority_dispatches_first():
    assert _priority_order(dt) == ["hi", "lo"] == _priority_order(daft_tpu)


def test_cancel_running_query_releases_admission():
    sched = QueryScheduler(concurrency=1, queue_timeout_s=60.0)
    try:
        gate, started = threading.Event(), threading.Event()
        h = sched.submit(_gated_query(dt, gate, started), session="s")
        assert started.wait(20)
        assert sched.admission.outstanding > 0  # admitted while running
        h.cancel("test cancel")
        gate.set()  # the morsel finishes; the executor sees the token next
        with pytest.raises(QueryCancelled):
            h.result(60)
        assert h.state == "cancelled"
        deadline = time.time() + 10
        while sched.admission.outstanding and time.time() < deadline:
            time.sleep(0.02)
        assert sched.admission.outstanding == 0  # admission released
    finally:
        sched.shutdown()


def test_cancel_queued_query_is_immediate():
    sched = QueryScheduler(concurrency=1, queue_timeout_s=60.0)
    try:
        gate, started = threading.Event(), threading.Event()
        blocker = sched.submit(_gated_query(dt, gate, started), session="s")
        assert started.wait(20)
        queued = sched.submit(mkdf({"a": [1]}).select(col("a")),
                              session="s")
        queued.cancel()
        with pytest.raises(QueryCancelled):
            queued.result(5)
        assert queued.state == "cancelled"
        gate.set()
        blocker.result(60)
        assert sched.admission.outstanding == 0
    finally:
        sched.shutdown()


def _queue_timeout(pkg):
    sched = pkg.serving.QueryScheduler(concurrency=1, queue_timeout_s=60.0)
    try:
        gate, started = threading.Event(), threading.Event()
        blocker = sched.submit(_gated_query(pkg, gate, started),
                               session="s")
        assert started.wait(20)
        held = sched.admission.outstanding
        late = sched.submit(pkg.from_pydict({"a": [1]}).select(
            pkg.col("a")), session="s", timeout_s=0.3)
        with pytest.raises(pkg.serving.AdmissionRejected) as ei:
            late.result(30)
        assert late.state == "rejected"
        assert sched.admission.outstanding == held  # never admitted
        gate.set()
        blocker.result(60)
        assert sched.admission.outstanding == 0
        return ei.value.kind, _counted(sched.counters_snapshot())
    finally:
        sched.shutdown()


def test_queue_timeout_rejects_without_admission():
    kind, snap = _queue_timeout(dt)
    assert kind == "queue_timeout"
    assert (kind, snap) == _queue_timeout(daft_tpu)


def _queue_full(pkg):
    sched = pkg.serving.QueryScheduler(concurrency=1, queue_depth=1,
                                       queue_timeout_s=60.0)
    try:
        gate, started = threading.Event(), threading.Event()
        blocker = sched.submit(_gated_query(pkg, gate, started),
                               session="s")
        assert started.wait(20)
        q = lambda: pkg.from_pydict({"a": [1]}).select(  # noqa: E731
            pkg.col("a"))
        q1 = sched.submit(q(), session="s")
        q2 = sched.submit(q(), session="s")
        with pytest.raises(pkg.serving.AdmissionRejected) as ei:
            q2.result(5)
        gate.set()
        blocker.result(60)
        q1.result(60)
        return ei.value.kind, _counted(sched.counters_snapshot())
    finally:
        sched.shutdown()


def test_queue_full_rejection():
    kind, snap = _queue_full(dt)
    assert kind == "queue_full" and snap["rejected_queue_full"] == 1
    assert (kind, snap) == _queue_full(daft_tpu)


def _memory_rejection(pkg):
    sched = pkg.serving.QueryScheduler(concurrency=1, memory_budget=1 << 20)
    try:
        h = sched.submit(pkg.from_pydict({"a": [1]}).select(pkg.col("a")),
                         est_bytes=10 << 20)
        with pytest.raises(pkg.serving.AdmissionRejected) as ei:
            h.result(30)
        assert sched.admission.outstanding == 0
        e = ei.value
        return ((e.kind, e.est_bytes, e.budget),
                _counted(sched.counters_snapshot()))
    finally:
        sched.shutdown()


def test_memory_rejection_is_structured():
    got = _memory_rejection(dt)
    assert got[0] == ("memory", 10 << 20, 1 << 20)
    assert got == _memory_rejection(daft_tpu)


def test_memory_manager_try_acquire_deadline_and_cancel():
    m = MemoryManager(budget=100)
    m.acquire(80)
    t0 = time.monotonic()
    assert m.try_acquire(50, deadline=time.monotonic() + 0.3) is False
    assert time.monotonic() - t0 < 5
    tok = CancelToken()
    tok.set()
    assert m.try_acquire(50, cancel=tok) is False
    m.release(80)
    assert m.try_acquire(50, deadline=time.monotonic() + 0.3) is True
    assert m.outstanding == 50
    m.release(50)
    assert m.outstanding == 0


def test_cancel_scope_threads_token_into_executor():
    from daft_tpu_torch.execution.pipeline import PushExecutor
    tok = CancelToken()
    with cancel_scope(tok):
        assert current_token() is tok
        assert PushExecutor().cancel_token is tok
    assert current_token() is None


# ---------------------------------------------------------------- caches

def _cache_invalidation(pkg, root):
    glob = _write(root, pa.table({"g": [1, 1, 2], "v": [1.0, 2.0, 3.0]}))
    sched = pkg.serving.QueryScheduler(concurrency=1)
    try:
        hs = [sched.submit(_agg_query(glob, pkg))]
        outs = [_answer(hs[0])]
        hs.append(sched.submit(_agg_query(glob, pkg)))
        outs.append(_answer(hs[1]))
        # rewrite the source (content AND stat change): both caches bust
        time.sleep(0.02)  # a distinct mtime_ns even on a coarse fs
        _write(root, pa.table({"g": [1, 1, 2], "v": [10.0, 20.0, 30.0]}))
        hs.append(sched.submit(_agg_query(glob, pkg)))
        outs.append(_answer(hs[2]))
        return (outs, [h.stats.serving["result_cache"] for h in hs],
                _counted(sched.counters_snapshot()))
    finally:
        sched.shutdown()


def test_result_cache_hit_and_source_invalidation(tmp_path):
    outs, states, snap = _cache_invalidation(dt, str(tmp_path / "p"))
    assert states == ["miss", "hit", "miss"]
    assert outs[0] == outs[1]
    assert outs[2]["s"] == [30.0, 30.0]
    r_outs, r_states, r_snap = _cache_invalidation(daft_tpu,
                                                   str(tmp_path / "r"))
    for a, b in zip(outs, r_outs):
        _same(a, b)
    assert (states, snap) == (r_states, r_snap)


def _plan_cache_only(pkg, glob):
    sched = pkg.serving.QueryScheduler(concurrency=1, result_cache_bytes=0)
    try:
        h1 = sched.submit(_agg_query(glob, pkg))
        a1 = _answer(h1)
        h2 = sched.submit(_agg_query(glob, pkg))
        a2 = _answer(h2)
        return ([a1, a2],
                [(h.stats.serving["plan_cache"],
                  h.stats.serving["result_cache"]) for h in (h1, h2)],
                _counted(sched.counters_snapshot()))
    finally:
        sched.shutdown()


def test_plan_cache_hit_when_result_cache_disabled(parquet_table):
    outs, states, snap = _plan_cache_only(dt, parquet_table)
    assert states == [("miss", "bypass"), ("hit", "bypass")]
    assert snap["plan_cache_hits"] >= 1
    r_outs, r_states, r_snap = _plan_cache_only(daft_tpu, parquet_table)
    for a, b in zip(outs, r_outs):
        _same(a, b)
    assert (states, snap) == (r_states, r_snap)


def _config_change(pkg, glob):
    sched = pkg.serving.QueryScheduler(concurrency=1, result_cache_bytes=0)
    try:
        sched.submit(_agg_query(glob, pkg)).result(60)
        with pkg.execution_config_ctx(default_morsel_size=999):
            h = sched.submit(_agg_query(glob, pkg))
            h.result(60)
        return h.stats.serving["plan_cache"], \
            _counted(sched.counters_snapshot())
    finally:
        sched.shutdown()


def test_config_change_busts_plan_cache(parquet_table):
    state, snap = _config_change(dt, parquet_table)
    assert state == "miss"
    assert (state, snap) == _config_change(daft_tpu, parquet_table)


def test_fingerprint_literal_stripping_and_volatility(parquet_table):
    from daft_tpu.logical.fingerprint import fingerprint as r_fingerprint
    cfg = dt.get_context().execution_config
    r_cfg = daft_tpu.get_context().execution_config
    plans = {}
    for pkg in PKGS:
        plans[pkg.__name__] = [
            pkg.read_parquet(parquet_table).where(pkg.col("v") > t)
            ._builder.plan for t in (5, 9, 5)]
    f1, f2, f3 = (fingerprint(p, cfg) for p in plans["daft_tpu_torch"])
    assert f1 is not None and f2 is not None
    assert f1.structure == f2.structure       # literal-stripped shape
    assert f1.params != f2.params             # bound-parameter vector
    assert f1.key != f2.key
    assert f3.key == f1.key                   # identical text, same key
    refs = [r_fingerprint(p, r_cfg) for p in plans["daft_tpu"]]
    assert [f.params for f in (f1, f2, f3)] == [r.params for r in refs]
    assert [f.sources for f in (f1, f2, f3)] == [r.sources for r in refs]
    # in-memory sources are uncacheable (pinning and id-reuse hazards)
    assert fingerprint(mkdf({"a": [1]}).select(col("a"))._builder.plan,
                       cfg) is None

    # UDF callables are uncacheable (repr address reuse)
    @udf(return_dtype=DataType.int64())
    def f(s):
        return s.to_pylist()
    assert fingerprint(
        dt.read_parquet(parquet_table).select(f(col("k")))._builder.plan,
        cfg) is None


def test_lru_byte_budget_evicts():
    from daft_tpu.serving.caches import _LRUCache as RefLRU
    from daft_tpu_torch.serving.caches import _LRUCache
    stats = []
    for cls in (_LRUCache, RefLRU):
        c = cls(100)
        c.put(("a",), 1, 40)
        c.put(("b",), 2, 40)
        c.put(("c",), 3, 40)           # evicts ("a",)
        assert c.get(("a",)) is None
        assert c.get(("b",)) == 2
        assert c.stats()["evictions"] == 1
        c.put(("huge",), 4, 200)       # over budget: not stored
        assert c.get(("huge",)) is None
        stats.append(c.stats())
    assert stats[0] == stats[1]


def test_serving_block_rendered_in_explain(parquet_table):
    sched = QueryScheduler(concurrency=1)
    try:
        h = sched.submit(_agg_query(parquet_table), session="render-s",
                         priority=2)
        h.result(60)
        text = h.stats.render()
        assert "serving (query scheduler):" in text
        assert "session=render-s" in text
        assert "priority=2" in text
        # a result-cache hit still renders a serving block
        h2 = sched.submit(_agg_query(parquet_table), session="render-s")
        h2.result(60)
        assert "result cache: hit" in h2.stats.render()
    finally:
        sched.shutdown()


# ------------------------------------------- concurrent stats isolation

class _Store(http.server.BaseHTTPRequestHandler):
    store = {}

    def log_message(self, *a):
        pass

    def _key(self):
        return urllib.parse.urlparse(self.path).path.lstrip("/")

    def do_HEAD(self):
        data = self.store.get(self._key())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        data = self.store.get(self._key())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        rng = self.headers.get("Range")
        if rng:
            a, b = rng.split("=")[1].split("-")
            start, end = int(a), min(int(b), len(data) - 1)
            chunk = data[start:end + 1]
            self.send_response(206)
        else:
            chunk = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(chunk)))
        self.end_headers()
        self.wfile.write(chunk)


@pytest.fixture
def http_parquet():
    import io as _io
    buf = _io.BytesIO()
    pq.write_table(pa.table({
        "g": pa.array([i % 5 for i in range(4000)]),
        "v": pa.array([float(i) for i in range(4000)]),
    }), buf, row_group_size=500)
    _Store.store = {"ds/p.parquet": buf.getvalue()}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Store)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/ds/p.parquet"
    srv.shutdown()
    srv.server_close()


def test_two_concurrent_queries_have_isolated_io_stats(http_parquet):
    """Per-query io stats come from thread attribution, so a pure
    in-memory query shows ZERO io whatever scans run beside it (the
    store sends no ETag: the scans are uncacheable and all execute)."""
    sched = QueryScheduler(concurrency=4)
    stop = threading.Event()
    scan_handles, mem_handles = [], []
    try:
        def scanner():
            while not stop.is_set() and len(scan_handles) < 6:
                h = sched.submit(
                    dt.read_parquet(http_parquet).groupby("g")
                    .agg(col("v").sum()), session="scan-sess")
                h.result(60)
                scan_handles.append(h)

        t = threading.Thread(target=scanner, daemon=True)
        t.start()
        for _ in range(6):
            h = sched.submit(mkdf({"x": [1, 2, 3, 4]}).agg(col("x").sum()),
                             session="mem-sess")
            h.result(60)
            mem_handles.append(h)
        stop.set()
        t.join(timeout=90)
        assert scan_handles, "the scanner never completed a query"
        assert any(h.stats.io.get("gets", 0) > 0 for h in scan_handles)
        for h in mem_handles:
            assert h.stats.io.get("gets", 0) == 0, h.stats.io
            assert h.stats.io.get("bytes_fetched", 0) == 0
    finally:
        stop.set()
        sched.shutdown()


def test_projection_compile_is_single_flight(monkeypatch):
    """N concurrent cold queries compiling the SAME projection compile it
    once: the losers wait on the winner's event."""
    from daft_tpu_torch.device import compiler
    from daft_tpu_torch.device import runtime as drt
    from daft_tpu_torch.schema import Field, Schema

    calls = []
    call_lock = threading.Lock()

    class _FakeCompiled:
        needs_cols = ()

    def slow_compile(exprs, schema):
        with call_lock:
            calls.append(1)
        time.sleep(0.2)
        return _FakeCompiled()

    monkeypatch.setattr(compiler, "compile_projection", slow_compile)
    schema = Schema([Field("serve_sf_test", DataType.int64())])
    exprs = [(col("serve_sf_test") + 1).alias("out")]
    results = []

    def run():
        results.append(drt._get_compiled(exprs, schema))

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert len(calls) == 1, f"{len(calls)} duplicate compiles"
    assert len(results) == 8
    assert all(r is results[0] for r in results)  # one shared program


def test_live_view_shape(sched):
    view = sched.live_view()
    assert view["concurrency"] == 2
    assert "admitted_bytes" in view and "counters" in view
    assert isinstance(view["sessions"], dict)
    ref = daft_tpu.serving.QueryScheduler(concurrency=2)
    try:
        assert sorted(view) == sorted(ref.live_view())
    finally:
        ref.shutdown()


# ----------------------------------------------- review-hardening fixes

def test_serve_memory_zero_disables_admission(monkeypatch):
    """DAFT_TORCH_SERVE_MEMORY=0 disables admission outright, never
    falling back to the engine memory limit."""
    monkeypatch.setenv("DAFT_TORCH_SERVE_MEMORY", "0")
    monkeypatch.setenv("DAFT_TORCH_MEMORY_LIMIT", "1GiB")
    s = QueryScheduler(concurrency=1)
    try:
        assert s.admission.budget is None
        assert s.admission.try_acquire(1 << 50)  # nothing gates
        assert s.admission.outstanding == 0
    finally:
        s.shutdown()


def test_estimate_runs_outside_scheduler_lock(sched, monkeypatch):
    """The cost-model footprint estimate can do real IO (remote footer
    reads); submit() must not hold the scheduler condition across it."""
    in_estimate, release = threading.Event(), threading.Event()

    def slow_estimate(self, builder):
        in_estimate.set()
        assert release.wait(10), "estimator never released"
        return 1 << 20

    monkeypatch.setattr(QueryScheduler, "_estimate_bytes", slow_estimate)
    hs = []
    t = threading.Thread(
        target=lambda: hs.append(sched.submit(mkdf({"a": [1]}))),
        daemon=True)
    t.start()
    assert in_estimate.wait(10)
    acquired = sched._cond.acquire(timeout=2.0)
    try:
        assert acquired, "submit held the scheduler lock across the " \
            "footprint estimate"
    finally:
        if acquired:
            sched._cond.release()
    release.set()
    t.join(20)
    assert hs and _answer(hs[0], 30) == {"a": [1]}


def test_idle_sessions_are_swept(monkeypatch):
    """Session queues are client-keyed; drained sessions must not
    accumulate forever."""
    from daft_tpu_torch.serving import scheduler as sched_mod
    s = QueryScheduler(concurrency=2)
    try:
        hs = [s.submit(mkdf({"a": [i]}), session=f"uuid-{i}")
              for i in range(6)]
        for h in hs:
            h.result(60)
        monkeypatch.setattr(sched_mod, "_SESSION_IDLE_TTL_S", 0.0)
        with s._cond:
            s._sweep_expired_locked()   # marks the empties idle
        time.sleep(0.01)
        with s._cond:
            s._sweep_expired_locked()   # the TTL elapsed: dropped
            assert s._sessions == {}
        h = s.submit(mkdf({"a": [9]}), session="uuid-0")
        assert _answer(h) == {"a": [9]}
    finally:
        s.shutdown()


def test_unstable_literal_is_uncacheable():
    """Literals key the result cache, so only faithful-repr types may
    fingerprint, canonicalized as the reference does."""
    import datetime
    import decimal

    from daft_tpu.logical.fingerprint import _canon_lit as r_canon
    from daft_tpu_torch.logical.fingerprint import _Uncacheable, _canon_lit

    class Truncates:  # reprs like a numpy array: plausible, lossy
        def __repr__(self):
            return "[0, 1, ..., 1999]"

    assert _canon_lit(7) == "7"
    assert _canon_lit([1, "x", None]) == "[1,'x',None]"
    assert _canon_lit({"b": 2, "a": 1}) == "{'a':1,'b':2}"
    assert "2026" in _canon_lit(datetime.date(2026, 8, 3))
    assert "3.14" in _canon_lit(decimal.Decimal("3.14"))
    for good in (7, 2.5, [1, "x", None], {"b": 2, "a": 1}, b"\x00",
                 datetime.date(2026, 8, 3), decimal.Decimal("3.14"),
                 datetime.datetime(2026, 8, 3, 1, 2, 3)):
        assert _canon_lit(good) == r_canon(good)
    for bad in (Truncates(), [1, Truncates()], {"k": Truncates()},
                object(), lambda: 1):
        with pytest.raises(_Uncacheable):
            _canon_lit(bad)


def test_attributed_device_kernels_isolated():
    """Two attributed contexts each see only their own dispatches, not a
    diff of the shared ledger spanning both."""
    from daft_tpu_torch import observability as obs
    from daft_tpu_torch.device import costmodel

    c1, c2 = obs.RuntimeStatsContext(), obs.RuntimeStatsContext()
    with obs.attributed(c1):
        costmodel.ledger_record("serve_test_argsort", rows=10,
                                nbytes=1e6, seconds=0.01)
    with obs.attributed(c2):
        costmodel.ledger_record("serve_test_join", rows=5,
                                nbytes=2e6, flops=1e6, seconds=0.02)
    c1.finish()
    c2.finish()
    assert set(c1.device_kernels) == {"serve_test_argsort"}
    assert set(c2.device_kernels) == {"serve_test_join"}
    assert c1.device_kernels["serve_test_argsort"]["rows"] == 10
    assert c2.device_kernels["serve_test_join"]["dispatches"] == 1
    assert "mfu_pct" in c2.device_kernels["serve_test_join"]


def test_cancel_unwinds_noncacheable_runner_drain(monkeypatch):
    """A runner other than the native one bypasses the caches and does
    not thread the CancelToken into its workers; the scheduler's drain
    loop checks it per partition, so a cancel releases admission
    mid-query."""
    import daft_tpu_torch.context as ctx_mod
    from daft_tpu_torch.micropartition import MicroPartition

    first_part, proceed = threading.Event(), threading.Event()

    class _FakeRunner:  # not a NativeRunner: the non-cacheable path
        def run_iter(self, builder):
            yield MicroPartition.from_pydict({"a": [1]})
            first_part.set()
            proceed.wait(20)
            yield MicroPartition.from_pydict({"a": [2]})

    monkeypatch.setattr(ctx_mod.get_context(), "get_or_create_runner",
                        lambda: _FakeRunner())
    s = QueryScheduler(concurrency=1, memory_budget=1 << 30)
    try:
        h = s.submit(mkdf({"a": [0]}), est_bytes=1 << 20)
        assert first_part.wait(20)
        h.cancel()
        proceed.set()
        with pytest.raises(QueryCancelled):
            h.result(20)
        assert h.state == "cancelled"
        deadline = time.monotonic() + 10
        while s.admission.outstanding and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.admission.outstanding == 0
    finally:
        s.shutdown()


# ----------------------------------------------------- lifecycle regressions

def test_admission_released_when_prerun_bookkeeping_raises(
        parquet_table, monkeypatch):
    """An exception between a successful try_acquire and the run's
    try-block (here the handle's running transition) must neither leak
    the admitted bytes nor the worker's slot."""
    from daft_tpu_torch.serving import scheduler as sched_mod
    sched = QueryScheduler(concurrency=1, memory_budget=1 << 30,
                           queue_timeout_s=30.0)
    try:
        orig = sched_mod.QueryHandle._mark_running

        def boom(self):
            raise RuntimeError("bookkeeping exploded")

        monkeypatch.setattr(sched_mod.QueryHandle, "_mark_running", boom)
        h = sched.submit(_agg_query(parquet_table))
        with pytest.raises(RuntimeError, match="bookkeeping exploded"):
            h.result(30)
        assert h.state == "failed"
        assert sched.admission.outstanding == 0
        # the worker slot survived: a healthy query still runs on it
        monkeypatch.setattr(sched_mod.QueryHandle, "_mark_running", orig)
        h2 = sched.submit(_agg_query(parquet_table))
        assert _answer(h2, 30) == _agg_query(parquet_table).to_pydict()
        assert sched.admission.outstanding == 0
    finally:
        sched.shutdown()


def test_breaker_drain_polls_cancellation():
    """A pipeline breaker's consume loop (sort sampling, bucket stores)
    drains its whole child before yielding; its in-loop poll ends the
    drain soon after the token fires."""
    from daft_tpu_torch.execution.executor import LocalExecutor
    from daft_tpu_torch.micropartition import MicroPartition

    mp = MicroPartition.from_pydict({"x": [1.0, 2.0, 3.0]})
    seen = {"n": 0}

    def stream(tok):
        for _ in range(100):
            seen["n"] += 1
            if seen["n"] == 3:
                tok.set("client interrupt")
            yield mp

    tok = CancelToken()
    with cancel_scope(tok):
        ex = LocalExecutor()  # captures the scope's token
    with pytest.raises(QueryCancelled):
        ex._consume_sampling(stream(tok), [col("x")])
    assert seen["n"] <= 4, "the drain kept running after the token fired"

    tok2 = CancelToken()
    with cancel_scope(tok2):
        ex2 = LocalExecutor()
    seen["n"] = 0
    with pytest.raises(QueryCancelled):
        ex2._key_bucket_store(stream(tok2), [col("x")], 4)
    assert seen["n"] <= 4


def test_fleet_wiring_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="A8b"):
        QueryScheduler(concurrency=1, fleet_state=object())
    with pytest.raises(NotImplementedError, match="A8b"):
        QueryScheduler(concurrency=1, cache_tier=object())


def test_shared_scheduler_lifecycle():
    assert serving.shared_scheduler_if_running() is None
    s = serving.shared_scheduler()
    try:
        assert serving.shared_scheduler() is s
        assert serving.shared_scheduler_if_running() is s
        assert _answer(s.submit(mkdf({"a": [3]}))) == {"a": [3]}
    finally:
        serving.shutdown_shared()
    assert serving.shared_scheduler_if_running() is None


# ---------------------------------------------------- armed, end to end

_ARMED = r'''
import json, sys
root = sys.argv[1]
import daft_tpu_torch as dt
from daft_tpu_torch.analysis import lock_sanitizer
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.serving import QueryScheduler

def get(t):
    return dt.read_parquet(f"{root}/{t}/*.parquet")

shapes = {"q1": Q.q1, "q3": Q.q3, "suppkey_agg": Q.suppkey_agg}
names = ["q1", "q3", "suppkey_agg"] * 3
names = names[:8]
s = QueryScheduler(concurrency=4, result_cache_bytes=0)
try:
    hs = [(n, s.submit(shapes[n](get), session=f"s{i % 3}"))
          for i, n in enumerate(names)]
    out = [(n, h.result(300).to_recordbatch().to_pydict()) for n, h in hs]
    outstanding = s.admission.outstanding
    counters = s.counters_snapshot()
finally:
    s.shutdown()
print("RESULT " + json.dumps({
    "answers": out, "outstanding": outstanding,
    "failed": counters.get("failed", 0),
    "armed": lock_sanitizer.is_enabled(),
    "lock": lock_sanitizer.summary(),
    "jax": "jax" in sys.modules,
    "reference": any(m == "daft_tpu" or m.startswith("daft_tpu.")
                     for m in sys.modules),
}, default=str))
'''


def _rows(d: dict) -> list:
    cols = sorted(d)
    return sorted(zip(*(d[c] for c in cols)), key=repr)


def test_armed_concurrent_serving_matches_the_unarmed_answers(tmp_path):
    """8 concurrent submissions (Q1, Q3 and the ``l_suppkey`` group-by at
    SF 0.003) through the scheduler in a child process with
    ``DAFT_TORCH_SANITIZE=1``: 0 lock-order cycles, every answer equal to
    the unarmed run's here, nothing admitted left over, and neither
    ``jax`` nor ``daft_tpu`` imported."""
    from benchmarking.tpch.datagen import generate_tpch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    root = str(tmp_path / "tpch")
    generate_tpch(root, scale_factor=0.003, num_parts=3)

    def get(t):
        return dt.read_parquet(f"{root}/{t}/*.parquet")

    # through JSON as the child's answers come (dates become strings)
    unarmed = json.loads(json.dumps(
        {n: Q.QUERIES[n](get).to_pydict()
         for n in ("q1", "q3", "suppkey_agg")}, default=str))
    env = dict(os.environ, DAFT_TORCH_SANITIZE="1", DAFT_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _ARMED, root], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["armed"] is True
    assert res["jax"] is False and res["reference"] is False
    assert res["lock"]["acquisitions"] > 0
    assert res["lock"]["cycles"] == [], res["lock"]
    assert res["outstanding"] == 0 and res["failed"] == 0
    assert len(res["answers"]) == 8
    for name, got in res["answers"]:
        want = unarmed[name]
        assert sorted(got) == sorted(want)
        assert all(all(_close(a, b) for a, b in zip(rg, rw))
                   for rg, rw in zip(_rows(got), _rows(want))), name
