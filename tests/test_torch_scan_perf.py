"""The port's scan data plane against the reference's
(``tests/test_scan_perf.py``): the byte-range read planner, ranged fetches
across object sources, the planned remote parquet read, the
prefetch-pipelined scan source, retries, hive keys, row-group pruning and
remote schema inference.

Each case runs the same inputs through ``daft_tpu`` (JAX on the CPU) and
``daft_tpu_torch`` (``DAFT_TORCH_DEVICE=cpu``) and holds the port to the
reference: the same ranges for the same footer and knobs, the same scan
counter deltas (``gets``, ``ranges_planned``, ``range_requests``,
``bytes_fetched``, ``bytes_used``, ``planned_read_fallbacks``) for the same
remote read, the same answers. The counters of both packages are
process-wide, so every comparison takes deltas.

Left out of the reference's file:
- ``test_prefetch_degrades_under_chaos``: the chaos and fault-plan
  fallback of the scan waits for the port's resilience plane (ROADMAP A7).
- ``test_io_stats_block_in_explain_analyze``: the ``io`` block of
  ``explain(analyze=True)`` waits for the port's ``observability.py``
  (ROADMAP A8).
- The seed test's inequality ``gets(planned) < gets(naive)``: on these
  four small files both paths send the same GETs in both packages, which
  ``test_planned_remote_read_counters_equal_the_reference`` holds instead.
"""

import http.client
import http.server
import os
import threading
import urllib.parse

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.io import read_planner as ref_rp
from daft_tpu_torch.io import read_planner as rp
from daft_tpu_torch.io.object_io import (HTTPConfig, HTTPSource,
                                         LocalSource, retry_backoff_s)

ENGINES = ["push", "interp"]
COUNTERS = ("gets", "ranges_planned", "range_requests", "bytes_fetched",
            "bytes_used", "planned_read_fallbacks")


# --------------------------------------------------------------- fixtures

class _RangeStore(http.server.BaseHTTPRequestHandler):
    """In-memory object store speaking Range/HEAD/404 + scripted failures;
    every request lands in ``log`` so tests count GETs per path (the
    reference test's server)."""

    store = {}
    log = []
    fail_next = []  # status codes consumed one per request

    def log_message(self, *a):
        pass

    def _key(self):
        return urllib.parse.urlparse(self.path).path.lstrip("/")

    def _scripted(self):
        if _RangeStore.fail_next:
            code = _RangeStore.fail_next.pop(0)
            self.send_response(code)
            self.end_headers()
            return True
        return False

    def do_HEAD(self):
        _RangeStore.log.append(("HEAD", self._key()))
        data = self.store.get(self._key())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        _RangeStore.log.append(("GET", self._key()))
        if self._scripted():
            return
        data = self.store.get(self._key())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        rng = self.headers.get("Range")
        if rng:
            spec = rng.split("=")[1]
            a, b = spec.split("-")
            start, end = int(a), min(int(b), len(data) - 1)
            chunk = data[start:end + 1]
            self.send_response(206)
        else:
            chunk = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(chunk)))
        self.end_headers()
        self.wfile.write(chunk)


@pytest.fixture(scope="module")
def store():
    _RangeStore.store = {}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeStore)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")


def _parquet_bytes(table, **kw) -> bytes:
    import io as _io
    buf = _io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


@pytest.fixture
def remote_dataset(store):
    """4 parquet files × 4 row groups × 4 columns on the HTTP store."""
    urls = []
    for i in range(4):
        n = 400
        t = pa.table({
            "seq": pa.array(range(i * n, (i + 1) * n)),
            "v": pa.array([float(j) for j in range(n)]),
            "pad": pa.array([f"pad-{j % 13}" for j in range(n)]),
            "w": pa.array([j * 2 for j in range(n)]),
        })
        key = f"ds/part-{i}.parquet"
        _RangeStore.store[key] = _parquet_bytes(t, row_group_size=100)
        urls.append(f"{store}/{key}")
    return urls


def _both_knobs(monkeypatch, name: str, value: str) -> None:
    """One scan knob set in both packages' spelling."""
    monkeypatch.setenv(f"DAFT_TPU_{name}", value)
    monkeypatch.setenv(f"DAFT_TORCH_{name}", value)


def _ref_cfg(**kv):
    return daft_tpu.context.execution_config_ctx(**kv)


def _one_file_per_task(monkeypatch):
    """The reference's ``max_sources_per_scan_task=1`` for the port, whose
    merge cap is a constant of ``io/scan.py``; returns the reference's
    config field."""
    from daft_tpu_torch.io import scan
    monkeypatch.setattr(scan, "MAX_FILES_PER_TASK", 1)
    return dict(max_sources_per_scan_task=1)


def _run_both(query, ref_only=None, **cfg):
    """``query(pkg)`` through the reference and the port: each answer with
    its scan counter deltas. ``ref_only`` holds config fields only the
    reference has."""
    out = {}
    for name, pkg, planner, ctx, extra in (
            ("ref", daft_tpu, ref_rp, _ref_cfg, ref_only or {}),
            ("port", daft_tpu_torch, rp,
             daft_tpu_torch.execution_config_ctx, {})):
        before = planner.scan_counters_snapshot()
        with ctx(**cfg, **extra):
            got = query(pkg)
        out[name] = (got, planner.scan_counters_delta(before))
    return out


# --------------------------------------------------------- planner: math

@pytest.mark.parametrize("ranges,gap,floor", [
    ([(0, 10), (15, 30), (200, 210), (205, 260)], 10, 0),
    ([(0, 10), (100, 110)], 10, 0),
    ([], 10, 0),
])
def test_coalesce_gap_merges_within_tolerance(ranges, gap, floor):
    got = rp.coalesce_ranges(ranges, gap=gap, floor=floor)
    assert got == ref_rp.coalesce_ranges(ranges, gap=gap, floor=floor)
    if ranges and ranges[0] == (0, 10) and len(ranges) == 4:
        assert got == [(0, 30), (200, 260)]


@pytest.mark.parametrize("ranges,want", [
    ([(0, 10), (50, 60), (100, 110)], [(0, 110)]),
    ([(0, 2000), (3500, 6000)], [(0, 2000), (3500, 6000)]),
    ([(0, 10), (5000, 5010)], [(0, 10), (5000, 5010)]),
])
def test_coalesce_request_floor_batches_small_requests(ranges, want):
    got = rp.coalesce_ranges(ranges, gap=5, floor=1000)
    assert got == want == ref_rp.coalesce_ranges(ranges, gap=5, floor=1000)


def test_coalesce_defaults_follow_the_knobs(monkeypatch):
    ranges = [(0, 10), (3 << 20, (3 << 20) + 10), (40 << 20, 41 << 20)]
    assert rp.coalesce_ranges(ranges) == ref_rp.coalesce_ranges(ranges)
    _both_knobs(monkeypatch, "IO_COALESCE_GAP", "4MiB")
    _both_knobs(monkeypatch, "IO_MIN_REQUEST", "1KiB")
    assert rp.coalesce_gap_bytes() == ref_rp.coalesce_gap_bytes() == 4 << 20
    assert rp.min_request_bytes() == ref_rp.min_request_bytes() == 1024
    assert rp.coalesce_ranges(ranges) == ref_rp.coalesce_ranges(ranges) \
        == [(0, (3 << 20) + 10), (40 << 20, 41 << 20)]


def test_plan_parquet_ranges_projection_and_pruning(tmp_path):
    p = str(tmp_path / "t.parquet")
    t = pa.table({"a": list(range(1000)),
                  "b": [float(i) for i in range(1000)],
                  "c": [f"s{i}" for i in range(1000)]})
    pq.write_table(t, p, row_group_size=250)  # 4 row groups
    md = pq.ParquetFile(p).metadata
    for groups, cols in (([1, 3], ["a"]), (None, ["a", "b"]), ([], ["a"]),
                         ([0], []), (None, None), ([2], ["c", "a"])):
        got = rp.plan_parquet_ranges(md, groups, cols)
        assert got == ref_rp.plan_parquet_ranges(md, groups, cols), \
            (groups, cols)
    assert rp.plan_parquet_ranges(md, [], ["a"]) == []
    assert rp.plan_parquet_ranges(md, [0], []) == []


def test_range_cache_reads_across_segments():
    segs = [((0, 10), bytes(range(10))), ((20, 30), bytes(range(20, 30)))]
    cache = rp.RangeCache(segs)
    assert cache.read(2, 8) == bytes(range(2, 8))
    assert cache.read(20, 30) == bytes(range(20, 30))
    for start, end in ((5, 25), (28, 35)):
        with pytest.raises(KeyError):
            cache.read(start, end)
        assert cache.covers(start, end) is False
    assert cache.covers(0, 10) is True


# ------------------------------------------------- get_ranges: parity

def test_get_ranges_parity_across_sources(tmp_path, store):
    from daft_tpu.io.object_io import HTTPSource as RefHTTPSource
    from daft_tpu_torch.io.object_io import IOStatsContext, S3Config
    from daft_tpu_torch.io.s3 import S3Source

    data = bytes(range(256)) * 40
    ranges = [(0, 100), (5000, 5500), (137, 139), (10000, 10240)]
    expected = [data[s:e] for s, e in ranges]

    lp = tmp_path / "blob.bin"
    lp.write_bytes(data)
    assert LocalSource().get_ranges(str(lp), ranges) == expected

    _RangeStore.store["parity/blob.bin"] = data
    url = f"{store}/parity/blob.bin"
    assert HTTPSource(HTTPConfig()).get_ranges(url, ranges, parallelism=3) \
        == expected == RefHTTPSource().get_ranges(url, ranges,
                                                  parallelism=3)

    s3 = S3Source(S3Config(endpoint_url=store, key_id="k", access_key="s",
                           region_name="us-east-1"))
    _RangeStore.store["bkt/blob.bin"] = data
    assert s3.get_ranges("s3://bkt/blob.bin", ranges,
                         parallelism=4) == expected

    # stats thread through: one record per request
    st = IOStatsContext("t")
    LocalSource().get_ranges(str(lp), ranges, st)
    assert st.num_gets == len(ranges)
    assert st.bytes_read == sum(len(b) for b in expected)


# ------------------------------------- planned remote reads: end-to-end

@pytest.mark.parametrize("planned,prefetch", [("0", "0"), ("1", "2")])
def test_planned_remote_read_counters_equal_the_reference(
        remote_dataset, monkeypatch, planned, prefetch):
    """The same pruned, projected remote read, planned (the default) and
    naive: the port's answer and scan counter deltas equal the
    reference's, and the planned way coalesces its ranges without a
    fallback and prefetches."""
    _both_knobs(monkeypatch, "IO_PLANNED_READS", planned)
    _both_knobs(monkeypatch, "SCAN_PREFETCH", prefetch)
    got = _run_both(lambda pkg: pkg.read_parquet(remote_dataset)
                    .where(pkg.col("seq") < 800).select("seq", "v")
                    .to_pydict(), scan_tasks_min_size_bytes=1)
    (ref, ref_c), (port, port_c) = got["ref"], got["port"]
    assert sorted(port["seq"]) == sorted(ref["seq"]) == list(range(800))
    assert sorted(port["v"]) == sorted(ref["v"])
    assert {k: port_c.get(k, 0) for k in COUNTERS} \
        == {k: ref_c.get(k, 0) for k in COUNTERS}
    assert port_c.get("gets", 0) > 0 and port_c.get("bytes_fetched", 0) > 0
    assert port_c.get("prefetch_tasks", 0) == ref_c.get("prefetch_tasks", 0)
    if planned == "1":
        assert port_c["range_requests"] < port_c["ranges_planned"]
        assert port_c.get("bytes_used", 0) > 0
        assert not port_c.get("planned_read_fallbacks")
        assert port_c["prefetch_tasks"] > 0
    else:
        assert not port_c.get("ranges_planned")
        assert not port_c.get("prefetch_tasks")


def test_planned_read_row_group_pruning_fetches_less(remote_dataset,
                                                     monkeypatch):
    _both_knobs(monkeypatch, "IO_PLANNED_READS", "1")

    def run(pred):
        def q(pkg):
            df = pkg.read_parquet(remote_dataset).select("seq", "v")
            if pred:
                df = df.where(pkg.col("seq") < 100)  # 1 of 16 row groups
            return df.to_pydict()
        return _run_both(q, scan_tasks_min_size_bytes=1)

    full, pruned = run(False), run(True)
    for pkg in ("ref", "port"):
        assert len(full[pkg][0]["seq"]) == 1600
        assert sorted(pruned[pkg][0]["seq"]) == list(range(100))
    f, p = full["port"][1], pruned["port"][1]
    assert p.get("bytes_used", 0) < f.get("bytes_used", 1)
    assert p.get("ranges_planned", 0) < f.get("ranges_planned", 1)
    for a, b in ((full["port"][1], full["ref"][1]),
                 (pruned["port"][1], pruned["ref"][1])):
        assert {k: a.get(k, 0) for k in COUNTERS} \
            == {k: b.get(k, 0) for k in COUNTERS}


# ------------------------------------------------ the local HTTP store

def _store_request(store, method, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1",
                                      int(store.url.rsplit(":", 1)[1]),
                                      timeout=30)
    try:
        conn.request(method, path, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


@pytest.mark.parametrize("header,status,body,content_range", [
    ("bytes=2-5", 206, b"2345", "bytes 2-5/10"),
    ("bytes=4-400", 206, b"456789", "bytes 4-9/10"),
    ("bytes=7-", 206, b"789", "bytes 7-9/10"),
    ("bytes=-3", 206, b"789", "bytes 7-9/10"),
    ("bytes=-30", 206, b"0123456789", "bytes 0-9/10"),
    ("bytes=10-", 416, b"", "bytes */10"),
    ("bytes=-0", 416, b"", "bytes */10"),
    ("bytes=5-2", 416, b"", "bytes */10"),
    ("bytes=0-1,4-5", 416, b"", "bytes */10"),
    ("bytes=a-b", 416, b"", "bytes */10"),
    ("items=0-1", 416, b"", "bytes */10"),
])
def test_file_store_answers_each_range_form(tmp_path, header, status, body,
                                            content_range):
    """The benchmark store answers an open-ended and a suffix range as
    well as ``a-b``, and a range it cannot satisfy with ``416``; then it
    goes on serving."""
    from daft_tpu_torch.benchmarking.http_store import FileStore
    (tmp_path / "f.bin").write_bytes(b"0123456789")
    with FileStore(str(tmp_path)) as store:
        got = _store_request(store, "GET", "/f.bin", {"Range": header})
        assert got[:2] == (status, body)
        assert got[2]["Content-Range"] == content_range
        assert _store_request(store, "GET", "/f.bin")[:2] \
            == (200, b"0123456789")


def test_file_store_serves_from_a_child_process(tmp_path):
    """The store runs in a process of its own, counts what it served
    (reading the counts is not counted) and stops with its ``with``
    block."""
    from daft_tpu_torch.benchmarking.http_store import FileStore
    (tmp_path / "f.bin").write_bytes(b"0123456789")
    with FileStore(str(tmp_path)) as store:
        proc = store._proc
        assert proc.pid != os.getpid() and proc.poll() is None
        status, _, headers = _store_request(store, "HEAD", "/f.bin")
        assert status == 200 and headers["Content-Length"] == "10"
        _store_request(store, "GET", "/f.bin", {"Range": "bytes=-4"})
        assert _store_request(store, "GET", "/missing")[0] == 404
        assert store.counts() == store.counts() \
            == {"gets": 2, "heads": 1, "bytes_sent": 4}
    assert proc.poll() is not None


@pytest.mark.parametrize("cfg", [
    {}, {"scan_tasks_min_size_bytes": 0},
    {"scan_tasks_max_size_bytes": 3_000, "scan_tasks_min_size_bytes": 1}])
def test_remote_scan_plans_the_local_tasks(tmp_path, cfg):
    """A scan of files served over HTTP plans the tasks a scan of the same
    local files plans (merged, one per file, split by row groups); the
    footer consumers (the stats' ndv, the fused agg's ndv gate, the scan
    bytes a host rescan decodes) read the footers cached at planning:
    they send no GET and open no local path."""
    from daft_tpu_torch.benchmarking.http_store import FileStore
    from daft_tpu_torch.execution import executor
    from daft_tpu_torch.io.scan import GlobScanOperator, Pushdowns
    from daft_tpu_torch.logical.stats import _footer_range
    os.makedirs(tmp_path / "t")
    for i in range(5):
        pq.write_table(pa.table({"k": list(range(i * 300, (i + 1) * 300)),
                                 "v": [float(j) for j in range(300)]}),
                       tmp_path / "t" / f"p{i}.parquet", row_group_size=100)
    local_paths = sorted(str(p) for p in (tmp_path / "t").iterdir())
    with FileStore(str(tmp_path)) as store, \
            daft_tpu_torch.execution_config_ctx(**cfg):
        urls = store.urls("t")
        for pd in (Pushdowns(), Pushdowns(
                filters=daft_tpu_torch.col("k") < 450)):
            local = GlobScanOperator(local_paths).to_scan_tasks(pd)
            remote = GlobScanOperator(urls).to_scan_tasks(pd)

            def shape(tasks):
                return [([os.path.basename(p) for p in t.paths],
                         t.row_groups, t.num_rows(), t.size_bytes())
                        for t in tasks]
            assert shape(remote) == shape(local)
            gets = store.counts()["gets"]
            for name in ("k", "v"):
                assert executor._task_column_ndv(remote, name) \
                    == executor._task_column_ndv(local, name)
            assert [executor._task_scan_bytes(t) for t in remote] \
                == [executor._task_scan_bytes(t) for t in local]
            assert [_footer_range(md, "k") for t in remote
                    for _, md, _ in t.files()] \
                == [_footer_range(md, "k") for t in local
                    for _, md, _ in t.files()]
            assert store.counts()["gets"] == gets
        if cfg.get("scan_tasks_max_size_bytes"):
            assert any(t.row_groups for t in remote)


def test_planned_read_refuses_a_server_ignoring_range(store, monkeypatch):
    """A store answering the planned read's range GETs with the whole
    object would corrupt the range cache's offsets: the planned read
    refuses it, the scan counts the fallback and the naive ranged read
    gives the answer."""
    from daft_tpu_torch.io.object_io import get_io_client

    class IgnoresRange(HTTPSource):
        def get_ranges(self, path, ranges, stats=None, parallelism=None):
            return [self.get(path, None, stats) for _ in ranges]

    _RangeStore.store["nr/x.parquet"] = _parquet_bytes(
        pa.table({"x": list(range(300))}), row_group_size=100)
    url = f"{store}/nr/x.parquet"
    src = IgnoresRange(HTTPConfig())
    monkeypatch.setattr(get_io_client(), "source_for", lambda path: src)
    monkeypatch.setenv("DAFT_TORCH_IO_PLANNED_READS", "1")
    before = rp.scan_counters_snapshot()
    out = daft_tpu_torch.read_parquet(url).where(
        daft_tpu_torch.col("x") >= 100).to_pydict()
    assert out["x"] == list(range(100, 300))
    assert rp.scan_counters_delta(before).get(
        "planned_read_fallbacks", 0) == 1


# ------------------------------------------------ prefetch pipeline

@pytest.mark.parametrize("engine", ENGINES)
def test_prefetch_preserves_task_order(tmp_path, monkeypatch, engine):
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
    _both_knobs(monkeypatch, "SCAN_PREFETCH", "3")
    for i in range(6):
        pq.write_table(pa.table({"x": list(range(i * 10, (i + 1) * 10))}),
                       tmp_path / f"p{i}.parquet")
    got = _run_both(lambda pkg: pkg.read_parquet(
        str(tmp_path) + "/*.parquet").to_pydict(),
        ref_only=_one_file_per_task(monkeypatch),
        scan_tasks_min_size_bytes=1)
    # no sort anywhere: order is the glob (task) order
    assert got["port"][0]["x"] == got["ref"][0]["x"] == list(range(60))
    assert got["port"][1].get("prefetch_tasks") == 6


def _stage_threads(before):
    return [t for t in threading.enumerate() if t not in before
            and t.name.split("-")[0] in ("drv", "dsp", "wrk", "col", "red")]


@pytest.mark.parametrize("engine", ENGINES)
def test_prefetch_early_limit_abandons_cleanly(tmp_path, monkeypatch,
                                               engine):
    """A satisfied limit abandons the scan stream mid-task: the window's
    producers must unblock (the dead-stream signal), not wedge the pool,
    and no stage thread is left."""
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
    _both_knobs(monkeypatch, "SCAN_PREFETCH", "3")
    for i in range(6):
        pq.write_table(pa.table({"x": list(range(i * 1000,
                                                 (i + 1) * 1000))}),
                       tmp_path / f"p{i}.parquet")
    cfg = dict(scan_tasks_min_size_bytes=1, default_morsel_size=100)
    ref_only = _one_file_per_task(monkeypatch)

    def q(pkg):
        return pkg.read_parquet(str(tmp_path) + "/*.parquet").limit(150) \
            .to_pydict()
    with _ref_cfg(**cfg, **ref_only):
        want = q(daft_tpu)
    # the port's stage threads only: the reference's own may still unwind
    before = set(threading.enumerate())
    with daft_tpu_torch.execution_config_ctx(**cfg):
        got = q(daft_tpu_torch)
    assert got["x"] == want["x"] == list(range(150))
    assert _stage_threads(before) == []
    # every producer of the scan pool has returned
    from daft_tpu_torch.execution import executor
    pool = executor._scan_pool()
    assert pool.submit(lambda: 1).result(timeout=30) == 1


def _executor(engine):
    from daft_tpu_torch.execution.executor import LocalExecutor
    from daft_tpu_torch.execution.pipeline import PushExecutor
    return PushExecutor() if engine == "push" else LocalExecutor()


@pytest.mark.parametrize("engine", ENGINES)
def test_prefetch_memory_admission(tmp_path, monkeypatch, engine):
    """Prefetched bytes stay under the memory budget: with a budget that
    fits about one task, the window's producers serialize on
    admission."""
    from daft_tpu_torch.execution import memory
    from daft_tpu_torch.io.scan import GlobScanOperator, Pushdowns
    from daft_tpu_torch.physical import plan as pp

    monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", "3")
    for i in range(5):
        pq.write_table(
            pa.table({"x": list(range(2000)),
                      "y": [float(j) for j in range(2000)]}),
            tmp_path / f"p{i}.parquet")

    _one_file_per_task(monkeypatch)
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1):
        op = GlobScanOperator(str(tmp_path) + "/*.parquet", "parquet")
        tasks = op.to_scan_tasks(Pushdowns())
        assert len(tasks) == 5
        sizes = [t.size_bytes() for t in tasks]
        assert all(sizes)
        budget = int(max(sizes) * 1.5)  # roughly one task at a time

        class Tracking(memory.MemoryManager):
            max_held = 0

            def acquire(self, n):
                super().acquire(n)
                with self._cond:
                    Tracking.max_held = max(Tracking.max_held, self._held)

        ex = _executor(engine)
        ex.host_mem = Tracking(budget)
        node = pp.ScanSource(tasks, op.schema())
        out = list(ex.run(node))
        assert sum(len(p) for p in out) == 5 * 2000
        assert 0 < Tracking.max_held <= budget


@pytest.mark.parametrize("engine", ENGINES)
def test_prefetch_admission_no_deadlock(tmp_path, monkeypatch, engine):
    """With a budget admitting only ONE task and multi-file tasks making
    more batches than any queue bound, an out-of-order admission must not
    deadlock the in-order consumer (a later producer holding admission
    while blocked on a bounded queue would starve the head task)."""
    from daft_tpu_torch.execution import memory
    from daft_tpu_torch.io.scan import Pushdowns, ScanTask
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.schema import Schema

    monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", "2")
    paths = []
    for i in range(12):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"x": list(range(i * 50, (i + 1) * 50))}), p)
        paths.append(p)
    schema = Schema.from_arrow(pq.read_schema(paths[0]))
    # two 6-file tasks (>4 batches each), est sized so only one admits
    tasks = [ScanTask(paths[:6], schema, Pushdowns(), size_bytes=800_000),
             ScanTask(paths[6:], schema, Pushdowns(), size_bytes=800_000)]
    ex = _executor(engine)
    ex.host_mem = memory.MemoryManager(1_000_000)
    node = pp.ScanSource(tasks, schema)
    result = {}

    def drain():
        result["rows"] = [x for p in ex.run(node)
                          for x in p.to_pydict()["x"]]

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "prefetch scan deadlocked under admission"
    assert result["rows"] == list(range(600))


@pytest.mark.parametrize("engine", ENGINES)
def test_prefetch_retries_an_io_error_only_before_a_batch(monkeypatch,
                                                          engine):
    """A producer's OSError before its first batch is retried once (the
    rows are re-readable); after a batch it reaches the consumer, since a
    re-stream would duplicate rows (reference ``executor.py:339-349``)."""
    from daft_tpu_torch.io.scan import Pushdowns, ScanTask
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.recordbatch import RecordBatch
    from daft_tpu_torch.schema import Schema
    monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", "2")
    schema = Schema.from_arrow(pa.schema([("x", pa.int64())]))
    calls = {"flaky": 0, "late": 0}

    def flaky():
        calls["flaky"] += 1
        if calls["flaky"] == 1:
            raise OSError("transient")
        yield RecordBatch.from_pydict({"x": [1, 2]})

    def late():
        calls["late"] += 1
        yield RecordBatch.from_pydict({"x": [3]})
        raise OSError("mid-task")

    def run(gen):
        node = pp.ScanSource([ScanTask([], schema, Pushdowns(),
                                       generator=gen)], schema)
        return [x for p in _executor(engine).run(node)
                for x in p.to_pydict()["x"]]
    assert run(flaky) == [1, 2] and calls["flaky"] == 2
    with pytest.raises(OSError, match="mid-task"):
        run(late)
    assert calls["late"] == 1


def test_prefetch_zero_loads_whole_tasks(tmp_path, monkeypatch):
    """``DAFT_TORCH_SCAN_PREFETCH=0`` takes the whole-task path: the same
    answer, no prefetched task."""
    for i in range(3):
        pq.write_table(pa.table({"x": list(range(i * 10, (i + 1) * 10))}),
                       tmp_path / f"p{i}.parquet")
    outs = []
    for pf in ("0", "2"):
        monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", pf)
        before = rp.scan_counters_snapshot()
        with daft_tpu_torch.execution_config_ctx(
                scan_tasks_min_size_bytes=1):
            outs.append(daft_tpu_torch.read_parquet(
                str(tmp_path)).to_pydict())
        assert rp.scan_counters_delta(before).get("prefetch_tasks", 0) \
            == (0 if pf == "0" else 3)
        assert rp.scan_sequential_fallback() is (pf == "0")
    assert outs[0] == outs[1] == {"x": list(range(30))}


# ------------------------------------------------------ retry satellite

def test_http_4xx_not_retried_5xx_retried(store):
    src = HTTPSource(HTTPConfig(num_tries=4))
    _RangeStore.store["r/x.bin"] = b"payload"

    _RangeStore.log = []
    with pytest.raises(Exception):
        src.get(f"{store}/r/missing.bin")
    # 404 is deterministic: exactly ONE request, not num_tries
    assert len([e for e in _RangeStore.log
                if e[1] == "r/missing.bin"]) == 1

    _RangeStore.fail_next = [500, 503]
    _RangeStore.log = []
    assert src.get(f"{store}/r/x.bin") == b"payload"  # 2 failures + 1 ok
    assert len(_RangeStore.log) == 3


def test_retry_backoff_deterministic_and_bounded():
    from daft_tpu.io.object_io import retry_backoff_s as ref_backoff
    a = [retry_backoff_s("s3://b/k", i) for i in range(6)]
    assert a == [retry_backoff_s("s3://b/k", i) for i in range(6)]
    assert a == [ref_backoff("s3://b/k", i) for i in range(6)]
    assert all(0 < x <= 2.0 for x in a)  # hard cap, jitter included
    assert retry_backoff_s("other", 0) != a[0]  # keyed jitter
    assert retry_backoff_s("k", 3, base=0.5, cap=9.0) \
        == ref_backoff("k", 3, base=0.5, cap=9.0)


# ------------------------------------------------------- hive satellite

def test_hive_union_across_mixed_key_paths(tmp_path):
    (tmp_path / "g=a").mkdir()
    (tmp_path / "g=b" / "h=1").mkdir(parents=True)
    pq.write_table(pa.table({"v": [1, 2]}), tmp_path / "g=a" / "x.parquet")
    pq.write_table(pa.table({"v": [3]}),
                   tmp_path / "g=b" / "h=1" / "y.parquet")
    got = _run_both(lambda pkg: (lambda df: (
        df.schema().column_names, df.sort("v").to_pydict()))(
        pkg.read_parquet(str(tmp_path) + "/**/*.parquet",
                         hive_partitioning=True)))
    (names, out), _ = got["port"]
    assert (names, out) == got["ref"][0]
    assert set(names) == {"v", "g", "h"}
    assert out["v"] == [1, 2, 3]
    assert out["g"] == ["a", "a", "b"]
    # missing key → null fill on the path without h=
    assert out["h"] == [None, None, "1"]


# ---------------------------------------------------- pruning satellite

def test_prune_null_count_and_is_in(tmp_path):
    from daft_tpu.io.readers import _prune_row_groups as ref_prune
    from daft_tpu.schema import Schema as RefSchema
    from daft_tpu_torch.io.readers import _prune_row_groups
    from daft_tpu_torch.schema import Schema

    p = str(tmp_path / "t.parquet")
    t = pa.table({
        # g0: 0..99 no nulls; g1: all nulls; g2: 200..299 some nulls
        "a": pa.array(list(range(100)) + [None] * 100
                      + list(range(200, 290)) + [None] * 10),
    })
    pq.write_table(t, p, row_group_size=100)
    md = pq.ParquetFile(p).metadata
    schema = Schema.from_arrow(pq.read_schema(p))
    ref_schema = RefSchema.from_arrow(pq.read_schema(p))

    cases = [
        (lambda c: c("a").is_null(), [1, 2]),
        (lambda c: c("a").not_null(), [0, 2]),
        (lambda c: c("a").is_in([250, 270]), [1, 2]),
        (lambda c: c("a").is_in([50]), [0, 1]),
        (lambda c: c("a").is_in([250]) & (c("a") > 240), [1, 2]),
    ]
    for make, want in cases:
        got = _prune_row_groups(md, make(daft_tpu_torch.col), schema)
        assert got == want == ref_prune(md, make(daft_tpu.col), ref_schema)
    # end-to-end answers agree with the pruned plan
    for make in (lambda c: c("a").is_in([50, 250]),
                 lambda c: c("a").is_null()):
        got = _run_both(lambda pkg: sorted(
            pkg.read_parquet(p).where(make(pkg.col)).to_pydict()["a"],
            key=lambda x: (x is None, x)))
        assert got["port"][0] == got["ref"][0]
    assert len(got["port"][0]) == 110


# -------------------------------------------------- inference satellite

def test_remote_csv_schema_from_head_range(store, monkeypatch):
    body = ("x,y\n" + "\n".join(f"{i},{i * 0.5}" for i in range(20000))) \
        .encode()
    _RangeStore.store["csv/big.csv"] = body
    _both_knobs(monkeypatch, "IO_INFER_BYTES", "4096")
    url = f"{store}/csv/big.csv"
    got = _run_both(lambda pkg: pkg.read_csv(url).schema().column_names)
    assert got["port"][0] == got["ref"][0] == ["x", "y"]
    # inference fetched a bounded head, not the whole object
    fetched = got["port"][1].get("bytes_fetched", 0)
    assert 0 < fetched < len(body)
    assert fetched == got["ref"][1].get("bytes_fetched", 0)
    got = _run_both(lambda pkg: pkg.read_csv(url).to_pydict())
    assert got["port"][0] == got["ref"][0]
    assert len(got["port"][0]["x"]) == 20000
    assert got["port"][0]["x"][:3] == [0, 1, 2]


def test_remote_json_head_inference_falls_back_whole(store, monkeypatch):
    # ONE record larger than the head budget: the truncated head can't
    # parse → whole-object fallback still infers correctly
    rec = '{"a": 1, "blob": "%s"}\n' % ("z" * 9000)
    _RangeStore.store["js/one.json"] = rec.encode()
    _both_knobs(monkeypatch, "IO_INFER_BYTES", "1024")
    url = f"{store}/js/one.json"
    got = _run_both(lambda pkg: (lambda df: (
        set(df.schema().column_names), df.to_pydict()["a"]))(
        pkg.read_json(url)))
    assert got["port"][0] == got["ref"][0] == ({"a", "blob"}, [1])
    assert {k: got["port"][1].get(k, 0) for k in COUNTERS} \
        == {k: got["ref"][1].get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("chunk,piece", [(7_000, 4_096), (4_096, 7_000),
                                         (50_000, 1)])
def test_chunked_stream_reader_exact_bytes(tmp_path, chunk, piece):
    data = os.urandom(50_000)
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    r = rp.ChunkedObjectReader(LocalSource(), str(p), chunk=chunk)
    got = b""
    while True:
        b = r.read(piece if piece > 1 else 1 << 20)
        if not b:
            break
        got += b
    assert got == data


def test_knobs_map_onto_the_execution_config(monkeypatch):
    """Each ``DAFT_TORCH_IO_*`` / ``DAFT_TORCH_SCAN_PREFETCH`` knob wins
    over its ``ExecutionConfig`` field, whose default is the
    reference's."""
    cases = [("IO_COALESCE_GAP", "io_coalesce_gap", rp.coalesce_gap_bytes,
              ref_rp.coalesce_gap_bytes, "2MiB", 2 << 20),
             ("IO_MIN_REQUEST", "io_min_request", rp.min_request_bytes,
              ref_rp.min_request_bytes, "64KiB", 64 << 10),
             ("IO_RANGE_PARALLELISM", "io_range_parallelism",
              rp.range_parallelism, ref_rp.range_parallelism, "3", 3),
             ("IO_PLANNED_READS", "io_planned_reads",
              rp.planned_reads_enabled, ref_rp.planned_reads_enabled, "0",
              False),
             ("SCAN_PREFETCH", "scan_prefetch", rp.scan_prefetch_tasks,
              ref_rp.scan_prefetch_tasks, "5", 5),
             ("IO_STREAM_CHUNK", "io_stream_chunk", rp.stream_chunk_bytes,
              ref_rp.stream_chunk_bytes, "1MiB", 1 << 20),
             ("IO_INFER_BYTES", "io_infer_bytes", rp.infer_head_bytes,
              ref_rp.infer_head_bytes, "0", 0)]
    for knob, field, port_fn, ref_fn, value, want in cases:
        monkeypatch.delenv(f"DAFT_TORCH_{knob}", raising=False)
        monkeypatch.delenv(f"DAFT_TPU_{knob}", raising=False)
        assert port_fn() == ref_fn(), knob
        with daft_tpu_torch.execution_config_ctx(**{field: want}):
            assert port_fn() == want, knob
        _both_knobs(monkeypatch, knob, value)
        assert port_fn() == ref_fn() == want, knob
