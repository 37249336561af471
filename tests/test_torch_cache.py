"""The port's device column cache (``daft_tpu_torch/device/cache.py``) on
CPU tensors: a second scan hits, a changed file or another pushdown
filter misses, LRU eviction keeps the byte budget, and a scan whose
working set is over the budget is not cached. Answers with and without
the cache are held to pyarrow on the same files (keys and counts exact,
sums at relative 1e-9)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import daft_tpu_torch as dtt
from daft_tpu_torch import col
from daft_tpu_torch.device import cache as dcache
from daft_tpu_torch.device import column as dcol, runtime
from daft_tpu_torch.io import scan
from daft_tpu_torch.recordbatch import RecordBatch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    # the cost model would price these small files onto the host
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    dcache.get_cache().clear()
    runtime.reset_counters()
    # one scan task (one cache entry set) per file: the scan would merge
    # these small files into one task
    with dtt.execution_config_ctx(scan_tasks_min_size_bytes=0):
        yield
    dcache.get_cache().clear()
    runtime.reset_counters()


@pytest.fixture
def pq_dir(tmp_path):
    rng = np.random.default_rng(5)
    for i in range(4):
        n = 1000
        pq.write_table(pa.table({"k": rng.integers(0, 8, n),
                                 "qty": rng.random(n) * 50,
                                 "price": rng.random(n) * 1000}),
                       str(tmp_path / f"part{i}.parquet"))
    return str(tmp_path)


def _query(root, where=None):
    df = dtt.read_parquet(f"{root}/*.parquet")
    if where is not None:
        df = df.where(where)
    return df.groupby("k").agg(col("qty").sum().alias("s"),
                               col("price").count().alias("n")).sort("k")


def _pyarrow(root, qty_below=None):
    t = pq.read_table(root)
    if qty_below is not None:
        t = t.filter(pa.compute.less(t["qty"], qty_below))
    g = t.group_by("k").aggregate([("qty", "sum"), ("price", "count")]) \
        .sort_by("k")
    return {"k": g["k"].to_pylist(), "s": g["qty_sum"].to_pylist(),
            "n": g["price_count"].to_pylist()}


def _assert_answer(got, want):
    assert got["k"] == want["k"] and got["n"] == want["n"]
    for a, b in zip(got["s"], want["s"]):
        assert a == pytest.approx(b, rel=1e-9)


def _run(root, monkeypatch, where=None):
    """The query's answer, its counters and the files it read."""
    read = []
    execute = scan.ScanTask.execute

    def counted(self, *a, **k):
        read.extend(os.path.basename(p) for p in self.paths)
        return execute(self, *a, **k)
    monkeypatch.setattr(scan.ScanTask, "execute", counted)
    runtime.reset_counters()
    try:
        got = _query(root, where).to_pydict()
    finally:
        monkeypatch.setattr(scan.ScanTask, "execute", execute)
    return got, runtime.counters(), sorted(read)


@pytest.mark.parametrize("window", [0, 2])
def test_second_scan_hits_the_cache(pq_dir, monkeypatch, window):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", str(window))
    first, c1, read1 = _run(pq_dir, monkeypatch)
    assert c1["cache_misses"] == c1["cache_puts"] == 4 and len(read1) == 4
    assert dcache.get_cache().stats()["entries"] == 12  # 4 tasks × 3 cols
    second, c2, read2 = _run(pq_dir, monkeypatch)
    assert c2["cache_hits"] == 4 and "cache_misses" not in c2, c2
    assert read2 == [] and c2.get("scan_bytes_up", 0) == 0
    assert first == second
    _assert_answer(second, _pyarrow(pq_dir))


def test_changed_file_misses(pq_dir, monkeypatch):
    _run(pq_dir, monkeypatch)
    path = os.path.join(pq_dir, "part2.parquet")
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    _, c, read = _run(pq_dir, monkeypatch)
    assert c["cache_hits"] == 3 and c["cache_misses"] == 1, c
    assert read == ["part2.parquet"]
    # new contents under the same name are read, not served stale
    pq.write_table(pa.table({"k": np.zeros(10, dtype=np.int64),
                             "qty": np.ones(10), "price": np.ones(10)}),
                   path)
    got, c, read = _run(pq_dir, monkeypatch)
    assert read == ["part2.parquet"]
    _assert_answer(got, _pyarrow(pq_dir))


def test_another_pushdown_filter_misses(pq_dir, monkeypatch):
    _run(pq_dir, monkeypatch)
    got, c, read = _run(pq_dir, monkeypatch, where=col("qty") < 10.0)
    assert c["cache_misses"] == 4 and "cache_hits" not in c, c
    assert len(read) == 4
    _assert_answer(got, _pyarrow(pq_dir, 10.0))
    # the same filter again hits its own entries
    again, c, read = _run(pq_dir, monkeypatch, where=col("qty") < 10.0)
    assert c["cache_hits"] == 4 and read == []
    assert again == got


def _table(n: int) -> dcol.DeviceTable:
    rb = RecordBatch.from_pydict({"a": np.arange(n, dtype=np.int64),
                                  "b": np.arange(n, dtype=np.float64)})
    return dcol.encode_batch(rb, ["a", "b"], CPU)


def test_lru_eviction_under_a_small_budget(monkeypatch):
    # one table: 2 columns × 128 rows × (8 + 1) bytes = 2304 bytes
    monkeypatch.setenv("DAFT_TORCH_DEVICE_CACHE_BYTES", str(2 * 2304))
    c = dcache.DeviceColumnCache()
    c.put_table(("t0",), _table(128))
    c.put_table(("t1",), _table(128))
    assert c.get_table(("t0",), ["a", "b"]) is not None   # t0 now newest
    c.put_table(("t2",), _table(128))
    assert c.stats()["bytes"] <= 2 * 2304
    assert c.get_table(("t1",), ["a", "b"]) is None       # LRU evicted
    hit = c.get_table(("t0",), ["a", "b"])
    assert hit is not None and hit.resident
    assert c.get_table(("t2",), ["a"]) is not None
    s = c.stats()
    assert s["evictions"] == 2 and s["entries"] == 4, s


def test_table_over_the_budget_is_not_cached(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_CACHE_BYTES", "1000")
    c = dcache.DeviceColumnCache()
    dt = _table(128)
    c.put_table(("big",), dt)
    assert c.stats()["entries"] == 0 and c.stats()["refused"] == 1
    assert not dt.resident


def test_working_set_over_the_budget_is_not_cached(pq_dir, monkeypatch):
    """One task's columns fit, all four do not: nothing is cached (a
    slice of the scan would only evict what other queries repay)."""
    one = dcol.encoded_nbytes(
        RecordBatch.from_arrow_table(
            pq.read_table(os.path.join(pq_dir, "part0.parquet"))),
        ["k", "qty", "price"])
    monkeypatch.setenv("DAFT_TORCH_DEVICE_CACHE_BYTES", str(2 * one))
    got, c, _ = _run(pq_dir, monkeypatch)
    assert "cache_puts" not in c and c["cache_misses"] == 4, c
    assert dcache.get_cache().stats()["entries"] == 0
    got2, c2, read = _run(pq_dir, monkeypatch)
    assert len(read) == 4 and c2["scan_bytes_up"] > 0
    assert got == got2
    _assert_answer(got, _pyarrow(pq_dir))


def test_fingerprint_covers_the_task_and_the_device(pq_dir):
    from daft_tpu_torch.schema import Schema
    path = os.path.join(pq_dir, "part0.parquet")
    schema = Schema.from_arrow(pq.read_schema(path))
    base = scan.ScanTask([path], schema, scan.Pushdowns(), 1000, 1)
    fp = dcache.task_fingerprint(base, CPU)
    assert fp == dcache.task_fingerprint(
        scan.ScanTask([path], schema, scan.Pushdowns(), 1000, 1), CPU)
    others = [
        scan.ScanTask([path], schema, scan.Pushdowns(limit=5), 1000, 1),
        scan.ScanTask([path], schema, scan.Pushdowns(), 1000, 1,
                      row_groups=[[0]]),
        scan.ScanTask([path], schema,
                      scan.Pushdowns(filters=col("qty") > 1.0), 1000, 1)]
    for t in others:
        assert dcache.task_fingerprint(t, CPU) != fp
    assert dcache.task_fingerprint(base, torch.device("cuda", 0)) != fp
    missing = scan.ScanTask([os.path.join(pq_dir, "gone.parquet")], schema,
                            scan.Pushdowns(), 1, 1)
    assert dcache.task_fingerprint(missing, CPU) is None
