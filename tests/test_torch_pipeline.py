"""The port's async device pipeline (``daft_tpu_torch/device/pipeline.py``)
against its synchronous path and against ``daft_tpu``.

The cases of ``tests/test_device_pipeline.py`` that need no chaos
serialization, fault plan or MFU ledger, on CPU tensors: pipelined equals
synchronous (in-memory morsels and scan windows, an overflow
re-dispatch), slot hygiene (an exception mid-window, a closed consumer, a
failed submit, host-routed items, the engine's acquires and releases),
the residency registry (reuse, masked validity, window 0, byte budget)
and ``_masked_validity`` against the reference's. Then TPC-H Q1,
``l_suppkey`` and Q6 over several files per table through the port's
pipelined, synchronous and cached paths against ``daft_tpu`` on JAX-CPU:
keys and counts exact, float sums and means at relative 1e-9 (stddev at
1e-6: the one-pass sum-of-squares formula, as in the reference). An
injected kernel error fails the query on every path.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import daft_tpu_torch as dtt
from daft_tpu_torch import col
from daft_tpu_torch.device import cache as dcache
from daft_tpu_torch.device import column as dcol
from daft_tpu_torch.device import fragment, pipeline as dpipe, runtime
from daft_tpu_torch.execution.memory import MemoryManager
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.series import Series

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    # the fused fragment priced in for these small files
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    dpipe.reset_residency()
    dcache.get_cache().clear()
    runtime.reset_counters()
    # one scan task (one window slot) per file: the scan would merge these
    # small files into one task
    with dtt.execution_config_ctx(scan_tasks_min_size_bytes=0):
        yield
    dpipe.reset_residency()
    dcache.get_cache().clear()
    runtime.reset_counters()


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    """A six-file parquet table: the scan-task path runs several
    windows."""
    root = tmp_path_factory.mktemp("torch_devpipe_pq")
    rng = np.random.default_rng(7)
    for i in range(6):
        n = 800
        pq.write_table(pa.table({"flag": rng.integers(0, 4, n),
                                 "qty": rng.random(n) * 50,
                                 "price": rng.random(n) * 1000}),
                       str(root / f"part{i}.parquet"))
    return str(root)


def _q1_scan(root):
    return (dtt.read_parquet(f"{root}/*.parquet").groupby("flag")
            .agg(col("qty").sum().alias("sum_qty"),
                 col("price").mean().alias("avg_price"),
                 col("qty").count().alias("cnt"))
            .sort(col("flag")))


def _frames(data: dict, parts: int):
    """An in-memory frame of ``parts`` partitions (a non-scan child: the
    pipelined morsel path)."""
    from daft_tpu_torch.dataframe import DataFrame
    from daft_tpu_torch.logical.builder import LogicalPlanBuilder
    from daft_tpu_torch.micropartition import MicroPartition
    n = len(next(iter(data.values())))
    step = -(-n // parts)
    mps = [MicroPartition.from_pydict({k: v[s:s + step]
                                       for k, v in data.items()})
           for s in range(0, n, step)]
    return DataFrame(LogicalPlanBuilder.from_in_memory(mps, mps[0].schema))


def _q1_shape(n=4000, ndv=4, parts=4):
    rng = np.random.default_rng(7)
    return (_frames({"flag": rng.integers(0, ndv, n),
                     "qty": rng.random(n) * 50,
                     "price": rng.random(n) * 1000}, parts)
            .groupby("flag")
            .agg(col("qty").sum().alias("sum_qty"),
                 col("price").mean().alias("avg_price"),
                 col("qty").count().alias("cnt"))
            .sort(col("flag")))


def _q6_shape(n=4000, parts=4):
    rng = np.random.default_rng(11)
    return (_frames({"qty": rng.random(n) * 50,
                     "disc": rng.random(n) * 0.1,
                     "price": rng.random(n) * 1000}, parts)
            .where(col("qty") < 24)
            .agg((col("price") * col("disc")).sum().alias("revenue")))


def _q3_shape(n=2000, parts=3):
    rng = np.random.default_rng(13)
    orders = dtt.from_pydict({"okey": np.arange(n),
                              "cust": rng.integers(0, 50, n)})
    items = _frames({"okey": rng.integers(0, n, 3 * n),
                     "rev": rng.random(3 * n) * 100}, parts)
    return (items.join(orders, on="okey")
            .groupby("cust").agg(col("rev").sum().alias("rev"))
            .sort(col("rev"), desc=True).limit(10))


def _with_window(monkeypatch, w: int, make):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", str(w))
    return make().to_pydict()


@pytest.mark.parametrize("shape", [_q1_shape, _q6_shape, _q3_shape])
def test_pipelined_matches_synchronous(monkeypatch, shape):
    piped = _with_window(monkeypatch, 2, shape)
    c = runtime.counters()
    sync = _with_window(monkeypatch, 0, shape)
    assert piped == sync
    if shape is not _q3_shape:   # a join under the agg: no fused fragment
        assert c.get("pipeline_slots", 0) >= 1, c


def test_pipelined_scan_windows_match_synchronous(monkeypatch, pq_dir):
    piped = _with_window(monkeypatch, 2, lambda: _q1_scan(pq_dir))
    c = runtime.counters()
    # 6 tasks, window 2: windows of ceil(6 / 3) = 2 tasks, so 3 slots
    assert c["pipeline_slots"] == 3 and c.get("dense", 0) \
        + c.get("hash", 0) + c.get("sort", 0) == 6, c
    dcache.get_cache().clear()
    sync = _with_window(monkeypatch, 0, lambda: _q1_scan(pq_dir))
    assert piped == sync


def test_pipelined_parity_on_forced_overflow_redispatch(monkeypatch):
    """1500 groups overflow the first 128-group bucket: the ladder climbs
    in the drain, and the answer equals the synchronous path's and the
    host tier's."""
    def shape():
        return _q1_shape(n=6000, ndv=1500)
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    host = shape().to_pydict()
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    piped = _with_window(monkeypatch, 2, shape)
    assert runtime.counters().get("sort", 0) + \
        runtime.counters().get("hash", 0) > 4   # a re-dispatch happened
    sync = _with_window(monkeypatch, 0, shape)
    assert piped == sync
    assert piped["flag"] == host["flag"] and piped["cnt"] == host["cnt"]
    for a, b in zip(piped["sum_qty"], host["sum_qty"]):
        assert a == pytest.approx(b, rel=1e-9)


def test_window_overflows_climb_together_with_one_copy_each_step(
        monkeypatch, tmp_path):
    """Three tables of one window all overflow: the drain waits on ONE
    copy for the window, then climbs all three with one more copy."""
    rng = np.random.default_rng(3)
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 1000, 3000),
                                 "v": rng.random(3000)}),
                       str(tmp_path / f"p{i}.parquet"))
    calls = []
    real = fragment._fetch_all

    def counting(items):
        calls.append(len(items))
        return real(items)
    monkeypatch.setattr(fragment, "_fetch_all", counting)
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "0")
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", "sort")
    got = dtt.read_parquet(f"{tmp_path}/*.parquet").groupby("k") \
        .agg(col("v").sum().alias("s")).sort("k").to_pydict()
    assert calls == [3, 3], calls   # the window's copy, one climb
    assert runtime.counters()["sort"] == 6
    t = pq.read_table(str(tmp_path)).group_by("k").aggregate(
        [("v", "sum")]).sort_by("k")
    assert got["k"] == t["k"].to_pylist()
    for a, b in zip(got["s"], t["v_sum"].to_pylist()):
        assert a == pytest.approx(b, rel=1e-9)


# ------------------------------------------------ slot admission hygiene

def test_exception_mid_window_releases_every_slot():
    mem = MemoryManager(budget=1 << 30)

    def submit(item, seq, gate):
        slot = dpipe.acquire_slot(gate, seq, mem, 1000)
        return dpipe.InflightItem(slot, item)

    def drain(ret, seq):
        if seq == 2:
            raise RuntimeError("boom mid-window")
        return ret.token

    with pytest.raises(RuntimeError, match="boom"):
        list(dpipe.run_pipelined(range(8), submit, drain, window=3))
    assert mem.outstanding == 0
    c = dpipe.counters_snapshot()
    assert c["slots_acquired"] == c["slots_released"]


def test_cancellation_unwinds_partially_drained_window():
    mem = MemoryManager(budget=1 << 30)

    def submit(item, seq, gate):
        slot = dpipe.acquire_slot(gate, seq, mem, 500)
        return dpipe.InflightItem(slot, item)

    gen = dpipe.run_pipelined(range(16), submit, lambda r, s: r.token,
                              window=2)
    assert next(gen) == 0
    assert next(gen) == 1
    gen.close()
    assert mem.outstanding == 0
    c = dpipe.counters_snapshot()
    assert c["slots_acquired"] == c["slots_released"]


def test_submit_failure_releases_slot_and_propagates():
    mem = MemoryManager(budget=1 << 30)

    def submit(item, seq, gate):
        slot = dpipe.acquire_slot(gate, seq, mem, 100)
        try:
            if seq == 1:
                raise ValueError("encode failed")
        except BaseException:
            dpipe.release_slot(slot)
            raise
        return dpipe.InflightItem(slot, item)

    with pytest.raises(ValueError, match="encode failed"):
        list(dpipe.run_pipelined(range(4), submit,
                                 drain=lambda r, s: r.token, window=2))
    assert mem.outstanding == 0


def test_host_routed_items_bypass_the_window():
    seen = []
    out = list(dpipe.run_pipelined(
        range(20), lambda item, seq, gate: item * 10,
        drain=lambda r, s: seen.append(s) or r, window=2))
    assert out == [i * 10 for i in range(20)]
    assert seen == list(range(20))
    assert "slots_acquired" not in dpipe.counters_snapshot()


def test_window_bounds_the_slots_in_flight():
    """At most ``window`` slots, plus the head of line, which is always
    admitted (pool workers may take later slots first)."""
    def submit(item, seq, gate):
        return dpipe.InflightItem(dpipe.acquire_slot(gate, seq), item)

    assert list(dpipe.run_pipelined(range(12), submit,
                                    lambda r, s: r.token, window=2)) \
        == list(range(12))
    assert 1 <= dpipe.counters_snapshot()["peak_inflight"] <= 3


def test_memory_manager_admission():
    import time
    mem = MemoryManager(budget=100)
    mem.acquire(60)
    t0 = time.monotonic()
    assert not mem.try_acquire(60, deadline=t0 + 0.05)
    assert mem.outstanding == 60
    mem.release(60)
    assert mem.try_acquire(60) and mem.outstanding == 60
    mem.release(60)
    # one request over the whole budget is admitted when nothing is held
    assert mem.try_acquire(500, deadline=time.monotonic() + 0.05)
    mem.release(500)
    gate = dpipe.WindowGate(2)
    mem.acquire(100)
    gate.abort()
    assert not mem.try_acquire(10, cancel=gate)
    unbounded = MemoryManager()
    assert unbounded.try_acquire(1 << 60) and unbounded.outstanding == 0


def test_admission_timeout_lets_the_slot_proceed_unadmitted(monkeypatch):
    monkeypatch.setattr(dpipe, "_ADMIT_DEADLINE_S", 0.05)
    mem = MemoryManager(budget=100)
    mem.acquire(100)
    gate = dpipe.WindowGate(2)
    slot = dpipe.acquire_slot(gate, 0, mem, 50)
    assert slot.nbytes == 0
    assert dpipe.counters_snapshot()["admission_timeouts"] == 1
    dpipe.release_slot(slot)
    dpipe.release_slot(slot)   # idempotent
    assert mem.outstanding == 100
    c = dpipe.counters_snapshot()
    assert c["slots_acquired"] == c["slots_released"] == 1
    gate.abort()
    with pytest.raises(dpipe.PipelineAborted):
        dpipe.acquire_slot(gate, 1, mem, 50)


def test_engine_slot_acquire_release_balanced(monkeypatch, pq_dir):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "2")
    acquired = []
    real = dpipe.acquire_slot

    def tracking(*a, **k):
        slot = real(*a, **k)
        acquired.append(slot)
        return slot
    monkeypatch.setattr(dpipe, "acquire_slot", tracking)
    _q1_scan(pq_dir).to_pydict()
    _q1_shape().to_pydict()
    assert acquired, "the pipelined device path never engaged"
    assert all(s.released for s in acquired)
    c = runtime.counters()
    assert c["pipeline_slots_acquired"] == c["pipeline_slots_released"] \
        == len(acquired)


def test_config_field_applies_when_env_unset(monkeypatch):
    monkeypatch.delenv("DAFT_TORCH_DEVICE_INFLIGHT", raising=False)
    assert dpipe.inflight_window() == 2
    with dtt.execution_config_ctx(device_inflight=7):
        assert dpipe.inflight_window() == 7
        monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "3")
        assert dpipe.inflight_window() == 3


# ------------------------------------------------ no fallback on errors

@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("source", ["scan", "morsels"])
def test_injected_kernel_error_fails_the_query(monkeypatch, pq_dir, window,
                                               source):
    """A device error propagates: no path turns it into a host result."""
    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")
    monkeypatch.setattr(fragment.FusedAggProgram, "run_planes", boom)
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", str(window))
    q = _q1_scan(pq_dir) if source == "scan" else _q1_shape()
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        q.to_pydict()
    assert runtime.counters().get("host_morsels", 0) == 0
    c = dpipe.counters_snapshot()
    assert c.get("slots_acquired", 0) == c.get("slots_released", 0)


# ------------------------------------------- device-resident hand-off

def _decode(named, count):
    return RecordBatch.from_series(dcol.decode_fetched(
        named, dcol.fetch_columns(named, count), count))


def _decoded(batch, names):
    dt = dcol.encode_batch(batch, names, CPU)
    return _decode([(n, dt.columns[n]) for n in names], len(batch)), dt


def test_residency_reuse_skips_reencode(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "2")
    batch = RecordBatch.from_pydict({
        "a": np.arange(128, dtype=np.int64),
        "b": np.arange(128, dtype=np.float64)})
    decoded, dt = _decoded(batch, ["a", "b"])
    assert dpipe.residency_counters()["entries"] == 2
    runtime.reset_counters()
    dt2 = dcol.encode_batch(decoded, ["a", "b"], CPU)
    assert dpipe.residency_counters()["hits"] >= 2
    assert runtime.counters().get("bytes_up", 0) == 0
    assert dt2.resident
    assert dt2.columns["a"].data is dt.columns["a"].data
    again = _decode([(n, dt2.columns[n]) for n in ("a", "b")], 128)
    assert again.to_pydict() == decoded.to_pydict()
    # a projection on the device re-enters through the registry too
    out = dcol.encode_series(decoded.get_column("a"), 128, CPU)
    assert out.data is dt.columns["a"].data


def test_residency_masks_garbage_validity_beyond_live_rows(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "2")
    s = Series.from_numpy(np.arange(5, dtype=np.int64), "x")
    data = torch.arange(16, dtype=torch.int64)
    validity = torch.ones(16, dtype=torch.bool)   # garbage-true tail
    dpipe.note_decoded(s, data, validity, None, count=5, capacity=16)
    hit = dpipe.resident_planes(s, 5)
    assert hit is not None
    _, masked, _, cap = hit
    assert cap == 16
    host = masked.numpy()
    assert host[:5].all() and not host[5:].any()
    # an encode through the registry sees the same masked validity
    dt = dcol.encode_batch(RecordBatch.from_series([s]), ["x"], CPU)
    assert dt.resident and dt.columns["x"].validity.sum() == 5
    assert int(dt.row_mask.sum()) == 5


def test_residency_skipped_when_pipeline_disabled(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "0")
    batch = RecordBatch.from_pydict({"a": np.arange(32, dtype=np.int64)})
    _decoded(batch, ["a"])
    assert dpipe.residency_counters()["entries"] == 0


def test_residency_registry_is_byte_bounded(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "2")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_CACHE_BYTES", "8192")  # 1 KiB
    kept = []
    for i in range(8):
        s = Series.from_numpy(np.arange(16, dtype=np.int64), f"c{i}")
        kept.append(s)
        dpipe.note_decoded(s, torch.arange(16, dtype=torch.int64),
                           torch.ones(16, dtype=torch.bool), None, 16, 16)
    c = dpipe.residency_counters()
    assert c["bytes"] <= 1024
    assert c["evictions"] > 0
    # a dropped Series leaves the registry
    before = dpipe.residency_counters()["entries"]
    del kept[-1], s
    assert dpipe.residency_counters()["entries"] == before - 1


def test_residency_refuses_slices_and_broadcasts(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", "2")
    s = Series.from_numpy(np.arange(8, dtype=np.int64), "x")
    dpipe.note_decoded(s, torch.zeros(1, dtype=torch.int64).expand(16),
                       torch.ones(16, dtype=torch.bool), None, 8, 16)
    dpipe.note_decoded(s, torch.arange(32)[::2],
                       torch.ones(16, dtype=torch.bool), None, 8, 16)
    assert dpipe.residency_counters()["entries"] == 0


@pytest.mark.parametrize("cap,n", [(16, 0), (16, 5), (16, 16), (1024, 777)])
def test_masked_validity_matches_the_reference(cap, n):
    import jax.numpy as jnp
    from daft_tpu.device import pipeline as ref_pipe
    rng = np.random.default_rng(cap + n)
    v = rng.random(cap) < 0.7
    got = dpipe._masked_validity(torch.from_numpy(v), n).numpy()
    want = np.asarray(ref_pipe._masked_validity(jnp.asarray(v), n))
    assert np.array_equal(got, want)


# ------------------------------- TPC-H against daft_tpu on JAX-CPU

@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    from benchmarking.tpch.datagen import generate_tpch
    root = tmp_path_factory.mktemp("tpch_torch_pipe")
    generate_tpch(str(root), scale_factor=0.002, num_parts=4)
    return str(root)


def _ref_suppkey(get_df):
    import daft_tpu
    c = daft_tpu.col
    return (get_df("lineitem").groupby("l_suppkey")
            .agg(c("l_quantity").sum().alias("sum_qty"),
                 c("l_extendedprice").mean().alias("avg_price"),
                 c("l_discount").count().alias("n"),
                 c("l_quantity").min().alias("min_qty"),
                 c("l_extendedprice").max().alias("max_price"),
                 c("l_discount").any_value().alias("any_disc"),
                 c("l_extendedprice").stddev().alias("std_price"))
            .sort("l_suppkey"))


_EXACT = {"q1": ["l_returnflag", "l_linestatus", "count_order"],
          "suppkey_agg": ["l_suppkey", "n", "min_qty", "max_price"],
          "q6": []}
_LOOSE = {"suppkey_agg": ["std_price"]}


def _assert_same(query, got, ref):
    assert set(got) >= set(ref) - {"any_disc"}
    for c, vals in ref.items():
        if c == "any_disc":
            continue
        assert len(got[c]) == len(vals), c
        if c in _EXACT[query]:
            assert got[c] == vals, c
            continue
        rel = 1e-6 if c in _LOOSE.get(query, ()) else 1e-9
        for a, b in zip(got[c], vals):
            assert a == pytest.approx(b, rel=rel), (c, a, b)


@pytest.mark.parametrize("query", ["q1", "suppkey_agg", "q6"])
def test_tpch_pipelined_synchronous_and_cached_match_the_reference(
        tpch_root, monkeypatch, query):
    import daft_tpu
    from benchmarking.tpch import queries as RQ
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    ref_fn = {"q1": RQ.q1, "q6": RQ.q6, "suppkey_agg": _ref_suppkey}[query]
    ref = ref_fn(lambda t: daft_tpu.read_parquet(
        f"{tpch_root}/{t}/*.parquet")).to_pydict()

    def port():
        return Q.QUERIES[query](lambda t: dtt.read_parquet(
            os.path.join(tpch_root, t))).to_pydict()
    runs = {}
    for label, window in (("synchronous", 0), ("pipelined", 2),
                          ("cached", 2)):
        if label != "cached":
            dcache.get_cache().clear()
        monkeypatch.setenv("DAFT_TORCH_DEVICE_INFLIGHT", str(window))
        runtime.reset_counters()
        runs[label] = port()
        c = runtime.counters()
        assert c.get("host_morsels", 0) == 0, (label, c)
        if label == "cached":
            # every task served from the cache: no scan column re-encoded
            assert c["cache_hits"] == 4 and "cache_misses" not in c, c
            assert c.get("scan_bytes_up", 0) == 0, c
        else:
            assert c["cache_misses"] == 4 and c["scan_bytes_up"] > 0, c
        if window:
            assert c["pipeline_slots_acquired"] == \
                c["pipeline_slots_released"] >= 2, c
        _assert_same(query, runs[label], ref)
    assert runs["pipelined"] == runs["synchronous"] == runs["cached"]


# ------------------------------------------------ concurrent stress

def test_concurrent_pipelines_and_cache_keep_their_invariants(monkeypatch):
    """Six pipelines on threads at once, sharing one admission budget and
    one small column cache, with a short switch interval: every slot
    and every admitted byte is released, and the cache's byte count
    equals what it holds and stays within its budget."""
    import sys
    import threading
    table = RecordBatch.from_pydict({"a": np.arange(64, dtype=np.int64)})
    one = dcol.encode_batch(table, ["a"], CPU)
    per = one.columns["a"].data.nbytes + one.columns["a"].validity.nbytes
    monkeypatch.setenv("DAFT_TORCH_DEVICE_CACHE_BYTES", str(5 * per))
    cache = dcache.DeviceColumnCache()
    mem = MemoryManager(budget=3000)
    errors = []

    def submit(item, seq, gate):
        slot = dpipe.acquire_slot(gate, seq, mem, 700)
        try:
            fp = ("t", item % 9)
            if cache.get_table(fp, ["a"]) is None:
                cache.put_table(fp, dcol.encode_batch(table, ["a"], CPU))
        except BaseException:
            dpipe.release_slot(slot)
            raise
        return dpipe.InflightItem(slot, item)

    def worker(k):
        try:
            out = list(dpipe.run_pipelined(
                range(k * 40, k * 40 + 40), submit,
                lambda r, s: r.token, window=2))
            assert out == list(range(k * 40, k * 40 + 40))
        except BaseException as exc:   # reported by the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert mem.outstanding == 0
    c = dpipe.counters_snapshot()
    assert c["slots_acquired"] == c["slots_released"] == 240
    s = cache.stats()
    assert s["bytes"] == s["entries"] * per <= 5 * per
