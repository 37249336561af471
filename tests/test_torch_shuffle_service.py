"""The port's shuffle service and shuffle fast path
(``daft_tpu_torch/distributed/shuffle_service.py``, ``worker.py``,
``stages.py``) against the reference's ``tests/test_shuffle_service.py``
and ``tests/test_shuffle_perf.py``.

- Map → serve → fetch over both transports (HTTP, and Arrow Flight where
  ``pyarrow.flight`` imports), empty and unknown partitions, a straggler
  push after the seal, unregistering over the transport, the failed
  task's spill directory cleaned up.
- The spill-cache hash exchange against the naive one; its partitions'
  key sets equal the reference's.
- The map-side combine: parity over every decomposable agg family with
  the local engine and the reference, the fallback for a non-decomposable
  set, the escape hatch, the cost model's decisions equal to the
  reference's.
- Compressed transport for every codec, the chunked HTTP send, explicit
  HTTP error details, the parallel fetch's overlap and source order, the
  chaos-serialized sequential fetch, the stream-safety rules, the
  streaming merge agg over many sources, and the ``shuffle`` stats block.
"""

import os
import threading

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.distributed import shuffle_service as ss
from daft_tpu_torch.distributed.worker import (FetchSpec, _ParallelFetch,
                                               _stream_safe)
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.runners.distributed_runner import DistributedRunner

TRANSPORTS = ["http"] + (["flight"] if ss.paflight is not None else [])
CODECS = ["none", "lz4", "zstd"]
REL = 1e-9


@pytest.fixture(autouse=True)
def host_tier(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "flight")
    yield


@pytest.fixture(params=TRANSPORTS)
def server(request):
    s = (ss.FlightShuffleServer() if request.param == "flight"
         else ss.ShuffleServer())
    yield s
    s.shutdown()


def _run_distributed(df, num_workers=3):
    from daft_tpu_torch import context
    ctx = context.get_context()
    runner = DistributedRunner(num_workers=num_workers)
    old = ctx._runner
    ctx.set_runner(runner)
    try:
        return df.to_pydict()
    finally:
        ctx.set_runner(old)
        runner.shutdown()


def _frame(pkg=daft_tpu_torch, n=6000, nkeys=7, parts=4, seed=3):
    rng = np.random.default_rng(seed)
    return pkg.from_pydict({
        "k": rng.integers(0, nkeys, n).tolist(),
        "v": [float(i) for i in range(n)],
        "w": rng.uniform(0, 10, n).round(3).tolist(),
    }).into_partitions(parts)


def _approx_eq(a, b):
    for x, y in zip(a, b):
        assert abs(x - y) <= REL * max(abs(x), abs(y), 1.0), (x, y)


# --------------------------------------------------------- the service

def test_make_shuffle_server_prefers_flight(monkeypatch):
    monkeypatch.delenv("DAFT_TORCH_SHUFFLE_TRANSPORT", raising=False)
    s = ss.make_shuffle_server()
    try:
        want = ss.ShuffleServer if ss.paflight is None \
            else ss.FlightShuffleServer
        assert isinstance(s, want)
    finally:
        s.shutdown()
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_TRANSPORT", "http")
    s = ss.make_shuffle_server()
    try:
        assert isinstance(s, ss.ShuffleServer)
    finally:
        s.shutdown()


def test_map_serve_fetch_roundtrip(server):
    cache = ss.ShuffleCache()
    n_parts = 4
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1000, 10_000)
    vals = rng.random(10_000)
    pids = keys % n_parts
    for lo, hi in ((0, 5000), (5000, 10_000)):
        for p in range(n_parts):
            m = pids[lo:hi] == p
            if m.any():
                cache.push(p, pa.table({"k": keys[lo:hi][m],
                                        "v": vals[lo:hi][m]}))
    server.register(cache)
    seen = 0
    for p in range(n_parts):
        t = ss.fetch_partition(server.address, cache.shuffle_id, p)
        assert (t.column("k").to_numpy() % n_parts == p).all()
        seen += len(t)
    assert seen == 10_000


def test_empty_partition_and_unknown_shuffle(server):
    cache = ss.ShuffleCache()
    cache.push(0, pa.table({"x": [1]}))
    server.register(cache)
    assert ss.fetch_partition(server.address, cache.shuffle_id, 3) is None
    with pytest.raises(Exception):
        ss.fetch_partition(server.address, "nope", 0)


def test_straggler_push_after_seal(server):
    cache = ss.ShuffleCache()
    cache.push(0, pa.table({"x": [1, 2, 3]}))
    server.register(cache)
    cache.push(0, pa.table({"x": [4, 5]}))
    t = ss.fetch_partition(server.address, cache.shuffle_id, 0)
    assert sorted(t.column("x").to_pylist()) == [1, 2, 3, 4, 5]


def test_fetch_of_a_partition_lost_mid_serve_fails(server):
    """A shuffle cleaned up while it is still served (a crashed source
    unregistered under a concurrent fetch) fails the fetch as retryable:
    a pushed partition whose data is gone is never served as an empty
    one (that lost whole groups under chaos faults)."""
    from daft_tpu_torch.distributed.resilience import ShuffleFetchError
    cache = ss.ShuffleCache()
    cache.push(0, pa.table({"x": [1, 2, 3]}))
    server.register(cache)
    cache.cleanup()            # the data goes, the registration stays
    assert cache.lost(0) and not cache.lost(1)
    with pytest.raises(ShuffleFetchError):
        ss.fetch_partition(server.address, cache.shuffle_id, 0)
    # a partition nothing was pushed to is still a plain empty one
    assert ss.fetch_partition(server.address, cache.shuffle_id, 1) is None


def test_remote_unregister_over_transport(server):
    cache = ss.ShuffleCache()
    cache.push(0, pa.table({"x": [1, 2]}))
    root = cache._root
    server.register(cache)
    assert ss.fetch_partition(server.address, cache.shuffle_id, 0) \
        is not None
    ss.unregister_remote(server.address, cache.shuffle_id)
    assert not os.path.isdir(root)
    with pytest.raises(Exception):
        ss.fetch_partition(server.address, cache.shuffle_id, 0)


def test_unregister_cleans_spill_files(server):
    cache = ss.ShuffleCache()
    cache.push(0, pa.table({"x": list(range(10))}))
    root = cache._root
    server.register(cache)
    assert os.path.isdir(root)
    server.unregister(cache.shuffle_id)
    assert not os.path.isdir(root)


def test_failed_shuffle_task_cleans_spill_dir(monkeypatch):
    from daft_tpu_torch.distributed import worker as w
    from daft_tpu_torch.execution.executor import LocalExecutor
    from daft_tpu_torch.micropartition import MicroPartition
    made = []
    orig_init = ss.ShuffleCache.__init__

    def spy_init(self, *a, **k):
        orig_init(self, *a, **k)
        made.append(self)

    def boom_stream(self, plan, stage_inputs=None):
        def gen():
            yield MicroPartition.from_pydict({"k": [1, 2], "v": [1.0, 2.0]})
            raise RuntimeError("fetch fault mid-drain")
        return gen()

    monkeypatch.setattr(ss.ShuffleCache, "__init__", spy_init)
    monkeypatch.setattr(LocalExecutor, "run", boom_stream)
    task = w.StageTask(0, pp.InMemorySource([], None), {},
                       shuffle_out=w.ShuffleOutSpec(num_partitions=2,
                                                    by=(col("k"),)))
    with pytest.raises(RuntimeError, match="fetch fault mid-drain"):
        w._run_task_body(task)
    assert made and all(not os.path.isdir(c._root) for c in made)


def _spill_cache_parts(pkg, algo):
    df = pkg.from_pydict({"k": [i % 7 for i in range(5000)],
                          "v": [float(i) for i in range(5000)]}) \
        .into_partitions(6)
    with pkg.execution_config_ctx(shuffle_algorithm=algo):
        rep = df.repartition(4, pkg.col("k"))
        assert rep.num_partitions() == 4
        parts = [sorted(set(p.to_pydict()["k"]))
                 for p in rep.iter_partitions()]
        agg = df.groupby("k").agg(pkg.col("v").sum().alias("s")) \
            .sort("k").to_pydict()
    return parts, agg


def test_spill_cache_shuffle_strategy_in_queries():
    naive = _spill_cache_parts(daft_tpu_torch, "naive")
    cache = _spill_cache_parts(daft_tpu_torch, "spill_cache")
    assert cache == naive
    assert cache == _spill_cache_parts(daft_tpu, "spill_cache")


def test_spill_cache_shuffle_preserves_empty_partitions():
    df = daft_tpu_torch.from_pydict({"k": [1, 1, 1], "v": ["a", "b", "c"]})
    with daft_tpu_torch.execution_config_ctx(shuffle_algorithm="spill_cache"):
        rep = df.into_partitions(2).repartition(5, col("k"))
        parts = [p.combined().to_arrow_table()
                 for p in rep.iter_partitions()]
    assert len(parts) == 5 and sum(t.num_rows for t in parts) == 3
    assert all(t.schema.names == ["k", "v"] for t in parts)


# ---------------------------------------------------- map-side combine

def _decomposable(pkg, df):
    c = pkg.col
    return df.groupby("k").agg(
        c("v").sum().alias("s"), c("w").mean().alias("m"),
        c("v").count().alias("c"), c("w").min().alias("lo"),
        c("w").max().alias("hi"), c("v").stddev().alias("sd")).sort("k")


def test_combine_parity_on_decomposable_aggs(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMBINE", "1")
    local = _decomposable(daft_tpu_torch, _frame()).to_pydict()
    ref = _decomposable(daft_tpu, _frame(daft_tpu)).to_pydict()
    before = ss.shuffle_counters_snapshot()
    dist = _run_distributed(_decomposable(daft_tpu_torch, _frame()))
    d = ss.shuffle_counters_delta(before)
    for other in (local, ref):
        assert dist["k"] == other["k"] and dist["c"] == other["c"]
        for name in ("s", "m", "lo", "hi", "sd"):
            _approx_eq(dist[name], other[name])
    assert d.get("combine_rows_in", 0) > 0, d
    assert d.get("combine_rows_out", 0) <= d["combine_rows_in"], d


def test_mixed_decomposable_and_fallback_aggs(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMBINE", "1")

    def q(df):
        return df.groupby("k").agg(col("v").sum().alias("s"),
                                   col("v").count_distinct().alias("nd")) \
            .sort("k")

    local = q(_frame(n=2500)).to_pydict()
    before = ss.shuffle_counters_snapshot()
    dist = _run_distributed(q(_frame(n=2500)))
    d = ss.shuffle_counters_delta(before)
    assert dist["k"] == local["k"] and dist["nd"] == local["nd"]
    _approx_eq(dist["s"], local["s"])
    assert d.get("combine_rows_in", 0) == 0, d


def test_combine_escape_hatch_and_wire_reduction(monkeypatch):
    def run(combine):
        monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMBINE", combine)
        before = ss.shuffle_counters_snapshot()
        out = _run_distributed(_frame(n=8000, nkeys=5).groupby("k")
                               .agg(col("v").sum().alias("s")).sort("k"))
        return out, ss.shuffle_counters_delta(before)

    off_out, off_c = run("0")
    on_out, on_c = run("1")
    assert off_out["k"] == on_out["k"]
    _approx_eq(off_out["s"], on_out["s"])
    assert off_c.get("combine_rows_in", 0) == 0
    assert on_c.get("combine_rows_in", 0) > 0
    assert on_c.get("rows_pushed", 0) < off_c.get("rows_pushed", 0)


@pytest.mark.parametrize("args", [(1_000_000, 4, 8), (1_000_000, 900_000, 8),
                                  (None, None, 8), (0, None, 8),
                                  (50_000, 20_000, 200)])
def test_combine_cost_model_decides_as_the_reference(args):
    from daft_tpu.device import costmodel as r_cm
    from daft_tpu_torch.device import costmodel as cm
    assert cm.shuffle_combine_wins(*args) == r_cm.shuffle_combine_wins(*args)
    assert cm.combine_wins_pure(*args) == r_cm.combine_wins_pure(*args)
    assert cm.shuffle_combine_wins(1_000_000, 4, 8)
    assert not cm.shuffle_combine_wins(1_000_000, 900_000, 8)


def test_decomposition_table_is_single_sourced():
    from daft_tpu_torch import aggs
    from daft_tpu_torch.expressions import col as c
    assert aggs.SELF_MERGE_OPS == frozenset(
        m for _, m in aggs.AGG_DECOMPOSITION.values())
    finals = [c("p0").sum().alias("out0"), c("p1").max().alias("out1")]
    assert [e.name() for e in aggs.merge_exprs_for(finals)] == \
        ["out0", "out1"]
    assert [e.name() for e in aggs.merge_exprs_for(
        finals, alias_to="source")] == ["p0", "p1"]
    assert aggs.merge_exprs_for([c("p0").mean().alias("x")]) is None
    # two merges of one wire column with different ops
    assert aggs.merge_exprs_for([c("p0").sum().alias("a"),
                                 c("p0").max().alias("b")],
                                alias_to="source") is None


# ------------------------------------------------ compressed transport

def _codec_available(codec):
    if codec == "none":
        return True
    try:
        import pyarrow.ipc as paipc
        paipc.IpcWriteOptions(compression=codec)
        return True
    except Exception:
        return False


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("codec", CODECS)
def test_compression_roundtrip_with_straggler(monkeypatch, transport, codec):
    if not _codec_available(codec):
        pytest.skip(f"{codec} not built into this pyarrow")
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMPRESSION", codec)
    srv = ss.ShuffleServer() if transport == "http" \
        else ss.FlightShuffleServer()
    try:
        cache = ss.ShuffleCache()
        t = pa.table({"x": list(range(20000)),
                      "s": [f"row-{i % 50}" for i in range(20000)]})
        cache.push(0, t.slice(0, 15000))
        cache.push(0, t.slice(15000))
        srv.register(cache)
        cache.push(0, pa.table({"x": [-1, -2], "s": ["strag", "strag"]}))
        got = ss.fetch_partition(srv.address, cache.shuffle_id, 0)
        assert got.num_rows == 20002
        assert sorted(got.column("x").to_pylist())[:2] == [-2, -1]
    finally:
        srv.shutdown()


def test_compression_reduces_spill_bytes(monkeypatch):
    t = pa.table({"x": list(range(200_000)), "s": ["abcdefgh"] * 200_000})
    sizes = {}
    for codec in ("none", "lz4", "bogus"):
        monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMPRESSION", codec)
        c = ss.ShuffleCache()
        c.push(0, t)
        c.close()
        sizes[codec] = c.partition_size(0)
        c.cleanup()
    if _codec_available("lz4"):
        assert sizes["lz4"] < sizes["none"] * 0.7, sizes
    assert sizes["bogus"] == sizes["none"], sizes


def test_chunked_http_send_and_incremental_read(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_COMPRESSION", "none")
    srv = ss.ShuffleServer()
    try:
        cache = ss.ShuffleCache()
        rng = np.random.default_rng(0)
        t = pa.table({"x": rng.integers(0, 1 << 40, 400_000),
                      "y": rng.uniform(size=400_000)})
        cache.push(0, t)
        srv.register(cache)
        cache.push(0, t.slice(0, 1000))
        assert cache.partition_size(0) > ss._CHUNK_BYTES
        got = ss.fetch_partition(srv.address, cache.shuffle_id, 0)
        assert got.num_rows == 401_000
        assert got.column("x").to_pylist()[:5] == \
            t.column("x").to_pylist()[:5]
    finally:
        srv.shutdown()


def test_http_error_detail_is_explicit():
    from daft_tpu_torch.distributed.resilience import ShuffleFetchError
    srv = ss.ShuffleServer()
    try:
        with pytest.raises(ShuffleFetchError) as ei:
            ss.fetch_partition(srv.address, "missing", 0)
        assert "HTTP 404" in ei.value.detail, ei.value.detail
    finally:
        srv.shutdown()


# ------------------------------------------------ parallel pipelined fetch

def _serve_sources(k, rows_each=200):
    srv = ss.make_shuffle_server()
    caches = []
    for j in range(k):
        c = ss.ShuffleCache()
        c.push(0, pa.table({"x": list(range(j * rows_each,
                                            (j + 1) * rows_each))}))
        srv.register(c)
        caches.append(c)
    return srv, [(srv.address, c.shuffle_id) for c in caches]


def test_parallel_fetch_overlaps_and_preserves_source_order(monkeypatch):
    """At least two fetches genuinely in flight at once (structural, not
    timed) and the tables still come in source order."""
    srv, srcs = _serve_sources(4)
    orig = ss.fetch_partition
    lock = threading.Lock()
    state = {"inflight": 0, "peak": 0}
    gate = threading.Event()

    def slow(address, shuffle_id, partition, fault_key=None):
        with lock:
            state["inflight"] += 1
            state["peak"] = max(state["peak"], state["inflight"])
            if state["inflight"] >= 2:
                gate.set()
        gate.wait(timeout=10.0)
        try:
            return orig(address, shuffle_id, partition, fault_key=fault_key)
        finally:
            with lock:
                state["inflight"] -= 1

    monkeypatch.setattr(ss, "fetch_partition", slow)
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM", "4")
    try:
        parts = list(_ParallelFetch(FetchSpec(srcs, 0), streaming=True))
        assert state["peak"] >= 2, state
        assert [p.to_pydict()["x"][0] for p in parts] == [0, 200, 400, 600]
    finally:
        srv.shutdown()


def test_chaos_serialize_forces_sequential_single_morsel(monkeypatch):
    from daft_tpu_torch.distributed.worker import resolve_stage_inputs
    monkeypatch.setenv("DAFT_TORCH_CHAOS_SERIALIZE", "1")
    srv, srcs = _serve_sources(3)
    calls = []
    orig = ss.fetch_partition

    def spy(address, shuffle_id, partition, fault_key=None):
        calls.append(shuffle_id)
        return orig(address, shuffle_id, partition, fault_key=fault_key)

    monkeypatch.setattr(ss, "fetch_partition", spy)
    try:
        out = resolve_stage_inputs({0: FetchSpec(srcs, 0)})
        assert isinstance(out[0], list) and len(out[0]) == 1
        assert len(out[0][0]) == 600
        assert calls == [sid for _, sid in srcs]
    finally:
        srv.shutdown()


def test_stream_safety_rules():
    from daft_tpu_torch.expressions import col as c
    schema = daft_tpu_torch.from_pydict({"k": [1], "s": [1.0]}).schema()
    si = pp.StageInput(7, schema)
    agg = pp.Aggregate(si, [c("s").sum().alias("s")], [c("k")], schema,
                       "final")
    assert _stream_safe(agg, 7, has_shuffle_out=False)
    assert _stream_safe(pp.Project(agg, [c("k"), c("s")], schema), 7, False)
    agg2 = pp.Aggregate(pp.StageInput(7, schema),
                        [c("s").mean().alias("m")], [c("k")], schema,
                        "single")
    assert not _stream_safe(agg2, 7, False)
    dd = pp.Dedup(pp.StageInput(7, schema), [c("k")])
    assert not _stream_safe(dd, 7, False)
    assert not _stream_safe(dd, 7, True)
    bare = pp.StageInput(7, schema)
    assert not _stream_safe(bare, 7, False)
    assert _stream_safe(bare, 7, True)
    proj = pp.Project(pp.StageInput(7, schema), [c("k")], schema)
    assert not _stream_safe(proj, 7, False)
    assert _stream_safe(proj, 7, True)


def test_streaming_merge_agg_multi_source_parity(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM", "8")

    def q(df):
        return df.groupby("k").agg(col("v").sum().alias("s"),
                                   col("v").count().alias("c")).sort("k")

    local = q(_frame(n=9000, parts=6)).to_pydict()
    dist = _run_distributed(q(_frame(n=9000, parts=6)), num_workers=4)
    assert dist["k"] == local["k"] and dist["c"] == local["c"]
    _approx_eq(dist["s"], local["s"])


def test_runtime_stats_shuffle_block():
    from daft_tpu_torch import observability as obs
    _run_distributed(_frame(n=4000).groupby("k")
                     .agg(col("v").sum().alias("s")).sort("k"))
    stats = obs.last_query_stats()
    assert stats is not None and stats.shuffle
    assert stats.shuffle.get("bytes_written", 0) > 0
    assert stats.shuffle.get("fetches", 0) > 0
    r = stats.render()
    assert "shuffle (data plane):" in r
    assert "written:" in r and "fetched:" in r
    # the dashboard's entry carries the block too
    from daft_tpu_torch import dashboard
    dashboard.broadcast_query(stats)
    assert dashboard._history[-1]["shuffle"] == dict(stats.shuffle)
