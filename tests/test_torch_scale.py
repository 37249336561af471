"""The port's spill-plane IO and memory governor (``daft_tpu_torch/
execution/spill_io.py``, ``execution/governor.py``): codec parity of every
spill path against ``daft_tpu`` (the grace join's buckets, the spilling
reducer's partial states, recursive re-partitioning at depth >= 2) on
nullable int/string/date payloads, the writer pool's ordering, error and
back-pressure contracts, prefetch-piped reads, the disk-byte counters, and
the governor's hysteresis, throttle and actions with a fake RSS.

The parity subset of ``tests/test_scale.py``. Answers compare as row
multisets, values exactly (integer sums, counts, dates, strings).

Left out: the chaos-freeze cases (the chaos plane is ROADMAP A7/A8; the
port's governor reads "no chaos plan"), and the ``explain_analyze``,
metrics-endpoint and flight-recorder cases (``observability.py``, A8).
"""

import datetime
import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution import memory as ref_memory
from daft_tpu_torch.execution import governor, memory, spill_io
from daft_tpu_torch.execution import out_of_core as ooc
from daft_tpu_torch.recordbatch import RecordBatch

CODECS = ["lz4", "zstd", "none"]


def _rows(d):
    keys = list(d)
    return sorted(zip(*[d[k] for k in keys]),
                  key=lambda r: tuple((v is None, str(type(v)), v)
                                      for v in r))


def _typed(n=40_000, ndv=8_000):
    """Nullable int/string/date payload on a spill-forcing key."""
    base = datetime.date(2024, 1, 1)
    return {
        "k": [None if i % 101 == 0 else i % ndv for i in range(n)],
        "v": [None if i % 7 == 0 else i for i in range(n)],
        "s": [None if i % 11 == 0 else "name-%d" % (i % 997)
              for i in range(n)],
        "d": [None if i % 13 == 0 else base + datetime.timedelta(i % 366)
              for i in range(n)],
    }


#: the unbounded port answer and the reference's under the budget, per
#: test: computed at the first codec, held for the others (the codec
#: changes no answer)
_ANSWERS = {}


def _want_and_ref(name, q, monkeypatch, **budget):
    if name not in _ANSWERS:
        want = q(daft_tpu_torch)
        for k, v in budget.items():
            monkeypatch.setenv("DAFT_TPU_" + k, v)
        _ANSWERS[name] = (want, q(daft_tpu))
    return _ANSWERS[name]


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_SPILL_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DAFT_TPU_SPILL_DIR", str(tmp_path / "ref"))
    for v in ("DAFT_TPU_MEMORY_LIMIT", "DAFT_TORCH_MEMORY_LIMIT"):
        monkeypatch.delenv(v, raising=False)
    memory._spill_dir = ref_memory._spill_dir = None
    memory._spill_ipc_cache.clear()
    ref_memory._spill_ipc_cache.clear()
    governor._reset_for_tests()
    yield
    governor._reset_for_tests()
    memory._spill_ipc_cache.clear()
    ref_memory._spill_ipc_cache.clear()
    memory._spill_dir = ref_memory._spill_dir = None


def _set(monkeypatch, name, value):
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        monkeypatch.setenv(pre + name, value)


# ------------------------------------------------------------ codec parity

@pytest.mark.parametrize("codec", CODECS)
def test_grace_join_codec_parity(monkeypatch, codec):
    """The spilled grace join under each codec: the unbounded answer and
    the reference's under the same budget and codec."""
    right = {"k": list(range(4_000)), "w": [i * 2 for i in range(4_000)]}

    def q(pkg):
        return _rows(pkg.from_pydict(_typed()).join(
            pkg.from_pydict(right), on="k", strategy="hash").to_pydict())
    want, ref = _want_and_ref("join", q, monkeypatch, MEMORY_LIMIT="400KB")
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "SPILL_COMPRESSION", codec)
    b0 = memory.spill_counters_snapshot()
    got = q(daft_tpu_torch)
    assert memory.spill_counters_delta(b0).get("joins_partitioned", 0) >= 1
    assert got == want == ref


@pytest.mark.parametrize("codec", CODECS)
def test_spilled_agg_codec_parity(monkeypatch, codec):
    """Partial agg states spill and merge under each codec."""
    def q(pkg):
        col = pkg.col
        return _rows(pkg.from_pydict(_typed(n=60_000, ndv=60_000))
                     .groupby("k").agg(col("v").sum(), col("s").count(),
                                       col("d").max()).to_pydict())
    want, ref = _want_and_ref("agg", q, monkeypatch, MEMORY_LIMIT="400KB",
                              SPILL_AGG="1")
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "SPILL_AGG", "1")
    _set(monkeypatch, "SPILL_COMPRESSION", codec)
    b0 = memory.spill_counters_snapshot()
    got = q(daft_tpu_torch)
    assert memory.spill_counters_delta(b0).get("agg_buckets_merged", 0) > 0
    assert got == want == ref


@pytest.mark.parametrize("codec", CODECS)
def test_recursive_repartition_codec_parity(monkeypatch, codec):
    """A forced 2-way fanout recurses to depth >= 2; the re-partitioned
    spill files round-trip and the joined answer does not change."""
    right = {"k": list(range(6_000)), "w": list(range(6_000))}

    def q(pkg):
        return _rows(pkg.from_pydict(_typed(n=60_000, ndv=6_000)).join(
            pkg.from_pydict(right), on="k", strategy="hash").to_pydict())
    want, ref = _want_and_ref("recursive", q, monkeypatch,
                              MEMORY_LIMIT="200KB", SPILL_PARTITIONS="2")
    _set(monkeypatch, "MEMORY_LIMIT", "200KB")
    _set(monkeypatch, "SPILL_PARTITIONS", "2")
    _set(monkeypatch, "SPILL_COMPRESSION", codec)
    b0 = memory.spill_counters_snapshot()
    got = q(daft_tpu_torch)
    d = memory.spill_counters_delta(b0)
    depths = [int(k[len("recursions_d"):]) for k in d
              if k.startswith("recursions_d")]
    assert depths and max(depths) >= 2, d
    assert got == want == ref


@pytest.mark.parametrize("codec", CODECS)
def test_store_roundtrip_bit_identical(monkeypatch, codec):
    """The typed batch read back from a spilled bucket equals the batch
    pushed, per codec, with the async writers on."""
    monkeypatch.setenv("DAFT_TORCH_SPILL_COMPRESSION", codec)
    monkeypatch.setenv("DAFT_TORCH_SPILL_IO_PARALLELISM", "4")
    base = datetime.date(2023, 6, 15)
    rb = RecordBatch.from_pydict({
        "v": [None if i % 5 == 0 else i for i in range(5_000)],
        "s": [None if i % 3 == 0 else "s%d" % i for i in range(5_000)],
        "d": [None if i % 4 == 0 else base + datetime.timedelta(i % 200)
              for i in range(5_000)],
    })
    with memory.PartitionedSpillStore(2, budget=1) as store:
        store.push(0, rb)
        store.push(1, rb)
        store.finalize()
        for i in (0, 1):
            got = store.bucket_batches(i)
            assert sum(len(b) for b in got) == 5_000
            assert got[0].to_pydict() == rb.to_pydict()


# ------------------------------------------------------------- writer pool

def test_writer_pool_preserves_push_order(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SPILL_IO_PARALLELISM", "8")
    with memory.PartitionedSpillStore(4, budget=1) as store:
        for seq in range(40):
            for b in range(4):
                store.push(b, RecordBatch.from_pydict(
                    {"seq": [seq] * 50, "b": [b] * 50}))
        store.finalize()
        for b in range(4):
            seqs = []
            for batch in store.bucket_batches(b):
                d = batch.to_pydict()
                assert set(d["b"]) == {b}
                seqs.extend(sorted(set(d["seq"])))
            assert seqs == sorted(seqs) and set(seqs) == set(range(40))


def test_writer_group_drain_raises_first_error():
    g = spill_io.SpillWriterGroup(pending_cap=1 << 20)

    def boom():
        raise RuntimeError("disk gone")

    g.submit("a", boom, 10)
    with pytest.raises(RuntimeError, match="disk gone"):
        g.drain()
    g.close()  # close() after an error does not raise


def test_writer_group_single_huge_request_admitted():
    g = spill_io.SpillWriterGroup(pending_cap=100)
    done = threading.Event()
    g.submit("a", done.set, 10_000_000)
    assert done.wait(5.0)
    g.drain()


def test_writer_group_backpressures_at_cap():
    g = spill_io.SpillWriterGroup(pending_cap=1 << 20)
    release = threading.Event()
    g.submit("a", lambda: release.wait(5.0), 900_000)
    t0 = time.monotonic()

    def unblock():
        time.sleep(0.2)
        release.set()

    threading.Thread(target=unblock, daemon=True).start()
    g.submit("b", lambda: None, 200_000)  # waits for a's drain
    assert time.monotonic() - t0 >= 0.15
    g.drain()


@pytest.mark.parametrize("window", [3, 0])
def test_prefetch_ordered_yields_in_order(window):
    def thunk(i):
        def run():
            time.sleep(0.05 if i == 0 else 0.0)  # the first finishes last
            return i
        return run
    assert list(spill_io.prefetch_ordered(
        (thunk(i) for i in range(6)), window=window)) == list(range(6))


@pytest.mark.parametrize("value,want", [("3", 3), ("99", 8), ("0", 0)])
def test_spill_io_parallelism_knob(monkeypatch, value, want):
    monkeypatch.setenv("DAFT_TORCH_SPILL_IO_PARALLELISM", value)
    assert spill_io.spill_io_parallelism() == want
    assert spill_io.read_prefetch_window() == min(want, 2)


def test_disk_bytes_track_codec(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_SPILL_COMPRESSION", "lz4")
    rb = RecordBatch.from_pydict({"x": [7] * 40_000})
    b0 = memory.spill_counters_snapshot()
    with memory.PartitionedSpillStore(1, budget=1) as store:
        store.push(0, rb)
        store.finalize()
        store.bucket_batches(0)
    d = memory.spill_counters_delta(b0)
    assert 0 < d["disk_bytes_written"] < d["bytes_written"]
    assert d["disk_bytes_written"] <= d.get("disk_bytes_read", 0) \
        < d["bytes_written"]


# --------------------------------------------------------------- governor

@pytest.fixture
def fake_rss(monkeypatch):
    """The governor sees a controllable RSS against a 100MB limit."""
    val = {"rss": 10 << 20}
    monkeypatch.setattr(governor, "_read_rss", lambda: val["rss"])
    monkeypatch.setenv("DAFT_TORCH_MEMORY_LIMIT", "100MB")
    governor._reset_for_tests()
    yield val
    governor._reset_for_tests()


def _rss(val, nbytes):
    val["rss"] = int(nbytes)
    governor.rss_bytes(refresh=True)


def test_governor_hysteresis(fake_rss):
    lim = 100 * 1000 * 1000
    assert governor.enabled() and governor.watermarks() == (0.85, 0.70)
    assert not governor.under_pressure()
    _rss(fake_rss, lim * 0.90)
    b0 = governor.counters_snapshot()
    assert governor.under_pressure()
    _rss(fake_rss, lim * 0.80)  # between low and high: still pressured
    assert governor.under_pressure()
    _rss(fake_rss, lim * 0.60)  # below low: clears
    assert not governor.under_pressure()
    d = governor.counters_delta(b0)
    assert d.get("pressure_episodes") == 1 and d.get("gc_collects") == 1


def test_governor_actions_under_pressure(fake_rss):
    _rss(fake_rss, 95 << 20)
    assert governor.budget_scale() == 0.5
    assert governor.prefetch_window(4) == 1
    assert governor.prefetch_window(1) == 1
    _rss(fake_rss, 10 << 20)
    assert not governor.under_pressure()
    assert governor.budget_scale() == 1.0 and governor.prefetch_window(4) == 4


def test_governor_throttle_bounded(fake_rss):
    _rss(fake_rss, 95 << 20)
    b0 = governor.counters_snapshot()
    t0 = time.monotonic()
    waited = governor.throttle("test")
    assert 0.0 < waited <= governor._THROTTLE_MAX_S + 0.1
    assert time.monotonic() - t0 < 5.0
    d = governor.counters_delta(b0)
    assert d.get("throttle_waits") == 1 and d.get("throttle_test") == 1
    assert d.get("throttle_wait_us", 0) > 0


def test_governor_throttle_releases_early(fake_rss):
    _rss(fake_rss, 95 << 20)
    assert governor.under_pressure()

    def drop():
        time.sleep(0.07)
        _rss(fake_rss, 10 << 20)

    threading.Thread(target=drop, daemon=True).start()
    assert governor.throttle("early") < governor._THROTTLE_MAX_S


def test_governor_inert_without_limit():
    assert not governor.enabled() and not governor.under_pressure()
    assert governor.budget_scale() == 1.0
    assert governor.prefetch_window(4) == 4
    assert governor.throttle() == 0.0 and governor.pressure() == 0.0


def test_governor_off_switch(fake_rss, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_GOVERNOR", "0")
    _rss(fake_rss, 99 << 20)
    assert not governor.enabled() and governor.budget_scale() == 1.0


def test_governor_watermark_knobs(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_GOVERNOR_HIGH", "0.5")
    monkeypatch.setenv("DAFT_TORCH_GOVERNOR_LOW", "0.9")  # inverted
    high, low = governor.watermarks()
    assert high == 0.5 and low < high


def test_governor_peak_rss_tracking(fake_rss):
    governor.reset_peak()
    _rss(fake_rss, 40 << 20)
    _rss(fake_rss, 20 << 20)
    assert governor.peak_rss_bytes() == 40 << 20
    assert governor.reset_peak() == 20 << 20
    snap = governor.snapshot()
    assert snap["rss_peak_bytes"] == float(20 << 20)
    assert snap["limit_bytes"] == 100 * 1000 * 1000.0


def test_real_rss_probe_sane():
    assert governor.rss_bytes(refresh=True) > 4 << 20


def test_governor_budget_scale_shrinks_pair_budget(fake_rss):
    _rss(fake_rss, 10 << 20)
    unpressured = ooc.pair_budget_bytes(1 << 20)
    _rss(fake_rss, 95 << 20)
    assert ooc.pair_budget_bytes(1 << 20) < unpressured


def test_governor_pressure_flips_the_spill_plan(fake_rss):
    """Under pressure the priced resident budget halves: an input that
    fits on paper takes the partitioned plan."""
    from daft_tpu_torch.device import costmodel
    _rss(fake_rss, 10 << 20)
    assert not costmodel.spill_plan_wins(600_000, 1_000_000)
    _rss(fake_rss, 95 << 20)
    assert costmodel.spill_plan_wins(600_000, 1_000_000)
