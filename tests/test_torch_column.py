"""Regression tests for two faults of the port's column transport
(``daft_tpu_torch/device/column.py``), held against ``daft_tpu``.

- An all-null string column encodes to an empty dictionary; decoding it
  took code 0 from that empty dictionary and raised ``ArrowIndexError``.
  It now decodes to nulls. Three shapes: a parquet group-by at default
  knobs (the fused fragment), a per-operator projection and grouped agg
  at floor 0, and the differential fuzzer's seeds 49 and 327 replayed
  through both packages.
- uint64 had no device plane, so a count's final merge and the sorts
  over counts ran on the host. A uint64 column whose values are all below
  2^63 now rides an int64 plane and decodes back to uint64; a value at
  2^63 declines to the host.

The pinned pool behind the transfers (``PinnedPool``) is held here too,
over plain host tensors: a buffer returns when its last view dies, is
reused only after its copy's event has passed, and a small class starts
with several buffers.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
from daft_tpu.analysis import plan_fuzzer


@pytest.fixture
def cpu(monkeypatch):
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    # every device path taken, as before the cost model (which prices these
    # small batches onto the host)
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    runtime.reset_counters()
    return runtime


@pytest.fixture(scope="module")
def null_strings(tmp_path_factory):
    root = tmp_path_factory.mktemp("null_strings")
    pq.write_table(pa.table({
        "s": pa.nulls(5000, type=pa.string()),
        "k": pa.array(np.arange(5000, dtype=np.int64)),
        "t": pa.array(["a", "b"] * 2500)}), str(root / "part0.parquet"))
    return str(root / "*.parquet")


def test_all_null_string_group_by_over_parquet_default_knobs(null_strings,
                                                             cpu):
    import daft_tpu_torch
    from daft_tpu_torch import col
    got = daft_tpu_torch.read_parquet(null_strings).groupby("s") \
        .agg(col("k").sum().alias("m")).to_pydict()
    want = daft_tpu.read_parquet(null_strings).groupby("s") \
        .agg(daft_tpu.col("k").sum().alias("m")).to_pydict()
    assert got == want == {"s": [None], "m": [12497500]}
    counts = cpu.counters()
    assert counts.get("dense", 0) + counts.get("hash", 0) \
        + counts.get("sort", 0) > 0, counts
    assert counts.get("host_morsels", 0) == 0, counts


def test_all_null_string_per_operator_paths_at_floor_0(null_strings, cpu,
                                                       monkeypatch):
    import daft_tpu_torch
    from daft_tpu_torch import col
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    b = daft_tpu_torch.RecordBatch.from_arrow_table(
        pq.read_table(null_strings.replace("*", "part0")))
    proj = b.eval_expression_list([col("s"), (col("k") + 1).alias("k1")])
    assert proj.to_pydict()["s"] == [None] * 5000
    agg = b.agg([col("k").sum().alias("m")], [col("s")])
    assert agg.to_pydict() == {"s": [None], "m": [12497500]}
    counts = cpu.counters()
    assert counts.get("projection", 0) == 1, counts
    assert counts.get("agg_hash", 0) + counts.get("agg_sort", 0) == 1, \
        counts


@pytest.mark.parametrize("seed", [49, 327])
def test_fuzzer_seed_replays_through_both_packages(seed, cpu, monkeypatch):
    """Every device path on (both floors 0): the seed's program gives the
    reference's rows."""
    import daft_tpu_torch
    from daft_tpu_torch import joins
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    monkeypatch.setattr(joins, "DEVICE_MIN_ROWS", 0)
    from daft_tpu_torch.analysis import plan_fuzzer as port_fuzzer
    tables, ops = plan_fuzzer.gen_case(seed)
    want = plan_fuzzer.build_df(tables, ops).to_pydict()
    df = daft_tpu_torch.from_pydict(tables["left"])
    right = daft_tpu_torch.from_pydict(tables["right"])
    for op in ops:
        df = port_fuzzer._apply_op(df, right, op)
    got = df.to_pydict()
    assert plan_fuzzer.canonical_rows(got) == \
        plan_fuzzer.canonical_rows(want)


# ------------------------------------------------------------------ uint64

def test_uint64_below_2_63_round_trips_as_int64():
    import torch
    from daft_tpu_torch import Series
    from daft_tpu_torch.device import column as dcol
    vals = [0, 1, None, 2 ** 63 - 1, 12345]
    s = Series.from_arrow(pa.array(vals, type=pa.uint64()), "u")
    assert dcol.has_device_plane(s)
    c = dcol.encode_series(s, 16, torch.device("cpu"))
    assert c.data.dtype == torch.int64
    back = dcol.decode_np("u", s.datatype(), c.data.numpy()[:5],
                          c.validity.numpy()[:5])
    assert back.to_arrow().type == pa.uint64()
    assert back.to_pylist() == vals


def test_uint64_at_2_63_declines(cpu):
    import torch
    from daft_tpu_torch import RecordBatch, Series, col
    from daft_tpu_torch.device import column as dcol, runtime
    s = Series.from_arrow(pa.array([1, 2 ** 63], type=pa.uint64()), "u")
    assert not dcol.has_device_plane(s)
    with pytest.raises(ValueError, match="2\\^63"):
        dcol.encode_series(s, 16, torch.device("cpu"))
    b = RecordBatch.from_arrow_table(pa.table({
        "u": pa.array([1, 2 ** 63, 3] * 2000, type=pa.uint64()),
        "g": pa.array([1, 2, 3] * 2000)}))
    assert runtime.try_agg(b, [col("u").max().alias("m")], [col("g")]) \
        is None


def test_empty_dictionary_decodes_to_nulls():
    from daft_tpu_torch.datatype import DataType
    from daft_tpu_torch.device import column as dcol
    out = dcol.decode_np("s", DataType.string(), np.zeros(3, np.int32),
                         np.zeros(3, np.bool_), pa.array([], pa.string()))
    assert out.to_pylist() == [None] * 3
    assert out.datatype() == DataType.string()


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    from benchmarking.tpch.datagen import generate_tpch
    root = tmp_path_factory.mktemp("tpch_torch_column")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


@pytest.mark.parametrize("q", [13, 16])
def test_count_sorts_dispatch_to_the_device(tpch_root, q, cpu, monkeypatch):
    """Q13 and Q16 sort over counts (uint64): the final sort takes the
    device argsort, and the answer is the reference's."""
    import daft_tpu_torch
    from benchmarking.tpch import queries as RQ
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    calls = []
    argsort = runtime.try_argsort

    def spy(keys, *a):
        out = argsort(keys, *a)
        calls.append(([k.datatype() for k in keys], out is not None))
        return out
    monkeypatch.setattr(runtime, "try_argsort", spy)
    got = Q.ALL[q](lambda t: daft_tpu_torch.read_parquet(
        f"{tpch_root}/{t}/*.parquet")).to_pydict()
    want = RQ.ALL[q](lambda t: daft_tpu.read_parquet(
        f"{tpch_root}/{t}/*.parquet")).to_pydict()
    assert got == want
    from daft_tpu_torch.datatype import DataType
    assert any(ok and DataType.uint64() in dts for dts, ok in calls), calls


class _Event:
    """A copy's event that has not passed until someone waits on it."""

    def __init__(self):
        self.waited = False

    def query(self):
        return self.waited

    def synchronize(self):
        self.waited = True


def _pool():
    import torch
    from daft_tpu_torch.device.column import PinnedPool
    return PinnedPool(alloc=lambda n: torch.empty(n, dtype=torch.uint8))


def test_pinned_pool_holds_a_buffer_while_any_view_lives():
    """A buffer stays out of the pool while its array, or an Arrow array
    made from a view of it, lives. A small class starts with 8 buffers and
    grows one at a time once all are held; a large class grows one at a
    time from the start; released buffers are reused."""
    import gc
    from daft_tpu_torch.device.column import _PIN_FIRST_BUFFERS
    pool = _pool()
    t, a, _ = pool.take(1000)
    assert a.nbytes == 1000
    assert pool.counters == {"allocated": _PIN_FIRST_BUFFERS,
                             "bytes": _PIN_FIRST_BUFFERS * 4096}
    view = pa.array(a[:8].view(np.int64))
    del t, a
    gc.collect()
    held = [pool.take(3000)[1] for _ in range(_PIN_FIRST_BUFFERS - 1)]
    assert pool.counters["allocated"] == _PIN_FIRST_BUFFERS
    held.append(pool.take(4096)[1])      # the Arrow array holds the 8th
    assert pool.counters["allocated"] == _PIN_FIRST_BUFFERS + 1
    del view, held
    gc.collect()
    held = [pool.take(4096)[1] for _ in range(_PIN_FIRST_BUFFERS + 1)]
    assert pool.counters["allocated"] == _PIN_FIRST_BUFFERS + 1
    del held
    gc.collect()
    big = 2 << 20                        # past the small classes
    held = [pool.take(big)[1] for _ in range(2)]
    assert pool.counters["allocated"] == _PIN_FIRST_BUFFERS + 3
    del held
    gc.collect()
    pool.take(big)
    assert pool.counters["bytes"] == (_PIN_FIRST_BUFFERS + 1) * 4096 \
        + 2 * big


def test_pinned_pool_waits_for_the_last_copy_before_reuse():
    """A returned buffer is handed out again only after the copy its
    lease names has passed: the pool waits on that event rather than
    allocate."""
    import gc
    import torch
    from daft_tpu_torch.device.column import _PIN_FIRST_BUFFERS
    pool = _pool()
    t, a, lease = pool.take(64, torch.int64)
    assert a.dtype == np.int64 and a.shape == (8,)
    ev = _Event()
    lease.event = ev
    del t, a
    gc.collect()
    # the buffer went back behind the class's other first buffers
    for _ in range(_PIN_FIRST_BUFFERS):
        pool.take(64)
    assert ev.waited
    assert pool.counters["allocated"] == _PIN_FIRST_BUFFERS
