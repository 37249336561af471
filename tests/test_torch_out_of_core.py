"""Out-of-core execution through the port (``daft_tpu_torch/execution/
out_of_core.py``): the grace hash join and the spill-partitioned
aggregation under a ``400KB`` budget, held to ``daft_tpu`` under the same
budget (``DAFT_TPU_MEMORY_LIMIT``, JAX on the CPU) and to the port's own
unbounded run, on the same numpy-seeded inputs.

The parity subset of ``tests/test_out_of_core.py``. Answers are compared
as row multisets (a hash join's and a group-by's row order is the
engine's own); integer, string and float values must be equal (the sums
are of small integers held exactly in float64: tolerance 0).

Left out: the ``explain_analyze`` spill block and the metrics-endpoint
counters (``observability.py``, A8).
"""

import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.device import costmodel as ref_costmodel
from daft_tpu.execution import memory as ref_memory
from daft_tpu.execution import out_of_core as ref_ooc
from daft_tpu.recordbatch import RecordBatch as RefBatch
from daft_tpu_torch.device import costmodel
from daft_tpu_torch.execution import memory, out_of_core as ooc
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch

PKGS = {"ref": daft_tpu, "port": daft_tpu_torch}
HOWS = ["inner", "left", "right", "outer", "semi", "anti"]


def _rows(d):
    keys = list(d)
    return sorted(zip(*[d[k] for k in keys]),
                  key=lambda r: tuple((v is None, v) for v in r))


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """The port on CPU tensors, each package spilling into its own
    directory, no budget unless a test sets one."""
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_SPILL_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DAFT_TPU_SPILL_DIR", str(tmp_path / "ref"))
    for v in ("DAFT_TPU_MEMORY_LIMIT", "DAFT_TORCH_MEMORY_LIMIT"):
        monkeypatch.delenv(v, raising=False)
    memory._spill_dir = ref_memory._spill_dir = None
    yield
    memory._spill_dir = ref_memory._spill_dir = None


def _set(monkeypatch, name, value):
    """One knob in both packages (``DAFT_TPU_<name>`` and
    ``DAFT_TORCH_<name>``); None unsets it."""
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        if value is None:
            monkeypatch.delenv(pre + name, raising=False)
        else:
            monkeypatch.setenv(pre + name, value)


def _join_data(n=60_000, ndv=20_000, nulls=False, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, ndv, n).astype(object)
    if nulls:
        k[::97] = None
    left = {"k": list(k), "v": list(range(n))}
    right = {"k": list(k[: n // 2]), "w": [i * 3 for i in range(n // 2)]}
    return left, right


def _join(pkg, data, how="inner"):
    left, right = data
    lf, rf = pkg.from_pydict(left), pkg.from_pydict(right)
    return _rows(lf.join(rf, on="k", how=how, strategy="hash").to_pydict())


def _port_delta(fn):
    b0 = memory.spill_counters_snapshot()
    out = fn()
    return out, memory.spill_counters_delta(b0)


# ----------------------------------------------------------- grace join

@pytest.mark.parametrize("how", HOWS)
def test_grace_join_all_types_null_keys(monkeypatch, how):
    """Every join type with null keys, spilled: the port equals the
    reference under the same budget and its own unbounded run (the
    materialize-and-refan path, ``SPILL_JOIN=0``)."""
    data = _join_data(n=30_000, ndv=10_000, nulls=True, seed=1)
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    got, d = _port_delta(lambda: _join(daft_tpu_torch, data, how))
    assert d.get("joins_partitioned", 0) >= 1, d
    assert d.get("bytes_written", 0) > 0 and d.get("bytes_read", 0) > 0
    assert got == _join(daft_tpu, data, how)
    _set(monkeypatch, "MEMORY_LIMIT", None)
    _set(monkeypatch, "SPILL_JOIN", "0")
    assert got == _join(daft_tpu_torch, data, how)


def test_forced_recursion_depth(monkeypatch):
    """``SPILL_PARTITIONS=2`` under-partitions on purpose: the rotated
    radix recurses, and the answer is the reference's and the unbounded
    one."""
    data = _join_data(seed=2)
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "SPILL_PARTITIONS", "2")
    got, d = _port_delta(lambda: _join(daft_tpu_torch, data))
    assert d.get("recursions", 0) >= 1
    assert any(k.startswith("recursions_d") for k in d)
    assert got == _join(daft_tpu, data)
    _set(monkeypatch, "MEMORY_LIMIT", None)
    _set(monkeypatch, "SPILL_PARTITIONS", None)
    assert got == _join(daft_tpu_torch, data)


def test_skewed_key_exhausts_depth_not_memory(monkeypatch):
    """One all-duplicate key: the depth bound trips (counted in both
    packages) and the bucket joins in memory anyway."""
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "SPILL_PARTITIONS", "2")
    _set(monkeypatch, "SPILL_MAX_DEPTH", "1")
    n = 40_000
    data = ({"k": [7] * n, "v": list(range(n))},
            {"k": [7] * 4, "w": [1, 2, 3, 4]})
    got, d = _port_delta(lambda: _join(daft_tpu_torch, data))
    assert len(got) == n * 4
    assert d.get("depth_exhausted", 0) >= 1
    b0 = ref_memory.spill_counters_snapshot()
    assert got == _join(daft_tpu, data)
    assert ref_memory.spill_counters_delta(b0).get("depth_exhausted", 0) >= 1


def test_copartitioned_pair_skew_guard(monkeypatch):
    """Two hash-repartitioned sides join pair by pair; a pair past the
    pair budget re-partitions instead of joining whole."""
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    n = 60_000

    def q(pkg):
        col = pkg.col
        left = pkg.from_pydict({"k": [i % 5 for i in range(n)],
                                "v": list(range(n))}).repartition(4, "k")
        right = pkg.from_pydict({"k": [i % 5 for i in range(50)],
                                 "w": list(range(50))}).repartition(4, "k")
        return left.join(right, on="k", strategy="hash").groupby("k") \
            .agg(col("v").count(), col("w").sum()).sort("k").to_pydict()
    got, d = _port_delta(lambda: q(daft_tpu_torch))
    assert len(got["k"]) == 5
    assert d.get("recursions", 0) >= 1
    assert got == q(daft_tpu)


def test_small_join_gathers():
    """No budget: the observed totals fit one pair, ``spill_plan_wins``
    declines the partitioned plan and ONE gathered join runs."""
    data = ({"k": [1, 2, 3], "v": [10, 20, 30]},
            {"k": [2, 3, 4], "w": [5, 6, 7]})
    got, d = _port_delta(lambda: _join(daft_tpu_torch, data))
    assert got == _join(daft_tpu, data) == [(2, 20, 5), (3, 30, 6)]
    assert d.get("joins_gathered", 0) >= 1
    assert not d.get("joins_partitioned") and not d.get("bytes_written")


@pytest.mark.parametrize("nbytes,budget", [(100 << 20, 1 << 20),
                                           (1 << 10, 1 << 20),
                                           (1 << 20, 1 << 20)])
def test_spill_plan_wins_pricing(nbytes, budget):
    """The partitioned plan wins exactly where the reference's does, and
    the decision is logged as ``spill_plan``."""
    assert costmodel.spill_plan_wins(nbytes, budget) \
        == ref_costmodel.spill_plan_wins(nbytes, budget)
    assert "spill_plan" in costmodel.decision_counts_snapshot()


# ------------------------------------------------ spill-partitioned agg

def _agg(pkg, data, **aggs):
    col = pkg.col
    df = pkg.from_pydict(data)
    return _rows(df.groupby("k").agg(
        *[getattr(col(c), op)().alias(f"{c}_{op}")
          for c, op in aggs.items()]).to_pydict())


def _agg_data(n=120_000, ndv=None, seed=3):
    rng = np.random.default_rng(seed)
    ndv = ndv or n
    return {"k": rng.integers(0, ndv, n),
            "v": rng.integers(0, 97, n).astype(np.float64),
            "c": rng.integers(0, 7, n)}


@pytest.mark.parametrize("case", ["near_unique", "skewed", "null_keys"])
def test_spilled_agg_parity(monkeypatch, case):
    """The spilling reducer (``SPILL_AGG=1``) against the reference's under
    the same budget and the port's in-memory reducer: a near-unique key,
    one giant group with a forced 2-way fanout (a bucket recursion), and
    null keys."""
    if case == "near_unique":
        data, aggs = _agg_data(), {"v": "sum", "c": "max"}
    elif case == "skewed":
        n = 100_000
        data = {"k": [0 if i % 2 else i for i in range(n)], "v": [1.0] * n}
        aggs = {"v": "sum"}
        _set(monkeypatch, "SPILL_PARTITIONS", "2")
    else:
        data = {"k": [None if i % 5 == 0 else i % 1000
                      for i in range(20_000)], "v": list(range(20_000))}
        aggs = {"v": "sum"}
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "SPILL_AGG", "1")
    got, d = _port_delta(lambda: _agg(daft_tpu_torch, data, **aggs))
    assert d.get("agg_buckets_merged", 0) > 0, d
    if case == "skewed":
        assert d.get("recursions", 0) >= 1, d
    assert got == _agg(daft_tpu, data, **aggs)
    _set(monkeypatch, "MEMORY_LIMIT", None)
    _set(monkeypatch, "SPILL_AGG", "0")
    _set(monkeypatch, "SPILL_PARTITIONS", None)
    assert got == _agg(daft_tpu_torch, data, **aggs)


def test_spilled_agg_auto_under_budget(monkeypatch):
    """``auto`` with a tiny budget and near-unique keys: the answer is the
    reference's."""
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    data = _agg_data(n=60_000)
    got = _agg(daft_tpu_torch, data, v="sum")
    assert len(got) == len(set(data["k"].tolist()))
    assert got == _agg(daft_tpu, data, v="sum")


# ---------------------------------------------- cancellation + admission

@pytest.mark.parametrize("engine", ["interp", "push"])
def test_cancellation_mid_partition_releases_admission(monkeypatch, engine):
    """Cancelling a grace join after its first pair unwinds the pair loop
    and releases every admitted byte, under either engine."""
    from daft_tpu_torch.execution import cancellation as cxl
    from daft_tpu_torch.physical.translate import translate
    from daft_tpu_torch.runners.native_runner import make_local_executor
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
    left, right = _join_data(n=40_000, ndv=40_000, seed=4)
    tok = cxl.CancelToken()
    orig = ooc._join_pair

    def cancel_after_first(*args, **kwargs):
        out = orig(*args, **kwargs)
        tok.set("test")
        return out

    monkeypatch.setattr(ooc, "_join_pair", cancel_after_first)
    builder = daft_tpu_torch.from_pydict(left).join(
        daft_tpu_torch.from_pydict(right), on="k", strategy="hash").builder
    plan = translate(builder.optimize().plan)
    with cxl.cancel_scope(tok):
        ex = make_local_executor(daft_tpu_torch.get_context()
                                 .execution_config, None)
    with pytest.raises(cxl.QueryCancelled):
        for _ in ex.run(plan):
            pass
    assert ex.host_mem.outstanding == 0 and ex.mem.outstanding == 0


# ------------------------------------------------------------ lifecycle

def _files_under(root):
    out = []
    for r, _d, files in os.walk(root):
        out.extend(os.path.join(r, f) for f in files)
    return out


def test_context_managers_close_deterministically(tmp_path):
    root = str(tmp_path / "port")
    rb = RecordBatch.from_pydict({"x": list(range(2000))})
    with memory.PartitionedSpillStore(4, budget=1) as store:
        store.push(0, rb)
        store.push(1, rb)
        store.finalize()
        assert any(e.startswith("pstore_") for e in os.listdir(root))
    assert _files_under(root) == []
    with memory.SpillBuffer(budget=1) as buf:
        buf.append(MicroPartition.from_recordbatch(rb))
        assert buf.bytes_spilled > 0
    assert _files_under(root) == []


@pytest.mark.parametrize("shape", ["grace_join", "external_sort",
                                   "hash_exchange"])
def test_no_spill_files_remain_after_query(tmp_path, monkeypatch, shape):
    """After a spilling query ends its spill directory holds no file:
    every store closes deterministically, not at GC."""
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    left, right = _join_data(n=30_000, ndv=10_000, seed=5)
    df = daft_tpu_torch.from_pydict(left)
    if shape == "grace_join":
        q = df.join(daft_tpu_torch.from_pydict(right), on="k",
                    strategy="hash")
    elif shape == "external_sort":
        q = df.sort(["k", "v"])
    else:
        q = df.repartition(8, "k")
    got, d = _port_delta(q.to_pydict)
    assert len(got["k"]) > 0 and d.get("bytes_written", 0) > 0, d
    assert _files_under(str(tmp_path / "port")) == []


# ---------------------------------------------------------- compression

def _typed_batch(n=5000):
    """Null-only strings, uint64 below 2^63, dates, decimals, dictionary
    strings and plain strings with nulls."""
    import datetime
    import decimal

    import pyarrow as pa
    base = datetime.date(2024, 1, 1)
    return RecordBatch.from_arrow_table(pa.table({
        "x": pa.array(range(n), pa.int64()),
        "u": pa.array([(1 << 62) + i for i in range(n)], pa.uint64()),
        "d": pa.array([None if i % 13 == 0
                       else base + datetime.timedelta(i % 366)
                       for i in range(n)], pa.date32()),
        "m": pa.array([decimal.Decimal(i) / 100 for i in range(n)],
                      pa.decimal128(12, 2)),
        "s": pa.array(["val%d" % (i % 50) if i % 7 else None
                       for i in range(n)]),
        "dict": pa.array(["w%d" % (i % 9) for i in range(n)])
        .dictionary_encode(),
        "nulls": pa.array([None] * n, pa.string()),
    }))


@pytest.mark.parametrize("codec", ["lz4", "zstd", "none"])
def test_spill_codec_roundtrip(monkeypatch, codec):
    """Through both spill containers and every codec, each column comes
    back with its values once cast to the declared schema (the cast every
    reader makes)."""
    monkeypatch.setenv("DAFT_TORCH_SPILL_COMPRESSION", codec)
    memory._spill_ipc_cache.clear()
    rb = _typed_batch()
    want = rb.to_pydict()
    with memory.PartitionedSpillStore(2, budget=1) as store:
        store.push(0, rb)
        store.push(1, rb)
        store.finalize()
        got = store.bucket_batches(0)
        assert sum(len(b) for b in got) == len(rb)
        assert got[0].cast_to_schema(rb.schema).to_pydict() == want
    with memory.SpillBuffer(budget=1) as buf:
        buf.append(MicroPartition.from_recordbatch(rb))
        assert buf.bytes_spilled > 0
        assert buf[0].cast_to_schema(rb.schema).to_pydict() == want
    memory._spill_ipc_cache.clear()


def test_spill_compression_shrinks_disk_bytes(tmp_path, monkeypatch):
    """lz4 spill files are smaller on disk than uncompressed ones for
    compressible data."""
    rb = RecordBatch.from_pydict({"x": [1] * 50_000})

    def disk_bytes(codec):
        monkeypatch.setenv("DAFT_TORCH_SPILL_COMPRESSION", codec)
        memory._spill_ipc_cache.clear()
        with memory.PartitionedSpillStore(1, budget=1) as store:
            store.push(0, rb)
            store.finalize()
            return sum(os.path.getsize(f)
                       for f in _files_under(str(tmp_path / "port")))
    assert disk_bytes("lz4") < disk_bytes("none")
    memory._spill_ipc_cache.clear()


# ------------------------------------------------------------- helpers

def test_rotated_radix_decorrelates():
    """Depth-1 sub-partitioning of one depth-0 bucket spreads its rows."""
    rb = RecordBatch.from_pydict({"k": list(range(100_000))})
    bucket = ooc.radix_split(rb, [daft_tpu_torch.col("k")], 8, 0)[3]
    sizes = [len(p) for p in ooc.radix_split(
        bucket, [daft_tpu_torch.col("k")], 8, 1)]
    assert sum(sizes) == len(bucket) and min(sizes) > 0
    assert max(sizes) < 2 * min(sizes)


def test_radix_depth0_matches_partition_by_hash():
    rng = np.random.default_rng(6)
    data = {"k": rng.integers(-1 << 40, 1 << 40, 10_000),
            "s": [f"s{i % 333}" for i in range(10_000)]}
    rb = RecordBatch.from_pydict(data)
    by = [daft_tpu_torch.col("k"), daft_tpu_torch.col("s")]
    for a, b in zip(ooc.radix_split(rb, by, 8, 0),
                    rb.partition_by_hash(by, 8)):
        assert a.to_pydict() == b.to_pydict()


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_radix_split_equals_the_reference_bucket_for_bucket(depth):
    """The grace buckets pair up across packages: each depth's rotated
    radix puts every row in the reference's bucket (ints with nulls and
    strings)."""
    rng = np.random.default_rng(7 + depth)
    data = {"k": [None if i % 11 == 0 else int(x)
                  for i, x in enumerate(rng.integers(0, 1 << 50, 8000))],
            "s": [f"name-{int(x)}" for x in rng.integers(0, 500, 8000)]}
    by_p = [daft_tpu_torch.col("k"), daft_tpu_torch.col("s")]
    by_r = [daft_tpu.col("k"), daft_tpu.col("s")]
    mine = ooc.radix_split(RecordBatch.from_pydict(data), by_p, 13, depth)
    ref = ref_ooc.radix_split(RefBatch.from_pydict(data), by_r, 13, depth)
    assert [p.to_pydict() for p in mine] == [p.to_pydict() for p in ref]


@pytest.mark.parametrize("est,budget", [(None, None), (10 << 30, 1 << 30),
                                        (1, 1 << 30), (5 << 20, 400_000)])
def test_plan_partitions_from_evidence(est, budget):
    assert ooc.plan_partitions(est, budget=budget) \
        == ref_ooc.plan_partitions(est, budget=budget)
    assert 2 <= ooc.plan_partitions(est, budget=budget) <= ooc._MAX_PARTITIONS \
        or est is None


def test_chaos_serialize_spilled_run_deterministic(monkeypatch):
    """Spilled execution under ``CHAOS_SERIALIZE=1`` (serial spill IO):
    two runs are bit-identical, and equal the reference's."""
    _set(monkeypatch, "MEMORY_LIMIT", "400KB")
    _set(monkeypatch, "CHAOS_SERIALIZE", "1")
    data = _join_data(n=20_000, ndv=5_000)

    def q(pkg):
        left, right = data
        return pkg.from_pydict(left).join(
            pkg.from_pydict(right), on="k", strategy="hash") \
            .groupby("k").agg(pkg.col("v").sum(), pkg.col("w").sum()) \
            .sort("k").to_pydict()

    first, d = _port_delta(lambda: q(daft_tpu_torch))
    assert d.get("bytes_written", 0) > 0, d
    assert q(daft_tpu_torch) == first
    assert first == q(daft_tpu)

