"""The port's memory budget and spill tier (``daft_tpu_torch/execution/
memory.py``) and the breakers that stream through it: the external sort
and the streaming hash, random, range and split exchanges under a
``400KB`` budget, held to ``daft_tpu`` under the same budget
(``DAFT_TPU_MEMORY_LIMIT``, JAX on the CPU) and to the port's unbounded
run, on the same numpy-seeded inputs.

The parity subset of ``tests/test_memory.py``, plus the breakers of
``tests/test_out_of_core.py``'s budget. A sort is compared as the
sequence of its key tuples, and the rows within equal keys as a multiset;
a partitioned output partition by partition, each as a multiset. Values
compare exactly (tolerance 0: integers, strings, and floats that are
moved, never summed).
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution import memory as ref_memory
from daft_tpu_torch import col
from daft_tpu_torch.execution import memory
from daft_tpu_torch.execution.executor import LocalExecutor
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.recordbatch import RecordBatch

PKGS = {"ref": daft_tpu, "port": daft_tpu_torch}


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_SPILL_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DAFT_TPU_SPILL_DIR", str(tmp_path / "ref"))
    for v in ("DAFT_TPU_MEMORY_LIMIT", "DAFT_TORCH_MEMORY_LIMIT"):
        monkeypatch.delenv(v, raising=False)
    memory._spill_dir = ref_memory._spill_dir = None
    yield
    memory._spill_dir = ref_memory._spill_dir = None


def _budget(monkeypatch, value):
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        if value is None:
            monkeypatch.delenv(pre + "MEMORY_LIMIT", raising=False)
        else:
            monkeypatch.setenv(pre + "MEMORY_LIMIT", value)


def _mp(n, base=0):
    return MicroPartition.from_recordbatch(
        RecordBatch.from_pydict({"x": list(range(base, base + n))}))


def _key(v):
    return (v is None, v)


def _multiset(d):
    keys = list(d)
    return sorted(zip(*[d[k] for k in keys]),
                  key=lambda r: tuple(_key(v) for v in r))


def _data(n=60_000, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": [None if i % 101 == 0 else int(x) for i, x in
                  enumerate(rng.integers(0, 5_000, n))],
            "s": [f"name-{int(x)}" for x in rng.integers(0, 300, n)],
            "v": rng.random(n).tolist(),
            "i": list(range(n))}


# ------------------------------------------------------------- basics

@pytest.mark.parametrize("text", ["4GB", "512MiB", "100", "2k", "1TB",
                                  "1TiB", "400KB", "1.5G"])
def test_parse_bytes_matches_the_reference(text):
    assert memory.parse_bytes(text) == ref_memory.parse_bytes(text)


def test_bad_memory_limit_is_hard_error(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_MEMORY_LIMIT", "lots")
    with pytest.raises(ValueError, match="DAFT_TORCH_MEMORY_LIMIT"):
        memory.memory_limit_bytes()


def test_breaker_budget_is_the_limit_else_a_quarter_of_ram(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_MEMORY_LIMIT", "400KB")
    assert memory.breaker_budget_bytes() == 400_000
    monkeypatch.delenv("DAFT_TORCH_MEMORY_LIMIT")
    assert memory.breaker_budget_bytes() >= 256 << 20


def test_spill_buffer_roundtrip_under_budget():
    buf = memory.SpillBuffer(budget=None)
    for i in range(3):
        buf.append(_mp(10, i * 10))
    assert len(buf) == 3 and buf.bytes_spilled == 0
    assert [v for p in buf for v in p.to_pydict()["x"]] == list(range(30))


def test_spill_buffer_spills_and_reloads(tmp_path):
    buf = memory.SpillBuffer(budget=1)  # everything after the 1st to disk
    for i in range(4):
        buf.append(_mp(100, i * 100))
    assert buf.bytes_spilled > 0
    root = tmp_path / "port"
    assert any(p.suffix == ".arrow" for p in root.iterdir())
    for _ in range(2):  # multi-pass iteration reloads, order kept
        assert [v for p in buf for v in p.to_pydict()["x"]] \
            == list(range(400))
    assert buf[2].to_pydict()["x"][0] == 200
    assert [p.to_pydict()["x"][0] for p in buf[1:]] == [100, 200, 300]
    buf.close()
    assert not any(p.suffix == ".arrow" for p in root.iterdir())


def test_memory_manager_admission():
    mm = memory.MemoryManager(budget=100)
    mm.acquire(60)
    state = {"entered": False}

    def second():
        mm.acquire(60)  # blocks until the release
        state["entered"] = True
        mm.release(60)

    t = threading.Thread(target=second)
    t.start()
    t.join(timeout=0.2)
    assert not state["entered"]
    mm.release(60)
    t.join(timeout=2)
    assert state["entered"] and mm.outstanding == 0


def test_memory_manager_oversized_request_admitted_when_idle():
    mm = memory.MemoryManager(budget=10)
    mm.acquire(100)  # larger than the budget; nothing held → no deadlock
    mm.release(100)


def test_query_with_spill_matches_no_spill(monkeypatch):
    """Hash repartition + group-by + sort under a 1KB budget: the
    reference's answer and the unbounded one."""
    data = {"k": [i % 13 for i in range(5000)], "v": list(range(5000))}

    def q(pkg):
        return (pkg.from_pydict(data).repartition(4, "k")
                .groupby("k").agg(pkg.col("v").sum().alias("s"))
                .sort("k").to_pydict())
    want = q(daft_tpu_torch)
    _budget(monkeypatch, "1KB")
    assert q(daft_tpu_torch) == want == q(daft_tpu)


def test_hash_join_mismatched_partition_counts_correct():
    """A partition-count mismatch never pairs unrelated partitions."""
    lparts = [MicroPartition.from_pydict(
        {"k": list(range(i * 10, i * 10 + 10)),
         "x": list(range(i * 10, i * 10 + 10))}) for i in range(4)]
    rparts = [MicroPartition.from_pydict(
        {"k": list(range(0, 40, 2))[i::2],
         "y": list(range(20))[i::2]}) for i in range(2)]
    node = pp.HashJoin(
        pp.InMemorySource(lparts, lparts[0].schema),
        pp.InMemorySource(rparts, rparts[0].schema),
        [col("k")], [col("k")], "inner", None, "hash")
    out = list(LocalExecutor().run(node))
    assert sorted(v for p in out for v in p.to_pydict()["k"]) \
        == list(range(0, 40, 2))


def test_hash_join_buckets_past_the_budget(monkeypatch):
    """Past the pair budget the join spill-partitions BOTH sides and emits
    one output per bucket pair."""
    n = 5000
    lparts = [MicroPartition.from_pydict(
        {"k": list(range(n)), "x": list(range(n))})]
    rparts = [MicroPartition.from_pydict(
        {"k": list(range(0, 2 * n, 2)), "y": list(range(n))})]
    monkeypatch.setattr(memory, "breaker_budget_bytes", lambda: 64 * 1024)
    node = pp.HashJoin(
        pp.InMemorySource(lparts, lparts[0].schema),
        pp.InMemorySource(rparts, rparts[0].schema),
        [col("k")], [col("k")], "inner", None, "hash")
    out = list(LocalExecutor().run(node))
    assert len(out) > 1
    assert sorted(v for p in out for v in p.to_pydict()["k"]) \
        == list(range(0, n, 2))


# ------------------------------------------------------ external sort

def _sorted_groups(d, keys):
    """(key tuples in order, rows grouped by equal keys as multisets)."""
    names = list(d)
    rows = list(zip(*[d[c] for c in names]))
    kidx = [names.index(k) for k in keys]
    seq = [tuple(r[i] for i in kidx) for r in rows]
    groups, cur, last = [], [], object()
    for kt, r in zip(seq, rows):
        if kt != last and cur:
            groups.append(sorted(cur, key=lambda x: tuple(map(_key, x))))
            cur = []
        cur.append(r)
        last = kt
    if cur:
        groups.append(sorted(cur, key=lambda x: tuple(map(_key, x))))
    return seq, groups


@pytest.mark.parametrize("keys,desc,nulls_first", [
    (["k"], False, None),
    (["k", "s"], [True, False], None),
    (["s", "k"], False, True),
    (["v"], True, False)])
def test_external_sort_parity(monkeypatch, keys, desc, nulls_first):
    """The streaming external sort under 400KB: the reference's key
    sequence (rows within equal keys as a multiset), and the port's
    unbounded sort's."""
    data = _data()

    def q(pkg):
        return pkg.from_pydict(data).sort(keys, desc=desc,
                                          nulls_first=nulls_first) \
            .to_pydict()
    unbounded = _sorted_groups(q(daft_tpu_torch), keys)
    _budget(monkeypatch, "400KB")
    b0 = memory.spill_counters_snapshot()
    got = _sorted_groups(q(daft_tpu_torch), keys)
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
    assert got == unbounded
    if nulls_first is None or nulls_first == desc:
        # the reference's range partitioning places nulls by `descending`
        # alone; its answer is the sort's where the two agree
        assert got == _sorted_groups(q(daft_tpu), keys)


# -------------------------------------------------- streaming exchanges

def _partitions(pkg, df):
    return [_multiset(p.to_pydict()) for p in df.iter_partitions()]


@pytest.mark.parametrize("kind", ["hash", "random", "split"])
def test_streaming_exchange_partitions_match_the_reference(monkeypatch,
                                                           kind):
    """hash, random and split exchanges under 400KB: every partition holds
    the reference's rows (the same hash chain, the same random draws, the
    same split points) and the port's unbounded run's."""
    data = _data(seed=1)

    def q(pkg):
        df = pkg.from_pydict(data)
        if kind == "hash":
            df = df.repartition(6, "k", "s")
        elif kind == "random":
            df = df.repartition(6)
        else:
            df = df.into_partitions(6)
        return _partitions(pkg, df)
    unbounded = q(daft_tpu_torch)
    _budget(monkeypatch, "400KB")
    b0 = memory.spill_counters_snapshot()
    got = q(daft_tpu_torch)
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
    assert len(got) == 6
    assert got == unbounded == q(daft_tpu)


@pytest.mark.parametrize("desc", [False, True])
def test_streaming_range_exchange(monkeypatch, desc):
    """A range exchange under 400KB: the partitions hold contiguous key
    ranges in order (boundaries are sampled, so the cut points are the
    engine's own) and together the input's rows, as in the reference."""
    from daft_tpu.logical import plan as ref_lp
    from daft_tpu_torch.logical import plan as lp
    data = _data(seed=2)

    def q(pkg, mod):
        df = pkg.from_pydict(data)
        spec = mod.ClusteringSpec("range", 5, (pkg.col("i"),), (desc,))
        b = type(df._builder)(mod.Repartition(df._builder._plan, spec))
        return [p.to_pydict() for p in pkg.DataFrame(b).iter_partitions()]

    def check(parts):
        assert len(parts) == 5
        spans = [(min(p["i"]), max(p["i"])) for p in parts if p["i"]]
        order = spans[::-1] if desc else spans
        for (lo1, hi1), (lo2, hi2) in zip(order, order[1:]):
            assert hi1 < lo2
        rows = _multiset({c: [v for p in parts for v in p[c]]
                          for c in data})
        assert rows == _multiset(data)
    _budget(monkeypatch, "400KB")
    b0 = memory.spill_counters_snapshot()
    check(q(daft_tpu_torch, lp))
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
    check(q(daft_tpu, ref_lp))


def _range_pids(mod, data, by, bounds, desc, nulls_first=None):
    """Each row's partition under ``mod``'s ``partition_by_range`` with
    the given boundaries (read back through a row-index column)."""
    rb = mod.RecordBatch.from_pydict(dict(data, i=list(range(len(data["k"])))))
    kw = {} if nulls_first is None else {"nulls_first": nulls_first}
    parts = rb.partition_by_range([mod.col(c) for c in by],
                                  mod.RecordBatch.from_pydict(bounds), desc,
                                  **kw)
    pid = [None] * len(rb)
    for j, p in enumerate(parts):
        for i in p.to_pydict()["i"]:
            pid[i] = j
    return pid


def _range_data(seed):
    rng = np.random.default_rng(seed)
    n = 400
    k = rng.integers(0, 6, n).tolist()
    s = [f"s{v}" for v in rng.integers(0, 4, n)]
    f = np.round(rng.random(n) * 4, 1).tolist()
    for i in rng.choice(n, 40, replace=False):
        k[i] = None
    for i in rng.choice(n, 40, replace=False):
        s[i] = None
    for i in rng.choice(n, 40, replace=False):
        f[i] = None
    return {"k": k, "s": s, "f": f}


class _Pkg:
    def __init__(self, rb_mod, col):
        self.RecordBatch = rb_mod.RecordBatch
        self.col = col


def _range_pkgs():
    import daft_tpu.recordbatch as ref_rb
    import daft_tpu_torch.recordbatch as port_rb
    return _Pkg(ref_rb, daft_tpu.col), _Pkg(port_rb, daft_tpu_torch.col)


@pytest.mark.parametrize("by,bounds,desc", [
    # keys equal to each boundary, nulls (last) in the key
    (["k"], {"k": [1, 3, 3, 4]}, [False]),
    # descending: boundaries in descending order, nulls first
    (["k"], {"k": [5, 3, 1]}, [True]),
    (["f"], {"f": [0.5, 2.0, 3.5]}, [False]),
    # two keys, the second descending, ties on the first; a null boundary
    (["k", "s"], {"k": [1, 2, 2, 4], "s": ["s2", "s3", "s1", None]},
     [False, True]),
    (["s", "k"], {"s": ["s3", "s1"], "k": [None, 2]}, [True, False]),
])
def test_range_partition_ids_match_the_reference(by, bounds, desc):
    """``partition_by_range`` row by row: the port's one sort of rows and
    boundaries gives every row the reference's partition (its row-by-row
    compare), ties with a boundary, nulls, descending and two keys
    included."""
    ref, port = _range_pkgs()
    data = _range_data(seed=7)
    want = _range_pids(ref, data, by, bounds, desc)
    assert len(set(want)) >= 3  # the rows spread over the partitions
    assert _range_pids(port, data, by, bounds, desc) == want


def test_range_partition_nulls_first_is_the_ports_own_option():
    """The reference's ``partition_by_range`` places nulls by ``descending``
    alone. The port's ``nulls_first`` (the sort's option) moves null keys
    to the first partition of an ascending key; every other row keeps the
    reference's partition."""
    ref, port = _range_pkgs()
    data = _range_data(seed=8)
    bounds = {"k": [1, 3, 4]}
    want = _range_pids(ref, data, ["k"], bounds, [False])
    got = _range_pids(port, data, ["k"], bounds, [False], nulls_first=[True])
    for v, g, w in zip(data["k"], got, want):
        assert g == (0 if v is None else w)
    assert _range_pids(port, data, ["k"], bounds, [False],
                       nulls_first=[False]) == want


@pytest.mark.parametrize("desc", [False, True])
def test_range_partition_places_nan_where_the_sort_does(desc):
    """NaN: the reference's row-by-row compare finds NaN neither above nor
    below a boundary, so it puts NaN in the first partition, while its own
    sort (and the port's) puts NaN after every number in either order. The
    port puts NaN where the sort does, in the last partition, so a
    range-partitioned sort keeps the whole sort's order; every other row
    keeps the reference's partition."""
    ref, port = _range_pkgs()
    data = _range_data(seed=9)
    for i in range(0, 400, 37):
        data["f"][i] = float("nan")
    bounds = {"f": [3.0, 1.5, 0.5] if desc else [0.5, 1.5, 3.0]}
    want = _range_pids(ref, data, ["f"], bounds, [desc])
    got = _range_pids(port, data, ["f"], bounds, [desc])
    nan = [v is not None and v != v for v in data["f"]]
    assert sum(nan) > 0
    for is_nan, g, w in zip(nan, got, want):
        if is_nan:
            assert (w, g) == (0, 3)
        else:
            assert g == w
    rb = port.RecordBatch.from_pydict(data)
    parts = rb.partition_by_range([port.col("f")],
                                  port.RecordBatch.from_pydict(bounds),
                                  [desc])
    whole = rb.sort([port.col("f")], [desc]).to_pydict()["f"]
    pieced = [v for p in parts
              for v in p.sort([port.col("f")], [desc]).to_pydict()["f"]]
    same = lambda a, b: a == b or (a != a and b != b)  # noqa: E731
    assert len(pieced) == len(whole)
    assert all(same(a, b) for a, b in zip(pieced, whole))


def test_spill_cache_hash_exchange_matches_the_bucket_store(monkeypatch):
    """``shuffle_algorithm="spill_cache"`` writes every bucket to disk and
    gives the same partitions as the bucket store."""
    data = _data(n=20_000, seed=3)
    df = daft_tpu_torch.from_pydict(data).repartition(4, "k")
    want = _partitions(daft_tpu_torch, df)
    b0 = memory.spill_counters_snapshot()
    with daft_tpu_torch.execution_config_ctx(shuffle_algorithm="spill_cache"):
        got = _partitions(daft_tpu_torch, df)
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
    assert got == want


def test_typed_columns_survive_a_spilled_exchange(monkeypatch):
    """Null-only strings, uint64 below 2^63, dates, decimals and
    dictionary strings through a spilling hash exchange and group-by come
    back with the values the unbounded run gives."""
    import datetime
    import decimal
    n = 20_000
    t = pa.table({
        "k": pa.array([i % 97 for i in range(n)], pa.int64()),
        "u": pa.array([(1 << 62) + i for i in range(n)], pa.uint64()),
        "d": pa.array([datetime.date(2024, 1, 1)
                       + datetime.timedelta(i % 300) for i in range(n)],
                      pa.date32()),
        "m": pa.array([decimal.Decimal(i % 1000) / 100 for i in range(n)],
                      pa.decimal128(12, 2)),
        "w": pa.array(["w%d" % (i % 9) for i in range(n)])
        .dictionary_encode(),
        "nulls": pa.array([None] * n, pa.string())})

    def q():
        df = daft_tpu_torch.from_arrow(t).repartition(5, "k")
        return _multiset(df.to_pydict())
    want = q()
    _budget(monkeypatch, "400KB")
    b0 = memory.spill_counters_snapshot()
    assert q() == want
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
