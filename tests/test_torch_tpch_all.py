"""All 22 TPC-H queries, as DataFrame code, three ways: the port's device
tier on CPU tensors (``DAFT_TORCH_DEVICE=cpu``, with the per-operator
paths' row floor at 0 so every operator that has a device path takes it),
the port's host tier (``device="0"``), and ``daft_tpu`` on JAX-CPU.

Data: the fixture size of ``tests/test_tpch.py`` (SF 0.003, 3 files per
table, seed 42). Every query ends in a sort (or returns one row), so the
answers compare row for row: keys, counts, integers and strings exactly,
floats at relative 1e-9 (``tests/test_tpch.py``).
"""

import pytest

import daft_tpu
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch

REL = 1e-9


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_all")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


def _port(root, q, device, monkeypatch):
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", device)
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    # every priced decision (the fused fragment, the joins) on the device
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    runtime.reset_counters()
    out = Q.ALL[q](_reader(daft_tpu_torch, root)).to_pydict()
    return out, runtime.counters()


def _same(got, want, what):
    assert list(got) == list(want), what
    for c in want:
        assert len(got[c]) == len(want[c]), (what, c)
        for a, b in zip(got[c], want[c]):
            if isinstance(b, float) and isinstance(a, float):
                assert abs(a - b) <= REL * max(abs(a), abs(b)), \
                    (what, c, a, b)
            else:
                assert a == b, (what, c, a, b)


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_query_matches_reference_and_host_tier(tpch_root, monkeypatch, q):
    want = RQ.ALL[q](_reader(daft_tpu, tpch_root)).to_pydict()
    device, counts = _port(tpch_root, q, "cpu", monkeypatch)
    host, host_counts = _port(tpch_root, q, "0", monkeypatch)
    _same(device, want, f"q{q} device tier vs daft_tpu")
    _same(host, want, f"q{q} host tier vs daft_tpu")
    assert counts.get("host_morsels", 0) == 0, counts
    device_keys = ("projection", "predicate", "argsort", "agg_hash",
                   "agg_sort", "agg_global", "dense", "hash", "sort",
                   "global", "join_hash", "join_sort")
    assert not any(host_counts.get(k) for k in device_keys), host_counts


def _q1_reducers(root):
    """The reducers of Q1's final aggregate that hold some of its four
    groups: the groups' keys hashed as its hash exchange hashes them (the
    reference's plan: partial, hash exchange, final), over that
    exchange's partition count."""
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    from daft_tpu_torch.recordbatch import RecordBatch
    exchanges = []

    def walk(n):
        if isinstance(n, pp.Exchange) and n.kind == "hash":
            exchanges.append(n)
        for c in n.children:
            walk(c)
    walk(translate(Q.q1(_reader(daft_tpu_torch, root)).builder.optimize()
                   .plan))
    (ex,) = exchanges
    groups = RQ.q1(_reader(daft_tpu, root)).to_pydict()
    keys = RecordBatch.from_pydict({c: groups[c] for c in
                                    ("l_returnflag", "l_linestatus")})
    assert len(keys) == 4
    return sum(1 for p in keys.partition_by_hash(list(ex.by),
                                                 ex.num_partitions)
               if len(p))


def test_device_tier_dispatches_every_per_operator_path(tpch_root,
                                                        monkeypatch):
    """Over Q1, Q3, Q5 and Q14: every per-operator path dispatches, and
    Q1 keeps its fused dense route. Q1's per-operator aggs are its final
    merges, sums over the partial counts, which ride an int64 plane since
    uint64 below 2^63 has one: one for each reducer of the final
    aggregate that holds some of Q1's groups (:func:`_q1_reducers`). Hash
    asked for past Q1: ``auto`` on CPU tensors is sort (Q1's dense route
    needs ``auto``)."""
    total = {}
    for q in (1, 3, 5, 14):
        monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY",
                           "auto" if q == 1 else "hash")
        _, counts = _port(tpch_root, q, "cpu", monkeypatch)
        if q == 1:
            assert counts.get("dense", 0) > 0, counts
            assert counts.get("agg_hash", 0) \
                + counts.get("agg_sort", 0) == _q1_reducers(tpch_root), counts
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for k in ("projection", "predicate", "argsort", "agg_hash", "agg_sort",
              "agg_global"):
        assert total.get(k, 0) > 0, (k, total)


def test_default_floor_keeps_small_operators_on_the_host(tpch_root,
                                                         monkeypatch):
    """At the default floor (4096 rows) this data's post-join operators
    are small: they run on the host and count ``host_ops``; the answer
    is unchanged."""
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("DAFT_TORCH_DEVICE_MIN_ROWS", raising=False)
    runtime.reset_counters()
    got = Q.q3(_reader(daft_tpu_torch, tpch_root)).to_pydict()
    counts = runtime.counters()
    assert counts.get("host_ops", 0) > 0, counts
    assert not counts.get("agg_sort") and not counts.get("argsort"), counts
    _same(got, RQ.q3(_reader(daft_tpu, tpch_root)).to_pydict(), "q3")


def test_shared_subplan_runs_once(tpch_root, monkeypatch):
    """Q15 reads its ``revenue`` DataFrame twice (the rows and their
    maximum): one physical node with two consumers, lineitem scanned
    once, so the equality against the maximum sees one set of sums."""
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.io import scan
    from daft_tpu_torch.physical.translate import translate
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    df = Q.q15(_reader(daft_tpu_torch, tpch_root))
    shared = []

    def walk(n):
        if getattr(n, "shared_consumers", 1) > 1:
            shared.append(n.shared_consumers)
        for ch in n.children:
            walk(ch)
    walk(translate(df.builder.optimize().plan))
    assert shared and set(shared) == {2}
    paths = []
    execute = scan.ScanTask.execute

    def counted(self, *a, **k):
        paths.extend(self.paths)
        return execute(self, *a, **k)
    monkeypatch.setattr(scan.ScanTask, "execute", counted)
    # an empty device column cache: a cached lineitem task is not read
    from daft_tpu_torch.device import cache
    cache.get_cache().clear()
    got = df.to_pydict()
    assert len(got["s_suppkey"]) == 1
    li = [p for p in paths if "lineitem" in p]
    assert len(li) == len(set(li)) == 3
