"""Equi-joins through both packages: ``joins.join_recordbatch`` and
``DataFrame.join``.

Inputs are seeded numpy columns with NULLs. The port runs with
``DAFT_TORCH_DEVICE=cpu``, where a join of at least 8192 rows (both sides
together) generates its index pairs through the device path on CPU
tensors (the plain twins of the CUDA kernels under ``hash``, the torch
sort join under ``sort``) and a smaller one on the host. The reference
runs its host path (``DAFT_TPU_DEVICE_JOIN=0``): every path of both
packages emits pairs left-major with right rows ascending, so rows match
exactly, in order, for all six join types.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import joins as ref_joins
from daft_tpu.recordbatch import RecordBatch as RefBatch
from daft_tpu_torch import joins as port_joins
from daft_tpu_torch.device import runtime
from daft_tpu_torch.recordbatch import RecordBatch as PortBatch

HOWS = ["inner", "left", "right", "outer", "semi", "anti"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TPU_DEVICE_JOIN", "0")
    monkeypatch.delenv("DAFT_TORCH_KERNEL_JOIN", raising=False)
    runtime.reset_counters()


def _with_nulls(rng, vals, frac):
    out = list(vals.tolist())
    for i in np.flatnonzero(rng.random(len(out)) < frac):
        out[i] = None
    return out


def _sides(kind, n_l, n_r, seed=0):
    """(left dict, right dict, left_on, right_on) for one key kind."""
    rng = np.random.default_rng(seed)
    kmax = max(n_r, 4)  # about one match per left row
    lk = rng.integers(0, kmax, n_l)
    rk = rng.integers(0, kmax, n_r)
    left = {"id": list(range(n_l)), "x": rng.normal(size=n_l).tolist()}
    right = {"rid": list(range(n_r)), "x": rng.normal(size=n_r).tolist()}
    if kind == "int":
        left["k"] = _with_nulls(rng, lk, 0.05)
        right["k"] = _with_nulls(rng, rk, 0.05)
        return left, right, ["k"], ["k"]
    if kind == "string":
        left["s"] = _with_nulls(rng, np.array([f"key{v}" for v in lk]), 0.05)
        right["t"] = _with_nulls(rng, np.array([f"key{v}" for v in rk]),
                                 0.05)
        return left, right, ["s"], ["t"]
    if kind == "multi":
        left["a"] = _with_nulls(rng, lk % 7, 0.05)
        left["b"] = _with_nulls(rng, np.array([f"b{v // 7}" for v in lk]),
                                0.05)
        right["a"] = _with_nulls(rng, rk % 7, 0.05)
        right["c"] = _with_nulls(rng, np.array([f"b{v // 7}" for v in rk]),
                                 0.05)
        return left, right, ["a", "b"], ["a", "c"]
    # int keys on the left, float keys on the right: joined in the
    # supertype (float64)
    left["k"] = _with_nulls(rng, lk.astype(np.int32), 0.05)
    right["f"] = _with_nulls(rng, rk.astype(np.float64), 0.05)
    return left, right, ["k"], ["f"]


def _join_both(kind, how, n_l, n_r):
    left, right, lo, ro = _sides(kind, n_l, n_r)
    rc = daft_tpu.col
    pc = daft_tpu_torch.col
    ref = ref_joins.join_recordbatch(
        RefBatch.from_pydict(left), RefBatch.from_pydict(right),
        [rc(c) for c in lo], [rc(c) for c in ro], how).to_pydict()
    got = port_joins.join_recordbatch(
        PortBatch.from_pydict(left), PortBatch.from_pydict(right),
        [pc(c) for c in lo], [pc(c) for c in ro], how).to_pydict()
    return got, ref


@pytest.mark.parametrize("kind", ["int", "string", "multi", "int_float"])
@pytest.mark.parametrize("how", HOWS)
def test_join_recordbatch_matches_reference_on_the_device_path(kind, how):
    got, ref = _join_both(kind, how, 5000, 4000)
    assert got == ref
    c = runtime.counters()
    if how in ("semi", "anti"):
        assert c == {}
    else:
        assert c == {"join_hash": 1}


@pytest.mark.parametrize("how", HOWS)
def test_join_recordbatch_matches_reference_on_the_host_path(how):
    got, ref = _join_both("multi", how, 300, 200)
    assert got == ref
    c = runtime.counters()
    assert c == ({} if how in ("semi", "anti") else {"host_joins": 1})


@pytest.mark.parametrize("how", ["inner", "outer"])
def test_sort_strategy_matches_reference(monkeypatch, how):
    monkeypatch.setenv("DAFT_TORCH_KERNEL_JOIN", "sort")
    got, ref = _join_both("int", how, 5000, 4000)
    assert got == ref
    assert runtime.counters() == {"join_sort": 1}


def test_unknown_join_strategy_raises(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_KERNEL_JOIN", "radix")
    with pytest.raises(ValueError, match="DAFT_TORCH_KERNEL_JOIN"):
        _join_both("int", "inner", 5000, 4000)


def test_host_tier_runs_large_joins_on_the_host(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    got, ref = _join_both("int", "left", 5000, 4000)
    assert got == ref
    assert runtime.counters() == {"host_joins": 1}


def test_many_to_many_overflow_redispatches_once():
    """A total past the first (foreign-key sized) bucket re-dispatches at
    the bucket of the true total: two device dispatches, exact pairs."""
    rng = np.random.default_rng(1)
    left = {"k": rng.integers(0, 500, 6000).tolist()}
    right = {"k": rng.integers(0, 500, 3000).tolist(),
             "v": list(range(3000))}
    rc, pc = daft_tpu.col, daft_tpu_torch.col
    ref = ref_joins.join_recordbatch(
        RefBatch.from_pydict(left), RefBatch.from_pydict(right),
        [rc("k")], [rc("k")], "inner").to_pydict()
    got = port_joins.join_recordbatch(
        PortBatch.from_pydict(left), PortBatch.from_pydict(right),
        [pc("k")], [pc("k")], "inner").to_pydict()
    assert len(got["k"]) > 8192 and got == ref
    assert runtime.counters() == {"join_hash": 2}


def _frames(pkg, n_l=3000, n_r=6000, seed=2):
    left, right, _, _ = _sides("int", n_l, n_r, seed)
    right["k2"] = right.pop("k")
    return pkg.from_pydict(left), pkg.from_pydict(right)


def _rows(d):
    names = sorted(d)
    return sorted(zip(*[d[n] for n in names]),
                  key=lambda r: tuple((v is None, v) for v in r)), names


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("strategy", [None, "hash", "broadcast"])
def test_dataframe_join_matches_reference(how, strategy):
    rl, rr = _frames(daft_tpu)
    pl, pr = _frames(daft_tpu_torch)
    ref = rl.join(rr, left_on="k", right_on="k2", how=how,
                  strategy=strategy).to_pydict()
    got = pl.join(pr, left_on="k", right_on="k2", how=how,
                  strategy=strategy).to_pydict()
    assert list(got) == list(ref)
    assert _rows(got) == _rows(ref)
    if how not in ("semi", "anti"):
        assert runtime.counters().get("join_hash", 0) >= 1


def test_dataframe_join_prefixes_colliding_names_and_filters_sides():
    """``x`` on both sides: the right one becomes ``right.x``; a filter on
    each side's columns above the join moves below it, and the answer is
    the reference's."""
    out = {}
    for pkg in (daft_tpu, daft_tpu_torch):
        l, r = _frames(pkg, 400, 500)
        c = pkg.col
        df = (l.join(r, left_on="k", right_on="k2")
              .where((c("x") > 0) & (c("right.x") < 0.5) & (c("id") < 300)))
        out[pkg.__name__] = df.to_pydict()
    got, ref = out["daft_tpu_torch"], out["daft_tpu"]
    assert "right.x" in got and list(got) == list(ref)
    assert _rows(got) == _rows(ref)

    from daft_tpu_torch.logical import plan as lp
    l, r = _frames(daft_tpu_torch, 400, 500)
    c = daft_tpu_torch.col
    plan = (l.join(r, left_on="k", right_on="k2")
            .where((c("x") > 0) & (c("right.x") < 0.5))
            .builder.optimize().plan)
    assert isinstance(plan, lp.Join)
    assert all(isinstance(ch, lp.Filter) for ch in plan.children)


def test_join_projection_pruning_reaches_the_scans(tmp_path):
    """Only the columns the query reads (plus the keys) are scanned."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.table({"k": [1, 2, 3], "a": [1.0, 2.0, 3.0],
                             "junk": ["x", "y", "z"]}), tmp_path / "l.parquet")
    pq.write_table(pa.table({"k2": [1, 1, 3], "b": [4, 5, 6],
                             "junk2": ["p", "q", "r"]}),
                   tmp_path / "r.parquet")
    l = daft_tpu_torch.read_parquet(str(tmp_path / "l.parquet"))
    r = daft_tpu_torch.read_parquet(str(tmp_path / "r.parquet"))
    q = l.join(r, left_on="k", right_on="k2").select("a", "b")
    plan = q.builder.optimize().plan
    scans = []

    def walk(n):
        if not n.children:
            scans.append(n.schema().column_names)
        for ch in n.children:
            walk(ch)
    walk(plan)
    assert sorted(map(sorted, scans)) == [["a", "k"], ["b", "k2"]]
    d = q.to_pydict()
    assert sorted(zip(d["a"], d["b"])) == [(1.0, 4), (1.0, 5), (3.0, 6)]


@pytest.mark.parametrize("how,strategy", [("left", "broadcast_left"),
                                          ("outer", "broadcast_right"),
                                          ("right", "broadcast_right")])
def test_broadcasting_a_preserved_side_is_refused(how, strategy):
    l, r = _frames(daft_tpu_torch, 10, 10)
    with pytest.raises(ValueError, match="cannot run"):
        l.join(r, left_on="k", right_on="k2", how=how,
               strategy=strategy).to_pydict()


def test_cross_join_is_not_ported_yet():
    l, r = _frames(daft_tpu_torch, 10, 10)
    with pytest.raises(NotImplementedError, match="cross"):
        l.join(r, how="cross")


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_overflow_probes_the_one_table_again(monkeypatch, how):
    """A many-to-many join past the first bucket builds the hash table
    once and probes it at the grown capacity: one build, two probes, two
    ``join_hash`` dispatches, the reference's rows."""
    from daft_tpu_torch.device import join_kernels as jk
    calls = {"build": 0, "probe": 0}
    build, probe = jk.hash_join_build, jk.hash_join_probe

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run
    monkeypatch.setattr(jk, "hash_join_build", counted("build", build))
    monkeypatch.setattr(jk, "hash_join_probe", counted("probe", probe))
    rng = np.random.default_rng(3)
    left = {"k": _with_nulls(rng, rng.integers(0, 400, 5000), 0.05)}
    right = {"k": _with_nulls(rng, rng.integers(0, 400, 4000), 0.05),
             "v": list(range(4000))}
    rc, pc = daft_tpu.col, daft_tpu_torch.col
    ref = ref_joins.join_recordbatch(
        RefBatch.from_pydict(left), RefBatch.from_pydict(right),
        [rc("k")], [rc("k")], how).to_pydict()
    got = port_joins.join_recordbatch(
        PortBatch.from_pydict(left), PortBatch.from_pydict(right),
        [pc("k")], [pc("k")], how).to_pydict()
    assert len(got["k"]) > 16384 and got == ref
    assert calls == {"build": 1, "probe": 2}
    assert runtime.counters() == {"join_hash": 2}
