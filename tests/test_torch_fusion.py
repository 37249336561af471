"""Fusion regions through the port (``daft_tpu_torch/physical/fusion.py``,
the region programs of ``device/fragment.py``, the executor's
``_exec_FusedRegion``) held to ``daft_tpu``: the cases of
``tests/test_fusion.py``.

- Planner: the port proposes exactly the reference's regions (shape and
  fused operators) for the chain, topk and join_agg shapes, declines
  string group keys, honours the ``MAX_OPS`` cap, and plans none with
  fusion off; on the TPC-DS queries that hold ``join_agg`` regions at
  scale 0.01 (1, 32, 51, 59, 65, 77, 92, 97: eleven regions) and on TPC-H
  Q17, and the region programs lower exactly where the reference's do.
- Parity three ways (the fused region, the per-operator device tier with
  fusion off, the host tier), each against the reference's answer.
- Both overflow ladders: the chain's width rung and join_agg's pair width
  W and group bucket.
- ``warmup_regions`` and the ``region`` ledger family.

The reference's cancellation case (``test_fusion.py:276``, admission
released when the output stream closes mid-region) waits for the port's
``execution/cancellation.py`` (ROADMAP A6).

Every port run is on CPU tensors (``DAFT_TORCH_DEVICE=cpu``), with every
priced decision on the device and every region admitted, as the
reference's file runs.
"""

import numpy as np
import pytest

import daft_tpu
from benchmarking.tpcds import queries as RDS
from benchmarking.tpcds.datagen import generate_tpcds
from benchmarking.tpch import queries as RQH
from benchmarking.tpch.datagen import generate_tpch


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_DEVICE", "1")
    monkeypatch.setenv("DAFT_TPU_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TPU_FUSION", "1")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TORCH_FUSION", "1")
    yield


def _port():
    import daft_tpu_torch
    return daft_tpu_torch


def _data(n=4000, seed=7, ndv=50):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.normal(size=n),
        "k": rng.integers(0, ndv, n).astype(np.int64),
        "s": rng.choice(["x", "y", "z"], n).tolist(),
    }


def _build(nkeys=40, seed=1):
    rng = np.random.default_rng(seed)
    return {"k2": np.arange(0, nkeys, dtype=np.int64),
            "w": rng.normal(size=nkeys),
            "g": (np.arange(nkeys, dtype=np.int64) % 5)}


def _chain_query(pkg, d):
    col = pkg.col
    return pkg.from_pydict(d).where(col("a") > 30).select(
        (col("b") * 2.0).alias("b2"), col("a"))


def _topk_query(pkg, d):
    col = pkg.col
    return (pkg.from_pydict(d).where(col("a") > 10)
            .select(col("a"), col("b")).sort(col("b"), desc=True).limit(9))


def _join_agg_query(pkg, d, b):
    col = pkg.col
    j = pkg.from_pydict(d).where(col("a") > 20).join(
        pkg.from_pydict(b), left_on=col("k"), right_on=col("k2"),
        how="inner")
    return j.groupby(col("g")).agg(
        (col("b") * col("w")).sum().alias("rev"),
        col("b").count().alias("n"))


def _string_keys_query(pkg, d, b):
    col = pkg.col
    return pkg.from_pydict(d).join(
        pkg.from_pydict(b), left_on=col("k"), right_on=col("k2"),
        how="inner").groupby(col("s")).agg(col("b").sum().alias("sb"))


def _cap_query(pkg, d):
    col = pkg.col
    return (pkg.from_pydict(d).where(col("a") > 5).where(col("b") > -10.0)
            .select((col("b") + 1).alias("b1"), col("a"))
            .select((col("b1") * 2).alias("b2"), col("a")))


def _regions(pkg, df):
    import importlib
    pp = importlib.import_module(pkg.__name__ + ".physical.plan")
    tr = importlib.import_module(pkg.__name__ + ".physical.translate")
    found, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, pp.FusedRegion):
            found.append(n)
        for c in n.children:
            walk(c)

    walk(tr.translate(df._builder.optimize().plan))
    return found


def _shapes(regions):
    return [(r.shape, tuple(r.fused_ops)) for r in regions]


def _both_regions(make):
    want = _regions(daft_tpu, make(daft_tpu))
    got = _regions(_port(), make(_port()))
    assert _shapes(got) == _shapes(want)
    return got, want


# ------------------------------------------------------------- planner


def test_planner_fuses_filter_project_chain():
    got, _ = _both_regions(lambda pkg: _chain_query(pkg, _data()))
    assert [r.shape for r in got] == ["chain"]
    assert len(got[0].fused_ops) >= 2


def test_planner_fuses_topk_tail():
    got, _ = _both_regions(lambda pkg: _topk_query(pkg, _data()))
    r = next(r for r in got if r.shape == "topk")
    assert r.limit == 9


def test_planner_fuses_join_agg_spine():
    got, want = _both_regions(
        lambda pkg: _join_agg_query(pkg, _data(), _build()))
    r = next(r for r in got if r.shape == "join_agg")
    assert r.mode == "partial" and r.build is not None
    w = next(r for r in want if r.shape == "join_agg")
    assert [e.name() for e in r.group_by] == [e.name() for e in w.group_by]
    assert [repr(e) for e in r.aggs] == [repr(e) for e in w.aggs]


def test_fusion_off_is_identity(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_FUSION", "0")
    monkeypatch.setenv("DAFT_TORCH_FUSION", "0")
    got, _ = _both_regions(lambda pkg: _chain_query(pkg, _data()))
    assert got == []


def test_host_tier_plans_no_region(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    assert _regions(_port(), _chain_query(_port(), _data())) == []


def test_planner_declines_string_group_keys():
    got, _ = _both_regions(
        lambda pkg: _string_keys_query(pkg, _data(), _build()))
    assert "join_agg" not in [r.shape for r in got]


def test_max_region_ops_cap(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_FUSION_MAX_OPS", "2")
    monkeypatch.setenv("DAFT_TORCH_FUSION_MAX_OPS", "2")
    got, _ = _both_regions(lambda pkg: _cap_query(pkg, _data()))
    for r in got:
        # the trailing "scan" names the source, not an absorbed operator
        assert len([o for o in r.fused_ops if o != "scan"]) <= 2


# ------------------------------------------------- three-way parity


_WAYS = {"fused": {"DAFT_TORCH_FUSION": "1"},
         "device": {"DAFT_TORCH_FUSION": "0"},
         "host": {"DAFT_TORCH_FUSION": "0", "DAFT_TORCH_DEVICE": "0",
                  "DAFT_TORCH_DEVICE_FORCE": "0"}}


def _run_port(monkeypatch, way, make):
    from daft_tpu_torch.device import runtime
    for k, v in _WAYS[way].items():
        monkeypatch.setenv(k, v)
    runtime.reset_counters()
    out = make(_port()).to_pydict()
    return out, runtime.counters()


def _assert_same(a, b, sort_cols=None):
    assert list(a) == list(b)
    if sort_cols:
        ka = np.lexsort([np.asarray(a[c]) for c in sort_cols[::-1]])
        kb = np.lexsort([np.asarray(b[c]) for c in sort_cols[::-1]])
    for k in a:
        va, vb = list(a[k]), list(b[k])
        if sort_cols:
            va, vb = [va[i] for i in ka], [vb[i] for i in kb]
        if va and isinstance(va[0], float):
            np.testing.assert_allclose(np.asarray(va, dtype=float),
                                       np.asarray(vb, dtype=float),
                                       rtol=1e-9, atol=1e-9)
        else:
            assert va == vb, k


def _strings_nulls():
    n = 3000
    rng = np.random.default_rng(5)
    return {"a": rng.integers(0, 100, n).astype(np.int64),
            "b": [None if i % 17 == 0 else float(x)
                  for i, x in enumerate(rng.normal(size=n))],
            "s": [None if i % 23 == 0 else v
                  for i, v in enumerate(rng.choice(["p", "q"], n).tolist())]}


def _strings_nulls_query(pkg, d):
    col = pkg.col
    return pkg.from_pydict(d).where(col("a") > 40).select(
        (col("b") + 0.5).alias("b1"), col("s"), col("a"))


_PARITY = {
    "chain": (lambda pkg: _chain_query(pkg, _data(seed=11)), None,
              "region_chain"),
    "topk": (lambda pkg: _topk_query(pkg, _data(seed=12)), None,
             "region_topk"),
    "join_agg": (lambda pkg: _join_agg_query(
        pkg, _data(seed=13), _build(seed=13)), ["g"], "region_join_agg"),
    "strings_nulls": (lambda pkg: _strings_nulls_query(
        pkg, _strings_nulls()), None, "region_chain"),
}


@pytest.mark.parametrize("way", list(_WAYS))
@pytest.mark.parametrize("shape", list(_PARITY))
def test_parity_three_ways(monkeypatch, shape, way):
    make, sort_cols, counter = _PARITY[shape]
    want = make(daft_tpu).to_pydict()
    got, counts = _run_port(monkeypatch, way, make)
    _assert_same(got, want, sort_cols)
    if way == "fused":
        assert counts.get(counter, 0) >= 1, counts
    else:
        assert not any(k.startswith("region_") for k in counts), counts


# ------------------------------------------------------ overflow ladders


def test_chain_width_ladder_overflow(monkeypatch):
    """A ~95%-selective predicate overflows the quarter-capacity first
    rung; the re-dispatch returns every survivor."""
    d = _data(n=20000, seed=3)
    col = _port().col
    fragment = pytest.importorskip("daft_tpu_torch.device.fragment")
    fragment._region_cache.clear()   # no learned rung from another test
    got, counts = _run_port(
        monkeypatch, "fused", lambda pkg: pkg.from_pydict(d).where(
            col("a") >= 5).select((col("b") + 1.0).alias("b1"), col("a")))
    m = d["a"] >= 5
    np.testing.assert_allclose(np.asarray(got["b1"]), d["b"][m] + 1.0)
    assert np.array_equal(np.asarray(got["a"]), d["a"][m])
    assert counts.get("region_w_climbs", 0) >= 1, counts


def test_join_agg_pair_width_ladder(monkeypatch):
    """Build-side keys repeat 6x: the pair total overflows W = the probe
    capacity and the W ladder grows; the answer equals the reference's."""
    d = _data(n=20000, seed=4, ndv=8)
    rng = np.random.default_rng(4)
    bk = np.repeat(np.arange(0, 8, dtype=np.int64), 6)
    b = {"k2": bk, "w": rng.normal(size=len(bk)),
         "g": (np.arange(len(bk), dtype=np.int64) % 4)}
    want = _join_agg_query(daft_tpu, d, b).to_pydict()
    got, counts = _run_port(monkeypatch, "fused",
                            lambda pkg: _join_agg_query(pkg, d, b))
    _assert_same(got, want, ["g"])
    assert counts.get("region_join_agg_w_climbs", 0) >= 1, counts


def test_join_agg_group_bucket_ladder(monkeypatch):
    """Near-unique group keys overflow the first group bucket; the
    out_cap ladder grows and every group survives."""
    n = 6000
    rng = np.random.default_rng(9)
    d = {"a": np.full(n, 50, dtype=np.int64), "b": rng.normal(size=n),
         "k": np.arange(n, dtype=np.int64) % 2000}
    b = {"k2": np.arange(2000, dtype=np.int64), "w": np.ones(2000),
         "g": np.arange(2000, dtype=np.int64)}
    want = _join_agg_query(daft_tpu, d, b).to_pydict()
    got, counts = _run_port(monkeypatch, "fused",
                            lambda pkg: _join_agg_query(pkg, d, b))
    assert len(got["g"]) == 2000 and sum(got["n"]) == n
    _assert_same(got, want, ["g"])
    assert counts.get("region_join_agg_group_climbs", 0) >= 1, counts


def test_cost_gate_declines_run_the_host_chain(monkeypatch):
    """``auto`` with the cost model deciding: the region's largest morsel,
    300 rows, prices cheaper off the card (a dispatch costs ~1.6 ms), so
    the region runs its fallback subtree whole (``region_declined_gate``,
    no build encoded), same answer, and the decision is logged as
    ``fusion``."""
    monkeypatch.setenv("DAFT_TORCH_FUSION", "auto")
    monkeypatch.delenv("DAFT_TORCH_DEVICE_FORCE")
    from daft_tpu_torch.device import costmodel, runtime
    costmodel.reset_decision_counts()
    runtime.reset_counters()
    d, b = _data(n=300, seed=14), _build(seed=14)
    got = _join_agg_query(_port(), d, b).to_pydict()
    _assert_same(got, _join_agg_query(daft_tpu, d, b).to_pydict(), ["g"])
    c = runtime.counters()
    assert c.get("region_declined_gate", 0) >= 1 \
        and not c.get("region_join_agg") and not c.get("region_builds"), c
    assert costmodel.decision_counts_snapshot()["fusion"]["host"] >= 1


def test_cost_gate_prices_each_morsel_once_the_largest_is_admitted(
        monkeypatch, tmp_path):
    """``auto`` over two probe files, 131,072 rows and 300: with a region
    program 1,000 times the measured rate the largest morsel is admitted,
    so the region runs, and the 300-row morsel, whose fixed dispatch time
    outweighs its host join, runs the region's host chain; the answer is
    the reference's."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from daft_tpu_torch.device import costmodel, runtime
    monkeypatch.setenv("DAFT_TORCH_FUSION", "auto")
    monkeypatch.delenv("DAFT_TORCH_DEVICE_FORCE")
    monkeypatch.setattr(costmodel, "DEV_REGION_JOIN_AGG_ROWS_PER_S",
                        costmodel.DEV_REGION_JOIN_AGG_ROWS_PER_S * 1000)
    probe = tmp_path / "probe"
    probe.mkdir()
    for i, n in enumerate((1 << 17, 300)):
        d = _data(n=n, seed=40 + i)
        pq.write_table(pa.table({k: d[k] for k in ("a", "b", "k")}),
                       str(probe / f"part-{i}.parquet"))
    b = _build(seed=40)
    runtime.reset_counters()

    def query(pkg):
        col = pkg.col
        return pkg.read_parquet(str(probe)).where(col("a") > 20).join(
            pkg.from_pydict(b), left_on=col("k"), right_on=col("k2"),
            how="inner").groupby(col("g")).agg(
            (col("b") * col("w")).sum().alias("rev"),
            col("b").count().alias("n"))
    got = query(_port()).to_pydict()
    c = runtime.counters()
    _assert_same(got, query(daft_tpu).to_pydict(), ["g"])
    assert c.get("region_join_agg", 0) >= 1 \
        and c.get("region_declined_gate", 0) >= 1, c


# --------------------------------------------------- warm-up and ledger


def test_warmup_regions_launches_the_library():
    """After one fused run of each shape, the region library launches over
    a size-class grid."""
    import torch

    from daft_tpu_torch.device import fragment, warmup
    d = _data(seed=21)
    _chain_query(_port(), d).to_pydict()
    _topk_query(_port(), d).to_pydict()
    _join_agg_query(_port(), d, _build(seed=21)).to_pydict()
    progs = fragment.fused_region_programs()
    kinds = {type(p).__name__ for p in progs}
    assert kinds == {"FusedRegionProgram", "FusedJoinAggProgram"}
    stats = warmup.warmup_regions([1 << 12, 1 << 13], torch.device("cpu"),
                                  progs)
    assert stats["programs"] >= 2 * 3, stats


def test_region_ledger_family():
    """Fused dispatches land in the ``region`` ledger family with the
    fused-op count, the round trips removed, and a fusion_x ratio."""
    from daft_tpu_torch.device import costmodel as cm
    cm.ledger_reset()
    _chain_query(_port(), _data(seed=30)).to_pydict()
    fam = cm.ledger_snapshot()["region"]
    assert fam["dispatches"] >= 1
    assert fam.get("fused_ops", 0) >= 2
    assert fam.get("round_trips_saved", 0) >= 1
    assert fam.get("fusion_x", 0) > 0


# ------------------------------------------- the suites' regions


@pytest.fixture(scope="module")
def tpcds_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpcds_fusion")
    generate_tpcds(str(root), scale=0.01, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_fusion")
    generate_tpch(str(root), scale_factor=0.01, num_parts=8, seed=42)
    return str(root)


def _lowers(pkg, region) -> bool:
    """Whether ``pkg``'s region program lowers for ``region`` (the
    executor's own call)."""
    import importlib
    aggs = importlib.import_module(pkg.__name__ + ".aggs")
    fragment = importlib.import_module(pkg.__name__ + ".device.fragment")
    specs = [aggs.split_agg_expr(a) for a in region.aggs]
    child = [(c if c is not None else pkg.lit(True)).alias(f"__v{i}__")
             for i, (op, c, nm, pr) in enumerate(specs)]
    prog = fragment.get_fused_join_agg(
        region.group_by, child, tuple(s[0] for s in specs),
        region.predicate, region.post_predicate,
        region.left_on[0].name(), region.right_on[0].name(),
        region.source.schema(), region.build.schema(),
        fused_ops=region.fused_ops)
    return prog is not None


_DS_REGIONS = {1: 1, 32: 1, 51: 2, 59: 1, 65: 1, 77: 2, 92: 1, 97: 2}


@pytest.mark.parametrize("q", sorted(_DS_REGIONS))
def test_tpcds_regions_match_reference(tpcds_root, q):
    from daft_tpu_torch.benchmarking import tpcds_sql
    want = _regions(daft_tpu, RDS.run(
        q, lambda t: daft_tpu.read_parquet(f"{tpcds_root}/{t}/*.parquet")))
    got = _regions(_port(), tpcds_sql.run(
        q, lambda t: _port().read_parquet(f"{tpcds_root}/{t}/*.parquet")))
    assert _shapes(got) == _shapes(want)
    assert [r.shape for r in got] == ["join_agg"] * _DS_REGIONS[q]
    assert [_lowers(_port(), r) for r in got] == \
        [_lowers(daft_tpu, r) for r in want]


def test_tpch_q17_region_matches_reference(tpch_root):
    from daft_tpu_torch.benchmarking import tpch_queries
    want = _regions(daft_tpu, RQH.ALL[17](
        lambda t: daft_tpu.read_parquet(f"{tpch_root}/{t}/*.parquet")))
    got = _regions(_port(), tpch_queries.ALL[17](
        lambda t: _port().read_parquet(f"{tpch_root}/{t}/*.parquet")))
    assert _shapes(got) == _shapes(want) == \
        [("join_agg", ("aggregate", "hashjoin", "scan"))]
    assert [_lowers(_port(), r) for r in got] == \
        [_lowers(daft_tpu, r) for r in want]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(_PARITY))
def test_regions_on_the_card_match_reference(monkeypatch, shape):
    """The three region programs on CUDA tensors, every morsel admitted,
    against the reference's answer."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cuda")
    make, sort_cols, counter = _PARITY[shape]
    want = make(daft_tpu).to_pydict()
    got, counts = _run_port(monkeypatch, "fused", make)
    _assert_same(got, want, sort_cols)
    assert counts.get(counter, 0) >= 1, counts
