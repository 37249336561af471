"""TPC-H grouped aggregation through both packages' DataFrame API.

SF 0.001 data from the in-repo generator. Q1 (dense strategy), Q6
(keyless), and the ``l_suppkey`` (int64, 2-word hash keys) and
``l_shipdate`` (date, 1-word hash keys) group-bys run through the port on
the CPU under every ``DAFT_TORCH_KERNEL_GROUPBY`` value and on its host
tier (``DAFT_TORCH_DEVICE=0``), and through the reference with
``DAFT_TPU_KERNEL_GROUPBY=hash`` and ``sort``. Keys and counts match
exactly; sums and means at relative 1e-9 (``tests/test_tpch.py``), stddev
at 1e-6 (one-pass sum-of-squares formula, as in the reference). any_value
may pick a different row per engine, so it must be a value of its group.
"""

import datetime

import pytest

import daft_tpu
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch


def ref_suppkey_agg(get_df):
    col = daft_tpu.col
    return (get_df("lineitem").groupby("l_suppkey")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").count().alias("n"),
                 col("l_quantity").min().alias("min_qty"),
                 col("l_extendedprice").max().alias("max_price"),
                 col("l_discount").any_value().alias("any_disc"),
                 col("l_extendedprice").stddev().alias("std_price"))
            .sort("l_suppkey"))


def ref_shipdate_agg(get_df):
    col = daft_tpu.col
    return (get_df("lineitem").groupby("l_shipdate")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("n"),
                 col("l_discount").max().alias("max_disc"))
            .sort("l_shipdate"))


REF = {"q1": RQ.q1, "q6": RQ.q6, "suppkey_agg": ref_suppkey_agg,
       "shipdate_agg": ref_shipdate_agg}
KEYS = {"q1": ["l_returnflag", "l_linestatus"], "q6": [],
        "suppkey_agg": ["l_suppkey"], "shipdate_agg": ["l_shipdate"]}
EXACT = {"q1": ["count_order"], "q6": [],
         "suppkey_agg": ["n", "min_qty", "max_price"],
         "shipdate_agg": ["n", "max_disc"]}
LOOSE = {"suppkey_agg": ["std_price"]}
#: the port's dispatch counter each query must bump under "auto" on CPU
#: tensors: the cost model keeps hash-eligible group-bys on sort there (the
#: hash kernels are compiled for a card); "hash" forces them onto it
AUTO_STRATEGY = {"q1": "dense", "q6": "global", "suppkey_agg": "sort",
                 "shipdate_agg": "sort"}


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch")
    generate_tpch(str(root), scale_factor=0.001, num_parts=2)
    return str(root)


@pytest.fixture(scope="module")
def ref_answers(tpch_root):
    """Reference answers per (query, DAFT_TPU_KERNEL_GROUPBY), lazily."""
    cache = {}
    mp = pytest.MonkeyPatch()

    def get(query, mode):
        if (query, mode) not in cache:
            mp.setenv("DAFT_TPU_KERNEL_GROUPBY", mode)
            try:
                df = REF[query](lambda t: daft_tpu.read_parquet(
                    f"{tpch_root}/{t}/*.parquet"))
                cache[(query, mode)] = df.to_pydict()
            finally:
                mp.undo()
        return cache[(query, mode)]
    return get


def _close(a, b, rel):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def assert_same_answer(query, got, ref, tpch_root):
    assert list(got) == list(ref), "columns"
    n = len(next(iter(ref.values())))
    assert all(len(v) == n for v in got.values()), "row count"
    for c in KEYS[query] + EXACT[query]:
        assert got[c] == ref[c], c
    for c, vals in ref.items():
        if c in KEYS[query] or c in EXACT[query] or c == "any_disc":
            continue
        rel = 1e-6 if c in LOOSE.get(query, ()) else 1e-9
        for a, b in zip(got[c], vals):
            assert _close(a, b, rel), (c, a, b)
    if query == "suppkey_agg":
        import pyarrow.dataset as ds
        t = ds.dataset(f"{tpch_root}/lineitem", format="parquet").to_table(
            columns=["l_suppkey", "l_discount"])
        pairs = set(zip(t["l_suppkey"].to_pylist(),
                        t["l_discount"].to_pylist()))
        for k, v in zip(got["l_suppkey"], got["any_disc"]):
            assert (k, v) in pairs


MODES = [("cpu", "auto"), ("cpu", "dense"), ("cpu", "hash"),
         ("cpu", "sort"), ("0", "auto")]


@pytest.mark.parametrize("query", list(REF))
@pytest.mark.parametrize("device,mode", MODES,
                         ids=[f"{d}-{m}" for d, m in MODES])
def test_port_matches_reference(tpch_root, ref_answers, monkeypatch,
                                query, device, mode):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", device)
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", mode)
    # the fused fragment priced in for these small files
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import runtime
    runtime.reset_counters()
    got = Q.QUERIES[query](lambda t: daft_tpu_torch.read_parquet(
        f"{tpch_root}/{t}/*.parquet")).to_pydict()
    counts = runtime.counters()
    for ref_mode in ("hash", "sort"):
        assert_same_answer(query, got, ref_answers(query, ref_mode),
                           tpch_root)
    if device == "0":
        assert counts.get("host_morsels", 0) > 0
        assert not any(counts.get(s) for s in ("dense", "hash", "sort",
                                               "global"))
        return
    assert counts.get("host_morsels", 0) == 0
    want = AUTO_STRATEGY[query]
    if mode in ("hash", "sort") and want != "global":
        want = mode
    assert counts.get(want, 0) > 0, counts


def test_hash_strategy_climbs_the_overflow_ladder(tpch_root, monkeypatch):
    """~2k ship dates per file overflow the first 128-group bucket: the
    full hash table re-dispatches on sort, whose exact count sizes the
    final hash bucket (the reference's ladder)."""
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", "hash")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.device import runtime
    runtime.reset_counters()
    # one scan task per file (the scan would merge the two)
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=0):
        out = Q.shipdate_agg(lambda t: daft_tpu_torch.read_parquet(
            f"{tpch_root}/{t}/*.parquet")).to_pydict()
    files = 2
    assert runtime.counters().get("hash", 0) == 2 * files
    assert runtime.counters().get("sort", 0) == files
    assert out["l_shipdate"] == sorted(out["l_shipdate"])
    assert isinstance(out["l_shipdate"][0], datetime.date)
