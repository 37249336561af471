"""Window functions through the port (``daft_tpu_torch/window.py``,
``window_exec.py``, the ``Exchange`` / ``Window`` plan nodes and SQL
``OVER``) held to ``daft_tpu`` on the same pydict.

The reference's window cases (``tests/test_dataframe.py``
``test_window_functions`` / ``test_window_full_frame``,
``tests/test_window_device.py``) and more — lag and lead with defaults,
``range_between``, ``rows_between`` frames, nulls in the partition and
order keys, the rank family without ``PARTITION BY`` (a gather exchange),
several specs in one select, a window nested in an expression, SQL
windows over aggregates — each at 1 and 3 input partitions, on the port's
device tier on CPU tensors (every priced decision on the device, so the
window's sort takes the device argsort) and on its host tier. Both
packages hash rows into the same partitions (``Series.hash``), so the
output order matches too: every answer is compared row for row, floats
at relative 1e-9.
"""

import math

import numpy as np
import pytest

import daft_tpu

MODES = {"device": {"DAFT_TORCH_DEVICE": "cpu",
                    "DAFT_TORCH_DEVICE_FORCE": "1"},
         "host": {"DAFT_TORCH_DEVICE": "0"}}


def _frame(pkg, data, nparts):
    """A DataFrame of ``nparts`` in-memory partitions (contiguous row
    ranges) in either package."""
    n = len(next(iter(data.values())))
    bounds = np.linspace(0, n, nparts + 1).astype(int)
    parts = [pkg.micropartition.MicroPartition.from_pydict(
        {k: list(v)[bounds[i]:bounds[i + 1]] for k, v in data.items()})
        for i in range(nparts)]
    b = pkg.logical.builder.LogicalPlanBuilder.from_in_memory(
        parts, parts[0].schema)
    return pkg.dataframe.DataFrame(b)


def _same(got, want):
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c]), c
        for a, b in zip(got[c], want[c]):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-9, abs_tol=1e-12), (c, a, b)
            else:
                assert a == b, (c, a, b)


def _check(monkeypatch, mode, nparts, data, query):
    """``query(pkg, df)`` → DataFrame, run through both packages."""
    import daft_tpu_torch
    import daft_tpu_torch.dataframe  # noqa: F401  (module attributes)
    import daft_tpu_torch.logical.builder  # noqa: F401
    import daft_tpu_torch.micropartition  # noqa: F401
    import daft_tpu.dataframe  # noqa: F401
    import daft_tpu.logical.builder  # noqa: F401
    import daft_tpu.micropartition  # noqa: F401
    want = query(daft_tpu, _frame(daft_tpu, data, nparts)).to_pydict()
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    got = query(daft_tpu_torch,
                _frame(daft_tpu_torch, data, nparts)).to_pydict()
    _same(got, want)
    return got


def _W(pkg):
    return pkg.Window


def _fns(pkg):
    import importlib
    return importlib.import_module(pkg.__name__ + ".functions")


_SMALL = {"g": ["a", "a", "a", "b", "b"], "v": [3, 1, 2, 10, 5],
          "s": [1.0, 2.0, 3.0, 4.0, 5.0]}


def _rng_data(n=60, seed=3):
    rng = np.random.default_rng(seed)
    g = [None if i % 11 == 0 else f"g{x}"
         for i, x in enumerate(rng.integers(0, 4, n))]
    k = [None if i % 7 == 3 else int(x)
         for i, x in enumerate(rng.integers(0, 9, n))]
    return {"g": g, "k": k, "o": rng.permutation(n).tolist(),
            "x": [None if i % 13 == 5 else float(x)
                  for i, x in enumerate(np.round(rng.normal(size=n), 3))],
            "t": rng.integers(0, 100, n).astype(np.int64).tolist()}


def q_functions(pkg, df):
    """``tests/test_dataframe.py::test_window_functions``."""
    f, col = _fns(pkg), pkg.col
    w = _W(pkg)().partition_by("g").order_by("v")
    return (df.with_column("rn", f.row_number().over(w))
            .with_column("rk", f.rank().over(w))
            .with_column("rsum", col("s").sum().over(w)).sort(["g", "v"]))


def q_full_frame(pkg, df):
    """``tests/test_dataframe.py::test_window_full_frame``."""
    w = _W(pkg)().partition_by("g")
    return df.with_column("avg", pkg.col("v").mean().over(w)) \
        .sort(["g", "v"])


def q_rank_lag(pkg, df):
    """``tests/test_window_device.py``: rank, a running sum frame, lag."""
    col, f, W = pkg.col, _fns(pkg), _W(pkg)
    w = W().partition_by("g").order_by("v")
    frame = W().partition_by("g").order_by("v").rows_between(
        W.unbounded_preceding, W.current_row)
    return df.select(col("g"), col("v"), f.rank().over(w).alias("r"),
                     col("s").sum().over(frame).alias("rs"),
                     col("s").lag(1).over(w).alias("p"))


def q_lag_lead_defaults(pkg, df):
    col, W = pkg.col, _W(pkg)
    w = W().partition_by("g").order_by("o")
    return df.select(col("g"), col("o"), col("x"),
                     col("x").lag(2, -1.0).over(w).alias("lag2"),
                     col("t").lead(1, 0).over(w).alias("lead1"),
                     col("x").lead(3).over(w).alias("lead3"))


def q_range_frame(pkg, df):
    col, W = pkg.col, _W(pkg)
    w = W().partition_by("g").order_by("t").range_between(-10, 5)
    w2 = W().partition_by("g").order_by("t").range_between(
        W.unbounded_preceding, 0)
    return df.select(col("g"), col("t"), col("x"),
                     col("x").sum().over(w).alias("rsum"),
                     col("x").count().over(w).alias("rcnt"),
                     col("x").mean().over(w2).alias("ravg"))


def q_rows_frames(pkg, df):
    col, W = pkg.col, _W(pkg)
    w = W().partition_by("k").order_by("o").rows_between(-2, 1)
    w3 = W().partition_by("k").order_by("o").rows_between(
        -1, 1, min_periods=3)
    return df.select(col("k"), col("o"), col("x"),
                     col("x").sum().over(w).alias("s"),
                     col("x").max().over(w).alias("mx"),
                     col("x").min().over(w3).alias("mn3"))


def q_null_keys(pkg, df):
    """Nulls in the partition keys (one partition of their own) and in the
    order keys (placed by the spec's nulls_first)."""
    col, f, W = pkg.col, _fns(pkg), _W(pkg)
    w = W().partition_by("g").order_by("k", desc=True)
    w2 = W().partition_by("g", "k").order_by("o", nulls_first=True)
    return df.select(col("g"), col("k"), col("o"),
                     f.rank().over(w).alias("rk"),
                     f.dense_rank().over(w).alias("drk"),
                     f.row_number().over(w2).alias("rn"),
                     col("x").max().over(W().partition_by("g"))
                     .alias("gmax"))


def q_no_partition(pkg, df):
    """No ``PARTITION BY``: the gather exchange, one partition."""
    col, f, W = pkg.col, _fns(pkg), _W(pkg)
    w = W().order_by("t", desc=True)
    return df.select(col("o"), col("t"), f.rank().over(w).alias("r"),
                     f.row_number().over(W().order_by("o")).alias("rn"),
                     col("x").sum().over(w).alias("run"))


def q_nested(pkg, df):
    """A window inside an expression (hoisted into its own Window node),
    and a running aggregate with the default frame."""
    col, W = pkg.col, _W(pkg)
    w = W().partition_by("g")
    return df.select(col("g"), col("o"),
                     (col("t") * 100.0 / col("t").sum().over(w))
                     .alias("share"),
                     col("t").max().over(W().partition_by("g")
                                         .order_by("o")).alias("cummax"),
                     col("x").stddev().over(w).alias("sd"))


CASES = {"functions": (q_functions, _SMALL),
         "full_frame": (q_full_frame, {"g": ["a", "a", "b"],
                                       "v": [1.0, 3.0, 10.0]}),
         "rank_lag": (q_rank_lag, {"g": ["a", "a", "a", "b", "b"],
                                   "v": [3.0, 1.0, 2.0, 10.0, 20.0],
                                   "s": [1.0, 2.0, 3.0, 4.0, 5.0]}),
         "lag_lead_defaults": (q_lag_lead_defaults, _rng_data()),
         "range_frame": (q_range_frame, _rng_data(seed=4)),
         "rows_frames": (q_rows_frames, _rng_data(seed=5)),
         "null_keys": (q_null_keys, _rng_data(seed=6)),
         "no_partition": (q_no_partition, _rng_data(seed=7)),
         "nested": (q_nested, _rng_data(seed=8))}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_window_matches_reference(monkeypatch, case, nparts, mode):
    query, data = CASES[case]
    _check(monkeypatch, mode, nparts, data, query)


def test_reference_window_values(monkeypatch):
    """The reference tests' expected values, on the port."""
    got = _check(monkeypatch, "device", 1, _SMALL, q_functions)
    assert got["rn"] == [1, 2, 3, 1, 2] and got["rk"] == [1, 2, 3, 1, 2]
    assert got["rsum"] == [2.0, 5.0, 6.0, 5.0, 9.0]
    got = _check(monkeypatch, "device", 1, CASES["rank_lag"][1],
                 lambda pkg, df: q_rank_lag(pkg, df).sort(["g", "v"]))
    assert got["r"] == [1, 2, 3, 1, 2]
    assert got["rs"] == [2.0, 5.0, 6.0, 4.0, 9.0]
    assert got["p"] == [None, 2.0, 3.0, None, 4.0]


_SQL = {
    "rank_partition": "SELECT g, o, rank() OVER (PARTITION BY g ORDER BY t "
                      "DESC, o) AS r FROM t ORDER BY g, o",
    "sum_over_agg": "SELECT g, k, sum(t) AS st, sum(sum(t)) OVER "
                    "(PARTITION BY g) AS gt, sum(t) * 100.0 / sum(sum(t)) "
                    "OVER (PARTITION BY g) AS share FROM t GROUP BY g, k "
                    "ORDER BY g, k",
    "avg_rows_frame": "SELECT o, avg(x) OVER (PARTITION BY g ORDER BY o "
                      "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma "
                      "FROM t ORDER BY o",
    "lag_lead": "SELECT o, lag(t, 1, 0) OVER (PARTITION BY g ORDER BY o) "
                "AS lt, lead(t) OVER (PARTITION BY g ORDER BY o) AS nt "
                "FROM t ORDER BY o",
    "rollup_rank": "SELECT g, k, sum(t) AS st, grouping(g) + grouping(k) "
                   "AS lvl, rank() OVER (PARTITION BY grouping(g) + "
                   "grouping(k) ORDER BY sum(t) DESC) AS rk FROM t "
                   "GROUP BY ROLLUP (g, k) ORDER BY lvl, rk, g, k",
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(_SQL))
def test_sql_window_matches_reference(monkeypatch, name, mode):
    import daft_tpu_torch
    data = _rng_data(n=80, seed=9)
    want = daft_tpu.sql(_SQL[name],
                        t=daft_tpu.from_pydict(data)).to_pydict()
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    got = daft_tpu_torch.sql(_SQL[name],
                             t=daft_tpu_torch.from_pydict(data)).to_pydict()
    _same(got, want)


@pytest.mark.parametrize("nparts", [1, 3, 7])
def test_partition_by_hash_matches_reference(nparts):
    """The exchange's buckets: the same rows in the same order."""
    import daft_tpu_torch
    data = _rng_data(n=200, seed=10)
    data["d"] = [None if i % 9 == 0 else i * 0.5 for i in range(200)]
    keys = ["g", "k", "d"]
    r = daft_tpu.RecordBatch.from_pydict(data).partition_by_hash(
        [daft_tpu.col(c) for c in keys], nparts)
    p = daft_tpu_torch.RecordBatch.from_pydict(data).partition_by_hash(
        [daft_tpu_torch.col(c) for c in keys], nparts)
    assert [b.to_pydict() for b in p] == [b.to_pydict() for b in r]


def test_series_hash_matches_reference():
    """splitmix64 over fixed widths, XXH64 over string bytes (short,
    8/4/1-byte tails, 32-byte stripes, multi-byte UTF-8), nulls."""
    import pyarrow as pa

    import daft_tpu_torch
    rng = np.random.default_rng(11)
    strs = [None if i % 13 == 0 else "".join(
        chr(97 + x) for x in rng.integers(0, 26, rng.integers(0, 90)))
        for i in range(400)] + ["é漢字" * k for k in range(20)]
    for data in (strs, rng.integers(-10**12, 10**12, 300).tolist(),
                 [None if i % 5 == 0 else float(x)
                  for i, x in enumerate(rng.normal(size=300))],
                 [True, False, None] * 20):
        a = pa.array(data)
        seed = pa.array(np.arange(len(data), dtype=np.uint64))
        for with_seed in (False, True):
            r = daft_tpu.Series.from_arrow(a, "x")
            p = daft_tpu_torch.Series.from_arrow(a, "x")
            rs = r.hash(daft_tpu.Series.from_arrow(seed, "s")) \
                if with_seed else r.hash()
            ps = p.hash(daft_tpu_torch.Series.from_arrow(seed, "s")) \
                if with_seed else p.hash()
            assert ps.to_pylist() == rs.to_pylist()
