"""All 99 TPC-DS queries as SQL through the port, three ways: the port's
device tier on CPU tensors at the default knobs (the cost model and
``DAFT_TORCH_FUSION=auto`` deciding), the port's host tier
(``DAFT_TORCH_DEVICE=0``), and ``daft_tpu`` on JAX-CPU. The nine queries
that hold ``join_agg`` fusion regions (TPC-DS 1, 32, 51, 59, 65, 77, 92,
97) also run with every region admitted (``DAFT_TORCH_FUSION=1``) and
every priced decision on the device (``DAFT_TORCH_DEVICE_FORCE=1``), and
must dispatch them.

Data: ``benchmarking/tpcds/datagen.py`` at scale 0.01, seed 0 (one module
fixture). Both packages hash window partitions alike. Every answer is held
in the query's order by its ``ORDER BY`` keys (``tpcds_sql.ORDER_KEYS``):
the keys row for row, and the rows inside each run of equal keys as a
multiset, because both packages' push executors order rows that tie on
every key by their arrival (``tpcds_sql.same_order``); keys, counts,
integers and strings exactly, floats at relative 1e-9.

At this scale four answers tie on their keys (``TIED``): Q2 (each
``d_week_seq1`` in 50 runs), Q59 (3 runs), Q81 (two ``CUST00000031`` rows,
the same customer's returns under two states) and Q84 (2 runs of equal
rows). One tie straddles its query's ``LIMIT`` cut (``LIMIT_CUT_TIES``):
Q59's last run continues past row 100 in the port's host answer without
the ``LIMIT`` (which the test asserts), so the rows above the cut are held
exactly and the straddling run's rows as a multiset drawn from that whole
run (``tpcds_sql.cut_run``).
"""

import pytest

import daft_tpu
from benchmarking.tpcds import queries as RQ
from benchmarking.tpcds.datagen import generate_tpcds

REGION_QUERIES = (1, 32, 51, 59, 65, 77, 92, 97)

#: the queries whose answers at scale 0.01 hold rows tied on every ORDER BY
#: key, and those whose last tied run straddles the LIMIT cut
TIED = (2, 59, 81, 84)
LIMIT_CUT_TIES = (59,)


@pytest.fixture(scope="module")
def tpcds_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpcds_torch")
    generate_tpcds(str(root), scale=0.01, seed=0)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


def _port(root, q, monkeypatch, **env):
    """``tpcds_sql.both_tiers`` under ``env``: the device tier's answer and
    counters, then the host tier's answer."""
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpcds_sql
    for k in ("DAFT_TORCH_FUSION", "DAFT_TORCH_DEVICE_FORCE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return tpcds_sql.both_tiers(q, _reader(daft_tpu_torch, root))


def _same(got, want, what, q, pool=None):
    from daft_tpu_torch.benchmarking import tpcds_sql
    try:
        return tpcds_sql.same_order(got, want, tpcds_sql.ORDER_KEYS[q],
                                    cut_pool=pool)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def _cut_pool(root, q, monkeypatch):
    """For a query of ``LIMIT_CUT_TIES``: the run of tied rows its
    ``LIMIT`` cuts, from the port's host tier without the ``LIMIT``
    (asserted to exist); else None."""
    if q not in LIMIT_CUT_TIES:
        return None
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpcds_sql
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    full = tpcds_sql.run(q, _reader(daft_tpu_torch, root),
                         cut=False).to_pydict()
    pool = tpcds_sql.cut_run(full, tpcds_sql.ORDER_KEYS[q],
                             tpcds_sql.limit_of(q))
    assert pool is not None, f"q{q}: the LIMIT cuts no run"
    return pool


@pytest.mark.parametrize("q", sorted(RQ.ALL))
def test_query_matches_reference_three_ways(tpcds_root, monkeypatch, q):
    from daft_tpu_torch.benchmarking import tpcds_sql
    want = RQ.run(q, _reader(daft_tpu, tpcds_root)).to_pydict()
    assert {k for k in tpcds_sql.ORDER_KEYS[q] if isinstance(k, str)} \
        <= set(want), (q, list(want))
    pool = _cut_pool(tpcds_root, q, monkeypatch)
    r = _port(tpcds_root, q, monkeypatch)
    runs = _same(r["device"], want, f"q{q} device tier vs daft_tpu", q, pool)
    assert any(e - s > 1 for s, e in runs) == (q in TIED), runs
    _same(r["host"], want, f"q{q} host tier vs daft_tpu", q, pool)
    if q in REGION_QUERIES:
        r = _port(tpcds_root, q, monkeypatch, DAFT_TORCH_FUSION="1",
                  DAFT_TORCH_DEVICE_FORCE="1")
        _same(r["device"], want, f"q{q} forced regions vs daft_tpu", q,
              pool)
        assert r["counters"].get("region_join_agg", 0) >= 1, r["counters"]


def test_port_keeps_the_reference_texts():
    from daft_tpu_torch.benchmarking import tpcds_sql
    assert tpcds_sql.ALL == RQ.ALL
    assert tpcds_sql.REGION_QUERIES == REGION_QUERIES
    assert all(tpcds_sql.tables_of(q) == RQ.tables_of(q) for q in RQ.ALL)


def test_order_oracle_holds_keys_and_frees_ties():
    """Rows may swap inside a run of equal keys, never across runs; a run
    cut by a LIMIT is held as a multiset drawn from the whole run."""
    from daft_tpu_torch.benchmarking import tpcds_sql
    same = tpcds_sql.same_order
    want = {"k": [1, 1, 2, 3, 3], "v": [10, 11, 20, 30, 31],
            "f": [0.5, 0.25, 1.0, 2.0, 3.0]}
    swapped = {"k": [1, 1, 2, 3, 3], "v": [11, 10, 20, 31, 30],
               "f": [0.25, 0.5, 1.0, 3.0, 2.0]}
    assert same(swapped, want, ("k",)) == [(0, 2), (2, 3), (3, 5)]
    with pytest.raises(AssertionError):
        same(swapped, want, ("k", "v"))
    across = {"k": [1, 1, 2, 3, 3], "v": [10, 20, 11, 30, 31],
              "f": [0.5, 1.0, 0.25, 2.0, 3.0]}
    with pytest.raises(AssertionError):
        same(across, want, ("k",))
    other = {"k": [1, 1, 2, 3, 3], "v": [10, 11, 20, 30, 32],
             "f": [0.5, 0.25, 1.0, 2.0, 3.0]}
    with pytest.raises(AssertionError):
        same(other, want, ("k",))
    full = {"k": [1, 1, 2, 3, 3, 3], "v": [10, 11, 20, 30, 31, 32],
            "f": [0.5, 0.25, 1.0, 2.0, 3.0, 4.0]}
    assert tpcds_sql.cut_run(full, ("k",), 2) is None
    pool = tpcds_sql.cut_run(full, ("k",), 5)
    assert [r["v"] for r in pool] == [30, 31, 32]
    cut = dict(other, f=[0.5, 0.25, 1.0, 2.0, 4.0])  # the row past the cut
    same(cut, want, ("k",), cut_pool=pool)
    with pytest.raises(AssertionError):
        same(other, want, ("k",), cut_pool=pool)  # v=32 with f=3.0
    with pytest.raises(AssertionError):
        same({**cut, "k": [1, 1, 2, 3, 4]}, want, ("k",), cut_pool=pool)
    with pytest.raises(AssertionError):
        same(swapped, want, ("k",), cut_pool=pool[:1])
    near = dict(want, f=[0.5 * (1 + 1e-12), 0.25, 1.0, 2.0, 3.0])
    same(near, want, ("k", "f"))
    diff = tpcds_sql.ORDER_KEYS[47][0]
    assert diff({"sum_sales": 3.0, "avg_monthly_sales": 1.0}) == 2.0
    case = tpcds_sql.ORDER_KEYS[36][1]
    assert case({"lochierarchy": 0, "i_category": "Books"}) == "Books"
    assert case({"lochierarchy": 1, "i_category": "Books"}) is None
    assert tpcds_sql.limit_of(59) == 100 and tpcds_sql.limit_of(2) is None
