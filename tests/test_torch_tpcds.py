"""All 99 TPC-DS queries as SQL through the port, three ways: the port's
device tier on CPU tensors at the default knobs (the cost model and
``DAFT_TORCH_FUSION=auto`` deciding), the port's host tier
(``DAFT_TORCH_DEVICE=0``), and ``daft_tpu`` on JAX-CPU. The nine queries
that hold ``join_agg`` fusion regions (TPC-DS 1, 32, 51, 59, 65, 77, 92,
97) also run with every region admitted (``DAFT_TORCH_FUSION=1``) and
every priced decision on the device (``DAFT_TORCH_DEVICE_FORCE=1``), and
must dispatch them.

Data: ``benchmarking/tpcds/datagen.py`` at scale 0.01, seed 0 (one module
fixture). Both packages hash window partitions alike, so every answer
compares row for row, in the query's order: keys, counts, integers and
strings exactly, floats at relative 1e-9.
"""

import math

import pytest

import daft_tpu
from benchmarking.tpcds import queries as RQ
from benchmarking.tpcds.datagen import generate_tpcds

REGION_QUERIES = (1, 32, 51, 59, 65, 77, 92, 97)


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


def _same(got, want, what):
    assert list(got) == list(want), what
    for c in want:
        assert len(got[c]) == len(want[c]), (what, c)
        for a, b in zip(got[c], want[c]):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-9, abs_tol=1e-12), (what, c, a, b)
            else:
                assert a == b, (what, c, a, b)


@pytest.mark.parametrize("q", sorted(RQ.ALL))
def test_query_matches_reference_three_ways(tpcds_root, monkeypatch, q):
    want = RQ.run(q, _reader(daft_tpu, tpcds_root)).to_pydict()
    r = _port(tpcds_root, q, monkeypatch)
    _same(r["device"], want, f"q{q} device tier vs daft_tpu")
    _same(r["host"], want, f"q{q} host tier vs daft_tpu")
    if q in REGION_QUERIES:
        r = _port(tpcds_root, q, monkeypatch, DAFT_TORCH_FUSION="1",
                  DAFT_TORCH_DEVICE_FORCE="1")
        _same(r["device"], want, f"q{q} forced regions vs daft_tpu")
        assert r["counters"].get("region_join_agg", 0) >= 1, r["counters"]


def test_port_keeps_the_reference_texts():
    from daft_tpu_torch.benchmarking import tpcds_sql
    assert tpcds_sql.ALL == RQ.ALL
    assert tpcds_sql.REGION_QUERIES == REGION_QUERIES
    assert all(tpcds_sql.tables_of(q) == RQ.tables_of(q) for q in RQ.ALL)
