"""TPC-H Q3 (two equi-joins, then a group-by and a top-10) through both
packages' DataFrame API.

SF 0.01 data from the in-repo generator (2 files per table). The port
runs on the CPU (``DAFT_TORCH_DEVICE=cpu``) with the join strategy chosen
from size estimates (broadcast at this size), with both joins forced to
gather both sides (broadcast threshold 0, the strategy Q3's lineitem join
takes at SF1), under ``DAFT_TORCH_KERNEL_JOIN=sort``, and on its host tier
(``DAFT_TORCH_DEVICE=0``). Keys match exactly, ``revenue`` at relative
1e-9 (``tests/test_tpch.py``).
"""

import pytest

import daft_tpu
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_join")
    generate_tpch(str(root), scale_factor=0.01, num_parts=2)
    return str(root)


@pytest.fixture(scope="module")
def ref_q3(tpch_root):
    return RQ.q3(lambda t: daft_tpu.read_parquet(
        f"{tpch_root}/{t}/*.parquet")).to_pydict()


def _port_q3(tpch_root):
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    return Q.q3(lambda t: daft_tpu_torch.read_parquet(
        f"{tpch_root}/{t}/*.parquet"))


def _join_strategies(df):
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    out = []

    def walk(n):
        if isinstance(n, pp.HashJoin):
            out.append(n.strategy)
        for c in n.children:
            walk(c)
    walk(translate(df.builder.optimize().plan))
    return out


MODES = ["cpu-estimated", "cpu-gather_both", "cpu-sort", "host"]


@pytest.mark.parametrize("mode", MODES)
def test_q3_matches_reference(tpch_root, ref_q3, monkeypatch, mode):
    import daft_tpu_torch
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0" if mode == "host" else "cpu")
    monkeypatch.setenv("DAFT_TORCH_KERNEL_JOIN",
                       "sort" if mode == "cpu-sort" else "auto")
    threshold = 0 if mode == "cpu-gather_both" else 10 * 1024 * 1024
    runtime.reset_counters()
    with daft_tpu_torch.execution_config_ctx(
            broadcast_join_size_bytes_threshold=threshold):
        df = _port_q3(tpch_root)
        strategies = _join_strategies(df)
        got = df.to_pydict()
    c = runtime.counters()

    assert list(got) == list(ref_q3)
    assert len(got["o_orderkey"]) == 10
    for k in ("o_orderkey", "o_orderdate", "o_shippriority"):
        assert got[k] == ref_q3[k], k
    for a, b in zip(got["revenue"], ref_q3["revenue"]):
        assert abs(a - b) <= 1e-9 * max(abs(a), abs(b)), (a, b)

    if mode == "cpu-gather_both":
        assert strategies == ["hash", "hash"]
    else:
        assert len(strategies) == 2 and "hash" not in strategies
    if mode == "host":
        assert c.get("host_joins", 0) > 0
        assert not c.get("join_hash") and not c.get("join_sort")
    else:
        # the lineitem join passes the 8192-row device floor here
        want, other = ("join_sort", "join_hash") if mode == "cpu-sort" \
            else ("join_hash", "join_sort")
        assert c.get(want, 0) > 0 and not c.get(other), c
