"""Adaptive execution through the port (``daft_tpu_torch/physical/
adaptive.py``, ``runners/native_runner.py:_run_adaptive``, the executor's
``_adaptive_hash_join`` and shuffle coalescing): the initial plan picks a
hash join; AQE materializes the join input, folds its ACTUAL size into the
logical plan and re-runs the optimizer, so the re-plan broadcasts the
small filtered side.

The parity subset of ``tests/test_aqe.py``, on the same numpy-seeded
parquet files: the adaptive answer equals the port's static one and
``daft_tpu``'s adaptive one (group keys exact, sums at relative 1e-9: the
two packages sum floats in different orders).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.physical import adaptive, plan as pp

THRESHOLD = 12_000


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


@pytest.fixture()
def tables(tmp_path):
    rng = np.random.default_rng(3)
    n_fact = 60_000
    pq.write_table(pa.table({
        "f_key": rng.integers(0, 2000, n_fact),
        "f_dim": rng.integers(0, 50, n_fact),
        "f_val": rng.uniform(0, 100, n_fact).round(2),
    }), str(tmp_path / "fact.parquet"))
    # dim is big on disk (an incompressible pad) but the query keeps a
    # handful of rows: the ESTIMATE stays big, the ACTUAL is tiny
    pad = rng.integers(0, 1 << 62, (2000, 25)).astype(np.int64)
    pq.write_table(pa.table({
        "d_key": np.arange(2000),
        "d_cat": rng.integers(0, 400, 2000),
        "d_pad": ["".join(f"{x:016x}" for x in row) for row in pad],
    }), str(tmp_path / "dim.parquet"))
    pq.write_table(pa.table({
        "g_dim": np.arange(50),
        "g_name": [f"g{i}" for i in range(50)],
    }), str(tmp_path / "grp.parquet"))
    return str(tmp_path)


def _query(pkg, root):
    col = pkg.col
    fact = pkg.read_parquet(f"{root}/fact.parquet")
    dim = pkg.read_parquet(f"{root}/dim.parquet").where(col("d_cat") == 7)
    grp = pkg.read_parquet(f"{root}/grp.parquet")
    return (fact.join(dim, left_on="f_key", right_on="d_key")
            .join(grp, left_on="f_dim", right_on="g_dim")
            .groupby("g_name").agg(col("f_val").sum().alias("s"))
            .sort("g_name"))


def _strategies(plan) -> list:
    out = []

    def walk(n):
        if isinstance(n, pp.HashJoin):
            out.append(n.strategy)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def _same(got, want):
    assert got["g_name"] == want["g_name"]
    for a, b in zip(got["s"], want["s"]):
        assert a == pytest.approx(b, rel=1e-9)


@pytest.fixture()
def aqe():
    """Sets either package's AQE switch; puts both packages' execution
    configs back as they were, whatever the test set."""
    saved = [(pkg, pkg.get_context().execution_config)
             for pkg in (daft_tpu, daft_tpu_torch)]

    def set_(pkg, on):
        pkg.set_execution_config(
            enable_aqe=on, broadcast_join_size_bytes_threshold=THRESHOLD)
    try:
        yield set_
    finally:
        for pkg, cfg in saved:
            pkg.set_execution_config(cfg)


@pytest.mark.parametrize("engine", ["push", "interp"])
def test_aqe_replans_to_broadcast(tables, aqe, monkeypatch, engine):
    from daft_tpu_torch.physical.translate import translate
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
    aqe(daft_tpu_torch, False)
    q = _query(daft_tpu_torch, tables)
    initial = translate(q.builder.optimize().plan)
    assert "broadcast_right" not in _strategies(initial)
    want = q.to_pydict()
    aqe(daft_tpu_torch, True)
    before = adaptive.counters_snapshot()
    got = _query(daft_tpu_torch, tables).to_pydict()
    _same(got, want)
    planner = adaptive.last_planner()
    report = planner.explain_analyze()
    assert "materialized join input" in report and "re-optimized" in report
    assert any(s in ("broadcast_right", "broadcast_left")
               for s in _strategies(planner.final_plan)), report
    assert adaptive.counters_delta(before).get("replans", 0) >= 1
    aqe(daft_tpu, True)
    _same(got, _query(daft_tpu, tables).to_pydict())


def test_aqe_materializes_cheapest_input_first_until_resolved(tables):
    """The loop picks the cheapest-estimated unresolved join input each
    round (never the fact table first) and ends with every join input
    measured."""
    from daft_tpu_torch.execution.executor import LocalExecutor
    from daft_tpu_torch.logical import plan as lp
    from daft_tpu_torch.logical.optimizer import Optimizer
    from daft_tpu_torch.physical.translate import translate
    from daft_tpu_torch.runners.native_runner import (_pick_join_input,
                                                      _replace_subtree)
    plan = Optimizer().optimize(_query(daft_tpu_torch, tables).builder.plan)
    target = _pick_join_input(plan)
    assert target is not None
    assert "f_val" not in target.schema().column_names
    for _ in range(8):
        target = _pick_join_input(plan)
        if target is None:
            break
        parts = list(LocalExecutor().run(translate(target)))
        src = lp.Source(partitions=parts, schema=target.schema(),
                        num_partitions=max(len(parts), 1))
        plan = Optimizer().optimize(_replace_subtree(plan, target, src))
    assert _pick_join_input(plan) is None


def test_adaptive_hash_join_demotes_a_measured_small_side(aqe):
    """A planned hash join over two multi-partition inputs whose measured
    right side fits the threshold skips both shuffles (the executor's
    join demotion) and gives the static answer."""
    rng = np.random.default_rng(9)
    big = {"k": rng.integers(0, 300, 20_000).tolist(),
           "v": list(range(20_000))}
    small = {"k": list(range(0, 300, 3)), "w": list(range(100))}

    def q(pkg):
        left = pkg.from_pydict(big).into_partitions(4)
        right = pkg.from_pydict(small).into_partitions(2)
        d = left.join(right, on="k", strategy="hash").to_pydict()
        return sorted(zip(d["k"], d["v"], d["w"]))
    want = q(daft_tpu_torch)
    aqe(daft_tpu_torch, True)
    before = adaptive.counters_snapshot()
    got = q(daft_tpu_torch)
    assert adaptive.counters_delta(before).get("join_demotions", 0) >= 1
    assert got == want
    aqe(daft_tpu, True)
    assert got == q(daft_tpu)


def test_engine_inserted_shuffle_coalesces_under_aqe(aqe):
    """An aggregation's hash exchange over a few bytes coalesces its
    buckets from the measured total (AQE's shuffle resizing)."""
    data = {"k": [i % 50 for i in range(4000)], "v": list(range(4000))}

    def q(pkg):
        d = pkg.from_pydict(data).into_partitions(8).groupby("k") \
            .agg(pkg.col("v").sum()).sort("k").to_pydict()
        return list(zip(d["k"], d["v"]))
    want = q(daft_tpu_torch)
    aqe(daft_tpu_torch, True)
    before = adaptive.counters_snapshot()
    with daft_tpu_torch.execution_config_ctx(local_executor="interp"):
        got = q(daft_tpu_torch)
    assert adaptive.counters_delta(before).get("shuffle_resizes", 0) >= 1
    assert got == want
