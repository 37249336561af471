"""The mesh dry run: every collective shape of the device mesh, first as
the raw exchange program and then through the engine, at toy sizes.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``, step for
step. The caller sets the mesh up (``DAFT_TORCH_MESH_DEVICES=n``, the
query device through ``DAFT_TORCH_DEVICE``) and forces admission
(``DAFT_TORCH_MESH_MIN_ROWS=0``: the frames are tiny by design). Each
step raises ``AssertionError`` on a wrong answer::

    DAFT_TORCH_DEVICE=cpu DAFT_TORCH_MESH_DEVICES=8 \\
        DAFT_TORCH_MESH_MIN_ROWS=0 \\
        python -m daft_tpu_torch.benchmarking.mesh_dryrun --shards 8
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Callable, Dict

import numpy as np

C = 64   # rows per shard


def _data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 8, n * C).astype(np.int64)
    vals = rng.uniform(0, 10, n * C)
    expect: Dict[int, float] = {}
    for k, v in zip(keys, vals):
        expect[int(k)] = expect.get(int(k), 0.0) + float(v)
    return rng, keys, vals, expect


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-6 * max(abs(b), 1.0)


def _has(node, t) -> bool:
    return isinstance(node, t) or any(_has(c, t) for c in node.children)


def _mesh(n: int):
    from ..parallel import mesh as pmesh
    m = pmesh.get_mesh()
    assert m is not None and m.size == n, \
        f"mesh of {pmesh.mesh_size()} shards, expected {n}"
    return m


@contextlib.contextmanager
def _repartition_spy():
    """Counts the mesh hash repartitions that ran (did not decline)."""
    from ..execution import executor as ex_mod
    calls = {"n": 0}
    orig = ex_mod.LocalExecutor._mesh_hash_repartition

    def spy(self, parts, by, k):
        out = orig(self, parts, by, k)
        if out is not None:
            calls["n"] += 1
        return out

    ex_mod.LocalExecutor._mesh_hash_repartition = spy
    try:
        yield calls
    finally:
        ex_mod.LocalExecutor._mesh_hash_repartition = orig


def step_grouped_sum(n: int, workdir: str) -> str:
    """The raw map → all_to_all → reduce program."""
    from ..parallel import exchange
    mesh = _mesh(n)
    _, keys, vals, expect = _data(n)
    sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
    fk, fs, fmask, _ = exchange.sharded_grouped_sum(
        mesh, sb(keys), sb(vals), sb(np.ones(n * C, dtype=bool)))
    got: Dict[int, float] = {}
    for k, s, m in zip(exchange.gather_blocks(fk),
                       exchange.gather_blocks(fs),
                       exchange.gather_blocks(fmask)):
        if m:
            assert int(k) not in got, "a key on two shards"
            got[int(k)] = float(s)
    assert set(got) == set(expect)
    assert all(_close(got[k], v) for k, v in expect.items())
    return f"sharded grouped-sum over {n * C} rows ({len(expect)} groups)"


def step_engine_groupby(n: int, workdir: str) -> str:
    """A group-by planned onto DeviceExchangeAgg."""
    import daft_tpu_torch as dt
    from ..physical import plan as pp, translate as pt
    _, keys, vals, expect = _data(n)
    df = dt.from_pydict({"k": keys.tolist(), "v": vals.tolist()}) \
        .into_partitions(n)
    agg = df.groupby("k").agg(dt.col("v").sum().alias("s")).sort("k")
    assert _has(pt.translate(agg._builder.optimize().plan),
                pp.DeviceExchangeAgg), "mesh exchange not chosen"
    out = agg.to_pydict()
    assert out["k"] == sorted(expect)
    assert all(_close(s, expect[k]) for k, s in zip(out["k"], out["s"]))
    return "engine group-by over the mesh exchange"


def step_repartition_join(n: int, workdir: str) -> str:
    """Two mesh hash repartitions and the co-partitioned join."""
    import daft_tpu_torch as dt
    _, keys, vals, expect = _data(n)
    with _repartition_spy() as calls:
        left = dt.from_pydict({"k": keys.tolist(), "v": vals.tolist()}) \
            .repartition(n, "k")
        right = dt.from_pydict(
            {"k": list(range(8)), "w": [float(i * 10) for i in range(8)]}) \
            .repartition(n, "k")
        out = left.join(right, on="k").groupby("k").agg(
            dt.col("v").sum().alias("s"),
            dt.col("w").any_value().alias("w")).sort("k").to_pydict()
    assert calls["n"] >= 2, "mesh hash-repartition did not run"
    assert out["k"] == sorted(expect)
    for k, s, w in zip(out["k"], out["s"], out["w"]):
        assert _close(s, expect[k]) and w == float(k * 10)
    return "mesh hash-repartition and co-partitioned join"


def step_range_sort(n: int, workdir: str) -> str:
    """The routing program fed a range pid, then a local sort per shard:
    globally ordered."""
    from ..parallel import exchange
    mesh = _mesh(n)
    rng, _, _, _ = _data(n)
    skeys = rng.uniform(0, 1000, n * C)
    bounds = np.quantile(skeys, [i / n for i in range(1, n)])
    pid = np.searchsorted(bounds, skeys).astype(np.int32)
    ones = np.ones(n * C, dtype=bool)
    sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
    (pk,), _, m2 = exchange.sharded_hash_repartition(
        mesh, (sb(skeys),), (sb(ones),), sb(ones), sb(pid))
    merged = np.concatenate([np.sort(k.cpu().numpy()[m.cpu().numpy()])
                             for k, m in zip(pk, m2)])
    assert merged.shape[0] == n * C
    assert np.all(np.diff(merged) >= 0), "not globally ordered"
    np.testing.assert_allclose(merged, np.sort(skeys))
    return "mesh range-partitioned sort"


def step_broadcast_join(n: int, workdir: str) -> str:
    """Sharded probe side, replicated build side, no all_to_all."""
    from ..parallel import exchange
    mesh = _mesh(n)
    rng, _, _, _ = _data(n)
    lkeys = rng.integers(0, 16, n * C).astype(np.int64)
    rkeys = np.arange(0, 16, 2, dtype=np.int64)
    rvalid = np.ones(rkeys.shape[0], dtype=bool)
    ones = np.ones(n * C, dtype=bool)
    sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
    rep = lambda a: exchange.replicate(mesh, a)  # noqa: E731
    li, ri, ok = exchange.sharded_broadcast_join(
        mesh, sb(lkeys), sb(ones), sb(ones), rep(rkeys), rep(rvalid),
        rep(rvalid), 2 * C)
    matched = 0
    for i in range(n):
        for lo, ro, good in zip(li[i].cpu().numpy(), ri[i].cpu().numpy(),
                                ok[i].cpu().numpy()):
            if good:
                assert lkeys[i * C + lo] == rkeys[ro]
                matched += 1
    assert matched == int(np.isin(lkeys, rkeys).sum())
    return f"mesh broadcast join ({matched} matches)"


def step_window(n: int, workdir: str) -> str:
    """A window whose partition_by repartition rides the mesh."""
    import daft_tpu_torch as dt
    _, keys, vals, expect = _data(n)
    with _repartition_spy() as calls:
        out = dt.from_pydict({"k": keys.tolist(), "v": vals.tolist()}) \
            .repartition(n, "k").select(
                dt.col("k"), dt.col("v"),
                dt.col("v").sum().over(dt.Window().partition_by("k"))
                .alias("tot")).sort(["k", "v"]).to_pydict()
    assert calls["n"] >= 1, "window repartition skipped the mesh"
    assert all(_close(t, expect[k]) for k, t in zip(out["k"], out["tot"]))
    return "window over the mesh exchange"


def step_tpch_q1(n: int, workdir: str) -> str:
    """TPC-H Q1 at SF 0.01 planned onto the mesh (two string keys on
    shared dictionary codes, seven partials), equal to the host tier."""
    import daft_tpu_torch as dt
    from benchmarking.tpch.datagen import generate_tpch
    from ..context import execution_config_ctx
    from ..physical import plan as pp, translate as pt
    from . import tpch_queries as Q
    root = os.path.join(workdir, "tpch_sf0.01")
    if not os.path.isdir(os.path.join(root, "lineitem")):
        generate_tpch(root, 0.01, n)

    def get(t):
        return dt.read_parquet(f"{root}/{t}/*.parquet")

    q1 = Q.q1(get)
    assert _has(pt.translate(q1._builder.optimize().plan),
                pp.DeviceExchangeAgg), "Q1 did not lower onto the mesh"
    got = q1.to_pydict()
    with execution_config_ctx(device="0"):
        want = Q.q1(get).to_pydict()
    assert list(got) == list(want)
    for c in want:
        for a, b in zip(got[c], want[c]):
            if isinstance(b, float):
                assert abs(a - b) <= 1e-9 * max(abs(b), 1.0), (c, a, b)
            else:
                assert a == b, (c, a, b)
    return "TPC-H Q1 end to end over the mesh"


STEPS: Dict[str, Callable[[int, str], str]] = {
    "grouped_sum": step_grouped_sum,
    "engine_groupby": step_engine_groupby,
    "repartition_join": step_repartition_join,
    "range_sort": step_range_sort,
    "broadcast_join": step_broadcast_join,
    "window": step_window,
    "tpch_q1": step_tpch_q1,
}


def dryrun(n: int, workdir: str) -> None:
    for name, fn in STEPS.items():
        print(f"mesh dryrun({n}) {name}: {fn(n, workdir)} OK", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shards", type=int, default=8)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as td:
        dryrun(args.shards, td)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
