"""The port's device mesh and exchange programs (``daft_tpu_torch/
parallel/``) held against the reference's (``daft_tpu/parallel/``).

- The reference runs on its 8-device virtual CPU mesh (``tests/
  conftest.py``); the port on an 8-shard mesh on ``cpu``
  (``DAFT_TORCH_DEVICE=cpu``, ``DAFT_TORCH_MESH_DEVICES=8``). Both force
  mesh admission with ``*_MESH_MIN_ROWS=0``, as the reference's tests do.
- The exchange functions are compared shard by shard on the same inputs,
  made from a seed with numpy: the 32-bit hashes bit for bit (negative
  int64, the int64 edges, NaN and -0.0, bool and null keys), the grouped
  aggregation's key set per shard exactly and its values at relative
  1e-9, the repartition's rows per shard exactly, the broadcast join's
  pair set per shard exactly.
- The reference's ``tests/test_exchange.py`` cases run through both
  packages' DataFrame APIs (the plan must pick ``DeviceExchangeAgg`` in
  both, and the answers must agree).
- Each step of ``__graft_entry__.py:dryrun_multichip`` runs through the
  port at 8 shards (``daft_tpu_torch/benchmarking/mesh_dryrun.py``).
- With no mesh knob the single-card path plans as before: one device
  means no mesh and no ``DeviceExchangeAgg``.
"""

import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.parallel import exchange as rex
from daft_tpu.parallel import mesh as rmesh
from daft_tpu.physical import plan as rpp
from daft_tpu.physical import translate as rpt
from daft_tpu_torch.parallel import exchange as tex
from daft_tpu_torch.parallel import mesh as tmesh
from daft_tpu_torch.physical import plan as tpp
from daft_tpu_torch.physical import translate as tpt

N = 8
REL = 1e-9


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_DEVICE", "1")
    monkeypatch.setenv("DAFT_TPU_MESH_MIN_ROWS", "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_MESH_DEVICES", str(N))
    monkeypatch.setenv("DAFT_TORCH_MESH_MIN_ROWS", "0")
    tmesh.reset_for_tests()
    yield
    tmesh.reset_for_tests()


def _rmesh():
    return rex.make_mesh(N)


def _np(x):
    import jax
    return np.asarray(jax.device_get(x))


def _blocks(blocks):
    """Per-shard port blocks → list of numpy arrays."""
    return [b.numpy() for b in blocks]


def _ref_blocks(arr, n=N):
    a = _np(arr)
    L = a.shape[0] // n
    return [a[i * L:(i + 1) * L] for i in range(n)]


def _has(node, t):
    return isinstance(node, t) or any(_has(c, t) for c in node.children)


# ------------------------------------------------------------- the mesh

def test_mesh_is_up():
    assert tmesh.mesh_size() == N
    m = tmesh.get_mesh()
    assert m.size == N
    assert all(d == torch.device("cpu") for d in m.devices)
    assert rmesh.mesh_size() >= N


def test_no_mesh_without_the_knob_or_a_device(monkeypatch):
    monkeypatch.delenv("DAFT_TORCH_MESH_DEVICES")
    assert tmesh.mesh_size() == 0 and tmesh.get_mesh() is None
    monkeypatch.setenv("DAFT_TORCH_MESH_DEVICES", str(N))
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    assert tmesh.mesh_size() == 0 and tmesh.get_mesh() is None


def test_one_card_means_no_mesh(monkeypatch):
    """With no knob the mesh spans the visible CUDA devices: one card is a
    one-shard mesh, so the planner keeps the host exchange."""
    monkeypatch.delenv("DAFT_TORCH_MESH_DEVICES")
    monkeypatch.setattr(tmesh, "_query_device",
                        lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.mesh_size() == 1
    assert tpt._try_mesh_exchange_agg(None, [], [object()], None, None,
                                      10 ** 6) is None
    # asked for 4 shards, all four sit on the one card
    monkeypatch.setenv("DAFT_TORCH_MESH_DEVICES", "4")
    m = tmesh.make_mesh(4, torch.device("cuda"))
    assert m.devices == (torch.device("cuda", 0),) * 4


def test_default_cpu_path_plans_no_exchange_agg(monkeypatch):
    monkeypatch.delenv("DAFT_TORCH_MESH_DEVICES")
    df = daft_tpu_torch.from_pydict({"k": list(range(100)),
                                     "v": [float(i) for i in range(100)]})
    phys = tpt.translate(df.groupby("k").agg(daft_tpu_torch.col("v").sum())
                         ._builder.optimize().plan)
    assert not _has(phys, tpp.DeviceExchangeAgg)


# --------------------------------------------------------------- hashes

def _hash_inputs():
    rng = np.random.default_rng(0)
    i64 = np.concatenate([
        rng.integers(-2 ** 63, 2 ** 63 - 1, 500, dtype=np.int64),
        np.array([-2 ** 63, 2 ** 63 - 1, 0, -1, 1, -2 ** 32, 2 ** 32],
                 dtype=np.int64)])
    i32 = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, 500,
                                       dtype=np.int32),
                          np.array([-2 ** 31, 2 ** 31 - 1, 0, -1],
                                   dtype=np.int32)])
    f64 = np.concatenate([rng.normal(size=500) * 1e6,
                          [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf,
                           5e-324, 1e308]])
    with np.errstate(over="ignore"):   # 1e308 → inf, on purpose
        f32 = f64.astype(np.float32)
    b = rng.integers(0, 2, 400).astype(bool)
    return {"int64": i64, "int32": i32, "float64": f64, "float32": f32,
            "bool": b}


@pytest.mark.parametrize("kind", ["int64", "int32", "bool"])
def test_hash_u32_bit_parity(kind):
    import jax.numpy as jnp
    x = _hash_inputs()[kind]
    want = _np(rex._hash_u32(jnp.asarray(x))).astype(np.int64)
    got = tex._hash_u32(torch.from_numpy(x)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("kinds", [("int64",), ("int32",), ("float64",),
                                   ("float32",), ("bool",),
                                   ("int64", "float64", "int32"),
                                   ("bool", "int64")])
def test_combine_hashes_bit_parity(kinds):
    import jax.numpy as jnp
    rng = np.random.default_rng(len(kinds))
    inputs = _hash_inputs()
    n = min(len(inputs[k]) for k in kinds)
    keys = [inputs[k][:n] for k in kinds]
    valids = [rng.random(n) > 0.2 for _ in kinds]   # null keys included
    want = _np(rex._combine_hashes([jnp.asarray(k) for k in keys],
                                   [jnp.asarray(v) for v in valids]))
    got = tex._combine_hashes([torch.from_numpy(k) for k in keys],
                              [torch.from_numpy(v) for v in valids])
    assert (got.numpy() == want.astype(np.int64)).all()


# ------------------------------------------------------- the programs

def _agg_case(case: str, C: int = 64):
    """Key / value planes as the engine encodes them (nulls zero-filled)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    T = N * C
    kv = rng.random(T) > 0.1
    if case == "int64":
        keys = [np.where(kv, rng.integers(-50, 50, T), 0).astype(np.int64)]
        kvs = [kv]
    elif case == "multi":
        k2v = rng.random(T) > 0.05
        keys = [np.where(kv, rng.integers(0, 9, T), 0).astype(np.int64),
                np.where(k2v, rng.integers(0, 4, T), 0).astype(np.int32)]
        kvs = [kv, k2v]
    elif case == "float":
        keys = [np.where(kv, rng.integers(0, 20, T) * 0.5, 0.0)]
        kvs = [kv]
    else:
        raise ValueError(case)
    vals = [rng.normal(size=T), rng.integers(-1000, 1000, T)]
    vvs = [rng.random(T) > 0.1, np.ones(T, dtype=bool)]
    mask = np.arange(T) < T - 13
    return keys, kvs, vals, vvs, mask


def _groups(keys, kvs, vals, vvs, gmask):
    """One shard's live groups → {key tuple: value tuple}."""
    out = {}
    for r in range(len(gmask)):
        if not gmask[r]:
            continue
        k = tuple(float(kp[r]) if kv[r] else None
                  for kp, kv in zip(keys, kvs))
        out[k] = tuple(float(vp[r]) if vv[r] else None
                       for vp, vv in zip(vals, vvs))
    return out


@pytest.mark.parametrize("case,ops", [
    ("int64", ("sum", "sum")), ("int64", ("min", "max")),
    ("multi", ("sum", "max")), ("float", ("max", "sum")),
    ("multi", ("any_value", "min"))])
def test_sharded_grouped_agg_parity(case, ops):
    keys, kvs, vals, vvs, mask = _agg_case(case)
    rm = _rmesh()
    rsb = lambda a: rex.shard_blocks(rm, a)  # noqa: E731
    rfk, rfkv, rfv, rfvv, rg = rex.sharded_grouped_agg(
        rm, tuple(rsb(k) for k in keys), tuple(rsb(k) for k in kvs),
        tuple(rsb(v) for v in vals), tuple(rsb(v) for v in vvs),
        rsb(mask), ops)
    tm = tmesh.get_mesh()
    tsb = lambda a: tex.shard_blocks(tm, a)  # noqa: E731
    pfk, pfkv, pfv, pfvv, pg = tex.sharded_grouped_agg(
        tm, tuple(tsb(k) for k in keys), tuple(tsb(k) for k in kvs),
        tuple(tsb(v) for v in vals), tuple(tsb(v) for v in vvs),
        tsb(mask), ops)
    rshards = [_ref_blocks(a) for a in (*rfk, *rfkv, *rfv, *rfvv, rg)]
    pshards = [_blocks(a) for a in (*pfk, *pfkv, *pfv, *pfvv, pg)]
    nk, nv = len(keys), len(vals)
    total = 0
    for j in range(N):
        rs = [x[j] for x in rshards]
        ps = [x[j] for x in pshards]
        want = _groups(rs[:nk], rs[nk:2 * nk], rs[2 * nk:2 * nk + nv],
                       rs[2 * nk + nv:2 * nk + 2 * nv], rs[-1])
        got = _groups(ps[:nk], ps[nk:2 * nk], ps[2 * nk:2 * nk + nv],
                      ps[2 * nk + nv:2 * nk + 2 * nv], ps[-1])
        assert set(got) == set(want), j
        for k, w in want.items():
            for a, b in zip(got[k], w):
                assert (a is None) == (b is None), (j, k)
                if b is not None:
                    assert abs(a - b) <= REL * max(abs(a), abs(b), 1.0)
        total += len(want)
    assert total > 0


def test_sharded_grouped_sum_parity():
    rng = np.random.default_rng(0)
    T = N * 64
    keys = rng.integers(0, 8, T).astype(np.int64)
    vals = rng.uniform(0, 10, T)
    mask = np.ones(T, dtype=bool)
    rm, tm = _rmesh(), tmesh.get_mesh()
    rk, rs, rmask, _ = rex.sharded_grouped_sum(
        rm, rex.shard_blocks(rm, keys), rex.shard_blocks(rm, vals),
        rex.shard_blocks(rm, mask))
    pk, ps, pmask, pcnt = tex.sharded_grouped_sum(
        tm, tex.shard_blocks(tm, keys), tex.shard_blocks(tm, vals),
        tex.shard_blocks(tm, mask))
    for j, (a, b, c) in enumerate(zip(_ref_blocks(rk), _ref_blocks(rs),
                                      _ref_blocks(rmask))):
        want = {int(k): float(s) for k, s, m in zip(a, b, c) if m}
        got = {int(k): float(s) for k, s, m in
               zip(pk[j].numpy(), ps[j].numpy(), pmask[j].numpy()) if m}
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= REL * max(abs(want[k]), 1.0)
        assert int(pcnt[j][0]) == len(got)


def test_sharded_hash_repartition_parity():
    rng = np.random.default_rng(3)
    T = N * 32
    plane_a = rng.integers(-2 ** 40, 2 ** 40, T)
    plane_b = rng.normal(size=T)
    va, vb = rng.random(T) > 0.1, rng.random(T) > 0.1
    mask = np.arange(T) < T - 5
    pid = rng.integers(0, N, T).astype(np.int32)
    rm, tm = _rmesh(), tmesh.get_mesh()
    rsb = lambda a: rex.shard_blocks(rm, a)  # noqa: E731
    tsb = lambda a: tex.shard_blocks(tm, a)  # noqa: E731
    (ra, rb), (rva, rvb), rmask = rex.sharded_hash_repartition(
        rm, (rsb(plane_a), rsb(plane_b)), (rsb(va), rsb(vb)), rsb(mask),
        rsb(pid))
    (pa, pb), (pva, pvb), pmask = tex.sharded_hash_repartition(
        tm, (tsb(plane_a), tsb(plane_b)), (tsb(va), tsb(vb)), tsb(mask),
        tsb(pid))
    for j in range(N):
        rl = _ref_blocks(rmask)[j]
        pl = pmask[j].numpy()
        assert rl.sum() == pl.sum()
        for r, p in ((ra, pa), (rb, pb), (rva, pva), (rvb, pvb)):
            np.testing.assert_array_equal(p[j].numpy()[pl],
                                          _ref_blocks(r)[j][rl])
    assert sum(int(m.sum()) for m in pmask) == int(mask.sum())


def test_all_to_all_by_hash_routes_like_the_reference():
    rng = np.random.default_rng(0)
    T = N * 32
    keys = rng.integers(0, 1000, T).astype(np.int32)
    vals = (keys * 10).astype(np.int32)
    mask = np.ones(T, dtype=bool)
    tm = tmesh.get_mesh()
    k2, v2, m2 = tex.all_to_all_by_hash(
        tex.shard_blocks(tm, keys), [(v,) for v in
                                     tex.shard_blocks(tm, vals)],
        tex.shard_blocks(tm, mask), tm)
    live = np.concatenate([m.numpy() for m in m2])
    allk = np.concatenate([k.numpy() for k in k2])
    allv = np.concatenate([v[0].numpy() for v in v2])
    assert live.sum() == T
    assert sorted(allk[live].tolist()) == sorted(keys.tolist())
    assert (allv[live] == allk[live] * 10).all()
    import jax.numpy as jnp
    for i in range(N):
        got = k2[i].numpy()[m2[i].numpy()]
        h = _np(rex._hash_u32(jnp.asarray(got))) % N
        assert (h == i).all()


def test_sharded_broadcast_join_parity():
    rng = np.random.default_rng(5)
    C = 32
    T = N * C
    lkeys = rng.integers(0, 16, T).astype(np.int64)
    lvalid = rng.random(T) > 0.1
    rkeys = np.array([0, 2, 2, 4, 6, 8, 10, 12, 14, 3], dtype=np.int64)
    rvalid = np.ones(len(rkeys), dtype=bool)
    ones = np.ones(T, dtype=bool)
    out_cap = 2 * C
    import jax.numpy as jnp
    rm, tm = _rmesh(), tmesh.get_mesh()
    rli, rri, rok = rex.sharded_broadcast_join(
        rm, rex.shard_blocks(rm, lkeys), rex.shard_blocks(rm, lvalid),
        rex.shard_blocks(rm, ones), jnp.asarray(rkeys),
        jnp.asarray(rvalid), jnp.asarray(rvalid), out_cap)
    pli, pri, pok = tex.sharded_broadcast_join(
        tm, tex.shard_blocks(tm, lkeys), tex.shard_blocks(tm, lvalid),
        tex.shard_blocks(tm, ones), tex.replicate(tm, rkeys),
        tex.replicate(tm, rvalid), tex.replicate(tm, rvalid), out_cap)
    matched = 0
    for j in range(N):
        r = {(int(a), int(b)) for a, b, ok in zip(
            _ref_blocks(rli)[j], _ref_blocks(rri)[j], _ref_blocks(rok)[j])
            if ok}
        p = {(int(a), int(b)) for a, b, ok in zip(
            pli[j].numpy(), pri[j].numpy(), pok[j].numpy()) if ok}
        assert p == r, j
        for a, b in p:
            assert lkeys[j * C + a] == rkeys[b]
        matched += len(p)
    want = sum(int((rkeys == k).sum()) for k, v in zip(lkeys, lvalid) if v)
    assert matched == want


def test_exchange_program_memo_is_reused():
    tm = tmesh.get_mesh()
    rng = np.random.default_rng(1)
    T = N * 16
    pid = rng.integers(0, N, T).astype(np.int32)
    ones = np.ones(T, dtype=bool)
    before = tex.exchange_cache_counters()
    for _ in range(2):
        tex.sharded_hash_repartition(
            tm, (tex.shard_blocks(tm, rng.normal(size=T)),),
            (tex.shard_blocks(tm, ones),), tex.shard_blocks(tm, ones),
            tex.shard_blocks(tm, pid))
    after = tex.exchange_cache_counters()
    assert after["hits"] - before["hits"] >= 1


# ------------------------------------------------- through the engines

def _both(q):
    """The query through the reference (device tier, 8-device mesh) and
    through the port (8-shard CPU mesh)."""
    return (q(daft_tpu).to_pydict(), q(daft_tpu_torch).to_pydict())


def _same(got, want):
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c]), c
        for a, b in zip(got[c], want[c]):
            if isinstance(b, float) and isinstance(a, float):
                assert abs(a - b) <= REL * max(abs(a), abs(b), 1.0), (c, a, b)
            else:
                assert a == b, (c, a, b)


def _plans_exchange_agg(q):
    r = rpt.translate(q(daft_tpu)._builder.optimize().plan)
    p = tpt.translate(q(daft_tpu_torch)._builder.optimize().plan)
    return _has(r, rpp.DeviceExchangeAgg), _has(p, tpp.DeviceExchangeAgg)


def _groupby_data(seed, n, nk):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nk, n)
    vals = rng.uniform(-100, 100, n)
    nulls = rng.random(n) < 0.1
    return {"k": keys.tolist(),
            "v": [None if m else float(v) for v, m in zip(vals, nulls)],
            "w": rng.integers(0, 1000, n).tolist()}


GROUPBY_CASES = {
    "sum_min_max": lambda pkg, d: pkg.from_pydict(d).groupby("k").agg(
        pkg.col("v").sum().alias("s"), pkg.col("v").min().alias("lo"),
        pkg.col("v").max().alias("hi")).sort("k"),
    "mean_count": lambda pkg, d: pkg.from_pydict(d).groupby("k").agg(
        pkg.col("v").mean().alias("m"),
        pkg.col("v").count().alias("c")).sort("k"),
    "multi_key": lambda pkg, d: pkg.from_pydict(d).groupby("k", "w").agg(
        pkg.col("v").sum().alias("s")).sort(["k", "w"]),
    "string_keys": lambda pkg, d: pkg.from_pydict(
        {"k": ["x", "y", "x", "z", None] * 50,
         "v": list(range(250))}).groupby("k").agg(
        pkg.col("v").sum().alias("s")).sort("k"),
    "string_min_max": lambda pkg, d: pkg.from_pydict(
        {"g": [i % 4 for i in range(200)],
         "s": [f"w{i % 23:03d}" for i in range(200)]}).groupby("g").agg(
        pkg.col("s").min().alias("lo"),
        pkg.col("s").max().alias("hi")).sort("g"),
}


@pytest.mark.parametrize("name", list(GROUPBY_CASES))
def test_groupby_through_mesh_exchange(name):
    d = _groupby_data(7, 3000, 37)
    q = lambda pkg: GROUPBY_CASES[name](pkg, d)  # noqa: E731
    assert _plans_exchange_agg(q) == (True, True)
    want, got = _both(q)
    _same(got, want)


def test_repartition_hash_through_mesh():
    from daft_tpu_torch.execution import executor as ex_mod
    calls = {"n": 0}
    orig = ex_mod.LocalExecutor._mesh_hash_repartition

    def spy(self, parts, by, k):
        out = orig(self, parts, by, k)
        if out is not None:
            calls["n"] += 1
        return out

    ex_mod.LocalExecutor._mesh_hash_repartition = spy
    try:
        parts = daft_tpu_torch.from_pydict(
            {"k": list(range(1000)), "v": [i * 0.5 for i in range(1000)],
             "s": [f"s{i % 17}" for i in range(1000)]}) \
            .repartition(N, daft_tpu_torch.col("k"))
        assert parts.num_partitions() == N
        out = parts.to_pydict()
        got = parts.groupby("k").agg(
            daft_tpu_torch.col("v").sum().alias("s")).sort("k").to_pydict()
    finally:
        ex_mod.LocalExecutor._mesh_hash_repartition = orig
    assert calls["n"] >= 1
    assert sorted(out["k"]) == list(range(1000))
    assert sorted(zip(out["k"], out["s"])) == \
        [(i, f"s{i % 17}") for i in range(1000)]
    assert got["k"] == list(range(1000))
    assert got["s"] == [i * 0.5 for i in range(1000)]


def test_mesh_repartition_agrees_with_host_partitioning():
    """The mesh repartition routes by the engine-wide xxh64 chain, so
    partition i holds the rows the host exchange puts in partition i."""
    rng = np.random.default_rng(2)
    d = {"k": rng.integers(0, 50, 600).tolist(),
         "v": rng.normal(size=600).tolist()}
    mesh_parts = [sorted(p.to_pydict()["k"]) for p in
                  daft_tpu_torch.from_pydict(d).repartition(N, "k")
                  .iter_partitions()]
    import os
    os.environ["DAFT_TORCH_DEVICE"] = "0"
    try:
        host_parts = [sorted(p.to_pydict()["k"]) for p in
                      daft_tpu_torch.from_pydict(d).repartition(N, "k")
                      .iter_partitions()]
    finally:
        os.environ["DAFT_TORCH_DEVICE"] = "cpu"
    assert mesh_parts == host_parts


def test_mesh_collective_failure_propagates(monkeypatch):
    """Unlike the reference (which falls back to the host exchange on any
    exception inside the collective), a failure in the port's collective
    reaches the caller; only planned declines fall back."""
    def boom(*a, **k):
        raise RuntimeError("collective failed")

    monkeypatch.setattr(tex, "sharded_grouped_agg", boom)
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    with pytest.raises(RuntimeError, match="collective failed"):
        df.groupby("k").agg(daft_tpu_torch.col("v").sum()).to_pydict()


# ---------------------------------------------- dryrun_multichip, ported

@pytest.mark.parametrize("step", ["grouped_sum", "engine_groupby",
                                  "repartition_join", "range_sort",
                                  "broadcast_join", "window", "tpch_q1"])
def test_dryrun_multichip_step(step, tmp_path):
    from daft_tpu_torch.benchmarking import mesh_dryrun
    mesh_dryrun.STEPS[step](N, str(tmp_path))


# --------------------------------------------------- the cost gates

@pytest.mark.parametrize("rows,row_bytes", [(None, 32.0), (0, 8.0),
                                            (1_000, 16.0), (50_000, 200.0),
                                            (100_000, 8.0),
                                            (10_000_000, 40.0)])
def test_mesh_gates_decide_as_the_reference(monkeypatch, rows, row_bytes):
    """With the link rate given (``*_ICI_MBPS``), the mesh admission and
    the exchange-path pricing decide as the reference's."""
    from daft_tpu.device import costmodel as r_cm
    from daft_tpu_torch.device import costmodel as cm
    monkeypatch.setenv("DAFT_TPU_ICI_MBPS", "2000")
    monkeypatch.setenv("DAFT_TORCH_ICI_MBPS", "2000")
    monkeypatch.setattr(r_cm, "_ici", None)
    cm.reset_ici_for_tests()
    try:
        assert cm.ici_bps() == r_cm.ici_bps() == 2e9
        assert cm.mesh_exchange_wins(rows, row_bytes, N) == \
            r_cm.mesh_exchange_wins(rows, row_bytes, N)
        assert cm.exchange_collective_wins(rows, row_bytes) == \
            r_cm.exchange_collective_wins(rows, row_bytes)
    finally:
        cm.reset_ici_for_tests()
        monkeypatch.setattr(r_cm, "_ici", None)


def test_admission_is_priced_when_the_knob_is_unset(monkeypatch):
    """``MESH_MIN_ROWS`` unset: ``mesh_admits`` asks the cost model, which
    measures the mesh once (a rate and a fixed cost) and logs the
    decision."""
    from daft_tpu_torch.device import costmodel as cm
    monkeypatch.delenv("DAFT_TORCH_MESH_MIN_ROWS")
    monkeypatch.delenv("DAFT_TORCH_ICI_MBPS", raising=False)
    cm.reset_ici_for_tests()
    cm.reset_decision_counts()
    try:
        rate, dispatch = cm._measure_ici()
        assert rate > 0 and dispatch >= 0
        assert tmesh.mesh_admits(None) is True
        assert tmesh.mesh_admits(0) is False
        tmesh.mesh_admits(10 ** 7, 64.0)
        assert sum(cm.decision_counts_snapshot()["mesh_exchange"].values()) \
            == 1
        assert cm.ici_bps() > 0 and cm.mesh_dispatch_s() >= 0
    finally:
        cm.reset_ici_for_tests()
