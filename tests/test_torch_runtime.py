"""The port's per-operator device paths (``daft_tpu_torch/device/runtime.py``)
held against the reference's (``daft_tpu/device/runtime.py``) on the same
seeded frames.

The reference runs on JAX-CPU with ``DAFT_TPU_DEVICE_FORCE=1``, so its cost
gates never decline; the port runs on CPU tensors
(``DAFT_TORCH_DEVICE=cpu``) with its row floor at 0
(``DAFT_TORCH_DEVICE_MIN_ROWS=0``). Argsort permutations, projection
outputs and predicate masks must be equal; aggregation groups are
compared as sets keyed by their keys (group order is unspecified engine
wide), keys, counts, integer aggregates, strings, min/max and any_value
exactly, float sums and means at relative 1e-9, variances at 1e-9 of
E[x²] (the scale of the one-pass formula's cancellation). Values carry no
NaN
(the reference's dense and sort strategies spread a NaN over every
group; ROADMAP Queue C).
"""

import datetime
import os
import sys
import threading
import time

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.device import kernels as ref_kernels, runtime as ref_rt
from daft_tpu.recordbatch import RecordBatch as RefBatch
from daft_tpu_torch.device import hash_kernels as hk
from daft_tpu_torch.device import kernels as port_kernels
from daft_tpu_torch.device import runtime as port_rt
from daft_tpu_torch.recordbatch import RecordBatch as PortBatch

REL = 1e-9


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_DEVICE", "1")
    monkeypatch.setenv("DAFT_TPU_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    monkeypatch.delenv("DAFT_TORCH_KERNEL_GROUPBY", raising=False)
    port_rt.reset_counters()


def _nulls(rng, vals, frac):
    return [None if rng.random() < frac else v for v in vals]


# ----------------------------------------------------------------- argsort

def _sort_frame(rng, n, dtypes):
    """Random columns with nulls and ties (the shape of
    ``tests/test_device_kernels.py``), floats with -0.0, +0.0, ±inf and
    NaN among them."""
    data = {}
    for i, dt in enumerate(dtypes):
        frac = float(rng.choice([0.0, 0.15, 0.5]))
        if dt == "int":
            v = rng.integers(-2**40, 2**40, n).tolist()
        elif dt == "small_int":
            v = rng.integers(-3, 3, n).tolist()
        elif dt == "float":
            v = np.round(rng.uniform(-1e6, 1e6, n), 3)
            special = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 1.5])
            pick = rng.random(n) < 0.3
            v[pick] = rng.choice(special, int(pick.sum()))
            v = v.tolist()
        elif dt == "bool":
            v = (rng.random(n) > 0.5).tolist()
        else:
            v = ["s" + str(rng.integers(0, 8)) for _ in range(n)]
        data[f"c{i}"] = _nulls(rng, v, frac)
    return data


@pytest.mark.parametrize("seed", range(12))
def test_argsort_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 300))
    n_keys = int(rng.integers(1, 4))
    dtypes = [str(rng.choice(["int", "small_int", "float", "bool",
                              "string"])) for _ in range(n_keys)]
    data = _sort_frame(rng, n, dtypes)
    ref_cols = RefBatch.from_pydict(data).columns()
    port_cols = PortBatch.from_pydict(data).columns()
    for _ in range(5):
        desc = [bool(rng.integers(0, 2)) for _ in range(n_keys)]
        nf = [bool(rng.integers(0, 2)) for _ in range(n_keys)]
        want = ref_rt.try_argsort(ref_cols, desc, nf)
        got = port_rt.try_argsort(port_cols, desc, nf)
        assert want is not None and got is not None
        assert got.tolist() == want.tolist(), (dtypes, desc, nf)
    assert port_rt.counters()["argsort"] == 5


def test_compaction_perm_matches_reference():
    import jax.numpy as jnp
    import torch
    mask = np.random.default_rng(4).random(257) < 0.4
    want = np.asarray(ref_kernels.compaction_perm(jnp.asarray(mask)))
    got = port_kernels.compaction_perm(torch.from_numpy(mask)).numpy()
    assert got.tolist() == want.tolist()


# ------------------------------------------------- projection and predicate

def _frame(rng, n):
    base = datetime.date(1992, 1, 1)
    return {
        "i": _nulls(rng, rng.integers(-50, 50, n).tolist(), 0.1),
        "f": _nulls(rng, np.round(rng.uniform(-100, 100, n), 2).tolist(),
                    0.1),
        "b": _nulls(rng, (rng.random(n) > 0.5).tolist(), 0.1),
        "s": _nulls(rng, ["k" + str(rng.integers(0, 6)) for _ in range(n)],
                    0.1),
        "d": _nulls(rng, [base + datetime.timedelta(days=int(x))
                          for x in rng.integers(0, 2500, n)], 0.1),
    }


def _projection(pkg):
    c, lit = pkg.col, pkg.lit
    return [c("i"), c("s"),
            (c("i") * 3 + c("f")).alias("lin"),
            (c("f") / (c("i") + 100)).alias("ratio"),
            (c("i") > 0).alias("pos"),
            (c("s") == "k2").alias("eq"),
            (c("s") < "k3").alias("lt"),
            c("i").is_in([1, 2, 3, -7]).alias("isin"),
            (c("f") > 0).if_else(c("f"), lit(0.0)).alias("clip"),
            c("d").dt.year().alias("year"),
            (c("b") & (c("i") < 10)).alias("both"),
            c("f").between(-10.0, 10.0).alias("mid")]


def _predicates(pkg):
    c, lit = pkg.col, pkg.lit
    return [(c("i") > 3) & (c("s") != "k1"),
            (c("d") >= lit(datetime.date(1994, 1, 1)))
            | c("f").is_in([0.5, -1.25]),
            c("b"),
            ~(c("s") == "k4") & (c("f") * 2 < c("i"))]


@pytest.mark.parametrize("seed", range(3))
def test_projection_matches_reference(seed):
    data = _frame(np.random.default_rng(seed), 500 + 37 * seed)
    want = ref_rt.try_eval_projection(RefBatch.from_pydict(data),
                                      _projection(daft_tpu))
    got = port_rt.try_eval_projection(PortBatch.from_pydict(data),
                                      _projection(daft_tpu_torch))
    assert want is not None and got is not None
    assert got.to_pydict() == want.to_pydict()
    assert port_rt.counters()["projection"] == 1


@pytest.mark.parametrize("which", range(4))
def test_predicate_matches_reference(which):
    data = _frame(np.random.default_rng(10 + which), 700)
    want = ref_rt.try_eval_predicate(RefBatch.from_pydict(data),
                                     _predicates(daft_tpu)[which])
    got = port_rt.try_eval_predicate(PortBatch.from_pydict(data),
                                     _predicates(daft_tpu_torch)[which])
    assert want is not None and got is not None
    assert got.dtype == np.bool_ and got.tolist() == want.tolist()
    assert port_rt.counters()["predicate"] == 1


def test_recordbatch_hooks_run_the_device_paths():
    """filter → projection → sort through ``RecordBatch`` equals the host
    tier, and each hook dispatched once."""
    data = _frame(np.random.default_rng(7), 400)
    c = daft_tpu_torch.col
    rb = PortBatch.from_pydict(data)

    def run():
        return (rb.filter(c("i") > -20)
                .eval_expression_list([c("s"), c("f"),
                                       (c("i") * 2).alias("i2")])
                .sort([c("s"), c("f")], descending=[False, True]))
    got = run().to_pydict()
    assert {k: port_rt.counters().get(k) for k in
            ("predicate", "projection", "argsort")} == \
        {"predicate": 1, "projection": 1, "argsort": 1}
    with daft_tpu_torch.execution_config_ctx(device="0"):
        assert run().to_pydict() == got


# --------------------------------------------------------------------- agg

def _agg_frame(rng, n):
    d = _frame(rng, n)
    d["v"] = _nulls(rng, np.round(rng.uniform(0, 100, n), 2).tolist(), 0.1)
    d["g"] = rng.integers(0, 9, n).tolist()
    return d


def _aggs(pkg):
    c = pkg.col
    return [c("v").sum().alias("sum_v"), c("v").mean().alias("mean_v"),
            c("v").min().alias("min_v"), c("i").max().alias("max_i"),
            c("v").count().alias("n_v"), c("v").stddev().alias("std_v"),
            c("v").var().alias("var_v"), c("i").sum().alias("sum_i"),
            c("f").any_value().alias("any_f"),
            c("b").bool_and().alias("all_b"), c("b").bool_or().alias("any_b"),
            c("s").min().alias("min_s"), c("s").max().alias("max_s")]


def _groups(d, keys):
    rows = {}
    n = len(d[next(iter(d))]) if d else 0
    for r in range(n):
        k = tuple(d[x][r] for x in keys)
        assert k not in rows, f"duplicate group {k}"
        rows[k] = {x: d[x][r] for x in d if x not in keys}
    return rows


def _same_groups(got, want, keys):
    g, w = _groups(got, keys), _groups(want, keys)
    assert set(g) == set(w)
    assert list(got) == list(want)
    for k in w:
        for col, b in w[k].items():
            a = g[k][col]
            if col in ("std_v", "var_v") and a is not None:
                # the one-pass formula E[x²] − mean² cancels: its error
                # scales with E[x²], not with the variance (a group of one
                # value reads 0 on one side, 1e-13 on the other)
                sq = (lambda x: x * x) if col == "std_v" else (lambda x: x)
                scale = w[k]["mean_v"] ** 2 + sq(b)
                assert abs(sq(a) - sq(b)) <= REL * scale, (k, col, a, b)
            elif isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(a), abs(b)), (k, col, a, b)
            else:
                assert a == b, (k, col, a, b)


KEYSETS = {"int": ["g"], "string": ["s"], "string+date+bool": ["s", "d", "b"],
           "nullable int": ["i"]}
STRATEGIES = ["hash", "sort"]


@pytest.mark.parametrize("keys", list(KEYSETS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_agg_matches_reference(monkeypatch, keys, strategy):
    # asked for explicitly: `auto` on CPU tensors takes sort (the cost
    # model's rule: the hash kernels are compiled for a card)
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", strategy)
    data = _agg_frame(np.random.default_rng(len(keys) * 7 + 1), 900)
    names = KEYSETS[keys]
    want = ref_rt.try_agg(RefBatch.from_pydict(data), _aggs(daft_tpu),
                          [daft_tpu.col(k) for k in names])
    got = port_rt.try_agg(PortBatch.from_pydict(data),
                          _aggs(daft_tpu_torch),
                          [daft_tpu_torch.col(k) for k in names])
    assert want is not None and got is not None
    _same_groups(got.to_pydict(), want.to_pydict(), names)
    counts = port_rt.counters()
    assert counts.get("agg_" + strategy) == 1, counts
    other = "sort" if strategy == "hash" else "hash"
    assert not counts.get("agg_" + other), counts


def test_wide_key_set_takes_the_sort_strategy():
    """int64 + int64 keys pack 130 bits, past the hash table's 128: the
    scatter-form sort runs, as the reference's width error routes it."""
    rng = np.random.default_rng(5)
    data = {"a": rng.integers(0, 4, 300).tolist(),
            "b": (rng.integers(0, 3, 300) * 2**40).tolist(),
            "v": rng.uniform(0, 1, 300).tolist()}
    keys = ["a", "b"]
    want = ref_rt.try_agg(RefBatch.from_pydict(data),
                          [daft_tpu.col("v").sum()],
                          [daft_tpu.col(k) for k in keys])
    got = port_rt.try_agg(PortBatch.from_pydict(data),
                          [daft_tpu_torch.col("v").sum()],
                          [daft_tpu_torch.col(k) for k in keys])
    _same_groups(got.to_pydict(), want.to_pydict(), keys)
    assert port_rt.counters().get("agg_sort") == 1


def test_global_agg_matches_reference():
    data = _agg_frame(np.random.default_rng(3), 600)
    want = ref_rt.try_agg(RefBatch.from_pydict(data), _aggs(daft_tpu), [])
    got = port_rt.try_agg(PortBatch.from_pydict(data),
                          _aggs(daft_tpu_torch), [])
    assert want is not None and got is not None
    _same_groups(got.to_pydict(), want.to_pydict(), [])
    assert port_rt.counters().get("agg_global") == 1


def test_scatter_form_matches_reference_kernel():
    """``kernels.grouped_agg_impl`` against the reference's on the same
    planes: groups in ascending key order on both, so row for row."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(11)
    C, n = 512, 431
    kv = rng.random(C) > 0.1
    # a null key's plane holds 0, as the encode fills it
    k = np.where(kv, rng.integers(-5, 5, C), 0).astype(np.int64)
    v = np.round(rng.uniform(-50, 50, C), 2)
    vv = rng.random(C) > 0.2
    mask = np.arange(C) < n
    ops = ("sum", "count", "min", "max", "mean", "any_value")
    ref = ref_kernels.grouped_agg_kernel(
        (jnp.asarray(k),), (jnp.asarray(kv),), (jnp.asarray(v),) * 6,
        (jnp.asarray(vv),) * 6, jnp.asarray(mask), ops)
    t = torch.from_numpy
    got = port_kernels.grouped_agg_impl(
        (t(k),), (t(kv),), (t(v),) * 6, (t(vv),) * 6, t(mask), ops)
    g = int(got[4])
    assert g == int(ref[4])
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        assert a.numpy()[:g].tolist() == np.asarray(b)[:g].tolist()
    for i, op in enumerate(ops):
        m = np.asarray(ref[3][i])[:g]
        assert got[3][i].numpy()[:g].tolist() == m.tolist(), op
        np.testing.assert_allclose(got[2][i].numpy()[:g][m],
                                   np.asarray(ref[2][i])[:g][m], rtol=REL,
                                   err_msg=op)


def test_aggregate_hook_runs_the_device_path(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", "hash")
    data = _agg_frame(np.random.default_rng(2), 300)
    c = daft_tpu_torch.col
    rb = PortBatch.from_pydict(data)
    got = rb.agg([c("v").sum().alias("sv")], [c("g")]).to_pydict()
    assert port_rt.counters().get("agg_hash") == 1
    with daft_tpu_torch.execution_config_ctx(device="0"):
        host = rb.agg([c("v").sum().alias("sv")], [c("g")]).to_pydict()
    _same_groups(got, host, ["g"])


# ------------------------------------------------------ declines and floor

def test_row_floor_sends_small_batches_to_the_host(monkeypatch):
    monkeypatch.delenv("DAFT_TORCH_DEVICE_MIN_ROWS")
    data = _agg_frame(np.random.default_rng(1), 200)
    rb = PortBatch.from_pydict(data)
    c = daft_tpu_torch.col
    assert port_rt.try_eval_projection(rb, [c("i") + 1]) is None
    assert port_rt.try_eval_predicate(rb, c("i") > 1) is None
    assert port_rt.try_argsort([rb.get_column("i")], [False], [False]) \
        is None
    assert port_rt.try_agg(rb, [c("v").sum()], [c("g")]) is None
    assert port_rt.counters() == {"host_ops": 4}
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "200")
    assert port_rt.try_agg(rb, [c("v").sum()], [c("g")]) is not None


def test_host_tier_and_non_device_cases_decline(monkeypatch):
    data = _agg_frame(np.random.default_rng(1), 50)
    rb = PortBatch.from_pydict(data)
    c = daft_tpu_torch.col
    # a string function has no device lowering; count_distinct no device
    # agg; a computed string output no dictionary to decode through
    assert port_rt.try_eval_projection(
        rb, [c("s").str.startswith("k1")]) is None
    assert port_rt.try_agg(rb, [c("v").count_distinct()], [c("g")]) is None
    assert port_rt.try_agg(rb, [c("v").sum()], [c("s").str.left(1)]) is None
    assert port_rt.counters() == {}
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    assert port_rt.try_eval_predicate(rb, c("i") > 1) is None
    assert port_rt.try_agg(rb, [c("v").sum()], [c("g")]) is None
    assert port_rt.counters() == {}


def test_compile_cache_is_single_flight(monkeypatch):
    """Eight threads asking for one uncached projection: one compile, the
    others wait for it and then hit."""
    from daft_tpu_torch.device import compiler
    calls = []
    real = compiler.compile_projection
    gate = threading.Event()

    def slow(exprs, schema):
        calls.append(1)
        gate.wait(5)
        return real(exprs, schema)
    monkeypatch.setattr(compiler, "compile_projection", slow)
    rb = PortBatch.from_pydict({"x": [1, 2, 3], "zz_single": [4, 5, 6]})
    exprs = [(daft_tpu_torch.col("x") * 17 + daft_tpu_torch.col(
        "zz_single")).alias("y")]
    before = port_rt.compile_cache_counters()
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        port_rt._get_compiled(exprs, rb.schema))) for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while port_rt.compile_cache_counters()["waits"] - before["waits"] < 7 \
            and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    after = port_rt.compile_cache_counters()
    assert len(calls) == 1 and len({id(c) for c in out}) == 1
    assert after["compiles"] - before["compiles"] == 1
    assert after["misses"] - before["misses"] == 1


def test_hash_agg_launch_counter_is_thread_safe():
    """More threads than cores bump the counter with a short switch
    interval: a lost update would leave it short."""
    hk.reset_launches()
    n = 2 * (os.cpu_count() or 4)
    threads = [threading.Thread(
        target=lambda: [hk._launched() for _ in range(2000)])
        for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert hk.launches == 2000 * n
    hk.reset_launches()
    assert hk.launches == 0


@pytest.mark.cuda
def test_operator_paths_on_the_card_match_reference(monkeypatch):
    """The same parity on CUDA tensors: argsort, projection, predicate,
    and the grouped agg through the hash kernel and the sort strategy."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cuda")
    hk.reset_launches()
    rng = np.random.default_rng(21)
    data = _sort_frame(rng, 5000, ["float", "string", "small_int"])
    ref_cols = RefBatch.from_pydict(data).columns()
    port_cols = PortBatch.from_pydict(data).columns()
    for desc, nf in (([False, True, False], [True, False, False]),
                     ([True, False, True], [False, False, True])):
        want = ref_rt.try_argsort(ref_cols, desc, nf)
        assert port_rt.try_argsort(port_cols, desc, nf).tolist() == \
            want.tolist()
    data = _frame(np.random.default_rng(22), 6000)
    want = ref_rt.try_eval_projection(RefBatch.from_pydict(data),
                                      _projection(daft_tpu))
    got = port_rt.try_eval_projection(PortBatch.from_pydict(data),
                                      _projection(daft_tpu_torch))
    assert got.to_pydict() == want.to_pydict()
    for which in range(4):
        want = ref_rt.try_eval_predicate(RefBatch.from_pydict(data),
                                         _predicates(daft_tpu)[which])
        got = port_rt.try_eval_predicate(PortBatch.from_pydict(data),
                                         _predicates(daft_tpu_torch)[which])
        assert got.tolist() == want.tolist()
    data = _agg_frame(np.random.default_rng(23), 9000)
    for strategy in STRATEGIES:
        monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", strategy)
        for names in KEYSETS.values():
            want = ref_rt.try_agg(RefBatch.from_pydict(data),
                                  _aggs(daft_tpu),
                                  [daft_tpu.col(k) for k in names])
            got = port_rt.try_agg(PortBatch.from_pydict(data),
                                  _aggs(daft_tpu_torch),
                                  [daft_tpu_torch.col(k) for k in names])
            _same_groups(got.to_pydict(), want.to_pydict(), names)
    counts = port_rt.counters()
    assert counts["agg_hash"] == counts["agg_sort"] == len(KEYSETS)
    assert hk.launches == len(KEYSETS)


# ------------------------------------------- per-operator floor benchmark

@pytest.mark.parametrize("op", ["projection", "predicate", "argsort",
                                "agg_grouped", "agg_global"])
def test_op_floor_runs_each_path_against_the_host_tier(op):
    """``benchmarking/op_floor.py`` on CPU tensors at a small batch: the
    device call counts its dispatch, its answer equals the host tier's,
    and the floor knob is put back."""
    from daft_tpu_torch.benchmarking import op_floor
    rec = op_floor.measure(op, 256, 1, 0)
    assert os.environ["DAFT_TORCH_DEVICE_MIN_ROWS"] == "0"
    assert rec["dispatch"] in op_floor.COUNTERS[op]
    assert rec["calls_per_tier"] == 2 and rec["host_ms"] > 0
    assert rec["device_ms"] > 0


def test_op_floor_crossover_is_the_least_row_count_that_stays_faster():
    from daft_tpu_torch.benchmarking import op_floor

    def rec(op, rows, dev, host):
        return dict(op=op, rows=rows, device_ms=dev, host_ms=host)
    recs = [rec("projection", 1, 2, 1), rec("projection", 4, 1, 2),
            rec("projection", 16, 1, 2), rec("argsort", 1, 1, 2),
            rec("argsort", 4, 2, 1), rec("argsort", 16, 1, 2),
            rec("predicate", 1, 1, 2), rec("predicate", 4, 2, 1)]
    got = op_floor.crossover(recs)
    assert got["projection"] == 4 and got["argsort"] == 16
    assert got["predicate"] is None and got["agg_global"] is None
