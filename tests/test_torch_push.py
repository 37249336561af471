"""The port's local engine: the runner (``runners/native_runner.py``), the
push pipeline (``execution/pipeline.py``) and the reference's exchange
placement (``physical/translate.py``).

- Plan parity: for all 22 TPC-H queries (SF 0.003, 3 files per table) and
  the 99 TPC-DS queries at scale 0.01, the port's physical tree has
  ``daft_tpu``'s node types, exchange kinds and partition counts, join
  strategies and fusion-region shapes: at both packages' default scan
  config (small files merge into one task, ``scan_tasks_min_size_bytes``
  96MB, so these plans are mostly one partition) and with that floor at 0
  in both (one task per file: three-way exchanges). The reference's
  device-mesh exchange-agg (``DeviceExchangeAgg``) stays out of the
  comparison: the port plans it only on a mesh the caller asks for
  (``DAFT_TORCH_MESH_DEVICES``; ``tests/test_torch_exchange.py``), so the
  reference plans with a one-device mesh.
- The same for a written TPC-H query (a ``Write`` root) and a
  hive-partitioned CSV scan.
- Engine parity: TPC-H queries under ``push`` and ``interp`` equal each
  other and ``daft_tpu`` (keys, counts and strings exact, floats at
  relative 1e-9); so do Q1 and Q3 over parquet served by a local HTTP
  store (planned range reads, the prefetch-pipelined scan), and a
  ``Write``-rooted Q1 read back after the push engine, the interpreter
  and the AQE loop wrote it.
- The pipeline's own contracts: bounded channels with producer-refcounted
  close, cancellation unblocking every stage, the first error re-raised at
  the consumer, no stage thread left after a query (an early limit
  included), and the partitioned-agg stage's choice.
"""

import os
import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch
from benchmarking.tpcds import queries as DQ
from benchmarking.tpcds.datagen import generate_tpcds
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch
from daft_tpu_torch.execution import pipeline

REL = 1e-9


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_push")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


@pytest.fixture(scope="module")
def tpcds_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpcds_torch_push")
    generate_tpcds(str(root), scale=0.01, seed=0)
    return str(root)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


# ------------------------------------------------------------ plan parity

def _sig(n):
    t = type(n).__name__
    extra = ()
    if t == "Exchange":
        extra = (n.kind, n.num_partitions)
    elif t == "HashJoin":
        extra = (n.strategy,)
    elif t == "FusedRegion":
        extra = (n.shape,)
    return (t,) + extra + (tuple(_sig(c) for c in n.children),)


#: the scan config both packages plan under: their defaults, or one
#: scan task per file
SCAN_CONFIGS = {"default": {}, "task_per_file": {"scan_tasks_min_size_bytes": 0}}


@pytest.fixture(params=sorted(SCAN_CONFIGS))
def ref_planning(monkeypatch, request):
    """Both packages at one scan config; the reference without its device
    mesh (see the module docstring)."""
    from daft_tpu.parallel import mesh
    monkeypatch.setattr(mesh, "mesh_size", lambda: 1)
    kv = SCAN_CONFIGS[request.param]
    old = daft_tpu.get_context().execution_config
    daft_tpu.set_execution_config(**kv)
    with daft_tpu_torch.execution_config_ctx(**kv):
        yield
    daft_tpu.set_execution_config(old)


def _ref_plan(df):
    from daft_tpu.physical.translate import translate
    return _sig(translate(df._builder.optimize()._plan))


def _port_plan(df):
    from daft_tpu_torch.physical.translate import translate
    return _sig(translate(df.builder.optimize().plan))


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_plan_parity(tpch_root, ref_planning, q):
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    assert _port_plan(Q.ALL[q](_reader(daft_tpu_torch, tpch_root))) \
        == _ref_plan(RQ.ALL[q](_reader(daft_tpu, tpch_root)))


@pytest.mark.parametrize("q", sorted(DQ.ALL))
def test_tpcds_plan_parity(tpcds_root, ref_planning, q):
    from daft_tpu_torch.benchmarking import tpcds_sql
    assert _port_plan(tpcds_sql.run(q, _reader(daft_tpu_torch, tpcds_root))) \
        == _ref_plan(DQ.run(q, _reader(daft_tpu, tpcds_root)))


def test_scan_tasks_merge_and_split_as_the_reference(tpch_root, tmp_path):
    """The port's scan tasks group the same files (and row groups), in the
    same order, as the reference's at each scan config, and at one that
    splits a file of many row groups into row-group ranges."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from daft_tpu.io.scan import Pushdowns as RPush
    from daft_tpu_torch.io.scan import Pushdowns
    rng = np.random.default_rng(3)
    for i, n in enumerate((40_000, 900, 700, 30_000, 500)):
        pq.write_table(pa.table({"k": rng.integers(0, 99, n),
                                 "v": rng.random(n)}),
                       str(tmp_path / f"part{i}.parquet"),
                       row_group_size=5_000)
    configs = dict(SCAN_CONFIGS, split={"scan_tasks_max_size_bytes": 100_000,
                                        "scan_tasks_min_size_bytes": 30_000})
    paths = [f"{tpch_root}/{t}/*.parquet" for t in ("lineitem", "nation")]
    paths.append(f"{tmp_path}/*.parquet")
    split = False
    for path in paths:
        for kv in configs.values():
            old = daft_tpu.get_context().execution_config
            daft_tpu.set_execution_config(**kv)
            try:
                want = daft_tpu.read_parquet(path)._builder._plan.scan_op \
                    .to_scan_tasks(RPush())
            finally:
                daft_tpu.set_execution_config(old)
            with daft_tpu_torch.execution_config_ctx(**kv):
                got = daft_tpu_torch.read_parquet(path).builder.plan \
                    .scan_op.to_scan_tasks(Pushdowns())
            assert [(t.paths, t.row_groups, t.num_rows(), t.size_bytes())
                    for t in got] == \
                [(t.paths, t.row_groups, t.num_rows(), t.size_bytes())
                 for t in want], (path, kv)
            split |= any(t.row_groups is not None for t in got)
            if kv == {}:
                assert len(got) == 1, (path, got)
    assert split


def _write_plans(tpch_root, out_dir):
    """A written TPC-H query (Q1 partitioned by its flag) and a
    hive-partitioned CSV scan, planned by each package."""
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    part = str(out_dir / "li_csv")
    if not os.path.isdir(part):
        daft_tpu_torch.read_parquet(f"{tpch_root}/lineitem/*.parquet") \
            .select("l_returnflag", "l_quantity", "l_extendedprice") \
            .write_csv(part, partition_cols=["l_returnflag"])

    def hive(pkg):
        return pkg.read_csv(f"{part}/**/*.csv", hive_partitioning=True) \
            .where(pkg.col("l_quantity") > 10).groupby("l_returnflag") \
            .agg(pkg.col("l_extendedprice").sum()).sort("l_returnflag")
    port = [Q.q1(_reader(daft_tpu_torch, tpch_root)).builder.table_write(
                "parquet", str(out_dir / "w"), ["l_returnflag"]),
            hive(daft_tpu_torch).builder]
    ref = [RQ.ALL[1](_reader(daft_tpu, tpch_root))._builder.table_write(
               "parquet", str(out_dir / "w"), ["l_returnflag"]),
           hive(daft_tpu)._builder]
    return port, ref


def test_write_and_hive_csv_plan_parity(tpch_root, ref_planning, tmp_path):
    from daft_tpu.physical.translate import translate as ref_translate
    from daft_tpu_torch.physical.translate import translate
    port, ref = _write_plans(tpch_root, tmp_path)
    for got, want in zip(port, ref):
        assert _sig(translate(got.optimize().plan)) \
            == _sig(ref_translate(want.optimize()._plan))
    assert _sig(translate(port[0].optimize().plan))[0] == "Write"


@pytest.mark.parametrize("mode", ["push", "interp", "aqe"])
def test_write_rooted_plan_runs_on_each_engine(tpch_root, tmp_path,
                                               monkeypatch, mode):
    """A plan with a ``Write`` root runs under the push engine, the
    interpreter and the AQE loop: the files it lists read back to the
    reference's answer."""
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.dataframe import DataFrame
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR",
                       "interp" if mode == "interp" else "push")
    want = RQ.ALL[1](_reader(daft_tpu, tpch_root)).to_pydict()
    out = tmp_path / "q1"
    with daft_tpu_torch.execution_config_ctx(enable_aqe=mode == "aqe"):
        res = DataFrame(Q.q1(_reader(daft_tpu_torch, tpch_root)).builder
                        .table_write("parquet", str(out),
                                     ["l_returnflag"])).to_pydict()
    assert sorted(set(res["l_returnflag"])) == sorted(
        set(want["l_returnflag"]))
    assert all(p.startswith(str(out)) for p in res["path"])
    got = daft_tpu_torch.read_parquet(f"{out}/**/*.parquet",
                                      hive_partitioning=True) \
        .sort(["l_returnflag", "l_linestatus"]).select(*want).to_pydict()
    _same(got, want, f"written q1 {mode}")


@pytest.mark.parametrize("q", [1, 3])
def test_remote_tpch_answers_match_the_reference(tpch_root, monkeypatch, q):
    """TPC-H over parquet served by a local HTTP store, through the
    planned reads and the prefetch-pipelined scan: the port's answers
    under both engines equal the reference's over the same URLs."""
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.benchmarking.http_store import FileStore
    from daft_tpu_torch.io import read_planner as rp
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    with FileStore(tpch_root) as store:
        want = RQ.ALL[q](lambda t: daft_tpu.read_parquet(
            store.urls(t))).to_pydict()
        for engine in ("push", "interp"):
            monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
            before = rp.scan_counters_snapshot()
            got = Q.ALL[q](lambda t: daft_tpu_torch.read_parquet(
                store.urls(t))).to_pydict()
            delta = rp.scan_counters_delta(before)
            _same(got, want, f"remote q{q} {engine}")
            assert delta.get("range_requests", 0) > 0, delta
            assert not delta.get("planned_read_fallbacks"), delta
        assert store.counts()["gets"] > 0


# ---------------------------------------------------------- engine parity

def _same(got, want, what):
    assert list(got) == list(want), what
    for c in want:
        assert len(got[c]) == len(want[c]), (what, c)
        for a, b in zip(got[c], want[c]):
            if isinstance(a, float) and isinstance(b, float):
                assert abs(a - b) <= REL * max(abs(a), abs(b)), (what, c)
            else:
                assert a == b, (what, c, a, b)


@pytest.mark.parametrize("q", [1, 3, 9, 18, 21])
def test_push_and_interp_agree_with_the_reference(tpch_root, monkeypatch,
                                                  q):
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    want = RQ.ALL[q](_reader(daft_tpu, tpch_root)).to_pydict()
    for engine in ("push", "interp"):
        monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", engine)
        got = Q.ALL[q](_reader(daft_tpu_torch, tpch_root)).to_pydict()
        _same(got, want, f"q{q} {engine}")


def test_default_engine_is_push(monkeypatch):
    from daft_tpu_torch.runners import native_runner
    cfg = daft_tpu_torch.get_context().execution_config
    monkeypatch.delenv("DAFT_TORCH_LOCAL_EXECUTOR", raising=False)
    assert isinstance(native_runner.make_local_executor(cfg, None),
                      pipeline.PushExecutor)
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", "interp")
    ex = native_runner.make_local_executor(cfg, None)
    assert not isinstance(ex, pipeline.PushExecutor)
    monkeypatch.setenv("DAFT_TORCH_LOCAL_EXECUTOR", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        native_runner.make_local_executor(cfg, None)


# -------------------------------------------------------- pipeline parts

def test_channel_is_bounded_and_closes_per_producer():
    ctx = pipeline.PipelineContext()
    ch = pipeline.Channel(ctx, capacity=2, producers=2)
    ch.put(1)
    ch.put(2)
    done = threading.Event()

    def third():
        ch.put(3)  # blocks: the channel holds 2
        done.set()

    threading.Thread(target=third, daemon=True).start()
    assert not done.wait(0.2)
    it = iter(ch)
    assert next(it) == 1
    assert done.wait(2.0)
    ch.close()  # one producer of two: not closed yet
    assert next(it) == 2 and next(it) == 3
    ch.close()
    with pytest.raises(StopIteration):
        next(it)


def test_cancel_unblocks_a_blocked_put():
    ctx = pipeline.PipelineContext()
    ch = pipeline.Channel(ctx, capacity=1)
    ch.put(0)
    raised = threading.Event()

    def blocked():
        try:
            ch.put(1)
        except pipeline.PipelineCancelled:
            raised.set()

    threading.Thread(target=blocked, daemon=True).start()
    time.sleep(0.1)
    ctx.cancel()
    assert raised.wait(2.0)


def _stage_threads(before=()):
    """Pipeline stage threads alive now that were not in ``before``."""
    return [t for t in threading.enumerate() if t not in before
            and t.name.split("-")[0] in ("drv", "dsp", "wrk", "col", "red")]


def test_first_error_reaches_the_consumer_and_threads_end(monkeypatch):
    from daft_tpu_torch.micropartition import MicroPartition

    def boom(self, predicate):
        raise RuntimeError("filter failed")
    monkeypatch.setattr(MicroPartition, "filter", boom)
    df = daft_tpu_torch.from_pydict({"x": list(range(1000))}) \
        .into_partitions(4).where(daft_tpu_torch.col("x") > 1)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="filter failed"):
        df.to_pydict()
    assert _stage_threads(before) == []


def test_early_limit_leaves_no_stage_thread():
    df = daft_tpu_torch.from_pydict({"x": list(range(200_000))}) \
        .into_partitions(20)
    before = set(threading.enumerate())
    out = df.where(daft_tpu_torch.col("x") % 2 == 0).limit(5).to_pydict()
    assert out["x"] == [0, 2, 4, 6, 8]
    assert _stage_threads(before) == []


def test_partitioned_agg_stage_is_chosen_for_a_final_grouped_agg():
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    df = daft_tpu_torch.from_pydict({"k": [i % 7 for i in range(100)],
                                     "v": list(range(100))}) \
        .into_partitions(4).groupby("k").agg(daft_tpu_torch.col("v").sum())
    plan = translate(df.builder.optimize().plan)
    finals = []

    def walk(n):
        if isinstance(n, pp.Aggregate) and n.mode == "final":
            finals.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    cfg = daft_tpu_torch.get_context().execution_config
    info = pipeline._partitioned_agg_info(finals[0], cfg)
    assert info is not None and info[3] is False  # in-memory reducer
    got = df.sort("k").to_pydict()
    assert got["k"] == list(range(7))
    assert got["v"] == [sum(v for v in range(100) if v % 7 == k)
                        for k in range(7)]


def test_concurrent_queries_under_a_short_switch_interval():
    """Twice as many concurrent queries as cores through the push engine
    (stage threads reused across queries, channels woken by a cancel),
    under a short switch interval: every answer equals the serial one, an
    early limit included, and no stage body is left running."""
    import concurrent.futures as cf
    import os
    import sys
    col = daft_tpu_torch.col
    n = 20_000
    left = daft_tpu_torch.from_pydict(
        {"k": [i % 50 for i in range(n)], "v": list(range(n))}
    ).into_partitions(4)
    right = daft_tpu_torch.from_pydict(
        {"k": list(range(50)), "w": [i * 2 for i in range(50)]}
    ).into_partitions(2)

    def agg_join():
        return left.join(right, on="k", strategy="hash").groupby("k") \
            .agg(col("v").sum(), col("w").max()).sort("k").to_pydict()

    def early_limit():
        return left.where(col("v") % 7 == 0).limit(3).to_pydict()

    want = {agg_join: agg_join(), early_limit: early_limit()}
    before = set(threading.enumerate())
    workers = 2 * (os.cpu_count() or 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [(fn, pool.submit(fn)) for fn in
                    [agg_join, early_limit] * workers]
            for fn, f in futs:
                assert f.result(timeout=120) == want[fn]
    finally:
        sys.setswitchinterval(old)
    assert _stage_threads(before) == []
