"""The port's distributed tier (``daft_tpu_torch/distributed/``,
``runners/distributed_runner.py``) held against the reference's.

- The reference's ``tests/test_distributed.py`` cases, each run through
  both packages: scheduler policies on mock workers (the same picks),
  stage splitting, map-like scan sharding, the distributed runner against
  the local runner, remote workers over HTTP, shuffle-backed boundaries,
  the fan-out guard, transient fetch recovery, the sort-merge join kept
  off the fan-out, and the worker-side range sort.
- The stage trees of the 22 TPC-H plans equal the reference's.
- The distributed runner's answers on TPC-H at SF 0.01 equal the
  reference's distributed runner's (keys, counts and strings exactly,
  floats at relative 1e-9).
- Runner selection: ``DAFT_TORCH_RUNNER`` and ``set_runner``.
- A subprocess runs queries through the distributed runner and a remote
  worker and shows ``jax`` absent from ``sys.modules``.

Queries run on CPU tensors (``DAFT_TORCH_DEVICE=cpu``) or the host tier
where the reference's case asks for its host tier.
"""

import concurrent.futures as cf
import os
import subprocess
import sys
from typing import List

import pytest

import daft_tpu
import daft_tpu_torch
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch
from daft_tpu_torch.benchmarking import tpch_queries as Q

REL = 1e-9
PKGS = {"ref": daft_tpu, "port": daft_tpu_torch}


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    yield


def _mods(pkg):
    """(distributed package, worker module, MicroPartition, physical plan
    module, translate, DistributedRunner, context module) of a package."""
    import importlib
    name = pkg.__name__
    return (importlib.import_module(f"{name}.distributed"),
            importlib.import_module(f"{name}.distributed.worker"),
            importlib.import_module(f"{name}.micropartition").MicroPartition,
            importlib.import_module(f"{name}.physical.plan"),
            importlib.import_module(f"{name}.physical.translate").translate,
            importlib.import_module(
                f"{name}.runners.distributed_runner").DistributedRunner,
            importlib.import_module(f"{name}.context"))


class _Runner:
    """Installs a DistributedRunner on a package for the block."""

    def __init__(self, pkg, n: int = 3):
        self.pkg = pkg
        self.n = n

    def __enter__(self):
        *_, DR, ctx = _mods(self.pkg)
        self.ctx = ctx.get_context()
        self.old = self.ctx._runner
        self.runner = DR(num_workers=self.n)
        self.ctx.set_runner(self.runner)
        return self.runner

    def __exit__(self, *exc):
        self.ctx.set_runner(self.old)
        mgr = getattr(self.runner, "_manager", None)
        if mgr is not None:
            mgr.shutdown()
        return False


def _same(got, want, what=""):
    assert list(got) == list(want), what
    for c in want:
        assert len(got[c]) == len(want[c]), (what, c)
        for a, b in zip(got[c], want[c]):
            if isinstance(b, float) and isinstance(a, float):
                assert abs(a - b) <= REL * max(abs(a), abs(b), 1.0), \
                    (what, c, a, b)
            else:
                assert a == b, (what, c, a, b)


def _mock_worker_cls(pkg):
    dist, worker, MP, *_ = _mods(pkg)

    class MockWorker(worker.Worker):
        def __init__(self, worker_id, num_slots=2, fail_times=0):
            self.id = worker_id
            self.num_slots = num_slots
            self.submitted: List = []
            self.fail_times = fail_times

        def submit(self, task):
            self.submitted.append(task)
            fut = cf.Future()
            if self.fail_times > 0:
                self.fail_times -= 1
                fut.set_exception(RuntimeError("mock worker down"))
            else:
                fut.set_result([MP.from_pydict({"x": [task.task_idx]})])
            return fut

    return MockWorker


def _mock_task(pkg, i=0, preferred=None):
    dist, worker, MP, pp, *_ = _mods(pkg)
    return worker.StageTask(0, pp.InMemorySource([], None), {}, task_idx=i,
                            preferred_worker=preferred)


# ------------------------------------------------------------- policies

def _policy_picks(pkg):
    dist, worker, *_ = _mods(pkg)
    Mock = _mock_worker_cls(pkg)
    out = {}
    ws = [worker.WorkerState(Mock(f"w{i}")) for i in range(3)]
    s = dist.RoundRobinScheduler()
    out["round_robin"] = [s.pick(_mock_task(pkg, i), ws) for i in range(6)]
    ws = [worker.WorkerState(Mock("w0")), worker.WorkerState(Mock("w1"))]
    ws[0].active = 2
    out["least_loaded"] = dist.LeastLoadedScheduler().pick(
        _mock_task(pkg), ws)
    ws = [worker.WorkerState(Mock("w0")), worker.WorkerState(Mock("w1"))]
    s = dist.LeastLoadedScheduler()
    out["affinity"] = s.pick(_mock_task(pkg, preferred="w1"), ws)
    ws[1].active = 99
    out["affinity_saturated"] = s.pick(_mock_task(pkg, preferred="w1"), ws)
    return out


def test_scheduler_policies_pick_as_the_reference():
    got = _policy_picks(daft_tpu_torch)
    assert got == _policy_picks(daft_tpu)
    assert got == {"round_robin": ["w0", "w1", "w2", "w0", "w1", "w2"],
                   "least_loaded": "w1", "affinity": "w1",
                   "affinity_saturated": "w0"}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_failed_task_retries_on_other_worker(pkg):
    pkg = PKGS[pkg]
    dist, worker, MP, pp, *_ = _mods(pkg)
    Mock = _mock_worker_cls(pkg)
    bad, good = Mock("bad", fail_times=1), Mock("good")
    mgr = dist.WorkerManager([bad, good])

    class PickBadFirst:
        def __init__(self):
            self.calls = 0

        def pick(self, task, states):
            self.calls += 1
            ids = [s.worker.id for s in states]
            return "bad" if "bad" in ids and self.calls == 1 else ids[0]

    runner = dist.StageRunner(mgr, PickBadFirst())
    sp = dist.StagePlan.from_physical(
        pp.InMemorySource([MP.from_pydict({"x": [1]})], None))
    parts = list(runner.run(sp))
    assert len(bad.submitted) == 1 and len(good.submitted) == 1
    assert parts and parts[0].to_pydict() == {"x": [0]}


# -------------------------------------------------------- stage planning

def _stage_plan(pkg, df):
    dist, _, _, _, translate, *_ = _mods(pkg)
    return dist.StagePlan.from_physical(
        translate(df._builder.optimize().plan))


def _shape(sp):
    return [(s.plan.name(), [(b.upstream, b.kind, b.num_partitions,
                              tuple(e.name() for e in b.by))
                             for b in s.boundaries], s.is_map_like())
            for s in sp.stages]


def test_stage_split_at_exchanges(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    lp, rp = str(tmp_path / "l.parquet"), str(tmp_path / "r.parquet")
    pq.write_table(pa.table({"k": list(range(100)),
                             "a": list(range(100))}), lp)
    pq.write_table(pa.table({"k": list(range(100)),
                             "b": [i * 2 for i in range(100)]}), rp)
    shapes = {}
    for name, pkg in PKGS.items():
        *_, pp, _, _, _ = _mods(pkg)
        df = pkg.read_parquet(lp).into_partitions(4).join(
            pkg.read_parquet(rp).into_partitions(4), on="k")
        sp = _stage_plan(pkg, df)
        assert len(sp.stages) >= 3
        kinds = [b.kind for s in sp.stages for b in s.boundaries]
        assert "hash" in kinds or "split" in kinds

        def has_exchange(n):
            return isinstance(n, pp.Exchange) or any(
                has_exchange(c) for c in n.children)

        assert not any(has_exchange(s.plan) for s in sp.stages)
        shapes[name] = _shape(sp)
    assert shapes["port"] == shapes["ref"]


def test_map_like_scan_stage_shards_across_workers(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    d = tmp_path / "t"
    d.mkdir()
    for i in range(6):
        pq.write_table(pa.table({"x": list(range(i * 10, i * 10 + 10))}),
                       str(d / f"{i}.parquet"))
    seen = {}
    for name, pkg in PKGS.items():
        dist, _, _, pp, _, _, ctx = _mods(pkg)
        df = pkg.read_parquet(str(d / "*.parquet")) \
            .where(pkg.col("x") % 2 == 0).repartition(2, pkg.col("x"))
        with ctx.execution_config_ctx(scan_tasks_min_size_bytes=1):
            sp = _stage_plan(pkg, df)
        scan_stage = next(s for s in sp.stages
                          if s.scan_source() is not None)
        assert scan_stage.is_map_like()
        Mock = _mock_worker_cls(pkg)
        runner = dist.StageRunner(
            dist.WorkerManager([Mock("w0"), Mock("w1")]),
            dist.RoundRobinScheduler())
        tasks = runner._make_tasks(scan_stage, {})
        counts = [len(t.plan.tasks) if isinstance(t.plan, pp.ScanSource)
                  else len(t.plan.children[0].tasks) for t in tasks]
        assert sum(counts) == len(scan_stage.scan_source().tasks)
        seen[name] = counts
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 2


# ------------------------------------------------------------ end to end

def _join_agg(pkg):
    import numpy as np
    rng = np.random.default_rng(5)
    n = 2000
    orders = pkg.from_pydict({
        "okey": list(range(n)), "cust": rng.integers(0, 50, n).tolist(),
        "price": rng.uniform(1, 100, n).round(2).tolist()}) \
        .into_partitions(4)
    customers = pkg.from_pydict({
        "cust": list(range(50)),
        "region": rng.integers(0, 5, 50).tolist()}).into_partitions(2)
    return (orders.join(customers, on="cust")
            .groupby("region").agg(pkg.col("price").sum().alias("rev"),
                                   pkg.col("okey").count().alias("cnt"))
            .sort("region"))


def test_distributed_runner_matches_local_on_join_agg():
    local = _join_agg(daft_tpu_torch).to_pydict()
    with _Runner(daft_tpu_torch):
        dist = _join_agg(daft_tpu_torch).to_pydict()
    with _Runner(daft_tpu):
        ref = _join_agg(daft_tpu).to_pydict()
    _same(dist, local)
    _same(dist, ref)


def test_distributed_runner_multi_stage_count(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": [i % 7 for i in range(1000)],
                             "v": [float(i) for i in range(1000)]}), p)
    outs = {}
    for name, pkg in PKGS.items():
        q = lambda: pkg.read_parquet(p).into_partitions(4).groupby(  # noqa
            "k").agg(pkg.col("v").sum().alias("s")).sort("k")
        assert len(_stage_plan(pkg, q()).stages) >= 2
        with _Runner(pkg):
            outs[name] = q().to_pydict()
    _same(outs["port"], outs["ref"])
    assert outs["port"]["k"] == list(range(7))


def _collect_stage_runner(pkg, df, workers):
    dist, *_ = _mods(pkg)
    sp = _stage_plan(pkg, df)
    runner = dist.StageRunner(dist.WorkerManager(workers),
                              dist.LeastLoadedScheduler())
    got = {}
    for p in runner.run(sp):
        d = p.to_pydict()
        for k, s in zip(d.get("k", []), d.get("s", [])):
            got[k] = s
    return got


@pytest.mark.parametrize("shuffle", ["driver", "flight"])
def test_remote_worker_runs_stage_over_http(monkeypatch, shuffle):
    """The Worker seam is transport-blind: a RemoteWorker posting fragments
    to a WorkerServer (with the flight shuffle, its map output is served
    from the worker's own shuffle server)."""
    from daft_tpu_torch.distributed.remote_worker import (RemoteWorker,
                                                          WorkerServer,
                                                          fetch_status)
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", shuffle)
    monkeypatch.setenv("DAFT_TPU_DISTRIBUTED_SHUFFLE", shuffle)
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    srv = WorkerServer()
    try:
        def q(pkg):
            return (pkg.from_pydict({"k": [i % 5 for i in range(800)],
                                     "v": [float(i) for i in range(800)]})
                    .into_partitions(3)
                    .groupby("k").agg(pkg.col("v").sum().alias("s"))
                    .sort("k"))
        local = q(daft_tpu_torch).to_pydict()
        got = _collect_stage_runner(
            daft_tpu_torch, q(daft_tpu_torch),
            [RemoteWorker("remote-0", srv.address)])
        assert got == dict(zip(local["k"], local["s"]))
        status = fetch_status(srv.address)
        assert status["device"] == "host" and status["pid"] == os.getpid()
        assert set(status["launches"]) == {
            "hash_agg_build", "hash_join_build", "hash_join_probe"}
    finally:
        srv.shutdown()


def test_flight_shuffle_backed_boundaries(monkeypatch):
    """Hash boundaries route through the shuffle service (map tasks return
    ShuffleResults, reduce tasks fan out per partition), and the answers
    equal the driver-materializing mode's and the reference's."""
    import numpy as np
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    outs = {}
    for name, pkg in PKGS.items():
        dist, worker, *_ = _mods(pkg)
        rng = np.random.default_rng(11)
        df = (pkg.from_pydict({"k": rng.integers(0, 9, 3000).tolist(),
                               "v": [float(i) for i in range(3000)]})
              .into_partitions(4)
              .groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k"))
        results = []
        orig = dist.StageRunner._collect

        def spy(self, tasks, _orig=orig, _w=worker):
            out = _orig(self, tasks)
            results.extend(r for r in out if isinstance(r, _w.ShuffleResult))
            return out

        monkeypatch.setattr(dist.StageRunner, "_collect", spy)
        for mode in ("flight", "driver"):
            monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", mode)
            monkeypatch.setenv("DAFT_TPU_DISTRIBUTED_SHUFFLE", mode)
            outs[(name, mode)] = _collect_stage_runner(
                pkg, df, [worker.InProcessWorker(f"w{i}") for i in range(3)])
            if mode == "flight":
                assert results, "no map task produced a ShuffleResult"
    assert outs[("port", "flight")] == outs[("port", "driver")]
    assert len(outs[("port", "flight")]) == 9
    ref = outs[("ref", "flight")]
    for k, v in ref.items():
        assert abs(outs[("port", "flight")][k] - v) <= REL * abs(v)


def test_fanout_guard_keeps_global_ops_correct(monkeypatch):
    """A Limit above a user hash-repartition must not fan out per
    partition."""
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "flight")
    for pkg in PKGS.values():
        with _Runner(pkg):
            out = pkg.from_pydict({"k": list(range(100))}) \
                .repartition(4, pkg.col("k")).limit(5).to_pydict()
        assert len(out["k"]) == 5


def test_transient_fetch_failure_recovers(monkeypatch):
    """A reduce-side fetch that fails once is retried by the resilience
    plane, and the recovery is counted."""
    from daft_tpu_torch.distributed import resilience as rz
    from daft_tpu_torch.distributed import shuffle_service as ss
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "flight")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    monkeypatch.setenv("DAFT_TORCH_RETRY_BACKOFF", "0.01")
    rz.reset_for_tests()

    def q():
        return (daft_tpu_torch.from_pydict(
            {"k": [i % 6 for i in range(900)],
             "v": [float(i) for i in range(900)]}).into_partitions(3)
            .groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s"))
            .sort("k"))

    local = q().to_pydict()
    orig = ss.fetch_partition
    state = {"failed": False}

    def flaky(address, shuffle_id, partition, fault_key=None):
        if not state["failed"]:
            state["failed"] = True
            raise rz.ShuffleFetchError(address, shuffle_id, partition,
                                       detail="transient blip")
        return orig(address, shuffle_id, partition, fault_key=fault_key)

    monkeypatch.setattr(ss, "fetch_partition", flaky)
    with _Runner(daft_tpu_torch):
        dist = q().to_pydict()
    assert state["failed"]
    assert dist == local
    c = rz.counters_snapshot()
    assert c.get("fetch_failures", 0) >= 1 and c.get("retries", 0) >= 1, c
    rz.reset_for_tests()


def test_sort_merge_join_not_fanned_out(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "flight")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    left = daft_tpu_torch.from_pydict({"k": [1, 2, 3], "lv": [10, 20, 30]})
    right = daft_tpu_torch.from_pydict({"k": [2, 9], "rv": ["b", "z"]})
    with _Runner(daft_tpu_torch):
        out = left.repartition(2, daft_tpu_torch.col("k")).join(
            right, on="k", how="outer", strategy="sort_merge").to_pydict()
    assert sum(1 for k in out["k"] if k == 9) == 1
    assert len(out["k"]) == 4


def test_distributed_sort_stays_off_driver(monkeypatch):
    """A global sort under the flight shuffle runs the worker-side range
    protocol: the driver sees samples, boundaries and receipts, never the
    rows; the order equals the local runner's."""
    import numpy as np
    from daft_tpu_torch.distributed import scheduler as sched_mod
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    rng = np.random.default_rng(11)
    data = {"k": rng.integers(0, 40, 5000).tolist(),
            "v": rng.uniform(0, 1000, 5000).round(3).tolist()}

    def q():
        return (daft_tpu_torch.from_pydict(data).into_partitions(4)
                .groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s"))
                .sort("s", desc=True).to_pydict())

    local = q()
    calls = {"range_sort": 0}
    orig = sched_mod.StageRunner._range_sort_remainder

    def spy(self, *a, **kw):
        calls["range_sort"] += 1
        return orig(self, *a, **kw)

    def no_driver_fetch(srcs, n, *a, **k):
        raise AssertionError("sort routed rows through the driver")

    monkeypatch.setattr(sched_mod.StageRunner, "_range_sort_remainder", spy)
    monkeypatch.setattr(sched_mod.StageRunner, "_driver_fetch",
                        staticmethod(no_driver_fetch))
    with _Runner(daft_tpu_torch):
        dist = q()
    assert calls["range_sort"] == 1
    assert dist["k"] == local["k"]
    for a, b in zip(dist["s"], local["s"]):
        assert a == pytest.approx(b, rel=REL)


# ------------------------------------------------------- runner selection

def test_runner_selection(monkeypatch):
    from daft_tpu_torch import context
    from daft_tpu_torch.runners.distributed_runner import DistributedRunner
    from daft_tpu_torch.runners.native_runner import NativeRunner
    ctx = context.get_context()
    old = ctx._runner
    try:
        ctx.set_runner(None)
        monkeypatch.setenv("DAFT_TORCH_RUNNER", "distributed")
        r = context.get_runner()
        assert isinstance(r, DistributedRunner)
        assert context.get_runner() is r
        r.shutdown()
        daft_tpu_torch.set_runner(None)
        monkeypatch.setenv("DAFT_TORCH_RUNNER", "native")
        assert isinstance(context.get_runner(), NativeRunner)
        daft_tpu_torch.set_runner(None)
        monkeypatch.setenv("DAFT_TORCH_RUNNER", "bogus")
        with pytest.raises(ValueError, match="DAFT_TORCH_RUNNER"):
            context.get_runner()
    finally:
        ctx.set_runner(old)


def test_num_workers_knob(monkeypatch):
    from daft_tpu_torch.runners.distributed_runner import DistributedRunner
    monkeypatch.setenv("DAFT_TORCH_NUM_WORKERS", "5")
    assert DistributedRunner().num_workers == 5


# ------------------------------------------------------------ TPC-H 22

@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_dist")
    generate_tpch(str(root), scale_factor=0.01, num_parts=4)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_stage_trees_equal_the_reference(tpch_root, monkeypatch, q):
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    ref = _stage_plan(daft_tpu, RQ.ALL[q](_reader(daft_tpu, tpch_root)))
    port = _stage_plan(daft_tpu_torch,
                       Q.ALL[q](_reader(daft_tpu_torch, tpch_root)))
    assert port.repr_ascii() == ref.repr_ascii()
    assert _shape(port) == _shape(ref)


def test_distributed_runner_matches_the_reference_on_tpch(tpch_root):
    with _Runner(daft_tpu, 4):
        want = {q: RQ.ALL[q](_reader(daft_tpu, tpch_root)).to_pydict()
                for q in range(1, 23)}
    with _Runner(daft_tpu_torch, 4):
        for q in range(1, 23):
            got = Q.ALL[q](_reader(daft_tpu_torch, tpch_root)).to_pydict()
            _same(got, want[q], f"q{q}")


# ------------------------------------------------------ import isolation

_CHILD = r"""
import os, sys
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
import daft_tpu_torch as dt
from daft_tpu_torch.distributed import (LeastLoadedScheduler, StagePlan,
                                        StageRunner, WorkerManager)
from daft_tpu_torch.distributed.remote_worker import (RemoteWorker,
                                                      WorkerServer)
from daft_tpu_torch.physical.translate import translate
from daft_tpu_torch.runners.distributed_runner import DistributedRunner

def q():
    return (dt.from_pydict({"k": [i % 5 for i in range(400)],
                            "v": [float(i) for i in range(400)]})
            .into_partitions(3).groupby("k")
            .agg(dt.col("v").sum().alias("s")).sort("k"))

runner = DistributedRunner(num_workers=2)
dt.set_runner(runner)
a = q().to_pydict()
dt.set_runner(None)
runner.shutdown()
srv = WorkerServer()
sp = StagePlan.from_physical(translate(q()._builder.optimize().plan))
mgr = WorkerManager([RemoteWorker("r0", srv.address)])
rows = {}
for p in StageRunner(mgr, LeastLoadedScheduler()).run(sp):
    d = p.to_pydict()
    rows.update(zip(d.get("k", []), d.get("s", [])))
srv.shutdown()
assert rows == dict(zip(a["k"], a["s"])), (rows, a)
print("JAX_LOADED", "jax" in sys.modules, "REF_LOADED",
      "daft_tpu" in sys.modules)
"""


def test_distributed_query_runs_without_jax():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_LOADED False REF_LOADED False" in out.stdout, out.stdout
