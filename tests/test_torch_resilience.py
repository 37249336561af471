"""The port's resilience plane (``daft_tpu_torch/distributed/
resilience.py``) against the reference's ``tests/test_resilience.py``, plus
the reference's distributed and chaos trace cases (``tests/
test_tracing.py``) and the chaos hooks of the scan, the governor and the
calibration store.

- The fault plan decides as the reference's: the same spec and seed give
  the same decisions (a pure hash of seed, site, key and attempt).
- Retry policy: quarantine and re-admission on an injected clock, the
  placement that never empties, deterministic bounded backoff.
- Chaos through the distributed runner: answers equal the fault-free run,
  a seeded run replays its fault events bit for bit (under every fast-path
  knob), the port's events equal the reference's on the same plan, a lost
  partition recomputes only its map task, a sticky fault fails fast.
- The supervisor on canned workers: speculation and task timeouts, with
  delays long enough (5 s against 0.2-0.3 s triggers) that scheduling
  jitter cannot change the outcome, and the retry budget.
- The remote worker carries the true exception type over the wire and
  ships its spans back (a child process); the shuffle sweep.
- The scan's sequential fallback, the governor and the calibration store
  freeze under chaos serialization or an active fault plan.
"""

import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch import observability as obs
from daft_tpu_torch import tracing
from daft_tpu_torch.distributed import WorkerManager
from daft_tpu_torch.distributed import resilience as rz
from daft_tpu_torch.distributed.worker import StageTask, Worker
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.runners.distributed_runner import DistributedRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from daft_tpu.distributed import resilience as r_rz
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    rz.reset_for_tests()
    r_rz.reset_for_tests()
    yield
    rz.reset_for_tests()
    r_rz.reset_for_tests()


def _pre(pkg):
    return "DAFT_TPU_" if pkg is daft_tpu else "DAFT_TORCH_"


def _rz(pkg):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.distributed.resilience")


def _run_distributed(df, pkg=daft_tpu_torch, num_workers=3):
    import importlib
    DR = importlib.import_module(
        f"{pkg.__name__}.runners.distributed_runner").DistributedRunner
    ctx = importlib.import_module(f"{pkg.__name__}.context").get_context()
    runner = DR(num_workers=num_workers)
    old = ctx._runner
    ctx.set_runner(runner)
    try:
        return df.to_pydict()
    finally:
        ctx.set_runner(old)
        if runner._manager is not None:
            runner._manager.shutdown()


def _q5_shape(pkg=daft_tpu_torch):
    rng = np.random.default_rng(5)
    n = 1500
    orders = pkg.from_pydict({
        "okey": list(range(n)), "cust": rng.integers(0, 40, n).tolist(),
        "price": rng.uniform(1, 100, n).round(2).tolist()}) \
        .into_partitions(4)
    customers = pkg.from_pydict({
        "cust": list(range(40)),
        "region": rng.integers(0, 5, 40).tolist()}).into_partitions(2)
    return (orders.join(customers, on="cust")
            .groupby("region").agg(pkg.col("price").sum().alias("rev"),
                                   pkg.col("okey").count().alias("cnt"))
            .sort("region"))


def _scan_dir(tmp_path, n_files=6):
    import pyarrow as pa
    import pyarrow.parquet as pq
    d = tmp_path / "t"
    if not d.exists():
        d.mkdir()
        for i in range(n_files):
            pq.write_table(
                pa.table({"k": [j % 5 for j in range(i * 100, i * 100 + 100)],
                          "v": [float(j) for j in range(100)]}),
                str(d / f"{i}.parquet"))
    return str(d / "*.parquet")


def _scan_groupby(pkg, path):
    return pkg.read_parquet(path).groupby("k").agg(
        pkg.col("v").sum().alias("s")).sort("k")


# ------------------------------------------------------------ fault plan

def test_fault_plan_decides_as_the_reference():
    from daft_tpu.distributed import resilience as r_rz
    spec = "task:0.5,fetch:0.25:3,crash:1:1"
    keys = [f"s0.t{i}" for i in range(64)]
    for seed in ("11", "12"):
        a, r = rz.FaultPlan(spec, seed=seed), r_rz.FaultPlan(spec, seed=seed)
        for site in ("task", "fetch", "crash"):
            da = [a.decide(site, k, attempt=j % 3)
                  for j, k in enumerate(keys)]
            assert da == [r.decide(site, k, attempt=j % 3)
                          for j, k in enumerate(keys)]
        assert a.events == r.events
    a = rz.FaultPlan(spec, seed="11")
    da = [a.decide("task", k, attempt=0) for k in keys]
    assert any(da) and not all(da)
    capped = rz.FaultPlan("fetch:1:2", seed="0")
    assert sum(capped.decide("fetch", f"k{i}") for i in range(10)) == 2
    with pytest.raises(ValueError):
        rz.FaultPlan("nonsense:1")


def test_sticky_fault_fires_on_every_attempt():
    p = rz.FaultPlan("task:1:sticky", seed="3")
    assert all(p.decide("task", "s0.t0", attempt=i) for i in range(4))
    t = rz.FaultPlan("task:1", seed="3")
    with pytest.raises(rz.InjectedFault) as e0:
        t.maybe_fail("task", "s0.t0", attempt=0)
    with pytest.raises(rz.InjectedFault) as e1:
        t.maybe_fail("task", "s0.t0", attempt=1)
    assert str(e0.value) != str(e1.value)
    s = rz.FaultPlan("task:1:sticky", seed="3")
    with pytest.raises(rz.InjectedFault) as s0:
        s.maybe_fail("task", "s0.t0", attempt=0)
    with pytest.raises(rz.InjectedFault) as s1:
        s.maybe_fail("task", "s0.t0", attempt=1)
    assert str(s0.value) == str(s1.value)


# ---------------------------------------------------------- retry policy

def _states(*ids):
    return [SimpleNamespace(worker=SimpleNamespace(id=i), active=0)
            for i in ids]


def test_quarantine_opens_and_readmits():
    now = [0.0]
    pol = rz.RetryPolicy(max_retries=3, quarantine_after=2,
                         quarantine_s=10.0, clock=lambda: now[0])
    states = _states("w0", "w1")
    assert not pol.record_failure("w0")
    assert pol.record_failure("w0")
    assert pol.is_quarantined("w0")
    assert [s.worker.id for s in pol.eligible(states)] == ["w1"]
    assert rz.counters_snapshot().get("quarantined") == 1
    now[0] = 10.5
    assert not pol.is_quarantined("w0")
    assert [s.worker.id for s in pol.eligible(states)] == ["w0", "w1"]
    assert rz.counters_snapshot().get("readmitted") == 1


def test_eligible_never_empty_when_all_quarantined():
    pol = rz.RetryPolicy(quarantine_after=1, quarantine_s=100.0,
                         clock=lambda: 0.0)
    pol.record_failure("w0")
    pol.record_failure("w1")
    states = _states("w0", "w1")
    assert pol.eligible(states) and pol.eligible(states, exclude="w0")


def test_success_resets_consecutive_failures():
    pol = rz.RetryPolicy(quarantine_after=2, quarantine_s=100.0)
    pol.record_failure("w0")
    pol.record_success("w0")
    assert not pol.record_failure("w0")
    assert not pol.is_quarantined("w0")


def test_backoff_is_deterministic_bounded_and_the_references():
    from daft_tpu.distributed import resilience as r_rz
    pol = rz.RetryPolicy(backoff_base=0.1, backoff_cap=1.0, seed="9")
    ref = r_rz.RetryPolicy(backoff_base=0.1, backoff_cap=1.0, seed="9")
    a = [pol.backoff_s("s0.t0", i) for i in range(1, 6)]
    assert a == [pol.backoff_s("s0.t0", i) for i in range(1, 6)]
    assert a == [ref.backoff_s("s0.t0", i) for i in range(1, 6)]
    assert all(x <= 1.5 for x in a) and a[1] > a[0] * 0.5


# ------------------------------------------------------ chaos end to end

def _chaos_env(monkeypatch, pkg, spec, seed, serialize=True):
    pre = _pre(pkg)
    monkeypatch.setenv(pre + "DISTRIBUTED_SHUFFLE", "flight")
    monkeypatch.setenv(pre + "FAULT_SPEC", spec)
    monkeypatch.setenv(pre + "FAULT_SEED", seed)
    monkeypatch.setenv(pre + "RETRY_BACKOFF", "0.01")
    monkeypatch.setenv(pre + "SPECULATIVE_MULTIPLIER", "0")
    if serialize:
        monkeypatch.setenv(pre + "CHAOS_SERIALIZE", "1")


def test_fast_path_layers_do_not_perturb_chaos_replay(monkeypatch,
                                                      tmp_path):
    path = _scan_dir(tmp_path)
    _chaos_env(monkeypatch, daft_tpu_torch,
               "task:0.06,fetch:0.06,crash:0.06", "11")

    def one_run(knobs):
        for k, v in knobs.items():
            monkeypatch.setenv("DAFT_TORCH_" + k, v)
        rz.reset_for_tests()
        with daft_tpu_torch.execution_config_ctx(
                scan_tasks_min_size_bytes=1):
            out = _run_distributed(_scan_groupby(daft_tpu_torch, path))
        return out, sorted(rz.fault_events())

    out1, ev1 = one_run({"SHUFFLE_COMBINE": "0",
                         "SHUFFLE_COMPRESSION": "none",
                         "SHUFFLE_FETCH_PARALLELISM": "1",
                         "SCAN_PREFETCH": "0", "DEVICE_INFLIGHT": "0",
                         "IO_PLANNED_READS": "0"})
    out2, ev2 = one_run({"SHUFFLE_COMBINE": "1",
                         "SHUFFLE_COMPRESSION": "lz4",
                         "SHUFFLE_FETCH_PARALLELISM": "8",
                         "SCAN_PREFETCH": "8", "DEVICE_INFLIGHT": "8",
                         "IO_PLANNED_READS": "1"})
    assert ev1, "the fixed spec and seed injected nothing"
    assert ev1 == ev2 and out1 == out2


def test_chaos_smoke_fixed_spec(monkeypatch):
    expected = _q5_shape().to_pydict()
    _chaos_env(monkeypatch, daft_tpu_torch,
               "task:0.08,fetch:0.08,crash:0.08", "1", serialize=False)
    got = _run_distributed(_q5_shape())
    assert got["region"] == expected["region"]
    assert got["cnt"] == expected["cnt"]
    for a, b in zip(got["rev"], expected["rev"]):
        assert a == pytest.approx(b, rel=1e-9)
    c = rz.counters_snapshot()
    assert sum(v for k, v in c.items() if k.startswith("injected_")) > 0, c
    assert c.get("retries", 0) > 0, c
    stats = obs.last_query_stats()
    assert stats is not None and stats.recovery
    assert "resilience (recovery events):" in stats.render()


def _seeded_events(pkg, path, monkeypatch):
    _chaos_env(monkeypatch, pkg, "task:0.06,fetch:0.06,crash:0.06", "11")
    res = _rz(pkg)
    res.reset_for_tests()
    with pkg.execution_config_ctx(scan_tasks_min_size_bytes=1):
        out = _run_distributed(_scan_groupby(pkg, path), pkg)
    return out, sorted(res.fault_events())


def test_same_seed_reproduces_same_fault_events(monkeypatch, tmp_path):
    """Two seeded runs inject the same faults at all three sites, and the
    port injects exactly the reference's faults on the same plan."""
    path = _scan_dir(tmp_path)
    out1, ev1 = _seeded_events(daft_tpu_torch, path, monkeypatch)
    out2, ev2 = _seeded_events(daft_tpu_torch, path, monkeypatch)
    assert ev1 and {e.split(":")[0] for e in ev1} == \
        {"task", "fetch", "crash"}
    assert ev1 == ev2 and out1 == out2
    ref_out, ref_ev = _seeded_events(daft_tpu, path, monkeypatch)
    assert ev1 == ref_ev
    assert out1["k"] == ref_out["k"]
    for a, b in zip(out1["s"], ref_out["s"]):
        assert a == pytest.approx(b, rel=1e-9)


def test_lost_partition_recomputes_only_producing_map_task(monkeypatch,
                                                           tmp_path):
    path = _scan_dir(tmp_path)
    monkeypatch.setenv("DAFT_TORCH_DISTRIBUTED_SHUFFLE", "flight")
    expected = _scan_groupby(daft_tpu_torch, path).to_pydict()
    monkeypatch.setenv("DAFT_TORCH_FAULT_SPEC", "crash:1:1")
    monkeypatch.setenv("DAFT_TORCH_FAULT_SEED", "7")
    monkeypatch.setenv("DAFT_TORCH_RETRY_BACKOFF", "0.01")
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1):
        got = _run_distributed(_scan_groupby(daft_tpu_torch, path))
    assert got == expected
    c = rz.counters_snapshot()
    assert c.get("injected_crash") == 1, c
    assert c.get("recomputed_map_tasks") == 1, c
    assert c.get("fetch_failures", 0) >= 2, c


def test_identical_failure_on_two_workers_fails_fast(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_FAULT_SPEC", "task:1:sticky")
    monkeypatch.setenv("DAFT_TORCH_FAULT_SEED", "1")
    monkeypatch.setenv("DAFT_TORCH_RETRY_BACKOFF", "0.01")
    df = daft_tpu_torch.from_pydict({"x": [1, 2, 3]})
    with pytest.raises(rz.FailFastError):
        _run_distributed(df.select(col("x") + 1))
    c = rz.counters_snapshot()
    assert c.get("fail_fast") == 1 and c.get("injected_task") == 2, c


# ---------------------------------------------- supervisor on mocks

class CannedWorker(Worker):
    """Returns a canned per-task result, after ``delay`` seconds."""

    def __init__(self, worker_id, delay=0.0, fail_times=0):
        self.id = worker_id
        self.num_slots = 4
        self.delay = delay
        self.fail_times = fail_times
        self.submitted = []

    def submit(self, task):
        import concurrent.futures as cf
        self.submitted.append(task)
        fut = cf.Future()

        def finish():
            if self.fail_times > 0:
                self.fail_times -= 1
                fut.set_exception(RuntimeError("canned failure"))
            else:
                fut.set_result(
                    [MicroPartition.from_pydict({"x": [task.task_idx]})])

        if self.delay:
            t = threading.Timer(self.delay, finish)
            t.daemon = True
            t.start()
        else:
            finish()
        return fut


def _trivial_tasks(n):
    return [StageTask(0, pp.InMemorySource([], None), {}, task_idx=i,
                      fault_key=f"s0.t{i}") for i in range(n)]


def test_speculative_backup_wins_over_straggler():
    slow, fast = CannedWorker("slow", delay=5.0), CannedWorker("fast")
    mgr = WorkerManager([slow, fast])

    class RouteLastToSlow:
        def pick(self, task, states):
            ids = [s.worker.id for s in states]
            if task.task_idx == 3 and "slow" in ids:
                return "slow"
            return "fast" if "fast" in ids else ids[0]

    pol = rz.RetryPolicy(speculative_multiplier=2.0, speculative_min_s=0.2,
                         task_timeout=0)
    sup = rz.TaskSupervisor(rz.ResilienceContext(policy=pol), mgr,
                            RouteLastToSlow())
    t0 = time.monotonic()
    results = sup.run(_trivial_tasks(4))
    assert time.monotonic() - t0 < 4.0
    assert [r[0].to_pydict() for r in results] == \
        [{"x": [i]} for i in range(4)]
    c = rz.counters_snapshot()
    assert c.get("speculative_launched") == 1 and \
        c.get("speculative_wins") == 1, c


def test_task_timeout_is_retried_on_another_worker():
    hung, good = CannedWorker("hung", delay=5.0), CannedWorker("good")
    mgr = WorkerManager([hung, good])

    class PickHungFirst:
        def __init__(self):
            self.calls = 0

        def pick(self, task, states):
            self.calls += 1
            ids = [s.worker.id for s in states]
            return "hung" if self.calls == 1 and "hung" in ids else \
                ("good" if "good" in ids else ids[0])

    pol = rz.RetryPolicy(task_timeout=0.3, speculative_multiplier=0,
                         backoff_base=0.01)
    sup = rz.TaskSupervisor(rz.ResilienceContext(policy=pol), mgr,
                            PickHungFirst())
    t0 = time.monotonic()
    results = sup.run(_trivial_tasks(1))
    assert time.monotonic() - t0 < 4.0
    assert results[0][0].to_pydict() == {"x": [0]}
    c = rz.counters_snapshot()
    assert c.get("task_timeouts") == 1 and c.get("retries") == 1, c
    assert len(good.submitted) == 1


def test_repeated_timeouts_do_not_fail_fast():
    hung = [CannedWorker("hung0", delay=5.0), CannedWorker("hung1",
                                                           delay=5.0)]
    good = CannedWorker("good")
    mgr = WorkerManager(hung + [good])

    class HungHungGood:
        def __init__(self):
            self.calls = 0

        def pick(self, task, states):
            self.calls += 1
            ids = [s.worker.id for s in states]
            want = {1: "hung0", 2: "hung1"}.get(self.calls, "good")
            return want if want in ids else \
                ("good" if "good" in ids else ids[0])

    pol = rz.RetryPolicy(task_timeout=0.2, max_retries=3, backoff_base=0.01,
                         quarantine_after=99, speculative_multiplier=0)
    sup = rz.TaskSupervisor(rz.ResilienceContext(policy=pol), mgr,
                            HungHungGood())
    results = sup.run(_trivial_tasks(1))
    assert results[0][0].to_pydict() == {"x": [0]}
    c = rz.counters_snapshot()
    assert c.get("task_timeouts") == 2 and not c.get("fail_fast"), c


def test_retry_budget_exhaustion_raises_original_error():
    bad = CannedWorker("bad", fail_times=99)
    pol = rz.RetryPolicy(max_retries=2, backoff_base=0.001,
                         quarantine_after=99, speculative_multiplier=0)

    class PickFirst:
        def pick(self, task, states):
            return states[0].worker.id

    sup = rz.TaskSupervisor(rz.ResilienceContext(policy=pol),
                            WorkerManager([bad]), PickFirst())
    with pytest.raises(RuntimeError, match="canned failure"):
        sup.run(_trivial_tasks(1))
    assert len(bad.submitted) == 3


# ------------------------------------------------- the remote worker

def test_remote_worker_serializes_true_exception_type():
    from daft_tpu_torch.distributed.remote_worker import (RemoteWorker,
                                                          WorkerServer)
    from daft_tpu_torch.distributed.worker import FetchSpec
    srv = WorkerServer()
    try:
        rw = RemoteWorker("r0", srv.address)
        schema = daft_tpu_torch.from_pydict({"x": [1]}).schema()
        task = StageTask(0, pp.StageInput(0, schema),
                         {0: FetchSpec([("http://127.0.0.1:9", "deadbeef")],
                                       0)})
        with pytest.raises(rz.ShuffleFetchError) as ei:
            rw.submit(task).result()
        assert ei.value.shuffle_id == "deadbeef"
        assert getattr(ei.value, "remote_traceback", "")
        rw.shutdown()
    finally:
        srv.shutdown()


def _worker_child(*extra):
    env = dict(os.environ)
    env.pop("DAFT_TORCH_TRACE", None)
    env["DAFT_TORCH_DEVICE"] = "0"
    proc = subprocess.Popen(
        [sys.executable, "-m", "daft_tpu_torch.distributed.remote_worker",
         "--port", "0", "--host", "127.0.0.1", *extra],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    line = proc.stdout.readline()
    addr = line.strip().split()[-1]
    assert addr.startswith("http://"), line
    return proc, addr


def test_remote_worker_ships_spans_cross_process(monkeypatch):
    from daft_tpu_torch.distributed import (LeastLoadedScheduler, StagePlan,
                                            StageRunner)
    from daft_tpu_torch.distributed.remote_worker import (RemoteWorker,
                                                          fetch_status)
    from daft_tpu_torch.physical.translate import translate
    proc, addr = _worker_child()
    try:
        monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
        tctx = tracing.maybe_start_trace("xproc")
        assert tctx is not None
        df = (daft_tpu_torch.from_pydict(
            {"k": [i % 5 for i in range(300)],
             "v": [float(i) for i in range(300)]}).into_partitions(2)
            .groupby("k").agg(col("v").sum().alias("s")))
        with tracing.attach(tctx):
            sp = StagePlan.from_physical(
                translate(df._builder.optimize().plan))
            runner = StageRunner(
                WorkerManager([RemoteWorker("remote-0", addr)]),
                LeastLoadedScheduler())
            parts = list(runner.run(sp))
        got = {}
        for p in parts:
            d = p.to_pydict()
            got.update(zip(d.get("k", []), d.get("s", [])))
        assert set(got) == {0, 1, 2, 3, 4}
        rec = tctx.recorder
        kinds = {s["name"] for s in rec.spans()}
        assert "rpc:post" in kinds and "task:run" in kinds, sorted(kinds)
        assert any(s["lane"].startswith("worker:")
                   for s in rec.spans() if s["name"] == "task:run")
        assert addr in rec.summary().get("clock_offsets_us", {})
        assert tracing.orphan_spans(rec) == []
        tracing.abort_trace(tctx)
        st = fetch_status(addr)
        assert st["device"] == "host" and st["pid"] == proc.pid
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_worker_concurrent_tasks_one_trace_no_span_loss():
    from daft_tpu_torch.distributed.remote_worker import RemoteWorker
    from daft_tpu_torch.recordbatch import RecordBatch
    proc, addr = _worker_child("--slots", "2")
    rw = None
    try:
        rec = tracing.SpanRecorder("ee" * 16)
        tracing.register_recorder(rec)
        rw = RemoteWorker("r0", addr, num_slots=2)
        mp = MicroPartition.from_recordbatch(
            RecordBatch.from_pydict({"x": list(range(50))}))

        def mk_task(i):
            return StageTask(
                0, pp.InMemorySource([mp], mp.schema), {}, task_idx=i,
                fault_key=f"s0.t{i}",
                trace_ctx=(rec.trace_id,
                           tracing.span_id_from(f"run:s0.t{i}"),
                           rec.root_id))

        for f in [rw.submit(mk_task(i)) for i in range(2)]:
            assert f.result(timeout=120)
        runs = {s["span_id"] for s in rec.spans()
                if s["name"] == "task:run"}
        assert tracing.span_id_from("run:s0.t0") in runs
        assert tracing.span_id_from("run:s0.t1") in runs
        tracing.unregister_recorder(rec.trace_id)
    finally:
        if rw is not None:
            rw.shutdown()
        proc.terminate()
        proc.wait(timeout=10)


# --------------------------------------------------- traces under chaos

def _traced_distributed(monkeypatch, fault_spec=None):
    monkeypatch.setenv("DAFT_TORCH_TRACE", "1")
    monkeypatch.setenv("DAFT_TORCH_CHAOS_SERIALIZE", "1")
    monkeypatch.setenv("DAFT_TORCH_RETRY_BACKOFF", "0.01")
    if fault_spec:
        monkeypatch.setenv("DAFT_TORCH_FAULT_SPEC", fault_spec)
        monkeypatch.setenv("DAFT_TORCH_FAULT_SEED", "7")
    rz.reset_for_tests()
    out = _run_distributed(
        daft_tpu_torch.from_pydict({"k": [i % 7 for i in range(4000)],
                                    "v": [float(i) for i in range(4000)]})
        .into_partitions(3).groupby("k").agg(col("v").sum().alias("s")),
        num_workers=2)
    rz.reset_for_tests()
    stats = obs.last_query_stats()
    assert stats is not None and stats.trace_ctx is not None
    rows = sorted(zip(out["k"], [round(s, 6) for s in out["s"]]))
    return rows, stats.trace_ctx.recorder


def test_chaos_trace_deterministic_and_complete(monkeypatch):
    spec = "task:0.1,fetch:0.1,crash:0.1"
    rows1, rec1 = _traced_distributed(monkeypatch, spec)
    rows2, rec2 = _traced_distributed(monkeypatch, spec)
    assert rows1 == rows2
    assert sorted(rec1.span_ids()) == sorted(rec2.span_ids())
    assert tracing.orphan_spans(rec1) == []
    spans = rec1.spans()
    kinds = {s["name"] for s in spans}
    for want in ("query", "stage", "task", "task:run", "shuffle:fetch",
                 "task:retry"):
        assert want in kinds, (want, sorted(kinds))
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        if s["name"] in ("task:retry", "lineage:recompute", "task:run"):
            parent = by_id.get(s["parent_id"])
            assert parent is not None and parent["name"] == "task", s
    assert tracing.validate_chrome_trace(
        tracing.chrome_trace_json(rec1)) == []


def test_faultfree_distributed_trace(monkeypatch):
    _, rec = _traced_distributed(monkeypatch)
    kinds = {s["name"] for s in rec.spans()}
    assert "task:run" in kinds and "stage" in kinds
    assert tracing.orphan_spans(rec) == []


# ------------------------------------------------------- shuffle sweep

def test_startup_sweep_removes_only_stale_shuffle_dirs(tmp_path):
    from daft_tpu_torch.distributed.shuffle_service import \
        sweep_orphaned_shuffles
    stale = tmp_path / "shuffle_dead"
    stale.mkdir()
    (stale / "part-0.arrow").write_bytes(b"x")
    old = time.time() - 7200
    os.utime(stale, (old, old))
    live = tmp_path / "shuffle_live"
    live.mkdir()
    unrelated = tmp_path / "not_a_shuffle"
    unrelated.mkdir()
    os.utime(unrelated, (old, old))
    assert sweep_orphaned_shuffles(root=str(tmp_path), ttl_s=3600) == \
        [str(stale)]
    assert live.exists() and unrelated.exists()


def test_sweep_scans_sibling_spill_roots_of_crashed_processes(
        tmp_path, monkeypatch):
    import tempfile

    from daft_tpu_torch.distributed import shuffle_service as ss
    from daft_tpu_torch.execution import memory
    mine = tmp_path / "daft_torch_spill_mine"
    mine.mkdir()
    monkeypatch.setattr(memory, "_spill_dir", str(mine))
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    dead = tmp_path / "daft_torch_spill_crashed" / "shuffle_zzz"
    dead.mkdir(parents=True)
    old = time.time() - 7200
    os.utime(dead, (old, old))
    assert str(dead) in ss.sweep_orphaned_shuffles(ttl_s=3600)
    assert not dead.exists()


# ------------------------------------ the chaos freeze of the other planes

@pytest.mark.parametrize("trigger", ["serialize", "fault_plan"])
def test_chaos_freezes_scan_governor_and_calibration(monkeypatch, trigger):
    from daft_tpu_torch.device import calibration
    from daft_tpu_torch.execution import governor
    from daft_tpu_torch.io import read_planner as rp
    monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", "4")
    monkeypatch.setenv("DAFT_TORCH_MEMORY_LIMIT", "64GiB")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    assert rp.scan_sequential_fallback() is False
    assert governor.enabled() is True
    assert calibration.frozen() is False
    if trigger == "serialize":
        monkeypatch.setenv("DAFT_TORCH_CHAOS_SERIALIZE", "1")
    else:
        monkeypatch.setenv("DAFT_TORCH_FAULT_SPEC", "task:0")
        rz.reset_for_tests()
    assert rp.scan_sequential_fallback() is True
    assert governor.enabled() is False
    assert calibration.frozen() is True
    # frozen: reads give the caller's default, observations are dropped
    calibration.reset_for_tests()
    calibration.observe("SHUFFLE_WIRE_BPS", 123.0, weight=100)
    assert calibration.const("SHUFFLE_WIRE_BPS", 7.0) == 7.0
    assert "SHUFFLE_WIRE_BPS" not in calibration.profile_entries()
    calibration.reset_for_tests()


def test_prefetch_degrades_under_chaos(tmp_path, monkeypatch):
    """An active fault plan or ``DAFT_TORCH_CHAOS_SERIALIZE=1`` takes the
    sequential scan (no prefetched task), and the answer is unchanged."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from daft_tpu_torch.io import read_planner as rp
    for i in range(4):
        pq.write_table(pa.table({"seq": list(range(i * 400,
                                                   (i + 1) * 400))}),
                       str(tmp_path / f"{i}.parquet"))
    monkeypatch.setenv("DAFT_TORCH_SCAN_PREFETCH", "4")

    def q():
        with daft_tpu_torch.execution_config_ctx(
                scan_tasks_min_size_bytes=1):
            return daft_tpu_torch.read_parquet(
                str(tmp_path / "*.parquet")).select("seq").to_pydict()

    before = rp.scan_counters_snapshot()
    assert sorted(q()["seq"]) == list(range(1600))
    assert rp.scan_counters_delta(before).get("prefetch_tasks", 0) > 0
    for env in ({"DAFT_TORCH_CHAOS_SERIALIZE": "1"},
                {"DAFT_TORCH_FAULT_SPEC": "task:0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        rz.reset_for_tests()
        before = rp.scan_counters_snapshot()
        assert sorted(q()["seq"]) == list(range(1600))
        assert rp.scan_counters_delta(before).get("prefetch_tasks", 0) == 0
        for k in env:
            monkeypatch.delenv(k)
