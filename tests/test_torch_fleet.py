"""The port's serving fleet (``daft_tpu_torch/fleet/``) against the
reference's (``tests/test_fleet.py``).

The reference's 13 cases, each run through both packages on the same
files (written once) or the same in-memory data, queries on CPU tensors
(``DAFT_TORCH_DEVICE=cpu``): routing (the ring's sha256 hashpoints give
the same owners in both), kill and drain with re-routing, gossiped state
(idempotent, commutative, sample-weighted merges), the cold replica's
calibration and admission seeded from the fleet, the cross-replica
result cache, the sidecar store, the calibration token in plan
fingerprints and the scale signal. Answers are equal (keys and integers
exact, float sums at relative 1e-9), and so are the fleet counters each
case reads.

Port-only, the repairs for replicas on a card (ROADMAP Queue C caveats):
a subprocess replica that writes more than 1 MiB after READY still
answers control and ``/sql`` calls; a replica whose Connect fails to
import reports ``connect: null`` with the reason, and the router never
hands out an empty Connect address; a replica that misses ``spawn``'s
deadline fails with its output's tail; a drain waits its own grace.
"""

import glob as globmod
import http.server
import math
import os
import sys
import textwrap
import threading
import types

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu.device.calibration as ref_cal
import daft_tpu.fleet.cache_tier as ref_cache_tier
import daft_tpu.fleet.router as ref_router
import daft_tpu.fleet.state_sync as ref_state_sync
import daft_tpu.logical.fingerprint as ref_fp
import daft_tpu.logical.stats as ref_stats
import daft_tpu.serving as ref_serving
import daft_tpu.serving.scheduler as ref_sched
import daft_tpu_torch
import daft_tpu_torch.device.calibration as cal
import daft_tpu_torch.fleet.cache_tier as cache_tier
import daft_tpu_torch.fleet.router as router_mod
import daft_tpu_torch.fleet.state_sync as state_sync
import daft_tpu_torch.logical.fingerprint as fp_mod
import daft_tpu_torch.logical.stats as stats_mod
import daft_tpu_torch.serving as serving
import daft_tpu_torch.serving.scheduler as sched_mod
from daft_tpu.execution.cancellation import QueryCancelled as RefCancelled
from daft_tpu_torch.execution.cancellation import QueryCancelled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _side(dt, cal_, cache_tier_, router_, state_sync_, fp_, stats_,
          serving_, sched_, cancelled, pre):
    return types.SimpleNamespace(
        dt=dt, cal=cal_, cache_tier=cache_tier_, router=router_,
        state_sync=state_sync_, fp=fp_, stats=stats_, serving=serving_,
        sched=sched_, QueryCancelled=cancelled, pre=pre)


SIDES = {
    "ref": _side(daft_tpu, ref_cal, ref_cache_tier, ref_router,
                 ref_state_sync, ref_fp, ref_stats, ref_serving, ref_sched,
                 RefCancelled, "DAFT_TPU_"),
    "port": _side(daft_tpu_torch, cal, cache_tier, router_mod, state_sync,
                  fp_mod, stats_mod, serving, sched_mod, QueryCancelled,
                  "DAFT_TORCH_"),
}


def _reset():
    for s in SIDES.values():
        s.state_sync.reset_for_tests()
        s.cache_tier.install(None)
        s.cal.reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh_fleet_state(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    _reset()
    yield
    _reset()


@pytest.fixture
def parquet_table(tmp_path):
    root = tmp_path / "t"
    os.makedirs(root)
    pq.write_table(pa.table({"k": list(range(2000)),
                             "g": [i % 7 for i in range(2000)],
                             "v": [float(i % 31) for i in range(2000)]}),
                   str(root / "part-0.parquet"))
    return str(root / "*.parquet")


def _agg_query(s, glob):
    return s.dt.read_parquet(glob).groupby("g") \
        .agg(s.dt.col("v").sum().alias("s")).sort("g")


def _gated_query(s, gate: threading.Event, started: threading.Event = None):
    @s.dt.udf(return_dtype=s.dt.DataType.int64())
    def block(x):
        if started is not None:
            started.set()
        gate.wait(30)
        return x.to_pylist()

    return s.dt.from_pydict({"a": [1]}).select(block(s.dt.col("a")))


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9)
    return a == b


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c]), c
        assert all(_close(x, y) for x, y in zip(got[c], want[c])), c


def _fleet(s):
    hub = s.cache_tier.InProcessCacheTier()
    reps = [s.router.InProcessReplica(f"r{i}", cache_tier=hub)
            for i in range(3)]
    return s.router.FleetRouter(reps), reps


@pytest.fixture
def fleets():
    out = {k: _fleet(s) for k, s in SIDES.items()}
    yield out
    for router, _ in out.values():
        router.shutdown()


# ---------------------------------------------------------------- routing

def test_session_affinity_and_spread(fleets, parquet_table):
    got = {}
    for k, s in SIDES.items():
        router, _ = fleets[k]
        expected = _agg_query(s, parquet_table).to_pydict()
        owners = set()
        for _ in range(5):
            h = router.submit(_agg_query(s, parquet_table),
                              session="sticky")
            assert h.result(60).to_recordbatch().to_pydict() == expected
            owners.add(router.route("sticky").name)
        assert len(owners) == 1
        spread = [router.route(f"s-{i}").name for i in range(24)]
        assert len(set(spread)) >= 2
        got[k] = (expected, owners, spread)
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:]


def test_kill_reroutes_and_cancels_inflight(fleets, parquet_table):
    got = {}
    for k, s in SIDES.items():
        router, reps = fleets[k]
        gate, started = threading.Event(), threading.Event()
        h = router.submit(_gated_query(s, gate, started), session="doomed")
        assert started.wait(20)
        owner = router.route("doomed").name
        router.kill(owner)
        gate.set()
        with pytest.raises(s.QueryCancelled):
            h.result(60)
        assert h.state == "cancelled"
        router.submit(_agg_query(s, parquet_table),
                      session="doomed").result(60)
        new_owner = router.route("doomed").name
        assert new_owner != owner
        assert s.state_sync.counters_snapshot().get("kill") == 1
        dead = next(r for r in reps if r.name == owner)
        with pytest.raises(s.router.ReplicaUnavailable):
            dead.submit(_agg_query(s, parquet_table), session="x")
        got[k] = (owner, new_owner)
    assert got["port"] == got["ref"]


def test_drain_rehomes_sessions_and_rejects_draining(fleets, parquet_table):
    got = {}
    for k, s in SIDES.items():
        router, reps = fleets[k]
        router.submit(_agg_query(s, parquet_table),
                      session="moving").result(60)
        owner = router.route("moving").name
        stats = router.drain(owner)
        assert stats["finished_in_time"] is True
        rep = next(r for r in reps if r.name == owner)
        assert rep.scheduler.draining
        direct = rep.scheduler.submit(_agg_query(s, parquet_table),
                                      session="x")
        with pytest.raises(s.serving.AdmissionRejected) as ei:
            direct.result(10)
        assert ei.value.kind == "draining"
        router.submit(_agg_query(s, parquet_table),
                      session="moving").result(60)
        new_owner = router.route("moving").name
        assert new_owner != owner
        released = rep.scheduler.counters_snapshot().get(
            "sessions_released", 0)
        assert released >= 1
        got[k] = (owner, new_owner, released, stats["sessions_moved"])
    assert got["port"] == got["ref"]


# ------------------------------------------------------------ state sync

def _snap(origin, gen, calib=None, admission=None):
    return {"origin": origin, "gen": gen, "calib": calib or {},
            "admission": admission or {}}


def test_gossip_merge_idempotent_and_commutative():
    got = {}
    for k, s in SIDES.items():
        a1 = _snap("a", 1, {"DEV_AGG_BPS": {"value": 1e9, "samples": 10}})
        a2 = _snap("a", 2, {"DEV_AGG_BPS": {"value": 2e9, "samples": 30}})
        b1 = _snap("b", 1, {"DEV_AGG_BPS": {"value": 6e9, "samples": 10}})
        x, y = s.state_sync.StateStore("x"), s.state_sync.StateStore("y")
        for snap in (a1, a2, b1):
            assert x.ingest(dict(snap))
        assert y.ingest(dict(b1)) and y.ingest(dict(a2))
        assert not y.ingest(dict(a1))
        assert not x.ingest(dict(a2))
        assert x.merged_calibration("DEV_AGG_BPS") == \
            y.merged_calibration("DEV_AGG_BPS")
        v, n = x.merged_calibration("DEV_AGG_BPS")
        assert n == 40 and v == pytest.approx(3e9)
        x.publish_local({}, {})
        assert not x.ingest(_snap("x", 99))
        assert x.generation("x") == 1
        got[k] = (v, n, x.view(), s.state_sync.counters_snapshot())
    assert got["port"] == got["ref"]


def test_sample_weighted_admission_merge():
    got = {}
    for k, s in SIDES.items():
        x = s.state_sync.StateStore("x")
        x.ingest(_snap("a", 1, admission={
            "k": {"bytes": 4e6, "wall_us": 900.0, "samples": 3}}))
        x.ingest(_snap("b", 1, admission={"k": (8e6, 1300.0, 1.0)}))
        b, w, n = x.merged_admission("k")
        assert n == 4 and b == pytest.approx(5e6) \
            and w == pytest.approx(1000.0)
        assert x.merged_admission("unknown") is None
        got[k] = (b, w, n)
    assert got["port"] == got["ref"]


def test_cold_replica_inherits_calibration(monkeypatch):
    got = {}
    for k, s in SIDES.items():
        monkeypatch.setenv(s.pre + "CALIBRATION", "1")
        monkeypatch.setenv(s.pre + "CALIBRATION_MIN_SAMPLES", "3")
        store = s.state_sync.StateStore("cold")
        store.ingest(_snap("warm", 5, {
            "DEV_AGG_BPS": {"value": 1.5e9, "samples": 40}}))
        s.state_sync.install(store)
        inherited = s.cal.const("DEV_AGG_BPS", 4e9)
        assert inherited == pytest.approx(1.5e9)
        assert s.state_sync.counters_snapshot().get(
            "calibration_fleet_reads") == 1
        store2 = s.state_sync.StateStore("cold2")
        store2.ingest(_snap("warm", 6, {
            "DEV_SORT_ROWS_PER_S": {"value": 9e6, "samples": 2}}))
        s.state_sync.install(store2)
        below = s.cal.const("DEV_SORT_ROWS_PER_S", 50e6)
        assert below == 50e6
        got[k] = (inherited, below)
    assert got["port"] == got["ref"]


def test_cold_replica_admission_seeded_from_fleet(monkeypatch,
                                                 parquet_table):
    got = {}
    for k, s in SIDES.items():
        monkeypatch.setattr(s.stats, "estimate",
                            lambda plan, _s=s: _s.stats.Stats(None, None))
        warm_store = s.state_sync.StateStore("warm")
        warm = s.serving.QueryScheduler(concurrency=1, result_cache_bytes=0,
                                        fleet_state=warm_store, name="warm")
        cold_store = s.state_sync.StateStore("cold")
        cold = s.serving.QueryScheduler(concurrency=1, result_cache_bytes=0,
                                        fleet_state=cold_store, name="cold")
        try:
            h1 = warm.submit(_agg_query(s, parquet_table))
            h1.result(60)
            assert h1._fp_hist_key is not None
            warm_store.publish_from_engine(warm)
            assert cold_store.ingest_all(warm_store.snapshot_all()) == 1
            h2 = cold.submit(_agg_query(s, parquet_table))
            h2.result(60)
            assert cold.counters_snapshot().get("est_seeded_fleet") == 1
            est = h2.stats.serving["admitted_bytes"]
            assert 0 < est < s.sched._DEFAULT_EST_BYTES
            got[k] = est
        finally:
            warm.shutdown()
            cold.shutdown()
    # the admitted bytes are the warm run's observed result bytes: each
    # package's own result, so each is held to its own bounds above
    assert got["port"] > 0 and got["ref"] > 0


# ------------------------------------------------------------ cache tier

def test_fleet_result_cache_hit_across_replicas(fleets, parquet_table):
    got = {}
    for k, s in SIDES.items():
        router, reps = fleets[k]
        expected = _agg_query(s, parquet_table).to_pydict()
        router.submit(_agg_query(s, parquet_table),
                      session="first").result(60)
        first = router.route("first").name
        other = next(f"o-{i}" for i in range(200)
                     if router.route(f"o-{i}").name != first)
        h2 = router.submit(_agg_query(s, parquet_table), session=other)
        ans = h2.result(60).to_recordbatch().to_pydict()
        assert ans == expected
        assert h2.stats.serving["result_cache"] == "fleet_hit"
        landing = next(r for r in reps
                       if r.name == router.route(other).name)
        assert landing.scheduler.counters_snapshot() \
            .get("result_cache_fleet_hits") == 1
        h3 = router.submit(_agg_query(s, parquet_table), session=other)
        h3.result(60)
        assert h3.stats.serving["result_cache"] == "hit"
        got[k] = (ans, first, other, landing.name)
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:]


def test_sidecar_cache_tier_roundtrip():
    import daft_tpu.micropartition as ref_mp
    import daft_tpu.runners.runner as ref_runner
    import daft_tpu.schema as ref_schema
    import daft_tpu_torch.micropartition as port_mp
    import daft_tpu_torch.runners.runner as port_runner
    import daft_tpu_torch.schema as port_schema
    mods = {"ref": (ref_mp, ref_runner, ref_schema),
            "port": (port_mp, port_runner, port_schema)}
    got = {}
    for k, s in SIDES.items():
        mp_, runner_, schema_ = mods[k]
        t = pa.table({"g": [0, 1, 2], "s": [10.0, 11.0, 12.0]})
        ps = runner_.PartitionSet([mp_.MicroPartition.from_arrow_table(t)],
                                  schema_.Schema.from_arrow(t.schema))
        fp = s.fp.PlanFingerprint("deadbeef", ("p",), ("src",), "deadbeef")
        sc = s.cache_tier.CacheSidecar(budget_bytes=8 << 20)
        addr = sc.start()
        try:
            tier = s.cache_tier.SidecarCacheTier(addr)
            assert tier.get_result(fp) is None
            tier.put_result(fp, ps)
            back = tier.get_result(fp)
            assert back is not None
            assert back.to_recordbatch().to_pydict() == \
                ps.to_recordbatch().to_pydict()
            assert tier.get_plan(fp) is None
            c = s.state_sync.counters_snapshot()
            assert (c.get("cache_tier_misses"), c.get("cache_tier_puts"),
                    c.get("cache_tier_hits")) == (1, 1, 1)
        finally:
            sc.stop()
        dead = s.cache_tier.SidecarCacheTier(addr, timeout_s=0.2)
        assert dead.get_result(fp) is None
        dead.put_result(fp, ps)
        assert s.state_sync.counters_snapshot().get(
            "cache_tier_errors", 0) >= 1
        got[k] = (back.to_recordbatch().to_pydict(),
                  s.cache_tier._fp_token(fp))
    assert got["port"] == got["ref"]


# ------------------------------------------- fingerprint calibration token

def test_fingerprint_calibration_token_invalidates_plans(monkeypatch,
                                                         parquet_table):
    for s in SIDES.values():
        cfg = s.dt.get_context().execution_config
        plan = _agg_query(s, parquet_table)._builder.plan
        f_off = s.fp.fingerprint(plan, cfg)
        assert f_off.structure == f_off.history_structure
        monkeypatch.setenv(s.pre + "CALIBRATION", "1")
        monkeypatch.setenv(s.pre + "CALIBRATION_MIN_SAMPLES", "2")
        f_cold = s.fp.fingerprint(plan, cfg)
        assert f_cold.key == f_off.key
        s.cal.observe("DEV_AGG_BPS", 1e9)
        s.cal.observe("DEV_AGG_BPS", 1e9)
        assert s.cal.plan_token() != ""
        f_warm = s.fp.fingerprint(plan, cfg)
        assert f_warm.structure != f_off.structure
        assert f_warm.key != f_off.key
        assert f_warm.history_structure == f_off.history_structure
        s.cal.observe("DEV_AGG_BPS", 1.001e9)
        assert s.fp.fingerprint(plan, cfg).structure == f_warm.structure
        s.cal.reset_for_tests()
        store = s.state_sync.StateStore("me")
        store.ingest(_snap("peer", 3, {
            "DEV_AGG_BPS": {"value": 1e9, "samples": 40}}))
        s.state_sync.install(store)
        f_fleet = s.fp.fingerprint(plan, cfg)
        assert f_fleet.structure == f_warm.structure
        assert f_fleet.history_structure == f_off.history_structure
    # the same local and fleet constants give the same token in both
    tokens = []
    for s in SIDES.values():
        s.cal.reset_for_tests()
        st = s.state_sync.StateStore("me")
        st.ingest(_snap("peer", 3, {
            "DEV_AGG_BPS": {"value": 1e9, "samples": 40}}))
        s.state_sync.install(st)
        tokens.append(s.cal.plan_token())
    assert tokens[0] == tokens[1] != ""


def test_fingerprint_remote_source_version_token(parquet_table):
    pqf = sorted(globmod.glob(parquet_table))[0]
    with open(pqf, "rb") as f:
        data = f.read()
    etag = {"value": '"v1"', "send": True}

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _serve(self, head_only):
            body, code = data, 200
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                a, _, b = rng[len("bytes="):].partition("-")
                start = int(a or 0)
                end = min(int(b) + 1 if b else len(data), len(data))
                body, code = data[start:end], 206
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            if etag["send"]:
                self.send_header("ETag", etag["value"])
            self.end_headers()
            if not head_only:
                self.wfile.write(body)

        def do_GET(self):
            self._serve(False)

        def do_HEAD(self):
            self._serve(True)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/t.parquet"
    got = {}
    try:
        for k, s in SIDES.items():
            etag.update(value='"v1"', send=True)
            cfg = s.dt.get_context().execution_config
            f1 = s.fp.fingerprint(s.dt.read_parquet(url)._builder.plan, cfg)
            assert f1 is not None
            tokens = [v for (_op, vers) in f1.sources for v in vers]
            assert tokens == [(url, "http", len(data), '"v1"')]
            f2 = s.fp.fingerprint(s.dt.read_parquet(url)._builder.plan, cfg)
            assert f2.key == f1.key
            etag["value"] = '"v2"'
            f3 = s.fp.fingerprint(s.dt.read_parquet(url)._builder.plan, cfg)
            assert f3.key != f1.key
            assert f3.structure == f1.structure
            assert s.sched._history_key_from_fp(f3) == \
                s.sched._history_key_from_fp(f1)
            etag["send"] = False
            assert s.fp.fingerprint(
                s.dt.read_parquet(url)._builder.plan, cfg) is None
            got[k] = tokens
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["ref"]


# ------------------------------------------------------------- aggregate

def test_gauges_scale_signal_and_gossip_round(fleets, parquet_table):
    got = {}
    for k, s in SIDES.items():
        router, reps = fleets[k]
        router.submit(_agg_query(s, parquet_table), session="g").result(60)
        g = router.gauges()
        agg = g["aggregate"]
        assert agg["replicas"] == 3 and agg["replicas_admitting"] == 3
        assert agg["concurrency"] == sum(
            r.gauges()["concurrency"] for r in reps)
        sig = router.scale_signal()
        assert 1 <= sig["desired_replicas"] <= 4
        applied = router.gossip_round()
        for r in reps:
            assert set(r.store.origins()) == {"r0", "r1", "r2"}
        got[k] = (agg, sig, applied)
    assert got["port"] == got["ref"]


def test_scheduler_release_session_cancels_queued():
    got = {}
    for k, s in SIDES.items():
        sched = s.serving.QueryScheduler(concurrency=1, queue_timeout_s=60.0)
        try:
            gate, started = threading.Event(), threading.Event()
            blocker = sched.submit(_gated_query(s, gate, started),
                                   session="keep")
            assert started.wait(20)
            queued = sched.submit(
                s.dt.from_pydict({"a": [1]}).select(s.dt.col("a")),
                session="gone")
            assert sched.release_session("gone") is True
            with pytest.raises(s.QueryCancelled):
                queued.result(10)
            assert queued.state == "cancelled"
            assert sched.release_session("gone") is False
            gate.set()
            blocker.result(60)
            assert sched.admission.outstanding == 0
            got[k] = {c: sched.counters_snapshot().get(c, 0)
                      for c in ("submitted", "completed", "cancelled",
                                "sessions_released")}
        finally:
            sched.shutdown()
    assert got["port"] == got["ref"]


# ----------------------------------------- port-only: replicas on a card

def _replica_env(tmp_path, body: str = "", **kw) -> dict:
    """The environment of a replica on the CPU whose interpreter runs
    ``body`` at start-up, before ``daft_tpu_torch.fleet.replica`` (a
    ``sitecustomize`` module first on its ``PYTHONPATH``)."""
    site = tmp_path / "site"
    os.makedirs(site, exist_ok=True)
    (site / "sitecustomize.py").write_text(textwrap.dedent(body))
    env = {"DAFT_TORCH_DEVICE": "cpu",
           "PYTHONPATH": os.pathsep.join([str(site), REPO])}
    env.update(kw)
    return env


def test_replica_that_logs_past_its_pipe_still_answers(tmp_path):
    """A replica writing 1.5 MiB to its output after READY (each /sql
    call does) answers every control and /sql call: the parent drains its
    output for its whole life (the reference stopped reading at READY and
    a 64 KiB pipe blocked the replica in ``write``)."""
    env = _replica_env(tmp_path, """
        import sys
        import daft_tpu_torch.sql
        sql_pkg = sys.modules["daft_tpu_torch.sql"]
        _orig = sql_pkg.sql

        def noisy(*a, **kw):
            for _ in range(96):
                sys.stdout.write("x" * 16383 + "\\n")
            sys.stdout.flush()
            return _orig(*a, **kw)
        sql_pkg.sql = noisy   # what ReplicaProcess.run_sql plans with
    """)
    rep = router_mod.SubprocessReplica.spawn(
        "noisy", env=env, timeout_s=120.0, control_timeout_s=30.0)
    try:
        for i in range(2):
            out = rep.sql(f"SELECT {i} + 1 AS x", session="s",
                          timeout_s=60.0)
            assert out["data"] == {"x": [i + 1]}
        assert rep.output.bytes > (1 << 20) + (1 << 20)
        assert len(rep.output.tail()) <= 64 << 10
        assert rep.health()["ok"] and rep.alive()
        assert "queued" in rep.gauges()
        st = rep.status()
        assert st["device"] == "cpu" and "hash_agg_build" in st["launches"]
    finally:
        rep.shutdown()
    assert rep.proc.returncode is not None


def test_replica_without_connect_reports_null_and_is_never_routed(
        tmp_path):
    """A replica whose Connect server cannot import ``grpc`` reports
    ``connect: null`` with the reason; the router hands out no empty
    address (``ConnectUnavailable`` names the reason) and its queries go
    over ``POST /sql``."""
    env = _replica_env(tmp_path, """
        import sys
        sys.modules["grpc"] = None  # grpcio absent
    """)
    rep = router_mod.SubprocessReplica.spawn(
        "nogrpc", env=env, timeout_s=120.0, control_timeout_s=30.0)
    router = router_mod.FleetRouter([rep])
    try:
        assert rep.connect_address is None
        h = rep.health()
        assert h["connect"] is None and "grpc" in h["connect_error"]
        assert "grpc" in rep.connect_error
        with pytest.raises(router_mod.ConnectUnavailable, match="grpc"):
            router.connect_address("any-session")
        assert router.sql("SELECT 2 AS y", session="any-session",
                          timeout_s=60.0)["data"] == {"y": [2]}
    finally:
        router.shutdown()


def test_start_connect_tolerates_only_its_packages(monkeypatch):
    from daft_tpu_torch.fleet import replica
    monkeypatch.setitem(sys.modules, "grpc", None)
    server, why = replica.start_connect()
    assert server is None and "grpc" in why

    def broken(port=0):
        raise ImportError("a broken build", name="daft_tpu_torch.csrc")
    import daft_tpu_torch.connect as connect_pkg
    monkeypatch.setattr(connect_pkg, "start_server", broken)
    with pytest.raises(ImportError, match="broken build"):
        replica.start_connect()


def test_spawn_deadline_names_the_replica_output(tmp_path):
    env = _replica_env(tmp_path, """
        import time
        print("loading something slow", flush=True)
        time.sleep(60)
    """)
    with pytest.raises(RuntimeError) as ei:
        router_mod.SubprocessReplica.spawn("slow", env=env, timeout_s=3.0)
    assert "not ready within 3.0 s" in str(ei.value)
    assert "loading something slow" in str(ei.value)


def test_replica_measures_its_link_before_it_serves(monkeypatch):
    """A replica prices with the link profile it measured while it
    started, before READY, and ``/status`` reports it; on the CPU, where
    host memory is shared, the profile is the zero-cost one."""
    from daft_tpu_torch.device import costmodel
    from daft_tpu_torch.fleet import replica
    seen = []
    measured = costmodel.LinkProfile(rtt_s=3e-4, up_bps=4.0e9,
                                     down_bps=3.0e10)

    def link_profile():
        seen.append(True)
        return measured

    monkeypatch.setattr(costmodel, "link_profile", link_profile)
    try:
        rp = replica.ReplicaProcess("r-link", with_connect=False)
        assert seen == [True] and rp.link is measured
        assert rp.status()["link"] == dict(rtt_s=3e-4, up_bps=4.0e9,
                                           down_bps=3.0e10)
        monkeypatch.undo()
        monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
        costmodel.reset_for_tests()
        rp = replica.ReplicaProcess("r-cpu", with_connect=False)
        assert rp.status()["link"] is None
    finally:
        serving.shutdown_shared()
