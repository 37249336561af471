"""The port's topology-aware exchange planner (``daft_tpu_torch/
distributed/topology.py`` and the stage runner's placement layer) held
against the reference's (``tests/test_pod_shuffle.py``).

- Topology parsing, autodetection, the exchange-path decision ladder
  (chaos serialization, a forced path, an active fault plan, the config
  mirrors) and the collective lease gauge, each decided as the reference
  decides.
- The three exchange paths (collective, hierarchical, flight) on a
  grouped aggregation and a hash join: every path equal to the driver
  oracle and to the reference's answer.
- The collective path over the 8-shard CPU mesh moves its bytes through
  the mesh all_to_all (``ici_*`` counters, no wire fetch).
- Chaos replay under ``DAFT_TORCH_CHAOS_SERIALIZE=1`` with a topology is
  bit-identical (the same fault events as without), and a lost per-mesh
  stream recovers as a whole exchange group.
- The exchange counters surface in the stats render and the metrics.

The reference's device tier (``DAFT_TPU_DEVICE=1``, its 8-device CPU mesh)
pairs with the port's 8-shard mesh on ``cpu``; its host tier
(``DAFT_TPU_DEVICE=0``) with the port's (``DAFT_TORCH_DEVICE=0``).
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.distributed import resilience as r_rz
from daft_tpu.distributed import shuffle_service as r_ss
from daft_tpu.distributed import topology as r_tp
from daft_tpu_torch.distributed import resilience as rz
from daft_tpu_torch.distributed import shuffle_service as ss
from daft_tpu_torch.distributed import topology as tp
from daft_tpu_torch.parallel import mesh as tmesh

PATH_ENVS = ("flight", "collective", "hierarchical")
TOPOLOGY_2MESH = "podA=worker-0,worker-1;podB=worker-2"
MODS = {"ref": (daft_tpu, r_rz, r_ss, r_tp, "DAFT_TPU_"),
        "port": (daft_tpu_torch, rz, ss, tp, "DAFT_TORCH_")}


def _device(monkeypatch, on: bool):
    """Both packages' device tier on (with their meshes) or off."""
    monkeypatch.setenv("DAFT_TPU_DEVICE", "1" if on else "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu" if on else "0")
    if on:
        monkeypatch.setenv("DAFT_TORCH_MESH_DEVICES", "8")
    tmesh.reset_for_tests()


def _set(monkeypatch, side: str, **env):
    pre = MODS[side][4]
    for k, v in env.items():
        monkeypatch.setenv(pre + k, v)


def _run_distributed(side, q, monkeypatch, path=None, topology=None,
                     num_workers=3):
    pkg, _, shuf, _, pre = MODS[side]
    if path is not None:
        monkeypatch.setenv(pre + "EXCHANGE_PATH", path)
    if topology is not None:
        monkeypatch.setenv(pre + "WORKER_TOPOLOGY", topology)
    import importlib
    DR = importlib.import_module(
        f"{pkg.__name__}.runners.distributed_runner").DistributedRunner
    ctx = importlib.import_module(f"{pkg.__name__}.context").get_context()
    runner = DR(num_workers=num_workers)
    old = ctx._runner
    ctx.set_runner(runner)
    before = shuf.shuffle_counters_snapshot()
    try:
        out = q(pkg)
    finally:
        ctx.set_runner(old)
        if runner._manager is not None:
            runner._manager.shutdown()
        monkeypatch.delenv(pre + "EXCHANGE_PATH", raising=False)
        monkeypatch.delenv(pre + "WORKER_TOPOLOGY", raising=False)
    return out, shuf.shuffle_counters_delta(before)


def _canon(d, float_cols=()):
    cols = sorted(d)
    return sorted(tuple(round(v, 6) if c in float_cols else v
                        for c, v in zip(cols, row))
                  for row in zip(*(d[c] for c in cols)))


# ------------------------------------------------------------- topology

@pytest.mark.parametrize("side", ["ref", "port"])
def test_topology_spec_parsing(side):
    t = MODS[side][3]
    topo = t.WorkerTopology.from_spec("podA=w0,w1;podB=w2",
                                      ["w0", "w1", "w2", "w3"])
    assert topo.n_groups == 3
    assert topo.group_of("w0").name == "podA"
    assert topo.group_of("w3").workers == ("w3",)
    assert topo.multi_worker_groups() == 1
    with pytest.raises(ValueError):
        t.WorkerTopology.from_spec("a=w0;b=w0", ["w0"])
    assert repr(topo) == repr(r_tp.WorkerTopology.from_spec(
        "podA=w0,w1;podB=w2", ["w0", "w1", "w2", "w3"]))


def test_topology_autodetect_single_mesh(monkeypatch):
    _device(monkeypatch, True)
    assert tp.WorkerTopology.detect(["w0", "w1"]).single_mesh()
    assert r_tp.WorkerTopology.detect(["w0", "w1"]).single_mesh()
    # no mesh: every worker is its own group
    monkeypatch.delenv("DAFT_TORCH_MESH_DEVICES")
    assert tp.WorkerTopology.detect(["w0", "w1"]).n_groups == 2


def _ladder(side, monkeypatch):
    """Decisions of the exchange-path ladder under each rung's trigger."""
    _, res, _, t, pre = MODS[side]
    out = {}
    topo = t.WorkerTopology.detect(["w0", "w1"])
    out["auto"] = t.plan_exchange_path(topo, 4)
    monkeypatch.setenv(pre + "CHAOS_SERIALIZE", "1")
    monkeypatch.setenv(pre + "EXCHANGE_PATH", "collective")
    out["chaos_over_force"] = t.plan_exchange_path(topo, 4)
    monkeypatch.delenv(pre + "CHAOS_SERIALIZE")
    monkeypatch.setenv(pre + "EXCHANGE_PATH", "collectve")
    with pytest.raises(ValueError, match="unknown exchange path"):
        t.plan_exchange_path(topo, 4)
    monkeypatch.delenv(pre + "EXCHANGE_PATH")
    monkeypatch.setenv(pre + "FAULT_SPEC", "fetch:0.1")
    res.reset_for_tests()
    out["fault_plan"] = t.plan_exchange_path(topo, 4)
    monkeypatch.setenv(pre + "EXCHANGE_PATH", "hierarchical")
    out["fault_plan_forced"] = t.plan_exchange_path(topo, 4)
    monkeypatch.delenv(pre + "EXCHANGE_PATH")
    monkeypatch.delenv(pre + "FAULT_SPEC")
    res.reset_for_tests()
    return out


def test_exchange_path_ladder_decides_as_the_reference(monkeypatch):
    _device(monkeypatch, True)
    got = _ladder("port", monkeypatch)
    assert got == _ladder("ref", monkeypatch)
    assert got == {"auto": "collective", "chaos_over_force": "flight",
                   "fault_plan": "flight",
                   "fault_plan_forced": "hierarchical"}


def test_config_field_mirrors_apply(monkeypatch):
    _device(monkeypatch, True)
    for side, field_pre in (("ref", "tpu_"), ("port", "")):
        pkg, _, _, t, pre = MODS[side]
        monkeypatch.delenv(pre + "EXCHANGE_PATH", raising=False)
        monkeypatch.delenv(pre + "WORKER_TOPOLOGY", raising=False)
        with pkg.execution_config_ctx(
                **{field_pre + "exchange_path": "flight",
                   field_pre + "worker_topology": "pod=w0,w1"}):
            topo = t.WorkerTopology.detect(["w0", "w1", "w2"])
            assert topo.group_of("w0").name == "pod"
            assert topo.group_of("w2").workers == ("w2",)
            assert t.plan_exchange_path(topo, 4) == "flight"


def test_collective_lease_gauge_balances():
    k = tp.acquire_collective("t.lease")
    assert tp.collective_inflight() >= 1
    tp.release_collective(k)
    assert tp.collective_inflight() == 0


# ---------------------------------------------------- path bit parity

def _groupby_query(data):
    def q(pkg):
        return pkg.from_pydict(data).into_partitions(4).groupby("k").agg(
            pkg.col("v").sum().alias("s")).to_pydict()
    return q


def test_exchange_paths_bit_parity_grouped_agg(monkeypatch):
    _device(monkeypatch, False)
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(0, 11, 6000).tolist(),
            "v": rng.integers(0, 1000, 6000).tolist()}
    q = _groupby_query(data)
    oracle = _canon(q(daft_tpu_torch))
    assert oracle == _canon(q(daft_tpu))
    for path in PATH_ENVS:
        topo = TOPOLOGY_2MESH if path == "hierarchical" else None
        for side in ("port", "ref"):
            out, delta = _run_distributed(side, q, monkeypatch, path=path,
                                          topology=topo)
            assert _canon(out) == oracle, (side, path)
            assert delta.get(f"exchange_path_{path}", 0) >= 1, \
                (side, path, delta)
            if path == "hierarchical":
                assert 1 <= delta.get("hierarchical_streams", 0) <= 2


def test_collective_path_rides_the_mesh(monkeypatch):
    """With the mesh up and admission forced, a collective repartition
    boundary moves its bytes through the mesh all_to_all: counted as
    ``ici_bytes``, zero wire fetches, and exact."""
    _device(monkeypatch, True)
    monkeypatch.setenv("DAFT_TORCH_MESH_MIN_ROWS", "0")
    monkeypatch.setenv("DAFT_TPU_MESH_MIN_ROWS", "0")
    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 1000, 4096).tolist(),
            "v": rng.integers(0, 10 ** 6, 4096).tolist()}

    def q(pkg):
        return pkg.from_pydict(data).into_partitions(4) \
            .repartition(8, pkg.col("k")).to_pydict()

    oracle = _canon(q(daft_tpu_torch))
    out, delta = _run_distributed("port", q, monkeypatch, path="collective")
    assert _canon(out) == oracle
    assert delta.get("ici_exchanges", 0) >= 1, delta
    assert delta.get("ici_bytes", 0) > 0
    assert delta.get("fetches", 0) == 0
    ref_out, _ = _run_distributed("ref", q, monkeypatch, path="collective")
    assert _canon(ref_out) == oracle


def test_exchange_paths_bit_parity_hash_join(monkeypatch):
    _device(monkeypatch, False)
    rng = np.random.default_rng(13)
    n = 4000
    left = {"k": rng.integers(0, 40, n).tolist(),
            "lv": rng.integers(0, 100, n).tolist()}
    right = {"k": list(range(40)), "rv": rng.integers(0, 9, 40).tolist()}

    def q(pkg):
        with pkg.execution_config_ctx(broadcast_join_size_bytes_threshold=1):
            lf = pkg.from_pydict(left).into_partitions(3)
            rf = pkg.from_pydict(right).into_partitions(2)
            return lf.join(rf, on="k").to_pydict()

    oracle = _canon(q(daft_tpu_torch))
    assert oracle == _canon(q(daft_tpu))
    for path in PATH_ENVS:
        topo = TOPOLOGY_2MESH if path == "hierarchical" else None
        out, _ = _run_distributed("port", q, monkeypatch, path=path,
                                  topology=topo)
        assert _canon(out) == oracle, path


# ------------------------------------------- chaos-serialize degradation

def test_chaos_replay_bit_identical_with_topology(monkeypatch):
    _device(monkeypatch, False)
    rng = np.random.default_rng(23)
    data = {"k": rng.integers(0, 7, 3000).tolist(),
            "v": rng.integers(0, 100, 3000).tolist()}
    q = _groupby_query(data)
    runs = {}
    for side in ("port", "ref"):
        _set(monkeypatch, side, CHAOS_SERIALIZE="1", FAULT_SPEC="fetch:0.3",
             FAULT_SEED="7", RETRY_BACKOFF="0.01")
        res = MODS[side][1]

        def chaos_run(path, topology):
            res.reset_for_tests()
            out, delta = _run_distributed(side, q, monkeypatch, path=path,
                                          topology=topology)
            events = res.fault_events()
            res.reset_for_tests()
            return _canon(out), events, delta

        base = chaos_run(None, None)
        coll = chaos_run("collective", TOPOLOGY_2MESH)
        assert coll[0] == base[0] and coll[1] == base[1], side
        assert coll[2].get("exchange_path_collective", 0) == 0
        assert coll[2].get("ici_exchanges", 0) == 0
        runs[side] = base
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1] == runs["ref"][1]
    assert runs["port"][1], "no fault fired"


# ---------------------------------------- all-or-nothing group recovery

def test_collective_group_recovery_is_all_or_nothing(monkeypatch):
    _device(monkeypatch, False)
    monkeypatch.setenv("DAFT_TORCH_RETRY_BACKOFF", "0.01")
    rng = np.random.default_rng(31)
    data = {"k": rng.integers(0, 9, 4000).tolist(),
            "v": rng.integers(0, 1000, 4000).tolist()}
    q = _groupby_query(data)
    oracle = _canon(q(daft_tpu_torch))
    rz.reset_for_tests()
    monkeypatch.setenv("DAFT_TORCH_FAULT_SPEC", "crash:1:1")
    monkeypatch.setenv("DAFT_TORCH_FAULT_SEED", "3")
    try:
        out, _ = _run_distributed("port", q, monkeypatch,
                                  path="hierarchical",
                                  topology=TOPOLOGY_2MESH)
        counters = rz.counters_snapshot()
    finally:
        rz.reset_for_tests()
    assert _canon(out) == oracle
    assert counters.get("injected_crash", 0) >= 1, counters
    assert counters.get("collective_group_recoveries", 0) >= 1
    assert tp.collective_inflight() == 0


# ------------------------------------------------- counters surfacing

def test_exchange_counters_surface_in_stats_and_metrics(monkeypatch):
    from daft_tpu_torch import observability as obs
    from daft_tpu_torch import tracing
    from daft_tpu_torch.parallel import exchange
    _device(monkeypatch, True)
    monkeypatch.setenv("DAFT_TORCH_MESH_MIN_ROWS", "0")
    df = daft_tpu_torch.from_pydict({"k": list(range(2048)),
                                     "v": list(range(2048))})
    df.groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s")) \
        .to_pydict()
    stats = obs.last_query_stats()
    assert exchange.exchange_cache_counters()["entries"] >= 1
    assert stats.shuffle.get("ici_exchanges", 0) >= 1, stats.shuffle
    rendered = stats.render()
    assert "shuffle (data plane):" in rendered
    assert "collective exchanges" in rendered
    assert "exchange programs (collective cache):" in rendered
    text = tracing.prometheus_text()
    assert "daft_torch_exchange_programs" in text
    assert "daft_torch_exchange_collective_inflight" in text
    assert "daft_torch_shuffle_ici_exchanges_total" in text
    tracing.parse_prometheus_text(text)
