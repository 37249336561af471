"""The card script's own helpers, on the CPU: the phase helper every
phase of ``chip_smoke.py`` runs through, the ``env`` line and the Connect
transport phase 7n chooses from it. The script itself runs only on a
card; these import it and call the helpers."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_run_phase_names_the_failing_phase_and_reraises(capsys):
    def broken():
        raise ValueError("the sidecar answered 500")

    with pytest.raises(ValueError, match="sidecar answered 500"):
        cs.run_phase("7n", broken, t_start=0.0)
    out, err = capsys.readouterr()
    for stream in (out, err):
        lines = stream.splitlines()
        assert lines[0].startswith("phase 7n FAILED after ")
        assert lines[0].endswith(
            " s: ValueError: the sidecar answered 500")
        assert "Traceback (most recent call last):" in stream
        assert "in broken" in stream
    assert "done" not in out


def test_run_phase_reports_done_and_returns():
    assert cs.run_phase("3-4", lambda: 42, t_start=0.0) == 42


def test_run_phase_done_line(capsys):
    cs.run_phase("7m", lambda: None, t_start=0.0)
    out, err = capsys.readouterr()
    assert out.startswith("phase 7m done at ") and err == ""


def test_env_line_names_every_module():
    env = cs.env_probe()
    assert set(env) == {"python", "torch", "cuda", "pyarrow",
                        "pyarrow.flight", "grpc", "google.protobuf",
                        "pyspark", "PIL", "regex", "cloudpickle"}
    assert env["pyarrow"] and env["torch"]
    for key, mod in cs.ENV_MODULES:
        try:
            __import__(mod)
            assert env[key] is not None, key
        except ImportError:
            assert env[key] is None, key


@pytest.mark.parametrize("env, way", [
    ({"grpc": "1.80.0", "google.protobuf": "6.33.6"}, "grpc"),
    ({"grpc": None, "google.protobuf": "6.33.6"}, "in-process"),
    ({"grpc": "1.80.0", "google.protobuf": None}, None),
    ({"grpc": None, "google.protobuf": None}, None),
])
def test_connect_transport_comes_from_the_env_line(env, way):
    assert cs.connect_transport(env) == way


def test_fleet_sql_reads_the_named_tables():
    sql = cs._sql_tables(cs.fleet_sql("q3"), "/d")
    assert "FROM read_parquet('/d/customer') AS customer" in sql
    assert "JOIN read_parquet('/d/orders') AS orders ON" in sql
    assert "JOIN read_parquet('/d/lineitem') AS lineitem ON" in sql
    for name, param in (("q1", None), ("suppkey_agg", None),
                        ("q6", (1994, 0.06)), ("lookup", 7)):
        sql = cs._sql_tables(cs.fleet_sql(name, param), "/d")
        assert "FROM read_parquet('/d/lineitem') AS lineitem" in sql


def test_profile_classifier_counts_every_call_once(tmp_path):
    """A synthetic profiler trace with one call of each kind: seen by
    name, its launch record outside its range (a stray), its launch
    record dropped (an orphan), its kernel record dropped (lost)."""
    import json

    def rng(ts):
        return dict(cat="user_annotation", name="daft_torch::"
                    "daft_hash_agg_build", tid=1, ts=ts, dur=10, ph="X")

    def launch(ts, corr):
        return dict(cat="cuda_runtime", name="cudaLaunchKernel", tid=1,
                    ts=ts, dur=1, ph="X", args=dict(correlation=corr))

    def kernel(ts, corr):
        return dict(cat="kernel", name="hash_agg_init_kernel", ts=ts,
                    dur=2, ph="X", args=dict(correlation=corr))

    events = [rng(0), launch(2, 1), kernel(5, 1),      # seen by name
              rng(20), launch(31, 2), kernel(33, 2),   # stray
              rng(40), kernel(45, 3),                  # orphan
              rng(60), launch(62, 4)]                  # lost
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    p = cs._profile_kernels(str(path))["hash_agg_build"]
    assert (p["calls"], p["named"], p["orphans"], p["strays"], p["lost"],
            p["empty"]) == (4, 3, 1, 1, 1, 2)
    assert cs._profile_calls(p) == 4
    # the stray's launch moved into its range: no longer empty nor a stray
    events[4] = launch(22, 2)
    path.write_text(json.dumps(dict(traceEvents=events)))
    p = cs._profile_kernels(str(path))["hash_agg_build"]
    assert (p["strays"], p["empty"]) == (0, 1)
    assert cs._profile_calls(p) == 4
    assert cs._profile_kernels(str(path))["hash_join_build"]["calls"] == 0


def test_expr_phase_runs_its_oracles_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """Phase 7o (``benchmarking/expr_phase.phase``) end to end over TPC-H
    at SF 0.01 on CPU tensors, with a recorder that runs each step as the
    card script's does but counts launches from the device tier's
    dispatch counters (the real one times with CUDA events): every
    oracle holds, and the forced way reaches the hash-agg and join
    paths."""
    import time
    import types

    from benchmarking.tpch.datagen import generate_tpch
    from daft_tpu_torch.benchmarking import expr_phase
    from daft_tpu_torch.device import costmodel, runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    root = str(tmp_path / "tpch")
    generate_tpch(root, scale_factor=0.01, num_parts=2, seed=42)

    class Recorder:
        def __init__(self, pass_="default"):
            self.pass_, self.decisions = pass_, {}

        def counted(self, label, fn, clear=True):
            runtime.reset_counters()
            costmodel.reset_decision_counts()
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            self.decisions = costmodel.decision_counts_snapshot()
            c = runtime.counters()
            joins = c.get("join_hash", 0)
            return out, wall, c, {
                "hash_agg_build": c.get("agg_hash", 0) + c.get("hash", 0),
                "hash_join_build": joins, "hash_join_probe": joins}

        def to_host(self, device="cpu"):
            pass

    stub = types.SimpleNamespace(KernelRecorder=Recorder, log=cs.log,
                                 _env=cs._env, _sql_tables=cs._sql_tables)
    out = expr_phase.phase(stub, root, "cpu")
    lines = {(d["step"], d["way"]): d for d in out["lines"]}
    forced = [lines[("groups", "forced")], lines[("pairs", "forced")]]
    assert forced[0]["launches"]["hash_agg_build"] >= 1
    assert forced[1]["launches"]["hash_join_build"] >= 1
    # each step's line carries its own decisions and knobs
    default = lines[("groups", "default")]
    assert default["decisions"] and default["knobs"] == ["DAFT_TORCH_DEVICE"]
    assert "DAFT_TORCH_DEVICE_FORCE" in forced[0]["knobs"]
    assert lines[("explode", "default")]["rows_out"] == \
        expr_phase.BANDS * lines[("explode", "default")]["rows_in"]
    text = capsys.readouterr().out
    assert "expr dedup " in text and "expr native " in text


class _CpuRecorder:
    """Runs each step as the card script's recorder does, but counts
    launches from the device tier's dispatch counters (the real one times
    with CUDA events)."""

    def __init__(self, pass_="default"):
        self.pass_, self.decisions = pass_, {}

    def counted(self, label, fn, clear=True):
        import time

        from daft_tpu_torch.device import costmodel, runtime
        runtime.reset_counters()
        costmodel.reset_decision_counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        self.decisions = costmodel.decision_counts_snapshot()
        c = runtime.counters()
        joins = c.get("join_hash", 0)
        return out, wall, c, {
            "hash_agg_build": c.get("agg_hash", 0) + c.get("hash", 0),
            "hash_join_build": joins, "hash_join_probe": joins}

    def to_host(self, device="cpu"):
        pass


@pytest.fixture(scope="module")
def tpch_001(tmp_path_factory):
    from benchmarking.tpch.datagen import generate_tpch
    root = str(tmp_path_factory.mktemp("cache") / "tpch")
    generate_tpch(root, scale_factor=0.01, num_parts=2, seed=42)
    return root


def _stub():
    import types
    return types.SimpleNamespace(
        KernelRecorder=_CpuRecorder, log=cs.log, _env=cs._env,
        cuda_ms=cs.cuda_ms, HBM_BYTES_PER_S=cs.HBM_BYTES_PER_S,
        check_table=cs.check_table, check_answer=cs.check_answer,
        pyarrow_answers=cs.pyarrow_answers, q3_reference=cs.q3_reference)


def _lines(text: str, prefix: str) -> list:
    import json
    out = []
    for ln in text.splitlines():
        if ln.startswith(prefix + " {"):
            out.append(json.loads(ln[len(prefix) + 1:]))
    return out


def test_multimodal_phase_runs_its_oracles_on_the_cpu(tpch_001, monkeypatch,
                                                      capsys):
    """Phase 7p (``benchmarking/multimodal_phase.phase``) end to end on CPU
    tensors, 64 images of 32x32 and TPC-H at SF 0.01: every oracle holds,
    the token UDF runs in two actors (each with its table on the CPU), the
    forced way reaches the hash-agg and join paths, and every ``mm`` line
    parses."""
    from daft_tpu_torch.benchmarking import multimodal_phase as mm
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(mm, "IMG_N", 64)
    monkeypatch.setattr(mm, "IMG_PX", 32)
    monkeypatch.setattr(mm, "IMG_OUT", 24)
    out = mm.phase(_stub(), tpch_001, "cpu")
    lines = {(d["step"], d["way"]): d for d in out["lines"]}
    for way in ("default", "forced"):
        assert lines[("resize", way)]["device_resizes"] == 1
    embed = lines[("token embed", "default")]
    assert len(embed["actor_pids"]) == 2 and embed["pool_shut_down"]
    assert embed["actor_devices"] == {str(p): ["cpu"]
                                      for p in embed["actor_pids"]}
    assert lines[("token counts", "forced")]["launches"]["hash_agg_build"] >= 1
    assert lines[("token join", "forced")]["launches"]["hash_join_probe"] >= 1
    assert lines[("cluster join", "forced")]["launches"]["hash_join_build"] >= 1
    text = capsys.readouterr().out
    parsed = _lines(text, "mm")
    assert len(parsed) == len(out["lines"])
    for prefix in ("mm resize", "mm vocab", "mm token check", "mm data"):
        assert len(_lines(text, prefix)) == 1, prefix
    assert len(_lines(text, "mm embed check")) == 2


def test_lake_phase_runs_its_oracles_on_the_cpu(tpch_001, monkeypatch,
                                                capsys):
    """Phase 7q (``benchmarking/lake_phase.phase``) end to end on CPU
    tensors at SF 0.01: the four tables written, Q1, ``l_suppkey`` and Q3
    over them held to pyarrow both ways (forced: the hash-agg build and
    the join kernels reached), Unity's Q1, the time travel; every ``lake``
    line parses."""
    from daft_tpu_torch.benchmarking import lake_phase
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    out = lake_phase.phase(_stub(), tpch_001, "cpu")
    text = capsys.readouterr().out
    parsed = _lines(text, "lake")
    assert parsed == out["lines"]
    writes = [d["format"] for d in parsed if d["step"] == "write"]
    assert writes == ["delta", "iceberg", "lance", "hudi"]
    queries = [d for d in parsed if d["step"] == "query"]
    assert len(queries) == 2 * 3 * 2 + 1
    for d in queries:
        if d["way"] == "forced" and d["query"] == "suppkey_agg":
            assert d["launches"]["hash_agg_build"] >= 1
        if d["way"] == "forced" and d["query"] == "q3":
            assert d["launches"]["hash_join_probe"] >= 1
    travel = [d for d in parsed if d["step"] == "time travel"][0]
    assert travel["counts"]["delta"][1] - travel["counts"]["delta"][0] \
        == lake_phase.APPEND_ROWS
