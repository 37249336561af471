"""The port's differential plan fuzzer (``daft_tpu_torch/analysis/
plan_fuzzer.py``) held against the reference's
(``daft_tpu/analysis/plan_fuzzer.py``).

- ``gen_case`` gives the reference's tables and ops for seeds 0-199, and
  ``canonical_rows`` the reference's rows.
- Every mode of the port's fuzzer gives, on :data:`SEEDS` seeds, the
  reference's ``run_reference`` answer (its unoptimized pull interpreter
  on JAX-CPU), on CPU tensors (``DAFT_TORCH_DEVICE=cpu``). 200 seeds keep
  the file near 60 s on one CPU core.
- The counterparts of the reference's fuzzer tests
  (``tests/test_plan_discipline.py:257-285``), the full mode matrix
  included.
- The fuzzer leaves ``os.environ`` and both packages' execution configs
  as it found them, also when a mode raises; ``combined`` runs through
  the distributed runner; ``device`` reaches the device paths and ``bounded``
  spills; the command line prints one line per mode and fails on a
  mismatch.

The 200-seed run against the reference in every mode:
``python -m pytest tests/test_torch_fuzz.py -k every_mode``.
"""

import os

import pytest

from daft_tpu.analysis import plan_fuzzer as ref_fuzzer

#: seeds of the per-mode comparison with the reference
SEEDS = 200


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _fz():
    from daft_tpu_torch.analysis import plan_fuzzer
    return plan_fuzzer


@pytest.mark.parametrize("start", [0, 50, 100, 150])
def test_gen_case_matches_the_reference(start):
    fz = _fz()
    for seed in range(start, start + 50):
        assert fz.gen_case(seed) == ref_fuzzer.gen_case(seed), seed


@pytest.mark.parametrize("data", [
    {"x": [1, None, 2], "y": [3.0, 4.0, None]},
    {"s": ["b", None, "a", "b"], "t": [True, False, None, True]},
    {"f": [float("nan"), -0.0, 0.0, 1e300], "i": [3, 2, 1, 0]},
    {},
])
def test_canonical_rows_match_the_reference(data):
    assert _fz().canonical_rows(data) == ref_fuzzer.canonical_rows(data)


_REF_CACHE = {}


def _reference_rows(seed):
    """The reference's oracle: its raw plan on its pull interpreter."""
    if seed not in _REF_CACHE:
        tables, ops = ref_fuzzer.gen_case(seed)
        _REF_CACHE[seed] = ref_fuzzer.canonical_rows(
            ref_fuzzer.run_reference(ref_fuzzer.build_df(tables, ops)))
    return _REF_CACHE[seed]


def _against_reference(fz, mode, seeds):
    """``[(seed, detail)]`` of every seed whose ``mode`` answer differs
    from the reference's, or raised."""
    bad = []
    for seed in seeds:
        tables, ops = fz.gen_case(seed)
        try:
            got = fz.canonical_rows(fz.run_mode(tables, ops, mode))
        except Exception as e:  # noqa: BLE001 - reported as a difference
            bad.append((seed, f"raised {e!r}"))
            continue
        want = _reference_rows(seed)
        if got != want:
            bad.append((seed, fz._diff_detail(want, got)))
    return bad


@pytest.mark.parametrize("mode", ["optimized", "fused", "spilled",
                                  "replanned", "device", "bounded",
                                  "combined"])
def test_every_mode_gives_the_references_answer(cpu, mode):
    fz = _fz()
    assert mode in fz.MODES
    assert _against_reference(fz, mode, range(SEEDS)) == []


def test_port_oracle_matches_the_reference_oracle(cpu):
    fz = _fz()
    for seed in range(SEEDS):
        tables, ops = fz.gen_case(seed)
        assert fz.canonical_rows(fz.run_reference(
            fz.build_df(tables, ops))) == _reference_rows(seed), seed


# ------------------------------------- the reference's fuzzer tests, ported


def test_fuzzer_is_deterministic():
    fz = _fz()
    t1, o1 = fz.gen_case(11)
    t2, o2 = fz.gen_case(11)
    assert t1 == t2 and o1 == o2
    t3, o3 = fz.gen_case(12)
    assert (t1, o1) != (t3, o3)


def test_fuzzer_canonical_rows_order_insensitive():
    fz = _fz()
    a = fz.canonical_rows({"x": [1, None, 2], "y": [3.0, 4.0, None]})
    b = fz.canonical_rows({"x": [2, 1, None], "y": [None, 3.0, 4.0]})
    assert a == b
    c = fz.canonical_rows({"x": [2, 1, None], "y": [None, 3.5, 4.0]})
    assert a != c


def test_fuzzer_smoke_local_modes(cpu):
    res = _fz().run_fuzz(count=2, seed=101,
                         modes=("optimized", "fused", "spilled"))
    assert res.seeds_run == 2
    assert not res.mismatches, [m.repro() for m in res.mismatches]
    assert not res.errors, res.errors


def test_fuzzer_smoke_full_matrix(cpu):
    fz = _fz()
    res = fz.run_fuzz(count=5, seed=201)
    assert res.seeds_run == 5
    assert set(res.per_mode) == set(fz.MODES)
    assert all(c == {"cases": 5, "mismatches": 0, "errors": 0}
               for c in res.per_mode.values()), res.per_mode
    assert not res.mismatches, [m.repro() for m in res.mismatches]
    assert not res.errors, res.errors


# --------------------------------------------------------- port behavior


def _state():
    import daft_tpu
    import daft_tpu_torch
    return (dict(os.environ),
            daft_tpu.get_context().execution_config,
            daft_tpu_torch.get_context().execution_config)


def test_fuzzer_leaves_no_state_behind(cpu):
    fz = _fz()
    before = _state()
    res = fz.run_fuzz(count=2, seed=7)
    assert res.seeds_run == 2 and not res.mismatches
    assert _state() == before
    for mode in fz.MODES:
        with pytest.raises(RuntimeError):
            with fz._mode_ctx(mode):
                raise RuntimeError(mode)
        assert _state() == before, mode


def test_combined_mode_waits_for_the_distributed_runner(cpu):
    """The distributed runner has landed: ``combined`` is a mode, runs
    through it and puts the process's runner back."""
    import daft_tpu_torch
    fz = _fz()
    assert "combined" in fz.MODES
    before = _state()
    runner_before = daft_tpu_torch.get_context()._runner
    res = fz.run_fuzz(count=3, seed=0, modes=("combined",))
    assert res.per_mode["combined"] == {"cases": 3, "mismatches": 0,
                                        "errors": 0}, res.per_mode
    assert daft_tpu_torch.get_context()._runner is runner_before
    with pytest.raises(ValueError):
        fz.run_fuzz(count=1, seed=0, modes=("nope",))
    assert _state() == before


def test_device_mode_dispatches_and_bounded_mode_spills(cpu):
    from daft_tpu_torch.device import runtime
    from daft_tpu_torch.execution import memory
    fz = _fz()
    runtime.reset_counters()
    for seed in range(12):
        fz.run_mode(*fz.gen_case(seed), "optimized")
    host = runtime.counters()
    runtime.reset_counters()
    for seed in range(12):
        fz.run_mode(*fz.gen_case(seed), "device")
    dev = runtime.counters()
    assert dev.get("join_hash", 0) > 0 and dev.get("agg_hash", 0) > 0, dev
    assert host.get("join_hash", 0) == 0, host
    b0 = memory.spill_counters_snapshot()
    for seed in range(12):
        fz.run_mode(*fz.gen_case(seed), "bounded")
    d = memory.spill_counters_delta(b0)
    assert d.get("partitions_spilled", 0) > 0, d


def test_seed_and_count_knobs(cpu, monkeypatch):
    fz = _fz()
    monkeypatch.delenv("DAFT_TORCH_FUZZ_SEED", raising=False)
    monkeypatch.delenv("DAFT_TORCH_FUZZ_COUNT", raising=False)
    assert (fz.fuzz_seed_base(), fz.fuzz_count()) == (0, 50)
    monkeypatch.setenv("DAFT_TORCH_FUZZ_SEED", "4")
    monkeypatch.setenv("DAFT_TORCH_FUZZ_COUNT", "2")
    assert (fz.fuzz_seed_base(), fz.fuzz_count()) == (4, 2)
    res = fz.run_fuzz(modes=("optimized",))
    assert res.seeds_run == 2 and res.per_mode["optimized"]["cases"] == 2


def test_budget_runs_seeds_past_the_count_while_it_lasts(cpu):
    fz = _fz()
    res = fz.run_fuzz(count=1, seed=0, modes=("optimized",), budget_s=0.0)
    assert res.seeds_run == 1
    res = fz.run_fuzz(count=0, seed=0, modes=("optimized",), budget_s=1.0)
    assert res.seeds_run >= 2, res.summary()
    assert res.per_mode["optimized"]["cases"] == res.seeds_run


def test_command_line_summary_and_exit_code(cpu, capsys, monkeypatch):
    from daft_tpu_torch.analysis.__main__ import main
    fz = _fz()
    assert main(["--fuzz", "--count", "2", "--seed", "3",
                 "--modes", "optimized,device"]) == 0
    out = capsys.readouterr().out
    assert "plan fuzzer mode optimized: 2 seeds, 2 compared, 0 mismatches" \
        in out and "plan fuzzer mode device: 2 seeds" in out
    real = fz.run_mode

    def wrong(tables, ops, mode):
        got = real(tables, ops, mode)
        return {k: v[:-1] for k, v in got.items()} if mode == "device" \
            else got
    monkeypatch.setattr(fz, "run_mode", wrong)
    seed = next(s for s in range(50) if fz.build_df(
        *fz.gen_case(s)).count_rows() > 0)
    assert main(["--fuzz", "--count", "1", "--seed", str(seed),
                 "--modes", "optimized,device"]) == 1
    out = capsys.readouterr().out
    assert "plan fuzzer MISMATCH" in out and f"seed={seed} mode=device" \
        in out and "minimized ops:" in out

