"""The port's sort-merge join (``strategy="sort_merge"``,
``LocalExecutor._sort_merge_join``): both sides range-bucketed on one
shared sampled boundary set, then joined bucket pair by bucket pair.

The parity subset of ``tests/test_sort_merge_join.py``, on the same
numpy-seeded inputs: the port's sort-merge answer equals its hash join's,
``daft_tpu``'s sort-merge answer, and the same join under a ``400KB``
budget, each compared as a row multiset (integers, exact).
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution import memory as ref_memory
from daft_tpu_torch.execution import memory

HOWS = ["inner", "left", "right", "outer", "semi", "anti"]


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_SPILL_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DAFT_TPU_SPILL_DIR", str(tmp_path / "ref"))
    for v in ("DAFT_TPU_MEMORY_LIMIT", "DAFT_TORCH_MEMORY_LIMIT"):
        monkeypatch.delenv(v, raising=False)
    memory._spill_dir = ref_memory._spill_dir = None
    yield
    memory._spill_dir = ref_memory._spill_dir = None


def _sides(pkg):
    rng = np.random.default_rng(7)
    lk = rng.integers(0, 500, 4000)
    rk = rng.integers(0, 500, 1500)
    left = pkg.from_pydict({"k": lk.tolist(), "lv": np.arange(4000).tolist()}
                           ).into_partitions(5)
    right = pkg.from_pydict({"k": rk.tolist(),
                             "rv": np.arange(1500).tolist()}
                            ).into_partitions(3)
    return left, right


def _canon(d):
    cols = list(d)
    return sorted(zip(*[d[c] for c in cols]),
                  key=lambda r: tuple((v is None, v) for v in r))


def _join(pkg, how, strategy):
    left, right = _sides(pkg)
    return _canon(left.join(right, on="k", how=how,
                            strategy=strategy).to_pydict())


@pytest.mark.parametrize("how", HOWS)
def test_matches_hash_join_and_the_reference(how):
    got = _join(daft_tpu_torch, how, "sort_merge")
    assert got == _join(daft_tpu_torch, how, "hash")
    assert got == _join(daft_tpu, how, "sort_merge")


def test_spilled_sort_merge_join(monkeypatch):
    """Under 400KB both sides spill while sampled; the answer is the
    unbounded one and the reference's under the same budget."""
    want = _join(daft_tpu_torch, "inner", "sort_merge")
    for pre in ("DAFT_TPU_", "DAFT_TORCH_"):
        monkeypatch.setenv(pre + "MEMORY_LIMIT", "20KB")
    b0 = memory.spill_counters_snapshot()
    got = _join(daft_tpu_torch, "inner", "sort_merge")
    assert memory.spill_counters_delta(b0).get("bytes_written", 0) > 0
    assert got == want == _join(daft_tpu, "inner", "sort_merge")


def test_output_is_range_clustered():
    left, right = _sides(daft_tpu_torch)
    df = left.join(right, on="k", strategy="sort_merge")
    parts = [p.to_pydict() for p in df.iter_partitions()]
    assert len(parts) > 1
    ranges = [(min(p["k"]), max(p["k"])) for p in parts if p["k"]]
    for (lo1, hi1), (lo2, hi2) in zip(ranges, ranges[1:]):
        assert hi1 <= lo2


def test_plan_has_no_hash_exchanges():
    from daft_tpu_torch.physical import plan as pp, translate as pt
    left, right = _sides(daft_tpu_torch)
    df = left.join(right, on="k", strategy="sort_merge")
    phys = pt.translate(df.builder.optimize().plan)

    def exchanges(n):
        out = [n.kind] if isinstance(n, pp.Exchange) else []
        for c in n.children:
            out.extend(exchanges(c))
        return out
    joins = []

    def walk(n):
        if isinstance(n, pp.HashJoin):
            joins.append(n.strategy)
        for c in n.children:
            walk(c)
    walk(phys)
    assert "hash" not in exchanges(phys) and joins == ["sort_merge"]


def test_empty_side():
    left, _ = _sides(daft_tpu_torch)
    empty = daft_tpu_torch.from_pydict({"k": [], "rv": []})
    out = left.join(empty, on="k", strategy="sort_merge").to_pydict()
    assert out["k"] == []
