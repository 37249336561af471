"""The port's session warm-up (``daft_tpu_torch/device/warmup.py``) on CPU
tensors: the kernel grid launches every kernel and strategy once per
capacity class, the fragment grid launches every fused program seen so far
(skipping the dictionary-shaped ones), and ``DAFT_TORCH_AOT_WARMUP`` gates
one session warm-up per process, which a query's ``run_plan`` triggers."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.device import fragment, warmup

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("DAFT_TORCH_AOT_WARMUP", raising=False)
    monkeypatch.setattr(warmup, "_session_done", False)


def test_size_classes_are_the_power_of_two_ladder():
    assert warmup.size_classes(1 << 12, 1 << 10) == [1024, 2048, 4096]
    assert warmup.size_classes(1000, 1000) == []


def test_kernel_grid_launches_each_program_per_class():
    assert warmup.warmup_kernels([128, 256], CPU) == {"programs": 18}


def test_fragment_grid_launches_seen_programs(tmp_path, monkeypatch):
    monkeypatch.setattr(fragment, "_fused_seen", {})
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({"k": rng.integers(0, 5, 500),
                             "v": rng.random(500),
                             "s": rng.choice(["a", "b"], 500)}),
                   str(tmp_path / "p.parquet"))
    df = daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet"))
    df.groupby("k").agg(col("v").sum()).to_pydict()
    df.groupby("s").agg(col("v").sum()).to_pydict()
    progs = fragment.fused_programs()
    assert len(progs) == 2
    # the int64-keyed program: sort and hash at each class; the
    # string-keyed one reads a dictionary column and is skipped
    assert warmup.warmup_fragments([256, 512], CPU) == {"programs": 4,
                                                        "skipped": 1}


def test_session_warmup_is_gated_and_runs_once(monkeypatch):
    calls = []
    monkeypatch.setattr(warmup, "warmup_session",
                        lambda: calls.append(1) or {"seconds": 0.0})
    assert warmup.maybe_warmup_session() is None   # off by default
    monkeypatch.setenv("DAFT_TORCH_AOT_WARMUP", "1")
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    out = df.groupby("k").agg(col("v").sum()).sort("k").to_pydict()
    assert out == {"k": [1, 2], "v": [4.0, 2.0]}
    assert calls == [1]   # run_plan warmed the session
    assert warmup.maybe_warmup_session() is None
    assert calls == [1]


def test_session_warmup_on_cpu_tensors():
    stats = warmup.warmup_session(max_capacity=1 << 11,
                                  min_capacity=1 << 10, fragments=False,
                                  device=CPU)
    assert stats["size_classes"] == [1024, 2048]
    assert stats["kernels"] == {"programs": 18}
    assert "library_s" not in stats   # no CUDA library off the card
