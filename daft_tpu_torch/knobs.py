"""The port's environment knobs, all under the ``DAFT_TORCH_`` prefix.

Read at call time (never cached at import), so a test can set one with
``monkeypatch.setenv``.
"""

from __future__ import annotations

import os

#: name → (default, help)
REGISTRY = {
    "DAFT_TORCH_DEVICE": (
        "cuda", "`cuda` (default), `cpu`, or `0` for the host tier only; "
        "an explicit `ExecutionConfig.device` wins"),
    "DAFT_TORCH_KERNEL_GROUPBY": (
        "auto", "grouped-agg strategy: `auto` (dense, else hash, else "
        "sort), or force `dense`/`hash`/`sort`"),
    "DAFT_TORCH_KERNEL_HASH_LOAD": (
        0.5, "max hash-table load factor: the table holds `out_cap / load` "
        "slots (clamped to [0.05, 0.95])"),
    "DAFT_TORCH_KERNEL_MAX_TABLE": (
        1 << 20, "hash-table slot ceiling; larger group budgets take sort"),
    "DAFT_TORCH_KERNEL_HASH_MAX_BITS": (
        128, "widest packed key set (bits, ≤128) the hash kernel accepts"),
    "DAFT_TORCH_KERNEL_JOIN": (
        "auto", "device equi-join strategy: `auto` (= `hash`), or force "
        "`hash` (build/probe kernels) / `sort` (torch sort join)"),
}


def env_str(name: str) -> str:
    v = os.environ.get(name)
    return str(REGISTRY[name][0]) if v is None or v == "" else v.strip()


def env_int(name: str) -> int:
    return int(env_str(name))


def env_float(name: str) -> float:
    return float(env_str(name))
