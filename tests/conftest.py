"""Test harness configuration.

Mirrors the reference's runner-matrix trick (``tests/conftest.py:32-38`` there:
one behavioral corpus, N backends): here the matrix axis is the device tier —
the full suite runs against a virtual 8-device CPU mesh
(``xla_force_host_platform_device_count``) so multi-chip sharding logic is
exercised without TPU hardware, and ``DAFT_TPU_DEVICE=0`` in the environment
reruns everything on the pure host tier.

``DAFT_TPU_REAL_DEVICE=1`` flips the suite onto the REAL accelerator
backend instead (no CPU forcing, no virtual mesh): an opt-in pass that
catches TPU-only numerics (f32 accumulation, int64 emulation) the CPU
backend hides. Budget warning: first compiles of each shape are remote
(10–160 s; amortized across processes by the persistent XLA compilation
cache, ``daft_tpu/device/backend.py``) — the standard opt-in set
(round 5: widened with the distributed runner, shuffle service, and
image/function kernels; 122 passed / 13 mesh-skips warm) is::

    DAFT_TPU_REAL_DEVICE=1 pytest tests/test_tpch.py \
        tests/test_exchange.py tests/test_device_join.py \
        tests/test_bigint_device.py tests/test_window_device.py \
        tests/test_datatypes.py tests/test_distributed.py \
        tests/test_shuffle_service.py tests/test_functions.py
"""

import os

# must run before any jax backend initializes. NOTE: this machine's site
# customization re-registers a TPU plugin and overrides the JAX_PLATFORMS env
# var, so we force the platform through jax.config instead.
_REAL = os.environ.get("DAFT_TPU_REAL_DEVICE") == "1"
if not _REAL:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = \
            flags + " --xla_force_host_platform_device_count=8"

import jax

if not _REAL:
    jax.config.update("jax_platforms", "cpu")

import gc

import numpy as np
import pyarrow as pa
import pytest

# The full suite accumulates several GB of long-lived engine state
# (compile caches, result caches, answer tables) — with the default
# gen2 threshold (10) CPython walks that entire live set every ~70k
# allocations, which makes the tail of a 1200-test serial run ~2x
# slower than the same tests in isolation. Suppress full collections
# for the run (gen0/gen1 still reclaim short-lived cycles; long-lived
# garbage just stays resident, which a test box can afford) and move
# the import-time baseline to the permanent generation so even
# explicit gc.collect() calls in tests don't re-walk it.
gc.set_threshold(700, 10, 100_000)
gc.freeze()

# importing daft_tpu ALSO arms the runtime lock-order sanitizer when
# DAFT_TPU_SANITIZE=1 (daft_tpu/__init__.py patches the lock factories
# before any engine module creates its module-level locks)
import daft_tpu
from daft_tpu import DataType, col
from daft_tpu.analysis import lock_sanitizer as _lock_sanitizer
from daft_tpu.analysis import plan_sanitizer as _plan_sanitizer
from daft_tpu.analysis import retrace_sanitizer as _retrace_sanitizer


@pytest.fixture(params=[False, True], ids=["host", "device"])
def device_tier(request, monkeypatch):
    """Parametrize a test over host-only and device execution tiers."""
    if request.param:
        monkeypatch.setenv("DAFT_TPU_DEVICE", "1")
    else:
        monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
    return request.param


def make_df(data):
    return daft_tpu.from_pydict(data)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: excluded from the tier-1 `-m 'not slow'` run")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where none is present")


def pytest_collection_modifyitems(config, items):
    """Under the DAFT_TPU_REAL_DEVICE=1 opt-in pass, tests that require a
    multi-device mesh skip on single-chip boxes instead of failing."""
    if not _REAL:
        return
    if jax.device_count() >= 2:
        return
    skip = pytest.mark.skip(
        reason="real-device pass on a single chip: no multi-device mesh")
    for item in items:
        if "exchange" in item.nodeid or "multichip" in item.nodeid:
            item.add_marker(skip)


def pytest_sessionfinish(session, exitstatus):
    """DAFT_TPU_SANITIZE=1: print the lock-order sanitizer report at
    session end and FAIL the session on any acquisition-order cycle (a
    potential deadlock two threads haven't hit yet).  With
    DAFT_TPU_SANITIZE_RETRACE also armed, print the retrace-sanitizer
    report and FAIL on any retrace-budget violation (a dispatch site
    that traced twice for one declared signature — the recompile tax)."""
    if _plan_sanitizer.is_enabled():
        print("\n" + _plan_sanitizer.report())
        if _plan_sanitizer.summary().get("violations"):
            print("daft-lint plan sanitizer: plan-contract violations "
                  "detected — failing the session")
            session.exitstatus = 1
    if _retrace_sanitizer.is_enabled():
        print("\n" + _retrace_sanitizer.report())
        if _retrace_sanitizer.summary().get("violations"):
            print("daft-lint retrace sanitizer: retrace-budget "
                  "violations detected — failing the session")
            session.exitstatus = 1
    if not _lock_sanitizer.is_enabled():
        return
    print("\n" + _lock_sanitizer.report())
    if _lock_sanitizer.summary()["cycles"]:
        print("daft-lint lock sanitizer: acquisition-order cycles "
              "detected — failing the session")
        session.exitstatus = 1
