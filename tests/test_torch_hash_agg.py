"""Parity of the port's hash grouped aggregation with the reference.

The port's ``hash_grouped_agg_impl`` runs on CPU tensors, where its table
build is the plain torch twin of the CUDA kernel; the reference runs its
Pallas kernel in interpret mode. Inputs come from a seeded numpy generator.
Group order is unspecified in both, so groups compare as sets keyed by the
key. Keys, counts, integer aggregates, min/max, any_value and the overflow
signal (``group_count``) match exactly; float sums and the statistics built
on them match at relative 1e-9 (f64) and 1e-6 (f32), the reference
tolerance of ``tests/test_tpch.py``.

The CUDA leg (kernel vs plain version on the card) is marked ``cuda`` and
skips on machines without a card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from daft_tpu.device import pallas_kernels as ref_pk

ALL_OPS = ("count", "sum", "mean", "var", "stddev", "min", "max",
           "any_value", "bool_and", "bool_or")
ALL_KINDS = ("f64", "f32", "i64", "f64", "f32", "f64", "f32", "i64",
             "bool", "bool")


@pytest.fixture(scope="module")
def port():
    import torch
    from daft_tpu_torch.device import hash_kernels
    return torch, hash_kernels


def _values(rng, kind, C):
    if kind == "f64":
        v = rng.normal(100.0, 50.0, C)
        v[rng.random(C) < 0.02] = np.nan
        v[rng.random(C) < 0.02] = -0.0
        v[rng.random(C) < 0.02] = 0.0
        return v
    if kind == "f32":
        v = rng.normal(10.0, 5.0, C).astype(np.float32)
        v[rng.random(C) < 0.02] = np.nan
        return v
    if kind == "i64":
        return rng.integers(-10**12, 10**12, C).astype(np.int64)
    if kind == "i32":
        return rng.integers(-1000, 1000, C).astype(np.int32)
    if kind == "i8":
        return rng.integers(-100, 100, C).astype(np.int8)
    return rng.random(C) < 0.5


def _keys(rng, kind, C, ndv):
    if kind == "int64":
        return rng.integers(1, ndv + 1, C).astype(np.int64) * 7919 - 10**12
    if kind == "date":
        return (rng.integers(0, ndv, C) + 8036).astype(np.int32)
    return (rng.integers(0, ndv, C) - ndv // 2).astype(np.int32)


def make_inputs(seed, C, live_n, key_kinds, ndv, ops, val_kinds,
                key_null=0.05, val_null=0.05):
    rng = np.random.default_rng(seed)
    live = np.zeros(C, dtype=np.bool_)
    live[:live_n] = True
    keys = [_keys(rng, k, C, ndv) for k in key_kinds]
    kvalids = [rng.random(C) >= key_null for _ in key_kinds]
    vals = [_values(rng, k, C) for k in val_kinds]
    vvalids = [rng.random(C) >= val_null for _ in val_kinds]
    return keys, kvalids, vals, vvalids, live, tuple(ops)


def run_ref(inp, out_cap, table_cap=None):
    keys, kvalids, vals, vvalids, live, ops = inp
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    out = ref_pk.hash_grouped_agg_impl(
        J(keys), J(kvalids), J(vals), J(vvalids), jnp.asarray(live), ops,
        out_cap, table_cap=table_cap, interpret=True)
    ok, okv, ov, ovv, g = out
    N = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return N(ok), N(okv), N(ov), N(ovv), int(g)


def run_port(port, inp, out_cap, table_cap=None):
    torch, hk = port
    keys, kvalids, vals, vvalids, live, ops = inp
    T = lambda xs: tuple(torch.from_numpy(np.array(x)) for x in xs)  # noqa: E731
    out = hk.hash_grouped_agg_impl(
        T(keys), T(kvalids), T(vals), T(vvalids), torch.from_numpy(live),
        ops, out_cap, table_cap=table_cap)
    ok, okv, ov, ovv, g = out
    N = lambda xs: [x.numpy() for x in xs]  # noqa: E731
    return N(ok), N(okv), N(ov), N(ovv), int(g)


def _groups(res):
    """{(key value or None, ...): row index} over live groups."""
    ok, okv, _, _, g = res
    out = {}
    for i in range(min(g, len(ok[0]))):
        key = tuple(k[i].item() if m[i] else None for k, m in zip(ok, okv))
        assert key not in out, f"duplicate group {key}"
        out[key] = i
    return out


def _same_float(a, b, rel):
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def assert_same_groups(got, ref, ops, vals):
    assert got[4] == ref[4], "group_count"
    gg, gr = _groups(got), _groups(ref)
    assert set(gg) == set(gr)
    for vi, op in enumerate(ops):
        for key, ir in gr.items():
            ig = gg[key]
            vr, mr = ref[2][vi][ir], ref[3][vi][ir]
            vg, mg = got[2][vi][ig], got[3][vi][ig]
            assert bool(mg) == bool(mr), (op, key)
            if not mr:
                continue
            dt = vals[vi].dtype
            if op in ("count", "bool_and", "bool_or") \
                    or (op in ("min", "max", "sum", "any_value")
                        and dt.kind in "biu"):
                assert vg == vr, (op, key, vg, vr)
            elif op in ("min", "max", "any_value"):
                assert (np.isnan(vg) and np.isnan(vr)) or (
                    vg == vr and np.signbit(vg) == np.signbit(vr)), \
                    (op, key, vg, vr)
            else:  # float sums and the statistics built on them
                rel = 1e-6 if dt == np.float32 else 1e-9
                assert _same_float(float(vg), float(vr), rel), \
                    (op, key, vg, vr)


# (name, C, live, key kinds, ndv, ops, value kinds, out_cap, table_cap)
CASES = [
    ("1word_int32_all_ops", 1024, 900, ("int32",), 40, ALL_OPS, ALL_KINDS,
     128, None),
    ("2word_int64_all_ops", 1024, 1000, ("int64",), 60, ALL_OPS, ALL_KINDS,
     128, None),
    ("date_key_sum_mean", 1024, 700, ("date",), 100,
     ("sum", "mean", "count"), ("f64", "f64", "f64"), 128, None),
    ("two_int32_keys_2word", 1024, 1024, ("int32", "int32"), 6,
     ("sum", "max", "min"), ("i64", "f64", "f32"), 128, None),
    ("null_heavy_keys", 1024, 800, ("int32",), 5,
     ("count", "sum", "any_value"), ("f64", "i64", "bool"), 128, None),
    ("narrow_int_values", 1024, 1000, ("int32",), 30,
     ("min", "max", "sum", "any_value"), ("i8", "i8", "i32", "i8"), 128,
     None),
    ("f32_stats", 1024, 1000, ("int64",), 20,
     ("var", "stddev", "mean", "sum"), ("f32", "f32", "f32", "f32"), 128,
     None),
    ("bool_values", 1024, 1000, ("int32",), 25,
     ("bool_and", "bool_or", "count", "any_value", "sum"),
     ("bool", "bool", "bool", "bool", "bool"), 128, None),
    ("overflow_ndv_gt_out_cap", 1024, 1000, ("int64",), 400,
     ("sum", "count"), ("f64", "i64"), 128, 1024),
    ("table_full", 1024, 1000, ("int32",), 600, ("sum", "max"),
     ("f64", "f32"), 128, 256),
    ("all_dead_rows", 1024, 0, ("int32",), 10, ("sum", "count"),
     ("f64", "i64"), 128, None),
    ("wide_table_2048_rows", 2048, 1900, ("int64",), 120,
     ("sum", "min", "max", "any_value", "stddev"),
     ("f64", "f64", "f64", "f64", "f64"), 256, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_hash_grouped_agg_matches_reference(port, case):
    name, C, live_n, kk, ndv, ops, vk, out_cap, table_cap = case
    inp = make_inputs(CASES.index(case), C, live_n, kk, ndv, ops, vk)
    ref = run_ref(inp, out_cap, table_cap)
    got = run_port(port, inp, out_cap, table_cap)
    if ref[4] > out_cap:
        # overflow: the caller re-dispatches, so the signal is the contract
        assert got[4] == ref[4]
        if table_cap is not None and ndv > table_cap:
            assert got[4] == table_cap   # a full table claims every slot
        return
    assert_same_groups(got, ref, ops, inp[2])


def test_hash_key_width_error_for_three_int64_keys(port):
    torch, hk = port
    inp = make_inputs(7, 64, 64, ("int64", "int64", "int64"), 4, ("sum",),
                      ("f64",))
    with pytest.raises(ref_pk.HashKeyWidthError):
        run_ref(inp, 128)
    with pytest.raises(hk.HashKeyWidthError):
        run_port(port, inp, 128)
    assert hk.hash_pack_words([torch.int64] * 3) is None
    assert hk.hash_pack_words([torch.int64]) == 2
    assert hk.hash_pack_words([torch.int32]) == 1


def test_agg_state_specs_mirror_reference(port):
    torch, hk = port
    ops = ALL_OPS
    tdts = [torch.float64, torch.float32, torch.int64, torch.float64,
            torch.float32, torch.float64, torch.float32, torch.int64,
            torch.bool, torch.bool]
    jdts = [jnp.float64, jnp.float32, jnp.int64, jnp.float64, jnp.float32,
            jnp.float64, jnp.float32, jnp.int64, jnp.bool_, jnp.bool_]
    got = [(vi, op, kind, str(dt).replace("torch.", ""))
           for vi, op, kind, dt in hk.agg_state_specs(ops, tdts)]
    ref = [(vi, op, kind, str(jnp.dtype(dt)))
           for vi, op, kind, dt in ref_pk.agg_state_specs(ops, jdts)]
    assert got == ref
    assert [hk.table_capacity(c) for c in (1, 64, 128, 1000, 1 << 19)] == \
        [ref_pk.table_capacity(c) for c in (1, 64, 128, 1000, 1 << 19)]


@pytest.mark.cuda
def test_hash_agg_build_cuda_matches_plain():
    """The CUDA kernel against its plain version on the card (the same
    check chip_smoke.py runs at full size)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from daft_tpu_torch.device import hash_kernels as hk
    rng = np.random.default_rng(3)
    for kk, ndv in (("int32", 300), ("int64", 900)):
        case = chip_smoke.make_case(rng, 1 << 14, 12000, kk, ndv, ALL_OPS,
                                    ALL_KINDS)
        words, live, vals, contribs, specs = chip_smoke.case_tensors(
            case, "cuda")
        got = hk.hash_agg_build_cuda(words, live, vals, contribs, specs, 4096)
        ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs,
                                      4096)
        chip_smoke.compare_builds(got, ref, specs, words, live, vals,
                                  contribs, 4096)
