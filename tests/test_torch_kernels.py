"""Parity of the port's torch aggregation programs with the reference's XLA
programs (``daft_tpu/device/kernels.py``), on seeded numpy inputs run
through both packages.

- ``_packed_chunks``: bit for bit, the port's int64-carried words viewed as
  uint64 against the reference's u64 words;
- dense, sort-block and global aggregation: group keys, counts, integer
  aggregates, min/max (NaN and -0.0 included) and any_value exactly, float
  sums and the statistics built on them at relative 1e-9 (f64) / 1e-6
  (f32). Both strategies emit groups in ascending key order, so rows align.

NaN feeds only the count, min/max and any_value columns of the parity
cases: the reference's dense and sort strategies sum through a one-hot
matmul, where one NaN row poisons every group's sum (NaN * 0 is NaN). The
port sums per group, as the reference's hash strategy does, so a NaN
poisons its own group only (``test_nan_sum_stays_in_its_group``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from daft_tpu.device import kernels as ref_k

OPS = ("count", "sum", "mean", "var", "stddev", "min", "max", "any_value",
       "bool_and", "bool_or")
KINDS = ("f64", "f32", "i64", "f64", "f32", "f64", "f32", "i64", "bool",
         "bool")


@pytest.fixture(scope="module")
def port():
    import torch
    from daft_tpu_torch.device import kernels
    return torch, kernels


def _col(rng, kind, C, nan=True):
    # float means sit well away from zero: the float tolerances are
    # relative, and a sum that cancels to near zero has no relative error
    # bound in any summation order
    if kind == "f64":
        v = rng.normal(100.0, 50.0, C)
        if nan:
            v[rng.random(C) < 0.03] = np.nan
            v[rng.random(C) < 0.01] = -np.inf
        v[rng.random(C) < 0.03] = -0.0
        v[rng.random(C) < 0.03] = 0.0
        return v
    if kind == "f32":
        v = rng.normal(10.0, 5.0, C).astype(np.float32)
        if nan:
            v[rng.random(C) < 0.03] = np.nan
        v[rng.random(C) < 0.03] = -0.0
        return v
    if kind == "i64":
        return rng.integers(-2**62, 2**62, C, dtype=np.int64)
    if kind == "i32":
        return rng.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)
    if kind == "i16":
        return rng.integers(-2**15, 2**15, C).astype(np.int16)
    if kind == "i8":
        return rng.integers(-128, 128, C).astype(np.int8)
    if kind == "u8":
        return rng.integers(0, 256, C).astype(np.uint8)
    return rng.random(C) < 0.5


def _to_torch(torch, xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _to_jax(xs):
    return tuple(jnp.asarray(x) for x in xs)


# (key kinds, descending, nulls_first, with_dead)
PACK_CASES = [
    (("i32",), (False,), (False,), True),
    (("i64",), (True,), (True,), True),
    (("f64", "bool"), (False, True), (True, False), False),
    (("f32", "i8", "u8"), (True, False, True), (False, False, True), True),
    (("i16", "f64", "i64"), (False, True, False), (True, True, False), True),
    (("i64", "i64", "f64"), (False, False, False), (False, False, False),
     False),
]


@pytest.mark.parametrize("case", PACK_CASES,
                         ids=["-".join(c[0]) for c in PACK_CASES])
def test_packed_chunks_bit_for_bit(port, case):
    torch, k = port
    kinds, desc, nf, with_dead = case
    rng = np.random.default_rng(PACK_CASES.index(case))
    C = 512
    keys = [_col(rng, kd, C) for kd in kinds]
    valids = [rng.random(C) >= 0.1 for _ in kinds]
    mask = rng.random(C) >= 0.2
    rc = ref_k._packed_chunks(ref_k._sort_codes(
        _to_jax(keys), _to_jax(valids), jnp.asarray(mask), desc, nf,
        with_dead=with_dead))
    pc = k._packed_chunks(k._sort_codes(
        _to_torch(torch, keys), _to_torch(torch, valids),
        torch.from_numpy(mask), desc, nf, with_dead=with_dead))
    assert len(pc) == len(rc)
    for pw, rw in zip(pc, rc):
        assert len(pw) == len(rw)
        for a, b in zip(pw, rw):   # int64-carried words, viewed as u64
            np.testing.assert_array_equal(a.numpy().view(np.uint64),
                                          np.asarray(b))


def test_packed_argsort_matches_reference(port):
    torch, k = port
    rng = np.random.default_rng(11)
    C = 300
    kinds = ("i64", "i64", "f64")   # 3 chunks: the LSD radix path
    keys = [(_col(rng, kd, C) % 7) if kd == "i64" else _col(rng, kd, C)
            for kd in kinds]
    valids = [rng.random(C) >= 0.1 for _ in kinds]
    mask = rng.random(C) >= 0.1
    desc, nf = (False, True, False), (True, False, False)
    rp = ref_k._packed_argsort(ref_k._sort_codes(
        _to_jax(keys), _to_jax(valids), jnp.asarray(mask), desc, nf), C)
    pp = k._packed_argsort(k._sort_codes(
        _to_torch(torch, keys), _to_torch(torch, valids),
        torch.from_numpy(mask), desc, nf), C)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))


#: ops whose inputs may hold NaN in the dense/sort parity cases
_NAN_OK = ("count", "min", "max", "any_value")


def _agg_inputs(seed, C, ops=OPS, kinds=KINDS):
    rng = np.random.default_rng(seed)
    vals = [_col(rng, kd, C, nan=op in _NAN_OK)
            for kd, op in zip(kinds, ops)]
    vvalids = [rng.random(C) >= 0.1 for _ in kinds]
    mask = rng.random(C) >= 0.15
    return vals, vvalids, mask, tuple(ops)


def assert_rows_equal(got, ref, g, ops, vals):
    """Row-aligned comparison of ``g`` live groups."""
    gv, gm = got
    rv, rm = ref
    for i, op in enumerate(ops):
        a, am = np.asarray(gv[i])[:g], np.asarray(gm[i])[:g]
        b, bm = np.asarray(rv[i])[:g], np.asarray(rm[i])[:g]
        np.testing.assert_array_equal(am, bm, err_msg=op)
        a, b = a[bm], b[bm]
        dt = vals[i].dtype
        if op in ("count", "bool_and", "bool_or") or dt.kind in "biu" \
                and op not in ("mean", "var", "stddev"):
            np.testing.assert_array_equal(a, b, err_msg=op)
        elif op in ("min", "max", "any_value"):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), op)
            ok = ~np.isnan(b)
            np.testing.assert_array_equal(a[ok], b[ok], err_msg=op)
            np.testing.assert_array_equal(np.signbit(a[ok]),
                                          np.signbit(b[ok]), err_msg=op)
        else:
            rtol = 1e-6 if dt == np.float32 else 1e-9
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=rtol,
                                       atol=0, equal_nan=True, err_msg=op)


@pytest.mark.parametrize("nkeys", [1, 2])
def test_dense_agg_matches_reference(port, nkeys):
    torch, k = port
    C = 512
    vals, vvalids, mask, ops = _agg_inputs(20 + nkeys, C)
    rng = np.random.default_rng(nkeys)
    dims = (4, 2)[:nkeys]
    keys = [rng.integers(0, d, C).astype(np.int32) for d in (3, 2)[:nkeys]]
    kval = [rng.random(C) >= 0.05 for _ in range(nkeys)]
    out_cap = 128
    r = ref_k.grouped_agg_dense_impl(
        _to_jax(keys), _to_jax(kval), _to_jax(vals), _to_jax(vvalids),
        jnp.asarray(mask), ops, out_cap, dims)
    p = k.grouped_agg_dense_impl(
        _to_torch(torch, keys), _to_torch(torch, kval),
        _to_torch(torch, vals), _to_torch(torch, vvalids),
        torch.from_numpy(mask), ops, out_cap, dims)
    g = int(r[4])
    assert int(p[4]) == g
    for a, b, am, bm in zip(p[0], r[0], p[1], r[1]):
        np.testing.assert_array_equal(am.numpy()[:g], np.asarray(bm)[:g])
        live = np.asarray(bm)[:g]
        np.testing.assert_array_equal(a.numpy()[:g][live],
                                      np.asarray(b)[:g][live])
    assert_rows_equal((p[2], p[3]), (r[2], r[3]), g, ops, vals)


@pytest.mark.parametrize("key_kinds", [("i32",), ("i64", "f64"),
                                       ("f32", "bool", "i8")])
def test_sort_block_agg_matches_reference(port, key_kinds):
    torch, k = port
    C = 512
    vals, vvalids, mask, ops = _agg_inputs(len(key_kinds), C)
    rng = np.random.default_rng(40 + len(key_kinds))
    keys = []
    for kd in key_kinds:
        col = _col(rng, kd, C)
        if kd.startswith("i"):
            col = (col % 9).astype(col.dtype)
        elif kd.startswith("f"):
            col = np.round(col / 20.0).astype(col.dtype)
        keys.append(col)
    kval = [rng.random(C) >= 0.05 for _ in key_kinds]
    out_cap = 512
    r = ref_k.grouped_agg_block_impl(
        _to_jax(keys), _to_jax(kval), _to_jax(vals), _to_jax(vvalids),
        jnp.asarray(mask), ops, out_cap)
    p = k.grouped_agg_block_impl(
        _to_torch(torch, keys), _to_torch(torch, kval),
        _to_torch(torch, vals), _to_torch(torch, vvalids),
        torch.from_numpy(mask), ops, out_cap)
    g = int(r[4])
    assert int(p[4]) == g and g <= out_cap
    for a, b, am, bm in zip(p[0], r[0], p[1], r[1]):
        live = np.asarray(bm)[:g]
        np.testing.assert_array_equal(am.numpy()[:g], live)
        a, b = a.numpy()[:g][live], np.asarray(b)[:g][live]
        np.testing.assert_array_equal(np.isnan(a) if a.dtype.kind == "f"
                                      else a, np.isnan(b)
                                      if b.dtype.kind == "f" else b)
    assert_rows_equal((p[2], p[3]), (r[2], r[3]), g, ops, vals)


def test_sort_block_overflow_signal(port):
    torch, k = port
    C = 512
    vals, vvalids, mask, ops = _agg_inputs(5, C, ("sum",), ("f64",))
    keys = [np.arange(C, dtype=np.int64)]
    kval = [np.ones(C, dtype=np.bool_)]
    r = ref_k.grouped_agg_block_impl(
        _to_jax(keys), _to_jax(kval), _to_jax(vals), _to_jax(vvalids),
        jnp.asarray(mask), ops, 128)
    p = k.grouped_agg_block_impl(
        _to_torch(torch, keys), _to_torch(torch, kval),
        _to_torch(torch, vals), _to_torch(torch, vvalids),
        torch.from_numpy(mask), ops, 128)
    assert int(p[4]) == int(r[4]) == int(mask.sum()) > 128


def test_global_agg_matches_reference(port):
    torch, k = port
    vals, vvalids, mask, ops = _agg_inputs(9, 300)
    r = ref_k.global_agg_impl(_to_jax(vals), _to_jax(vvalids),
                              jnp.asarray(mask), ops)
    p = k.global_agg_impl(_to_torch(torch, vals), _to_torch(torch, vvalids),
                          torch.from_numpy(mask), ops)
    got = ([x[0].reshape(1) for x in p], [x[1].reshape(1) for x in p])
    ref = ([np.asarray(x[0]).reshape(1) for x in r],
           [np.asarray(x[1]).reshape(1) for x in r])
    assert_rows_equal(got, ref, 1, ops, vals)
    # an empty input: counts are 0 and valid, everything else is null
    none = np.zeros_like(mask)
    p = k.global_agg_impl(_to_torch(torch, vals), _to_torch(torch, vvalids),
                          torch.from_numpy(none), ops)
    assert int(p[0][0]) == 0 and bool(p[0][1])
    assert not any(bool(m) for _, m in p[1:])


def test_nan_sum_stays_in_its_group(port):
    """A NaN poisons its own group's sum and mean, no other (per-group
    sums, as the reference's hash strategy computes them)."""
    torch, k = port
    C = 64
    keys = [np.repeat(np.arange(4, dtype=np.int32), 16)]
    kval = [np.ones(C, dtype=np.bool_)]
    v = np.arange(C, dtype=np.float64)
    v[5] = np.nan   # group 0 only
    vals, vvalids = [v, v], [np.ones(C, np.bool_)] * 2
    mask = np.ones(C, dtype=np.bool_)
    ops = ("sum", "mean")
    want = v.reshape(4, 16).sum(axis=1)
    for impl in (k.grouped_agg_block_impl,
                 lambda *a: k.grouped_agg_dense_impl(*a, (4,))):
        p = impl(_to_torch(torch, keys), _to_torch(torch, kval),
                 _to_torch(torch, vals), _to_torch(torch, vvalids),
                 torch.from_numpy(mask), ops, 128)
        np.testing.assert_array_equal(p[2][0].numpy()[:4], want)
        np.testing.assert_array_equal(p[2][1].numpy()[:4], want / 16)
