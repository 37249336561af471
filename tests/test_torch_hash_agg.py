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


def one_column_inputs(seed, C, live_n, key_kinds, ndv, ops, cols,
                      col_kinds):
    """Inputs where op i reads column ``cols[i]``: aggs over one column
    get the same value and validity arrays, as the compiler hands them."""
    keys, kvalids, vals, vvalids, live, ops = make_inputs(
        seed, C, live_n, key_kinds, ndv, ops, col_kinds)
    return keys, kvalids, [vals[c] for c in cols], [vvalids[c] for c in cols], \
        live, ops


def _tensors(torch, xs, made):
    """One torch tensor per distinct array, so arrays shared between aggs
    stay shared."""
    for x in xs:
        if id(x) not in made:
            made[id(x)] = torch.from_numpy(np.array(x))
    return tuple(made[id(x)] for x in xs)


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
    made = {}
    T = lambda xs: _tensors(torch, xs, made)  # noqa: E731
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


# (name, key kinds, ndv, ops, column per op, column kinds, out_cap,
#  table_cap): aggs that share planes (one count per column; `mean` and
#  `stddev` share `sum`'s plane)
SHARED_CASES = [
    ("sum_mean_stddev_count_one_f64_column", ("int32",), 40,
     ("sum", "mean", "stddev", "count", "count", "any_value"),
     (0, 0, 0, 0, 1, 1), ("f64", "i64"), 128, None),
    ("sum_mean_stddev_count_one_f32_column", ("int64",), 60,
     ("sum", "mean", "stddev", "count", "count", "any_value"),
     (0, 0, 0, 0, 1, 1), ("f32", "bool"), 128, None),
    ("shared_planes_table_full", ("int32",), 600,
     ("sum", "mean", "count", "any_value"), (0, 0, 0, 1), ("f64", "f64"),
     128, 256),
]


@pytest.mark.parametrize("case", SHARED_CASES,
                         ids=[c[0] for c in SHARED_CASES])
def test_hash_grouped_agg_shared_planes_match_reference(port, case):
    name, kk, ndv, ops, cols, ck, out_cap, table_cap = case
    inp = one_column_inputs(100 + SHARED_CASES.index(case), 1024, 950, kk,
                            ndv, ops, cols, ck)
    ref = run_ref(inp, out_cap, table_cap)
    got = run_port(port, inp, out_cap, table_cap)
    if ref[4] > out_cap:
        assert got[4] == ref[4] == table_cap
        return
    assert_same_groups(got, ref, ops, inp[2])


def test_plane_aliases_share_and_restore_order(port):
    """Specs over one column share its count and sum planes; `first` and
    counts depend only on the contrib mask; the build hands the planes
    back one per spec, in the order of ``agg_state_specs``, equal to the
    build of every spec on its own."""
    torch, hk = port
    rng = np.random.default_rng(11)
    C = 512
    x = torch.from_numpy(rng.normal(size=C))
    y = torch.from_numpy(rng.normal(size=C))
    cx = torch.from_numpy(rng.random(C) > 0.1)
    cy = torch.from_numpy(rng.random(C) > 0.1)
    ops = ("sum", "mean", "stddev", "count", "min", "any_value")
    vals = [x, x, x, y, x, y]
    contribs = [cx, cx, cx, cy, cx, cy]
    specs = hk.agg_state_specs(ops, [v.dtype for v in vals])
    assert [(vi, k) for vi, _, k, _ in specs] == [
        (0, "cnt"), (0, "sum"), (1, "cnt"), (1, "sum"), (2, "cnt"),
        (2, "sum"), (2, "sumsq"), (3, "cnt"), (4, "cnt"), (4, "min"),
        (5, "cnt"), (5, "first")]
    distinct, alias = hk.plane_aliases(specs, vals, contribs)
    assert distinct == [0, 1, 6, 7, 9, 11]
    assert alias == [0, 1, 0, 1, 0, 1, 2, 3, 0, 4, 3, 5]
    # another tensor with the same values is another input
    x2 = x.clone()
    d2, _ = hk.plane_aliases(specs, [x, x2, x, y, x, y], contribs)
    assert d2 == [0, 1, 3, 6, 7, 9, 11]
    words = [torch.from_numpy(rng.integers(0, 20, C).astype(np.int64))]
    live = torch.from_numpy(rng.random(C) > 0.05)
    got = hk.hash_agg_build(words, live, vals, contribs, specs, 128)
    ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs, 128)
    assert len(got[3]) == len(specs)
    for a, b in zip(got[3], ref[3]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    for a, b in zip(got[:3], ref[:3]):
        assert all(torch.equal(u, v) for u, v in zip(a, b)) \
            if isinstance(a, list) else torch.equal(a, b)
    assert int(got[4]) == int(ref[4])


def test_shared_table_rule(port):
    """The build's path rule at the main path's four rung shapes and at
    both of its boundaries, for a given device (an H100: 132 SMs, 232,448
    B a block may take, 233,472 B an SM, 1,024 B reserved per block)."""
    torch, hk = port
    i32, f64, i64 = torch.int32, torch.float64, torch.int64
    h100 = hk.Device(132, 232_448, 233_472, 1024)
    C = 1 << 20
    rule = lambda T, w, dts, c=C, dev=h100: hk.uses_shared_table(  # noqa: E731
        T, w, dts, c, dev)
    # l_suppkey: 2-word keys, 4 counts, 5 f64 planes, one first (10)
    supp = [i32] * 4 + [f64] * 5 + [i64]
    # l_shipdate: 1-word keys, 4 counts, 3 f64 planes (7)
    ship = [i32] * 4 + [f64] * 3
    assert rule(256, 2, supp)
    assert not rule(32768, 2, supp)
    assert rule(256, 1, ship)
    assert not rule(8192, 1, ship)
    # shared memory: 1-word keys at T = 2048 hold 56 B a slot with a count
    # and four 8-byte planes (114,688 B: two blocks to an SM), 64 B with
    # one more (131,072 B: one block)
    four = [i32, f64, f64, f64, i64]
    big = 1 << 21
    assert hk.table_layout(2048, 1, four).local_bytes == 114_688
    assert rule(2048, 1, four, c=big)
    assert not rule(2048, 1, four + [f64], c=big)
    assert not rule(2048, 1, four, c=big,
                    dev=h100._replace(smem_sm=2 * (114_688 + 1024 + 64) - 1))
    # rows: at least 4 per slot on each SM
    assert not rule(2048, 1, four, c=4 * 2048 * 132 - 1)
    assert rule(2048, 1, four, c=4 * 2048 * 132)
    assert not rule(2048, 1, four)   # 2^20 rows are too few for T = 2048
    assert rule(1024, 1, ship)
    # planes of one dtype sit side by side, each group 16-byte aligned;
    # `occ` and the count follow the shared prefix
    L = hk.table_layout(256, 2, [torch.int8, i32, f64, i32, torch.int8])
    assert [(dt, n) for dt, _, n in L.groups] == [
        (i64, 3), (f64, 1), (i32, 3), (torch.int8, 2)]
    assert all(off % 16 == 0 for _, off, _ in L.groups)
    assert L.planes == (L.groups[3][1], L.groups[2][1] + 1024,
                        L.groups[1][1], L.groups[2][1] + 2048,
                        L.groups[3][1] + 256)
    assert L.tk == (0, 2048) and L.frow == 4096 and L.state == L.groups[2][1]
    assert max(L.planes) < L.local_bytes == L.occ < L.count
    assert L.nbytes == L.count + 16


def test_workspace_views_read_the_layout(port):
    """The kernel's result views: each plane, key word, `occ`, `frow` and
    the count read the bytes the layout gives them (written here from
    numpy, as the kernel writes them on the card)."""
    torch, hk = port
    T = 128
    dts = [torch.int32, torch.float64, torch.int8, torch.int64,
           torch.float32, torch.int32]
    L = hk.table_layout(T, 2, dts)
    buf = np.zeros(L.nbytes, dtype=np.uint8)
    want = {}
    for i, (off, dt) in enumerate(zip(L.planes, dts)):
        npdt = hk._NP[dt]
        v = (np.arange(T) * (i + 3) % 100).astype(npdt)
        buf[off:off + T * v.itemsize] = v.view(np.uint8)
        want[i] = v
    for i, off in enumerate(L.tk):
        buf[off:off + 8 * T] = (np.arange(T, dtype=np.int64) - 7 * i) \
            .view(np.uint8)
    buf[L.frow:L.frow + 8 * T] = np.full(T, 99, np.int64).view(np.uint8)
    buf[L.occ:L.occ + T] = np.arange(T) % 3 == 0
    buf[L.count:L.count + 8] = np.array([41], np.int64).view(np.uint8)
    tk, occ, frow, planes, count = hk.workspace_views(
        torch.from_numpy(buf), L, T, 2, len(dts))
    for i, p in enumerate(planes):
        assert p.dtype == dts[i] and np.array_equal(p.numpy(), want[i])
    assert [t.tolist()[:2] for t in tk] == [[0, 1], [-7, -6]]
    assert frow.dtype == torch.int64 and bool((frow == 99).all())
    assert occ.dtype == torch.bool and occ.tolist() == [
        j % 3 == 0 for j in range(T)]
    assert count.dim() == 0 and int(count) == 41


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
    check chip_smoke.py runs at full size), over both paths of the build
    and both sides of its rows-per-slot rule."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from daft_tpu_torch.device import hash_kernels as hk
    rng = np.random.default_rng(3)
    # (rows, key kind, ndv, ops, value kinds, T, sorted keys, path): random
    # keys in a global and a shared-memory table, 4 groups in both, sorted
    # keys, a shared table that fills, and T = 256 on each side of the
    # rows-per-slot rule (4 x 256 x 132 SMs = 135,168 rows)
    cases = [
        (1 << 14, "int32", 300, ALL_OPS, ALL_KINDS, 4096, False, "global"),
        (1 << 14, "int64", 900, ALL_OPS, ALL_KINDS, 4096, False, "global"),
        (1 << 18, "int32", 100, ALL_OPS, ALL_KINDS, 256, False, "shared"),
        (1 << 18, "int32", 4, ALL_OPS, ALL_KINDS, 128, False, "shared"),
        (1 << 18, "int64", 4, ALL_OPS, ALL_KINDS, 1 << 16, False, "global"),
        (1 << 18, "int32", 300, ALL_OPS, ALL_KINDS, 8192, True, "global"),
        (1 << 18, "int32", 3000, ALL_OPS, ALL_KINDS, 256, False, "shared"),
        (1 << 17, "int32", 150, ALL_OPS, ALL_KINDS, 256, False, "global"),
    ]
    for rows, kk, ndv, ops, kinds, T, srt, path in cases:
        case = chip_smoke.make_case(rng, rows, rows * 3 // 4, kk, ndv, ops,
                                    kinds, sorted_keys=srt)
        words, live, vals, contribs, specs = chip_smoke.case_tensors(
            case, "cuda")
        assert chip_smoke.build_path(words, vals, contribs, specs,
                                     T) == path
        got = hk.hash_agg_build(words, live, vals, contribs, specs, T)
        torch.cuda.synchronize()
        ref = hk.hash_agg_build_plain(words, live, vals, contribs, specs, T)
        chip_smoke.compare_builds(got, ref, specs, words, live, vals,
                                  contribs, T)
