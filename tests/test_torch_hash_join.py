"""Parity of the port's hash-join build/probe and torch sort join with the
reference.

The port's ``join_kernels.hash_join_impl`` runs on CPU tensors, where the
build and probe are the plain torch twins of the CUDA kernels; the
reference runs its Pallas kernels in interpret mode (``block=32``, as
``tests/test_device_kernels.py`` does). The port's torch sort join
(``kernels.join_fused_impl``) is held against the reference's XLA one.
Inputs come from a seeded numpy generator. Everything compares exactly:
the per-left-row counts ``[:C_l]`` and the pairs ``[:min(total, cap)]``
in order (left-major, right rows ascending). When ``cap < total`` the
counts keep the true total and only the pairs below ``cap`` exist.

The CUDA leg (kernels vs plain versions on the card) is marked ``cuda``
and skips on machines without a card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from daft_tpu.device import kernels as ref_k
from daft_tpu.device import pallas_kernels as ref_pk

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


@pytest.fixture(scope="module")
def port():
    import torch
    from daft_tpu_torch.device import join_kernels, kernels
    return torch, join_kernels, kernels


def _case(seed, C_l, C_r, n_l, n_r, keys, null_l=0.1, null_r=0.1):
    """Seeded (l_key, l_valid, l_mask, r_key, r_valid, r_mask) numpy
    planes; ``keys`` draws a key column of the given length."""
    rng = np.random.default_rng(seed)
    return (keys(rng, C_l), rng.random(C_l) >= null_l, np.arange(C_l) < n_l,
            keys(rng, C_r), rng.random(C_r) >= null_r, np.arange(C_r) < n_r)


def _small(kmax):
    return lambda rng, n: rng.integers(0, kmax, n).astype(np.int64)


def _extreme(rng, n):
    """Keys at the int64 edges: INT64_MIN is the table's free-slot marker,
    so it must still join as an ordinary key."""
    pool = np.array([I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX],
                    dtype=np.int64)
    return pool[rng.integers(0, len(pool), n)]


#: name → (seed, C_l, C_r, n_l, n_r, key generator, null_l, null_r, cap)
CASES = {
    "duplicate_heavy": (0, 64, 128, 60, 120, _small(3), 0.1, 0.1, 8192),
    "null_keys_left": (1, 64, 64, 64, 64, _small(8), 0.6, 0.0, 2048),
    "null_keys_right": (2, 64, 64, 64, 64, _small(8), 0.0, 0.6, 2048),
    "left_wider": (3, 128, 32, 100, 32, _small(16), 0.1, 0.1, 1024),
    "right_wider": (4, 32, 256, 32, 200, _small(16), 0.1, 0.1, 1024),
    "empty_left": (5, 32, 64, 0, 64, _small(4), 0.1, 0.1, 256),
    "empty_right": (6, 64, 32, 64, 0, _small(4), 0.1, 0.1, 256),
    "overflow_cap_lt_total": (7, 64, 64, 64, 64, _small(2), 0.1, 0.1, 100),
    "foreign_key": (8, 128, 64, 128, 64, _small(192), 0.05, 0.0, 128),
    "int64_edge_keys": (9, 64, 64, 64, 64, _extreme, 0.1, 0.1, 2048),
}


def _ref_hash(planes, cap):
    return np.asarray(ref_pk.hash_join_impl(
        *[jnp.asarray(p) for p in planes], cap, interpret=True, block=32))


def _ref_sort(planes, cap):
    return np.asarray(ref_k.join_fused_impl(
        *[jnp.asarray(p) for p in planes], cap))


def _assert_same(got, ref, C_l, cap):
    assert got.shape == ref.shape and got.dtype == np.int32
    counts = ref[2, :C_l]
    np.testing.assert_array_equal(got[2, :C_l], counts)
    n = min(int(counts.sum()), cap)
    np.testing.assert_array_equal(got[:2, :n], ref[:2, :n])


@pytest.mark.parametrize("name", sorted(CASES))
def test_hash_join_impl_matches_reference(port, name):
    torch, jk, _ = port
    seed, C_l, C_r, n_l, n_r, keys, nl, nr, cap = CASES[name]
    planes = _case(seed, C_l, C_r, n_l, n_r, keys, nl, nr)
    ref = _ref_hash(planes, cap)
    got = jk.hash_join_impl(*[torch.from_numpy(p) for p in planes],
                            out_capacity=cap).numpy()
    _assert_same(got, ref, C_l, cap)
    total = int(ref[2, :C_l].sum())
    if name == "overflow_cap_lt_total":
        assert total > cap
    if name.startswith("empty"):
        assert total == 0
    if name in ("duplicate_heavy", "int64_edge_keys"):
        assert total > max(C_l, C_r)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sort_join_matches_reference_and_hash(port, name):
    torch, _, tk = port
    seed, C_l, C_r, n_l, n_r, keys, nl, nr, cap = CASES[name]
    planes = _case(seed, C_l, C_r, n_l, n_r, keys, nl, nr)
    ref = _ref_sort(planes, cap)
    got = tk.join_fused_impl(*[torch.from_numpy(p) for p in planes],
                             out_capacity=cap).numpy()
    _assert_same(got, ref, C_l, cap)


def test_join_table_capacity_matches_reference(port):
    _, jk, _ = port
    for c in (16, 64, 128, 1 << 17, 1 << 22):
        assert jk.join_table_capacity(c) == ref_pk.join_table_capacity(c)


def _groups(table, code, live):
    """key → the rows of its slot, from a build result; and the same map
    computed directly from the inputs."""
    off = table.off.numpy().astype(np.int64)
    rows = table.rows.numpy()
    tk = table.tk.numpy()
    got = {}
    for j in np.flatnonzero(off[1:] > off[:-1]):
        got[int(tk[j])] = rows[off[j]:off[j + 1]].tolist()
    want = {}
    for r in np.flatnonzero(live):
        want.setdefault(int(code[r]), []).append(int(r))
    return got, want


@pytest.mark.parametrize("name", ["duplicate_heavy", "int64_edge_keys",
                                  "foreign_key", "empty_right"])
def test_plain_build_keeps_the_contract(port, name):
    """Each distinct live key holds exactly its live rows, ascending; the
    rows past the live count read -1; n_keys counts the distinct keys."""
    torch, jk, _ = port
    seed, C_l, C_r, n_l, n_r, keys, nl, nr, cap = CASES[name]
    planes = _case(seed, C_l, C_r, n_l, n_r, keys, nl, nr)
    code, live = planes[3], planes[4] & planes[5]
    T = jk.join_table_capacity(C_r)
    table = jk.hash_join_build_plain(torch.from_numpy(code),
                                     torch.from_numpy(live), T)
    got, want = _groups(table, code, live)
    assert got == want
    n_live = int(live.sum())
    assert (table.rows[n_live:] == -1).all()
    assert int(table.n_keys) == len(want) and int(table.unplaced) == 0
    assert table.tk.shape == (T + 1,) and table.off.shape == (T + 2,)


def test_plain_probe_reads_any_slot_layout(port):
    """The plain probe finds keys by value, so it gives the same result on
    a table whose slots were moved around (as the kernel's hash layout
    moves them): it can check the kernel's probe on the kernel's table."""
    torch, jk, _ = port
    seed, C_l, C_r, n_l, n_r, keys, nl, nr, cap = CASES["duplicate_heavy"]
    planes = [torch.from_numpy(p) for p in
              _case(seed, C_l, C_r, n_l, n_r, keys, nl, nr)]
    T = jk.join_table_capacity(C_r)
    table = jk.hash_join_build_plain(planes[3], planes[4] & planes[5], T)
    # move every slot j < T to slot perm[j], keeping slot T
    perm = torch.from_numpy(np.random.default_rng(0).permutation(T))
    off = table.off.to(torch.int64)
    cnt = torch.zeros(T + 1, dtype=torch.int64)
    cnt[:T][perm] = (off[1:] - off[:-1])[:T]
    cnt[T] = off[T + 1] - off[T]
    tk = torch.full((T + 1,), jk.EMPTY, dtype=torch.int64)
    tk[:T][perm] = table.tk[:T]
    new_off = torch.zeros(T + 2, dtype=torch.int64)
    new_off[1:] = torch.cumsum(cnt, 0)
    rows = table.rows.clone()
    src = torch.cat([perm, torch.tensor([T])])
    for j in range(T + 1):
        n = int(off[j + 1] - off[j])
        if n:
            d = int(src[j])
            rows[new_off[d]:new_off[d] + n] = table.rows[off[j]:off[j] + n]
    moved = jk.JoinTable(tk, new_off.to(torch.int32), rows, table.n_keys,
                         table.unplaced, T)
    l_live = planes[1] & planes[2]
    a = jk.hash_join_probe_plain(planes[0], l_live, table, cap)
    b = jk.hash_join_probe_plain(planes[0], l_live, moved, cap)
    assert torch.equal(a, b)


def test_cuda_wrappers_refuse_what_they_do_not_take(port):
    """The kernel wrappers take CUDA tensors only, and the dispatchers
    take CUDA or CPU tensors: nothing else falls through to a plain run."""
    torch, jk, _ = port
    code = torch.zeros(16, dtype=torch.int64)
    live = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        jk.hash_join_build_cuda(code, live, 128)
    with pytest.raises(ValueError, match="power of two"):
        jk.hash_join_build_cuda(code, live, 100)
    with pytest.raises(ValueError, match="exceed"):
        jk.hash_join_build_cuda(code, live, 16)
    meta = code.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        jk.hash_join_build(meta, live.to("meta"), 128)
    table = jk.hash_join_build(code, live, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        jk.hash_join_probe(meta, live.to("meta"), table, 64)
    assert jk.launches == {"hash_join_build": 0, "hash_join_probe": 0}


@pytest.mark.cuda
def test_hash_join_cuda_matches_plain():
    """The CUDA kernels against their plain versions on the card, over the
    cases above at a larger width (the check chip_smoke.py runs at full
    size)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    rng = np.random.default_rng(5)
    for case in chip_smoke.join_cases(rng, 1 << 14, 12000, 1 << 12):
        chip_smoke.check_join_case(case)


# ------------------------------------------------------- wrapper-side layout

LAYOUT_SIZES = [(0, 128), (16, 128), (1000, 2048), (12_345, 32_768),
                (1 << 20, 1 << 21), (1 << 22, 1 << 23)]


def _planes_fit(lay, sizes):
    """Every plane 256-byte aligned, in order, inside the workspace and
    not overlapping the next."""
    names = list(lay.offsets)
    assert names == list(sizes)
    for a, b in zip(names, names[1:] + [None]):
        start = lay.offsets[a]
        end = lay.offsets[b] if b else lay.nbytes
        assert start % 256 == 0 and start + sizes[a] <= end


@pytest.mark.parametrize("C,T", LAYOUT_SIZES)
def test_build_layout_planes(port, C, T):
    """The build workspace holds the contract's planes and the kernels'
    own, aligned and apart; the entry's int64 array lists their offsets,
    the scan's tiles and the chunk list's capacity, which the kernel
    checks against its own tile size."""
    _, jk, _ = port
    lay = jk.build_layout(C, T)
    tiles = -(-(T + 1) // 4096)
    items = C // 33 + C // 4096 + 2
    _planes_fit(lay, {"tk": 8 * (T + 1), "off": 4 * (T + 2), "rows": 4 * C,
                      "cnt": 4 * (T + 1), "slot_of": 4 * C,
                      "shorts": 4 * (C // 2 + 1), "items": 8 * items,
                      "status": 8 * tiles, "info": 32})
    assert lay.meta.dtype == np.int64
    assert list(lay.meta[:9]) == list(lay.offsets.values())
    assert list(lay.meta[9:]) == [tiles, items]
    assert jk.build_layout(C, T) is lay  # cached: no host work per call


def _listed(segments):
    """What the scatter lists for segments of these lengths, each split
    over several warp groups: (short entries, chunk items)."""
    shorts = sum(1 for n in segments if 2 <= n <= 32)
    items = sum(-(-n // 4096) for n in segments if n > 32)
    return shorts, items


@pytest.mark.parametrize("C", [64, 4096, 100_000, 1 << 22])
def test_build_layout_lists_hold_any_split(port, C):
    """The short and chunk lists fit the worst splits of C rows: all
    segments of 2 rows, of 33 rows, of 4097 rows, and one of C rows."""
    _, jk, _ = port
    lay = jk.build_layout(C, jk.join_table_capacity(C))
    cap_short = C // 2 + 1
    cap_items = int(lay.meta[10])
    for n in (2, 33, 4097, C):
        shorts, items = _listed([n] * (C // n))
        assert shorts <= cap_short and items <= cap_items


@pytest.mark.parametrize("C,W", [(0, 0), (1, 1024), (300, 1024),
                                 (1 << 18, 1 << 22), (5000, 5000)])
def test_probe_layout_planes(port, C, W):
    """The probe buffer starts with the packed [3, W] matrix (row 2 the
    counts), then the scan's planes; the entry's array lists W, the
    counts' offset, the planes and one look-back tile per 256 rows."""
    _, jk, _ = port
    lay = jk.probe_layout(C, W)
    tiles = -(-C // 256)
    _planes_fit(lay, {"packed": 12 * W, "incl": 8 * C, "pslot": 4 * C,
                      "status": 8 * tiles, "tiles": 4})
    assert lay.offsets["packed"] == 0 and lay.nbytes % 8 == 0
    assert list(lay.meta) == [W, 8 * W, lay.offsets["incl"],
                              lay.offsets["pslot"], lay.offsets["status"],
                              lay.offsets["tiles"], tiles]


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_table_serves_several_probes(port, name):
    """A table built once (``hash_join_table``) and probed at two output
    capacities gives the reference's matrix at each: what the overflow
    re-dispatch of ``joins._device_match_indices`` relies on."""
    torch, jk, _ = port
    seed, C_l, C_r, n_l, n_r, keys, nl, nr, cap = CASES[name]
    planes = _case(seed, C_l, C_r, n_l, n_r, keys, nl, nr)
    t = [torch.from_numpy(p) for p in planes]
    table = jk.hash_join_table(*t[3:])
    for c in (cap, 4 * cap):
        got = jk.hash_join_probe_table(*t[:3], table, c).numpy()
        _assert_same(got, _ref_hash(planes, c), C_l, c)


# ------------------------------------------------------- the card's new cases

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_key_all_rows", "clustered_runs",
                                  "all_distinct"])
def test_hash_join_cuda_skewed_case(name):
    """The skewed build cases of chip_smoke.py at a small size (one key's
    segment still spans four sort chunks), kernels against the plain
    versions on the card."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    cases = chip_smoke.join_cases_skewed(np.random.default_rng(6), 1 << 16,
                                         50_000)
    chip_smoke.check_join_case(next(c for c in cases if c["name"] == name))
