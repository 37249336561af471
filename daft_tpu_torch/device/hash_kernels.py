"""One-pass hash grouped aggregation: the CUDA table build, its plain
torch twin, and the torch compaction/finalize post-pass.

The torch rewrite of ``daft_tpu/device/pallas_kernels.py``'s grouped-agg
half: ``agg_state_specs``, ``table_capacity``, ``hash_pack_words``,
``HashKeyWidthError`` and ``hash_grouped_agg_impl``. The table build
(``_agg_build_call`` there, a Pallas kernel) is ``csrc/hash_agg.cu`` here,
launched by :func:`hash_agg_build` on a CUDA tensor; on a CPU tensor the
wrapper runs :func:`hash_agg_build_plain`, the same function written with
``torch.unique`` and scatters.

Build contract (kernel and plain alike), over C rows and T slots:

- ``tk``: the key word(s) of each occupied slot, int64-carried u64;
- ``occ``: bool, the slot holds a group; ``frow``: the group's earliest
  live row (C where empty);
- one plane per spec of :func:`agg_state_specs`, except that ``first``
  holds the earliest contributing row (C where none), gathered into values
  by the post-pass;
- ``group_count``: the claim count, ``min(ndv, T)``. A row that finds the
  table full is dropped, so a full table reads T > out_cap and forces the
  caller's re-dispatch. A full table's planes are partial (the kernel
  stops aggregating once the last slot is claimed): only its count is
  part of the contract.

Slot order differs between the two (hash slots vs first-row order), and
grouped-aggregate output order is unspecified engine-wide, so results are
compared as sets keyed by the key.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import knobs
from . import kernels

#: CUDA kernel launches since the last :func:`reset_launches` — counted
#: where the wrapper launches the kernel and nowhere else
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


class HashKeyWidthError(ValueError):
    """The key set packs wider than the hash-table key budget; the
    dispatch site routes this program to the sort path. Raised before any
    launch."""


# ------------------------------------------------------------ configuration

def max_table_slots() -> int:
    return knobs.env_int("DAFT_TORCH_KERNEL_MAX_TABLE")


def hash_load_factor() -> float:
    """Clamped strictly below 1.0: the overflow contract needs the table
    to hold more slots than the group budget."""
    return min(max(knobs.env_float("DAFT_TORCH_KERNEL_HASH_LOAD"), 0.05),
               0.95)


def hash_pack_words(dtypes: Sequence[torch.dtype]) -> Optional[int]:
    """u64 words one table key occupies for these key dtypes (per-key
    null-rank bit + value bits), or None when the pack exceeds the
    hash-key budget and the caller must take the sort path."""
    bits = sum(1 + kernels._key_bits(dt) for dt in dtypes)
    limit = min(knobs.env_int("DAFT_TORCH_KERNEL_HASH_MAX_BITS"), 128)
    if bits > limit:
        return None
    return 1 if bits <= 64 else 2


def table_capacity(out_cap: int) -> int:
    """Table slots for a group budget of ``out_cap`` (power of two, at
    least 128)."""
    want = int(np.ceil(out_cap / hash_load_factor()))
    t = 128
    while t < want:
        t <<= 1
    return t


# --------------------------------------------------------- agg state planes

def agg_state_specs(ops: Tuple[str, ...], val_dtypes: Sequence[torch.dtype]
                    ) -> List[Tuple[int, str, str, torch.dtype]]:
    """Table state planes for one agg list: ``(val_index, op, kind,
    dtype)``, ``kind`` ∈ {cnt, sum, sumsq, min, max, first}. Accumulator
    dtypes mirror the reference exactly (int/bool sums in int64, float
    sums in the value's own width; bool min/max in int8)."""
    specs = []
    for i, (op, dt) in enumerate(zip(ops, val_dtypes)):
        acc = dt if dt.is_floating_point else torch.int64
        narrow = torch.int8 if dt == torch.bool else dt
        specs.append((i, op, "cnt", torch.int32))
        if op in ("sum", "mean", "var", "stddev"):
            specs.append((i, op, "sum", acc))
        if op in ("var", "stddev"):
            specs.append((i, op, "sumsq", torch.float32
                          if dt == torch.float32 else torch.float64))
        if op in ("min", "bool_and"):
            specs.append((i, op, "min", narrow))
        if op in ("max", "bool_or"):
            specs.append((i, op, "max", narrow))
        if op == "any_value":
            specs.append((i, op, "first", narrow))
    return specs


def _identity(kind: str, dtype: torch.dtype):
    if kind in ("min", "max"):
        return kernels._identity_for(dtype, kind)
    return 0


# ------------------------------------------------------------ plain version

def hash_agg_build_plain(words: Sequence[torch.Tensor], live: torch.Tensor,
                         vals, contribs, specs, T: int):
    """The table build in plain torch (the CPU leg, and the yardstick the
    kernel is held against on the card): groups take slots in first-row
    order; past T distinct keys the later groups are dropped."""
    C = live.shape[0]
    dev = live.device
    rows = torch.nonzero(live).flatten()
    if len(words) == 1:
        uniq, inv = torch.unique(words[0][rows], return_inverse=True)
    else:
        uniq, inv = torch.unique(torch.stack([w[rows] for w in words], 1),
                                 dim=0, return_inverse=True)
    ndv = uniq.shape[0]
    first = torch.full((ndv,), C, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, inv, rows, "amin")
    rank = torch.empty_like(first)
    rank[torch.argsort(first)] = torch.arange(ndv, device=dev)
    slot = rank[inv]                 # per live row: its group's slot
    kept = slot < T
    rows, slot = rows[kept], slot[kept]
    g = min(ndv, T)

    tk = []
    for w in words:
        t = torch.zeros(T, dtype=torch.int64, device=dev)
        t[slot] = w[rows]
        tk.append(t)
    occ = torch.zeros(T, dtype=torch.bool, device=dev)
    occ[slot] = True
    frow = torch.full((T,), C, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, slot, rows, "amin")
    planes = []
    for vi, op, kind, dt in specs:
        m = contribs[vi][rows]
        r, s = rows[m], slot[m]
        v = vals[vi][r]
        if kind == "cnt":
            p = torch.zeros(T, dtype=dt, device=dev).index_add_(
                0, s, torch.ones_like(s, dtype=dt))
        elif kind in ("sum", "sumsq"):
            x = v.to(dt)
            p = torch.zeros(T, dtype=dt, device=dev).index_add_(
                0, s, x * x if kind == "sumsq" else x)
        elif kind in ("min", "max"):
            p = kernels._seg_minmax(v.to(dt), torch.ones_like(s, dtype=torch.bool),
                                    s, T, kind)
        else:  # first: earliest contributing row
            p = torch.full((T,), C, dtype=torch.int64, device=dev) \
                .scatter_reduce(0, s, r, "amin")
        planes.append(p)
    return tk, occ, frow, planes, torch.tensor(g, device=dev)


# ------------------------------------------------------------- CUDA kernel

_U8, _I8, _I16 = torch.uint8, torch.int8, torch.int16
_I32, _I64, _F32, _F64 = torch.int32, torch.int64, torch.float32, \
    torch.float64
#: the build kernel's typed plane groups, in the order of ``Combos`` in
#: ``csrc/hash_agg.cu``: (kind, value dtype). cnt and first read no value;
#: sum and sumsq read bool as uint8; min/max of bool keep an int8 plane.
_COMBOS = ([("cnt", None), ("first", None)]
           + [(k, v) for k in ("sum", "sumsq")
              for v in (_U8, _I8, _I16, _I32, _I64, _F32, _F64)]
           + [(k, v) for k in ("min", "max")
              for v in (torch.bool, _U8, _I8, _I16, _I32, _I64, _F32,
                        _F64)])
_COMBO_ID = {c: i for i, c in enumerate(_COMBOS)}
_VALUE_DTYPES = (torch.bool, _U8, _I8, _I16, _I32, _I64, _F32, _F64)
_MAX_PLANES = 48
_NP = {torch.bool: np.uint8, _U8: np.uint8, _I8: np.int8, _I16: np.int16,
       _I32: np.int32, _I64: np.int64, _F32: np.float32, _F64: np.float64}


def _combo(kind: str, vdtype: torch.dtype) -> int:
    if kind in ("cnt", "first"):
        return _COMBO_ID[(kind, None)]
    if kind in ("sum", "sumsq") and vdtype == torch.bool:
        vdtype = _U8
    if (kind, vdtype) not in _COMBO_ID:
        raise ValueError(f"hash_agg_build: no {kind} plane over {vdtype}")
    return _COMBO_ID[(kind, vdtype)]


def _plane_dtype(kind: str, dt: torch.dtype) -> torch.dtype:
    """The plane the build writes: the spec's dtype, except that `first`
    holds int64 row ids."""
    return _I64 if kind == "first" else dt


class TableLayout(NamedTuple):
    """Byte offsets of one build's planes in its workspace. Planes of one
    dtype sit side by side in one group (each group 16-byte aligned), so a
    group is one ``[n, T]`` view; ``rows`` gives each plane's (dtype, row)
    there. The prefix ``[0, local_bytes)`` (key words, first row, claim
    state, agg planes) is what a block's shared-memory table mirrors;
    ``occ``, the int64 claim count and an int flag of the build follow
    it."""
    tk: Tuple[int, ...]
    frow: int
    state: int
    planes: Tuple[int, ...]
    local_bytes: int
    occ: int
    count: int
    nbytes: int
    groups: Tuple[Tuple[torch.dtype, int, int], ...]   # (dtype, offset, n)
    rows: dict


_GROUP_ORDER = (_I64, _F64, _F32, _I32, _I16, _U8, _I8)


def table_layout(T: int, n_words: int, plane_dtypes) -> TableLayout:
    members = {dt: [] for dt in _GROUP_ORDER}
    members[_I64] += [("tk", i) for i in range(n_words)] + [("frow", 0)]
    members[_I32].append(("state", 0))
    for i, dt in enumerate(plane_dtypes):
        members[dt].append(("plane", i))
    off, at, rows, groups = 0, {}, {}, []
    for dt in _GROUP_ORDER:
        if not members[dt]:
            continue
        groups.append((dt, off, len(members[dt])))
        for r, key in enumerate(members[dt]):
            at[key] = off + r * T * dt.itemsize
            rows[key] = (dt, r)
        off += -(-len(members[dt]) * T * dt.itemsize // 16) * 16
    local = occ = off
    count = occ + -(-T // 16) * 16
    return TableLayout(
        tuple(at[("tk", i)] for i in range(n_words)), at[("frow", 0)],
        at[("state", 0)], tuple(at[("plane", i)]
                                for i in range(len(plane_dtypes))),
        local, occ, count, count + 16, tuple(groups), rows)


class Device(NamedTuple):
    """What the build's rules read of the card."""
    sms: int
    smem_block_optin: int     # dynamic shared memory a block may take
    smem_sm: int              # shared memory of one SM
    smem_reserved: int        # reserved by the system per block


#: rows per SM, per table slot, from which a block's table pays for itself
SHARED_ROWS_PER_SLOT = 4
#: the build kernel's static shared memory, bytes (rounded up)
_STATIC_SMEM = 64


def uses_shared_table(T: int, n_words: int, plane_dtypes, C: int,
                      dev: Device) -> bool:
    """The build's path rule: pre-aggregate in a block-local table in
    shared memory when the table's record (key words, first row, claim
    state, the distinct planes) times T fits half of an SM's shared memory,
    so that two blocks of 16 warps share each SM, and each SM has at least
    ``SHARED_ROWS_PER_SLOT`` rows per slot, so that a block's flush (at
    most T slots) stays well under its rows' updates; else every row goes
    to the global table, with warp aggregation alone. Measured on the H100
    (`PERF.md`): a table filling a whole SM (one block) ran 0.83 ms
    where the global path ran 0.53 ms, and with few rows per slot every
    block flushed most of its table onto a full global table (7.4 ms for
    10,000 keys at T = 4,096 over 2^20 rows)."""
    local = table_layout(T, n_words, plane_dtypes).local_bytes
    per_block = local + dev.smem_reserved + _STATIC_SMEM
    return local <= dev.smem_block_optin and 2 * per_block <= dev.smem_sm \
        and C >= SHARED_ROWS_PER_SLOT * T * dev.sms


def _bits(value, dt: torch.dtype) -> int:
    """``value`` in ``dt`` as the signed 64-bit integer of its bits."""
    b = int(np.array(value, dtype=_NP[dt]).view(
        f"u{dt.itemsize}").astype(np.uint64))
    return b - (1 << 64) if b >= 1 << 63 else b


class _Plan(NamedTuple):
    meta: np.ndarray              # int64, csrc/hash_agg.cu's `meta`
    layout: TableLayout
    dtypes: Tuple[torch.dtype, ...]


@functools.lru_cache(maxsize=256)
def _plan(C: int, T: int, n_words: int, specs, vdtypes,
          device: Device) -> _Plan:
    """Everything of one launch that depends only on the shapes, the spec
    list and the value dtypes: the layout, the path, and the host
    descriptor ``meta`` — ``[C, T, n_words, shared, n_planes, n_fills, tk0,
    tk1, frow, state, occ, count, local_bytes]``, then ``(combo, offset)``
    per plane, then ``(offset, element bytes, elements, fill bits)`` per
    fill. Raises on a plane the kernel has no combo for."""
    for vi, _, _, _ in specs:
        if vdtypes[vi] not in _VALUE_DTYPES:
            raise ValueError(f"hash_agg_build: value {vi} of {vdtypes[vi]}")
    combos = [_combo(kind, vdtypes[vi]) for vi, _, kind, _ in specs]
    dtypes = tuple(_plane_dtype(kind, dt) for _, _, kind, dt in specs)
    L = table_layout(T, n_words, dtypes)
    shared = uses_shared_table(T, n_words, dtypes, C, device)
    fills = [(o, 8, T, 0) for o in L.tk] + [(L.frow, 8, T, C),
                                            (L.state, 4, T, 0)]
    planes = []
    for (_, _, kind, _), combo, pdt, off in zip(specs, combos, dtypes,
                                                L.planes):
        planes += [combo, off]
        ident = C if kind == "first" else _identity(kind, pdt)
        fills.append((off, pdt.itemsize, T, _bits(ident, pdt)))
    fills += [(L.occ, 1, T, 0), (L.count, 8, 2, 0)]
    meta = [C, T, n_words, int(shared), len(specs), len(fills),
            L.tk[0], L.tk[-1], L.frow, L.state, L.occ, L.count,
            L.local_bytes] + planes + [x for f in fills for x in f]
    return _Plan(np.array(meta, dtype=np.int64), L, dtypes)


@functools.lru_cache(maxsize=8)
def device_info(device_index: int) -> Device:
    """The card's SM count and shared-memory sizes."""
    from . import cuda_build
    info = np.zeros(4, dtype=np.int32)
    with torch.cuda.device(device_index):
        cuda_build.check(cuda_build.library().daft_device_info(
            info.ctypes.data), "daft_device_info")
    return Device(*(int(x) for x in info))


def _check(t: torch.Tensor, name: str, C: int, dtypes) -> None:
    if not t.is_cuda or t.dtype not in dtypes or t.dim() != 1 \
            or t.shape[0] != C or not t.is_contiguous():
        raise ValueError(f"hash_agg_build: {name} must be a contiguous "
                         f"[{C}] CUDA tensor of {dtypes}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def hash_agg_build_cuda(words: Sequence[torch.Tensor], live: torch.Tensor,
                        vals, contribs, specs, T: int):
    """Launch ``csrc/hash_agg.cu`` on the current stream: two kernels,
    the workspace's init and the build, into one ``torch.empty``
    workspace whose views are the result. Raises on any input the kernels
    do not take, and on a refused launch."""
    global launches
    from . import cuda_build
    C = live.shape[0]
    dev = live.device
    n_words = len(words)
    if n_words not in (1, 2):
        raise ValueError("hash_agg_build: 1 or 2 key words")
    if T < 1 or T & (T - 1) or T > 1 << 30 or C >= 2 ** 31:
        raise ValueError(f"hash_agg_build: T={T} must be a power of two "
                         f"up to 2^30 and C={C} < 2^31")
    if len(specs) > _MAX_PLANES:
        raise ValueError(f"hash_agg_build: at most {_MAX_PLANES} planes")
    for i, w in enumerate(words):
        _check(w, f"word {i}", C, (_I64,))
    _check(live, "live", C, (torch.bool,))
    used = {s[0] for s in specs}
    for vi in used:
        _check(vals[vi], f"value {vi}", C, _VALUE_DTYPES)
        _check(contribs[vi], f"contrib {vi}", C, (torch.bool,))
    lib = cuda_build.library()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = _plan(C, T, n_words, tuple(specs), tuple(v.dtype for v in vals),
                 device_info(idx))
    ws = torch.empty(plan.layout.nbytes, dtype=torch.uint8, device=dev)
    ptrs = [words[0].data_ptr(), words[-1].data_ptr(), live.data_ptr(),
            ws.data_ptr()]
    vp = {vi: (vals[vi].data_ptr(), contribs[vi].data_ptr()) for vi in used}
    for s in specs:
        ptrs += vp[s[0]]
    ptrs = np.array(ptrs, dtype=np.uint64)
    cuda_build.check(cuda_build.launch(
        lib.daft_hash_agg_build, dev, plan.meta.ctypes.data,
        ptrs.ctypes.data), "hash_agg_build")
    launches += 1
    return workspace_views(ws, plan.layout, T, n_words, len(specs))


def workspace_views(ws: torch.Tensor, L: TableLayout, T: int, n_words: int,
                    n_planes: int):
    """The build's result as views of its uint8 workspace: ``(tk, occ,
    frow, planes, group_count)``. One ``[n, T]`` view per dtype group,
    unbound into its planes: few torch calls, since each costs the host
    about as much as the build's device work at a small rung."""
    rows = {}
    for dt, off, n in L.groups:
        typed = ws.view(dt)
        rows[dt] = torch.as_strided(typed, (n, T), (T, 1),
                                    off // dt.itemsize).unbind(0)
        if dt == _I64:
            count = torch.as_strided(typed, (), (), L.count // 8)
    at = lambda key: rows[L.rows[key][0]][L.rows[key][1]]  # noqa: E731
    return ([at(("tk", i)) for i in range(n_words)],
            ws[L.occ:L.occ + T].view(torch.bool), at(("frow", 0)),
            [at(("plane", i)) for i in range(n_planes)], count)


def plane_aliases(specs, vals, contribs) -> Tuple[List[int], List[int]]:
    """Specs that compute the same plane, mapped onto one: the indices of
    the distinct specs, and per spec the position of its plane among
    them. A count or `first` plane depends only on the contrib mask; the
    others on the kind, dtype, value tensor and contrib mask. Tensors are
    the same input when they are the same object: the compiler hands the
    same tensors to every agg over one column, so `mean` and `stddev` of a
    column share their sum and every agg over it its count."""
    seen: dict = {}
    distinct: List[int] = []
    alias: List[int] = []
    for i, (vi, _, kind, dt) in enumerate(specs):
        key = (kind, id(contribs[vi])) if kind in ("cnt", "first") \
            else (kind, dt, id(vals[vi]), id(contribs[vi]))
        if key not in seen:
            seen[key] = len(distinct)
            distinct.append(i)
        alias.append(seen[key])
    return distinct, alias


def hash_agg_build(words, live, vals, contribs, specs, T: int):
    """The table build: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors, over the distinct planes of ``specs``
    (:func:`plane_aliases`); the planes come back one per spec, in the
    order of ``specs``. No fallback: a CUDA tensor launches the kernel or
    raises."""
    distinct, alias = plane_aliases(specs, vals, contribs)
    uniq = [specs[i] for i in distinct]
    if live.device.type == "cuda":
        out = hash_agg_build_cuda(words, live, vals, contribs, uniq, T)
    elif live.device.type == "cpu":
        out = hash_agg_build_plain(words, live, vals, contribs, uniq, T)
    else:
        raise ValueError(f"hash_agg_build: unsupported device {live.device}")
    tk, occ, frow, planes, group_count = out
    return tk, occ, frow, [planes[a] for a in alias], group_count


# ------------------------------------------------------------ full strategy

def key_words(keys, key_valids, row_mask) -> List[torch.Tensor]:
    """The packed u64 key words (int64-carried) of the hash strategy:
    per key a null-rank bit and the value code, no dead bit (liveness is
    the separate mask). Raises HashKeyWidthError past 128 bits."""
    codes = kernels._sort_codes(keys, key_valids, row_mask,
                                (False,) * len(keys), (False,) * len(keys),
                                with_dead=False)
    chunks = kernels._packed_chunks(codes)
    if len(chunks) != 1:
        raise HashKeyWidthError(
            "hash grouped-agg requires ≤128-bit packed keys (caller must "
            "route wide key sets to the sort path)")
    return list(chunks[0])


def hash_grouped_agg_impl(keys, key_valids, vals, val_valids, row_mask,
                          ops: Tuple[str, ...], out_cap: int,
                          table_cap: Optional[int] = None):
    """One-pass hash grouped aggregation over padded device columns — the
    drop-in twin of :func:`kernels.grouped_agg_block_impl`: same
    ``([out_cap] keys/valids/vals/valids, group_count)`` contract and
    overflow discipline (``group_count > out_cap`` → re-dispatch). Groups
    come back in table-slot order."""
    C = row_mask.shape[0]
    dev = row_mask.device
    words = key_words(keys, key_valids, row_mask)
    T = table_cap if table_cap is not None else table_capacity(out_cap)
    specs = agg_state_specs(ops, [v.dtype for v in vals])
    masked: dict = {}   # one contrib mask per distinct validity tensor
    for vv in val_valids:
        if id(vv) not in masked:
            masked[id(vv)] = vv & row_mask
    contribs = [masked[id(vv)] for vv in val_valids]
    _, occ, frow, planes, group_count = hash_agg_build(
        words, row_mask, list(vals), contribs, specs, T)

    # compact occupied slots to the front (stable: slot order survives)
    order = torch.sort((~occ).to(torch.int8), stable=True).indices
    sel = order[:out_cap] if out_cap <= T else torch.cat(
        [order, torch.zeros(out_cap - T, dtype=order.dtype, device=dev)])
    j = torch.arange(out_cap, device=dev)
    live_group = j < torch.clamp(group_count, max=out_cap)

    first_row = torch.clamp(frow[sel], 0, C - 1)
    out_keys = tuple(k[first_row] for k in keys)
    out_kvalids = tuple((kv & row_mask)[first_row] & live_group
                        for kv in key_valids)
    by_val: dict = {}
    for (vi, op, kind, dt), p in zip(specs, planes):
        by_val.setdefault(vi, {})[kind] = p[sel]
    out_vals, out_valids = [], []
    for vi, (v, op) in enumerate(zip(vals, ops)):
        st = by_val[vi]
        cnt = st["cnt"]
        has = live_group & (cnt > 0)
        if op == "count":
            out_vals.append(cnt.to(torch.int64))
            out_valids.append(live_group)
            continue
        red = first = None
        if op in ("min", "bool_and", "max", "bool_or"):
            red = st["min" if op in ("min", "bool_and") else "max"]
        elif op == "any_value":
            first = v[torch.clamp(st["first"], 0, C - 1)]
        val, valid = kernels._finalize(v, op, cnt, has, st.get("sum"),
                                       st.get("sumsq"), red, first)
        out_vals.append(val)
        out_valids.append(valid)
    return out_keys, out_kvalids, tuple(out_vals), tuple(out_valids), \
        group_count
