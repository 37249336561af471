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

from typing import List, Optional, Sequence, Tuple

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

_VTYPE = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
          torch.int32: 3, torch.int64: 4, torch.float32: 5,
          torch.float64: 6}
_KIND = {"cnt": 0, "sum": 1, "sumsq": 2, "min": 3, "max": 4, "first": 5}
_PTYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
          torch.float64: 3}
_MAX_SPECS = 48


def _kernel_plane_dtype(kind: str, dt: torch.dtype) -> torch.dtype:
    """The plane the kernel accumulates into: narrow ints widen to int32,
    `first` holds row ids."""
    if kind == "first":
        return torch.int32
    if dt in (torch.int8, torch.int16, torch.uint8):
        return torch.int32
    return dt


def _check(t: torch.Tensor, name: str, C: int, dtypes) -> None:
    if t.device.type != "cuda" or t.dtype not in dtypes \
            or t.shape != (C,) or not t.is_contiguous():
        raise ValueError(f"hash_agg_build: {name} must be a contiguous "
                         f"[{C}] CUDA tensor of {dtypes}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def hash_agg_build_cuda(words: Sequence[torch.Tensor], live: torch.Tensor,
                        vals, contribs, specs, T: int):
    """Launch ``csrc/hash_agg.cu`` on the current stream (through
    ``csrc/binding.cpp``). Raises on any input the kernel does not take,
    and on a refused launch."""
    global launches
    from . import cuda_build
    C = live.shape[0]
    dev = live.device
    if len(words) not in (1, 2):
        raise ValueError("hash_agg_build: 1 or 2 key words")
    if T < 1 or T & (T - 1) or C >= 2 ** 31:
        raise ValueError(f"hash_agg_build: T={T} must be a power of two "
                         f"and C={C} < 2^31")
    if len(specs) > _MAX_SPECS:
        raise ValueError(f"hash_agg_build: at most {_MAX_SPECS} planes")
    for i, w in enumerate(words):
        _check(w, f"word {i}", C, (torch.int64,))
    _check(live, "live", C, (torch.bool,))
    for i, (v, c) in enumerate(zip(vals, contribs)):
        _check(v, f"value {i}", C, tuple(_VTYPE))
        _check(c, f"contrib {i}", C, (torch.bool,))
    tk = [torch.zeros(T, dtype=torch.int64, device=dev) for _ in words]
    state = torch.zeros(T, dtype=torch.int32, device=dev)
    frow = torch.full((T,), C, dtype=torch.int32, device=dev)
    info = torch.zeros(8, dtype=torch.int32, device=dev)
    kplanes = []
    for vi, op, kind, dt in specs:
        kdt = _kernel_plane_dtype(kind, dt)
        fill = C if kind == "first" else _identity(kind, dt)
        kplanes.append(torch.full((T,), fill, dtype=kdt, device=dev))
    cuda_build.extension().hash_agg_build(
        list(words), live, T, tk, state, frow, info,
        [_KIND[s[2]] for s in specs], [_VTYPE[vals[s[0]].dtype] for s in specs],
        [_PTYPE[p.dtype] for p in kplanes], [vals[s[0]] for s in specs],
        [contribs[s[0]] for s in specs], kplanes)
    launches += 1
    planes = []
    for (vi, op, kind, dt), p in zip(specs, kplanes):
        planes.append(p.to(torch.int64) if kind == "first" else p.to(dt))
    return tk, state == 2, frow.to(torch.int64), planes, \
        info[0].to(torch.int64)


def hash_agg_build(words, live, vals, contribs, specs, T: int):
    """The table build: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors. No fallback: a CUDA tensor launches the
    kernel or raises."""
    if live.device.type == "cuda":
        return hash_agg_build_cuda(words, live, vals, contribs, specs, T)
    if live.device.type == "cpu":
        return hash_agg_build_plain(words, live, vals, contribs, specs, T)
    raise ValueError(f"hash_agg_build: unsupported device {live.device}")


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
    contribs = [vv & row_mask for vv in val_valids]
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
