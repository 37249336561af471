"""Hash equi-join index generation: the CUDA build and probe kernels,
their plain torch twins, and the entry point that packs their result.

The torch rewrite of the join half of ``daft_tpu/device/pallas_kernels.py``
(:455-690): ``join_table_capacity``, ``hash_join_impl`` and the two Pallas
kernels ``_join_build_call`` and ``_join_probe_call``. Here the kernels
are ``csrc/hash_join.cu``, launched by :func:`hash_join_build` and
:func:`hash_join_probe` on CUDA tensors; on CPU tensors the same wrappers
run :func:`hash_join_build_plain` and :func:`hash_join_probe_plain`. There
is no third way: a CUDA tensor launches the kernel or raises.

Build contract (kernel and plain alike), over C build rows and a
power-of-two table of T > C slots plus one extra slot T:

- ``tk`` int64 ``[T+1]``: each occupied slot's key code, ``EMPTY``
  (INT64_MIN) elsewhere; the key equal to ``EMPTY`` itself lives in slot
  T;
- ``off`` int32 ``[T+2]``: slot j's rows are ``rows[off[j]:off[j+1]]``
  (empty for a free slot);
- ``rows`` int32 ``[C]``: the live rows grouped by slot, ascending within
  a slot (the reference's chains run in ascending build-row order); the
  entries past the live count are -1;
- ``n_keys``: occupied slots (distinct live keys);
- ``unplaced``: live rows that found no slot within T probe steps, 0 by
  construction (T > C leaves a free slot); the kernel counts them so a
  check on the card can show it.

Which slot a key takes differs between the two (the kernel hashes with
splitmix64 and probes linearly; the plain version numbers keys in
first-row order), so two builds compare as key → rows maps. The probe of
either table is the same function: :func:`hash_join_probe` returns the
reference's packed int32 ``[3, max(cap, C_l)]`` (row 0 left row and row 1
right row per output slot ``[:cap]``, row 2 per-left-row match counts
``[:C_l]``; pairs left-major, right rows ascending; pairs at or past
``cap`` dropped, counts still true; slots past the total hold 0).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

#: the free-slot marker of the table's key plane
EMPTY = -(1 << 63)

#: CUDA kernel launches since the last :func:`reset_launches`, per kernel —
#: counted where a wrapper launches its kernel and nowhere else
launches = {"hash_join_build": 0, "hash_join_probe": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


def _launched(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


def join_table_capacity(c_r: int) -> int:
    """Build-table slots for a build side of capacity ``c_r``: twice it,
    at least 128, rounded up to a power of two (the reference's
    ``max(2 c_r, 128)`` for every power-of-two bucket), so the table can
    never fill (distinct keys <= live rows < T)."""
    t = 128
    while t < 2 * c_r:
        t <<= 1
    return t


class JoinTable(NamedTuple):
    tk: torch.Tensor        # int64 [T+1]
    off: torch.Tensor       # int32 [T+2]
    rows: torch.Tensor      # int32 [C]
    n_keys: torch.Tensor    # int scalar: occupied slots
    unplaced: torch.Tensor  # int scalar: live rows without a slot (0)
    T: int


# ------------------------------------------------------------ plain versions

def hash_join_build_plain(code: torch.Tensor, live: torch.Tensor,
                          T: int) -> JoinTable:
    """The build in plain torch: keys take slots 0, 1, ... in first-row
    order (the ``EMPTY`` key takes slot T); rows ascending per slot."""
    C = code.shape[0]
    dev = code.device
    rows = torch.nonzero(live).flatten()
    k = code[rows]
    special = k == EMPTY
    uniq, inv = torch.unique(k[~special], return_inverse=True)
    ndv = uniq.shape[0]
    first = torch.full((ndv,), C, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, inv, rows[~special], "amin")
    rank = torch.empty_like(first)
    rank[torch.argsort(first)] = torch.arange(ndv, device=dev)
    slot = torch.full_like(rows, T)
    slot[~special] = rank[inv]
    tk = torch.full((T + 1,), EMPTY, dtype=torch.int64, device=dev)
    tk[slot] = k
    cnt = torch.zeros(T + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, slot, torch.ones_like(slot))
    off = torch.zeros(T + 2, dtype=torch.int32, device=dev)
    off[1:] = torch.cumsum(cnt, 0).to(torch.int32)
    out_rows = torch.full((C,), -1, dtype=torch.int32, device=dev)
    # rows ascend, so a stable sort by slot keeps each slot's rows in order
    out_rows[:rows.shape[0]] = rows[torch.sort(slot, stable=True).indices] \
        .to(torch.int32)
    n_keys = torch.tensor(ndv + int(bool(special.any())), device=dev)
    return JoinTable(tk, off, out_rows, n_keys,
                     torch.zeros((), dtype=torch.int64, device=dev), T)


def hash_join_probe_plain(code: torch.Tensor, live: torch.Tensor,
                          table: JoinTable, cap: int) -> torch.Tensor:
    """The probe in plain torch, over any table that keeps the build
    contract: each live row's key is looked up among the occupied slots'
    keys by binary search, and its slot's rows are expanded at the
    exclusive scan of the counts, up to ``cap``."""
    C = code.shape[0]
    dev = code.device
    tk, off, rows = table.tk, table.off.to(torch.int64), table.rows
    cnt = off[1:] - off[:-1]
    occ = torch.nonzero(cnt > 0).flatten()
    keys, order = torch.sort(tk[occ])
    occ = occ[order]
    pos = torch.clamp(torch.searchsorted(keys, code), max=max(
        occ.shape[0] - 1, 0))
    found = live & (occ.shape[0] > 0)
    if occ.shape[0]:
        found = found & (keys[pos] == code)
        slot = occ[pos]
    else:
        slot = torch.zeros_like(pos)
    counts = torch.where(found, cnt[slot], torch.zeros_like(pos))
    cum = torch.cumsum(counts, 0)
    n_out = min(int(cum[-1]) if C else 0, cap)
    packed = torch.zeros((3, max(cap, C)), dtype=torch.int32, device=dev)
    o = torch.arange(n_out, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(cum, o, right=True)
    k = o - (cum - counts)[owner]
    packed[0, :n_out] = owner.to(torch.int32)
    packed[1, :n_out] = rows[off[slot[owner]] + k]
    packed[2, :C] = counts.to(torch.int32)
    return packed


# ------------------------------------------------------------- CUDA kernels

def _check(t: torch.Tensor, name: str, n: int, dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"hash join: {name} must be a contiguous [{n}] "
                         f"CUDA tensor of {dtype}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_T(T: int, C: int) -> None:
    if T < 1 or T & (T - 1) or T >= 2 ** 31 - 2:
        raise ValueError(f"hash join: T={T} must be a power of two "
                         "below 2^31")
    if C >= T:
        raise ValueError(f"hash join: the table's T={T} slots must exceed "
                         f"the build side's C={C} rows")


def hash_join_build_cuda(code: torch.Tensor, live: torch.Tensor,
                         T: int) -> JoinTable:
    """Launch the build of ``csrc/hash_join.cu`` on the current stream:
    claim/count, the scan of the counts (torch cumsum), then scatter and
    segment sort. Raises on any input the kernels do not take, and on a
    refused launch."""
    from . import cuda_build
    C = code.shape[0]
    _check_T(T, C)
    _check(code, "build keys", C, torch.int64)
    _check(live, "build live mask", C, torch.bool)
    dev = code.device
    i32 = dict(dtype=torch.int32, device=dev)
    tk = torch.full((T + 1,), EMPTY, dtype=torch.int64, device=dev)
    cnt = torch.zeros(T + 1, **i32)
    off = torch.zeros(T + 2, **i32)
    slot_of = torch.empty(C, **i32)
    fill = torch.zeros(T + 1, **i32)
    rows = torch.full((C,), -1, **i32)
    long_list = torch.empty(T + 1, **i32)
    info = torch.zeros(4, **i32)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(lib.daft_hash_join_build_claim(
            code.data_ptr(), live.data_ptr(), C, T, tk.data_ptr(),
            cnt.data_ptr(), slot_of.data_ptr(), info.data_ptr(), stream),
            "hash_join_build")
        # the exclusive scan of the counts into off[1:]
        torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
        cuda_build.check(lib.daft_hash_join_build_scatter(
            slot_of.data_ptr(), C, T, off.data_ptr(), fill.data_ptr(),
            rows.data_ptr(), long_list.data_ptr(), info.data_ptr(), stream),
            "hash_join_build")
    _launched("hash_join_build")
    return JoinTable(tk, off, rows, info[0], info[1], T)


def hash_join_probe_cuda(code: torch.Tensor, live: torch.Tensor,
                         table: JoinTable, cap: int) -> torch.Tensor:
    """Launch the probe of ``csrc/hash_join.cu`` on the current stream:
    count, the scan of the counts (torch cumsum), then emit; returns the
    packed int32 ``[3, max(cap, C)]`` matrix."""
    from . import cuda_build
    C = code.shape[0]
    T = table.T
    if C >= 2 ** 31 or cap < 0:
        raise ValueError(f"hash join: probe C={C} must be below 2^31 and "
                         f"cap={cap} non-negative")
    _check(code, "probe keys", C, torch.int64)
    _check(live, "probe live mask", C, torch.bool)
    _check(table.tk, "table keys", T + 1, torch.int64)
    _check(table.off, "table offsets", T + 2, torch.int32)
    _check(table.rows, "table rows", table.rows.shape[0], torch.int32)
    dev = code.device
    packed = torch.zeros((3, max(cap, C)), dtype=torch.int32, device=dev)
    pslot = torch.empty(C, dtype=torch.int32, device=dev)
    incl = torch.empty(C, dtype=torch.int64, device=dev)
    counts = packed[2, :C]
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(lib.daft_hash_join_probe_count(
            code.data_ptr(), live.data_ptr(), C, T, table.tk.data_ptr(),
            table.off.data_ptr(), pslot.data_ptr(), counts.data_ptr(),
            stream), "hash_join_probe")
        # the inclusive scan of the counts: each row's end in the output
        torch.cumsum(counts, 0, dtype=torch.int64, out=incl)
        cuda_build.check(lib.daft_hash_join_probe_emit(
            pslot.data_ptr(), counts.data_ptr(), incl.data_ptr(), C,
            table.off.data_ptr(), table.rows.data_ptr(), cap,
            packed[0].data_ptr(), packed[1].data_ptr(), stream),
            "hash_join_probe")
    _launched("hash_join_probe")
    return packed


# ---------------------------------------------------------------- dispatch

def hash_join_build(code: torch.Tensor, live: torch.Tensor,
                    T: int) -> JoinTable:
    """The build: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors."""
    if code.device.type == "cuda":
        return hash_join_build_cuda(code, live, T)
    if code.device.type == "cpu":
        return hash_join_build_plain(code, live, T)
    raise ValueError(f"hash_join_build: unsupported device {code.device}")


def hash_join_probe(code: torch.Tensor, live: torch.Tensor,
                    table: JoinTable, cap: int) -> torch.Tensor:
    """The probe: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors."""
    if code.device.type == "cuda":
        return hash_join_probe_cuda(code, live, table, cap)
    if code.device.type == "cpu":
        return hash_join_probe_plain(code, live, table, cap)
    raise ValueError(f"hash_join_probe: unsupported device {code.device}")


def hash_join_impl(l_key, l_valid, l_mask, r_key, r_valid, r_mask,
                   out_capacity: int) -> torch.Tensor:
    """Hash build/probe inner-equi-join index generation, returning the
    SAME packed int32 ``[3, max(out_capacity, C_l)]`` matrix as
    :func:`kernels.join_fused_impl`. NULL keys never match: liveness
    folds validity in, and dead rows neither insert nor probe."""
    T = join_table_capacity(r_key.shape[0])
    table = hash_join_build(r_key.to(torch.int64).contiguous(),
                            (r_valid & r_mask).contiguous(), T)
    return hash_join_probe(l_key.to(torch.int64).contiguous(),
                           (l_valid & l_mask).contiguous(), table,
                           out_capacity)
