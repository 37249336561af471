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

import functools
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
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

#: slots per tile of the build's scan (``kScanTile`` in csrc/hash_join.cu)
_SCAN_TILE = 4096
#: rows of a long segment that one block sorts (``kChunk``)
_CHUNK = 4096
#: probe rows per tile of the probe's scan (``kThreads``)
_PROBE_TILE = 256
_ALIGN = 256


class Layout(NamedTuple):
    """A workspace's planes: byte offsets by name, the total size, and the
    int64 array the kernel entry reads (byte offsets, then sizes)."""
    offsets: Dict[str, int]
    nbytes: int
    meta: np.ndarray


def _place(planes) -> Tuple[Dict[str, int], int]:
    offsets, at = {}, 0
    for name, nbytes in planes:
        offsets[name] = at
        at += -(-nbytes // _ALIGN) * _ALIGN
    return offsets, at


@functools.lru_cache(maxsize=64)
def build_layout(C: int, T: int) -> Layout:
    """The build's workspace over C build rows and T slots, every plane
    256-byte aligned: the contract's ``tk`` [T+1] int64, ``off`` [T+2] and
    ``rows`` [C] int32; the count plane [T+1] (the scatter's cursors
    after the scan); ``slot_of`` [C] (each row's slot, then the long
    segments' sort scratch); the lists of segments to order (``shorts``:
    at most C/2 segments of 2..32 rows; ``items``: one int2 per chunk of a
    longer one, at most C/33 + C/4096 + 2); the scan's tile status; and
    eight int32 counters (n_keys, unplaced, then the kernels' own)."""
    tiles = -(-(T + 1) // _SCAN_TILE)
    items = C // 33 + C // _CHUNK + 2
    offsets, nbytes = _place((
        ("tk", 8 * (T + 1)), ("off", 4 * (T + 2)), ("rows", 4 * C),
        ("cnt", 4 * (T + 1)), ("slot_of", 4 * C), ("shorts", 4 * (C // 2 + 1)),
        ("items", 8 * items), ("status", 8 * tiles), ("info", 32)))
    meta = np.array([offsets[k] for k in (
        "tk", "off", "rows", "cnt", "slot_of", "shorts", "items", "status",
        "info")] + [tiles, items], dtype=np.int64)
    return Layout(offsets, nbytes, meta)


@functools.lru_cache(maxsize=64)
def probe_layout(C: int, W: int) -> Layout:
    """The probe's buffer over C probe rows and W = max(cap, C) output
    slots, zeroed whole by the wrapper: the packed int32 [3, W] matrix
    first (its row 2 is the counts), then each row's inclusive end in the
    output (int64), its slot, the scan's tile status and its tile
    counter."""
    tiles = -(-C // _PROBE_TILE)
    offsets, nbytes = _place((
        ("packed", 12 * W), ("incl", 8 * C), ("pslot", 4 * C),
        ("status", 8 * tiles), ("tiles", 4)))
    meta = np.array([W, 8 * W] + [offsets[k] for k in (
        "incl", "pslot", "status", "tiles")] + [tiles], dtype=np.int64)
    return Layout(offsets, nbytes, meta)


def _check(t: torch.Tensor, name: str, n: int, dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"hash join: {name} must be a contiguous [{n}] "
                         f"CUDA tensor of {dtype}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_T(T: int, C: int) -> None:
    if T < 1 or T & (T - 1) or T > 2 ** 30:
        raise ValueError(f"hash join: T={T} must be a power of two "
                         "up to 2^30")
    if C >= T:
        raise ValueError(f"hash join: the table's T={T} slots must exceed "
                         f"the build side's C={C} rows")


def hash_join_build_cuda(code: torch.Tensor, live: torch.Tensor,
                         T: int) -> JoinTable:
    """Launch the build of ``csrc/hash_join.cu`` on the current stream:
    six kernels into one ``torch.empty`` workspace (:func:`build_layout`),
    whose planes the table views. Raises on any input the kernels do not
    take, and on a refused launch."""
    from . import cuda_build
    C = code.shape[0]
    _check_T(T, C)
    _check(code, "build keys", C, torch.int64)
    _check(live, "build live mask", C, torch.bool)
    lay = build_layout(C, T)
    ws = torch.empty(lay.nbytes // 4, dtype=torch.int32, device=code.device)
    cuda_build.check(cuda_build.launch(
        cuda_build.library().daft_hash_join_build, code.device,
        code.data_ptr(), live.data_ptr(), C, T, ws.data_ptr(),
        lay.meta.ctypes.data), "hash_join_build")
    _launched("hash_join_build")
    tk, off, rows, info = (lay.offsets[k] // 4 for k in (
        "tk", "off", "rows", "info"))
    n_keys, unplaced = ws[info:info + 2].unbind()
    return JoinTable(ws[tk:tk + 2 * (T + 1)].view(torch.int64),
                     ws[off:off + T + 2], ws[rows:rows + C], n_keys,
                     unplaced, T)


def hash_join_probe_cuda(code: torch.Tensor, live: torch.Tensor,
                         table: JoinTable, cap: int) -> torch.Tensor:
    """Launch the probe of ``csrc/hash_join.cu`` on the current stream:
    one zeroed buffer (:func:`probe_layout`), the count-and-scan kernel,
    then the emit kernel; returns the packed int32 ``[3, max(cap, C)]``
    matrix (a view of the buffer)."""
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
    W = max(cap, C)
    lay = probe_layout(C, W)
    buf = torch.zeros(lay.nbytes // 8, dtype=torch.int64, device=code.device)
    cuda_build.check(cuda_build.launch(
        cuda_build.library().daft_hash_join_probe, code.device,
        code.data_ptr(), live.data_ptr(), C, T, table.tk.data_ptr(),
        table.off.data_ptr(), table.rows.data_ptr(), cap, buf.data_ptr(),
        lay.meta.ctypes.data), "hash_join_probe")
    _launched("hash_join_probe")
    return buf.view(torch.int32)[:3 * W].view(3, W)


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


def hash_join_table(r_key, r_valid, r_mask) -> JoinTable:
    """The build side's table, as :func:`hash_join_impl` builds it: NULL
    keys never match, so liveness folds validity in and dead rows do not
    insert. One table serves any number of probes."""
    return hash_join_build(r_key.to(torch.int64).contiguous(),
                           (r_valid & r_mask).contiguous(),
                           join_table_capacity(r_key.shape[0]))


def hash_join_probe_table(l_key, l_valid, l_mask, table: JoinTable,
                          out_capacity: int) -> torch.Tensor:
    """One probe of a :func:`hash_join_table` table: the packed int32
    ``[3, max(out_capacity, C_l)]`` matrix of :func:`hash_join_impl`."""
    return hash_join_probe(l_key.to(torch.int64).contiguous(),
                           (l_valid & l_mask).contiguous(), table,
                           out_capacity)


def hash_join_impl(l_key, l_valid, l_mask, r_key, r_valid, r_mask,
                   out_capacity: int) -> torch.Tensor:
    """Hash build/probe inner-equi-join index generation, returning the
    SAME packed int32 ``[3, max(out_capacity, C_l)]`` matrix as
    :func:`kernels.join_fused_impl`. NULL keys never match: liveness
    folds validity in, and dead rows neither insert nor probe."""
    return hash_join_probe_table(l_key, l_valid, l_mask,
                                 hash_join_table(r_key, r_valid, r_mask),
                                 out_capacity)
