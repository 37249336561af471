"""Mesh-collective exchange programs: repartition as a transpose of
per-shard frames.

The torch rewrite of ``daft_tpu/parallel/exchange.py``. The reference runs
each program as one ``shard_map`` over a 1-D ``data`` mesh, with
``lax.all_to_all`` moving rows between shards. Here one process drives
every shard (``parallel/mesh.py``): a program takes one tensor per shard
and returns one tensor per shard, and runs in phases over the shards with
the exchange between them.

The ``all_to_all`` is a transpose of ``[n, C]`` frames: shard i fills a
frame whose row j goes to shard j, and shard j concatenates row j of every
frame in shard order. On one device that is an index over the stacked
``[n, n, C]`` frames; across devices row j moves with ``.to(devices[j],
non_blocking=True)``.

The 32-bit hash arithmetic the reference does in ``uint32`` runs in
``int64`` masked to 32 bits after every multiply and shift, so shard
assignments equal the reference's bit for bit. The reference's dropped
scatters (``mode="drop"``) write to one trash slot at ``n*C`` that is
sliced off.

All programs are eager torch ops; ``exchange_cache_counters`` counts the
memo of per-signature programs (the reference's traced-program cache).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import kernels
from .mesh import Mesh

_M32 = 0xFFFFFFFF

#: signature → program (the per-shard step functions of one exchange
#: shape); the counters are the evidence that two same-shape exchanges
#: share one program
_program_cache: Dict[tuple, "_Program"] = {}
_program_lock = threading.Lock()
_program_counters = {"hits": 0, "misses": 0, "uncacheable": 0}


def exchange_cache_counters() -> dict:
    """Program-memo counters plus its size."""
    with _program_lock:
        out = dict(_program_counters)
        out["entries"] = len(_program_cache)
    return out


class _Program:
    """One exchange program for one signature: a name and its steps."""

    __slots__ = ("name", "key", "steps")

    def __init__(self, name: str, key: tuple, steps: dict):
        self.name = name
        self.key = key
        self.steps = steps


def _program(name: str, key: tuple, build: Callable[[], dict]) -> _Program:
    """The memoized program of ``(name, key)``; ``build`` makes its steps
    on a miss."""
    full = (name,) + key
    with _program_lock:
        hit = _program_cache.get(full)
        if hit is not None:
            _program_counters["hits"] += 1
            return hit
        _program_counters["misses"] += 1
    prog = _Program(name, full, build())
    with _program_lock:
        return _program_cache.setdefault(full, prog)


def _sig(ts: Sequence[torch.Tensor]) -> tuple:
    return tuple((str(t.dtype), int(t.shape[0])) for t in ts)


# ------------------------------------------------------------- placement

def shard_blocks(mesh: Mesh, arr) -> List[torch.Tensor]:
    """Host ndarray ``[n*C]`` (or a tensor) → n ``[C]`` blocks, block i on
    shard i's device."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"])) \
        if isinstance(arr, np.ndarray) else arr
    n = mesh.size
    C = t.shape[0] // n
    return [t[i * C:(i + 1) * C].to(mesh.devices[i], non_blocking=True)
            for i in range(n)]


def replicate(mesh: Mesh, arr) -> List[torch.Tensor]:
    """The whole array on every shard (the reference's ``P()`` spec)."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"])) \
        if isinstance(arr, np.ndarray) else arr
    return [t.to(d, non_blocking=True) for d in mesh.devices]


def gather_blocks(blocks: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-shard blocks → one host ndarray ``[sum of block lengths]`` (the
    reference's ``jax.device_get`` of a sharded array)."""
    return np.concatenate([b.detach().cpu().numpy() for b in blocks])


# ---------------------------------------------------------- 32-bit hash

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``0 <= h < 2^32`` held in int64, without
    overflowing the int64 product."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)`` of an integer or bool tensor, as int64."""
    return x.to(torch.int64) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The reference's murmur3 finalizer over ``x.astype(uint32)``;
    returns the uint32 hash as int64."""
    h = _to_u32(x)
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _combine_hashes(keys, kvalids) -> torch.Tensor:
    """Multi-key → one uint32 hash plane (boost-style hash_combine), as
    int64 (reference ``exchange._combine_hashes``)."""
    h = torch.zeros(keys[0].shape, dtype=torch.int64,
                    device=keys[0].device)
    for k, kv in zip(keys, kvalids):
        if k.dtype == torch.bool:
            x = k.to(torch.int64)
        elif k.dtype.is_floating_point:
            x = k.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
        elif k.dtype in (torch.int64, torch.uint64):
            x64 = k.to(torch.int64)
            lo = x64 & _M32
            hi = (x64 >> 32) & _M32
            x = lo ^ _mul32(hi, 0x9E3779B9)
        else:
            x = _to_u32(k)
        hk = _hash_u32(x ^ kv.to(torch.int64))
        h = h ^ ((hk + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)) & _M32)
    return h


# ------------------------------------------------------------ all_to_all

def _route(pid: torch.Tensor, payload: Sequence[torch.Tensor],
           row_mask: torch.Tensor, n: int):
    """One shard's side of ``all_to_all_by_pid``: stable-sort rows by
    destination and scatter each into its destination's C-slot frame row.
    → (masked pid, frame mask ``[n, C]``, frame planes ``[n, C]``)."""
    C = pid.shape[0]
    dev = pid.device
    pid = torch.where(row_mask, pid.to(torch.int64),
                      torch.full((C,), n, dtype=torch.int64, device=dev))
    order = torch.sort(pid, stable=True).indices
    sorted_pid = pid[order]
    in_bucket = torch.arange(C, device=dev) \
        - torch.searchsorted(sorted_pid, sorted_pid, side="left")
    slots = torch.where(sorted_pid < n, sorted_pid * C + in_bucket,
                        torch.full_like(sorted_pid, n * C))
    fmask = torch.zeros(n * C + 1, dtype=torch.bool, device=dev)
    fmask[slots] = row_mask[order]
    frames = []
    for p in payload:
        fp = torch.zeros(n * C + 1, dtype=p.dtype, device=dev)
        fp[slots] = p[order]
        frames.append(fp[:n * C].view(n, C))
    return pid, fmask[:n * C].view(n, C), frames


def _transpose(frames: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The all_to_all: ``frames[i]`` is shard i's ``[n, C]`` frame; shard
    j receives ``concat_i frames[i][j]`` (``[n*C]``)."""
    n = len(frames)
    if all(d == devices[0] for d in devices) \
            and all(f.device == devices[0] for f in frames):
        stacked = torch.stack(list(frames))          # [src, dst, C]
        t = stacked.transpose(0, 1).reshape(n, -1)  # [dst, src*C]
        return [t[j] for j in range(n)]
    return [torch.cat([frames[i][j].to(devices[j], non_blocking=True)
                       for i in range(n)]) for j in range(n)]


def all_to_all_by_pid(pids, payloads, row_masks, mesh: Mesh):
    """Route every shard's rows to the shard its ``pid`` names: shard j
    ends with ``[n*C]`` blocks holding every live row whose pid was j, in
    (source shard, source row) order. pids / row_masks: one ``[C]`` tensor
    per shard; payloads: per shard, a sequence of ``[C]`` planes.
    → (masked pids, per-shard received planes, per-shard received mask)."""
    n = mesh.size
    routed = [_route(pids[i], payloads[i], row_masks[i], n)
              for i in range(n)]
    m2 = _transpose([r[1] for r in routed], mesh.devices)
    n_planes = len(payloads[0]) if payloads else 0
    planes = [_transpose([r[2][k] for r in routed], mesh.devices)
              for k in range(n_planes)]
    out = [tuple(planes[k][j] for k in range(n_planes)) for j in range(n)]
    return [r[0] for r in routed], out, m2


def all_to_all_by_hash(keys, payloads, row_masks, mesh: Mesh):
    """Route by ``_hash_u32(key) % n`` (reference
    ``exchange.all_to_all_by_hash``): the key plane travels first.
    → (per-shard keys, per-shard payload planes, per-shard mask)."""
    n = mesh.size
    pids = [(_hash_u32(k) % n) for k in keys]
    _, out, m2 = all_to_all_by_pid(
        pids, [(k,) + tuple(p) for k, p in zip(keys, payloads)],
        row_masks, mesh)
    return [o[0] for o in out], [o[1:] for o in out], m2


# ---------------------------------------------------------- the programs

#: final-merge ops that combine with themselves (x ⊕ x merges two
#: partials): the partial/final split upstream reduces count/mean/var to
#: sums before this layer
MERGEABLE_OPS = ("sum", "min", "max", "any_value", "bool_and", "bool_or")


def sharded_grouped_sum(mesh: Mesh, keys_sharded, vals_sharded,
                        mask_sharded):
    """Map → all_to_all → reduce grouped sum (reference
    ``exchange.sharded_grouped_sum``): per shard a partial grouped sum,
    the partials exchanged by key hash, a final grouped sum.
    → per-shard (keys, sums, group mask, group count broadcast)."""
    prog = _program("grouped_sum", (mesh.devices, _sig(keys_sharded),
                                    _sig(vals_sharded)),
                    lambda: {"agg": _grouped_agg_step(1, 1, ("sum",))})
    agg = prog.steps["agg"]
    n = mesh.size
    pk, ps, pm = [], [], []
    for i in range(n):
        k, v, m = keys_sharded[i], vals_sharded[i], mask_sharded[i]
        (ok,), (okv,), (osum,), _, pmask = agg((k, m, v, m), m)
        pk.append(ok)
        ps.append((osum,))
        pm.append(pmask & okv)
    k2, v2, m2 = all_to_all_by_hash(pk, ps, pm, mesh)
    out = ([], [], [], [])
    for j in range(n):
        (fk,), _, (fs,), _, fmask = agg((k2[j], m2[j], v2[j][0], m2[j]),
                                        m2[j])
        out[0].append(fk)
        out[1].append(fs)
        out[2].append(fmask)
        out[3].append(fmask.sum().expand(fk.shape[0]))
    return out


def _grouped_agg_step(nk: int, nv: int, ops: Tuple[str, ...]):
    """One shard's grouped aggregation over flat planes ``(keys...,
    kvalids..., vals..., vvalids...)`` → (keys, kvalids, vals, vvalids,
    live-group mask), each ``[C]`` (``kernels.grouped_agg_impl``)."""
    def step(flat, mask):
        ok, okv, ov, ovv, cnt = kernels.grouped_agg_impl(
            tuple(flat[:nk]), tuple(flat[nk:2 * nk]),
            tuple(flat[2 * nk:2 * nk + nv]), tuple(flat[2 * nk + nv:]),
            mask, ops)
        live = torch.arange(mask.shape[0], device=mask.device) < cnt
        return ok, okv, ov, ovv, live
    return step


def sharded_grouped_agg(mesh: Mesh, keys, kvalids, vals, vvalids, mask,
                        ops: Tuple[str, ...]):
    """Map → all_to_all → reduce grouped aggregation over the mesh for any
    number of key and value planes: the engine path behind
    ``DeviceExchangeAgg`` (reference ``exchange.sharded_grouped_agg``).

    keys / kvalids / vals / vvalids: tuples of per-shard block lists
    (``keys[a][i]`` is key plane a on shard i); mask: per-shard row masks.
    ops must all be in ``MERGEABLE_OPS``. → (keys, kvalids, vals, vvalids,
    group_mask), each plane a per-shard list of ``[n*C]`` blocks with
    disjoint key sets across shards."""
    n = mesh.size
    nk, nv = len(keys), len(vals)
    assert all(op in MERGEABLE_OPS for op in ops), ops
    agg = _program("grouped_agg", (mesh.devices, tuple(ops),
                                   _sig([k[0] for k in keys]),
                                   _sig([v[0] for v in vals])),
                   lambda: {"agg": _grouped_agg_step(nk, nv, tuple(ops))}
                   ).steps["agg"]
    payloads, pmasks, hashes = [], [], []
    for i in range(n):
        flat = tuple(p[i] for p in tuple(keys) + tuple(kvalids)
                     + tuple(vals) + tuple(vvalids))
        ok, okv, ov, ovv, live = agg(flat, mask[i])
        pmasks.append(live)
        # the reference routes by this hash plane, hashed once more by
        # all_to_all_by_hash
        hashes.append(_combine_hashes(ok, okv))
        payloads.append(tuple(ok) + tuple(okv) + tuple(ov) + tuple(ovv))
    _, recv, m2 = all_to_all_by_hash(hashes, payloads, pmasks, mesh)
    outs = [[] for _ in range(2 * nk + 2 * nv + 1)]
    for j in range(n):
        fk, fkv, fv, fvv, fmask = agg(recv[j], m2[j])
        for a, t in enumerate(tuple(fk) + tuple(fkv) + tuple(fv)
                              + tuple(fvv) + (fmask,)):
            outs[a].append(t)
    return (outs[:nk], outs[nk:2 * nk], outs[2 * nk:2 * nk + nv],
            outs[2 * nk + nv:2 * nk + 2 * nv], outs[-1])


def sharded_broadcast_join(mesh: Mesh, l_key, l_valid, l_mask,
                           r_key, r_valid, r_mask,
                           out_capacity_per_shard: int):
    """Broadcast equi-join over the mesh (reference
    ``exchange.sharded_broadcast_join``): the left key plane is sharded,
    the small right side is replicated to every shard, and each shard
    sort-merges its block against it (``kernels.join_sort_impl`` /
    ``join_count_impl`` / ``join_expand_impl``); no all_to_all.

    l_*: per-shard blocks; r_*: per-shard replicas (:func:`replicate`).
    → per-shard (left_idx, right_idx, valid) ``[out_capacity]`` blocks;
    left indices are SHARD-LOCAL (add ``shard * C`` to globalize)."""
    join = _program("broadcast_join", (mesh.devices, _sig(l_key),
                                       _sig(r_key), out_capacity_per_shard),
                    lambda: {"join": _broadcast_join_step(
                        out_capacity_per_shard)}).steps["join"]
    li, ri, ok = [], [], []
    for i in range(mesh.size):
        a, b, c = join(l_key[i], l_valid[i], l_mask[i], r_key[i],
                       r_valid[i], r_mask[i])
        li.append(a)
        ri.append(b)
        ok.append(c)
    return li, ri, ok


def _broadcast_join_step(out_capacity: int):
    """One shard's sort-merge of its probe block against the replicated
    build side → (left_idx, right_idx, valid) ``[out_capacity]``."""
    def step(lk, lv, lm, rk, rv, rm):
        rs, rperm, rcnt = kernels.join_sort_impl(rk, rv, rm)
        counts, starts, _ = kernels.join_count_impl(lk, lv, lm, rs, rcnt)
        return kernels.join_expand_impl(counts, starts, rperm,
                                        out_capacity)
    return step


def sharded_hash_repartition(mesh: Mesh, planes, valids, mask, pid):
    """Repartition row blocks across the mesh with one all_to_all: shard
    i ends up holding every row whose ``pid`` says i (reference
    ``exchange.sharded_hash_repartition``). The pid is computed on the
    host with the engine-wide xxh64 chain, so mesh- and host-exchanged
    partitions of one key agree. planes / valids: tuples of per-shard
    block lists. → (planes, valids, row_mask) per-shard received blocks."""
    n = mesh.size
    np_ = len(planes)
    route = _program("hash_repartition", (mesh.devices,
                                          _sig([p[0] for p in planes])),
                     lambda: {"route": all_to_all_by_pid}).steps["route"]
    payloads = [tuple(p[i] for p in planes) + tuple(v[i] for v in valids)
                for i in range(n)]
    _, recv, m2 = route(pid, payloads, mask, mesh)
    out_p = [[recv[j][a] for j in range(n)] for a in range(np_)]
    out_v = [[recv[j][np_ + a] for j in range(n)] for a in range(np_)]
    return out_p, out_v, m2
