"""Grouped and global aggregation as torch programs.

The torch rewrite of the aggregation half of ``daft_tpu/device/kernels.py``
(XLA programs there, eager torch here): the packed u64 key codes shared by
the hash and sort strategies, the sort strategy
(``grouped_agg_block_impl``), the dense direct-slot strategy
(``grouped_agg_dense_impl``, what TPC-H Q1 runs), the keyless
``global_agg_impl`` (Q6), and the sort join (``join_sort_impl`` /
``join_count_impl`` / ``join_expand_impl`` / ``join_fused_impl``: the
``sort`` strategy of the device equi-join, and the oracle the hash join's
kernels are held against).

u64 words: torch's uint64 support is thin (``>>``, ``+`` and ``<`` raise on
the CPU build), so every u64 word rides an int64 tensor holding the same
bit pattern. Logical right shifts mask off the sign extension, and where
unsigned order matters the sign bit is flipped first (``_u64_order``).

Float min/max follow the reference's XLA semantics exactly: NaN propagates,
and -0.0 orders below +0.0 (``_seg_minmax``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _key_bits(dtype: torch.dtype) -> int:
    """Static value-code width (bits) of one sort key of this dtype."""
    if dtype == torch.bool:
        return 1
    if dtype.is_floating_point:
        return torch.finfo(dtype).bits
    return torch.iinfo(dtype).bits


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-carried u64 words."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mask(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep the low ``bits`` bits (bits < 64)."""
    return x & ((1 << bits) - 1)


def _u64_order(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of the u64 word."""
    return x ^ _I64_MIN


def _value_code(x: torch.Tensor, valid: torch.Tensor,
                descending: bool) -> torch.Tensor:
    """u64 radix code (as int64 bits): unsigned code order == key order.

    Floats use the IEEE total-order transform (flip all bits when
    negative, else set the sign bit); signed ints flip the sign bit;
    descending XOR-inverts the code. Invalid rows collapse to 0."""
    w = _key_bits(x.dtype)
    if x.dtype == torch.bool or x.dtype == torch.uint8:
        c = x.to(torch.int64)
    elif x.dtype == torch.float32:
        b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        c = torch.where(b >= (1 << 31), (~b) & 0xFFFFFFFF, b | (1 << 31))
    elif x.dtype == torch.float64:
        b = x.view(torch.int64)
        c = torch.where(b < 0, ~b, b | _I64_MIN)
    elif w == 64:
        c = x.view(torch.int64) ^ _I64_MIN
    else:
        c = x.to(torch.int64) + (1 << (w - 1))
    if descending:
        c = c ^ ((1 << w) - 1 if w < 64 else -1)
    return torch.where(valid, c, torch.zeros_like(c))


def _null_rank_code(valid: torch.Tensor, nulls_first: bool) -> torch.Tensor:
    """1-bit code placed ABOVE the value code: the null-placement plane."""
    rank_of_valid = 1 if nulls_first else 0
    return torch.where(valid, rank_of_valid, 1 - rank_of_valid) \
        .to(torch.int64)


def _sort_codes(keys, valids, row_mask, descending, nulls_first,
                with_dead: bool = True):
    """The (code, width) list for one multi-key sort: optional dead-row
    bit, then per-key (null_rank, value) codes, most-significant first."""
    codes: list = []
    if with_dead:
        codes.append(((~row_mask).to(torch.int64), 1))
    for v, valid, d, nf in zip(keys, valids, descending, nulls_first):
        live = valid & row_mask
        codes.append((_null_rank_code(live, nf), 1))
        codes.append((_value_code(v, live, d), _key_bits(v.dtype)))
    return codes


def _packed_chunks(codes) -> List[Tuple[torch.Tensor, ...]]:
    """Pack (code, width) planes — big-endian concatenated — into 128-bit
    chunks of one or two u64 words each (int64-carried), bit for bit the
    layout of the reference's ``kernels._packed_chunks``: cut every 128
    bits, each chunk left-aligned, (hi, lo) unsigned order == 128-bit
    unsigned order."""
    offs: List[int] = []
    off = 0
    for _, w in codes:
        offs.append(off)
        off += w
    W = off
    zero = torch.zeros_like(codes[0][0])
    chunks: List[Tuple[torch.Tensor, ...]] = []
    for cs in range(0, W, 128):
        ce = min(cs + 128, W)
        span = 64 if ce - cs <= 64 else 128
        words = [zero, zero]
        for (c, w), s in zip(codes, offs):
            a, b = max(s, cs), min(s + w, ce)
            if a >= b:
                continue
            ln = b - a
            piece = _lsr(c, s + w - b)
            if ln < 64:
                piece = _mask(piece, ln)
            p = span - (a - cs) - ln  # LSB bit position within the chunk
            if span == 64:
                words[0] = words[0] | (piece << p)
            elif p >= 64:
                words[0] = words[0] | (piece << (p - 64))
            elif p + ln <= 64:
                words[1] = words[1] | (piece << p)
            else:  # straddles the word boundary: split
                words[1] = words[1] | (piece << p)
                words[0] = words[0] | _lsr(piece, 64 - p)
        chunks.append(tuple(words[:1] if span == 64 else words))
    return chunks


def _stable_argsort_u64(word: torch.Tensor, perm: torch.Tensor
                        ) -> torch.Tensor:
    """Reorder ``perm`` stably by the unsigned value of ``word[perm]``."""
    o = torch.sort(_u64_order(word[perm]), stable=True).indices
    return perm[o]


def _packed_argsort(codes, C: int, want_words: bool = False):
    """Stable permutation ordering rows ascending by the big-endian
    concatenation of ``codes``: an LSD radix over 128-bit chunks, each
    chunk sorted low word first, then high word (stable)."""
    chunks = _packed_chunks(codes)
    perm = torch.arange(C, dtype=torch.int64, device=codes[0][0].device)
    for words in reversed(chunks):
        for w in reversed(words):
            perm = _stable_argsort_u64(w, perm)
    if not want_words:
        return perm
    return perm, tuple(w[perm] for words in chunks for w in words)


def argsort_kernel(keys, valids, row_mask, descending: Tuple[bool, ...],
                   nulls_first: Tuple[bool, ...]) -> torch.Tensor:
    """Multi-key sort permutation (reference: ``kernels.argsort_kernel``):
    live rows first, in key order, ties in row order; per key, nulls
    placed by ``nulls_first`` and values by the IEEE total order (-0.0
    before +0.0, NaN after +inf)."""
    codes = _sort_codes(keys, valids, row_mask, descending, nulls_first)
    return _packed_argsort(codes, row_mask.shape[0])


def compaction_perm(row_mask: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving the set rows of ``row_mask`` to the
    front."""
    return torch.sort((~row_mask).to(torch.int8), stable=True).indices


# ---------------------------------------------------------------------------
# segment reductions

def _identity_for(dtype: torch.dtype, op: str):
    if op == "min":
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed-int key whose order is the float total order (-0.0 < +0.0);
    its own inverse."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        return torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    b = x.view(torch.int64)
    return torch.where(b < 0, b ^ _I64_MAX, b)


def _float_from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_float_order_key` (the transform is an
    involution on the bit pattern)."""
    mask = 0x7FFFFFFF if k.dtype == torch.int32 else _I64_MAX
    return torch.where(k < 0, k ^ mask, k).view(dtype)


def _seg_minmax(x: torch.Tensor, contrib: torch.Tensor, seg: torch.Tensor,
                nseg: int, red: str) -> torch.Tensor:
    """Per-segment min/max of ``x`` over contributing rows, identity where
    a segment has none. Floats: NaN propagates, -0.0 < +0.0 (XLA's
    scatter-min/max semantics, which the reference computes with)."""
    ident = _identity_for(x.dtype, red)
    how = "amin" if red == "min" else "amax"
    if not x.dtype.is_floating_point:
        out = torch.full((nseg,), ident, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, seg[contrib], x[contrib], how)
    nan = torch.isnan(x)
    ok = contrib & ~nan
    key = _float_order_key(x)
    kident = _float_order_key(torch.tensor([ident], dtype=x.dtype))[0]
    out = torch.full((nseg,), int(kident), dtype=key.dtype, device=x.device)
    out = out.scatter_reduce(0, seg[ok], key[ok], how)
    out = _float_from_key(out, x.dtype)
    has_nan = torch.zeros(nseg, dtype=torch.bool, device=x.device)
    has_nan[seg[contrib & nan]] = True
    return torch.where(has_nan, torch.full_like(out, float("nan")), out)


def _seg_sum(x: torch.Tensor, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """Per-segment sum; float32 accumulates in float64 and rounds once."""
    acc = torch.float64 if x.dtype == torch.float32 else x.dtype
    out = torch.zeros(nseg, dtype=acc, device=x.device)
    return out.index_add_(0, seg, x.to(acc)).to(x.dtype)


def _seg_first_row(contrib: torch.Tensor, seg: torch.Tensor, nseg: int,
                   C: int) -> torch.Tensor:
    """Earliest contributing row per segment (C - 1 where none)."""
    idx = torch.arange(C, dtype=torch.int64, device=seg.device)
    out = torch.full((nseg,), C - 1, dtype=torch.int64, device=seg.device)
    return out.scatter_reduce(0, seg[contrib], idx[contrib], "amin")


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else torch.int64


def _mean_dtype(s1: torch.Tensor) -> torch.dtype:
    return torch.float32 if s1.dtype == torch.float32 else torch.float64


def _finalize(v, op, cnt, has, s1=None, s2=None, red=None, first=None):
    """(value, valid) of one op from its per-group states."""
    if op == "sum":
        return s1, has
    if op in ("mean", "var", "stddev"):
        fdt = _mean_dtype(s1)
        safe = torch.clamp(cnt, min=1).to(fdt)
        mean = s1.to(fdt) / safe
        if op == "mean":
            return mean, has
        var = torch.clamp(s2.to(fdt) / safe - mean * mean, min=0.0)
        return (torch.sqrt(var) if op == "stddev" else var), has
    if op in ("min", "max", "bool_and", "bool_or"):
        return (red.to(torch.bool) if v.dtype == torch.bool else red), has
    if op == "any_value":
        return first, has
    raise ValueError(f"unsupported device agg {op}")


def _float_acc(vals) -> torch.dtype:
    """The reference's float accumulator for the dense and sort
    strategies: float64 when any value is float64, else float32."""
    return torch.float64 if any(v.dtype == torch.float64 for v in vals) \
        else torch.float32


def _reduce_segments(vals, val_valids, row_mask, ops, seg, nseg: int,
                     live_group, float_acc=None):
    """Shared per-op reductions of the sort, dense and global strategies
    over per-row segment ids ``seg`` (ORIGINAL row order). Float sums
    accumulate in ``float_acc`` when given, else in the value's type."""
    C = row_mask.shape[0]
    out_vals, out_valids = [], []
    for v, vv, op in zip(vals, val_valids, ops):
        contrib = row_mask & vv
        cnt = _seg_sum(contrib.to(torch.int64), seg, nseg)
        has = live_group & (cnt > 0)
        if op == "count":
            out_vals.append(cnt)
            out_valids.append(live_group)
            continue
        s1 = s2 = red = first = None
        if op in ("sum", "mean", "var", "stddev"):
            x = torch.where(contrib, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
            acc = float_acc if float_acc is not None \
                and v.dtype.is_floating_point else _acc_dtype(v.dtype)
            s1 = _seg_sum(x.to(acc), seg, nseg)
            if op in ("var", "stddev"):
                xf = x.to(_mean_dtype(s1))
                s2 = _seg_sum(xf * xf, seg, nseg)
        elif op in ("min", "max", "bool_and", "bool_or"):
            base = v.to(torch.int8) if v.dtype == torch.bool else v
            red = _seg_minmax(base, contrib, seg, nseg,
                              "min" if op in ("min", "bool_and") else "max")
        elif op == "any_value":
            first = v[_seg_first_row(contrib, seg, nseg, C)]
        val, valid = _finalize(v, op, cnt, has, s1, s2, red, first)
        out_vals.append(val)
        out_valids.append(valid)
    return tuple(out_vals), tuple(out_valids)


# ---------------------------------------------------------------------------
# sort strategy

def grouped_agg_block_impl(keys, key_valids, vals, val_valids, row_mask,
                           ops: Tuple[str, ...], out_cap: int):
    """Sort-based grouped aggregation emitting [out_cap]-wide group blocks
    (reference: ``kernels.grouped_agg_block_impl``): radix-sort the packed
    key words, mark group boundaries, scatter each row's segment id back to
    its original position and reduce there. Groups come out in ascending
    key order; groups past ``out_cap`` are dropped, and ``group_count >
    out_cap`` tells the caller to re-dispatch bigger. Float sums
    accumulate as the reference's block strategy does
    (:func:`_float_acc`)."""
    return _sort_grouped_agg(keys, key_valids, vals, val_valids, row_mask,
                             ops, out_cap, _float_acc(vals))


def grouped_agg_impl(keys, key_valids, vals, val_valids, row_mask,
                     ops: Tuple[str, ...]):
    """The scatter form (reference: ``kernels.grouped_agg_impl``): the
    sort strategy at a ``[C]``-wide group block, which holds every group
    of C rows, so it never overflows. Groups in ascending key order; each
    float value sums in its own type."""
    return _sort_grouped_agg(keys, key_valids, vals, val_valids, row_mask,
                             ops, row_mask.shape[0], None)


def _sort_grouped_agg(keys, key_valids, vals, val_valids, row_mask,
                      ops: Tuple[str, ...], out_cap: int, float_acc):
    C = row_mask.shape[0]
    dev = row_mask.device
    codes = _sort_codes(keys, key_valids, row_mask,
                        (False,) * len(keys), (False,) * len(keys))
    perm, s_words = _packed_argsort(codes, C, want_words=True)
    s_live = s_words[0] >= 0   # dead bit is the MSB of the first word
    diff = torch.zeros(C, dtype=torch.bool, device=dev)
    diff[0] = True
    for w in s_words:
        diff[1:] |= w[1:] != w[:-1]
    flags = diff & s_live
    segf = torch.cumsum(flags.to(torch.int64), 0) - 1
    group_count = flags.sum()
    seg_sorted = torch.where(s_live, torch.clamp(segf, max=out_cap),
                             torch.full_like(segf, out_cap))
    seg = torch.empty_like(seg_sorted)
    seg[perm] = seg_sorted          # segment id of every ORIGINAL row

    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    live_group = j < group_count
    starts = torch.clamp(torch.searchsorted(seg_sorted, j), max=C - 1)
    first_row = perm[starts]
    out_keys = tuple(k[first_row] for k in keys)
    out_kvalids = tuple((kv & row_mask)[first_row] & live_group
                        for kv in key_valids)
    out_vals, out_valids = _reduce_segments(
        vals, val_valids, row_mask, ops, seg, out_cap + 1,
        torch.cat([live_group, torch.zeros(1, dtype=torch.bool,
                                           device=dev)]), float_acc)
    return out_keys, out_kvalids, tuple(x[:out_cap] for x in out_vals), \
        tuple(x[:out_cap] for x in out_valids), group_count


# ---------------------------------------------------------------------------
# dense strategy (dictionary-coded keys)

def grouped_agg_dense_impl(keys, key_valids, vals, val_valids, row_mask,
                           ops: Tuple[str, ...], out_cap: int,
                           dims: Tuple[int, ...]):
    """Grouped aggregation by direct slot indexing (reference:
    ``kernels.grouped_agg_dense_impl``): every key is a sorted-dictionary
    code < its pow2 width ``dims[i]`` (slot ``d`` holds nulls), so a row's
    group id is a mixed-radix number over the codes and each reduction is
    one scatter over ``K = prod(d + 1)`` slots. Occupied slots compact to
    the front in ascending key order with nulls last — the sort strategy's
    group order. Requires ``K <= out_cap``; never overflows."""
    C = row_mask.shape[0]
    dev = row_mask.device
    K = 1
    for d in dims:
        K *= d + 1
    if K > out_cap:
        raise ValueError("dense dispatch requires K <= out_cap")
    gid = torch.zeros(C, dtype=torch.int64, device=dev)
    for k, kv, d in zip(keys, key_valids, dims):
        comp = torch.where(kv & row_mask,
                           torch.clamp(k.to(torch.int64), 0, d),
                           torch.full((C,), d, dtype=torch.int64,
                                      device=dev))
        gid = gid * (d + 1) + comp
    seg = torch.where(row_mask, gid, torch.full_like(gid, K))
    occ = torch.zeros(K + 1, dtype=torch.int64, device=dev)
    occ.index_add_(0, seg, torch.ones_like(seg))
    occupied = occ[:K] > 0
    group_count = occupied.sum()
    # compact occupied slots to the front, ascending slot order (slot K,
    # the empty dead-row slot, pads the block)
    slot_of = compaction_perm(occupied)
    slot_of = torch.cat([slot_of, torch.full(
        (out_cap - K,), K, dtype=torch.int64, device=dev)])
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    live_group = j < group_count
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d + 1
    strides.reverse()
    out_keys, out_kvalids = [], []
    for k, d, st in zip(keys, dims, strides):
        comp = torch.where(live_group, (slot_of // st) % (d + 1), d)
        out_keys.append(comp.to(k.dtype))
        out_kvalids.append(live_group & (comp != d))
    # reduce over the K+1 slots (slot K: dead rows), then gather by slot
    slot_live = torch.cat([occupied, torch.zeros(1, dtype=torch.bool,
                                                 device=dev)])
    out_vals, out_valids = _reduce_segments(
        vals, val_valids, row_mask, ops, seg, K + 1, slot_live,
        _float_acc(vals))
    return tuple(out_keys), tuple(out_kvalids), \
        tuple(x[slot_of] for x in out_vals), \
        tuple(x[slot_of] & live_group for x in out_valids), group_count


# ---------------------------------------------------------------------------
# global aggregation

def global_agg_impl(vals, val_valids, row_mask, ops: Tuple[str, ...]):
    """Keyless aggregation → ((value, valid) scalar tensors) per op
    (reference: ``kernels.global_agg_impl``)."""
    seg = torch.zeros(row_mask.shape[0], dtype=torch.int64,
                      device=row_mask.device)
    live = torch.ones(1, dtype=torch.bool, device=row_mask.device)
    out_vals, out_valids = _reduce_segments(vals, val_valids, row_mask, ops,
                                            seg, 1, live)
    return tuple((v[0], m[0]) for v, m in zip(out_vals, out_valids))


# ---------------------------------------------------------------------------
# sort join (index generation)
#
# The reference's four phase programs, eager here: sort the build side,
# count each probe row's matches by binary search, expand the counts into
# (left, right) index pairs. Key codes stay int64 (torch's uint64 has no
# searchsorted).

def join_sort_impl(r_key, r_valid, r_mask):
    """Sort the right side's key column, stably (equal keys keep ascending
    row order); invalid/dead rows go to the end and read as the dtype's
    maximum so the array stays monotonic for searchsorted."""
    C = r_key.shape[0]
    live = r_valid & r_mask
    x = torch.where(live, r_key, torch.zeros((), dtype=r_key.dtype,
                                              device=r_key.device))
    perm = torch.sort(x, stable=True).indices
    perm = perm[torch.sort((~live[perm]).to(torch.int8), stable=True).indices]
    live_count = live.sum()
    maxval = float("inf") if x.dtype.is_floating_point \
        else torch.iinfo(x.dtype).max
    pos = torch.arange(C, device=r_key.device)
    sorted_keys = torch.where(pos < live_count, x[perm],
                              torch.full_like(x, maxval))
    return sorted_keys, perm, live_count


def join_count_impl(l_key, l_valid, l_mask, r_sorted, r_live_count):
    """Per-left-row match counts (and first match position) against the
    sorted right keys."""
    live = l_valid & l_mask
    key = l_key.to(r_sorted.dtype)
    starts = torch.minimum(torch.searchsorted(r_sorted, key), r_live_count)
    ends = torch.minimum(torch.searchsorted(r_sorted, key, right=True),
                         r_live_count)
    counts = torch.where(live, ends - starts, torch.zeros_like(starts))
    return counts, starts, counts.sum()


def join_expand_impl(counts, starts, r_perm, out_capacity: int):
    """Prefix-sum expansion: output slot j → (left row, right row)."""
    C = counts.shape[0]
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    j = torch.arange(out_capacity, dtype=cum.dtype, device=counts.device)
    owner = torch.clamp(torch.searchsorted(cum, j, right=True), 0, C - 1)
    offset = j - (cum - counts)[owner]
    r_slot = starts[owner] + offset
    # clip against the RIGHT side's capacity (the sides' buckets differ)
    r_idx = r_perm[torch.clamp(r_slot, 0, r_perm.shape[0] - 1)]
    return owner.to(torch.int32), r_idx.to(torch.int32), j < total


def join_fused_impl(l_key, l_valid, l_mask, r_key, r_valid, r_mask,
                    out_capacity: int):
    """Sort + count + expand, packed as the reference packs it: int32
    ``[3, max(out_capacity, C_l)]`` with row 0 the left row and row 1 the
    right row of each output slot (``[:out_capacity]``) and row 2 the
    per-left-row match counts (``[:C_l]``). Slots at or past the total
    are garbage; a total above ``out_capacity`` means the caller
    re-dispatches at a larger capacity. Pairs run left-major, right rows
    ascending."""
    C_l = l_key.shape[0]
    r_sorted, r_perm, r_live_count = join_sort_impl(r_key, r_valid, r_mask)
    counts, starts, _ = join_count_impl(l_key, l_valid, l_mask, r_sorted,
                                        r_live_count)
    owner, r_idx, _ = join_expand_impl(counts, starts, r_perm, out_capacity)
    packed = torch.zeros((3, max(out_capacity, C_l)), dtype=torch.int32,
                         device=l_key.device)
    packed[0, :out_capacity] = owner
    packed[1, :out_capacity] = r_idx
    packed[2, :C_l] = counts.to(torch.int32)
    return packed
