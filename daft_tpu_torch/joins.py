"""Equi-joins of two RecordBatches: key factorization on the host, index
generation on the device (or the host), column assembly on the host.

Reference: ``daft_tpu/joins.py``. Join keys are factorized to shared dense
int64 ids (Arrow dictionary encoding, or range codes for integer keys);
:func:`match_indices` turns the two id columns into (left row, right row)
pairs, left-major with right rows ascending; :func:`join_recordbatch`
takes the columns through those pairs for inner/left/right/outer/semi/
anti joins. NULL keys never match; right-side columns colliding with left
names get a ``right.`` prefix; outer joins coalesce key columns.

The port's device rule departs from the reference's cost model
(``costmodel.join_wins``, the link-priced gate, waits for ROADMAP A7): a
join's index generation runs on the device whenever
``backend.resolve_device()`` gives one and the two sides hold at least
:data:`DEVICE_MIN_ROWS` rows together (the reference's own floor); below
it, on the host, counted as ``host_joins``. The strategy is ``hash`` (the
build/probe kernels of ``device/join_kernels.py``) unless
``DAFT_TORCH_KERNEL_JOIN=sort`` (the torch sort join of
``device/kernels.py``). The reference also sends a join to the sort
strategy when its hash table would pass 2^20 slots
(``costmodel._join_strategy``), because its table planes must fit the
TPU's on-chip memory; on the GPU they live in device memory, so the port
has no such ceiling for joins.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from . import knobs
from .expressions import Expression
from .series import Series

#: fewest rows (both sides together) whose index generation goes to the
#: device (reference: ``daft_tpu/joins.py`` ``match_indices``)
DEVICE_MIN_ROWS = 8192

# One join's device section at a time: the executor's pool threads share
# the card's one stream, where their launches would only interleave; the
# host work around it (factorize, take) still runs in parallel.
_device_lock = threading.Lock()


def _factorize_pair(l_arrs: List[pa.Array], r_arrs: List[pa.Array]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Map rows of (left, right) key columns to shared dense ids.

    Returns (l_gids, r_gids, l_valid, r_valid); gid comparisons implement
    multi-column key equality. NULL in any key column marks the row invalid.
    """
    n_l = len(l_arrs[0]) if l_arrs else 0
    n_r = len(r_arrs[0]) if r_arrs else 0
    code_cols = []
    l_valid = np.ones(n_l, dtype=bool)
    r_valid = np.ones(n_r, dtype=bool)
    for la, ra in zip(l_arrs, r_arrs):
        if la.type != ra.type:
            from .datatype import DataType
            from .expressions.typing import supertype
            st = supertype(DataType.from_arrow_type(la.type),
                           DataType.from_arrow_type(ra.type)).to_arrow()
            la, ra = la.cast(st), ra.cast(st)
        combined = pa.chunked_array([la, ra]).combine_chunks()
        if pa.types.is_integer(combined.type) \
                and not pa.types.is_uint64(combined.type):
            # integer keys: range codes (value - min) skip the dictionary
            # hash table; validity comes from Arrow's null mask, never a
            # value sentinel (INT64_MIN is a legal key); uint64 keys past
            # 2^63 take the dictionary path below
            valid = np.asarray(pc.is_valid(combined)
                               .to_numpy(zero_copy_only=False), dtype=bool)
            vals = np.asarray(pc.fill_null(combined.cast(pa.int64()), 0)
                              .to_numpy(zero_copy_only=False),
                              dtype=np.int64)
            live = vals[valid]
            lo = int(live.min()) if live.size else 0
            hi = int(live.max()) if live.size else 0
            if hi - lo < (1 << 40):
                codes = np.where(valid, vals - lo, -1)
                l_valid &= valid[:n_l]
                r_valid &= valid[n_l:]
                code_cols.append(codes)
                continue
        codes_arr = combined.dictionary_encode().indices
        codes = np.asarray(pc.fill_null(codes_arr, -1)
                           .to_numpy(zero_copy_only=False), dtype=np.int64)
        valid = codes >= 0
        l_valid &= valid[:n_l]
        r_valid &= valid[n_l:]
        code_cols.append(codes)
    if len(code_cols) == 1:
        gids = code_cols[0]
    else:
        # arithmetic packing while the cardinality product stays under
        # 2^62; a structured np.unique past that
        maxes = [int(c.max()) + 2 if c.size else 2 for c in code_cols]
        prod = 1
        for m in maxes:
            prod *= m
        if 0 < prod < (1 << 62):
            gids = code_cols[0].astype(np.int64, copy=True)
            for c, m in zip(code_cols[1:], maxes[1:]):
                gids *= m
                gids += c
        else:
            stacked = np.ascontiguousarray(
                np.stack(code_cols, axis=1).astype(np.int64))
            void = stacked.view([("", np.int64)] * stacked.shape[1]).ravel()
            _, gids = np.unique(void, return_inverse=True)
            gids = gids.astype(np.int64)
    return gids[:n_l], gids[n_l:], l_valid, r_valid


def join_strategy() -> str:
    """The device join's strategy: ``hash`` unless
    ``DAFT_TORCH_KERNEL_JOIN=sort``."""
    s = knobs.env_str("DAFT_TORCH_KERNEL_JOIN").lower()
    if s in ("auto", "hash"):
        return "hash"
    if s == "sort":
        return "sort"
    raise ValueError(f"DAFT_TORCH_KERNEL_JOIN={s!r}: expected auto, hash "
                     "or sort")


def match_indices(l_gids: np.ndarray, r_gids: np.ndarray,
                  l_valid: np.ndarray, r_valid: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each left row, all matching right rows.

    Returns (li, ri, l_match_counts): parallel index arrays of the matching
    pairs (left-major, right rows ascending) plus per-left-row match
    counts. On the device when the rule of this module's docstring says
    so, else on the host."""
    from .device import backend, runtime as drt
    n_l = len(l_gids)
    if n_l + len(r_gids) >= DEVICE_MIN_ROWS:
        device = backend.resolve_device()
        if device is not None:
            return _device_match_indices(l_gids, r_gids, l_valid, r_valid,
                                         device)
    drt.count("host_joins")
    r_idx = np.flatnonzero(r_valid)
    r_vals = r_gids[r_idx]
    order = np.argsort(r_vals, kind="stable")
    r_sorted_vals = r_vals[order]
    r_sorted_idx = r_idx[order]

    starts = np.searchsorted(r_sorted_vals, l_gids, side="left")
    ends = np.searchsorted(r_sorted_vals, l_gids, side="right")
    counts = np.where(l_valid, ends - starts, 0)
    total = int(counts.sum())
    li = np.repeat(np.arange(n_l), counts)
    cum = np.cumsum(counts) - counts  # exclusive prefix
    offsets = np.arange(total) - np.repeat(cum, counts)
    ri = r_sorted_idx[np.repeat(starts, counts) + offsets]
    return li, ri, counts


def _device_match_indices(l_gids, r_gids, l_valid, r_valid, device):
    """Index generation on ``device``: both sides padded to power-of-two
    buckets, one dispatch of the strategy's packed program (the hash
    strategy's probe of a table built once, ``join_kernels``, or
    ``kernels.join_fused_impl``) with an output bucket sized foreign-key
    shaped (about one match per row of the larger side, at least 1024),
    and one re-dispatch at the bucket of the true total when the counts
    say it was too small (the hash strategy probes its table again).
    Fetches the counts, then only the ``[:total]`` pairs."""
    import torch

    from .device import join_kernels as jk, kernels as K, runtime as drt
    from .device.column import bucket_capacity

    strategy = join_strategy()
    n_l, n_r = len(l_gids), len(r_gids)
    c_l, c_r = bucket_capacity(n_l), bucket_capacity(n_r)

    def put(a: np.ndarray, cap: int, dtype) -> "torch.Tensor":
        out = np.zeros(cap, dtype=dtype)
        out[:len(a)] = a
        return torch.from_numpy(out).to(device)

    with _device_lock:
        left = (put(l_gids, c_l, np.int64), put(l_valid, c_l, np.bool_),
                torch.arange(c_l, device=device) < n_l)
        right = (put(r_gids, c_r, np.int64), put(r_valid, c_r, np.bool_),
                 torch.arange(c_r, device=device) < n_r)
        if strategy == "hash":
            table = jk.hash_join_table(*right)
            dispatch = lambda cap: jk.hash_join_probe_table(  # noqa: E731
                *left, table, cap)
        else:
            dispatch = lambda cap: K.join_fused_impl(  # noqa: E731
                *left, *right, out_capacity=cap)
        cap = max(bucket_capacity(max(n_l, n_r, 1)), 1024)
        drt.count("join_" + strategy)
        packed = dispatch(cap)
        counts = packed[2, :n_l].cpu().numpy().astype(np.int64)
        total = int(counts.sum())
        if total > cap:  # many-to-many blowup past the estimate
            drt.count("join_" + strategy)
            packed = dispatch(bucket_capacity(total))
        pairs = packed[:2, :total].cpu().numpy().astype(np.int64)
    return pairs[0], pairs[1], counts


def _take_nullable(s: Series, idx: np.ndarray, valid: np.ndarray) -> Series:
    if s.is_pyobject():
        out = np.empty(len(idx), dtype=object)
        vals = s._pyobjs
        for i, (j, v) in enumerate(zip(idx, valid)):
            out[i] = vals[j] if v else None
        return Series(s.name(), s.datatype(), pyobjs=out)
    ia = pa.array(idx, mask=~valid)
    return Series(s.name(), s.datatype(), arrow=s.to_arrow().take(ia))


def join_recordbatch(left, right, left_on: List[Expression],
                     right_on: List[Expression], how: str = "inner"):
    from .recordbatch import RecordBatch

    l_keys = [left.eval_expression(e) for e in left_on]
    r_keys = [right.eval_expression(e) for e in right_on]
    l_gids, r_gids, l_valid, r_valid = _factorize_pair(
        [k.to_arrow() for k in l_keys], [k.to_arrow() for k in r_keys])

    if how in ("semi", "anti"):
        matched_gids = np.unique(r_gids[r_valid])
        has = np.isin(l_gids, matched_gids) & l_valid
        mask = has if how == "semi" else ~has
        return RecordBatch(left.schema,
                           [c.filter(mask) for c in left.columns()],
                           int(mask.sum()))

    li, ri, counts = match_indices(l_gids, r_gids, l_valid, r_valid)
    l_matched_mask = np.ones(len(li), dtype=bool)
    r_matched_mask = np.ones(len(ri), dtype=bool)

    if how in ("left", "outer", "full"):
        unmatched_l = np.flatnonzero(counts == 0)
        li = np.concatenate([li, unmatched_l])
        ri = np.concatenate([ri, np.zeros(len(unmatched_l), dtype=ri.dtype)])
        l_matched_mask = np.concatenate(
            [l_matched_mask, np.ones(len(unmatched_l), dtype=bool)])
        r_matched_mask = np.concatenate(
            [r_matched_mask, np.zeros(len(unmatched_l), dtype=bool)])
    if how in ("right", "outer", "full"):
        r_hit = np.zeros(len(right), dtype=bool)
        r_hit[ri[r_matched_mask]] = True
        unmatched_r = np.flatnonzero(~r_hit)
        li = np.concatenate([li, np.zeros(len(unmatched_r), dtype=li.dtype)])
        ri = np.concatenate([ri, unmatched_r])
        l_matched_mask = np.concatenate(
            [l_matched_mask, np.zeros(len(unmatched_r), dtype=bool)])
        r_matched_mask = np.concatenate(
            [r_matched_mask, np.ones(len(unmatched_r), dtype=bool)])

    # column assembly --------------------------------------------------
    l_key_names = [e.name() for e in left_on]
    r_key_names = [e.name() for e in right_on]
    left_names = set(left.column_names())

    out_cols: List[Series] = []
    for c in left.columns():
        s = _take_nullable(c, li, l_matched_mask)
        if how in ("outer", "full") and c.name() in l_key_names:
            # coalesce join keys from both sides
            ki = l_key_names.index(c.name())
            r_key_taken = _take_nullable(r_keys[ki], ri, r_matched_mask)
            merged = pc.if_else(
                pa.array(l_matched_mask),
                s.to_arrow(),
                r_key_taken.cast(s.datatype()).to_arrow())
            s = Series(c.name(), s.datatype(), arrow=merged)
        out_cols.append(s)
    for c in right.columns():
        if c.name() in r_key_names:
            ki = r_key_names.index(c.name())
            # drop right key when it pairs with an identically-named left key
            if ki < len(l_key_names) and l_key_names[ki] == c.name():
                continue
        nm = c.name()
        if nm in left_names:
            nm = f"right.{nm}"
        out_cols.append(_take_nullable(c, ri, r_matched_mask).rename(nm))
    return RecordBatch.from_series(out_cols) if out_cols else RecordBatch.empty()
