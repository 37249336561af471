"""Byte models and achieved-rate measurement of the port's device kernels.

The torch rewrite of ``daft_tpu/device/mfu.py``. Two parts:

- **Byte models** of one dispatch of each kernel family, written for the
  port's own kernels: the hash-agg table build (``csrc/hash_agg.cu``, two
  launches per call, ``device/hash_kernels.py``), the hash-join build
  (six launches) and probe (two, ``device/join_kernels.py``), and the
  torch sort, dense and sort-join strategies of ``device/kernels.py``.
  The hash models count what the bound column of ``PERF.md`` §6 counts
  (``chip_smoke.py``'s ``build_bytes``, ``join_build_bytes``,
  ``join_probe_bytes``): each input byte read once, each output byte
  written once, so the roofline reads the same work whatever implements
  it. The torch strategies' models count their passes (two per sort
  operand, one per scatter). None of these kernels does matrix
  arithmetic: every family is bandwidth-bound and its flops are 0 (the
  reference's one-hot matmul flops have no counterpart here).
  ``costmodel.groupby_strategy`` compares the hash and sort models, and
  the per-dispatch ledger (``costmodel.ledger_record``) prices real
  dispatches with them.
- **Measurement** (``measure_*``, :func:`report`): each family timed on
  device-resident inputs with CUDA events around ``iters`` back-to-back
  calls after a warm call (on CPU tensors, for the tests, with the host
  clock; the result names its device either way). Times are per call.

The peaks the rates are read against are :data:`PEAK_FLOPS` and
:data:`HBM_BPS`, the published figures of the card the port targets (never
a TPU's); ``chip_smoke.py`` gives its kernels' bounds against the same
memory rate.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

#: the card's peak FLOP/s: the published NVIDIA H100 SXM FP32 rate at
#: its 700 W limit
PEAK_FLOPS = 67e12
#: the card's memory rate, bytes/s: the published NVIDIA H100 SXM HBM3
#: rate at its 700 W limit
HBM_BPS = 3.35e12

#: calls per timed measurement (after one warm call)
_ITERS = 16


def _itemsize(dt) -> int:
    return dt.itemsize if isinstance(dt, torch.dtype) \
        else np.dtype(dt).itemsize


def _key_bits(dt) -> int:
    from . import kernels
    if not isinstance(dt, torch.dtype):
        dt = torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype
    return kernels._key_bits(dt)


# ------------------------------------------------------------ byte models

def argsort_pack_plan(dtypes: Sequence) -> list:
    """u64 words per 128-bit chunk of the packed sort key of these key
    dtypes (``kernels._packed_chunks``: a dead bit, then per key a
    null-rank bit and the value code): one stable sort pass per word."""
    bits = 1 + sum(1 + _key_bits(d) for d in dtypes)
    plan = []
    while bits > 0:
        take = min(bits, 128)
        plan.append(1 if take <= 64 else 2)
        bits -= take
    return plan


def argsort_bytes_model(cap: int, dtypes: Sequence) -> int:
    """One packed-key argsort over ``cap`` rows: one read of each key and
    validity plane (code construction), then per radix word one gather of
    the word by the running permutation and one stable sort of (word,
    int64 index), each read and written once."""
    key_read = cap * sum(_itemsize(d) + 1 for d in dtypes)
    words = sum(argsort_pack_plan(dtypes))
    return int(key_read + words * cap * (8 + 8 + 2 * (8 + 8)))


def join_bytes_model(c_l: int, c_r: int, out_cap: int) -> int:
    """One torch sort join (``kernels.join_fused_impl``): the build side's
    key, validity and mask read, two stable sorts of (key, int64 index);
    two searchsorted probes of the probe keys and their counts and starts
    planes; the prefix sum; the expansion's owner search, offset and
    right-row gathers; the packed ``[3, max(out_cap, c_l)]`` int32
    matrix written."""
    build = c_r * (8 + 1 + 1) + 2 * 2 * c_r * (8 + 8)
    probe = c_l * (8 + 1 + 1) + 2 * c_l * 8 + 2 * c_l * 8 + 2 * c_l * 8
    expand = out_cap * (8 + 8 + 8 + 8)
    return int(build + probe + expand + 3 * max(out_cap, c_l) * 4)


def grouped_agg_models(cap: int, out_cap: int, n_keys: int,
                       n_vals: int, val_bytes: int = 4):
    """(flops, bytes) of one sort-strategy grouped agg
    (``kernels._sort_grouped_agg``) over int64 keys: the packed argsort,
    the boundary pass over the sorted words, the segment ids scattered
    back (int64, read and written), one scatter-add per value plane and
    its count (value, validity and segment id read), and the
    ``[out_cap]`` output planes written."""
    sort_bytes = argsort_bytes_model(cap, [torch.int64] * max(n_keys, 1))
    words = sum(argsort_pack_plan([torch.int64] * max(n_keys, 1)))
    seg_bytes = cap * (8 * words + 8 * 4)
    reduce_bytes = (n_vals + 1) * cap * (val_bytes + 1 + 8)
    out_bytes = out_cap * (n_keys * 9 + n_vals * 9)
    return 0.0, int(sort_bytes + seg_bytes + reduce_bytes + out_bytes)


def hash_agg_models(cap: int, out_cap: int, table_cap: int, n_words: int,
                    n_vals: int, val_bytes: int = 4,
                    live_rows: Optional[int] = None):
    """(flops, bytes) of one hash-agg table build
    (``hash_kernels.hash_agg_build``): read once, the live mask (``cap``
    bytes) and per live row its key words and each value plane with its
    contrib mask (``val_bytes + 1``); written once, per table slot the key
    words, ``occ`` (1 B), ``frow`` (8 B) and per value its count (int32)
    and accumulator (``val_bytes``: the sum's width), and the group count.
    ``live_rows`` defaults to every row (``chip_smoke.build_bytes`` counts
    the rows a table that fills reads)."""
    live = cap if live_rows is None else live_rows
    reads = cap + live * (8 * n_words + n_vals * (val_bytes + 1))
    writes = table_cap * (8 * n_words + 1 + 8 + n_vals * (4 + val_bytes)) \
        + 8
    return 0.0, int(reads + writes)


def dense_agg_models(cap: int, out_cap: int, n_keys: int, n_vals: int,
                     val_bytes: int = 4):
    """(flops, bytes) of one dense grouped agg
    (``kernels.grouped_agg_dense_impl``): one pass over each key-code
    plane and its validity (the mixed-radix slot id is arithmetic), the
    slot ids written and read by the occupancy count and one scatter per
    reduced plane (values and the count), and the ``[out_cap]`` slot
    planes."""
    row_bytes = cap * (n_keys * (4 + 1) + 1 + 8 + 8
                       + (n_vals + 1) * (val_bytes + 1 + 8))
    slot_bytes = out_cap * (n_vals + 2) * 8
    return 0.0, int(row_bytes + slot_bytes)


def hash_join_build_bytes(c_r: int, table_cap: int,
                          live_r: Optional[int] = None) -> int:
    """One join-table build (``join_kernels.hash_join_build``): the live
    mask (``c_r`` bytes) and each live row's key read once; the table's
    key (T+1 slots, 8 B), offset (T+2, 4 B) and row (``c_r``, 4 B) planes
    written once."""
    live = c_r if live_r is None else live_r
    return int(c_r + 8 * live + 8 * (table_cap + 1) + 4 * (table_cap + 2)
               + 4 * c_r)


def hash_join_probe_bytes(c_l: int, pairs: int,
                          live_l: Optional[int] = None) -> int:
    """One probe (``join_kernels.hash_join_probe``): the live mask; per
    live row its key, its slot's key and the slot's two offsets (24 B);
    per emitted pair the right row id read (4 B); written once, the
    per-row counts (4 B) and the pairs (8 B)."""
    live = c_l if live_l is None else live_l
    return int(c_l + 24 * live + 4 * pairs + 4 * c_l + 8 * pairs)


def hash_join_bytes_model(c_l: int, c_r: int, out_cap: int) -> int:
    """One hash join dispatch, build and probe, every row live and
    ``out_cap`` pairs emitted."""
    from . import join_kernels
    return hash_join_build_bytes(c_r, join_kernels.join_table_capacity(c_r)) \
        + hash_join_probe_bytes(c_l, out_cap)


# ------------------------------------------------------- timing harness

def _resolve(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mfu: no CUDA device is available")
    return d


def _timed(fn, device: torch.device, iters: int = _ITERS) -> float:
    """Seconds per call of ``fn``: one warm call, then ``iters`` calls
    between two CUDA events (the host clock on the CPU)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return max((time.perf_counter() - t0) / iters, 1e-9)
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return max(a.elapsed_time(b) / 1e3 / iters, 1e-9)


def _rates(rec: dict) -> dict:
    t = rec["time_s"]
    rec["achieved_gbps"] = rec["bytes"] / t / 1e9
    rec["roofline_pct"] = 100.0 * rec["bytes"] / t / HBM_BPS
    if rec.get("input_bytes"):
        rec["input_bps"] = rec["input_bytes"] / t
    rec["rows_per_s"] = rec["rows"] / t
    return rec


def _agg_inputs(n: int, groups: int, n_vals: int, device):
    g = torch.Generator().manual_seed(0)
    keys = (torch.randint(0, groups, (n,), generator=g).to(device),)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    vals = tuple((torch.rand(n, generator=g, dtype=torch.float64) * 100)
                 .to(device) for _ in range(n_vals))
    return keys, (ones,), vals, (ones,) * n_vals, ones


def _agg_input_bytes(n: int, n_vals: int) -> int:
    """Encoded bytes of one int64 key and ``n_vals`` float64 values with
    their validity planes: what ``column.encoded_nbytes`` prices."""
    return n * (8 + 1 + n_vals * (8 + 1))


def measure_grouped_agg(n: int = 1 << 20, groups: int = 256,
                        n_vals: int = 2, device="cuda") -> Dict:
    """The sort strategy (``kernels.grouped_agg_block_impl``) over one
    int64 key, ``groups`` groups and ``n_vals`` float64 sums."""
    from . import kernels
    dev = _resolve(device)
    args = _agg_inputs(n, groups, n_vals, dev)
    out_cap = max(256, groups)
    ops = ("sum",) * n_vals
    t = _timed(lambda: kernels.grouped_agg_block_impl(*args, ops, out_cap),
               dev)
    _, nbytes = grouped_agg_models(n, out_cap, 1, n_vals, 8)
    return _rates({"kernel": "grouped_agg_sort", "strategy": "sort",
                   "rows": n, "groups": groups, "time_s": t,
                   "bytes": nbytes,
                   "input_bytes": _agg_input_bytes(n, n_vals)})


def measure_hash_grouped_agg(n: int = 1 << 20, groups: int = 256,
                             n_vals: int = 2, device="cuda") -> Dict:
    """The hash strategy (``hash_kernels.hash_grouped_agg_impl``: the
    CUDA table build on a card) at the same shape as
    :func:`measure_grouped_agg`."""
    from . import hash_kernels as hk
    dev = _resolve(device)
    args = _agg_inputs(n, groups, n_vals, dev)
    out_cap = max(256, groups)
    table = hk.table_capacity(out_cap)
    ops = ("sum",) * n_vals
    t = _timed(lambda: hk.hash_grouped_agg_impl(*args, ops, out_cap), dev)
    _, nbytes = hash_agg_models(n, out_cap, table, 1, n_vals, 8)
    return _rates({"kernel": "grouped_agg_hash", "strategy": "hash",
                   "rows": n, "groups": groups, "table_slots": table,
                   "time_s": t, "bytes": nbytes,
                   "input_bytes": _agg_input_bytes(n, n_vals)})


def measure_dense_agg(n: int = 1 << 20, groups: int = 4, n_vals: int = 2,
                      device="cuda") -> Dict:
    """The dense strategy (``kernels.grouped_agg_dense_impl``): one
    dictionary-coded int32 key of ``groups`` codes (TPC-H Q1's shape)."""
    from . import kernels
    dev = _resolve(device)
    keys, kv, vals, vv, mask = _agg_inputs(n, groups, n_vals, dev)
    keys = (keys[0].to(torch.int32),)
    d = max(1 << max(groups - 1, 0).bit_length(), 1)
    out_cap = max(128, d + 1)
    ops = ("sum",) * n_vals
    t = _timed(lambda: kernels.grouped_agg_dense_impl(
        keys, kv, vals, vv, mask, ops, out_cap, (d,)), dev)
    _, nbytes = dense_agg_models(n, out_cap, 1, n_vals, 8)
    return _rates({"kernel": "grouped_agg_dense", "strategy": "dense",
                   "rows": n, "groups": groups, "time_s": t,
                   "bytes": nbytes,
                   "input_bytes": n * (4 + 1 + n_vals * (8 + 1))})


def _join_inputs(n: int, device):
    g = torch.Generator().manual_seed(1)
    r_key = torch.randint(0, max(n // 2, 1), (n,), generator=g).to(device)
    l_key = torch.randint(0, max(n // 2, 1), (n,), generator=g).to(device)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    return l_key, ones, ones, r_key, ones, ones


def measure_join(n: int = 1 << 20, device="cuda") -> Dict:
    """The torch sort join (``kernels.join_fused_impl``) of two ``n``-row
    sides of keys drawn from ``n / 2`` values (about two matches per
    probe row)."""
    from . import kernels
    dev = _resolve(device)
    args = _join_inputs(n, dev)
    out_cap = 4 * n
    t = _timed(lambda: kernels.join_fused_impl(*args, out_cap), dev)
    return _rates({"kernel": "join_sort", "strategy": "sort", "rows": 2 * n,
                   "time_s": t, "bytes": join_bytes_model(n, n, out_cap),
                   "input_bytes": 2 * n * (8 + 1)})


def measure_hash_join(n: int = 1 << 20, device="cuda") -> Dict:
    """The hash join (``join_kernels.hash_join_impl``: the CUDA build and
    probe on a card) at the shape of :func:`measure_join`."""
    from . import join_kernels as jk
    dev = _resolve(device)
    args = _join_inputs(n, dev)
    out_cap = 4 * n
    t = _timed(lambda: jk.hash_join_impl(*args, out_cap), dev)
    return _rates({"kernel": "join_hash", "strategy": "hash", "rows": 2 * n,
                   "table_slots": jk.join_table_capacity(n), "time_s": t,
                   "bytes": hash_join_bytes_model(n, n, out_cap),
                   "input_bytes": 2 * n * (8 + 1)})


def measure_argsort(n: int = 1 << 20, n_keys: int = 2,
                    device="cuda") -> Dict:
    """The packed-key multi-key argsort (``kernels.argsort_kernel``) over
    ``n_keys`` float64 keys."""
    from . import kernels
    dev = _resolve(device)
    g = torch.Generator().manual_seed(2)
    keys = tuple((torch.rand(n, generator=g, dtype=torch.float64) * 1e6)
                 .to(dev) for _ in range(n_keys))
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    flags = (False,) * n_keys
    t = _timed(lambda: kernels.argsort_kernel(keys, (ones,) * n_keys, ones,
                                              flags, flags), dev)
    dts = [k.dtype for k in keys]
    return _rates({"kernel": "argsort_packed", "strategy": "sort",
                   "rows": n, "n_keys": n_keys, "time_s": t,
                   "bytes": argsort_bytes_model(n, dts),
                   "sort_passes": sum(argsort_pack_plan(dts)),
                   "input_bytes": n * n_keys * (8 + 1),
                   "key_rows_per_s": n * n_keys / t})


def measure_vector(n: int = 1 << 20, device="cuda") -> Dict:
    """A compiled projection (``compiler.compile_projection`` of ``x * 2 +
    y`` and ``k % 7`` over an int64, a float64 and an int32 column) on
    device-resident planes; bytes as the cost model prices a row-shaped
    op: the encoded inputs up, 8 bytes per output row down."""
    import pyarrow as pa

    from .. import col
    from ..recordbatch import RecordBatch
    from . import column as dcol
    from . import compiler
    dev = _resolve(device)
    rng = np.random.default_rng(3)
    rb = RecordBatch.from_arrow_table(pa.table({
        "k": rng.integers(0, max(n // 16, 1), n), "x": rng.random(n),
        "y": rng.integers(-1000, 1000, n).astype(np.int32)}))
    exprs = [(col("x") * 2 + col("y")).alias("z"), (col("k") % 7).alias("m")]
    # daft-lint: allow(program-not-memoized) -- a measurement harness: one
    # program per measurement, built outside the timed region
    c = compiler.compile_projection(exprs, rb.schema)
    with dcol.uncounted():
        dt = dcol.encode_batch(rb, c.needs_cols, dev)
    dcol.use_on_current_stream(dt)
    arrays = {nm: cc.data for nm, cc in dt.columns.items()}
    valids = {nm: cc.validity for nm, cc in dt.columns.items()}
    t = _timed(lambda: c.fn(arrays, valids, dt.row_mask, ()), dev)
    up = dcol.encoded_nbytes(rb, c.needs_cols)
    return _rates({"kernel": "projection", "strategy": None, "rows": n,
                   "time_s": t, "bytes": up + n * 8 * len(exprs),
                   "input_bytes": up + n * 8 * len(exprs)})


def device_name(device) -> str:
    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def report(n: int = 1 << 20, device="cuda") -> Dict:
    """Every family at ``n`` rows on ``device``, the peaks they are read
    against, and the per-dispatch ledger of real dispatches so far. A
    failure raises: there is no partial report."""
    dev = _resolve(device)
    out = {"device": device_name(dev), "peak_flops": PEAK_FLOPS,
           "hbm_bps": HBM_BPS, "rows": n,
           "method": f"{_ITERS} calls between two CUDA events after a "
                     "warm call" if dev.type == "cuda"
                     else f"{_ITERS} calls on the host clock (CPU)"}
    out["vector"] = measure_vector(n, dev)
    out["grouped_agg"] = measure_grouped_agg(n, device=dev)
    out["grouped_agg_hash"] = measure_hash_grouped_agg(n, device=dev)
    out["grouped_agg_dense"] = measure_dense_agg(n, device=dev)
    out["argsort"] = measure_argsort(n, device=dev)
    out["join"] = measure_join(n, device=dev)
    out["join_hash"] = measure_hash_join(n, device=dev)
    from . import costmodel
    out["ledger"] = costmodel.ledger_snapshot()
    return out
