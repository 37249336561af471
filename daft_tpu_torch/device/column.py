"""Host⇄device column transport: RecordBatch → DeviceTable and back.

The torch twin of ``daft_tpu/device/column.py``: a dict of fixed-width
tensors plus validity planes and a live-row mask, padded to a power-of-two
capacity bucket. String/binary columns ride sorted-dictionary codes, so code
order is string order. Float64 lanes stay float64 (the H100 has native f64;
the reference's f32 downcast exists only for TPUs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..series import Series

_MIN_CAPACITY = 16

#: numpy dtypes the device planes may carry. Unsigned ints wider than a
#: byte widen to the next signed type (torch's uint16/32/64 support few
#: ops); uint64 has no lossless signed twin and stays on the host.
_WIDEN = {np.dtype("uint16"): np.dtype("int32"),
          np.dtype("uint32"): np.dtype("int64")}


def bucket_capacity(n: int) -> int:
    """Pad row counts to power-of-two buckets (minimum 16)."""
    c = _MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def device_np_dtype(np_dtype) -> np.dtype:
    """The numpy dtype a plane of this numpy dtype carries on the device;
    raises ValueError for one that has no device plane."""
    d = np.dtype(np_dtype)
    d = _WIDEN.get(d, d)
    if d == np.dtype("uint64") or d.kind not in "biuf":
        raise ValueError(f"{d} has no device plane")
    return d


@dataclass
class DeviceColumn:
    data: torch.Tensor                     # [capacity]
    validity: torch.Tensor                 # [capacity] bool
    dtype: object                          # logical DataType
    dictionary: Optional[pa.Array] = None  # sorted dictionary for codes


@dataclass
class DeviceTable:
    columns: Dict[str, DeviceColumn]
    row_mask: torch.Tensor                 # [capacity] bool — live rows
    row_count: int                         # host-side live count
    capacity: int

    @property
    def device(self) -> torch.device:
        return self.row_mask.device


def _np_encode(s: Series):
    """Series → (values ndarray, validity ndarray, dictionary|None).

    Same lowering as the reference: strings become codes into their
    sorted dictionary, dates int32 days, other temporals int64, decimals
    float64; nulls fill with zero."""
    arr = s.to_arrow()
    dt = s.datatype()
    n = len(arr)
    validity = np.asarray(pc.is_valid(arr).to_numpy(zero_copy_only=False),
                          dtype=np.bool_)
    if dt.is_null():
        return np.zeros(n, dtype=np.int32), validity, None
    if dt.is_string() or dt.is_binary():
        enc = arr.dictionary_encode()
        d = enc.dictionary
        sort_idx = pc.array_sort_indices(d).to_numpy()
        ranks = np.empty(len(d), dtype=np.int32)
        ranks[sort_idx] = np.arange(len(d), dtype=np.int32)
        codes_raw = pc.fill_null(enc.indices, 0).to_numpy(
            zero_copy_only=False)
        codes = ranks[np.asarray(codes_raw, dtype=np.int64)] if len(d) \
            else np.zeros(n, dtype=np.int32)
        return codes.astype(np.int32), validity, d.take(pa.array(sort_idx))
    if dt.to_physical().device_repr() is None:
        raise ValueError(
            f"column {s.name()!r}: {dt!r} is not device-representable")
    if dt.kind == "date":
        arr = arr.cast(pa.int32())
    elif dt.is_temporal():
        arr = arr.cast(pa.int64())
    elif dt.is_decimal():
        arr = arr.cast(pa.float64())
    if dt.is_boolean():
        vals = np.asarray(pc.fill_null(arr, False).to_numpy(
            zero_copy_only=False), dtype=np.bool_)
    else:
        if not validity.all():
            # fill at the Arrow level so nullable ints don't decay to f64
            arr = pc.fill_null(arr, pa.scalar(0, type=arr.type))
        vals = np.asarray(arr.to_numpy(zero_copy_only=False))
    return vals.astype(device_np_dtype(vals.dtype), copy=False), \
        validity, None


def _pad(x: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros(capacity, dtype=x.dtype)
    out[:len(x)] = x
    return out


def encode_batch(batch, columns: Sequence[str],
                 device: torch.device) -> DeviceTable:
    """Encode the named columns of a RecordBatch onto ``device``."""
    n = len(batch)
    cap = bucket_capacity(n)
    cols = {}
    for nm in columns:
        s = batch.get_column(nm)
        vals, validity, dictionary = _np_encode(s)
        cols[nm] = DeviceColumn(
            torch.from_numpy(_pad(vals, cap)).to(device),
            torch.from_numpy(_pad(validity, cap)).to(device),
            s.datatype(), dictionary)
    mask = np.zeros(cap, dtype=np.bool_)
    mask[:n] = True
    return DeviceTable(cols, torch.from_numpy(mask).to(device), n, cap)


def from_reference_planes(arrays: Dict[str, np.ndarray],
                          valids: Dict[str, np.ndarray],
                          row_mask: np.ndarray,
                          device: torch.device,
                          dtypes: Optional[Dict[str, object]] = None,
                          dictionaries: Optional[Dict[str, pa.Array]] = None
                          ) -> DeviceTable:
    """Carry-over: the reference's encoded device planes (as numpy arrays,
    already padded to one capacity) become this package's DeviceTable, so
    both packages compute on bit-identical inputs."""
    cap = int(row_mask.shape[0])
    cols = {}
    for nm, a in arrays.items():
        a = np.ascontiguousarray(a)
        a = a.astype(device_np_dtype(a.dtype), copy=False)
        v = np.ascontiguousarray(valids[nm], dtype=np.bool_)
        if a.shape != (cap,) or v.shape != (cap,):
            raise ValueError(f"plane {nm!r} is not [{cap}]")
        cols[nm] = DeviceColumn(
            torch.from_numpy(a.copy()).to(device),
            torch.from_numpy(v.copy()).to(device),
            (dtypes or {}).get(nm), (dictionaries or {}).get(nm))
    mask = np.ascontiguousarray(row_mask, dtype=np.bool_)
    return DeviceTable(cols, torch.from_numpy(mask.copy()).to(device),
                       int(mask.sum()), cap)


def decode_np(name: str, dtype, vals: np.ndarray, validity: np.ndarray,
              dictionary: Optional[pa.Array] = None) -> Series:
    """Host-side decode of already-fetched planes → Series of the logical
    ``dtype`` (codes route through ``dictionary``)."""
    count = len(vals)
    if dtype.is_null():
        return Series(name, dtype, arrow=pa.nulls(count))
    if dictionary is not None:
        codes = np.where(validity, vals.astype(np.int64), 0)
        arr = dictionary.take(pa.array(codes, type=pa.int64()))
        if arr.type != dtype.to_arrow():
            arr = arr.cast(dtype.to_arrow())
        if not validity.all():
            arr = pc.if_else(pa.array(validity), arr,
                             pa.nulls(count, type=dtype.to_arrow()))
        return Series(name, dtype, arrow=arr)
    target = dtype.to_arrow()
    if dtype.kind == "date":
        arr = pa.array(vals.astype(np.int32), mask=~validity).cast(target)
    elif dtype.is_temporal():
        arr = pa.array(vals.astype(np.int64), mask=~validity).cast(target)
    elif dtype.is_boolean():
        arr = pa.array(vals.astype(np.bool_), mask=~validity)
    else:
        rep = dtype.device_repr()
        if rep is not None and vals.dtype != rep:
            vals = vals.astype(rep)
        arr = pa.array(vals, mask=~validity)
        if arr.type != target:
            arr = arr.cast(target)
    return Series(name, dtype, arrow=arr)
