"""Series: a named, typed column.

Capability mirror of the reference's ``daft-core`` Series
(``src/daft-core/src/series/mod.rs:32`` — type-erased column with ~60 kernel
modules), re-designed for a two-tier engine:

- **Host tier** (this file): data lives as a pyarrow Array (Arrow C++ memory —
  the survey's build plan §7.1 prescribes Arrow C++ instead of the reference's
  vendored arrow2). Variable-length and nested data is wrangled here; host
  kernels delegate to Arrow C++ compute.
- **Device tier** (``daft_tpu_torch.device``): fixed-width projections of a
  Series are encoded into torch tensors for the fused device fragments.

Python-object columns (``DataType.python()``) are stored as numpy object arrays
(the reference's "pseudo-arrow" ``src/daft-core/src/array/pseudo_arrow``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatype import DataType
from .schema import Field


def _combine(arr: Union[pa.Array, pa.ChunkedArray]) -> pa.Array:
    if isinstance(arr, pa.ChunkedArray):
        return arr.combine_chunks()
    return arr


class Series:
    """A named, typed, immutable column of values."""

    __slots__ = ("_name", "_dtype", "_arrow", "_pyobjs", "__weakref__")

    def __init__(self, name: str, dtype: DataType,
                 arrow: Optional[pa.Array] = None,
                 pyobjs: Optional[np.ndarray] = None):
        self._name = name
        self._dtype = dtype
        self._arrow = arrow
        self._pyobjs = pyobjs

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_arrow(cls, arr: Union[pa.Array, pa.ChunkedArray],
                   name: str = "arrow_series") -> "Series":
        arr = _combine(arr)
        if pa.types.is_dictionary(arr.type):
            arr = arr.dictionary_decode()
        dtype = DataType.from_arrow_type(arr.type)
        # normalize to the canonical arrow repr (e.g. string -> large_string)
        target = dtype.to_arrow()
        if arr.type != target:
            arr = arr.cast(target)
        return cls(name, dtype, arrow=arr)

    @classmethod
    def from_pylist(cls, data: Sequence[Any], name: str = "list_series",
                    dtype: Optional[DataType] = None) -> "Series":
        if dtype is not None and dtype.is_python():
            return cls.from_pyobjects(data, name)
        try:
            arr = pa.array(data, type=dtype.to_arrow() if dtype is not None else None)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError):
            return cls.from_pyobjects(data, name)
        s = cls.from_arrow(arr, name)
        if dtype is not None and s._dtype != dtype:
            s = cls(name, dtype, arrow=arr.cast(dtype.to_arrow()))
        return s

    @classmethod
    def from_pyobjects(cls, data: Sequence[Any], name: str = "py_series") -> "Series":
        objs = np.empty(len(data), dtype=object)
        for i, v in enumerate(data):
            objs[i] = v
        return cls(name, DataType.python(), pyobjs=objs)

    @classmethod
    def from_numpy(cls, arr: np.ndarray, name: str = "np_series") -> "Series":
        if arr.dtype == object:
            return cls.from_pyobjects(list(arr), name)
        if arr.ndim == 1:
            return cls.from_arrow(pa.array(arr), name)
        # [N, ...] -> fixed-shape tensor column
        inner = DataType.from_numpy_dtype(arr.dtype)
        dt = DataType.tensor(inner, tuple(arr.shape[1:]))
        flat = arr.reshape(arr.shape[0], -1)
        fsl = pa.FixedSizeListArray.from_arrays(pa.array(flat.ravel()), flat.shape[1])
        return cls(name, dt, arrow=fsl)

    @classmethod
    def empty(cls, name: str, dtype: DataType) -> "Series":
        if dtype.is_python():
            return cls(name, dtype, pyobjs=np.empty(0, dtype=object))
        return cls(name, dtype, arrow=pa.array([], type=dtype.to_arrow()))

    @classmethod
    def full_null(cls, name: str, dtype: DataType, length: int) -> "Series":
        if dtype.is_python():
            return cls(name, dtype, pyobjs=np.full(length, None, dtype=object))
        return cls(name, dtype, arrow=pa.nulls(length, type=dtype.to_arrow()))

    # ---- basic props -----------------------------------------------------
    def name(self) -> str:
        return self._name

    def datatype(self) -> DataType:
        return self._dtype

    @property
    def dtype(self) -> DataType:
        return self._dtype

    def field(self) -> Field:
        return Field(self._name, self._dtype)

    def __len__(self) -> int:
        if self._pyobjs is not None:
            return len(self._pyobjs)
        return len(self._arrow)

    def rename(self, name: str) -> "Series":
        return Series(name, self._dtype, self._arrow, self._pyobjs)

    def is_pyobject(self) -> bool:
        return self._pyobjs is not None

    # ---- conversions -----------------------------------------------------
    def to_arrow(self) -> pa.Array:
        if self._pyobjs is not None:
            raise ValueError(f"cannot convert Python-object column {self._name!r} to arrow")
        return self._arrow

    def to_pylist(self) -> List[Any]:
        if self._pyobjs is not None:
            return list(self._pyobjs)
        return self._arrow.to_pylist()

    def to_numpy(self) -> np.ndarray:
        if self._pyobjs is not None:
            return self._pyobjs
        if self._dtype.is_tensor() or self._dtype.is_embedding():
            flat = self._arrow.flatten().to_numpy(zero_copy_only=False)
            n = len(self._arrow)
            return flat.reshape(n, -1)
        return self._arrow.to_numpy(zero_copy_only=False)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    # ---- selection kernels ----------------------------------------------
    def take(self, indices: Union["Series", np.ndarray, Sequence[int]]) -> "Series":
        if isinstance(indices, Series):
            indices = indices.to_numpy()
        indices = np.asarray(indices)
        if self._pyobjs is not None:
            return Series(self._name, self._dtype, pyobjs=self._pyobjs[indices])
        return Series(self._name, self._dtype,
                      arrow=self._arrow.take(pa.array(indices)))

    def filter(self, mask: Union["Series", np.ndarray]) -> "Series":
        if isinstance(mask, Series):
            m = mask.to_arrow()
        else:
            m = pa.array(np.asarray(mask, dtype=np.bool_))
        if self._pyobjs is not None:
            keep = np.asarray(m.to_numpy(zero_copy_only=False), dtype=np.bool_)
            keep = np.where(np.isnan(keep.astype(float)), False, keep) \
                if keep.dtype != np.bool_ else keep
            return Series(self._name, self._dtype, pyobjs=self._pyobjs[keep])
        return Series(self._name, self._dtype,
                      arrow=self._arrow.filter(m, null_selection_behavior="drop"))

    def slice(self, start: int, end: int) -> "Series":
        n = len(self)
        start = max(0, min(start, n))
        end = max(start, min(end, n))
        if self._pyobjs is not None:
            return Series(self._name, self._dtype, pyobjs=self._pyobjs[start:end])
        return Series(self._name, self._dtype, arrow=self._arrow.slice(start, end - start))

    def head(self, n: int) -> "Series":
        return self.slice(0, n)

    def broadcast(self, length: int) -> "Series":
        if len(self) == length:
            return self
        if len(self) != 1:
            raise ValueError(f"cannot broadcast series of length {len(self)} to {length}")
        if self._pyobjs is not None:
            out = np.empty(length, dtype=object)
            for i in range(length):
                out[i] = self._pyobjs[0]
            return Series(self._name, self._dtype, pyobjs=out)
        return self.take(np.zeros(length, dtype=np.int64))

    @classmethod
    def concat(cls, series_list: List["Series"]) -> "Series":
        assert series_list, "concat of empty list"
        first = series_list[0]
        if any(s.is_pyobject() for s in series_list):
            objs = np.concatenate([
                s._pyobjs if s.is_pyobject() else np.array(s.to_pylist(), dtype=object)
                for s in series_list])
            return cls(first._name, DataType.python(), pyobjs=objs)
        arrays = [s.to_arrow() for s in series_list]
        # a NULL-typed piece (all-null batch) must never drive the target
        # type — casting null→anything is free, anything→null impossible
        tgt = first
        if first._dtype.is_null():
            tgt = next((s for s in series_list if not s._dtype.is_null()),
                       first)
        t = tgt._dtype.to_arrow()
        arrays = [a if a.type == t else a.cast(t) for a in arrays]
        return cls(first._name, tgt._dtype,
                   arrow=_combine(pa.chunked_array(arrays)))

    # ---- null handling ---------------------------------------------------
    def is_null(self) -> "Series":
        if self._pyobjs is not None:
            vals = np.array([v is None for v in self._pyobjs])
            return Series(self._name, DataType.bool(), arrow=pa.array(vals))
        return Series(self._name, DataType.bool(), arrow=pc.is_null(self._arrow))

    def not_null(self) -> "Series":
        if self._pyobjs is not None:
            vals = np.array([v is not None for v in self._pyobjs])
            return Series(self._name, DataType.bool(), arrow=pa.array(vals))
        return Series(self._name, DataType.bool(), arrow=pc.is_valid(self._arrow))

    def fill_null(self, fill: "Series") -> "Series":
        fv = fill.to_arrow()[0] if isinstance(fill, Series) else pa.scalar(fill)
        return Series(self._name, self._dtype, arrow=pc.fill_null(self._arrow, fv))

    def null_count(self) -> int:
        if self._pyobjs is not None:
            return sum(1 for v in self._pyobjs if v is None)
        return self._arrow.null_count

    # ---- casting ---------------------------------------------------------
    def cast(self, dtype: DataType) -> "Series":
        if dtype == self._dtype:
            return self
        if dtype.is_python():
            return Series.from_pyobjects(self.to_pylist(), self._name)
        if self._pyobjs is not None:
            return Series.from_pylist(list(self._pyobjs), self._name, dtype=dtype)
        if dtype.is_null():
            # any → null: only null values can occupy a null column
            # (pyarrow has no cast kernel for this direction)
            return Series(self._name, dtype,
                          arrow=pa.nulls(len(self._arrow)))
        target = dtype.to_arrow()
        try:
            out = self._arrow.cast(target)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            out = self._arrow.cast(target, safe=False)
        return Series(self._name, dtype, arrow=out)

    # ---- repr ------------------------------------------------------------
    def __repr__(self):
        preview = self.to_pylist()[:10]
        return f"Series[{self._name}: {self._dtype!r}] {preview}"

    def __iter__(self):
        return iter(self.to_pylist())
