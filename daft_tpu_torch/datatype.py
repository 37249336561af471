"""DataType system for the dataframe engine.

Mirrors the capability surface of the reference's ``daft-schema`` crate
(``src/daft-schema/src/dtype.rs:13-157`` — the 34-variant ``DataType`` enum with
multimodal types, and ``dtype.rs:307-335`` — the logical→physical lowering where
``Image`` lowers to a struct of (data, channel, height, width, mode) and ``Tensor``
lowers to a struct of (data, shape)), designed for a two-tier substrate:

- every type knows its **Arrow** representation (host columnar memory, pyarrow) and
  its **device** representation (how it lowers onto the accelerator as fixed-width
  arrays — fixed-width primitives map directly; strings/binary dictionary-encode to
  int32 codes; nested/multimodal types stay host-resident unless fixed-shape).
"""

from __future__ import annotations

import builtins
from enum import Enum
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa


class ImageMode(Enum):
    """Supported image modes (reference: ``src/daft-schema/src/image_mode.rs``)."""

    L = 1
    LA = 2
    RGB = 3
    RGBA = 4
    L16 = 5
    LA16 = 6
    RGB16 = 7
    RGBA16 = 8
    RGB32F = 9
    RGBA32F = 10

    @property
    def num_channels(self) -> int:
        return {
            ImageMode.L: 1, ImageMode.LA: 2, ImageMode.RGB: 3, ImageMode.RGBA: 4,
            ImageMode.L16: 1, ImageMode.LA16: 2, ImageMode.RGB16: 3,
            ImageMode.RGBA16: 4, ImageMode.RGB32F: 3, ImageMode.RGBA32F: 4,
        }[self]

    @property
    def np_dtype(self) -> np.dtype:
        if self in (ImageMode.L, ImageMode.LA, ImageMode.RGB, ImageMode.RGBA):
            return np.dtype(np.uint8)
        if self in (ImageMode.L16, ImageMode.LA16, ImageMode.RGB16, ImageMode.RGBA16):
            return np.dtype(np.uint16)
        return np.dtype(np.float32)

    @classmethod
    def from_mode_string(cls, s: str) -> "ImageMode":
        return cls[s.upper()]


class ImageFormat(Enum):
    PNG = "PNG"
    JPEG = "JPEG"
    TIFF = "TIFF"
    GIF = "GIF"
    BMP = "BMP"

    @classmethod
    def from_format_string(cls, s: str) -> "ImageFormat":
        return cls[s.upper()]


class TimeUnit(Enum):
    s = "s"
    ms = "ms"
    us = "us"
    ns = "ns"

    @classmethod
    def from_str(cls, s: str) -> "TimeUnit":
        return cls[s]


class _Kind(Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL128 = "decimal128"
    STRING = "string"
    BINARY = "binary"
    FIXED_SIZE_BINARY = "fixed_size_binary"
    DATE = "date"
    TIME = "time"
    TIMESTAMP = "timestamp"
    DURATION = "duration"
    INTERVAL = "interval"
    LIST = "list"
    FIXED_SIZE_LIST = "fixed_size_list"
    STRUCT = "struct"
    MAP = "map"
    EMBEDDING = "embedding"
    IMAGE = "image"
    FIXED_SHAPE_IMAGE = "fixed_shape_image"
    TENSOR = "tensor"
    FIXED_SHAPE_TENSOR = "fixed_shape_tensor"
    SPARSE_TENSOR = "sparse_tensor"
    FIXED_SHAPE_SPARSE_TENSOR = "fixed_shape_sparse_tensor"
    PYTHON = "python"
    EXTENSION = "extension"
    UNKNOWN = "unknown"


_NUMERIC_KINDS = {
    _Kind.INT8, _Kind.INT16, _Kind.INT32, _Kind.INT64,
    _Kind.UINT8, _Kind.UINT16, _Kind.UINT32, _Kind.UINT64,
    _Kind.FLOAT32, _Kind.FLOAT64, _Kind.DECIMAL128,
}
_INTEGER_KINDS = {
    _Kind.INT8, _Kind.INT16, _Kind.INT32, _Kind.INT64,
    _Kind.UINT8, _Kind.UINT16, _Kind.UINT32, _Kind.UINT64,
}
_TEMPORAL_KINDS = {_Kind.DATE, _Kind.TIME, _Kind.TIMESTAMP, _Kind.DURATION}


class DataType:
    """A logical column datatype.

    Construct via classmethods: ``DataType.int64()``, ``DataType.list(inner)``,
    ``DataType.image("RGB")`` etc. Instances are immutable and hashable.
    """

    __slots__ = ("_kind", "_params")

    def __init__(self, kind: _Kind, params: Tuple = ()):  # internal
        object.__setattr__(self, "_kind", kind)
        object.__setattr__(self, "_params", params)

    def __setattr__(self, k, v):
        raise AttributeError("DataType is immutable")

    def __reduce__(self):
        # __slots__ + blocked __setattr__ breaks default (cloud)pickle
        # state restoration; rebuild through __init__ instead
        return (DataType, (self._kind, self._params))

    # ---- constructors ----------------------------------------------------
    @classmethod
    def null(cls): return cls(_Kind.NULL)
    @classmethod
    def bool(cls): return cls(_Kind.BOOL)
    @classmethod
    def int8(cls): return cls(_Kind.INT8)
    @classmethod
    def int16(cls): return cls(_Kind.INT16)
    @classmethod
    def int32(cls): return cls(_Kind.INT32)
    @classmethod
    def int64(cls): return cls(_Kind.INT64)
    @classmethod
    def uint8(cls): return cls(_Kind.UINT8)
    @classmethod
    def uint16(cls): return cls(_Kind.UINT16)
    @classmethod
    def uint32(cls): return cls(_Kind.UINT32)
    @classmethod
    def uint64(cls): return cls(_Kind.UINT64)
    @classmethod
    def float32(cls): return cls(_Kind.FLOAT32)
    @classmethod
    def float64(cls): return cls(_Kind.FLOAT64)

    @classmethod
    def decimal128(cls, precision: int, scale: int):
        return cls(_Kind.DECIMAL128, (precision, scale))

    @classmethod
    def string(cls): return cls(_Kind.STRING)
    @classmethod
    def binary(cls): return cls(_Kind.BINARY)

    @classmethod
    def fixed_size_binary(cls, size: int):
        return cls(_Kind.FIXED_SIZE_BINARY, (size,))

    @classmethod
    def date(cls): return cls(_Kind.DATE)

    @classmethod
    def time(cls, timeunit: "TimeUnit | str" = TimeUnit.us):
        tu = TimeUnit.from_str(timeunit) if isinstance(timeunit, str) else timeunit
        return cls(_Kind.TIME, (tu,))

    @classmethod
    def timestamp(cls, timeunit: "TimeUnit | str" = TimeUnit.us,
                  timezone: Optional[str] = None):
        tu = TimeUnit.from_str(timeunit) if isinstance(timeunit, str) else timeunit
        return cls(_Kind.TIMESTAMP, (tu, timezone))

    @classmethod
    def duration(cls, timeunit: "TimeUnit | str" = TimeUnit.us):
        tu = TimeUnit.from_str(timeunit) if isinstance(timeunit, str) else timeunit
        return cls(_Kind.DURATION, (tu,))

    @classmethod
    def interval(cls): return cls(_Kind.INTERVAL)

    @classmethod
    def list(cls, dtype: "DataType"):
        return cls(_Kind.LIST, (dtype,))

    @classmethod
    def fixed_size_list(cls, dtype: "DataType", size: int):
        return cls(_Kind.FIXED_SIZE_LIST, (dtype, size))

    @classmethod
    def struct(cls, fields: "dict[str, DataType]"):
        return cls(_Kind.STRUCT, (tuple(sorted_items(fields)),))

    @classmethod
    def map(cls, key_type: "DataType", value_type: "DataType"):
        return cls(_Kind.MAP, (key_type, value_type))

    @classmethod
    def embedding(cls, dtype: "DataType", size: int):
        return cls(_Kind.EMBEDDING, (dtype, size))

    @classmethod
    def image(cls, mode: "str | ImageMode | None" = None):
        m = ImageMode.from_mode_string(mode) if isinstance(mode, str) else mode
        return cls(_Kind.IMAGE, (m,))

    @classmethod
    def fixed_shape_image(cls, mode: "str | ImageMode", height: int, width: int):
        m = ImageMode.from_mode_string(mode) if isinstance(mode, str) else mode
        return cls(_Kind.FIXED_SHAPE_IMAGE, (m, height, width))

    @classmethod
    def tensor(cls, dtype: "DataType", shape: Optional[Tuple[int, ...]] = None):
        if shape is not None:
            return cls(_Kind.FIXED_SHAPE_TENSOR, (dtype, tuple(shape)))
        return cls(_Kind.TENSOR, (dtype,))

    @classmethod
    def sparse_tensor(cls, dtype: "DataType", shape: Optional[Tuple[int, ...]] = None,
                      use_offset_indices: builtins.bool = False):
        if shape is not None:
            return cls(_Kind.FIXED_SHAPE_SPARSE_TENSOR,
                       (dtype, tuple(shape), use_offset_indices))
        return cls(_Kind.SPARSE_TENSOR, (dtype, use_offset_indices))

    @classmethod
    def python(cls): return cls(_Kind.PYTHON)

    @classmethod
    def extension(cls, name: str, storage: "DataType", metadata: Optional[str] = None):
        return cls(_Kind.EXTENSION, (name, storage, metadata))

    # ---- inspection ------------------------------------------------------
    @property
    def kind(self) -> str:
        return self._kind.value

    def is_null(self): return self._kind == _Kind.NULL
    def is_boolean(self): return self._kind == _Kind.BOOL
    def is_numeric(self): return self._kind in _NUMERIC_KINDS
    def is_integer(self): return self._kind in _INTEGER_KINDS

    def is_signed_integer(self):
        return self._kind in (_Kind.INT8, _Kind.INT16, _Kind.INT32, _Kind.INT64)

    def is_unsigned_integer(self):
        return self._kind in (_Kind.UINT8, _Kind.UINT16, _Kind.UINT32, _Kind.UINT64)

    def is_floating(self):
        return self._kind in (_Kind.FLOAT32, _Kind.FLOAT64)

    def is_temporal(self): return self._kind in _TEMPORAL_KINDS
    def is_string(self): return self._kind == _Kind.STRING
    def is_binary(self): return self._kind == _Kind.BINARY
    def is_list(self): return self._kind in (_Kind.LIST, _Kind.FIXED_SIZE_LIST)
    def is_struct(self): return self._kind == _Kind.STRUCT
    def is_map(self): return self._kind == _Kind.MAP
    def is_python(self): return self._kind == _Kind.PYTHON
    def is_decimal(self): return self._kind == _Kind.DECIMAL128

    def is_image(self):
        return self._kind in (_Kind.IMAGE, _Kind.FIXED_SHAPE_IMAGE)

    def is_tensor(self):
        return self._kind in (_Kind.TENSOR, _Kind.FIXED_SHAPE_TENSOR)

    def is_sparse_tensor(self):
        return self._kind in (_Kind.SPARSE_TENSOR, _Kind.FIXED_SHAPE_SPARSE_TENSOR)

    def is_embedding(self): return self._kind == _Kind.EMBEDDING

    def is_nested(self):
        return self._kind in (
            _Kind.LIST, _Kind.FIXED_SIZE_LIST, _Kind.STRUCT, _Kind.MAP,
            _Kind.EMBEDDING, _Kind.IMAGE, _Kind.FIXED_SHAPE_IMAGE, _Kind.TENSOR,
            _Kind.FIXED_SHAPE_TENSOR, _Kind.SPARSE_TENSOR,
            _Kind.FIXED_SHAPE_SPARSE_TENSOR,
        )

    @property
    def inner(self) -> "DataType":
        """Element type of list/fixed-size-list/embedding/tensor types."""
        if self._kind in (_Kind.LIST, _Kind.FIXED_SIZE_LIST, _Kind.EMBEDDING,
                          _Kind.TENSOR, _Kind.FIXED_SHAPE_TENSOR,
                          _Kind.SPARSE_TENSOR, _Kind.FIXED_SHAPE_SPARSE_TENSOR):
            return self._params[0]
        raise ValueError(f"{self} has no inner type")

    @property
    def size(self) -> int:
        if self._kind in (_Kind.FIXED_SIZE_LIST, _Kind.EMBEDDING):
            return self._params[1]
        if self._kind == _Kind.FIXED_SIZE_BINARY:
            return self._params[0]
        raise ValueError(f"{self} has no fixed size")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._kind == _Kind.FIXED_SHAPE_TENSOR:
            return self._params[1]
        if self._kind == _Kind.FIXED_SHAPE_IMAGE:
            return self._params[1:]
        raise ValueError(f"{self} has no fixed shape")

    @property
    def image_mode(self) -> Optional[ImageMode]:
        if self._kind in (_Kind.IMAGE, _Kind.FIXED_SHAPE_IMAGE):
            return self._params[0]
        raise ValueError(f"{self} is not an image type")

    @property
    def precision(self) -> int:
        assert self._kind == _Kind.DECIMAL128
        return self._params[0]

    @property
    def scale(self) -> int:
        assert self._kind == _Kind.DECIMAL128
        return self._params[1]

    @property
    def timeunit(self) -> TimeUnit:
        assert self._kind in (_Kind.TIME, _Kind.TIMESTAMP, _Kind.DURATION)
        return self._params[0]

    @property
    def timezone(self) -> Optional[str]:
        assert self._kind == _Kind.TIMESTAMP
        return self._params[1]

    @property
    def fields(self) -> "dict[str, DataType]":
        assert self._kind == _Kind.STRUCT
        return dict(self._params[0])

    # ---- physical lowering ----------------------------------------------
    def to_physical(self) -> "DataType":
        """Lower a logical type to its physical storage type.

        Mirrors the mapping in the reference (``dtype.rs:307-335``): Image →
        Struct{data: List[u8|u16|f32], channel/height/width: u16, mode: u8};
        Tensor → Struct{data: List[inner], shape: List[u64]}; Embedding →
        FixedSizeList; Date → int32; Timestamp/Duration/Time → int64.
        """
        k = self._kind
        if k == _Kind.DATE:
            return DataType.int32()
        if k in (_Kind.TIMESTAMP, _Kind.DURATION, _Kind.TIME):
            return DataType.int64()
        if k == _Kind.EMBEDDING:
            return DataType.fixed_size_list(self._params[0].to_physical(), self._params[1])
        if k == _Kind.IMAGE:
            mode = self._params[0]
            data_dt = (DataType.from_numpy_dtype(mode.np_dtype)
                       if mode is not None else DataType.uint8())
            return DataType.struct({
                "data": DataType.list(data_dt),
                "channel": DataType.uint16(),
                "height": DataType.uint32(),
                "width": DataType.uint32(),
                "mode": DataType.uint8(),
            })
        if k == _Kind.FIXED_SHAPE_IMAGE:
            mode, h, w = self._params
            return DataType.fixed_size_list(
                DataType.from_numpy_dtype(mode.np_dtype), h * w * mode.num_channels)
        if k == _Kind.TENSOR:
            return DataType.struct({
                "data": DataType.list(self._params[0].to_physical()),
                "shape": DataType.list(DataType.uint64()),
            })
        if k == _Kind.FIXED_SHAPE_TENSOR:
            dt, shape = self._params
            n = int(np.prod(shape)) if shape else 1
            return DataType.fixed_size_list(dt.to_physical(), n)
        if k == _Kind.SPARSE_TENSOR:
            return DataType.struct({
                "values": DataType.list(self._params[0].to_physical()),
                "indices": DataType.list(DataType.uint64()),
                "shape": DataType.list(DataType.uint64()),
            })
        if k == _Kind.FIXED_SHAPE_SPARSE_TENSOR:
            return DataType.struct({
                "values": DataType.list(self._params[0].to_physical()),
                "indices": DataType.list(DataType.uint64()),
            })
        if k == _Kind.EXTENSION:
            return self._params[1].to_physical()
        return self

    # ---- device lowering -------------------------------------------------
    def device_repr(self) -> Optional[np.dtype]:
        """The numpy dtype this column uses on the device, or None if host-only.

        Strings/binary lower to int32 dictionary codes; bool stays bool;
        temporal types lower via to_physical; nested/python stay on host
        (None) except fixed-shape tensors/embeddings which lower to [N, prod]
        arrays of their inner dtype.
        """
        k = self._kind
        if k in (_Kind.STRING, _Kind.BINARY):
            return np.dtype(np.int32)  # dictionary code plane
        if k == _Kind.BOOL:
            return np.dtype(np.bool_)
        if k == _Kind.NULL:
            return np.dtype(np.bool_)
        if self.is_numeric() and k != _Kind.DECIMAL128:
            return np.dtype(self.kind)
        if k == _Kind.DECIMAL128:
            return np.dtype(np.float64)  # approximate device compute plane
        if self.is_temporal():
            return self.to_physical().device_repr()
        if k in (_Kind.EMBEDDING, _Kind.FIXED_SHAPE_TENSOR, _Kind.FIXED_SHAPE_IMAGE):
            inner = self._params[0]
            if k == _Kind.FIXED_SHAPE_IMAGE:
                return self._params[0].np_dtype
            return inner.device_repr()
        return None

    def is_device_representable(self) -> builtins.bool:
        return self.device_repr() is not None

    # ---- arrow interop ---------------------------------------------------
    def to_arrow(self) -> pa.DataType:
        k = self._kind
        simple = {
            _Kind.NULL: pa.null(), _Kind.BOOL: pa.bool_(),
            _Kind.INT8: pa.int8(), _Kind.INT16: pa.int16(),
            _Kind.INT32: pa.int32(), _Kind.INT64: pa.int64(),
            _Kind.UINT8: pa.uint8(), _Kind.UINT16: pa.uint16(),
            _Kind.UINT32: pa.uint32(), _Kind.UINT64: pa.uint64(),
            _Kind.FLOAT32: pa.float32(), _Kind.FLOAT64: pa.float64(),
            _Kind.STRING: pa.large_string(), _Kind.BINARY: pa.large_binary(),
            _Kind.DATE: pa.date32(),
        }
        if k in simple:
            return simple[k]
        if k == _Kind.DECIMAL128:
            return pa.decimal128(*self._params)
        if k == _Kind.FIXED_SIZE_BINARY:
            return pa.binary(self._params[0])
        if k == _Kind.TIME:
            return pa.time64(self._params[0].value)
        if k == _Kind.TIMESTAMP:
            return pa.timestamp(self._params[0].value, tz=self._params[1])
        if k == _Kind.DURATION:
            return pa.duration(self._params[0].value)
        if k == _Kind.INTERVAL:
            return pa.month_day_nano_interval()
        if k == _Kind.LIST:
            return pa.large_list(self._params[0].to_arrow())
        if k == _Kind.FIXED_SIZE_LIST:
            return pa.list_(self._params[0].to_arrow(), self._params[1])
        if k == _Kind.STRUCT:
            return pa.struct([(n, t.to_arrow()) for n, t in self._params[0]])
        if k == _Kind.MAP:
            return pa.map_(self._params[0].to_arrow(), self._params[1].to_arrow())
        if k in (_Kind.EMBEDDING, _Kind.IMAGE, _Kind.FIXED_SHAPE_IMAGE, _Kind.TENSOR,
                 _Kind.FIXED_SHAPE_TENSOR, _Kind.SPARSE_TENSOR,
                 _Kind.FIXED_SHAPE_SPARSE_TENSOR):
            return self.to_physical().to_arrow()
        if k == _Kind.EXTENSION:
            return self._params[1].to_arrow()
        raise NotImplementedError(f"to_arrow for {self}")

    @classmethod
    def from_arrow_type(cls, t: pa.DataType) -> "DataType":
        if pa.types.is_null(t): return cls.null()
        if pa.types.is_boolean(t): return cls.bool()
        if pa.types.is_int8(t): return cls.int8()
        if pa.types.is_int16(t): return cls.int16()
        if pa.types.is_int32(t): return cls.int32()
        if pa.types.is_int64(t): return cls.int64()
        if pa.types.is_uint8(t): return cls.uint8()
        if pa.types.is_uint16(t): return cls.uint16()
        if pa.types.is_uint32(t): return cls.uint32()
        if pa.types.is_uint64(t): return cls.uint64()
        if pa.types.is_float16(t): return cls.float32()
        if pa.types.is_float32(t): return cls.float32()
        if pa.types.is_float64(t): return cls.float64()
        if pa.types.is_decimal(t): return cls.decimal128(t.precision, t.scale)
        if pa.types.is_string(t) or pa.types.is_large_string(t) or \
           pa.types.is_string_view(t):
            return cls.string()
        if pa.types.is_fixed_size_binary(t): return cls.fixed_size_binary(t.byte_width)
        if pa.types.is_binary(t) or pa.types.is_large_binary(t) or \
           pa.types.is_binary_view(t):
            return cls.binary()
        if pa.types.is_date32(t) or pa.types.is_date64(t): return cls.date()
        if pa.types.is_time32(t) or pa.types.is_time64(t):
            return cls.time(TimeUnit.from_str(t.unit) if t.unit in ("us", "ns") else TimeUnit.us)
        if pa.types.is_timestamp(t): return cls.timestamp(TimeUnit.from_str(t.unit), t.tz)
        if pa.types.is_duration(t): return cls.duration(TimeUnit.from_str(t.unit))
        if pa.types.is_interval(t): return cls.interval()
        if pa.types.is_fixed_size_list(t):
            return cls.fixed_size_list(cls.from_arrow_type(t.value_type), t.list_size)
        if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_list_view(t):
            return cls.from_arrow_type(t.value_type).as_list()
        if pa.types.is_map(t):
            return cls.map(cls.from_arrow_type(t.key_type), cls.from_arrow_type(t.item_type))
        if pa.types.is_struct(t):
            return cls.struct({f.name: cls.from_arrow_type(f.type) for f in t})
        if pa.types.is_dictionary(t):
            return cls.from_arrow_type(t.value_type)
        raise NotImplementedError(f"from_arrow_type for {t}")

    def as_list(self) -> "DataType":
        return DataType.list(self)

    @classmethod
    def from_numpy_dtype(cls, dt) -> "DataType":
        dt = np.dtype(dt)
        m = {
            "b": cls.bool, "i1": cls.int8, "i2": cls.int16, "i4": cls.int32,
            "i8": cls.int64, "u1": cls.uint8, "u2": cls.uint16, "u4": cls.uint32,
            "u8": cls.uint64, "f4": cls.float32, "f8": cls.float64,
        }
        key = dt.kind if dt.kind == "b" else dt.kind + str(dt.itemsize)
        if key in m:
            return m[key]()
        if dt.kind == "U" or dt.kind == "O":
            return cls.string()
        if dt.kind == "M":
            return cls.timestamp(TimeUnit.us)
        raise NotImplementedError(f"from_numpy_dtype for {dt}")

    @classmethod
    def infer_from_pylist(cls, values) -> "DataType":
        arr = pa.array(values)
        return cls.from_arrow_type(arr.type)

    # ---- dunder ----------------------------------------------------------
    def __eq__(self, other):
        return (isinstance(other, DataType) and self._kind == other._kind
                and self._params == other._params)

    def __hash__(self):
        return hash((self._kind, self._params))

    def __repr__(self):
        k = self._kind
        if not self._params:
            return k.value.capitalize() if k != _Kind.NULL else "Null"
        if k == _Kind.DECIMAL128:
            return f"Decimal128({self._params[0]}, {self._params[1]})"
        if k == _Kind.LIST:
            return f"List[{self._params[0]!r}]"
        if k == _Kind.FIXED_SIZE_LIST:
            return f"FixedSizeList[{self._params[0]!r}; {self._params[1]}]"
        if k == _Kind.STRUCT:
            inner = ", ".join(f"{n}: {t!r}" for n, t in self._params[0])
            return f"Struct[{inner}]"
        if k == _Kind.MAP:
            return f"Map[{self._params[0]!r}: {self._params[1]!r}]"
        if k == _Kind.EMBEDDING:
            return f"Embedding[{self._params[0]!r}; {self._params[1]}]"
        if k == _Kind.IMAGE:
            m = self._params[0]
            return f"Image[{m.name}]" if m else "Image[MIXED]"
        if k == _Kind.FIXED_SHAPE_IMAGE:
            m, h, w = self._params
            return f"Image[{m.name}; {h} x {w}]"
        if k == _Kind.TENSOR:
            return f"Tensor({self._params[0]!r})"
        if k == _Kind.FIXED_SHAPE_TENSOR:
            return f"FixedShapeTensor[{self._params[0]!r}; {self._params[1]}]"
        if k == _Kind.TIMESTAMP:
            return f"Timestamp({self._params[0].value}, {self._params[1]})"
        if k in (_Kind.TIME, _Kind.DURATION):
            return f"{k.value.capitalize()}({self._params[0].value})"
        return f"{k.value}({self._params})"


def sorted_items(d: "dict[str, DataType]"):
    # struct fields keep insertion order (like the reference's IndexMap)
    return tuple(d.items())
