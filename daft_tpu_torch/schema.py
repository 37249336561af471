"""Field and Schema (reference: ``src/daft-schema/src/{field.rs,schema.rs:26}``)."""

from __future__ import annotations

from typing import Iterator, List, Optional

import pyarrow as pa

from .datatype import DataType


class Field:
    __slots__ = ("name", "dtype", "metadata")

    def __init__(self, name: str, dtype: DataType, metadata: Optional[dict] = None):
        self.name = name
        self.dtype = dtype
        self.metadata = metadata or {}

    @classmethod
    def create(cls, name: str, dtype: DataType) -> "Field":
        return cls(name, dtype)

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.dtype.to_arrow())

    def rename(self, name: str) -> "Field":
        return Field(name, self.dtype, self.metadata)

    def __eq__(self, other):
        return (isinstance(other, Field) and self.name == other.name
                and self.dtype == other.dtype)

    def __hash__(self):
        return hash((self.name, self.dtype))

    def __repr__(self):
        return f"Field({self.name!r}, {self.dtype!r})"


class Schema:
    """An ordered mapping of column name → Field with O(1) lookup."""

    __slots__ = ("_fields", "_index")

    def __init__(self, fields: List[Field]):
        self._fields = list(fields)
        self._index = {}
        for i, f in enumerate(self._fields):
            if f.name in self._index:
                raise ValueError(f"duplicate column name in schema: {f.name!r}")
            self._index[f.name] = i

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_fields(cls, fields: List[Field]) -> "Schema":
        return cls(fields)

    @classmethod
    def from_pydict(cls, d: "dict[str, DataType]") -> "Schema":
        return cls([Field(n, t) for n, t in d.items()])

    @classmethod
    def from_arrow(cls, s: pa.Schema) -> "Schema":
        return cls([Field(f.name, DataType.from_arrow_type(f.type)) for f in s])

    @classmethod
    def empty(cls) -> "Schema":
        return cls([])

    # ---- access ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self._fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, key) -> Field:
        if isinstance(key, int):
            return self._fields[key]
        return self._fields[self._index[key]]

    def index_of(self, name: str) -> int:
        return self._index[name]

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self._fields]

    @property
    def fields(self) -> List[Field]:
        return list(self._fields)

    def to_pydict(self) -> "dict[str, DataType]":
        return {f.name: f.dtype for f in self._fields}

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self._fields])

    # ---- algebra ---------------------------------------------------------
    def union(self, other: "Schema") -> "Schema":
        """Disjoint union; raises on duplicate names."""
        return Schema(self._fields + other._fields)

    def non_distinct_union(self, other: "Schema") -> "Schema":
        """Union keeping left field on name clash (reference: schema.rs non_distinct_union)."""
        fields = list(self._fields)
        for f in other._fields:
            if f.name not in self._index:
                fields.append(f)
        return Schema(fields)

    def project(self, names: List[str]) -> "Schema":
        return Schema([self[n] for n in names])

    def exclude(self, names: List[str]) -> "Schema":
        drop = set(names)
        return Schema([f for f in self._fields if f.name not in drop])

    def estimate_row_size_bytes(self) -> float:
        """Rough per-row byte estimate for scan-task sizing."""
        total = 0.0
        for f in self._fields:
            d = f.dtype.device_repr()
            total += d.itemsize if d is not None else 32.0
        return max(total, 1.0)

    def __eq__(self, other):
        return isinstance(other, Schema) and self._fields == other._fields

    def __hash__(self):
        return hash(tuple(self._fields))

    def __repr__(self):
        inner = ", ".join(f"{f.name}: {f.dtype!r}" for f in self._fields)
        return f"Schema({inner})"

    def _repr_html_(self):
        rows = "".join(
            f"<tr><td>{f.name}</td><td>{f.dtype!r}</td></tr>" for f in self._fields)
        return f"<table><tr><th>name</th><th>dtype</th></tr>{rows}</table>"
