"""Schema and type system for the Shark columnar engine.

Shark inherits Hive's schema-on-read model; we keep a small, explicit type
lattice sufficient for the paper's workloads (Pavlo benchmark, TPC-H,
warehouse logs, ML feature matrices).  Strings are always dictionary-encoded
to int32 codes at load time (the columnar-store design of §3.2): the engine
never materializes per-row string objects, mirroring how Shark avoids per-row
JVM objects.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence

import numpy as np


class DType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    STRING = "string"  # stored as int32 dictionary codes
    DATE = "date"      # stored as int32 days-since-epoch

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_NP.get(self, np.int32))

    @property
    def is_numeric(self) -> bool:
        return self in (DType.INT32, DType.INT64, DType.FLOAT32, DType.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self in (DType.INT32, DType.INT64, DType.DATE)


_NP = {
    DType.INT32: np.int32,
    DType.INT64: np.int64,
    DType.FLOAT32: np.float32,
    DType.FLOAT64: np.float64,
    DType.BOOL: np.bool_,
    DType.STRING: np.int32,
    DType.DATE: np.int32,
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DType

    def __repr__(self) -> str:
        return f"{self.name}:{self.dtype.value}"


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    @staticmethod
    def of(**kwargs: DType) -> "Schema":
        return Schema(tuple(Field(k, v) for k, v in kwargs.items()))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no column {name!r} in schema {self.names}")

    def dtype(self, name: str) -> DType:
        return self.field(name).dtype

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def concat(self, other: "Schema") -> "Schema":
        seen = set(self.names)
        extra = tuple(f for f in other.fields if f.name not in seen)
        return Schema(self.fields + extra)

    def rename_prefixed(self, prefix: str) -> "Schema":
        return Schema(tuple(Field(f"{prefix}.{f.name}", f.dtype) for f in self.fields))

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"


def common_dtype(a: DType, b: DType) -> DType:
    """Numeric type promotion for binary expressions."""
    if a == b:
        return a
    order = [DType.BOOL, DType.INT32, DType.DATE, DType.INT64, DType.FLOAT32, DType.FLOAT64]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    raise TypeError(f"incompatible dtypes {a} and {b}")


def np_value(dtype: DType, v: Any) -> Any:
    return dtype.np_dtype.type(v)
