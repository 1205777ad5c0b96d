"""Column type system.

The reference relies on PostgreSQL's type system; the TPU build needs a
closed, fixed-width set of physical types because XLA requires static shapes
and dtypes.  Variable-width SQL types (TEXT/VARCHAR) are dictionary-encoded:
device arrays carry int32 codes, raw bytes stay host-side in the per-column
dictionary (late materialization), mirroring how the columnar engine in
Citus src/backend/columnar stores per-chunk value streams separately
from scan output.

DECIMAL(p, s) is carried as float64 on host.  The device compute dtype is a
session policy (`compute_dtype` config): float32 for TPU speed (MXU/VPU native)
or float64 for exactness on CPU test meshes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TypeClass(enum.Enum):
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    DATE = "date"
    STRING = "string"


class DataType(enum.Enum):
    """Physical column types."""

    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    DATE = "date"      # int32 days since 1970-01-01
    STRING = "string"  # dictionary-encoded: int32 code + host dictionary

    @property
    def type_class(self) -> TypeClass:
        return _TYPE_CLASS[self]

    @property
    def numpy_dtype(self) -> np.dtype:
        return _NUMPY_DTYPE[self]

    @property
    def is_numeric(self) -> bool:
        return self.type_class in (TypeClass.INT, TypeClass.FLOAT)

    @property
    def fixed_width(self) -> int:
        """Bytes per value in the storage format (codes for STRING)."""
        return _NUMPY_DTYPE[self].itemsize


_TYPE_CLASS = {
    DataType.INT32: TypeClass.INT,
    DataType.INT64: TypeClass.INT,
    DataType.FLOAT32: TypeClass.FLOAT,
    DataType.FLOAT64: TypeClass.FLOAT,
    DataType.BOOL: TypeClass.BOOL,
    DataType.DATE: TypeClass.DATE,
    DataType.STRING: TypeClass.STRING,
}

_NUMPY_DTYPE = {
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FLOAT32: np.dtype(np.float32),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.BOOL: np.dtype(np.bool_),
    DataType.DATE: np.dtype(np.int32),
    DataType.STRING: np.dtype(np.int32),
}


# SQL type-name → DataType mapping used by the DDL layer
# (CREATE TABLE ... ). DECIMAL/NUMERIC map to FLOAT64 storage.
_SQL_NAME_MAP = {
    "int": DataType.INT32,
    "integer": DataType.INT32,
    "int4": DataType.INT32,
    "smallint": DataType.INT32,
    "bigint": DataType.INT64,
    "int8": DataType.INT64,
    "real": DataType.FLOAT32,
    "float4": DataType.FLOAT32,
    "float": DataType.FLOAT64,
    "float8": DataType.FLOAT64,
    "double": DataType.FLOAT64,
    "decimal": DataType.FLOAT64,
    "numeric": DataType.FLOAT64,
    "bool": DataType.BOOL,
    "boolean": DataType.BOOL,
    "date": DataType.DATE,
    "text": DataType.STRING,
    "varchar": DataType.STRING,
    "char": DataType.STRING,
    "bpchar": DataType.STRING,
}


def sql_type_to_datatype(name: str) -> DataType:
    base = name.strip().lower()
    # strip parenthesized typmods: varchar(44), decimal(15,2), double precision
    if "(" in base:
        base = base[: base.index("(")].strip()
    if base == "double precision":
        base = "double"
    if base.startswith("character varying"):
        base = "varchar"
    elif base.startswith("character"):
        base = "char"
    if base not in _SQL_NAME_MAP:
        from .errors import CatalogError

        raise CatalogError(f"unsupported SQL type: {name!r}")
    return _SQL_NAME_MAP[base]


@dataclass(frozen=True)
class ColumnDef:
    """One column of a table schema."""

    name: str
    dtype: DataType
    nullable: bool = True

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype.value, "nullable": self.nullable}

    @staticmethod
    def from_json(obj: dict) -> "ColumnDef":
        return ColumnDef(obj["name"], DataType(obj["dtype"]), obj.get("nullable", True))


@dataclass(frozen=True)
class TableSchema:
    """Ordered column list; the unit the catalog and storage layers share."""

    columns: tuple[ColumnDef, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            from .errors import CatalogError

            raise CatalogError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> ColumnDef:
        for c in self.columns:
            if c.name == name:
                return c
        from .errors import CatalogError

        raise CatalogError(f"column {name!r} does not exist")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        from .errors import CatalogError

        raise CatalogError(f"column {name!r} does not exist")

    def to_json(self) -> list:
        return [c.to_json() for c in self.columns]

    @staticmethod
    def from_json(obj: list) -> "TableSchema":
        return TableSchema(tuple(ColumnDef.from_json(c) for c in obj))


def date_to_days(text: str) -> int:
    """'1995-03-15' → int32 days since epoch."""
    import datetime

    d = datetime.date.fromisoformat(text.strip())
    return (d - datetime.date(1970, 1, 1)).days


def days_to_date(days: int) -> str:
    import datetime

    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))).isoformat()
