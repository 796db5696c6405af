"""Port of the JAX package's `schema.py`. The type system is copied; the
dtype map gives torch dtypes, with uint64 kept as int64 bit patterns.

Table schemas and the logical type system.

TPU-native analog of the reference's TTableSchema / TColumnSchema / logical types
(yt/yt/client/table_client/schema.h, logical_type.h).  Differences by design:

  * The physical representation is columnar-first: each logical type maps onto a
    fixed-width device plane dtype (see `device_dtype`) plus a validity mask.
    Strings are order-preserving dictionary-encoded (codes on device, vocabulary
    on host) so that comparisons / grouping / sorting run on the MXU/VPU over
    integer planes — the reference's pointer-rich TUnversionedValue row layout
    (unversioned_row.h:153) would defeat XLA's static-shape compilation model.
  * Schemas are immutable and hashable so they can key compilation caches.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Optional

import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


class EValueType(enum.Enum):
    """Logical value types (subset of ref logical_type.h ESimpleLogicalValueType).

    `null` is the type of the NULL literal; `any` holds arbitrary YSON values
    (kept host-side, excluded from device planes).
    """

    null = "null"
    int64 = "int64"
    uint64 = "uint64"
    double = "double"
    boolean = "boolean"
    string = "string"
    any = "any"

    @property
    def is_numeric(self) -> bool:
        return self in (EValueType.int64, EValueType.uint64, EValueType.double)

    @property
    def is_arithmetic(self) -> bool:
        return self.is_numeric

    @property
    def is_comparable(self) -> bool:
        return self is not EValueType.any


class VectorType:
    """Parametric fixed-width float vector type: `vector<float, N>`.

    Not an EValueType member (an enum cannot carry a per-column dim), but
    duck-types its API (`value`, `is_numeric`, `is_comparable`) so the flat
    name→type namespaces, `TableSchema.make((name, ty.value))` rebuilds and
    schema dict round-trips all preserve the dim without special-casing.
    Instances are INTERNED per dim so `a is b` works wherever code compares
    EValueType members by identity; the device plane is a contiguous
    `(capacity, dim)` float32 matrix plus the usual (capacity,) validity
    mask — the matmul-ready layout NEAREST distance passes scan.
    """

    __slots__ = ("dim",)
    _interned: "dict[int, VectorType]" = {}

    def __new__(cls, dim: int):
        dim = int(dim)
        if dim <= 0:
            raise YtError(f"Vector dim must be positive, got {dim}",
                          code=EErrorCode.QueryTypeError)
        cached = cls._interned.get(dim)
        if cached is None:
            cached = super().__new__(cls)
            object.__setattr__(cached, "dim", dim)
            cls._interned[dim] = cached
        return cached

    def __setattr__(self, name, value):
        raise AttributeError("VectorType is immutable")

    def __reduce__(self):
        return (VectorType, (self.dim,))

    @property
    def value(self) -> str:
        return f"vector<float,{self.dim}>"

    @property
    def name(self) -> str:
        return "vector"

    @property
    def is_numeric(self) -> bool:
        return False

    @property
    def is_arithmetic(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        # No total order on vectors: ORDER BY / GROUP BY / key columns
        # reject them; NEAREST orders by a DISTANCE over them instead.
        return False

    def __repr__(self) -> str:
        return f"VectorType({self.dim})"

    def __hash__(self) -> int:
        return hash(("vector", self.dim))

    def __eq__(self, other) -> bool:
        return self is other


_VECTOR_TYPE_RE = re.compile(r"^vector\s*<\s*float\s*,\s*(\d+)\s*>$")


def parse_type(ty: "str | EValueType | VectorType") -> "EValueType | VectorType":
    """Parse a type spelling: EValueType values plus `vector<float,N>`."""
    if isinstance(ty, (EValueType, VectorType)):
        return ty
    m = _VECTOR_TYPE_RE.match(str(ty).strip())
    if m:
        return VectorType(int(m.group(1)))
    try:
        return EValueType(ty)
    except ValueError:
        raise YtError(f"Unknown column type {ty!r}",
                      code=EErrorCode.QueryTypeError)


_DEVICE_DTYPES = {
    EValueType.int64: torch.int64,
    # torch has no uint64 arithmetic on the CPU (no add, shift, compare
    # or scatter): uint64 planes hold the values' int64 bit patterns, and
    # the engine flips the sign bit wherever unsigned order matters.
    EValueType.uint64: torch.int64,
    EValueType.double: torch.float64,
    EValueType.boolean: torch.bool,
    # Strings live on device as int32 order-preserving dictionary codes.
    EValueType.string: torch.int32,
    # NULL literal columns carry no payload; use int8 zeros.
    EValueType.null: torch.int8,
}


def device_dtype(ty: "EValueType | VectorType") -> torch.dtype:
    """Torch dtype of the plane backing a column of logical type `ty`."""
    if isinstance(ty, VectorType):
        # A contiguous (capacity, dim) float32 matrix: the layout the
        # NEAREST distance matmul scans.
        return torch.float32
    if ty not in _DEVICE_DTYPES:
        raise YtError(f"Type {ty.value!r} has no device representation",
                      code=EErrorCode.QueryUnsupported)
    return _DEVICE_DTYPES[ty]


class SortOrder(enum.Enum):
    ascending = "ascending"
    descending = "descending"


@dataclass(frozen=True)
class ColumnSchema:
    """One column (ref: client/table_client/schema.h TColumnSchema)."""

    name: str
    type: "EValueType | VectorType"
    sort_order: Optional[SortOrder] = None
    required: bool = False
    expression: Optional[str] = None  # computed column (key evaluator)
    aggregate: Optional[str] = None   # aggregate column for dynamic tables
    lock: Optional[str] = None        # lock group for dynamic-table writes
    # Values >= this many bytes store out-of-row in hunk chunks
    # (ref TColumnSchema::MaxInlineHunkSize, client/table_client/schema.h).
    max_inline_hunk_size: Optional[int] = None

    def with_sort_order(self, order: Optional[SortOrder]) -> "ColumnSchema":
        return replace(self, sort_order=order)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "type": self.type.value}
        if self.sort_order is not None:
            d["sort_order"] = self.sort_order.value
        if self.required:
            d["required"] = True
        if self.expression is not None:
            d["expression"] = self.expression
        if self.aggregate is not None:
            d["aggregate"] = self.aggregate
        if self.lock is not None:
            d["lock"] = self.lock
        if self.max_inline_hunk_size is not None:
            d["max_inline_hunk_size"] = self.max_inline_hunk_size
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ColumnSchema":
        return cls(
            name=d["name"],
            type=parse_type(d["type"]),
            sort_order=SortOrder(d["sort_order"]) if d.get("sort_order") else None,
            required=bool(d.get("required", False)),
            expression=d.get("expression"),
            aggregate=d.get("aggregate"),
            lock=d.get("lock"),
            max_inline_hunk_size=d.get("max_inline_hunk_size"),
        )


@dataclass(frozen=True)
class TableSchema:
    """An ordered set of columns; key columns form a prefix with sort orders.

    Ref: client/table_client/schema.h TTableSchema.  `strict` means no columns
    outside the schema; `unique_keys` marks a sorted table whose key is unique
    (dynamic sorted tables require this).
    """

    columns: tuple[ColumnSchema, ...]
    strict: bool = True
    unique_keys: bool = False
    _by_name: dict[str, int] = field(default=None, repr=False, compare=False, hash=False)  # type: ignore

    def __post_init__(self):
        by_name: dict[str, int] = {}
        for i, col in enumerate(self.columns):
            if col.name in by_name:
                raise YtError(f"Duplicate column {col.name!r} in schema")
            by_name[col.name] = i
        # Key columns must form a prefix.
        seen_non_key = False
        for col in self.columns:
            if col.sort_order is None:
                seen_non_key = True
            elif seen_non_key:
                raise YtError(
                    f"Key column {col.name!r} appears after a non-key column")
            elif isinstance(col.type, VectorType):
                raise YtError(
                    f"Column {col.name!r} of type {col.type.value} cannot "
                    "be a key column (no total order on vectors)",
                    code=EErrorCode.QueryTypeError)
        object.__setattr__(self, "_by_name", by_name)

    # --- construction helpers -------------------------------------------------

    @classmethod
    def make(cls, columns: Iterable[ColumnSchema | tuple | dict],
             strict: bool = True, unique_keys: bool = False) -> "TableSchema":
        cols = []
        for c in columns:
            if isinstance(c, ColumnSchema):
                cols.append(c)
            elif isinstance(c, dict):
                cols.append(ColumnSchema.from_dict(c))
            else:  # ("name", type[, sort_order])
                name, ty = c[0], c[1]
                ty = parse_type(ty)
                so = None
                if len(c) > 2 and c[2] is not None:
                    so = SortOrder(c[2]) if not isinstance(c[2], SortOrder) else c[2]
                cols.append(ColumnSchema(name=name, type=ty, sort_order=so))
        return cls(columns=tuple(cols), strict=strict, unique_keys=unique_keys)

    # --- lookups --------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self.columns)

    def __len__(self) -> int:
        return len(self.columns)

    def find(self, name: str) -> Optional[ColumnSchema]:
        idx = self._by_name.get(name)
        return None if idx is None else self.columns[idx]

    def get(self, name: str) -> ColumnSchema:
        col = self.find(name)
        if col is None:
            raise YtError(f"No such column {name!r}",
                          code=EErrorCode.QueryTypeError)
        return col

    def index_of(self, name: str) -> int:
        idx = self._by_name.get(name)
        if idx is None:
            raise YtError(f"No such column {name!r}")
        return idx

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def key_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.sort_order is not None]

    @property
    def key_column_names(self) -> list[str]:
        return [c.name for c in self.key_columns]

    @property
    def is_sorted(self) -> bool:
        return bool(self.key_columns)

    # --- derived schemas ------------------------------------------------------

    def to_unsorted(self) -> "TableSchema":
        return TableSchema(
            columns=tuple(c.with_sort_order(None) for c in self.columns),
            strict=self.strict, unique_keys=False)

    def select(self, names: Iterable[str]) -> "TableSchema":
        """Project onto `names` in the given order.

        Sort orders survive only while the projection keeps key columns as a
        prefix in key order; the first break clears all remaining sort orders
        (mirrors ref schema projection semantics rather than raising).
        """
        names = list(names)
        cols = [self.get(n) for n in names]
        out: list[ColumnSchema] = []
        prefix_ok = True
        for i, col in enumerate(cols):
            if prefix_ok and col.sort_order is not None and \
                    i < len(self.columns) and self.columns[i].name == col.name:
                out.append(col)
            else:
                prefix_ok = False
                out.append(col.with_sort_order(None))
        return TableSchema(columns=tuple(out), strict=self.strict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "columns": [c.to_dict() for c in self.columns],
            "strict": self.strict,
            "unique_keys": self.unique_keys,
        }

    @classmethod
    def from_dict(cls, d: "dict[str, Any] | list") -> "TableSchema":
        # YT accepts a bare column list as @schema; honor that shape too.
        if isinstance(d, (list, tuple)):
            return cls.make(d)
        return cls.make(d["columns"], strict=d.get("strict", True),
                        unique_keys=d.get("unique_keys", False))
