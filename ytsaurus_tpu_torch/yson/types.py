"""YSON object model: plain Python values + attribute-bearing wrappers.

Ref: yt/yt/core/yson + core/ytree node model.  Values map to Python as
  int64/uint64 → int (YsonUint64 marks the unsigned flavor)
  double → float;  boolean → bool;  string → bytes (YsonString) or str
  entity (#) → None / YsonEntity;  map → dict;  list → list
Any node can carry attributes (`<a=1>value`); wrappers expose `.attributes`.
"""

from __future__ import annotations


class YsonType:
    """Mixin: YSON node with attributes."""
    attributes: dict

    def has_attributes(self) -> bool:
        return bool(getattr(self, "attributes", None))


class YsonString(bytes, YsonType):
    def __new__(cls, value=b"", attributes=None):
        obj = super().__new__(cls, value)
        obj.attributes = dict(attributes or {})
        return obj


class YsonUnicode(str, YsonType):
    def __new__(cls, value="", attributes=None):
        obj = super().__new__(cls, value)
        obj.attributes = dict(attributes or {})
        return obj


class YsonInt64(int, YsonType):
    def __new__(cls, value=0, attributes=None):
        obj = super().__new__(cls, value)
        obj.attributes = dict(attributes or {})
        return obj


class YsonUint64(int, YsonType):
    def __new__(cls, value=0, attributes=None):
        if not (0 <= int(value) < 2**64):
            raise ValueError(f"uint64 out of range: {value}")
        obj = super().__new__(cls, value)
        obj.attributes = dict(attributes or {})
        return obj


class YsonDouble(float, YsonType):
    def __new__(cls, value=0.0, attributes=None):
        obj = super().__new__(cls, value)
        obj.attributes = dict(attributes or {})
        return obj


class YsonBoolean(int, YsonType):
    """bool is not subclassable; YsonBoolean(1)/YsonBoolean(0) with bool
    equality semantics."""

    def __new__(cls, value=False, attributes=None):
        obj = super().__new__(cls, 1 if value else 0)
        obj.attributes = dict(attributes or {})
        return obj

    def __repr__(self):
        return "YsonBoolean(%s)" % bool(self)


class YsonList(list, YsonType):
    def __init__(self, value=(), attributes=None):
        super().__init__(value)
        self.attributes = dict(attributes or {})


class YsonMap(dict, YsonType):
    def __init__(self, value=(), attributes=None):
        super().__init__(value)
        self.attributes = dict(attributes or {})


class YsonEntity(YsonType):
    def __init__(self, attributes=None):
        self.attributes = dict(attributes or {})

    def __eq__(self, other):
        return other is None or isinstance(other, YsonEntity)

    def __hash__(self):
        return hash(None)

    def __bool__(self):
        return False

    def __repr__(self):
        return "YsonEntity(%r)" % self.attributes


def get_attributes(value) -> dict:
    return getattr(value, "attributes", None) or {}


def to_yson_type(value, attributes=None):
    """Wrap a plain value so it can carry attributes."""
    if attributes is None:
        return value
    if value is None:
        return YsonEntity(attributes)
    if isinstance(value, bool):
        return YsonBoolean(value, attributes)
    if isinstance(value, int):
        return YsonInt64(value, attributes)
    if isinstance(value, float):
        return YsonDouble(value, attributes)
    if isinstance(value, bytes):
        return YsonString(value, attributes)
    if isinstance(value, str):
        return YsonUnicode(value, attributes)
    if isinstance(value, dict):
        return YsonMap(value, attributes)
    if isinstance(value, list):
        return YsonList(value, attributes)
    raise TypeError(f"Cannot attach attributes to {type(value).__name__}")
