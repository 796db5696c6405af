"""YSON: YT's object notation (ref yt/yt/core/yson) — text + binary.

Own copy of the JAX package's `yson/` (types, writer, parser): chunk metas
are binary YSON, so the port writes the same bytes for the same value."""

from ytsaurus_tpu_torch.yson.parser import loads
from ytsaurus_tpu_torch.yson.types import (
    YsonBoolean,
    YsonDouble,
    YsonEntity,
    YsonInt64,
    YsonList,
    YsonMap,
    YsonString,
    YsonType,
    YsonUint64,
    YsonUnicode,
    get_attributes,
    to_yson_type,
)
from ytsaurus_tpu_torch.yson.writer import dumps
