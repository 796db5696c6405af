"""Typed wire bodies: YSON with the Python str/bytes distinction preserved.

Binary YSON has one string type; the client API distinguishes text
(attribute values, paths) from binary (row string values).  On the wire,
bytes values are wrapped as {"$b": <raw>}; every unwrapped string decodes
back to str (utf-8).  A literal single-key {"$b": ...} dict is escaped as
{"$$b": ...}.

Own copy of the JAX package's `rpc/wire.py`.
"""

from __future__ import annotations


def encode_body(value):
    if isinstance(value, bytes):
        return {"$b": value}
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if isinstance(k, str) and k.startswith("$") and len(value) == 1:
                k = "$" + k
            out[k] = encode_body(v)
        return out
    if isinstance(value, (list, tuple)):
        return [encode_body(v) for v in value]
    return value


def decode_body(value):
    if isinstance(value, dict):
        if len(value) == 1:
            ((k, v),) = value.items()
            key = k.decode() if isinstance(k, bytes) else k
            if key == "$b":
                return v if isinstance(v, bytes) else str(v).encode()
            if isinstance(key, str) and key.startswith("$$"):
                return {key[1:]: decode_body(v)}
        return {(k.decode() if isinstance(k, bytes) else k): decode_body(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [decode_body(v) for v in value]
    if isinstance(value, bytes):
        return value.decode("utf-8")
    return value


def wire_text(v) -> str:
    """Wire value to str (strings arrive as utf-8 str already; bytes from
    legacy peers decode)."""
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)
