"""Host codec helpers: g++-compiled C++ through ctypes, numpy fallback.

Own copy of the JAX package's `native/` (the same `fastpath.cpp`): zigzag
varint streams, bit-packed validity bitmaps, delta coding, CRC-64/XZ block
checksums and the dictionary code remap. This is host code, not a device
kernel. At first use `fastpath.cpp` is compiled with g++ into the port's
`_build/` directory (named by a hash of the source) and loaded; when no
compiler is present the module-level functions fall back to numpy, as the
reference's do. The fallback checksum is tagged with a high bit, so a blob
written through it never passes for a native one: callers that must run
the library (chip_smoke) check `lib()` and `status()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import zlib
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "fastpath.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_LIB = None
_TRIED = False
# How the last `lib()` call ended: "native" (loaded, with the build's
# seconds), or "numpy" with the reason the library is missing.
_STATUS: dict = {"path": "untried"}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "yt_varint_encode_zigzag": ([_P, _I64, _P], _I64),
    "yt_varint_decode_zigzag": ([_P, _I64, _I64, _P], _I64),
    "yt_bitmap_pack": ([_P, _I64, _P], None),
    "yt_bitmap_unpack": ([_P, _I64, _I64, _P], _I64),
    "yt_delta_encode": ([_P, _I64, _P], None),
    "yt_delta_decode": ([_P, _I64, _P], None),
    "yt_crc64": ([_P, _I64, ctypes.c_uint64], ctypes.c_uint64),
    "yt_remap_i32": ([_P, _I64, _P, _I64, _P], None),
}


def _load():
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"fastpath-{digest}.so"
    seconds = 0.0
    if not so_path.exists():
        tmp = f"{so_path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(_SOURCE), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
        seconds = time.perf_counter() - t0
    handle = ctypes.CDLL(str(so_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle, {"path": "native", "library": str(so_path),
                    "build_seconds": seconds}


def lib():
    """The loaded library (built at first use), or None when it cannot be
    built or loaded; `status()` then says why."""
    global _LIB, _TRIED, _STATUS
    if _LIB is not None or _TRIED:
        return _LIB
    with _lock:
        if not _TRIED:
            try:
                _LIB, _STATUS = _load()
            except (OSError, subprocess.CalledProcessError) as e:
                _LIB = None
                _STATUS = {"path": "numpy",
                           "reason": f"{type(e).__name__}: {e}"}
            _TRIED = True
    return _LIB


def status() -> dict:
    """Which path the helpers take: {"path": "native", "library": ...,
    "build_seconds": ...} or {"path": "numpy", "reason": ...}."""
    lib()
    return dict(_STATUS)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


# --- varint ------------------------------------------------------------------


def varint_encode(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int64)
    handle = lib()
    if handle is not None:
        out = np.empty(len(values) * 10 + 1, dtype=np.uint8)
        n = handle.yt_varint_encode_zigzag(_ptr(values), len(values),
                                           _ptr(out))
        return out[:n].tobytes()
    buf = bytearray()
    for v in values.tolist():
        z = ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)
        while z >= 0x80:
            buf.append((z & 0x7F) | 0x80)
            z >>= 7
        buf.append(z)
    return bytes(buf)


def varint_decode(data: bytes, count: int) -> np.ndarray:
    handle = lib()
    if handle is not None:
        out = np.empty(count, dtype=np.int64)
        src = np.frombuffer(data, dtype=np.uint8)
        consumed = handle.yt_varint_decode_zigzag(_ptr(src), len(src),
                                                  count, _ptr(out))
        if consumed < 0:
            raise ValueError("truncated varint stream")
        return out
    out = np.empty(count, dtype=np.int64)
    pos = 0
    for i in range(count):
        value = 0
        shift = 0
        while True:
            byte = data[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        out[i] = (value >> 1) ^ -(value & 1)
    return out


# --- bitmaps -----------------------------------------------------------------


def bitmap_pack(bools: np.ndarray) -> bytes:
    bools = np.ascontiguousarray(bools, dtype=np.uint8)
    handle = lib()
    if handle is not None:
        out = np.zeros((len(bools) + 7) // 8, dtype=np.uint8)
        handle.yt_bitmap_pack(_ptr(bools), len(bools), _ptr(out))
        return out.tobytes()
    return np.packbits(bools, bitorder="little").tobytes()


def bitmap_unpack(data: bytes, count: int) -> np.ndarray:
    if len(data) * 8 < count:
        raise ValueError(
            f"bitmap too small: {len(data)} bytes for {count} bits")
    handle = lib()
    if handle is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(count, dtype=np.uint8)
        rc = handle.yt_bitmap_unpack(_ptr(src), len(src), count, _ptr(out))
        if rc != 0:
            raise ValueError("bitmap too small")
        return out.astype(bool)
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                         count=count, bitorder="little").astype(bool)


# --- delta -------------------------------------------------------------------


def delta_encode(values: np.ndarray) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.int64)
    handle = lib()
    if handle is not None:
        out = np.empty_like(values)
        handle.yt_delta_encode(_ptr(values), len(values), _ptr(out))
        return out
    out = np.empty_like(values)
    if len(values):
        out[0] = values[0]
        with np.errstate(over="ignore"):
            np.subtract(values[1:], values[:-1], out=out[1:])
    return out


def delta_decode(deltas: np.ndarray) -> np.ndarray:
    deltas = np.ascontiguousarray(deltas, dtype=np.int64)
    handle = lib()
    if handle is not None:
        out = np.empty_like(deltas)
        handle.yt_delta_decode(_ptr(deltas), len(deltas), _ptr(out))
        return out
    return np.cumsum(deltas, dtype=np.int64)


# --- checksums / remap -------------------------------------------------------


def checksum(data: bytes, seed: int = 0) -> int:
    handle = lib()
    if handle is not None:
        src = np.frombuffer(data, dtype=np.uint8) if data else \
            np.empty(0, dtype=np.uint8)
        return int(handle.yt_crc64(_ptr(src), len(src), seed))
    # Fallback: crc32 widened (weaker; tagged with a high bit so native and
    # fallback checksums never silently compare equal).
    return zlib.crc32(data, seed & 0xFFFFFFFF) | (1 << 62)


def remap_i32(codes: np.ndarray, table: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    handle = lib()
    if handle is not None:
        out = np.empty_like(codes)
        handle.yt_remap_i32(_ptr(codes), len(codes), _ptr(table),
                            len(table), _ptr(out))
        return out
    safe = np.clip(codes, 0, max(len(table) - 1, 0))
    out = table[safe] if len(table) else np.zeros_like(codes)
    out[(codes < 0) | (codes >= len(table))] = 0
    return out
