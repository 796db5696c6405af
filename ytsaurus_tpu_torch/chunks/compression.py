"""Block compression codec registry (own copy of the JAX package's
`chunks/compression.py`).

Ref: yt/yt/core/compression/public.h (None/Snappy/Lz4/Brotli/Zlib/Zstd/
Lzma/Bzip2 codec enum).  Stdlib codecs are always present; lz4/zstd register
when importable.  Codec names are stored in chunk metas, so they are stable
identifiers.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Callable

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

_CODECS: dict[str, tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {}


def register_codec(name: str, compress, decompress) -> None:
    _CODECS[name] = (compress, decompress)


register_codec("none", lambda b: b, lambda b: b)
for level in (1, 6, 9):
    register_codec(f"zlib_{level}",
                   (lambda lv: lambda b: zlib.compress(b, lv))(level),
                   zlib.decompress)
register_codec("lzma", lzma.compress, lzma.decompress)
register_codec("bzip2", bz2.compress, bz2.decompress)

try:  # optional
    import lz4.frame as _lz4

    register_codec("lz4", _lz4.compress, _lz4.decompress)
except Exception:  # pragma: no cover
    pass

try:  # optional
    import zstandard as _zstd

    register_codec("zstd_3",
                   lambda b: _zstd.ZstdCompressor(level=3).compress(b),
                   lambda b: _zstd.ZstdDecompressor().decompress(b))
except Exception:  # pragma: no cover
    pass


def get_codec(name: str):
    codec = _CODECS.get(name)
    if codec is None:
        raise YtError(f"Unknown compression codec {name!r}",
                      code=EErrorCode.ChunkFormatError)
    return codec


def codec_names() -> list[str]:
    return sorted(_CODECS)
