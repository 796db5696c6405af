"""Hunks: large values stored out-of-row in separate hunk chunks.

Own copy of the JAX package's `chunks/hunks.py`.

Ref mapping:
  hunks (ytlib/table_client/hunks.h)        → HunkRef in the string
                                              dictionary; payload lives in
                                              its own hunk chunk
  hunk_store (tablet_node/hunk_store.h)     → hunk chunks are plain blobs
                                              in the same chunk store,
                                              id = "hunk-" + content hash
  hunk_chunk_sweeper                        → collect_garbage traces
                                              hunk_chunk_ids from live
                                              chunk metas
  max_inline_hunk_size (TColumnSchema)      → ColumnSchema.max_inline_hunk_size

Design delta (TPU-first): hunk payloads never touch device planes — the
dictionary-encoded string column keeps int32 codes on device either way,
so hunking changes only what the HOST-side vocabulary stores.  Hunk chunks
are content-addressed: flushing or compacting a chunk whose large values
already live in hunks re-hashes the payloads and finds the blobs already
present — compaction never rewrites hunk payloads (the reference gets this
by attaching existing hunk chunks to the new store; we get it from content
addressing).  Refs resolve eagerly at chunk decode; a lazy
chunk-fragment-reader analog is a later optimization.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

HUNK_PREFIX = "hunk-"


@dataclass(frozen=True)
class HunkRef:
    """Out-of-row value pointer (vocab entry stand-in)."""

    hunk_id: str
    length: int


def is_hunk_id(chunk_id: str) -> bool:
    return chunk_id.startswith(HUNK_PREFIX)


def write_hunk(store, payload: bytes) -> str:
    """Store one payload content-addressed; returns the hunk chunk id.
    An existing blob with the same hash is NOT rewritten."""
    hunk_id = HUNK_PREFIX + hashlib.sha256(payload).hexdigest()[:24]
    if not store.exists(hunk_id):
        store.put_blob(hunk_id, payload)
    return hunk_id


def read_hunk(store, ref: HunkRef) -> bytes:
    payload = store.get_blob(ref.hunk_id)
    if len(payload) != ref.length:
        raise YtError(f"Hunk {ref.hunk_id} length {len(payload)} != "
                      f"expected {ref.length}",
                      code=EErrorCode.ChunkFormatError)
    return payload


def hunkify_vocab(store, vocab: np.ndarray,
                  threshold: int) -> tuple[np.ndarray, list[str]]:
    """Move vocab entries >= threshold bytes into hunk chunks.  Returns the
    new vocab (HunkRef entries for moved values) and the hunk ids used."""
    hunk_ids: list[str] = []
    out = vocab
    for i, value in enumerate(vocab):
        if isinstance(value, HunkRef):
            hunk_ids.append(value.hunk_id)
            continue
        if len(value) < threshold:
            continue
        if out is vocab:
            out = vocab.copy()
        hunk_id = write_hunk(store, bytes(value))
        out[i] = HunkRef(hunk_id=hunk_id, length=len(value))
        hunk_ids.append(hunk_id)
    return out, hunk_ids


def resolve_vocab(store, vocab: np.ndarray) -> np.ndarray:
    """Fetch every HunkRef back into an inline bytes entry."""
    out = vocab
    for i, value in enumerate(vocab):
        if isinstance(value, HunkRef):
            if store is None:
                raise YtError("Chunk has hunk refs but no hunk store is "
                              "available to resolve them",
                              code=EErrorCode.ChunkFormatError)
            if out is vocab:
                out = vocab.copy()
            out[i] = read_hunk(store, value)
    return out
