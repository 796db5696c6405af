"""Reduce / MapReduce operation kernels: key-aligned slicing + grouping.

Ref mapping:
  sorted Reduce controller   → scheduler._reduce_controller
    (controller_agent/controllers/sorted_controller.cpp:1451
     CreateReduceController — key-guarantee job slicing over sorted input)
  MapReduce controller       → scheduler._map_reduce_controller
    (controller_agent/controllers/sort_controller.cpp:5029
     CreateMapReduceController — partition → shuffle → sorted reduce)
  partition function         → stable_key_hash
    (job_proxy/partition_sort_job.cpp:43 + partitioner.cpp hash routing)

Own copy of the JAX package's `operations/reduce_op.py`.

Redesign vs the reference: the reference merges sorted chunk readers with
a streaming heap and cuts jobs at teleport boundaries.  Here chunks are
columnar device planes, so the "merge" of already-sorted inputs is one
device sort (the radix kernels), and job boundaries come from the key
change points: stripes cut only where the reduce key changes, which IS
the reference's key guarantee (no key group ever spans two jobs).  The
controller finds the change points on the device
(`chunk_key_change_points`: an adjacent-row compare of the key planes,
then one copy of the cut indices) and gets the same ranges as the host
scan of decoded keys (`decode_keys` + `key_aligned_ranges`).
"""

from __future__ import annotations

import zlib
from typing import Iterator, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.errors import EErrorCode, YtError


def decode_keys(chunk: ColumnarChunk,
                key_names: Sequence[str]) -> list[tuple]:
    """Host key tuples for slicing/grouping decisions (controller side —
    row counts here are per-operation, not per-cluster)."""
    for name in key_names:
        if name not in chunk.schema:
            raise YtError(f"No such reduce column {name!r}",
                          code=EErrorCode.QueryTypeError)
    cols = [chunk.column(name).decode(chunk.row_count)
            for name in key_names]
    return list(zip(*cols)) if cols else [() for _ in range(chunk.row_count)]


def key_change_points(keys: Sequence[tuple]) -> list[int]:
    """Indices i where keys[i] != keys[i-1] (group starts, excluding 0)."""
    return [i for i in range(1, len(keys)) if keys[i] != keys[i - 1]]


def chunk_key_change_points(chunk: ColumnarChunk,
                            key_names: Sequence[str]) -> list[int]:
    """`key_change_points(decode_keys(chunk, key_names))`, computed on
    the chunk's device: row i starts a group when any key column differs
    from row i - 1 (validity first; two nulls are equal; doubles compare
    as floats, so -0.0 equals 0.0 and NaN equals nothing, as in Python's
    tuple compare). String codes index one sorted vocabulary per column,
    so equal codes are equal strings. One copy of the cut indices."""
    n = chunk.row_count
    for name in key_names:
        if name not in chunk.schema:
            raise YtError(f"No such reduce column {name!r}",
                          code=EErrorCode.QueryTypeError)
    if n < 2 or not key_names:
        return []
    change = torch.zeros(n - 1, dtype=torch.bool, device=chunk.device)
    for name in key_names:
        col = chunk.column(name)
        valid = col.valid[:n]
        data = col.data[:n]
        both = valid[1:] & valid[:-1]
        differs = data[1:] != data[:-1]
        if differs.dim() > 1:
            differs = differs.any(dim=1)
        change |= (valid[1:] != valid[:-1]) | (both & differs)
    cuts = torch.nonzero(change).flatten().cpu().numpy()
    return (cuts + 1).tolist()


def ranges_from_change_points(change_points: Sequence[int], n: int,
                              rows_per_job: int) -> list[tuple[int, int]]:
    """Greedy cut of [0, n) at key change points into ranges of at least
    rows_per_job rows (the last may be shorter)."""
    if n == 0:
        return []
    ranges: list[tuple[int, int]] = []
    start = 0
    for cut in list(change_points) + [n]:
        if cut - start >= rows_per_job:
            ranges.append((start, cut))
            start = cut
    if start < n:
        ranges.append((start, n))
    return ranges


def key_aligned_ranges(keys: Sequence[tuple],
                       rows_per_job: int) -> list[tuple[int, int]]:
    """Cut [0, len(keys)) into ranges of ~rows_per_job rows whose
    boundaries fall ONLY on key changes.  A single key group larger than
    rows_per_job stays whole (the key guarantee outranks the size hint,
    as in the reference's reduce job size constraints)."""
    return ranges_from_change_points(key_change_points(keys), len(keys),
                                     rows_per_job)


def iter_groups(rows: Sequence[dict],
                key_names: Sequence[str]) -> Iterator[tuple[dict, list]]:
    """Yield (key_dict, group_rows) over key-contiguous rows — the Python
    reducer calling convention (mirrors yt.wrapper's reduce iteration)."""
    if not rows:
        return
    start = 0
    current = tuple(rows[0].get(k) for k in key_names)
    for i in range(1, len(rows)):
        key = tuple(rows[i].get(k) for k in key_names)
        if key != current:
            yield dict(zip(key_names, current)), list(rows[start:i])
            start, current = i, key
    yield dict(zip(key_names, current)), list(rows[start:])


def stable_key_hash(key: tuple) -> int:
    """Process-stable partition hash (Python's hash() is salted per
    process; revival re-partitions in a NEW process and must agree).

    Numerically equal values of different Python types (1, 1.0, True)
    compare equal under dict/tuple equality, so they must hash equal too
    — otherwise one logical key group splits across partitions."""
    parts = []
    for v in key:
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, float) and v.is_integer():
            v = int(v)
        if isinstance(v, bytes):
            parts.append(b"b" + v)
        elif isinstance(v, str):
            parts.append(b"s" + v.encode())
        elif isinstance(v, float):
            parts.append(b"f" + repr(v).encode())
        elif v is None:
            parts.append(b"n")
        else:
            parts.append(b"i" + str(v).encode())
    return zlib.crc32(b"\x00".join(parts))


def partition_rows(rows: Sequence[dict], key_names: Sequence[str],
                   partition_count: int) -> list[list[dict]]:
    """Hash-route rows to partitions by reduce key (the partition job of
    the MapReduce pipeline).  Same key → same partition, always."""
    parts: list[list[dict]] = [[] for _ in range(partition_count)]
    for row in rows:
        key = tuple(row.get(k) for k in key_names)
        parts[stable_key_hash(key) % partition_count].append(row)
    return parts


def validate_sorted_input(client, path: str,
                          required_prefix: Sequence[str]) -> None:
    """Reduce requires input sorted with reduce_by as a key prefix (ref
    sorted_controller.cpp input validation)."""
    try:
        sorted_by = client.get(path + "/@sorted_by")
    except YtError:
        sorted_by = None
    if not sorted_by:
        raise YtError(
            f"Reduce input {path!r} is not sorted; run_sort it by "
            f"{list(required_prefix)} first (or use run_map_reduce)",
            code=EErrorCode.SortOrderViolation)
    prefix = list(sorted_by)[: len(required_prefix)]
    if prefix != list(required_prefix):
        raise YtError(
            f"Reduce input {path!r} is sorted by {list(sorted_by)}, which "
            f"does not start with reduce_by {list(required_prefix)}",
            code=EErrorCode.QueryTypeError)
