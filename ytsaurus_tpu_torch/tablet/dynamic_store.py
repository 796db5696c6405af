"""In-memory dynamic stores.

Ref: sorted_dynamic_store.h (MVCC edit lists) / ordered_dynamic_store.h.
SortedDynamicStore versions are per-column: a version records ONLY the
columns it wrote (update=True partial writes carry just those; overwrite
writes state every value column explicitly), and reads merge newest-per-
column above the latest delete — TVersionedRow semantics
(client/table_client/versioned_row.h:90, versioned_row_merger.h).

Port of the JAX package's `tablet/dynamic_store.py`. Differences:
`to_versioned_chunk` builds the planes on the device it is given (the
tablet's), from the versions taken column-wise (`versioned_columns`,
`ColumnarChunk.from_columns`: no row dicts), and the sorted key list is
kept lazily: a new key is appended,
and the list is sorted when the store is next iterated, so a store of n
keys costs O(n log n) to fill instead of the O(n^2) of inserting each key
at its place (a store holds up to 1,000,000 rows before a flush).
`OrderedDynamicStore` also appends a batch under one lock acquisition
(`append_rows`) and hands its rows out column-wise (`columns`), which the
ordered tablet's flush and snapshot build planes from.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP


class SortedDynamicStore:
    def __init__(self, schema: TableSchema):
        if not schema.is_sorted:
            raise YtError("Dynamic store requires a sorted schema")
        self.schema = schema
        self.key_names = schema.key_column_names
        self.value_names = [c.name for c in schema
                            if c.sort_order is None]
        self._rows: dict[tuple, list[tuple[int, Optional[dict]]]] = {}
        # Null-safe keys: sorted, then the keys added since the last sort.
        self._sorted_keys: list[tuple] = []
        self._new_keys: list[tuple] = []
        self._lock = threading.Lock()
        self.store_row_count = 0          # versions stored
        self.min_timestamp = MAX_TIMESTAMP
        self.max_timestamp = 0
        # (store_row_count, device, chunk): versioned planes ingested once
        # per mutation generation for the vectorized read path.
        self._versioned_chunk_cache: "Optional[tuple[int, object, object]]" \
            = None

    # -- write path ------------------------------------------------------------

    def key_of(self, row: dict) -> tuple:
        try:
            return tuple(row[name] for name in self.key_names)
        except KeyError as e:
            raise YtError(f"Row is missing key column {e.args[0]!r}",
                          code=EErrorCode.QueryTypeError)

    def write_row(self, row: dict, timestamp: int,
                  update: bool = False) -> None:
        """update=False (default): the write STATES every value column
        (missing ones become explicit nulls — the reference's overwrite
        mode).  update=True: only the provided columns are written; the
        rest merge from older versions per column (TVersionedRow partial
        writes, client/table_client/versioned_row.h:90 +
        versioned_row_merger.h)."""
        key = self.key_of(row)
        if update:
            values = {name: row[name] for name in self.value_names
                      if name in row}
        else:
            values = {name: row.get(name) for name in self.value_names}
        self._append(key, timestamp, values)

    def delete_row(self, key_row: dict | tuple, timestamp: int) -> None:
        key = key_row if isinstance(key_row, tuple) else self.key_of(key_row)
        self._append(key, timestamp, None)

    def _append(self, key: tuple, timestamp: int,
                values: Optional[dict]) -> None:
        with self._lock:
            versions = self._rows.get(key)
            if versions is None:
                versions = []
                self._rows[key] = versions
                self._new_keys.append(_null_safe(key))
            versions.append((timestamp, values))
            self.store_row_count += 1
            self.min_timestamp = min(self.min_timestamp, timestamp)
            self.max_timestamp = max(self.max_timestamp, timestamp)

    # -- read path -------------------------------------------------------------

    def last_committed_timestamp(self, key: tuple) -> Optional[int]:
        versions = self._rows.get(key)
        if not versions:
            return None
        return max(ts for ts, _ in versions)

    def lookup_versions(self, key: tuple) -> list[tuple[int, Optional[dict]]]:
        """All versions for a key, newest first."""
        versions = self._rows.get(key, [])
        return sorted(versions, key=lambda v: -v[0])

    def iter_items(self) -> Iterable[tuple[tuple, list]]:
        """(key, versions) in key order (nulls first)."""
        with self._lock:
            if self._new_keys:
                self._sorted_keys = sorted(self._sorted_keys
                                           + self._new_keys)
                self._new_keys = []
            keys = list(self._sorted_keys)
        for sk in keys:
            key = _null_unsafe(sk)
            # analyze: allow(guard-read): intentional lock-free read — the key list was snapshotted under the lock, version lists are append-only, and MVCC timestamp filtering tolerates a torn tail
            yield key, self._rows[key]

    @property
    def key_count(self) -> int:
        return len(self._rows)

    def to_versioned_chunk(self, versioned_schema, device):
        """This store's versions as planes on `device` (versioned-schema
        ColumnarChunk, key-ordered, newest-first per key) — the
        ingestion step of the vectorized MVCC read path.  Memoized per
        mutation generation (store_row_count): repeated snapshots of an
        unchanged store never re-walk its Python rows."""
        with self._lock:
            count = self.store_row_count
        cached = self._versioned_chunk_cache
        if cached is not None and cached[0] == count and \
                cached[1] == device:
            return cached[2]
        columns = self.versioned_columns()
        chunk = ColumnarChunk.from_columns(
            versioned_schema, columns, len(columns["$timestamp"]),
            device=device)
        self._versioned_chunk_cache = (count, device, chunk)
        return chunk

    def versioned_columns(self) -> dict[str, list]:
        """The store's versions column-wise (newest first per key): key
        columns + $timestamp + $tombstone + each value column followed by
        its $w: written flag (partial writes carry False for columns the
        version does not state)."""
        names = [*self.key_names, "$timestamp", "$tombstone"]
        for name in self.value_names:
            names += [name, f"$w:{name}"]
        columns: dict[str, list] = {name: [] for name in names}
        key_columns = [columns[name] for name in self.key_names]
        stamps, tombs = columns["$timestamp"], columns["$tombstone"]
        value_columns = [(name, columns[name], columns[f"$w:{name}"])
                         for name in self.value_names]
        for key, versions in self.iter_items():
            for ts, state in sorted(versions, key=lambda v: -v[0]):
                for column, value in zip(key_columns, key):
                    column.append(value)
                stamps.append(ts)
                tombs.append(state is None)
                for name, column, written in value_columns:
                    stated = state is not None and name in state
                    column.append(state[name] if stated else None)
                    written.append(stated)
        return columns

    def versioned_rows(self) -> list[dict]:
        """versioned_columns as row dicts (a small store's flush and the
        replication log read them)."""
        columns = self.versioned_columns()
        names = list(columns)
        return [dict(zip(names, values))
                for values in zip(*columns.values())]


def _null_safe(key: tuple) -> tuple:
    """Make keys with None sortable (null < everything, ref comparator)."""
    return tuple((v is not None, v if v is not None else 0) for v in key)


def _null_unsafe(sk: tuple) -> tuple:
    return tuple(v if present else None for present, v in sk)


class OrderedDynamicStore:
    """Append-only store backing ordered (queue) tables.

    Ref: tablet_node/ordered_dynamic_store.h."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self._rows: list[tuple[int, dict]] = []
        self._lock = threading.Lock()

    def append_row(self, row: dict, timestamp: int) -> int:
        with self._lock:
            self._rows.append((timestamp, dict(row)))
            return len(self._rows) - 1

    def append_rows(self, rows: "list[dict]", timestamp: int) -> None:
        """Append a batch at one timestamp under one lock acquisition (the
        rows are taken as they are, not copied)."""
        with self._lock:
            self._rows.extend((timestamp, row) for row in rows)

    def columns(self, names: "list[str]"
                ) -> "tuple[list[int], dict[str, list]]":
        """The rows column-wise: their timestamps and each named column's
        values."""
        with self._lock:
            rows = self._rows
            return ([ts for ts, _ in rows],
                    {name: [row.get(name) for _, row in rows]
                     for name in names})

    def read(self, start_index: int = 0,
             limit: Optional[int] = None) -> list[dict]:
        with self._lock:
            end = len(self._rows) if limit is None else start_index + limit
            return [dict(row) | {"$row_index": i, "$timestamp": ts}
                    for i, (ts, row) in enumerate(self._rows[start_index:end],
                                                  start=start_index)]

    @property
    def row_count(self) -> int:
        with self._lock:
            return len(self._rows)
