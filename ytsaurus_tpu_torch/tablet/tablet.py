"""The versioned layout of a tablet's snapshot chunks.

Port of `versioned_schema` from the JAX package's `tablet/tablet.py`, the
layout that `tablet/mvcc.py` reads. The `Tablet` class, its dynamic
stores, flushes and compactions are not ported yet.
"""

from __future__ import annotations

from dataclasses import replace

from ytsaurus_tpu_torch.schema import TableSchema


def versioned_schema(schema: TableSchema) -> TableSchema:
    """Schema of versioned snapshot chunks: keys + $timestamp/$tombstone +
    per value column (value plane, $w: written-flag plane).  The written
    planes are the per-column timestamp dimension of TVersionedRow
    (client/table_client/versioned_row.h:90-141): a version only carries
    the columns it wrote, so partial writes merge per column on read.
    Keys keep their sort order; versions sort within key by descending
    timestamp at flush time."""
    cols: list = []
    for c in schema:
        if c.sort_order is not None:
            cols.append((c.name, c.type.value, c.sort_order.value))
    cols.append(("$timestamp", "int64"))
    cols.append(("$tombstone", "boolean"))
    for c in schema:
        if c.sort_order is None:
            # Keep hunk thresholds so flushes store big values out-of-row.
            cols.append(replace(c, sort_order=None, expression=None,
                                aggregate=None, required=False))
            cols.append((f"$w:{c.name}", "boolean"))
    return TableSchema.make(cols)
