"""Secondary indexes: index tables maintained on write, used by queries.
Own copy of the JAX package's `tablet/secondary_index.py`.

Ref mapping:
  secondary index objects + index tables   → create_secondary_index builds
  (library/query/secondary_index,            an index table keyed by
  server/master/table_server)                (index columns..., source key
                                             columns...) with an $empty
                                             payload column
  index maintenance on tablet writes       → index rows join the SAME 2PC
  (sorted_store_manager index updates)       transaction as the source
                                             write: stale entries deleted,
                                             fresh ones inserted, using the
                                             pre-write row images
  predicate rewrite                        → select_rows consults
  (secondary_index/schema.cpp rewriter)      WHERE-derived column intervals
                                             (query/pruning.py) and serves
                                             the scan from index + lookup
                                             when the index prefix is
                                             bounded

Design delta: the rewrite happens at coordination time, not in the IR —
the index produces the exact source-key set, the source rows are fetched
via the vectorized lookup path, and the ORIGINAL plan runs unchanged over
that small rowset (so every query feature works over indexed scans).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import TableSchema

INDEXES_ATTR = "secondary_indexes"
EMPTY_COLUMN = "$empty"


def index_schema(source_schema: TableSchema,
                 index_columns: Sequence[str]) -> TableSchema:
    """Index table schema: (index columns..., source keys...) -> $empty."""
    cols: list = []
    seen = set()
    for name in index_columns:
        col = source_schema.find(name)
        if col is None:
            raise YtError(f"No such column {name!r} to index",
                          code=EErrorCode.QueryTypeError)
        if col.type.value == "any":
            raise YtError(f"Cannot index `any` column {name!r}",
                          code=EErrorCode.QueryUnsupported)
        cols.append((name, col.type.value, "ascending"))
        seen.add(name)
    for col in source_schema.key_columns:
        if col.name not in seen:
            cols.append((col.name, col.type.value, "ascending"))
    cols.append((EMPTY_COLUMN, "int64"))
    return TableSchema.make(cols, unique_keys=True)


def index_descriptors(node) -> dict:
    return dict(node.attributes.get(INDEXES_ATTR) or {})


def index_key_row(desc: dict, source_key_names: Sequence[str],
                  row: dict) -> dict:
    out = {}
    for name in desc["columns"]:
        out[name] = row.get(name)
    for name in source_key_names:
        out[name] = row.get(name)
    return out


def index_key_tuple(desc: dict, source_key_names: Sequence[str],
                    row: dict) -> tuple:
    ordered = list(desc["columns"]) + [
        n for n in source_key_names if n not in set(desc["columns"])]
    return tuple(row.get(n) for n in ordered)


def create_secondary_index(client, table_path: str, index_path: str,
                           columns: Sequence[str]) -> None:
    """Create + backfill an index table and register it on the source
    (ref: secondary index creation; backfill replaces the reference's
    online index build for existing rows)."""
    node = client._table_node(table_path)
    schema = client._node_schema(node)
    if schema is None or not schema.is_sorted or \
            not node.attributes.get("dynamic"):
        raise YtError("Secondary indexes require a sorted dynamic table",
                      code=EErrorCode.QueryUnsupported)
    columns = list(columns)
    if not columns:
        raise YtError("Secondary index needs at least one column",
                      code=EErrorCode.QueryTypeError)
    ischema = index_schema(schema, columns)
    client.create("table", index_path, recursive=True,
                  attributes={"schema": ischema, "dynamic": True,
                              "index_source": table_path})
    client.mount_table(index_path)
    # Backfill from the current committed state.
    key_names = schema.key_column_names
    desc = {"columns": columns, "path": index_path}
    existing = client._select_rows_system(
        ", ".join(c.name for c in schema) + f" FROM [{table_path}]")
    if existing:
        client.insert_rows(index_path, [
            dict(index_key_row(desc, key_names, row), **{EMPTY_COLUMN: 0})
            for row in existing])
    indexes = index_descriptors(node)
    indexes[index_path] = {"columns": columns}
    client.set(table_path + "/@" + INDEXES_ATTR, indexes)


def drop_secondary_index(client, table_path: str, index_path: str,
                         remove_table: bool = True) -> None:
    node = client._table_node(table_path)
    indexes = index_descriptors(node)
    if index_path not in indexes:
        raise YtError(f"No index {index_path!r} on {table_path!r}",
                      code=EErrorCode.ResolveError)
    del indexes[index_path]
    client.set(table_path + "/@" + INDEXES_ATTR, indexes)
    if remove_table:
        client.unmount_table(index_path)
        client.remove(index_path)


def record_index_intent(client, tx, path, node, schema,
                        new_rows: Optional[list],
                        deleted_keys: Optional[list],
                        update: bool) -> None:
    """Record a source-table modification for deferred index maintenance.

    Index mutations are computed at COMMIT time from the NET change
    (pre-transaction committed image → final image): staging per-write
    would emit a delete and a write of the SAME index key at one commit
    timestamp when a transaction rewrites a row twice, which MVCC cannot
    order.  The reference gets the same effect from its ordered row locks;
    here the transaction carries intents and finalize computes the net.
    """
    if not index_descriptors(node):
        return
    intents = getattr(tx, "index_intents", None)
    if intents is None:
        intents = tx.index_intents = []
    intents.append((path, new_rows, deleted_keys, update))


def finalize_index_mutations(client, txm, tx) -> None:
    """Stage the NET index mutations for every intent recorded under this
    transaction.  Called once, right before commit."""
    intents = getattr(tx, "index_intents", None)
    if not intents:
        return
    tx.index_intents = []          # idempotent under retry
    # path → {normalized source key: (raw key, committed_row, final_row)}
    net: dict = {}
    for path, new_rows, deleted_keys, update in intents:
        node = client._table_node(path)
        schema = client._node_schema(node)
        key_names = schema.key_column_names
        norm = client._mounted_tablets(path)[0].normalize_key
        per_path = net.setdefault(path, {})
        if deleted_keys is not None:
            items = [(tuple(k), None) for k in deleted_keys]
        else:
            items = [(tuple(r.get(n) for n in key_names), dict(r))
                     for r in new_rows]
        keys = [k for k, _ in items]
        need_committed = [k for k in keys if norm(k) not in per_path]
        # System path: this runs on the WRITE commit path and must not
        # queue behind (or deadlock inside) user read admission.
        committed = client._lookup_rows_direct(path, need_committed) \
            if need_committed else []
        for k, row in zip(need_committed, committed):
            per_path[norm(k)] = (k, row, row)
        for k, new in items:
            raw, committed_row, image = per_path[norm(k)]
            if new is None:
                image = None
            elif update and image is not None:
                merged = dict(image)
                merged.update(new)
                image = merged
            else:
                image = new
            per_path[norm(k)] = (raw, committed_row, image)
    for path, per_path in net.items():
        node = client._table_node(path)
        schema = client._node_schema(node)
        key_names = schema.key_column_names
        for index_path, desc in index_descriptors(node).items():
            desc = dict(desc, path=index_path)
            index_tablets = client._mounted_tablets(index_path)
            norm = index_tablets[0].normalize_key
            to_delete: list[tuple] = []
            to_write: list[dict] = []
            for raw, old, final in per_path.values():
                if final is None:
                    if old is not None:
                        to_delete.append(
                            index_key_tuple(desc, key_names, old))
                    continue
                if old is not None:
                    old_key = index_key_tuple(desc, key_names, old)
                    new_key = index_key_tuple(desc, key_names, final)
                    # Normalized compare: str vs bytes images of one key.
                    if norm(old_key) != norm(new_key):
                        to_delete.append(old_key)
                to_write.append(
                    dict(index_key_row(desc, key_names, final),
                         **{EMPTY_COLUMN: 0}))
            if to_delete:
                for idx, part in client._route_rows(
                        index_path, index_tablets, to_delete).items():
                    txm.delete_rows(tx, index_tablets[idx], part)
            if to_write:
                for idx, part in client._route_rows(
                        index_path, index_tablets, to_write).items():
                    txm.write_rows(tx, index_tablets[idx], part)


def _bounded(iv) -> bool:
    from ytsaurus_tpu_torch.query.pruning import _NEG_INF, _POS_INF
    return iv is not None and not (iv.lo is _NEG_INF and iv.hi is _POS_INF)


def pick_index(node, intervals: dict) -> Optional[dict]:
    """Choose an index whose FIRST column is bounded by the WHERE-derived
    intervals (the rewriter's applicability rule)."""
    for index_path, desc in index_descriptors(node).items():
        if _bounded(intervals.get(desc["columns"][0])):
            return dict(desc, path=index_path)
    return None


def _ql_literal(value) -> Optional[str]:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, bytes):
        try:
            value = value.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace("'", "\\'")
        return f"'{escaped}'"
    return None


def _interval_predicate(column: str, iv) -> Optional[str]:
    from ytsaurus_tpu_torch.query.pruning import _NEG_INF, _POS_INF
    parts = []
    if iv.lo is not _NEG_INF:
        lit = _ql_literal(iv.lo)
        if lit is None:
            return None
        parts.append(f"{column} {'>=' if iv.lo_incl else '>'} {lit}")
    if iv.hi is not _POS_INF:
        lit = _ql_literal(iv.hi)
        if lit is None:
            return None
        parts.append(f"{column} {'<=' if iv.hi_incl else '<'} {lit}")
    return " AND ".join(parts) if parts else None


def fetch_via_index(client, table_path: str, schema, desc: dict,
                    intervals: dict, timestamp) -> Optional[list[dict]]:
    """Index scan → source-key set → vectorized source lookup.  Returns
    None when the bound cannot be expressed (caller falls back to scan)."""
    key_names = schema.key_column_names
    first = desc["columns"][0]
    predicate = _interval_predicate(first, intervals[first])
    if predicate is None:
        return None
    index_cols = ", ".join(
        list(desc["columns"]) +
        [n for n in key_names if n not in set(desc["columns"])])
    # The index table is keyed by the indexed columns, so the bound lands
    # on its key prefix (range pruning); the caller's plan re-applies the
    # full WHERE over the fetched rows.
    # System path: fetch_via_index runs INSIDE an already-admitted
    # select — re-entering admission here could deadlock a saturated
    # pool (every slot holder waiting for one more slot).
    index_rows = client._select_rows_system(
        f"{index_cols} FROM [{desc['path']}] WHERE {predicate}",
        timestamp=timestamp)
    # Dedup: duplicated index entries (or several matching index rows per
    # source key) must not duplicate source rows.
    keys = list(dict.fromkeys(
        tuple(r[n] for n in key_names) for r in index_rows))
    if not keys:
        return []
    rows = client._lookup_rows_direct(table_path, keys,
                                      timestamp=timestamp)
    return [r for r in rows if r is not None]
