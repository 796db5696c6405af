"""Parity of the port's dynamic-table storage path with the JAX package on
the CPU: `Tablet` (writes, deletes, partial writes, flushes, compactions,
`read_snapshot`, `lookup_rows`, `versioned_rows_snapshot`) and the
`TransactionManager`.

The same seeded sequence of operations (tests/test_mvcc_vectorized.py's
generator) goes into a JAX `Tablet` and a port `Tablet` (device "cpu"),
once with `vectorized_scan_min_rows=0` (the columnar merge) and once at
its default of 1024 (the Python merge below it); reads must agree at
several timestamps and every chunk each flush and compaction writes must
be the same bytes. Then twins of the `Tablet` cases of
tests/test_mvcc_vectorized.py and of tests/test_dynamic_tables.py's
transaction cases (with the port's `select_rows`), store directories
written by one package and mounted by the other, and the per-chunk key
index against the reference's row mask.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tests.test_mvcc_vectorized import SCHEMAS, _apply_workload
from tests.test_torch_wire import _rows_equal
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.store import FsChunkStore as RefStore
from ytsaurus_tpu.config import TabletConfig as RefTabletConfig
from ytsaurus_tpu.config import set_tablet_config as ref_set_tablet_config
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.tablet import tablet as ref_tablet
from ytsaurus_tpu.tablet.tablet import Tablet as RefTablet
from ytsaurus_tpu.tablet.timestamp import MAX_TIMESTAMP as REF_MAX_TIMESTAMP
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.store import ChunkCache, FsChunkStore
from ytsaurus_tpu_torch.config import TabletConfig, set_tablet_config
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query import select_rows
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet import tablet as tablet_mod
from ytsaurus_tpu_torch.tablet.tablet import Tablet
from ytsaurus_tpu_torch.tablet.timestamp import (
    MAX_TIMESTAMP,
    TimestampProvider,
)
from ytsaurus_tpu_torch.tablet.transactions import TransactionManager

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

CPU = "cpu"
assert MAX_TIMESTAMP == REF_MAX_TIMESTAMP


@pytest.fixture(autouse=True)
def _restore_configs():
    yield
    set_tablet_config(None)
    ref_set_tablet_config(None)


def _configure(min_rows: int) -> None:
    set_tablet_config(TabletConfig(vectorized_scan_min_rows=min_rows))
    ref_set_tablet_config(RefTabletConfig(vectorized_scan_min_rows=min_rows))


def _port_schema(schema) -> TableSchema:
    return TableSchema.from_dict(schema.to_dict())


class _Both:
    """Applies every call to the JAX tablet and the port tablet; returns
    the JAX tablet's answer."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def __getattr__(self, name):
        ref_fn, port_fn = getattr(self.ref, name), getattr(self.port, name)

        def call(*args, **kwargs):
            out = ref_fn(*args, **kwargs)
            port_fn(*args, **kwargs)
            return out
        return call


def _pair(tmp_path, schema):
    ref = RefTablet(schema, RefStore(str(tmp_path / "ref")))
    port = Tablet(_port_schema(schema), FsChunkStore(str(tmp_path / "port")),
                  device=CPU)
    return ref, port


def _keys_of(ref) -> list:
    names = ref.schema.key_column_names
    keys = {tuple(r[n] for n in names) for r in ref.versioned_rows_snapshot()}
    return sorted(keys, key=repr) + [tuple([999] + [None] * (len(names) - 1))]


def _assert_same_chunks(ref, port):
    assert len(ref.chunk_ids) == len(port.chunk_ids)
    for a, b in zip(ref.chunk_ids, port.chunk_ids):
        assert port.chunk_store.get_blob(b) == ref.chunk_store.get_blob(a)


def _assert_same_reads(ref, port, read_points):
    for ts in read_points:
        assert port.read_snapshot(ts).to_rows() == \
            ref.read_snapshot(ts).to_rows(), ts
    keys = _keys_of(ref)
    for ts in read_points[1::2]:
        assert port.lookup_rows(keys, ts) == ref.lookup_rows(keys, ts), ts
        assert port.lookup_rows(keys[:2], ts) == \
            ref.lookup_rows(keys[:2], ts), ts
    assert port.versioned_rows_snapshot() == ref.versioned_rows_snapshot()
    assert port.last_committed_timestamps(keys) == \
        [ref.last_committed_timestamp(k) for k in keys]


@pytest.mark.parametrize("min_rows", [0, 1024], ids=["columnar", "python"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("schema_name", sorted(SCHEMAS))
def test_same_history_reads_the_same(tmp_path, schema_name, seed, min_rows):
    """Writes, partial writes, deletes and flushes (timestamps reused
    across chunk and store) read the same at every timestamp tested, and
    every flushed chunk is the same bytes."""
    _configure(min_rows)
    schema = SCHEMAS[schema_name]
    ref, port = _pair(tmp_path, schema)
    rng = random.Random(1000 * seed + len(schema_name))
    max_ts = _apply_workload(_Both(ref, port), schema, rng)
    _assert_same_chunks(ref, port)
    _assert_same_reads(ref, port, [5, max_ts // 3, max_ts // 2, max_ts - 1,
                                   max_ts, MAX_TIMESTAMP])


@pytest.mark.parametrize("min_rows", [0, 1024], ids=["columnar", "python"])
@pytest.mark.parametrize("cut", ["low", "mid", "high"])
@pytest.mark.parametrize("schema_name", sorted(SCHEMAS))
def test_same_history_compacts_the_same(tmp_path, schema_name, cut,
                                        min_rows):
    _configure(min_rows)
    schema = SCHEMAS[schema_name]
    ref, port = _pair(tmp_path, schema)
    rng = random.Random(9000 + len(schema_name) + len(cut))
    max_ts = _apply_workload(_Both(ref, port), schema, rng, n_ops=80,
                             allow_duplicates=False)
    both = _Both(ref, port)
    both.flush()
    retention = {"low": 5, "mid": max_ts // 2, "high": max_ts + 10}[cut]
    both.compact(retention_timestamp=retention)
    _assert_same_chunks(ref, port)
    _assert_same_reads(ref, port, [5, max_ts // 2, max_ts, MAX_TIMESTAMP])
    # More writes on top of the compacted chunk, then another round.
    both.write_row({n: 1 for n in schema.key_column_names},
                   timestamp=max_ts + 20, update=True)
    both.delete_row(tuple(2 for _ in schema.key_column_names),
                    timestamp=max_ts + 21)
    both.flush()
    both.compact(retention_timestamp=max_ts + 20)
    _assert_same_chunks(ref, port)
    _assert_same_reads(ref, port, [max_ts, max_ts + 20, MAX_TIMESTAMP])


DOUBLE_KEYS = RefSchema.make([("k", "double", "ascending"), ("v", "int64")])
WIDE_KEYS = RefSchema.make([("u", "uint64", "ascending"),
                            ("s", "string", "ascending"),
                            ("b", "boolean", "ascending"), ("v", "int64")])


@pytest.mark.parametrize("schema", [DOUBLE_KEYS, WIDE_KEYS],
                         ids=["double", "uint64_string_boolean"])
def test_key_index_finds_the_reference_rows(tmp_path, schema):
    """The per-chunk key index returns the rows the reference's mask
    returns: nulls, NaN (matches nothing), -0.0 and +0.0 (equal), uint64
    at and above 2^63, absent strings, booleans, several key columns."""
    _configure(1024)        # the Python merge: see ROADMAP queue 3 on -0.0
    ref, port = _pair(tmp_path, schema)
    both = _Both(ref, port)
    if schema is DOUBLE_KEYS:
        values = [None, float("nan"), -0.0, 0.0, 1.5, -2.5, float("inf")]
        keys = [(v,) for v in values]
        probes = keys + [(7.0,), (-0.0,)]
    else:
        us = [None, 0, 2**63, 2**63 + 1, 2**64 - 1]
        ss = [None, b"", b"a", b"zz"]
        keys = [(u, s, b) for u in us for s in ss for b in (None, True)]
        probes = keys + [(2**63, b"absent", True), (5, b"a", False),
                         (2**64 - 1, None, None)]
    ts = 10
    for round_ in range(3):
        for i, key in enumerate(keys):
            ts += 1
            if (i + round_) % 4 == 0:
                both.delete_row(key, timestamp=ts)
            else:
                row = dict(zip(schema.key_column_names, key))
                both.write_row({**row, "v": ts}, timestamp=ts)
        both.flush()
    for ref_cid, cid in zip(ref.chunk_ids, port.chunk_ids):
        ref_chunk, chunk = ref._decode(ref_cid), port._decode(cid)
        ref_planes = ref._chunk_host_planes_locked(ref_cid)
        planes = port._chunk_host_planes_locked(cid)
        for key in probes:
            assert tablet_mod._chunk_key_rows(
                chunk, port.schema, key, planes) == \
                ref_tablet._chunk_key_rows(ref_chunk, ref.schema, key,
                                           ref_planes), key
        # The batched search answers as the reference's batched probe.
        batch = ref_tablet._chunk_batch_key_rows(ref_chunk, ref.schema,
                                                 probes, ref_planes)
        found = tablet_mod._chunk_keys_indices(chunk, port.schema, probes,
                                               planes)
        for key, idx in zip(probes, found):
            assert tablet_mod._decode_chunk_rows(chunk, planes, idx) == \
                batch.get(key, []), key
    assert port.last_committed_timestamps(probes) == \
        [ref.last_committed_timestamp(k) for k in probes]
    assert port.lookup_rows(probes) == ref.lookup_rows(probes)
    assert port.lookup_rows(probes[:3], timestamp=15) == \
        ref.lookup_rows(probes[:3], timestamp=15)
    assert _rows_equal(port.read_snapshot().to_rows(),
                       ref.read_snapshot().to_rows())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_directory_mounts_in_the_other_package(tmp_path, writer):
    """Chunks written by one package's flush and compaction are mounted by
    the other's `Tablet` (as the client mounts persisted chunk ids) and
    read equal."""
    _configure(0)
    schema = SCHEMAS["int_key"]
    ref, port = _pair(tmp_path, schema)
    rng = random.Random(77)
    source = ref if writer == "jax" else port
    max_ts = _apply_workload(source, schema, rng, n_ops=90,
                             allow_duplicates=False)
    source.flush()
    source.write_row({"k": 3, "a": 42}, timestamp=max_ts + 5, update=True)
    source.flush()
    source.compact(retention_timestamp=max_ts // 2)
    source.write_row({"k": 4, "a": 43, "b": "late", "c": 1.0},
                     timestamp=max_ts + 6)
    source.flush()
    root = tmp_path / ("ref" if writer == "jax" else "port")
    if writer == "jax":
        mounted = Tablet(_port_schema(schema), FsChunkStore(str(root)),
                         device=CPU)
    else:
        mounted = RefTablet(schema, RefStore(str(root)))
    mounted.chunk_ids = list(source.chunk_ids)
    for ts in (5, max_ts // 2, max_ts, max_ts + 5, MAX_TIMESTAMP):
        assert mounted.read_snapshot(ts).to_rows() == \
            source.read_snapshot(ts).to_rows(), ts
    keys = _keys_of(source)
    assert mounted.lookup_rows(keys) == source.lookup_rows(keys)
    assert mounted.lookup_rows(keys, max_ts // 2) == \
        source.lookup_rows(keys, max_ts // 2)


def test_tablet_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    schema = _port_schema(SCHEMAS["int_key"])
    with pytest.raises(YtError, match="no CUDA device"):
        Tablet(schema, FsChunkStore(str(tmp_path)))


def test_a_chunk_cache_on_another_device_is_refused(tmp_path):
    store = FsChunkStore(str(tmp_path))
    schema = _port_schema(SCHEMAS["int_key"])
    cache = ChunkCache(store, device=CPU)
    assert Tablet(schema, store, chunk_cache=cache, device=CPU).chunk_cache \
        is cache
    cache.device = torch.device("meta")
    with pytest.raises(YtError, match="chunk cache decodes onto"):
        Tablet(schema, store, chunk_cache=cache, device=CPU)


# --- twins of tests/test_mvcc_vectorized.py's Tablet cases ---------------------

def _port_tablet(tmp_path, schema=None) -> Tablet:
    schema = schema or _port_schema(SCHEMAS["int_key"])
    return Tablet(schema, FsChunkStore(str(tmp_path)), device=CPU)


@pytest.mark.parametrize("seed", range(2))
def test_vectorized_flush_matches_the_reference_oracle(tmp_path, seed):
    _configure(0)
    schema = _port_schema(SCHEMAS["int_key"])
    t = _port_tablet(tmp_path, schema)
    _apply_workload(t, schema, random.Random(7000 + seed), n_ops=60)
    rows = []
    for store in t.passive_stores + [t.active_store]:
        rows.extend(store.versioned_rows())
    rows.sort(key=ref_tablet._versioned_sort_key(schema))
    cid = t.flush()
    assert t.chunk_store.read_chunk(cid, device=CPU).to_rows() == rows


@pytest.mark.parametrize("schema_name", sorted(SCHEMAS))
def test_store_planes_are_the_references_versioned_rows(tmp_path,
                                                        schema_name):
    """A store's planes, built column-wise (`versioned_columns`,
    `ColumnarChunk.from_columns`), hold the JAX store's versioned rows,
    and serialize to the bytes of the chunk that the reference builds
    from them."""
    from ytsaurus_tpu.chunks.encoding import serialize_chunk as ref_serialize
    from ytsaurus_tpu_torch.chunks.encoding import serialize_chunk
    _configure(0)
    ref, port = _pair(tmp_path, SCHEMAS[schema_name])
    both = _Both(ref, port)
    both.flush = lambda: None       # every version stays in the store
    _apply_workload(both, SCHEMAS[schema_name], random.Random(8100),
                    n_ops=60, allow_duplicates=False)
    want = ref.active_store.versioned_rows()
    assert len(want) > 40
    planes = port.active_store.to_versioned_chunk(port._versioned_schema,
                                                  torch.device(CPU))
    assert planes.to_rows() == want
    assert port.active_store.versioned_rows() == want
    assert serialize_chunk(planes) == ref_serialize(RefChunk.from_rows(
        ref._versioned_schema, want))


def test_vectorized_compaction_matches_the_reference_oracle(tmp_path):
    _configure(0)
    schema = _port_schema(SCHEMAS["int_key"])
    t = _port_tablet(tmp_path, schema)
    max_ts = _apply_workload(t, schema, random.Random(9001), n_ops=80,
                             allow_duplicates=False)
    t.flush()
    value_names = [c.name for c in schema if c.sort_order is None]
    rows = []
    for cid in t.chunk_ids:
        for row in t.chunk_store.read_chunk(cid, device=CPU).to_rows():
            for name in value_names:
                row[f"$w:{name}"] = ref_tablet._written(row, name)
            rows.append(row)
    rows.sort(key=ref_tablet._versioned_sort_key(schema))
    expected = ref_tablet._drop_superseded(rows, schema, max_ts // 2)
    new_id = t.compact(retention_timestamp=max_ts // 2)
    assert t.chunk_store.read_chunk(new_id, device=CPU).to_rows() == expected
    assert t.read_snapshot().to_rows() == \
        t.read_snapshot_reference().to_rows()


def test_duplicate_timestamp_across_chunk_and_store(tmp_path):
    _configure(0)
    ref, port = _pair(tmp_path, SCHEMAS["int_key"])
    both = _Both(ref, port)
    both.write_row({"k": 1, "a": 1, "b": "chunk", "c": 0.5}, timestamp=100)
    both.flush()
    both.write_row({"k": 1, "a": 2, "b": "store", "c": 0.5}, timestamp=100)
    assert port.read_snapshot().to_rows() == \
        port.read_snapshot_reference().to_rows() == \
        ref.read_snapshot().to_rows()


def test_select_path_performs_zero_to_rows(tmp_path, monkeypatch):
    _configure(0)
    t = _port_tablet(tmp_path)
    for i in range(30):
        t.write_row({"k": i % 7, "a": i, "b": f"v{i}", "c": i / 2},
                    timestamp=10 + i)
    t.flush()
    t.write_row({"k": 3, "a": 99}, timestamp=100, update=True)
    t.delete_row((5,), timestamp=101)

    def _boom(self):
        raise AssertionError("to_rows() on the select path")
    monkeypatch.setattr(ColumnarChunk, "to_rows", _boom)
    monkeypatch.setenv("YT_TPU_INVARIANTS", "0")
    assert t.read_snapshot().row_count > 0
    assert t.read_snapshot(timestamp=50).row_count > 0


def test_snapshot_cache_hit_and_invalidation(tmp_path):
    _configure(0)
    t = _port_tablet(tmp_path)
    for i in range(10):
        t.write_row({"k": i, "a": i, "b": "x", "c": 0.0}, timestamp=10 + i)
    t.flush()
    hits0 = tablet_mod._SNAP_HITS.get()
    c1 = t.read_snapshot()
    assert t.read_snapshot() is c1
    assert tablet_mod._SNAP_HITS.get() == hits0 + 1
    assert t.read_snapshot(timestamp=10_000) is c1
    assert t.read_snapshot(timestamp=12) is not c1
    t.write_row({"k": 99, "a": 1, "b": "y", "c": 1.0}, timestamp=200)
    c3 = t.read_snapshot()
    assert c3 is not c1 and any(r["k"] == 99 for r in c3.to_rows())
    t.flush()
    c4 = t.read_snapshot()
    assert c4 is not c3 and c4.to_rows() == c3.to_rows()
    t.compact()
    c5 = t.read_snapshot()
    assert c5 is not c4 and c5.to_rows() == c4.to_rows()
    stats = tablet_mod.snapshot_cache_stats()
    assert stats["evictions"] >= 2 and stats["bytes_pinned"] > 0
    served, age = t.read_snapshot_bounded(max_staleness=60.0)
    assert served is c5 and 0.0 <= age <= 60.0
    t.write_row({"k": 98, "a": 1, "b": "z", "c": 1.0}, timestamp=300)
    assert t.read_snapshot_bounded(max_staleness=60.0)[0] is c5
    assert t.read_snapshot_bounded()[0] is not c5


def test_snapshot_cache_disabled_via_config(tmp_path):
    set_tablet_config(TabletConfig(vectorized_scan_min_rows=0,
                                   snapshot_cache_enabled=False))
    t = _port_tablet(tmp_path)
    t.write_row({"k": 1, "a": 1, "b": "x", "c": 0.0}, timestamp=10)
    assert t.read_snapshot() is not t.read_snapshot()


def test_host_planes_lru_promotes_on_hit(tmp_path):
    set_tablet_config(TabletConfig(host_plane_cache_capacity=2))
    t = _port_tablet(tmp_path)
    cids = []
    for i in range(3):
        t.write_row({"k": i, "a": i, "b": "x", "c": 0.0}, timestamp=10 + i)
        cids.append(t.flush())
    t._host_planes.clear()
    t._chunk_host_planes_locked(cids[0])
    t._chunk_host_planes_locked(cids[1])
    t._chunk_host_planes_locked(cids[0])        # promote: [1, 0]
    t._chunk_host_planes_locked(cids[2])        # evicts 1, not 0
    assert cids[0] in t._host_planes and cids[2] in t._host_planes
    assert cids[1] not in t._host_planes


def test_host_planes_view_uint64_as_unsigned(tmp_path):
    schema = TableSchema.make([("k", "uint64", "ascending"), ("v", "int64")])
    t = _port_tablet(tmp_path, schema)
    t.write_row({"k": 2**64 - 1, "v": 1}, timestamp=10)
    cid = t.flush()
    data, valid = t._chunk_host_planes_locked(cid)["k"]
    assert data.dtype == np.uint64 and int(data[0]) == 2**64 - 1
    assert t.lookup_rows([(2**64 - 1,)]) == [{"k": 2**64 - 1, "v": 1}]


def test_chunk_max_timestamp_from_sealed_stats(tmp_path):
    t = _port_tablet(tmp_path)
    t.write_row({"k": 1, "a": 1, "b": "x", "c": 0.0}, timestamp=123)
    cid = t.flush()
    assert t._chunk_max_timestamp(cid) == 123
    assert t._latest_ts_floor() == 123


def test_pre_percolumn_chunks_mount_and_compact(tmp_path):
    """A versioned chunk without $w: planes (whole-row writes) reads and
    compacts as the reference's does."""
    _configure(0)
    old_spec = [("k", "int64", "ascending"), ("$timestamp", "int64"),
                ("$tombstone", "boolean"), ("a", "int64"), ("b", "string"),
                ("c", "double")]
    row = {"k": 1, "$timestamp": 100, "$tombstone": False, "a": 7,
           "b": b"x", "c": 2.5}
    ref, port = _pair(tmp_path, SCHEMAS["int_key"])
    ref.chunk_ids.append(ref.chunk_store.write_chunk(
        RefChunk.from_rows(RefSchema.make(old_spec), [row])))
    port.chunk_ids.append(port.chunk_store.write_chunk(
        ColumnarChunk.from_rows(TableSchema.make(old_spec), [row],
                                device=CPU)))
    _assert_same_chunks(ref, port)
    assert port.lookup_rows([(1,)]) == ref.lookup_rows([(1,)])
    _Both(ref, port).compact()
    _assert_same_chunks(ref, port)
    assert port.read_snapshot().to_rows() == ref.read_snapshot().to_rows() \
        == [{"k": 1, "a": 7, "b": b"x", "c": 2.5}]


# --- twins of tests/test_dynamic_tables.py's transaction cases -----------------

DYN = TableSchema.make([("key", "int64", "ascending"), ("value", "string"),
                        ("amount", "int64")], unique_keys=True)


@pytest.fixture
def tablet(tmp_path):
    return Tablet(DYN, FsChunkStore(str(tmp_path)), device=CPU)


@pytest.fixture
def txm():
    return TransactionManager()


def _insert(txm, tablet, rows):
    tx = txm.start()
    txm.write_rows(tx, tablet, rows)
    return txm.commit(tx)


def test_insert_lookup_overwrite_and_snapshot_isolation(tablet, txm):
    ts1 = _insert(txm, tablet, [{"key": 1, "value": "v1", "amount": 1},
                                {"key": 2, "value": "b", "amount": 20}])
    ts2 = _insert(txm, tablet, [{"key": 1, "value": "v2", "amount": 2}])
    assert tablet.lookup_rows([(1,), (2,), (3,)]) == [
        {"key": 1, "value": b"v2", "amount": 2},
        {"key": 2, "value": b"b", "amount": 20}, None]
    assert tablet.lookup_rows([(1,)], timestamp=ts1)[0]["value"] == b"v1"
    assert tablet.lookup_rows([(1,)], timestamp=ts2)[0]["value"] == b"v2"
    assert tablet.lookup_rows([(1,)], timestamp=ts1 - 1) == [None]


def test_delete_row(tablet, txm):
    _insert(txm, tablet, [{"key": 1, "value": "x", "amount": 1}])
    tx = txm.start()
    txm.delete_rows(tx, tablet, [(1,)])
    del_ts = txm.commit(tx)
    assert tablet.lookup_rows([(1,)]) == [None]
    assert tablet.lookup_rows([(1,)], timestamp=del_ts - 1)[0]["value"] == \
        b"x"


def test_flush_and_mixed_store_chunk_reads(tablet, txm):
    ts1 = _insert(txm, tablet, [{"key": 1, "value": "v1", "amount": 1}])
    _insert(txm, tablet, [{"key": 1, "value": "v2", "amount": 2}])
    assert tablet.flush() is not None
    assert tablet.active_store.key_count == 0
    assert tablet.lookup_rows([(1,)], timestamp=ts1)[0]["value"] == b"v1"
    _insert(txm, tablet, [{"key": 2, "value": "fresh", "amount": 2}])
    rows = tablet.lookup_rows([(1,), (2,)])
    assert [r["value"] for r in rows] == [b"v2", b"fresh"]
    assert sorted(r["key"] for r in tablet.read_snapshot().to_rows()) == \
        [1, 2]
    _insert(txm, tablet, [{"key": 1, "value": "new", "amount": 3}])
    assert tablet.lookup_rows([(1,)])[0]["value"] == b"new"


def test_compaction_drops_superseded_and_deleted(tablet, txm):
    for i in range(3):
        _insert(txm, tablet, [{"key": 1, "value": f"v{i}", "amount": i}])
    _insert(txm, tablet, [{"key": 2, "value": "x", "amount": 1}])
    tx = txm.start()
    txm.delete_rows(tx, tablet, [(2,)])
    txm.commit(tx)
    tablet.flush()
    tablet.compact(retention_timestamp=txm.timestamps.generate())
    assert len(tablet.chunk_ids) == 1
    chunk = tablet.chunk_store.read_chunk(tablet.chunk_ids[0], device=CPU)
    assert chunk.row_count == 1          # only key 1's latest version
    assert tablet.lookup_rows([(1,), (2,)]) == [
        {"key": 1, "value": b"v2", "amount": 2}, None]


def test_conflict_detection_against_chunks_and_stores(tablet, txm):
    _insert(txm, tablet, [{"key": 1, "value": "base", "amount": 0},
                          {"key": 5, "value": "base", "amount": 0}])
    tablet.flush()
    for flushed in (False, True):
        tx1, tx2 = txm.start(), txm.start()
        txm.write_rows(tx1, tablet, [{"key": 1, "value": "a", "amount": 1}])
        txm.write_rows(tx2, tablet, [{"key": 5, "value": "b", "amount": 2},
                                     {"key": 1, "value": "b", "amount": 2}])
        txm.commit(tx1)
        if flushed:
            tablet.flush()
        with pytest.raises(YtError) as err:
            txm.commit(tx2)
        assert err.value.code == 1700 and tx2.state == "aborted"
        assert tablet.lookup_rows([(1,), (5,)])[0]["value"] == b"a"
        assert tablet.lookup_rows([(5,)])[0]["value"] == b"base"


def test_non_conflicting_keys_and_prepare_locks(tablet, txm):
    tx1, tx2 = txm.start(), txm.start()
    txm.write_rows(tx1, tablet, [{"key": 1, "value": "a", "amount": 1}])
    txm.write_rows(tx2, tablet, [{"key": 2, "value": "b", "amount": 2}])
    txm.commit(tx1)
    txm.commit(tx2)
    assert len([r for r in tablet.lookup_rows([(1,), (2,)]) if r]) == 2
    tx3 = txm.start()
    txm.write_rows(tx3, tablet, [{"key": 3, "value": "c", "amount": 3}])
    txm._prepared_locks[(id(tablet), (3,))] = "someone"
    with pytest.raises(YtError) as err:
        txm.commit(tx3)
    assert err.value.code == 1700
    assert err.value.attributes["winner"] == "someone"


def test_multi_tablet_transaction_is_atomic(tmp_path, txm):
    t1 = Tablet(DYN, FsChunkStore(str(tmp_path / "a")), tablet_id="a",
                device=CPU)
    t2 = Tablet(DYN, FsChunkStore(str(tmp_path / "b")), tablet_id="b",
                device=CPU)
    tx = txm.start()
    txm.write_rows(tx, t1, [{"key": 1, "value": "x", "amount": 1}])
    txm.write_rows(tx, t2, [{"key": 1, "value": "y", "amount": 2}])
    ts = txm.commit(tx)
    assert t1.lookup_rows([(1,)], timestamp=ts)[0]["value"] == b"x"
    assert t2.lookup_rows([(1,)], timestamp=ts)[0]["value"] == b"y"
    assert t1.lookup_rows([(1,)], timestamp=ts - 1) == [None]
    assert t2.lookup_rows([(1,)], timestamp=ts - 1) == [None]


def test_commit_to_unmounted_participant_applies_nothing(tmp_path, txm):
    t1 = Tablet(DYN, FsChunkStore(str(tmp_path / "x")), tablet_id="x",
                device=CPU)
    t2 = Tablet(DYN, FsChunkStore(str(tmp_path / "y")), tablet_id="y",
                device=CPU)
    tx = txm.start()
    txm.write_rows(tx, t1, [{"key": 1, "value": "a", "amount": 1}])
    txm.write_rows(tx, t2, [{"key": 2, "value": "b", "amount": 2}])
    t2.mounted = False
    with pytest.raises(YtError) as err:
        txm.commit(tx)
    assert err.value.code == 1702
    assert t1.lookup_rows([(1,)]) == [None]
    t2.mounted = True
    tx2 = txm.start()
    txm.write_rows(tx2, t1, [{"key": 1, "value": "c", "amount": 3}])
    txm.commit(tx2)
    assert t1.lookup_rows([(1,)])[0]["value"] == b"c"


def test_abort_releases_locks_and_states(tablet, txm):
    tx1 = txm.start()
    txm.write_rows(tx1, tablet, [{"key": 1, "value": "a", "amount": 1}])
    txm.abort(tx1)
    with pytest.raises(YtError) as err:
        txm.commit(tx1)
    assert err.value.code == 503
    tx2 = txm.start()
    txm.write_rows(tx2, tablet, [{"key": 1, "value": "b", "amount": 2}])
    txm.commit(tx2)
    assert tablet.lookup_rows([(1,)])[0]["value"] == b"b"
    with pytest.raises(YtError) as err:
        txm.abort(tx2)
    assert err.value.code == 1705


def test_select_over_tablet_snapshot(tablet, txm):
    for i in range(20):
        _insert(txm, tablet, [{"key": i, "value": f"g{i % 3}",
                               "amount": i * 10}])
    tablet.flush()
    _insert(txm, tablet, [{"key": 100, "value": "g0", "amount": 5}])
    out = select_rows("value, sum(amount) AS total FROM [//t] GROUP BY value",
                      {"//t": tablet.read_snapshot()}, device=CPU)
    rows = {r["value"]: r["total"] for r in out.to_rows()}
    assert rows[b"g0"] == sum(i * 10 for i in range(0, 20, 3)) + 5
    assert rows[b"g1"] == sum(i * 10 for i in range(1, 20, 3))


def test_write_missing_value_column_becomes_null(tablet, txm):
    _insert(txm, tablet, [{"key": 1, "value": "full", "amount": 7}])
    _insert(txm, tablet, [{"key": 1, "value": "partial"}])
    assert tablet.lookup_rows([(1,)]) == [
        {"key": 1, "value": b"partial", "amount": None}]


def test_batch_validation_is_all_or_nothing(tmp_path, txm):
    schema = dataclasses.replace(DYN, columns=tuple(
        dataclasses.replace(c, required=(c.name == "value"))
        for c in DYN.columns))
    t = Tablet(schema, FsChunkStore(str(tmp_path)), device=CPU)
    tx = txm.start()
    with pytest.raises(YtError):
        txm.write_rows(tx, t, [{"key": 1, "value": "ok"},
                               {"key": 2, "value": None}])
    txm.commit(tx)
    assert t.lookup_rows([(1,), (2,)]) == [None, None]
    tx2 = txm.start()
    with pytest.raises(YtError):
        txm.write_rows(tx2, t, [{"key": 4, "nosuch": 5}], update=True)


def test_lookup_row_cache(tablet, txm):
    _insert(txm, tablet, [{"key": i, "value": f"v{i}", "amount": i}
                          for i in range(10)])
    tablet.flush()
    r1 = tablet.lookup_rows([(3,)])[0]
    assert tablet.row_cache_misses >= 1
    hits0 = tablet.row_cache_hits
    assert tablet.lookup_rows([(3,)])[0] == r1
    assert tablet.row_cache_hits == hits0 + 1
    _insert(txm, tablet, [{"key": 3, "value": "fresh", "amount": 99}])
    assert tablet.lookup_rows([(3,)])[0]["value"] == b"fresh"
    assert tablet.lookup_rows([(3,)], column_names=["amount"])[0] == \
        {"amount": 99}
    ts_hit = tablet.row_cache_hits
    tablet.lookup_rows([(3,)], timestamp=1)
    assert tablet.row_cache_hits == ts_hit


def test_partial_writes_merge_and_survive_flush_and_compaction(tmp_path):
    ref, port = _pair(tmp_path, SCHEMAS["int_key"])
    both = _Both(ref, port)
    both.write_row({"k": 1, "a": 1, "b": "base", "c": 0.5}, timestamp=100)
    both.flush()
    both.write_row({"k": 1, "a": 2}, timestamp=200, update=True)
    both.flush()
    both.write_row({"k": 1, "c": 9.5}, timestamp=300, update=True)
    both.delete_row((2,), timestamp=310)
    both.write_row({"k": 2, "a": 5}, timestamp=320, update=True)
    for ts in (150, 250, MAX_TIMESTAMP):
        assert port.lookup_rows([(1,), (2,)], timestamp=ts) == \
            ref.lookup_rows([(1,), (2,)], timestamp=ts)
    both.flush()
    both.compact(retention_timestamp=250)
    _assert_same_chunks(ref, port)
    _assert_same_reads(ref, port, [150, 250, 300, MAX_TIMESTAMP])


def test_timestamp_provider_is_monotone():
    provider = TimestampProvider()
    a, b = provider.generate(), provider.generate()
    assert b > a and provider.last() == b
    provider.observe(b + 100)
    assert provider.generate() == b + 101


def test_vector_values_look_up_from_chunks(tmp_path):
    """A vector value column reads back from a flushed chunk as it does
    from the store. The JAX package's `_decode_chunk_rows` raises
    TypeError there (ROADMAP queue 3); the port answers as the store
    lookup and the snapshot read do."""
    spec = [("k", "int64", "ascending"), ("e", "vector<float, 2>")]
    ref = RefTablet(RefSchema.make(spec), RefStore(str(tmp_path / "ref")))
    port = Tablet(TableSchema.make(spec), FsChunkStore(str(tmp_path / "p")),
                  device=CPU)
    both = _Both(ref, port)
    both.write_row({"k": 1, "e": [1.0, 2.0]}, timestamp=10)
    want = ref.lookup_rows([(1,)])
    assert want == [{"k": 1, "e": [1.0, 2.0]}]
    assert port.lookup_rows([(1,)]) == want
    both.flush()
    _assert_same_chunks(ref, port)
    with pytest.raises(TypeError):
        ref.lookup_rows([(1,)])
    assert port.lookup_rows([(1,)]) == want
    assert port.read_snapshot().to_rows() == ref.read_snapshot().to_rows() \
        == want
