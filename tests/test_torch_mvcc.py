"""Parity of the port's MVCC merge (`ytsaurus_tpu_torch.tablet.mvcc`) with
the JAX package on the CPU.

Random histories come from tests/test_mvcc_vectorized.py's generator
through the JAX `Tablet` (both of its schemas: strings, doubles, booleans,
nulls, partial writes and deletes, and timestamps reused across chunk and
store). Their sources concatenate into one versioned chunk, as the
tablet's read path does; the same bytes go to the JAX `mvcc` functions and
to the port's (carried across with `chunk_from_numpy`, `device="cpu"`).
Every output plane must match bit for bit, and the rows must match the
Python oracles `tablet._mvcc_select` and `_drop_superseded`.
"""

import random

import pytest
import torch

from tests.test_mvcc_vectorized import SCHEMAS, _apply_workload, _tablet
from tests.test_torch_query import _assert_rows, _to_port
from tests.test_torch_sort import _planes_equal
from ytsaurus_tpu.chunks.columnar import concat_chunks as ref_concat
from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
from ytsaurus_tpu.tablet import mvcc as ref_mvcc
from ytsaurus_tpu.tablet.tablet import (
    _drop_superseded,
    _mvcc_select,
    _versioned_sort_key,
    _written,
)
from ytsaurus_tpu.tablet.tablet import versioned_schema as ref_versioned_schema
from ytsaurus_tpu.tablet.timestamp import MAX_TIMESTAMP as REF_MAX_TIMESTAMP
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query import select_rows
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet import mvcc
from ytsaurus_tpu_torch.tablet.tablet import versioned_schema
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

CPU = "cpu"


def _port_schema(schema) -> TableSchema:
    return TableSchema.make([
        (c.name, c.type.value,
         c.sort_order.value if c.sort_order is not None else None)
        for c in schema])


def _merged(t):
    """The tablet's sources concatenated as its vectorized read path does
    (`Tablet._read_snapshot_uncached`)."""
    sources = [t._normalize_versioned(t._decode(cid)) for cid in t.chunk_ids]
    sources += [s.to_versioned_chunk(t._versioned_schema)
                for s in t.passive_stores + [t.active_store]
                if s.store_row_count]
    return ref_concat(sources)


def _history(schema_name: str, seed: int, allow_duplicates=True,
             flush=False):
    schema = SCHEMAS[schema_name]
    rng = random.Random(1000 * seed + len(schema_name))
    t = _tablet(schema)
    max_ts = _apply_workload(t, schema, rng, n_ops=100,
                             allow_duplicates=allow_duplicates)
    if flush:
        t.flush()
    return t, schema, max_ts


def test_versioned_schema_and_max_timestamp_match():
    assert MAX_TIMESTAMP == REF_MAX_TIMESTAMP
    for schema in SCHEMAS.values():
        want = ref_versioned_schema(schema)
        got = versioned_schema(_port_schema(schema))
        assert [c.to_dict() for c in got] == [c.to_dict() for c in want]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("schema_name", sorted(SCHEMAS))
def test_visible_chunk_matches_the_reference(schema_name, seed):
    t, schema, max_ts = _history(schema_name, seed)
    merged = _merged(t)
    port_merged = _to_port(merged)
    port_schema = _port_schema(schema)
    rows = t.versioned_rows_snapshot()
    for ts in (5, max_ts // 3, max_ts // 2, max_ts - 1, max_ts,
               MAX_TIMESTAMP):
        want = ref_mvcc.visible_chunk(merged, schema, ts)
        got = mvcc.visible_chunk(port_merged, port_schema, ts, device=CPU)
        _planes_equal(got, want)
        assert got.sorted_by == want.sorted_by == \
            tuple(schema.key_column_names)
        assert got.to_rows() == _mvcc_select(rows, schema, ts), ts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("schema_name", sorted(SCHEMAS))
def test_sorted_versioned_chunk_matches_the_reference(schema_name, seed):
    t, schema, _ = _history(schema_name, 10 + seed)
    merged = _merged(t)
    want = ref_mvcc.sorted_versioned_chunk(merged, schema)
    got = mvcc.sorted_versioned_chunk(_to_port(merged), _port_schema(schema),
                                      device=CPU)
    _planes_equal(got, want)
    # Python's stable sort by (key, -ts) over the concatenation order.
    oracle = sorted(merged.to_rows(), key=_versioned_sort_key(schema))
    assert got.to_rows() == oracle


@pytest.mark.parametrize("cut", ["low", "mid", "high"])
@pytest.mark.parametrize("seed", range(3))
def test_retained_chunk_matches_the_reference(seed, cut):
    t, schema, max_ts = _history("int_key", 20 + seed,
                                 allow_duplicates=False, flush=True)
    retention = {"low": 5, "mid": max_ts // 2, "high": max_ts + 10}[cut]
    merged = ref_concat([t._normalize_versioned(t._decode(cid))
                         for cid in t.chunk_ids])
    port_schema = _port_schema(schema)
    want = ref_mvcc.retained_chunk(merged, schema, retention)
    got = mvcc.retained_chunk(_to_port(merged), port_schema, retention,
                              device=CPU)
    _planes_equal(got, want)
    value_names = [c.name for c in schema if c.sort_order is None]
    rows = []
    for row in merged.to_rows():
        for name in value_names:
            row[f"$w:{name}"] = _written(row, name)
        rows.append(row)
    rows.sort(key=_versioned_sort_key(schema))
    assert got.to_rows() == _drop_superseded(rows, schema, retention)
    # The compacted versions read as the originals at and after the cut.
    if got.row_count:
        for ts in (retention, max_ts, MAX_TIMESTAMP):
            before = mvcc.visible_chunk(_to_port(merged), port_schema, ts,
                                        device=CPU)
            after = mvcc.visible_chunk(got, port_schema, ts, device=CPU)
            assert after.to_rows() == before.to_rows()


def test_duplicate_timestamp_across_chunk_and_store():
    """The same (key, ts) sealed in a chunk AND rewritten in the store:
    source concatenation order (chunks first) breaks the tie."""
    schema = SCHEMAS["int_key"]
    t = _tablet(schema)
    t.write_row({"k": 1, "a": 1, "b": "chunk", "c": 0.5}, timestamp=100)
    t.flush()
    t.write_row({"k": 1, "a": 2, "b": "store", "c": 0.5}, timestamp=100)
    merged = _merged(t)
    want = ref_mvcc.visible_chunk(merged, schema, MAX_TIMESTAMP)
    got = mvcc.visible_chunk(_to_port(merged), _port_schema(schema),
                             MAX_TIMESTAMP, device=CPU)
    _planes_equal(got, want)
    assert got.to_rows() == t.read_snapshot_reference().to_rows()
    sorted_got = mvcc.sorted_versioned_chunk(
        _to_port(merged), _port_schema(schema), device=CPU)
    assert [r["b"] for r in sorted_got.to_rows()] == [b"chunk", b"store"]


@pytest.mark.parametrize("query", [
    "b, sum(a) AS s, count(*) AS n FROM [//t] GROUP BY b",
    "k, a, c FROM [//t] WHERE a > 0 ORDER BY k LIMIT 7",
])
def test_visible_chunk_then_select_rows(query):
    t, schema, max_ts = _history("int_key", 31)
    merged = _merged(t)
    port_schema = _port_schema(schema)
    for ts in (max_ts // 2, MAX_TIMESTAMP):
        snapshot = ref_mvcc.visible_chunk(merged, schema, ts)
        want = ref_select(query, {"//t": snapshot}).to_rows()
        port_snapshot = mvcc.visible_chunk(_to_port(merged), port_schema, ts,
                                           device=CPU)
        got = select_rows(query, {"//t": port_snapshot},
                          device=CPU).to_rows()
        _assert_rows(got, want, ordered="ORDER BY" in query)


def test_supports_and_the_device_rules():
    schema = SCHEMAS["int_key"]
    assert mvcc.supports(_port_schema(schema))
    assert not mvcc.supports(TableSchema.make([("k", "int64", "ascending"),
                                               ("x", "any")]))
    t, _, _ = _history("int_key", 40)
    port_merged = _to_port(_merged(t))
    with pytest.raises(YtError, match="Unsupported device"):
        mvcc.visible_chunk(port_merged, _port_schema(schema), 10,
                           device="meta")
    if not torch.cuda.is_available():
        for call in (
                lambda: mvcc.visible_chunk(port_merged,
                                           _port_schema(schema), 10),
                lambda: mvcc.sorted_versioned_chunk(port_merged,
                                                    _port_schema(schema)),
                lambda: mvcc.retained_chunk(port_merged,
                                            _port_schema(schema), 10)):
            with pytest.raises(YtError, match="no CUDA device"):
                call()


def _odd_keys_history(with_negative_zero: bool):
    """Versions on keys the test generator does not make: uint64 on both
    sides of 2^63 and doubles with ±inf (and, if asked, -0.0 beside
    +0.0), with deletes and partial writes."""
    from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
    from ytsaurus_tpu.schema import TableSchema as RefSchema
    schema = RefSchema.make([("u", "uint64", "ascending"),
                             ("d", "double", "ascending"), ("x", "int64"),
                             ("y", "string")])
    rng = random.Random(5)
    us = [0, 3, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    ds = [0.0, 1.5, float("inf"), -float("inf")] + \
        ([-0.0] if with_negative_zero else [])
    rows = []
    for ts in range(1, 400):
        tomb = rng.random() < 0.15
        wx = not tomb and rng.random() < 0.7
        wy = not tomb and (not wx or rng.random() < 0.5)
        rows.append({"u": rng.choice(us), "d": rng.choice(ds),
                     "$timestamp": ts, "$tombstone": tomb,
                     "x": rng.randrange(100) if wx else None, "$w:x": wx,
                     "y": rng.choice(["p", "q", None]) if wy else None,
                     "$w:y": wy})
    return schema, RefChunk.from_rows(ref_versioned_schema(schema), rows)


def test_uint64_and_double_keys_match_the_reference():
    schema, merged = _odd_keys_history(with_negative_zero=False)
    port_schema = _port_schema(schema)
    port_merged = _to_port(merged)
    for ts in (150, MAX_TIMESTAMP):
        _planes_equal(mvcc.visible_chunk(port_merged, port_schema, ts,
                                         device=CPU),
                      ref_mvcc.visible_chunk(merged, schema, ts))
    _planes_equal(mvcc.sorted_versioned_chunk(port_merged, port_schema,
                                              device=CPU),
                  ref_mvcc.sorted_versioned_chunk(merged, schema))
    _planes_equal(mvcc.retained_chunk(port_merged, port_schema, 200,
                                      device=CPU),
                  ref_mvcc.retained_chunk(merged, schema, 200))


def test_negative_zero_keys_merge_with_positive_zero():
    """-0.0 and +0.0 are one key to the Python oracles (and to the JAX
    package's `_comparable`, `data + 0.0`; but under jax.jit XLA folds
    that addition away, so the JAX programs keep -0.0 apart in the sort
    and drop or misplace such keys). The port folds -0.0 eagerly and
    matches the oracles."""
    schema, merged = _odd_keys_history(with_negative_zero=True)
    port_schema = _port_schema(schema)
    port_merged = _to_port(merged)
    rows = sorted(merged.to_rows(), key=_versioned_sort_key(schema))
    for ts in (150, MAX_TIMESTAMP):
        got = mvcc.visible_chunk(port_merged, port_schema, ts, device=CPU)
        assert got.to_rows() == _mvcc_select(rows, schema, ts)
    got = mvcc.sorted_versioned_chunk(port_merged, port_schema, device=CPU)
    assert got.to_rows() == rows
    for row in rows:
        for name in ("x", "y"):
            row[f"$w:{name}"] = _written(row, name)
    got = mvcc.retained_chunk(port_merged, port_schema, 200, device=CPU)
    assert got.to_rows() == _drop_superseded(rows, schema, 200)
