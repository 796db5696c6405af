"""Parity of the port's `any` columns with the JAX package on the CPU.

`any` payloads stay on the host (`Column.host_values`) beside an int8
placeholder plane. Twins of tests/test_columnar_chunk.py::
test_any_column_roundtrip and tests/test_chunk_store.py::
test_any_str_roundtrips_as_str; slices, concatenation and the wire format
(blobs byte for byte the reference's); `sort_chunk` and a join carrying
`any` columns giving the reference's rows; a `Tablet` with an `any` value
column written, flushed, read, looked up and compacted as the reference's
is; and the refusals the reference makes (`from_arrays`, the external
sort) made with the same code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_tablet import _assert_same_chunks, _Both
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.columnar import concat_chunks as ref_concat
from ytsaurus_tpu.chunks.encoding import serialize_chunk as ref_serialize
from ytsaurus_tpu.chunks.store import FsChunkStore as RefStore
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.ops.bigsort import external_sort as ref_external_sort
from ytsaurus_tpu.operations.sort_op import sort_chunk as ref_sort_chunk
from ytsaurus_tpu.query import builder as ref_builder
from ytsaurus_tpu.query.engine import evaluator as ref_evaluator
from ytsaurus_tpu.query.engine.joins import execute_join as ref_execute_join
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.tablet.tablet import Tablet as RefTablet
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.chunks.encoding import (
    deserialize_chunk,
    serialize_chunk,
)
from ytsaurus_tpu_torch.chunks.store import FsChunkStore
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
from ytsaurus_tpu_torch.ops.bigsort import external_sort
from ytsaurus_tpu_torch.query import builder
from ytsaurus_tpu_torch.query.engine import evaluator
from ytsaurus_tpu_torch.query.engine.joins import execute_join
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet import mvcc
from ytsaurus_tpu_torch.tablet.tablet import Tablet
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP

torch.set_num_threads(1)

PAYLOADS = [{"x": 1}, [1, 2, 3], None, "text", b"\xff\xfe", 7, -2.5,
            {"deep": [{"a": None}, b"b"]}, True, []]


def _both(spec, rows):
    return (ColumnarChunk.from_rows(TableSchema.make(spec), rows,
                                    device="cpu"),
            RefChunk.from_rows(RefSchema.make(spec), rows))


def test_any_column_roundtrip():
    """Twin of tests/test_columnar_chunk.py::test_any_column_roundtrip."""
    schema = TableSchema.make([("k", "int64"), ("a", "any")])
    rows = [{"k": 1, "a": {"x": 1}}, {"k": 2, "a": [1, 2, 3]},
            {"k": 3, "a": None}]
    chunk = ColumnarChunk.from_rows(schema, rows, device="cpu")
    out = chunk.to_rows()
    assert out[0]["a"] == {"x": 1}
    assert out[1]["a"] == [1, 2, 3]
    assert out[2]["a"] is None
    merged = concat_chunks([chunk, ColumnarChunk.from_rows(
        schema, [{"k": 4, "a": "s"}], device="cpu")])
    assert merged.to_rows()[3]["a"] == "s"


def test_any_str_roundtrips_as_str():
    """Twin of tests/test_chunk_store.py::test_any_str_roundtrips_as_str;
    a payload that is not UTF-8 stays bytes."""
    schema = TableSchema.make([("k", "int64"), ("a", "any")])
    chunk = ColumnarChunk.from_rows(
        schema, [(1, "text"), (2, {"x": "y"}), (3, b"\xff")], device="cpu")
    rows = deserialize_chunk(serialize_chunk(chunk, "none"),
                             device="cpu").to_rows()
    assert rows[0]["a"] == "text" and isinstance(rows[0]["a"], str)
    assert rows[1]["a"] == {"x": "y"}
    assert rows[2]["a"] == b"\xff"


@pytest.mark.parametrize("n", [0, 1, 10, 300])
def test_planes_host_values_and_blobs_match(n):
    spec = [("k", "int64"), ("a", "any"), ("s", "string")]
    rows = [{"k": i, "a": PAYLOADS[i % len(PAYLOADS)],
             "s": f"v{i % 3}"} for i in range(n)]
    chunk, ref = _both(spec, rows)
    col, ref_col = chunk.columns["a"], ref.columns["a"]
    assert col.host_values == ref_col.host_values
    assert col.data.dtype == torch.int8 and not col.data.any()
    assert col.valid.numpy().tolist() == np.asarray(ref_col.valid).tolist()
    for codec in ("none", "zlib_6"):
        assert serialize_chunk(chunk, codec) == ref_serialize(ref, codec)
    parts = [chunk.slice_rows(2, 7), chunk, chunk.slice_rows(5, 5)]
    ref_parts = [ref.slice_rows(2, 7), ref, ref.slice_rows(5, 5)]
    assert parts[0].to_rows() == ref_parts[0].to_rows()
    merged, ref_merged = concat_chunks(parts), ref_concat(ref_parts)
    assert merged.to_rows() == ref_merged.to_rows()
    assert merged.columns["a"].host_values == \
        ref_merged.columns["a"].host_values
    assert serialize_chunk(merged) == ref_serialize(ref_merged)


@pytest.mark.parametrize("keys,descending", [(["k"], False), (["s", "k"],
                                                                True)])
def test_sort_chunk_carries_any(keys, descending):
    rng = np.random.default_rng(1)
    spec = [("k", "int64"), ("s", "string"), ("a", "any")]
    rows = [{"k": int(rng.integers(0, 20)), "s": f"s{int(rng.integers(4))}",
             "a": PAYLOADS[i % len(PAYLOADS)]} for i in range(200)]
    chunk, ref = _both(spec, rows)
    got = sort_chunk(chunk, keys, descending, device="cpu")
    want = ref_sort_chunk(ref, keys, descending)
    assert got.to_rows() == want.to_rows()
    assert serialize_chunk(got) == ref_serialize(want)


@pytest.mark.parametrize("kind", ["JOIN", "LEFT JOIN"])
def test_join_carries_any(kind):
    rng = np.random.default_rng(2)
    spec_t = [("k", "int64"), ("a", "any"), ("v", "int64")]
    spec_f = [("k", "int64"), ("b", "any"), ("w", "int64")]
    rows_t = [{"k": int(rng.integers(0, 12)), "a": PAYLOADS[i % 10],
               "v": i} for i in range(60)]
    rows_f = [{"k": int(rng.integers(0, 9)), "b": PAYLOADS[(i * 3) % 10],
               "w": i} for i in range(25)]
    t, ref_t = _both(spec_t, rows_t)
    f, ref_f = _both(spec_f, rows_f)
    query = f"k, v, f.w FROM [//t] {kind} [//f] AS f ON k = f.k"
    outs = []
    for bld, ev, join_fn, chunk, foreign, schema_cls, extra in (
            (builder, evaluator, execute_join, t, f, TableSchema, ()),
            (ref_builder, ref_evaluator, ref_execute_join, ref_t, ref_f,
             RefSchema, ({},))):
        plan = bld.build_query(query, {"//t": chunk.schema,
                                       "//f": foreign.schema})
        # Carry every column of both sides, the `any` ones included.
        join = dataclasses.replace(
            plan.joins[0],
            foreign_columns=tuple(foreign.schema.column_names))
        namespace = [(c.name, c.type.value) for c in chunk.schema]
        namespace = ev._extend_namespace(namespace, join)
        outs.append(join_fn(chunk, schema_cls.make(namespace), join,
                            foreign, *extra))
    got, want = outs
    assert got.row_count == want.row_count
    assert got.to_rows() == want.to_rows()
    assert any(r["f.b"] is not None for r in got.to_rows())


def test_tablet_with_an_any_column(tmp_path):
    spec = [("k", "int64", "ascending"), ("a", "any"), ("v", "int64")]
    ref = RefTablet(RefSchema.make(spec), RefStore(str(tmp_path / "ref")))
    port = Tablet(TableSchema.make(spec), FsChunkStore(str(tmp_path / "p")),
                  device="cpu")
    # An `any` column keeps the tablet on the Python merge.
    assert not mvcc.supports(port.schema)
    both = _Both(ref, port)
    ts = 1
    for round_ in range(3):
        for i in range(12):
            both.write_row({"k": i % 7, "a": PAYLOADS[(i + round_) % 10],
                            "v": i * round_}, timestamp=ts)
            ts += 1
        both.write_row({"k": 3, "v": 100 + round_}, timestamp=ts,
                       update=True)
        ts += 1
        both.delete_row((round_,), timestamp=ts)
        ts += 1
        if round_ < 2:
            both.flush()
    _assert_same_chunks(ref, port)
    for at in (5, ts // 2, ts, MAX_TIMESTAMP):
        assert port.read_snapshot(at).to_rows() == \
            ref.read_snapshot(at).to_rows(), at
    keys = [(i,) for i in range(9)]
    assert port.lookup_rows(keys) == ref.lookup_rows(keys)
    assert port.lookup_rows(keys, ts // 2) == ref.lookup_rows(keys, ts // 2)
    both.flush()
    both.compact(retention_timestamp=ts // 2)
    _assert_same_chunks(ref, port)
    assert port.read_snapshot().to_rows() == ref.read_snapshot().to_rows()
    assert port.lookup_rows(keys) == ref.lookup_rows(keys)


def test_refusals_match():
    schema, ref_schema = TableSchema.make([("a", "any")]), \
        RefSchema.make([("a", "any")])
    with pytest.raises(RefYtError) as ref_err:
        RefChunk.from_arrays(ref_schema, {"a": np.zeros(3)})
    with pytest.raises(YtError) as err:
        ColumnarChunk.from_arrays(schema, {"a": np.zeros(3)}, device="cpu")
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))
    spec = [("k", "int64"), ("a", "any")]
    chunk, ref = _both(spec, [(1, "x"), (2, None)])
    with pytest.raises(RefYtError) as ref_err:
        list(ref_external_sort([lambda: ref], ["k"]))
    with pytest.raises(YtError) as err:
        list(external_sort([lambda: chunk], ["k"], device="cpu"))
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))
