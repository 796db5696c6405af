"""Parity of the port's row formats and Arrow interop with the JAX package.

`ytsaurus_tpu_torch.formats` against `ytsaurus_tpu.formats`: `dumps_rows`
byte for byte in yson, json, dsv and schemaful_dsv, and `dumps_skiff`,
over rows with int64, uint64 at and above 2^63, doubles (NaN, ±0.0, ±inf),
booleans, bytes holding tabs, `=`, backslashes and newlines, nulls and
`any` values; `loads_rows` / `loads_skiff` giving the reference's rows and
errors; twins of the skiff tests of tests/test_formats_interop.py.
`ytsaurus_tpu_torch.arrow` against `ytsaurus_tpu.arrow`: `chunk_to_arrow`
of the port's chunk equal to the reference's table, IPC round trips,
`arrow_schema_to_table_schema`, twins of
tests/test_vector.py::test_arrow_round_trip and
tests/test_formats_interop.py::test_arrow_zero_copy_numeric_plane, and the
error without pyarrow. The Arrow tests skip where pyarrow is absent.
"""

import math
import sys

import numpy as np
import pytest
import torch

from ytsaurus_tpu import formats as ref_formats
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import formats
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import TableSchema, VectorType

torch.set_num_threads(1)

SPEC = [("i", "int64"), ("u", "uint64"), ("d", "double"), ("b", "boolean"),
        ("s", "string"), ("a", "any")]
COLUMNS = [c[0] for c in SPEC]
SPECIAL_DOUBLES = [float("nan"), 0.0, -0.0, float("inf"), float("-inf"),
                   1.5, -2.25e-300]
NASTY = [b"plain", b"tab\there", b"key=value", b"back\\slash", b"new\nline",
         b"all\t=\\\n", b"", b"\\t literal", b"=", b"trailing\\"]


def _rows(n=60, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {
            "i": [0, -1, 2**63 - 1, -2**63, int(rng.integers(-2**40, 2**40))
                  ][i % 5],
            "u": [0, 2**63, 2**64 - 1, 2**63 + 7, int(rng.integers(0, 2**62))
                  ][i % 5],
            "d": SPECIAL_DOUBLES[i % len(SPECIAL_DOUBLES)],
            "b": bool(i % 2),
            "s": NASTY[i % len(NASTY)],
            "a": [{"k": i, "v": [1, 2.5, "x"]}, [i, None], "text", i,
                  {"nested": {"deep": b"bytes"}}][i % 5],
        }
        if nulls and i % 4 == 3:
            row[COLUMNS[i % len(COLUMNS)]] = None
        rows.append(row)
    return rows


def _canon(value):
    if isinstance(value, float):
        return ("nan",) if math.isnan(value) else \
            (value, math.copysign(1.0, value))
    if isinstance(value, dict):
        return {k: _canon(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_canon(v) for v in value]
    return value


def _text_rows(rows):
    """DSV carries no `any` values (their text is Python's repr)."""
    return [{k: v for k, v in r.items() if k != "a"} for r in rows]


@pytest.mark.parametrize("fmt", ["yson", "json", "dsv", "schemaful_dsv"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dumps_rows_is_byte_identical(fmt, seed):
    rows = _rows(seed=seed)
    if fmt in ("dsv", "schemaful_dsv"):
        rows = _text_rows(rows)
    columns = COLUMNS[:-1] if fmt == "schemaful_dsv" else None
    blob = formats.dumps_rows(rows, fmt, columns=columns)
    assert blob == ref_formats.dumps_rows(rows, fmt, columns=columns)
    got = formats.loads_rows(blob, fmt, columns=columns)
    want = ref_formats.loads_rows(blob, fmt, columns=columns)
    assert _canon(got) == _canon(want)
    assert len(got) == len(rows)


def test_dsv_escapes_round_trip():
    rows = [{"k=ey\t": v.decode("latin-1"), "n": None} for v in NASTY]
    blob = formats.dumps_rows(rows, "dsv")
    assert blob == ref_formats.dumps_rows(rows, "dsv")
    back = formats.loads_rows(blob, "dsv")
    assert back == ref_formats.loads_rows(blob, "dsv")
    assert back == [{"k=ey\t": v.decode("latin-1")} for v in NASTY]
    # Fields without an '=' and stray escapes parse as the reference's.
    odd = b"novalue\ta\\qb=c\\\td=\n\n=x\n"
    assert formats.loads_rows(odd, "dsv") == \
        ref_formats.loads_rows(odd, "dsv")


def test_empty_and_refused_formats():
    for fmt in ("yson", "json", "dsv"):
        assert formats.dumps_rows([], fmt) == \
            ref_formats.dumps_rows([], fmt)
        assert formats.loads_rows(b"", fmt) == \
            ref_formats.loads_rows(b"", fmt)
    for call in (lambda m: m.dumps_rows([{"a": 1}], "xml"),
                 lambda m: m.loads_rows(b"", "xml"),
                 lambda m: m.dumps_rows([{"a": 1}], "schemaful_dsv"),
                 lambda m: m.loads_rows(b"1", "schemaful_dsv", ["a", "b"])):
        with pytest.raises(RefYtError) as ref_err:
            call(ref_formats)
        with pytest.raises(YtError) as err:
            call(formats)
        assert err.value.code == ref_err.value.code
        assert str(err.value) == str(ref_err.value)
    with pytest.raises(YtError):
        formats.loads_rows(b"1;2;", "yson")


def _schemas(spec):
    return TableSchema.make(spec), RefSchema.make(spec)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skiff_is_byte_identical(seed):
    schema, ref_schema = _schemas(SPEC)
    rows = _rows(seed=seed)
    blob = formats.dumps_skiff(rows, schema)
    assert blob == ref_formats.dumps_skiff(rows, ref_schema)
    assert _canon(formats.loads_skiff(blob, schema)) == \
        _canon(ref_formats.loads_skiff(blob, ref_schema))


def test_skiff_errors_match():
    schema, ref_schema = _schemas(SPEC)
    blob = formats.dumps_skiff(_rows(8), schema)
    for cut in range(1, 40):
        with pytest.raises(RefYtError) as ref_err:
            ref_formats.loads_skiff(blob[:-cut], ref_schema)
        with pytest.raises(YtError) as err:
            formats.loads_skiff(blob[:-cut], schema)
        assert (err.value.code, str(err.value)) == \
            (ref_err.value.code, str(ref_err.value))
    bad = bytearray(blob)
    bad[2] = 7                                  # a variant tag
    with pytest.raises(YtError) as err:
        formats.loads_skiff(bytes(bad), schema)
    with pytest.raises(RefYtError) as ref_err:
        ref_formats.loads_skiff(bytes(bad), ref_schema)
    assert str(err.value) == str(ref_err.value)
    vec, ref_vec = _schemas([("e", "vector<float, 2>")])
    with pytest.raises(YtError) as err:
        formats.dumps_skiff([{"e": [1.0, 2.0]}], vec)
    with pytest.raises(RefYtError) as ref_err:
        ref_formats.dumps_skiff([{"e": [1.0, 2.0]}], ref_vec)
    assert err.value.code == ref_err.value.code


# --- twins of tests/test_formats_interop.py's skiff tests ---------------------

INTEROP = TableSchema.make([
    ("k", "int64"), ("u", "uint64"), ("x", "double"),
    ("flag", "boolean"), ("name", "string"),
])

INTEROP_ROWS = [
    {"k": -5, "u": 2 ** 63, "x": 1.5, "flag": True, "name": b"alpha"},
    {"k": 7, "u": 0, "x": -0.25, "flag": False, "name": b"beta"},
    {"k": None, "u": None, "x": None, "flag": None, "name": None},
]


def test_skiff_roundtrip():
    blob = formats.dumps_skiff(INTEROP_ROWS, INTEROP)
    assert formats.loads_skiff(blob, INTEROP) == INTEROP_ROWS


def test_skiff_required_dense():
    schema = TableSchema.make([
        {"name": "k", "type": "int64", "required": True},
        {"name": "x", "type": "double", "required": True}])
    blob = formats.dumps_skiff([{"k": 1, "x": 2.0}], schema)
    # Required columns carry no variant tag: row = u16 + 8 + 8 bytes.
    assert len(blob) == 18
    assert formats.loads_skiff(blob, schema) == [{"k": 1, "x": 2.0}]
    with pytest.raises(YtError):
        formats.dumps_skiff([{"k": None, "x": 1.0}], schema)


def test_skiff_truncation_raises():
    blob = formats.dumps_skiff(INTEROP_ROWS, INTEROP)
    for cut in (1, 3, 9):
        with pytest.raises(YtError):
            formats.loads_skiff(blob[:-cut], INTEROP)


# --- Arrow -------------------------------------------------------------------

ARROW_SPEC = SPEC + [("e", "vector<float, 3>"), ("n", "null")]


def _arrow_rows(n=40, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    rows = _rows(n, seed, nulls=nulls)
    for i, row in enumerate(rows):
        row["e"] = None if nulls and i % 6 == 5 else \
            [float(x) for x in rng.integers(-4, 5, 3)]
        row["n"] = None
        if isinstance(row["d"], float) and math.isnan(row["d"]):
            row["d"] = 0.5          # arrow's equals() tells NaN from NaN
    return rows


@pytest.mark.parametrize("nulls", [False, True])
def test_chunk_to_arrow_equals_the_reference(nulls):
    pytest.importorskip("pyarrow")
    from ytsaurus_tpu import arrow as ref_arrow
    from ytsaurus_tpu_torch import arrow
    rows = _arrow_rows(nulls=nulls)
    chunk = ColumnarChunk.from_rows(TableSchema.make(ARROW_SPEC), rows,
                                    device="cpu")
    ref_chunk = RefChunk.from_rows(RefSchema.make(ARROW_SPEC), rows)
    table = arrow.chunk_to_arrow(chunk)
    ref_table = ref_arrow.chunk_to_arrow(ref_chunk)
    assert table.schema.equals(ref_table.schema)
    assert table.equals(ref_table)
    blob = arrow.chunks_to_arrow_ipc([chunk, chunk.slice_rows(3, 11)])
    assert blob == ref_arrow.chunks_to_arrow_ipc(
        [ref_chunk, ref_chunk.slice_rows(3, 11)])
    assert arrow.arrow_ipc_to_rows(blob) == ref_arrow.arrow_ipc_to_rows(blob)


def test_arrow_schema_to_table_schema_matches():
    pa = pytest.importorskip("pyarrow")
    from ytsaurus_tpu import arrow as ref_arrow
    from ytsaurus_tpu_torch import arrow
    schema = pa.schema([
        ("a", pa.int32()), ("b", pa.uint16()), ("c", pa.float32()),
        ("d", pa.bool_()), ("e", pa.string()), ("f", pa.large_binary()),
        ("g", pa.dictionary(pa.int32(), pa.binary())),
        ("h", pa.list_(pa.float32(), 7))])
    got = arrow.arrow_schema_to_table_schema(schema)
    assert got.to_dict() == \
        ref_arrow.arrow_schema_to_table_schema(schema).to_dict()
    assert isinstance(got.get("h").type, VectorType)
    bad = pa.schema([("t", pa.timestamp("s"))])
    with pytest.raises(YtError) as err:
        arrow.arrow_schema_to_table_schema(bad)
    with pytest.raises(RefYtError) as ref_err:
        ref_arrow.arrow_schema_to_table_schema(bad)
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))


def test_arrow_round_trip():
    """Twin of tests/test_vector.py::test_arrow_round_trip."""
    pytest.importorskip("pyarrow")
    import tests.test_vector as ref_vector_tests
    from ytsaurus_tpu_torch.arrow import (
        arrow_ipc_to_rows,
        arrow_schema_to_table_schema,
        chunk_to_arrow,
        chunks_to_arrow_ipc,
    )
    dim = ref_vector_tests.DIM
    spec = [(c.name, c.type.value if not hasattr(c.type, "dim")
             else f"vector<float, {c.type.dim}>")
            for c in ref_vector_tests.SCHEMA]
    rows = ref_vector_tests._corpus(24, seed=3, null_every=5)
    chunk = ColumnarChunk.from_rows(TableSchema.make(spec), rows,
                                    device="cpu")
    table = chunk_to_arrow(chunk)
    assert str(table.schema.field("emb").type).startswith("fixed_size_list")
    back = arrow_ipc_to_rows(chunks_to_arrow_ipc([chunk]))
    for want, got in zip(rows, back):
        assert got["emb"] == want["emb"]
    ts = arrow_schema_to_table_schema(table.schema)
    emb = next(c for c in ts if c.name == "emb")
    assert isinstance(emb.type, VectorType) and emb.type.dim == dim


def test_arrow_zero_copy_numeric_plane():
    """Twin of tests/test_formats_interop.py::test_arrow_zero_copy_numeric_
    plane: a CPU plane is handed to Arrow without a copy."""
    pytest.importorskip("pyarrow")
    from ytsaurus_tpu_torch.arrow import chunk_to_arrow
    chunk = ColumnarChunk.from_arrays(
        TableSchema.make([("v", "int64")]),
        {"v": np.arange(1000, dtype=np.int64)}, device="cpu")
    table = chunk_to_arrow(chunk)
    assert table.column("v").to_pylist()[:3] == [0, 1, 2]
    assert table.num_rows == 1000


def test_arrow_without_pyarrow_raises_the_reference_error(monkeypatch):
    from ytsaurus_tpu_torch import arrow
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    chunk = ColumnarChunk.from_rows(TableSchema.make([("v", "int64")]),
                                    [(1,)], device="cpu")
    with pytest.raises(YtError, match="pyarrow is not available") as err:
        arrow.chunk_to_arrow(chunk)
    assert err.value.code == EErrorCode.QueryUnsupported
