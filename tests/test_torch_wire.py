"""Parity of the port's storage wire format with the JAX package on the CPU.

The varint helpers, the host codec library (`native/`), YSON (text and
binary, on tests/test_yson.py's values), every compression codec present,
and the chunk wire format: `serialize_chunk` must give the JAX package's
blob byte for byte for the same rows and codec (int64, uint64 at and above
2^63, doubles with NaN, ±0.0 and ±inf, booleans, dictionary strings, a
vector column, nulls, an empty chunk, hunked strings), each package must
read the other's blobs to equal chunks, and the decode errors must carry
the reference's codes and messages. Then twins of tests/test_chunk_store.py
and tests/test_hunks.py where they need no client, and the store's
failpoint sites.
"""

import math
import os

import numpy as np
import pytest
import torch

import tests.test_yson as ref_yson_tests
from tests.test_torch_query import _to_port
from ytsaurus_tpu import native as ref_native
from ytsaurus_tpu import yson as ref_yson
from ytsaurus_tpu.chunks import compression as ref_compression
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.encoding import deserialize_chunk as ref_deserialize
from ytsaurus_tpu.chunks.encoding import serialize_chunk as ref_serialize
from ytsaurus_tpu.chunks.store import FsChunkStore as RefStore
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.utils import varint as ref_varint
from ytsaurus_tpu_torch import native, yson
from ytsaurus_tpu_torch.chunks import compression
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.encoding import (
    MAGIC,
    decode_totals,
    deserialize_chunk,
    read_chunk_meta,
    serialize_chunk,
)
from ytsaurus_tpu_torch.chunks.hunks import is_hunk_id
from ytsaurus_tpu_torch.chunks.store import ChunkCache, FsChunkStore
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils import failpoints, varint
from ytsaurus_tpu_torch.yson import YsonEntity, YsonUint64, to_yson_type

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

CPU = "cpu"


def _both_schemas(spec):
    return RefSchema.make(spec), TableSchema.make(spec)


def _chunks(spec, rows):
    ref_schema, schema = _both_schemas(spec)
    return (RefChunk.from_rows(ref_schema, rows),
            ColumnarChunk.from_rows(schema, rows, device=CPU))


def _rows_equal(a: list, b: list) -> bool:
    """Rows equal, NaN equal to NaN and -0.0 told from +0.0."""
    def canon(v):
        if isinstance(v, float):
            return ("nan",) if math.isnan(v) else (v, math.copysign(1, v))
        return v
    return [{k: canon(v) for k, v in r.items()} for r in a] == \
        [{k: canon(v) for k, v in r.items()} for r in b]


# --- varint, the native library, YSON, codecs --------------------------------

VARINTS = [0, 1, 127, 128, 300, 2**32, 2**62, 2**63 - 1, 2**63, 2**64 - 1]


def test_varint_matches_the_reference():
    for v in VARINTS:
        blob = varint.encode_varint_u(v)
        assert blob == ref_varint.encode_varint_u(v)
        assert varint.read_varint_u(blob + b"\x05", 0) == (v, len(blob))
    with pytest.raises(ValueError):
        varint.read_varint_u(b"\x80", 0)
    with pytest.raises(ValueError):
        varint.encode_varint_u(-1)


def test_native_library_builds_in_the_port():
    assert native.lib() is not None
    status = native.status()
    assert status["path"] == "native"
    assert os.path.dirname(status["library"]).endswith(
        os.path.join("ytsaurus_tpu_torch", "_build"))


def test_native_helpers_match_the_reference():
    rng = np.random.default_rng(5)
    values = np.concatenate([
        np.array([0, -1, 1, 2**62, -(2**62), 127, -128, 2**63 - 1, -2**63],
                 dtype=np.int64),
        rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64)])
    blob = native.varint_encode(values)
    assert blob == ref_native.varint_encode(values)
    assert (native.varint_decode(blob, len(values)) == values).all()
    deltas = native.delta_encode(values)
    assert (deltas == ref_native.delta_encode(values)).all()
    assert (native.delta_decode(deltas) == values).all()
    bools = rng.random(1001) < 0.5
    packed = native.bitmap_pack(bools)
    assert packed == ref_native.bitmap_pack(bools)
    assert (native.bitmap_unpack(packed, len(bools)) == bools).all()
    for data in (b"", b"hello world", bytes(range(256)) * 9):
        assert native.checksum(data) == ref_native.checksum(data)
    codes = rng.integers(-2, 12, 500).astype(np.int32)
    table = rng.integers(0, 100, 10).astype(np.int32)
    assert (native.remap_i32(codes, table) ==
            ref_native.remap_i32(codes, table)).all()
    with pytest.raises(ValueError):
        native.bitmap_unpack(b"\x01", 1_000_000)
    with pytest.raises(ValueError):
        native.varint_decode(b"\x80", 1)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("value", ref_yson_tests.CASES,
                         ids=[repr(c)[:30] for c in ref_yson_tests.CASES])
def test_yson_matches_the_reference(value, binary):
    blob = yson.dumps(value, binary=binary)
    assert blob == ref_yson.dumps(value, binary=binary)
    assert yson.loads(blob) == value
    assert yson.loads(ref_yson.dumps(value, binary=binary)) == value
    assert ref_yson.loads(blob) == value


def test_yson_bytes_attributes_and_specials():
    raw = bytes(range(256))
    for binary in (False, True):
        blob = yson.dumps(raw, binary=binary)
        assert blob == ref_yson.dumps(raw, binary=binary)
        assert yson.loads(blob, encoding=None) == raw
    escaped = b"\x00\xff\"quote\\slash\n"
    assert yson.loads(yson.dumps(escaped), encoding=None) == escaped
    value = to_yson_type({"a": 1}, {"attr": "x", "n": 2})
    for binary in (False, True):
        blob = yson.dumps(value, binary=binary)
        assert blob == ref_yson.dumps(ref_yson.to_yson_type(
            {"a": 1}, {"attr": "x", "n": 2}), binary=binary)
        back = yson.loads(blob)
        assert back == {"a": 1} and back.attributes == {"attr": "x", "n": 2}
    entity = yson.loads(yson.dumps(to_yson_type(None, {"type": "table"})))
    assert isinstance(entity, YsonEntity)
    assert entity.attributes == {"type": "table"}
    assert yson.loads(b"5u") == 5 and isinstance(yson.loads(b"5u"),
                                                 YsonUint64)
    assert yson.dumps(YsonUint64(5)) == b"5u"
    for special in (float("nan"), float("inf"), float("-inf"), -0.0):
        for binary in (False, True):
            blob = yson.dumps(special, binary=binary)
            assert blob == ref_yson.dumps(special, binary=binary)
    assert math.isnan(yson.loads(yson.dumps(float("nan"))))
    assert yson.loads(b"{a=1;b=[x;y];c=#}") == \
        {"a": 1, "b": ["x", "y"], "c": None}
    assert yson.loads(b"<append=%true>//tmp/t").attributes == \
        {"append": True}
    assert yson.loads(b"{a=1};{a=2};{a=3}", yson_type="list_fragment") == \
        [{"a": 1}, {"a": 2}, {"a": 3}]


@pytest.mark.parametrize("blob", [
    b"{a=}", b"[1;2", b'"abc\\', b"\x03\x01\x02", b"1.2.3", b"{a=1",
    b"\x01\xff\xff"])
def test_yson_malformed_inputs_raise_as_the_reference(blob):
    with pytest.raises(RefYtError) as ref_err:
        ref_yson.loads(blob)
    with pytest.raises(YtError) as err:
        yson.loads(blob)
    assert str(err.value) == str(ref_err.value)


def test_codec_registry_matches_the_reference():
    assert compression.codec_names() == ref_compression.codec_names()
    payload = bytes(np.random.default_rng(2).integers(
        0, 16, 20_000, dtype=np.uint8)) + b"tail" * 500
    for name in compression.codec_names():
        compress, decompress = compression.get_codec(name)
        ref_compress, ref_decompress = ref_compression.get_codec(name)
        packed = compress(payload)
        assert decompress(packed) == payload
        assert ref_decompress(packed) == payload
        assert packed == ref_compress(payload), name
    with pytest.raises(YtError) as err:
        compression.get_codec("snappy")
    assert err.value.code == 1101


# --- the chunk wire format ----------------------------------------------------

WIDE = [("k", "int64", "ascending"), ("u", "uint64"), ("d", "double"),
        ("b", "boolean"), ("s", "string")]
# tests/test_chunk_store.py's schema: WIDE and an `any` column.
WIDE_ANY = WIDE + [("a", "any")]


def _wide_any_rows(n: int = 300, seed: int = 0) -> list:
    """_wide_rows with test_chunk_store.py's `any` payloads (maps, lists,
    a str, non-UTF-8 bytes and nulls)."""
    rows = _wide_rows(n, seed)
    for i, row in enumerate(rows):
        row["a"] = [{"i": i}, [1, i], "text", b"\xff\xfe", None][i % 5]
    return rows


def _wide_rows(n: int = 300, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    specials = [float("nan"), 0.0, -0.0, float("inf"), float("-inf")]
    rows = []
    for i in range(n):
        rows.append({
            "k": int(rng.integers(-2**62, 2**62)) if i % 11 else i,
            "u": [1, 2**63, 2**63 + 5, 2**64 - 1,
                  int(rng.integers(0, 2**63))][i % 5],
            "d": specials[i % 5] if i % 3 == 0 else
            (float(rng.normal()) if i % 7 else None),
            "b": bool(i % 2) if i % 5 else None,
            "s": f"value-{i % 13}" if i % 3 else None,
        })
    return rows


CHUNK_CASES = {
    "wide": (WIDE, _wide_rows()),
    "wide_any": (WIDE_ANY, _wide_any_rows()),
    "all_null": (WIDE, [{"k": None, "u": None, "d": None, "b": None,
                         "s": None}] * 5),
    "empty": (WIDE, []),
    "one_row": (WIDE, [{"k": -2**63, "u": 2**64 - 1, "d": -0.0,
                        "b": False, "s": ""}]),
    "vector": ([("k", "int64"), ("emb", "vector<float, 4>")],
               [{"k": i, "emb": None if i % 4 == 3 else
                 [i * 0.5, -1.0, 0.0, 1e-3 * i]} for i in range(40)]),
    "sorted_keys": ([("k", "int64", "ascending"), ("v", "string")],
                    [{"k": i * 3, "v": "x" * (i % 5)} for i in range(2000)]),
}


@pytest.mark.parametrize("codec", ["none", "zlib_6", "lzma", "zstd_3"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_serialize_chunk_is_byte_identical(case, codec):
    if codec not in compression.codec_names():
        pytest.skip(f"codec {codec} is not importable here")
    spec, rows = CHUNK_CASES[case]
    ref_chunk, chunk = _chunks(spec, rows)
    blob = serialize_chunk(chunk, codec)
    ref_blob = ref_serialize(ref_chunk, codec)
    assert blob == ref_blob
    # The planes carried across bit for bit give the same blob too.
    assert serialize_chunk(_to_port(ref_chunk), codec) == ref_blob


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_each_package_reads_the_others_blobs(case):
    spec, rows = CHUNK_CASES[case]
    ref_chunk, chunk = _chunks(spec, rows)
    mine = deserialize_chunk(ref_serialize(ref_chunk), device=CPU)
    assert mine.schema == chunk.schema and mine.row_count == len(rows)
    assert _rows_equal(mine.to_rows(), ref_chunk.to_rows())
    theirs = ref_deserialize(serialize_chunk(chunk))
    assert _rows_equal(theirs.to_rows(), ref_chunk.to_rows())
    # Planes bit for bit, capacity included.
    want = _to_port(ref_deserialize(ref_serialize(ref_chunk)))
    assert mine.capacity == want.capacity
    for name, col in want.columns.items():
        got = mine.columns[name]
        assert torch.equal(got.valid, col.valid), name
        a, b = got.data, col.data
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.dtype == torch.float32
                          else torch.int64), \
                b.view(torch.int32 if b.dtype == torch.float32
                       else torch.int64)
        assert torch.equal(a, b), name


def test_deserialize_capacity_and_decode_totals():
    _, chunk = _chunks(*CHUNK_CASES["wide"])
    blob = serialize_chunk(chunk)
    before = decode_totals()
    back = deserialize_chunk(blob, capacity=1024, device=CPU)
    after = decode_totals()
    assert back.capacity == 1024 and back.row_count == chunk.row_count
    assert after["chunks"] == before["chunks"] + 1
    assert after["bytes_copied"] - before["bytes_copied"] == \
        sum(c.data.nbytes + c.valid.nbytes for c in back.columns.values())
    assert after["decode_seconds"] > before["decode_seconds"]


def test_decode_onto_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, chunk = _chunks(*CHUNK_CASES["wide"])
    with pytest.raises(YtError, match="no CUDA device"):
        deserialize_chunk(serialize_chunk(chunk))


def _forge(blob: bytes, edit) -> bytes:
    """The blob with its meta rewritten by `edit(meta)` through YSON."""
    meta = read_chunk_meta(blob)
    start = meta.pop("_data_start")
    edit(meta)
    meta_blob = yson.dumps(meta, binary=True)
    return MAGIC + varint.encode_varint_u(len(meta_blob)) + meta_blob + \
        blob[start:]


def _flip_last(blob: bytes) -> bytes:
    out = bytearray(blob)
    out[-10] ^= 0xFF
    return bytes(out)


def _bad_size(blob: bytes) -> bytes:
    def edit(meta):
        meta["columns"][0]["data"]["raw_size"] += 1
    return _forge(blob, edit)


def _inflated_rows(blob: bytes) -> bytes:
    def edit(meta):
        meta["row_count"] = 10_000_000
    return _forge(blob, edit)


@pytest.mark.parametrize("corrupt", [
    lambda b: b"XXXX" + b[4:], _flip_last, _bad_size, _inflated_rows,
    lambda b: b[:-3]], ids=["magic", "checksum", "size", "row_count",
                             "truncated"])
def test_decode_errors_carry_the_reference_codes(corrupt):
    spec, rows = CHUNK_CASES["wide"]
    ref_chunk, _ = _chunks(spec, rows[:50])
    blob = corrupt(ref_serialize(ref_chunk, "none"))
    with pytest.raises(RefYtError) as ref_err:
        ref_deserialize(blob)
    with pytest.raises(YtError) as err:
        deserialize_chunk(blob, device=CPU)
    assert err.value.code == ref_err.value.code == 1101
    assert str(err.value) == str(ref_err.value)


def test_any_columns_are_not_ported():
    """(Named when the port refused `any` columns.) A blob with an `any`
    column reads back with its payloads, and the port writes it byte for
    byte."""
    ref_schema = RefSchema.make([("k", "int64"), ("a", "any")])
    ref_chunk = RefChunk.from_rows(ref_schema, [(1, {"x": 1}), (2, None),
                                                (3, "text")])
    blob = ref_serialize(ref_chunk)
    back = deserialize_chunk(blob, device=CPU)
    assert back.to_rows() == ref_chunk.to_rows()
    assert back.columns["a"].host_values[:3] == [{"x": 1}, None, "text"]
    assert len(back.columns["a"].host_values) == back.capacity
    assert serialize_chunk(back) == blob


# --- twins of tests/test_chunk_store.py ----------------------------------------

def _store_chunk(n: int = 100, seed: int = 0) -> ColumnarChunk:
    return ColumnarChunk.from_rows(TableSchema.make(WIDE_ANY),
                                   _wide_any_rows(n, seed), device=CPU)


@pytest.mark.parametrize("codec", ["none", "zlib_6", "lzma"])
def test_serialize_roundtrip(codec):
    chunk = _store_chunk(200)
    back = deserialize_chunk(serialize_chunk(chunk, codec), device=CPU)
    assert back.schema == chunk.schema
    assert _rows_equal(back.to_rows(), chunk.to_rows())


def test_compression_shrinks_sorted_keys():
    chunk = _store_chunk(2000)
    assert len(serialize_chunk(chunk, "zlib_6")) < \
        len(serialize_chunk(chunk, "none"))


def test_fs_store_roundtrip(tmp_path):
    store = FsChunkStore(str(tmp_path))
    chunk = _store_chunk(64)
    cid = store.write_chunk(chunk)
    assert store.exists(cid) and store.list_chunks() == [cid]
    assert _rows_equal(store.read_chunk(cid, device=CPU).to_rows(),
                       chunk.to_rows())
    assert store.read_meta(cid)["row_count"] == 64
    assert store.verify_chunk(cid)
    store.remove_chunk(cid)
    assert not store.exists(cid)
    with pytest.raises(YtError) as err:
        store.read_chunk(cid, device=CPU)
    assert err.value.code == 1100


def test_fs_store_files_match_the_reference(tmp_path):
    ref_store = RefStore(str(tmp_path / "ref"))
    store = FsChunkStore(str(tmp_path / "port"))
    spec, rows = CHUNK_CASES["wide"]
    ref_chunk, chunk = _chunks(spec, rows)
    ref_store.write_chunk(ref_chunk, chunk_id="ab" + "1" * 30)
    store.write_chunk(chunk, chunk_id="ab" + "1" * 30)
    for root in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / root / "ab")) == \
            ["ab" + "1" * 30 + ".chunk"]
    assert store.get_blob("ab" + "1" * 30) == \
        ref_store.get_blob("ab" + "1" * 30)
    # Compared as bytes: the double column's min and max are NaN.
    assert yson.dumps(store.read_stats("ab" + "1" * 30), binary=True) == \
        ref_yson.dumps(ref_store.read_stats("ab" + "1" * 30), binary=True)


def test_verify_and_quarantine(tmp_path):
    store = FsChunkStore(str(tmp_path))
    cid = store.write_chunk(_store_chunk(50), codec="none")
    path = store._path(cid)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(_flip_last(blob))
    assert not store.verify_chunk(cid)
    store.quarantine_chunk(cid)
    assert not store.exists(cid) and store.list_chunks() == []
    assert os.path.exists(path + ".quarantine")


def test_chunk_cache_lru(tmp_path):
    store = FsChunkStore(str(tmp_path))
    ids = [store.write_chunk(_store_chunk(32, seed=i)) for i in range(4)]
    one = ChunkCache(store, capacity_bytes=1, device=CPU).get(ids[0])
    size = ChunkCache._chunk_bytes(one)
    assert size == sum(c.data.numel() * c.data.element_size() +
                       c.valid.numel() for c in one.columns.values())
    cache = ChunkCache(store, capacity_bytes=int(size * 2.5), device=CPU)
    for cid in ids:
        cache.get(cid)
    assert cache.misses == 4
    cache.get(ids[-1])
    assert cache.hits == 1
    cache.get(ids[0])  # evicted earlier → miss again
    assert cache.misses == 5


def test_chunk_cache_keeps_an_entry_above_its_budget(tmp_path):
    """The newest entry survives even when it alone exceeds the budget;
    pinned entries never evict; invalidate drops an entry and its pin."""
    store = FsChunkStore(str(tmp_path))
    ids = [store.write_chunk(_store_chunk(32, seed=i)) for i in range(3)]
    cache = ChunkCache(store, capacity_bytes=1, device=CPU)
    first = cache.get(ids[0])
    assert cache.get(ids[0]) is first and cache.hits == 1
    cache.pin(ids[1])
    cache.get(ids[2])
    assert set(cache._entries) == {ids[1], ids[2]}
    cache.unpin(ids[1])
    cache.invalidate(ids[2])
    assert set(cache._entries) == {ids[1]}
    assert cache.used_bytes == ChunkCache._chunk_bytes(cache.get(ids[1]))


def test_chunk_cache_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(YtError, match="no CUDA device"):
        ChunkCache(FsChunkStore(str(tmp_path)))


def test_read_stats_sealed_and_backfilled(tmp_path):
    store = FsChunkStore(str(tmp_path))
    schema = TableSchema.make([("k", "int64"), ("s", "string")])
    chunk = ColumnarChunk.from_rows(
        schema, [{"k": 3, "s": "b"}, {"k": -1, "s": "a"},
                 {"k": 7, "s": None}], device=CPU)
    cid = store.write_chunk(chunk)
    k_stats = dict(store.read_meta(cid)["column_stats"]["k"])
    sketch = k_stats.pop("ndv_sketch")
    assert len(sketch.encode("utf-8") if isinstance(sketch, str)
               else sketch) == 64
    assert k_stats == {"min": -1, "max": 7, "has_null": False}
    stats = store.read_stats(cid)
    assert stats["k"]["max"] == 7 and stats["$row_count"] == 3
    assert stats["s"]["has_null"] is True
    # A chunk sealed before stats existed decodes once and memoizes.
    blob = serialize_chunk(ColumnarChunk.from_rows(
        TableSchema.make([("k", "int64")]), [{"k": 5}, {"k": 9}],
        device=CPU))
    legacy = _forge(blob, lambda meta: meta.pop("column_stats"))
    old = store.put_blob("ab" + "0" * 30, legacy)
    assert store.read_meta(old).get("column_stats") is None
    stats = store.read_stats(old)
    assert {k: stats["k"][k] for k in ("min", "max", "has_null")} == \
        {"min": 5, "max": 9, "has_null": False}
    assert stats["k"].get("ndv_sketch") is not None
    assert store.read_stats(old) is stats
    # A chunk sealed with stats but before the sketch: backfilled on ask.
    no_sketch = _forge(blob, lambda meta: meta["column_stats"]["k"].pop(
        "ndv_sketch"))
    cid = store.put_blob("ac" + "0" * 30, no_sketch)
    assert "ndv_sketch" not in store.read_stats(cid)["k"]
    assert store.read_stats(cid, backfill_sketch=True)["k"]["ndv_sketch"]


def test_erasure_is_not_ported(tmp_path):
    """(Named when the port refused erasure chunks.) Each package reads
    the erasure chunks the other wrote; tests/test_torch_erasure.py holds
    the erasure layer to the reference in full."""
    store = FsChunkStore(str(tmp_path))
    chunk = _store_chunk(8)
    cid = store.write_chunk(chunk, erasure="rs_3_2")
    ref_store = RefStore(str(tmp_path))
    assert _rows_equal(ref_store.read_chunk(cid).to_rows(), chunk.to_rows())
    ref_schema = RefSchema.make([("k", "int64")])
    ref_cid = ref_store.write_chunk(RefChunk.from_rows(ref_schema, [(1,)]),
                                    erasure="rs_3_2")
    assert store.exists(ref_cid) and ref_cid in store.list_chunks()
    assert store.read_chunk(ref_cid, device=CPU).to_rows() == [{"k": 1}]


# --- failpoint sites ------------------------------------------------------------

def test_store_failpoint_sites_are_registered():
    assert {"chunks.store.read", "chunks.store.write", "chunks.store.decode",
            "chunks.store.remove", "chunks.erasure.part_read"} <= \
        set(failpoints._SITES)


def test_torn_write_leaves_no_published_chunk(tmp_path):
    store = FsChunkStore(str(tmp_path))
    with failpoints.active("chunks.store.write=torn-write:times=1"):
        with pytest.raises(OSError, match="torn"):
            store.write_chunk(_store_chunk(16), chunk_id="cd" + "2" * 30)
    assert not store.exists("cd" + "2" * 30)
    cid = store.write_chunk(_store_chunk(16), chunk_id="cd" + "2" * 30)
    assert store.verify_chunk(cid)


def test_read_decode_and_remove_failpoints(tmp_path):
    store = FsChunkStore(str(tmp_path))
    cid = store.write_chunk(_store_chunk(16))
    with failpoints.active("chunks.store.read=error:times=1"):
        with pytest.raises(OSError, match="injected read failure"):
            store.read_chunk(cid, device=CPU)
        assert store.read_chunk(cid, device=CPU).row_count == 16
    with failpoints.active("chunks.store.decode=error:times=1"):
        with pytest.raises(YtError) as err:
            store.read_chunk(cid, device=CPU)
        assert err.value.code == 1101
    with failpoints.active("chunks.store.remove=error:times=1"):
        store.remove_chunk(cid)          # advisory: swallowed, file stays
    assert store.exists(cid)
    store.remove_chunk(cid)
    assert not store.exists(cid)


# --- twins of tests/test_hunks.py ------------------------------------------------

BIG = b"B" * 4096
BIG2 = b"C" * 8192
HUNKED = [("k", "int64"),
          {"name": "v", "type": "string", "max_inline_hunk_size": 256}]


def _hunk_ids(store) -> list:
    return [cid for cid in store.list_chunks() if is_hunk_id(cid)]


def test_chunk_roundtrip_with_hunks(tmp_path):
    store = FsChunkStore(str(tmp_path))
    rows = [{"k": 0, "v": b"small"}, {"k": 1, "v": BIG},
            {"k": 2, "v": BIG2}, {"k": 3, "v": None}]
    cid = store.write_chunk(ColumnarChunk.from_rows(
        TableSchema.make(HUNKED), rows, device=CPU))
    assert len(store.get_blob(cid)) < 2048
    assert len(_hunk_ids(store)) == 2
    meta = read_chunk_meta(store.get_blob(cid))
    assert sorted(meta["hunk_chunk_ids"]) == sorted(_hunk_ids(store))
    assert store.read_chunk(cid, device=CPU).to_rows() == rows


def test_hunked_blobs_match_the_reference(tmp_path):
    rows = [{"k": 0, "v": b"small"}, {"k": 1, "v": BIG},
            {"k": 2, "v": BIG2}, {"k": 3, "v": None}, {"k": 4, "v": BIG}]
    ref_chunk, chunk = _chunks(HUNKED, rows)
    ref_store = RefStore(str(tmp_path / "ref"))
    store = FsChunkStore(str(tmp_path / "port"))
    ref_id = ref_store.write_chunk(ref_chunk)
    cid = store.write_chunk(chunk)
    assert store.get_blob(cid) == ref_store.get_blob(ref_id)
    assert _hunk_ids(store) == _hunk_ids(ref_store)
    for hid in _hunk_ids(store):
        assert store.get_blob(hid) == ref_store.get_blob(hid)
    # Each package reads the other's hunked chunk through its own store.
    assert RefStore(str(tmp_path / "port")).read_chunk(cid).to_rows() == rows
    assert FsChunkStore(str(tmp_path / "ref")).read_chunk(
        ref_id, device=CPU).to_rows() == rows


def test_hunks_content_addressed_no_rewrite(tmp_path):
    store = FsChunkStore(str(tmp_path))
    schema = TableSchema.make(HUNKED)
    c1 = store.write_chunk(ColumnarChunk.from_rows(
        schema, [{"k": 1, "v": BIG}], device=CPU))
    before = _hunk_ids(store)
    store.write_chunk(ColumnarChunk.from_rows(
        schema, [{"k": 2, "v": BIG}, {"k": 3, "v": b"tiny"}], device=CPU))
    assert _hunk_ids(store) == before
    assert store.read_chunk(c1, device=CPU).to_rows() == [{"k": 1, "v": BIG}]


def test_serialize_without_store_keeps_inline():
    blob = serialize_chunk(ColumnarChunk.from_rows(
        TableSchema.make(HUNKED), [{"k": 1, "v": BIG}], device=CPU))
    assert "hunk_chunk_ids" not in read_chunk_meta(blob)


def test_hunk_refs_need_a_store_to_resolve(tmp_path):
    store = FsChunkStore(str(tmp_path))
    cid = store.write_chunk(ColumnarChunk.from_rows(
        TableSchema.make(HUNKED), [{"k": 1, "v": BIG}], device=CPU))
    with pytest.raises(YtError, match="no hunk store") as err:
        deserialize_chunk(store.get_blob(cid), device=CPU)
    assert err.value.code == 1101
