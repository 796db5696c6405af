"""Parity of the port's erasure layer with the JAX package on the CPU.

`ytsaurus_tpu_torch.chunks.erasure` against `ytsaurus_tpu.chunks.erasure`:
the parts of every codec byte for byte over blobs of 0, 1, k - 1 and 4097
bytes and 1 MiB, every erasure pattern up to one beyond each codec's
tolerance decoded or refused as the reference decodes or refuses it (with
the same error code), `repair_part` and `locality_group`. Then the store's
erasure layout against `ytsaurus_tpu.chunks.store.FsChunkStore`: the same
files for the same chunk, each package reading the other's, repair on read
after damage (rows and rewritten files equal), verify, quarantine, the
codec peek, remove and list, and the two erasure failpoint sites. Last,
the 10 tests of tests/test_erasure.py run on the port with the module's
names pointed at it.
"""

import os
from itertools import combinations

import numpy as np
import pytest
import torch

import tests.test_erasure as ref_tests
import ytsaurus_tpu.chunks as ref_chunks_pkg
import ytsaurus_tpu.chunks.store as ref_store_mod
import ytsaurus_tpu.schema as ref_schema_mod
from ytsaurus_tpu.chunks import erasure as ref_erasure
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.store import FsChunkStore as RefStore
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.utils import failpoints as ref_failpoints
from ytsaurus_tpu_torch.chunks import erasure
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.store import FsChunkStore, repair_totals
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils import failpoints, tracing

torch.set_num_threads(1)

CODECS = ("rs_6_3", "rs_3_2", "lrc_12_2_2")
# How many lost parts every pattern of each codec survives.
TOLERANCE = {"rs_6_3": 3, "rs_3_2": 2, "lrc_12_2_2": 3}
CID = "ab" + "7" * 30


def _blob(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _outcome(codec, parts, size):
    """The decoded blob, or the error code of the refusal."""
    try:
        return codec.decode(parts, size)
    except (YtError, RefYtError) as e:
        return ("error", e.code)


# --- the codec ---------------------------------------------------------------

@pytest.mark.parametrize("size", ["0", "1", "k-1", "4097", "1MiB"])
@pytest.mark.parametrize("name", CODECS)
def test_parts_are_byte_identical(name, size):
    codec, ref = erasure.get_erasure_codec(name), \
        ref_erasure.get_erasure_codec(name)
    n = {"0": 0, "1": 1, "k-1": codec.data_parts - 1, "4097": 4097,
         "1MiB": 1 << 20}[size]
    blob = _blob(n, seed=n)
    parts = codec.encode(blob)
    assert parts == ref.encode(blob)
    assert len(parts) == codec.total_parts
    assert codec.decode(parts, n) == blob
    lost = list(parts)
    lost[0] = None
    assert codec.decode(lost, n) == blob
    assert codec.encode_parts(blob, [codec.total_parts - 1, 0]) == \
        [parts[-1], parts[0]]


@pytest.mark.parametrize("name", CODECS)
def test_generators_and_groups_match(name):
    codec, ref = erasure.get_erasure_codec(name), \
        ref_erasure.get_erasure_codec(name)
    assert np.array_equal(codec.generator, ref.generator)
    assert (codec.data_parts, codec.parity_parts, codec.groups) == \
        (ref.data_parts, ref.parity_parts, ref.groups)
    for i in range(codec.total_parts):
        assert codec.locality_group(i) == ref.locality_group(i)


def test_gf_tables_match():
    assert np.array_equal(erasure._EXP, ref_erasure._EXP)
    assert np.array_equal(erasure._LOG, ref_erasure._LOG)
    assert erasure._EXP.dtype == np.uint8 and erasure._LOG.dtype == np.int32
    for a in range(256):
        for b in (0, 1, 2, 3, 29, 142, 255):
            assert erasure._MUL[a, b] == ref_erasure._gf_mul(a, b)
    m = np.random.default_rng(3).integers(0, 256, (5, 5), dtype=np.uint8)
    data = np.random.default_rng(4).integers(0, 256, (5, 333),
                                             dtype=np.uint8)
    assert np.array_equal(erasure._gf_matmul_vec(m, data),
                          ref_erasure._gf_matmul_vec(m, data))


@pytest.mark.parametrize("name", CODECS)
def test_every_erasure_pattern_decodes_or_is_refused_alike(name):
    codec, ref = erasure.get_erasure_codec(name), \
        ref_erasure.get_erasure_codec(name)
    blob = _blob(997, seed=11)
    encoded = codec.encode(blob)
    refused = 0
    for count in range(1, TOLERANCE[name] + 2):
        for lost in combinations(range(codec.total_parts), count):
            parts = [None if i in lost else p for i, p in enumerate(encoded)]
            got, want = _outcome(codec, parts, len(blob)), \
                _outcome(ref, parts, len(blob))
            assert got == want, lost
            if count <= TOLERANCE[name]:
                assert got == blob, lost
            refused += isinstance(got, tuple)
    assert refused > 0          # one beyond the tolerance, some fail


@pytest.mark.parametrize("name", CODECS)
def test_repair_part_matches(name):
    codec, ref = erasure.get_erasure_codec(name), \
        ref_erasure.get_erasure_codec(name)
    blob = _blob(1500, seed=5)
    encoded = codec.encode(blob)
    rng = np.random.default_rng(6)
    for index in range(codec.total_parts):
        group = codec.locality_group(index)
        # Only the group (when there is one), then a random survivor set.
        keep = set(group) if group else set(range(codec.total_parts))
        for extra in range(3):
            parts = [p if i in keep and i != index else None
                     for i, p in enumerate(encoded)]
            try:
                want = ref.repair_part(parts, index)
            except RefYtError as e:
                with pytest.raises(YtError) as err:
                    codec.repair_part(parts, index)
                assert err.value.code == e.code
            else:
                assert codec.repair_part(parts, index) == want == \
                    encoded[index]
            keep = set(rng.choice(codec.total_parts, codec.data_parts + 1,
                                  replace=False).tolist())


def test_unknown_codec_raises_alike():
    with pytest.raises(RefYtError) as ref_err:
        ref_erasure.get_erasure_codec("rs_9_9")
    with pytest.raises(YtError) as err:
        erasure.get_erasure_codec("rs_9_9")
    assert err.value.code == ref_err.value.code
    assert str(err.value) == str(ref_err.value)


# --- the store ---------------------------------------------------------------

SPEC = [("k", "int64", "ascending"), ("s", "string"), ("d", "double"),
        ("a", "any")]


def _rows(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"k": i, "s": f"row-{i % 17}".encode() if i % 5 else None,
             "d": float(rng.normal()), "a": [i, {"x": i}] if i % 3 else None}
            for i in range(n)]


def _stores(tmp_path, name="lrc_12_2_2", n=700):
    """Both packages' stores holding the same chunk under CID."""
    rows = _rows(n)
    ref_store = RefStore(str(tmp_path / "ref"))
    store = FsChunkStore(str(tmp_path / "port"))
    ref_store.write_chunk(RefChunk.from_rows(RefSchema.make(SPEC), rows),
                          chunk_id=CID, erasure=name)
    store.write_chunk(ColumnarChunk.from_rows(TableSchema.make(SPEC), rows,
                                              device="cpu"),
                      chunk_id=CID, erasure=name)
    return ref_store, store, rows


def _files(store) -> dict:
    sub = os.path.join(store.root, CID[:2])
    out = {}
    for name in sorted(os.listdir(sub)):
        with open(os.path.join(sub, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("name", CODECS)
def test_store_files_match_and_cross_read(tmp_path, name):
    ref_store, store, rows = _stores(tmp_path, name)
    files = _files(store)
    assert files == _files(ref_store)
    codec = erasure.get_erasure_codec(name)
    assert sorted(files) == sorted(
        [f"{CID}.part{i}" for i in range(codec.total_parts)]
        + [f"{CID}.erasure"])
    assert RefStore(store.root).read_chunk(CID).to_rows() == rows
    assert FsChunkStore(ref_store.root).read_chunk(
        CID, device="cpu").to_rows() == rows
    assert store.get_blob(CID) == ref_store.get_blob(CID)
    assert store.read_meta(CID)["row_count"] == len(rows)


DAMAGE = {"lrc_12_2_2": [(1,), (7,), (12,), (14,), (1, 14), (1, 13),
                         (0, 7), (2, 3, 12), (0, 6, 15), (4, 5, 13)],
          "rs_6_3": [(0,), (6,), (1, 4, 7), (0, 1, 2)],
          "rs_3_2": [(2,), (0, 4), (1, 3)]}


@pytest.mark.parametrize("name,lost", [(n, lost) for n in CODECS
                                       for lost in DAMAGE[n]])
def test_repair_on_read_matches(tmp_path, name, lost):
    ref_store, store, rows = _stores(tmp_path, name)
    for s in (ref_store, store):
        for i in lost:
            os.unlink(s._part_path(CID, i))
    before = repair_totals()
    assert store.read_chunk(CID, device="cpu").to_rows() == \
        ref_store.read_chunk(CID).to_rows() == rows
    after = repair_totals()
    assert _files(store) == _files(ref_store)     # every part rebuilt
    # A lost data part makes a repair, which rewrites every lost part; a
    # lost parity part alone is not seen by the fast path.
    repaired = min(lost) < erasure.get_erasure_codec(name).data_parts
    assert after["repairs"] - before["repairs"] == int(repaired)
    assert after["parts_rewritten"] - before["parts_rewritten"] == \
        (len(lost) if repaired else 0)
    assert store.verify_chunk(CID)


def test_single_part_repair_reads_its_locality_group(tmp_path):
    _, store, rows = _stores(tmp_path)
    codec = erasure.get_erasure_codec("lrc_12_2_2")
    clean = _files(store)
    site = failpoints._SITES["chunks.erasure.part_read"]
    for lost in (3, 9):
        os.unlink(store._part_path(CID, lost))
        with tracing.start_span("test.read") as root:
            with failpoints.active("chunks.erasure.part_read=delay:ms=0"):
                hits = site.hits
                assert store.read_chunk(CID, device="cpu").to_rows() == rows
                reads = site.hits - hits
        # The 12 data parts, then only the lost part's local parity.
        assert reads == codec.data_parts + 1
        repair = [r for r in tracing.get_collector().find(root.trace_id)
                  if r.name == "chunk.erasure_repair"]
        assert [(r.tags["local"], r.tags["parts_read"],
                 r.tags["lost_parts"]) for r in repair] == \
            [(True, codec.data_parts + 1, 1)]
        assert _files(store) == clean
    # A lost parity part is not read on the fast path: no repair then.
    os.unlink(store._part_path(CID, 14))
    with failpoints.active("chunks.erasure.part_read=delay:ms=0"):
        hits = site.hits
        assert store.read_chunk(CID, device="cpu").to_rows() == rows
        assert site.hits - hits == codec.data_parts
    assert not os.path.exists(store._part_path(CID, 14))


def test_unrecoverable_pattern_raises_the_reference_code(tmp_path):
    ref_store, store, _ = _stores(tmp_path)
    for s in (ref_store, store):
        for i in (0, 1, 2, 12):
            os.unlink(s._part_path(CID, i))
    with pytest.raises(RefYtError) as ref_err:
        ref_store.read_chunk(CID)
    with pytest.raises(YtError) as err:
        store.read_chunk(CID, device="cpu")
    assert err.value.code == ref_err.value.code
    assert not store.verify_chunk(CID) and not ref_store.verify_chunk(CID)


def test_verify_quarantine_codec_remove_list(tmp_path):
    ref_store, store, _ = _stores(tmp_path, "rs_6_3")
    assert store.verify_chunk(CID)
    assert store.erasure_codec_of(CID) == ref_store.erasure_codec_of(CID) \
        == "rs_6_3"
    plain = store.write_chunk(ColumnarChunk.from_rows(
        TableSchema.make(SPEC), _rows(5), device="cpu"))
    assert store.erasure_codec_of(plain) is None
    assert store.list_chunks() == sorted([CID, plain])
    assert [os.path.basename(p) for p in store._chunk_paths(CID)] == \
        [os.path.basename(p) for p in ref_store._chunk_paths(CID)]
    for s in (ref_store, store):
        s.quarantine_chunk(CID)
    assert _files(store) == _files(ref_store)
    assert all(name.endswith(".quarantine") for name in _files(store))
    assert not store.exists(CID) and store.list_chunks() == [plain]
    ref_store2, store2, _ = _stores(tmp_path / "again", "rs_3_2")
    store2.remove_chunk(CID)
    ref_store2.remove_chunk(CID)
    assert _files(store2) == _files(ref_store2) == {}
    assert not store2.exists(CID) and store2.list_chunks() == []
    with pytest.raises(YtError) as err:
        store2.read_chunk(CID, device="cpu")
    assert err.value.code == 1100


def test_chunk_paths_with_a_damaged_meta_sweep_wide(tmp_path):
    _, store, _ = _stores(tmp_path, "rs_3_2")
    with open(store._erasure_meta_path(CID), "wb") as f:
        f.write(b"\x00garbage")
    paths = store._chunk_paths(CID)
    assert len(paths) == 2 + 32
    store.remove_chunk(CID)
    assert not os.listdir(os.path.join(store.root, CID[:2]))


def test_meta_file_bytes_and_bytes_codec_name(tmp_path):
    ref_store, store, _ = _stores(tmp_path, "rs_3_2")
    with open(store._erasure_meta_path(CID), "rb") as f:
        meta = f.read()
    with open(ref_store._erasure_meta_path(CID), "rb") as f:
        assert meta == f.read()
    from ytsaurus_tpu_torch import yson
    assert meta == yson.dumps({"codec": "rs_3_2",
                               "size": len(store.get_blob(CID))},
                              binary=True)
    # A meta whose codec name reads back as bytes still names the codec.
    size = len(store.get_blob(CID))
    with open(store._erasure_meta_path(CID), "wb") as f:
        f.write(yson.dumps({"codec": b"rs_3_2", "size": size}, binary=True))
    assert store.erasure_codec_of(CID) == "rs_3_2"
    assert store.verify_chunk(CID)


def test_erasure_failpoint_sites(tmp_path):
    ref_store, store, rows = _stores(tmp_path, "rs_6_3")
    assert {"chunks.erasure.decode", "chunks.erasure.part_read"} <= \
        set(failpoints._SITES)
    with failpoints.active("chunks.erasure.decode=error:times=1"):
        with pytest.raises(YtError) as err:
            store.read_chunk(CID, device="cpu")
    with ref_failpoints.active("chunks.erasure.decode=error:times=1"):
        with pytest.raises(RefYtError) as ref_err:
            ref_store.read_chunk(CID)
    assert err.value.code == ref_err.value.code
    assert str(err.value) == str(ref_err.value)
    # A part read that fails is a lost part: decoded through and rebuilt.
    os.unlink(store._part_path(CID, 0))
    os.unlink(ref_store._part_path(CID, 0))
    with failpoints.active("chunks.erasure.part_read=error:times=1"):
        assert store.read_chunk(CID, device="cpu").to_rows() == rows
    with ref_failpoints.active("chunks.erasure.part_read=error:times=1"):
        assert ref_store.read_chunk(CID).to_rows() == rows
    assert _files(store) == _files(ref_store)


# --- tests/test_erasure.py on the port ---------------------------------------

class _PortChunk:
    @staticmethod
    def from_rows(schema, rows):
        return ColumnarChunk.from_rows(schema, rows, device="cpu")


class _PortStore(FsChunkStore):
    def read_chunk(self, chunk_id, device="cpu"):
        return super().read_chunk(chunk_id, device=device)


@pytest.fixture
def _port_names(monkeypatch):
    names = {"YtError": YtError, "ColumnarChunk": _PortChunk,
             "get_erasure_codec": erasure.get_erasure_codec,
             "FsChunkStore": _PortStore, "TableSchema": TableSchema}
    for name, value in names.items():
        monkeypatch.setattr(ref_tests, name, value)
    # test_store_lrc_chunk_survives_part_loss imports inside its body.
    monkeypatch.setattr(ref_chunks_pkg, "ColumnarChunk", _PortChunk)
    monkeypatch.setattr(ref_store_mod, "FsChunkStore", _PortStore)
    monkeypatch.setattr(ref_schema_mod, "TableSchema", TableSchema)


def _ref_params():
    params = []
    for name in sorted(n for n in dir(ref_tests) if n.startswith("test_")):
        fn = getattr(ref_tests, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        grid = [{}]
        for mark in reversed(marks):
            names = [a.strip() for a in mark.args[0].split(",")]
            grid = [{**g, **dict(zip(names, v if len(names) > 1 else (v,)))}
                    for v in mark.args[1] for g in grid]
        for i, kwargs in enumerate(grid):
            params.append(pytest.param(name, kwargs, id=f"{name}[{i}]"
                                       if len(grid) > 1 else name))
    return params


def test_the_reference_tests_are_ten():
    assert len({p.values[0] for p in _ref_params()}) == 10


@pytest.mark.parametrize("name,kwargs", _ref_params())
def test_reference_case(name, kwargs, _port_names, tmp_path):
    fn = getattr(ref_tests, name)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = {**kwargs, "tmp_path": tmp_path}
    fn(**kwargs)
