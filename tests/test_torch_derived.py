"""The port's secondary indexes, backups and the dynamic tables under them
against the JAX package's: one script of writes (inserts, partial
updates, deletes, transactions) into an indexed table, selects served
through the index, a backup at a timestamp and its restore, driven alike
through both clients and compared by rows, index tables and errors; and
`ColumnarChunk.from_arrays` with the reference's signature on the same
inputs. The port runs with device="cpu".

Twins, run on the port through `port_twin`: every case of
tests/test_secondary_index.py (7), tests/test_backup.py (4) and
tests/test_dynamic_tables.py (26, `from_arrays` with raw strings and
nulls among them).
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_client import (
    _both,
    _code,
    _cpu_module,
    _rows_equal,
    call_twin,
    port_twin,
    twin_cases,
)
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.chunks import store as port_store
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.store import FsChunkStore
from ytsaurus_tpu_torch.client import connect
from ytsaurus_tpu_torch.query import select_rows as port_select_rows
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet import secondary_index

torch.set_num_threads(1)

_INDEX_TWIN = port_twin("test_secondary_index")
_INDEX_CASES = twin_cases(_INDEX_TWIN)
_BACKUP_TWIN = port_twin("test_backup")
_BACKUP_CASES = twin_cases(_BACKUP_TWIN)


class _CpuFsChunkStore(FsChunkStore):
    """FsChunkStore whose reads default to the CPU."""

    def read_chunk(self, chunk_id, device="cpu", **kwargs):
        return super().read_chunk(chunk_id, device=device, **kwargs)


_cpu_module("_port_cpu_store", port_store, FsChunkStore=_CpuFsChunkStore)
_DYN_TWIN = port_twin("test_dynamic_tables", edits={
    "from ytsaurus_tpu.chunks.store import FsChunkStore":
        "from _port_cpu_store import FsChunkStore"},
    select_rows=functools.partial(port_select_rows, device="cpu"))
_DYN_CASES = twin_cases(_DYN_TWIN)


def test_twin_lists_are_whole():
    assert len(_INDEX_CASES) == 7
    assert len(_BACKUP_CASES) == 4
    assert len(_DYN_CASES) == 26


def _client_with(twin, path, tmp_path):
    """The twin's `client` fixture: a cluster with one mounted dynamic
    table of the twin's SCHEMA."""
    client = twin.connect(str(tmp_path))
    client.create("table", path, recursive=True,
                  attributes={"schema": twin.SCHEMA, "dynamic": True})
    client.mount_table(path)
    return client


@pytest.mark.parametrize("name", _INDEX_CASES)
def test_reference_secondary_index_case_on_the_port(name, tmp_path):
    call_twin(_INDEX_TWIN, name, {
        "client": _client_with(_INDEX_TWIN, "//users", tmp_path)})


@pytest.mark.parametrize("name", _BACKUP_CASES)
def test_reference_backup_case_on_the_port(name, tmp_path):
    call_twin(_BACKUP_TWIN, name, {
        "client": _client_with(_BACKUP_TWIN, "//t", tmp_path)})


@pytest.mark.parametrize("name", _DYN_CASES)
def test_reference_dynamic_tables_case_on_the_port(name, tmp_path):
    call_twin(_DYN_TWIN, name, {
        "tablet": _DYN_TWIN.Tablet(_DYN_TWIN.SCHEMA,
                                   _DYN_TWIN.FsChunkStore(str(tmp_path))),
        "txm": _DYN_TWIN.TransactionManager(), "tmp_path": tmp_path})


# --- from_arrays with the reference's signature -----------------------------


_ARRAYS = {
    "object_nulls": (
        [("s", "string")],
        {"s": np.array([b"a", None, b"c", b"a", None], dtype=object)}, {}),
    "unicode": ([("s", "string")], {"s": np.array(["b", "a", "b", "c"])}, {}),
    "bytes_and_valids": (
        [("s", "string"), ("x", "int64"), ("u", "uint64"), ("d", "double")],
        {"s": np.array([b"z", b"", b"z\x00"], dtype=object),
         "x": np.array([1, 2, 3]), "u": np.array([0, 2**64 - 1, 5],
                                                dtype=np.uint64),
         "d": np.array([0.5, -0.0, np.inf])},
        {"valids": {"x": np.array([True, False, True]),
                    "d": np.array([False, True, True])}}),
    "row_count_capacity": (
        [("x", "int64"), ("b", "boolean")],
        {"x": np.arange(4), "b": np.array([True, False, True, True])},
        {"row_count": 4, "capacity": 64}),
    "dictionary_codes": (
        [("s", "string")], {"s": np.array([1, 0, 1], dtype=np.int32)},
        {"dictionaries": {"s": np.array([b"p", b"q"], dtype=object)}}),
}


@pytest.mark.parametrize("case", sorted(_ARRAYS))
def test_from_arrays_matches_the_reference(case):
    spec, arrays, kwargs = _ARRAYS[case]
    ref = RefChunk.from_arrays(RefSchema.make(spec), arrays, **kwargs)
    port = ColumnarChunk.from_arrays(TableSchema.make(spec), arrays,
                                     **kwargs, device="cpu")
    assert repr(port.to_rows()) == repr(ref.to_rows())
    assert (port.row_count, port.capacity) == (ref.row_count, ref.capacity)
    for name, _ in spec:
        want = ref.columns[name].dictionary
        got = port.columns[name].dictionary
        assert (got is None) == (want is None)
        if want is not None:
            assert list(got) == list(want)


def test_from_arrays_refuses_a_string_column_without_strings():
    schema = TableSchema.make([("s", "string")])
    with pytest.raises(Exception, match="needs a dictionary"):
        ColumnarChunk.from_arrays(schema, {"s": np.arange(3)}, device="cpu")


# --- one script through both clients ----------------------------------------


def _derived_script(c, Schema, Error) -> dict:
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64"),
                          ("city", "string")], unique_keys=True)
    c.create("table", "//t", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//t")
    rng = np.random.default_rng(8)
    rows = [{"k": int(k), "v": int(v), "city": f"c{int(t)}"}
            for k, v, t in zip(rng.permutation(400), rng.integers(0, 25, 400),
                               rng.integers(0, 6, 400))]
    c.insert_rows("//t", rows[:150])
    c.create_secondary_index("//t", "//t_by_v", ["v"])
    out = {"backfill": c.select_rows("v, k FROM [//t_by_v]")}
    for lo in range(150, 400, 50):
        tx = c.start_transaction()
        c.insert_rows("//t", rows[lo:lo + 50], tx=tx)
        c.commit_transaction(tx)
    c.insert_rows("//t", [{"k": r["k"], "v": 99} for r in rows[:10]],
                  update=True)
    c.delete_rows("//t", [(r["k"],) for r in rows[10:20]])
    cutoff = c.cluster.transactions.timestamps.generate()
    out["index"] = c.select_rows("v, k FROM [//t_by_v]")
    out["selects"] = [
        c.select_rows(f"k, v, city FROM [//t] WHERE v = {x}")
        for x in (0, 7, 99, 1000)]
    out["ranges"] = c.select_rows(
        "k, v FROM [//t] WHERE v >= 5 AND v < 8")
    out["missing"] = _code(lambda: c.create_secondary_index(
        "//t", "//bad", ["nope"]), Error)
    c.insert_rows("//t", [{"k": 1000, "v": 1, "city": "late"}])
    c.backup_table("//t", "//backup/t", timestamp=cutoff)
    c.restore_table_backup("//backup/t", "//restored/t")
    c.mount_table("//restored/t")
    out["restored"] = c.select_rows("k, v, city FROM [//restored/t]")
    out["live"] = c.select_rows("k, v, city FROM [//t]")
    c.drop_secondary_index("//t", "//t_by_v", remove_table=True)
    out["dropped"] = c.exists("//t_by_v")
    out["after_drop"] = c.select_rows("k FROM [//t] WHERE v = 7")
    return out


def _by_k(rows):
    return sorted(rows, key=lambda r: r["k"])


def test_indexes_and_backups_match(tmp_path):
    ref, port = _both(_derived_script, tmp_path)
    for key in ("backfill", "index"):
        _rows_equal(port[key], ref[key])
    for got, want in zip(port["selects"], ref["selects"]):
        _rows_equal(_by_k(got), _by_k(want))
    for key in ("ranges", "restored", "live", "after_drop"):
        _rows_equal(_by_k(port[key]), _by_k(ref[key]))
    assert (port["missing"], port["dropped"]) == \
        (ref["missing"], ref["dropped"])
    assert len(port["restored"]) == 390 and 1000 not in \
        {r["k"] for r in port["restored"]}


def test_indexed_select_goes_through_the_index(tmp_path, monkeypatch):
    """A select bounded on the indexed column is served by
    `fetch_via_index`, and equals the scan of the primary table."""
    client = connect(str(tmp_path), device="cpu")
    schema = TableSchema.make([("k", "int64", "ascending"),
                               ("v", "int64")], unique_keys=True)
    client.create("table", "//t", attributes={"schema": schema,
                                              "dynamic": True})
    client.mount_table("//t")
    client.insert_rows("//t", [{"k": i, "v": i % 9} for i in range(300)])
    client.create_secondary_index("//t", "//t_by_v", ["v"])
    calls = []
    fetch = secondary_index.fetch_via_index

    def counted(*args, **kwargs):
        calls.append(args[1])
        return fetch(*args, **kwargs)

    monkeypatch.setattr(secondary_index, "fetch_via_index", counted)
    rows = client.select_rows("k, v FROM [//t] WHERE v = 4")
    assert calls == ["//t"]
    assert _by_k(rows) == [{"k": i, "v": 4} for i in range(4, 300, 9)]
