"""Parity of the port's ordered (queue) tablet with the JAX package on the CPU.

`ytsaurus_tpu_torch.tablet.ordered.OrderedTablet` against
`ytsaurus_tpu.tablet.ordered.OrderedTablet`, driven through the same
appends (each batch at its own timestamp), flushes, trims and in-memory
toggles: `row_count`, `read_rows` at every range that starts or ends in a
chunk, the store or at the trim point (rows, values, order and key order
equal), `snapshot(ts)` and `snapshot()` equal by `to_rows`, every flushed
chunk's blob byte for byte the reference's, and `select_rows` over the
snapshots equal to the reference's (tests/test_client.py's
`WHERE $row_index >= 2 GROUP BY msg` among them). Then the refusals.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_query import _assert_rows
from ytsaurus_tpu.chunks.store import FsChunkStore as RefStore
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.tablet.ordered import OrderedTablet as RefOrdered
from ytsaurus_tpu.tablet.ordered import \
    ordered_chunk_schema as ref_ordered_chunk_schema
from ytsaurus_tpu_torch.chunks.store import FsChunkStore
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query import select_rows
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet.ordered import (
    OrderedTablet,
    ordered_chunk_schema,
)

torch.set_num_threads(1)

QUEUE = [("producer", "int64"), ("seq", "int64"), ("v", "double"),
         ("payload", "string")]


def _pair(tmp_path, spec=QUEUE):
    ref = RefOrdered(RefSchema.make(spec), RefStore(str(tmp_path / "ref")))
    port = OrderedTablet(TableSchema.make(spec),
                         FsChunkStore(str(tmp_path / "port")), device="cpu")
    return ref, port


def _batch(rng, n, first_seq):
    return [{"producer": int(rng.integers(0, 8)), "seq": first_seq + i,
             "v": float(rng.normal()) if i % 9 else None,
             "payload": f"msg-{int(rng.integers(0, 50)):04d}"
             if i % 11 else None} for i in range(n)]


def _blob(tablet, cid) -> bytes:
    with open(tablet.chunk_store._path(cid), "rb") as f:
        return f.read()


def _drive(ref, port, seed, batches=40, flush_every=9, trims=(120, 333),
           toggle_at=15):
    """The same history in both tablets: appends at increasing timestamps,
    flushes (blobs compared), trims and an in-memory toggle."""
    rng = np.random.default_rng(seed)
    seq = 0
    ts = 10
    timestamps = []
    for b in range(batches):
        rows = _batch(rng, int(rng.integers(1, 30)), seq)
        seq += len(rows)
        assert port.append_rows(rows, ts) == ref.append_rows(rows, ts)
        timestamps.append(ts)
        ts += int(rng.integers(1, 4))
        if b % flush_every == flush_every - 1:
            ref_id, port_id = ref.flush(), port.flush()
            assert _blob(port, port_id) == _blob(ref, ref_id)
            assert port.chunk_ranges == ref.chunk_ranges
        if b == toggle_at:
            ref.set_in_memory(True)
            port.set_in_memory(True)
            assert len(port.chunk_cache._pinned) == \
                len(ref.chunk_cache._pinned) == len(port.chunk_ids)
        if b == toggle_at + 5:
            ref.set_in_memory(False)
            port.set_in_memory(False)
            assert port.chunk_cache._pinned == set()
        for trim in trims:
            if ref.row_count >= trim > ref.trimmed_count and b % 7 == 3:
                ref.trim_rows(trim)
                port.trim_rows(trim)
                assert len(port.chunk_ids) == len(ref.chunk_ids)
                assert port.chunk_ranges == ref.chunk_ranges
    assert port.row_count == ref.row_count
    return timestamps


def _edges(tablet) -> list:
    """Offsets at and around every chunk edge, the store's base and the
    trim point."""
    points = {0, tablet.trimmed_count, tablet.base_index, tablet.row_count}
    for lo, hi in tablet.chunk_ranges:
        points |= {lo, hi}
    return sorted({p + d for p in points for d in (-2, -1, 0, 1, 3)
                   if p + d >= 0})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_rows_match_at_every_edge(tmp_path, seed):
    ref, port = _pair(tmp_path)
    _drive(ref, port, seed)
    for start in _edges(port):
        for limit in (None, 1, 2, 7, 40, 1000):
            got = port.read_rows(start, limit)
            want = ref.read_rows(start, limit)
            assert got == want, (start, limit)
            assert [list(r) for r in got] == [list(r) for r in want]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_match(tmp_path, seed):
    ref, port = _pair(tmp_path)
    timestamps = _drive(ref, port, seed)
    for ts in [None, timestamps[0] - 1, timestamps[0], timestamps[5],
               timestamps[len(timestamps) // 2], timestamps[-1]]:
        snap, ref_snap = port.snapshot(ts), ref.snapshot(ts)
        assert snap.schema.to_dict() == ref_snap.schema.to_dict()
        assert snap.row_count == ref_snap.row_count
        assert snap.to_rows() == ref_snap.to_rows(), ts


def test_snapshot_of_an_empty_and_a_flushed_only_tablet(tmp_path):
    ref, port = _pair(tmp_path)
    assert port.snapshot().to_rows() == ref.snapshot().to_rows() == []
    assert port.snapshot().capacity == ref.snapshot().capacity
    rng = np.random.default_rng(4)
    rows = _batch(rng, 20, 0)
    port.append_rows(rows, 5)
    ref.append_rows(rows, 5)
    port.flush()
    ref.flush()
    assert port.snapshot().to_rows() == ref.snapshot().to_rows()
    port.trim_rows(20)
    ref.trim_rows(20)
    assert port.snapshot().to_rows() == ref.snapshot().to_rows() == []
    assert port.chunk_ids == [] and port.chunk_store.list_chunks() == []


QUERIES = [
    "producer, count(*) AS c, sum(v) AS s FROM [//q] "
    "WHERE $row_index >= 150 GROUP BY producer",
    "seq, payload FROM [//q] ORDER BY seq DESC LIMIT 7",
    "$row_index, $timestamp, v FROM [//q] WHERE producer = 3",
    "payload, count(*) AS c FROM [//q] GROUP BY payload",
]


@pytest.mark.parametrize("query", QUERIES)
def test_select_over_snapshots_matches(tmp_path, query):
    ref, port = _pair(tmp_path)
    timestamps = _drive(ref, port, seed=3)
    for ts in (None, timestamps[len(timestamps) // 2]):
        got = select_rows(query, {"//q": port.snapshot(ts)}, device="cpu")
        want = ref_select(query, {"//q": ref.snapshot(ts)})
        _assert_rows(got.to_rows(), want.to_rows(),
                     ordered="ORDER BY" in query)


def test_client_row_index_query(tmp_path):
    """tests/test_client.py:289 on the tablet: WHERE $row_index >= 2."""
    spec = [("msg", "string"), ("n", "int64")]
    ref, port = _pair(tmp_path, spec)
    rows = [{"msg": f"m{i % 2}", "n": i} for i in range(6)]
    ref.append_rows(rows, 1)
    port.append_rows(rows, 1)
    query = "msg, count(*) AS c FROM [//q] WHERE $row_index >= 2 GROUP BY msg"
    got = select_rows(query, {"//q": port.snapshot()}, device="cpu")
    assert sorted((r["msg"], r["c"]) for r in got.to_rows()) == \
        [(b"m0", 2), (b"m1", 2)]
    want = ref_select(query, {"//q": ref.snapshot()})
    _assert_rows(got.to_rows(), want.to_rows(), ordered=False)


def test_ordered_chunk_schema_matches():
    for spec in (QUEUE, [("a", "any"), ("e", "vector<float, 4>")]):
        assert ordered_chunk_schema(TableSchema.make(spec)).to_dict() == \
            ref_ordered_chunk_schema(RefSchema.make(spec)).to_dict()


def test_any_payloads_ride_the_queue(tmp_path):
    spec = [("k", "int64"), ("a", "any")]
    ref, port = _pair(tmp_path, spec)
    for i in range(5):
        rows = [{"k": i * 10 + j, "a": [{"j": j}, "s", None, b"\xff"][j % 4]}
                for j in range(8)]
        ref.append_rows(rows, i + 1)
        port.append_rows(rows, i + 1)
        if i % 2:
            assert _blob(port, port.flush()) == _blob(ref, ref.flush())
    port.trim_rows(13)
    ref.trim_rows(13)
    assert port.read_rows(0) == ref.read_rows(0)
    assert port.snapshot(3).to_rows() == ref.snapshot(3).to_rows()
    assert port.snapshot().to_rows() == ref.snapshot().to_rows()


def test_refusals_match(tmp_path):
    with pytest.raises(RefYtError) as ref_err:
        RefOrdered(RefSchema.make([("k", "int64", "ascending")]),
                   RefStore(str(tmp_path / "r")))
    with pytest.raises(YtError) as err:
        OrderedTablet(TableSchema.make([("k", "int64", "ascending")]),
                      FsChunkStore(str(tmp_path / "p")), device="cpu")
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))
    ref, port = _pair(tmp_path)
    rows = [{"producer": 1, "seq": 0}, {"producer": 1, "nope": 2}]
    with pytest.raises(RefYtError) as ref_err:
        ref.append_rows(rows, 1)
    with pytest.raises(YtError) as err:
        port.append_rows(rows, 1)
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))
    # The row before the refused one stays appended, as in the reference.
    assert port.row_count == ref.row_count == 1
    with pytest.raises(YtError):
        port.trim_rows(5)
    port.mounted = ref.mounted = False
    with pytest.raises(RefYtError) as ref_err:
        ref.append_rows([{"producer": 1}], 2)
    with pytest.raises(YtError) as err:
        port.append_rows([{"producer": 1}], 2)
    assert (err.value.code, str(err.value)) == \
        (ref_err.value.code, str(ref_err.value))


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(YtError, match="no CUDA device"):
        OrderedTablet(TableSchema.make(QUEUE), FsChunkStore(str(tmp_path)))
