"""TPC-H Q1 through `YtClient.select_rows` on a chunk cache smaller than
its table (the benchmark's `tpch_sf10.cold` at a size a CPU test holds):
seeded TPC-H from `ytbench.tpch`, lineitem in 4 chunks, the cache at about
1.5 decoded chunks. Every query stages chunks through the miss path, and
its answers are the plain reference's and a warm cache's. A query's
miss-path fields (query/statistics.py MISS_FIELDS) agree with the
cache's counters and the bytes it decoded; on a warm cache they read 0.
A miss on a chunk another thread is reading counts as a duplicate."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ytbench import harness, spec
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, pad_capacity
from ytsaurus_tpu_torch.chunks.store import ChunkCache
from ytsaurus_tpu_torch.query.statistics import MISS_FIELDS, QueryStatistics
from ytsaurus_tpu_torch.query.workload import get_workload_log
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils.tracing import staging_for

torch.set_num_threads(1)

CELL = "tpch_sf10.cold"
SEED = 2**33 + 17
STREAMS = 3
ROUNDS = 3
# 4 lineitem chunks of about 3,000 rows each; orders and customer as
# the benchmark publishes them.
TINY = {"scale_factor": 0.002,
        "tables": {"lineitem": {"chunks": 4}, "orders": {"chunks": 1},
                   "customer": {"chunks": 1}}}
# A decoded lineitem row: six 8-byte planes, two int32 code planes and
# one validity byte for each of the 8 columns.
ROW_BYTES = 6 * 8 + 2 * 4 + 8


def _plan(cache_bytes: int) -> harness.Plan:
    return harness.plan(CELL, SEED, config_overrides={
        **TINY, "chunk_cache_bytes": cache_bytes})


def _chunk_bytes(tables: dict) -> int:
    caps = {pad_capacity(len(part["l_orderkey"]))
            for part in tables["lineitem"]}
    assert len(caps) == 1, caps
    return caps.pop() * ROW_BYTES


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """(plan, tables, the cold cluster's clients, the warm cluster's
    clients, one decoded chunk's bytes), both served as the benchmark
    serves a cell: published, then warmed up."""
    p = _plan(1)
    tables = harness.generate(p)
    chunk = _chunk_bytes(tables)
    cold_plan = _plan(chunk * 3 // 2)
    cold = harness.serve(cold_plan, tables,
                         str(tmp_path_factory.mktemp("cold")), "cpu")
    warm = harness.serve(_plan(2 << 30), tables,
                         str(tmp_path_factory.mktemp("warm")), "cpu")
    return cold_plan, tables, cold, warm, chunk


def _streams(clients: list, texts: list, rounds: int) -> list:
    """Every client on its own thread sends texts[(i + k) % len] for k in
    range(rounds); [(stream, k, sub, rows)]."""
    out = []
    lock = threading.Lock()

    def stream(i, client):
        for k in range(rounds):
            sub = (i + k) % len(texts)
            rows = client.select_rows(texts[sub])
            with lock:
                out.append((i, k, sub, rows))

    threads = [threading.Thread(target=stream, args=(i, c))
               for i, c in enumerate(clients)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    return out


def test_streams_on_a_cold_cache_answer_as_the_reference(clusters):
    p, tables, cold, warm, chunk = clusters
    texts = p.texts["q1"]
    cache = cold[0].cluster.chunk_cache
    module = p.queries["q1"]["module"]
    want = module.answers(harness.merged_tables(tables),
                          p.substitutions["q1"], np.float64)
    warm_rows = [warm[0].select_rows(text) for text in texts]
    limit = spec.cell(CELL)["limits"]["max_rel_err"]["max"]
    evictions = cache.evictions
    for r in range(ROUNDS):
        misses = cache.misses
        got = _streams(cold, texts, 1)
        assert len(got) == STREAMS
        assert cache.misses > misses, f"round {r} did not miss"
        assert cache.used_bytes <= cache.capacity_bytes + chunk
        for _, _, sub, rows in got:
            wrong, err = module.compare(rows, want[sub])
            assert wrong == 0 and err <= limit, (sub, err)
            assert rows == warm_rows[sub]
    assert cache.evictions > evictions


def test_a_stream_of_rounds_stays_within_capacity(clusters):
    p, _, cold, _, chunk = clusters
    cache = cold[0].cluster.chunk_cache
    got = _streams(cold[:2], p.texts["q1"], ROUNDS)
    assert len(got) == 2 * ROUNDS
    assert cache.used_bytes <= cache.capacity_bytes + chunk
    assert cache._loading == {}


def test_one_query_carries_its_misses(clusters, monkeypatch):
    p, _, cold, _, chunk = clusters
    client = cold[0]
    cache = client.cluster.chunk_cache
    decoded = []
    real = cache.store.read_chunk

    def recording(chunk_id, device):
        out = real(chunk_id, device=device)
        decoded.append(ChunkCache._chunk_bytes(out))
        return out
    monkeypatch.setattr(cache.store, "read_chunk", recording)
    misses = cache.misses
    client.select_rows(p.texts["q1"][0])
    stats = client.last_query_statistics
    assert stats.chunk_misses == cache.misses - misses == len(decoded) >= 1
    assert stats.duplicate_misses == 0
    assert stats.bytes_staged == sum(decoded) == len(decoded) * chunk
    assert stats.decode_time > 0 and stats.chunk_read_time > 0
    assert stats.copy_time >= 0
    record = get_workload_log().records()[-1]
    assert {f: record.stages[f] for f in MISS_FIELDS} == \
        {f: float(getattr(stats, f)) for f in MISS_FIELDS}


def test_a_warm_query_reads_zero_in_every_miss_field(clusters):
    p, _, _, warm, _ = clusters
    client = warm[0]
    cache = client.cluster.chunk_cache
    misses = cache.misses
    client.select_rows(p.texts["q1"][1])
    stats = client.last_query_statistics
    assert cache.misses == misses and cache.evictions == 0
    assert all(getattr(stats, f) == 0 for f in MISS_FIELDS)
    record = get_workload_log().records()[-1]
    assert all(record.stages[f] == 0 for f in MISS_FIELDS)


def test_a_miss_is_a_read_span_with_decode_and_copy_children(clusters):
    p, _, cold, _, _ = clusters
    client = cold[0]
    cache = client.cluster.chunk_cache
    misses = cache.misses
    prof = client.select_rows(p.texts["q1"][2], explain_analyze=True)
    assert cache.misses > misses

    def reads(nodes):
        for node in nodes:
            if node["name"] == "chunk.read":
                yield node
            yield from reads(node["children"])
    found = list(reads(prof.span_tree()))
    assert len(found) == cache.misses - misses
    for node in found:
        assert [c["name"] for c in node["children"]] == \
            ["chunk.decode", "chunk.copy"]


def test_a_miss_is_three_profiler_ranges(clusters):
    p, _, cold, _, _ = clusters
    client = cold[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        client.select_rows(p.texts["q1"][3])
    names = {e.name for e in prof.events()}
    assert {"chunk.read", "chunk.decode", "chunk.copy"} <= names


class _HeldStore:
    """A store whose reads wait for `release`; `entered` counts them."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Semaphore(0)
        self.schema = TableSchema.make([("k", "int64")])

    def read_chunk(self, chunk_id, device="cpu"):
        self.entered.release()
        assert self.release.wait(30)
        return ColumnarChunk.from_rows(self.schema, [{"k": 1}],
                                       device=device)


def test_a_miss_on_a_chunk_being_read_is_a_duplicate():
    store = _HeldStore()
    cache = ChunkCache(store, device="cpu")
    first, second = QueryStatistics(), QueryStatistics()

    def get(stats):
        with staging_for(stats):
            cache.get("c1")

    threads = [threading.Thread(target=get, args=(s,))
               for s in (first, second)]
    threads[0].start()
    assert store.entered.acquire(timeout=30)
    threads[1].start()
    assert store.entered.acquire(timeout=30)
    store.release.set()
    for thread in threads:
        thread.join()
    assert cache.misses == 2 and cache.duplicate_misses == 1
    assert (first.chunk_misses, first.duplicate_misses) == (1, 0)
    assert (second.chunk_misses, second.duplicate_misses) == (1, 1)
    assert cache._loading == {}
    cache.get("c1")
    assert cache.hits == 1 and cache.misses == 2


def test_a_failed_read_leaves_no_read_under_way():
    class Failing:
        def read_chunk(self, chunk_id, device="cpu"):
            raise OSError("gone")

    cache = ChunkCache(Failing(), device="cpu")
    stats = QueryStatistics()
    with staging_for(stats), pytest.raises(OSError):
        cache.get("c1")
    assert cache._loading == {} and cache.misses == 0
    assert stats.chunk_misses == 0


def test_evictions_count_the_entries_dropped_for_room():
    schema = TableSchema.make([("k", "int64")])

    class Store:
        def read_chunk(self, chunk_id, device="cpu"):
            return ColumnarChunk.from_rows(schema, [{"k": 1}], device=device)

    cache = ChunkCache(Store(), device="cpu")
    size = ChunkCache._chunk_bytes(cache.store.read_chunk("x"))
    cache.capacity_bytes = 2 * size
    for i in range(5):
        cache.get(f"c{i}")
    assert cache.evictions == 3 and cache.used_bytes == 2 * size
    cache.invalidate("c4")
    assert cache.evictions == 3
