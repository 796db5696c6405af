"""Parity of the port's distributed sort (`parallel/shuffle.py::sort_table`:
range partition, exchange, per-rank sort) with tests/test_shuffle_sort.py,
on 8 gloo ranks spawned as in tests/test_torch_distributed.py.

Each of the reference's 8 cases is made by the JAX package with the same
seeds and shapes and carried to the ranks as numpy planes: random keys,
input already in range order (every row to one rank), descending, two
keys, nulls first, strings, one hot key holding half the rows, and a mesh
of one. Every rank must report the same row counts and key order and hold
its own count of rows; the rows, shard-major, must be the concatenated
input in the order of a stable sort by the keys (numpy's stable lexsort
order: equal keys keep their input order), every column exact.

This module imports nothing of jax or the JAX package at its top: the
ranks import tests/test_torch_distributed.py to run.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from tests.test_torch_distributed import (
    _agreed_sort,
    _canon_rows,
    _numpy_chunk,
    _spawn_ranks,
)

SORT_SPEC = [("k", "int64"), ("v", "double"), ("tag", "int64")]


def _make_shards(rows_per_shard, seed=0, key_gen=None):
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make(SORT_SPEC)
    rng = np.random.default_rng(seed)
    chunks = []
    for s in range(8):
        n = rows_per_shard
        keys = key_gen(rng, s, n) if key_gen else rng.integers(0, 10_000, n)
        chunks.append(ColumnarChunk.from_arrays(
            schema, {"k": keys, "v": rng.uniform(0, 1, n),
                     "tag": np.full(n, s)}))
    return chunks


def _random():
    return _make_shards(500), ["k"], False


def _already_sorted_skew():
    return _make_shards(300, key_gen=lambda rng, s, n:
                        s * 1000 + rng.integers(0, 999, n)), ["k"], False


def _descending():
    return _make_shards(200), ["k"], True


def _multi_key():
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make(SORT_SPEC)
    rng = np.random.default_rng(3)
    chunks = [ColumnarChunk.from_arrays(
        schema, {"k": rng.integers(0, 4, 100), "v": rng.uniform(0, 1, 100),
                 "tag": rng.integers(0, 1000, 100)}) for _ in range(8)]
    return chunks, ["k", "tag"], False


def _nulls_first():
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make([("k", "int64"), ("p", "int64")])
    chunks = [ColumnarChunk.from_rows(schema, [
        (None if i % 5 == 0 else i + s * 100, s) for i in range(50)])
        for s in range(8)]
    return chunks, ["k"], False


def _strings():
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make([("s", "string"), ("i", "int64")])
    words = ["kiwi", "apple", "fig", "date", "grape", "lime", "pear", "plum"]
    chunks = [ColumnarChunk.from_rows(schema, [
        (words[(s + i) % 8] + str(i % 3), i) for i in range(40)])
        for s in range(8)]
    return chunks, ["s"], False


def _heavy_skew():
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make([("k", "int64"), ("p", "int64")])
    rng = np.random.default_rng(13)
    chunks = []
    for s in range(8):
        n = 400
        k = np.concatenate([np.full(n // 2, 777),
                            rng.integers(0, 10_000, n - n // 2)])
        rng.shuffle(k)
        chunks.append(ColumnarChunk.from_arrays(
            schema, {"k": k, "p": np.arange(n) + s * 1000}))
    return chunks, ["k"], False


def _single_device_mesh():
    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.schema import TableSchema
    schema = TableSchema.make([("k", "int64"), ("v", "int64")])
    rng = np.random.default_rng(3)
    chunk = ColumnarChunk.from_arrays(
        schema, {"k": rng.integers(0, 1000, 257), "v": np.arange(257)})
    return [chunk], ["k"], False


CASES = {
    "random_data": _random,
    "already_sorted_input_skew": _already_sorted_skew,
    "descending": _descending,
    "multi_key": _multi_key,
    "with_nulls_first": _nulls_first,
    "strings": _strings,
    "heavy_skew_one_hot_key": _heavy_skew,
    "single_device_mesh": _single_device_mesh,
}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    return CASES[name]()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = []
    for name in CASES:
        shards, keys, descending = _case(name)
        jobs.append({"name": name, "kind": "sort", "keys": keys,
                     "descending": descending,
                     "shards": [_numpy_chunk(c) for c in shards]})
    return _spawn_ranks(jobs, str(tmp_path_factory.mktemp("sort8")))


def _stable_sorted(rows: list, keys: list, descending: bool) -> list:
    """The rows in a stable sort by `keys`, nulls first."""
    def key(row):
        return tuple((0, 0) if row[k] is None else (1, row[k]) for k in keys)
    return sorted(rows, key=key, reverse=descending)


@pytest.mark.parametrize("name", list(CASES))
def test_sort_table_matches_a_stable_sort(name, ranks):
    shards, keys, descending = _case(name)
    got = _agreed_sort(ranks, name)
    rows = [r for c in shards for r in c.to_rows()]
    assert len(got) == len(rows)
    assert _canon_rows(got) == _canon_rows(_stable_sorted(rows, keys,
                                                          descending))
    result = ranks[0][name]
    assert result["keys"] == keys
    assert len(result["row_counts"]) == len(shards)
