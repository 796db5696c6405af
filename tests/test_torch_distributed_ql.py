"""Parity of the port's mesh paths with the JAX package on 8 gloo ranks:
the QL twins. The 18 SPMD corpus queries of tests/test_ql_corpus2.py (its
_spmd_fixture, seed 7) and the 6 SPMD window queries of
tests/test_ql_window.py (seed 11) in both modes (PARTITION BY
co-partition, and the gather merge with shuffle=False), each against the
JAX package's local evaluator over the concatenated shards, as in
tests/test_torch_distributed.py, whose ranks, jobs and checks this module
uses. Integers, codes, group sets and orders exactly; doubles to rtol
1e-9; unordered results as sets, ORDER BY results as sequences, window
rows keyed by the unique k.

This module imports nothing of jax or the JAX package at its top: the
ranks import it.
"""

from __future__ import annotations

import functools

import pytest

from tests.test_torch_distributed import (
    _CASE_MAKERS,
    _agreed,
    _check,
    _job,
    _oracle,
    _runs,
    _spawn_ranks,
)

T = "//t"


# tests/test_ql_corpus2.py's SPMD queries over its _spmd_fixture (seed 7).

SPMD_CORPUS = [
    "regex_spmd_filter", "regex_replace_spmd", "substr_spmd_group",
    "parse_like_spmd", "sha_len_spmd", "bigb_spmd_group", "upper_spmd",
    "case_spmd", "in_spmd", "between_spmd", "hash_mod_spmd", "minmax_spmd",
    "having_spmd", "ts_floor_spmd", "ilike_spmd", "tuple_in_spmd",
    "like_escape_spmd", "order_two_dirs_spmd",
]


def _corpus_case(case: str):
    import tests.test_ql_corpus2 as ref_tests
    _, schema, chunks = _corpus_fixture()
    return chunks, _runs({T: schema}, ref_tests._SPMD_SQL[case])


@functools.lru_cache(maxsize=1)
def _corpus_fixture():
    import tests.test_ql_corpus2 as ref_tests
    return ref_tests._spmd_fixture()


# tests/test_ql_window.py's SPMD window queries (seed 11), both modes.

SPMD_WINDOW = ["bounded_frame_spmd", "filtered_whole_partition_spmd",
               "offset_first_last_spmd", "rank_cross_shard_ties_spmd",
               "ranking_running_spmd", "windowed_then_order_limit_spmd"]
WINDOW_MODES = {"copartition": {}, "gather": {"shuffle": False}}


@functools.lru_cache(maxsize=1)
def _window_fixture():
    import tests.test_ql_window as ref_tests
    return ref_tests._spmd_fixture()


def _window_case(case: str, mode: str):
    import tests.test_ql_window as ref_tests
    _, schema, chunks = _window_fixture()
    return chunks, _runs({T: schema}, ref_tests.SPMD_WINDOW_SQL[case],
                         kwargs=(WINDOW_MODES[mode],))


CASES = {
    **{f"corpus-{c}": functools.partial(_corpus_case, c)
       for c in SPMD_CORPUS},
    **{f"window-{c}-{m}": functools.partial(_window_case, c, m)
       for c in SPMD_WINDOW for m in WINDOW_MODES},
}
_CASE_MAKERS.update(CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on each of the 8 ranks, by case name."""
    return _spawn_ranks([_job(name) for name in CASES],
                        str(tmp_path_factory.mktemp("mesh8ql")))


# --- tests/test_ql_corpus2.py::test_spmd_matches_local -------------------------


@pytest.mark.parametrize("case", SPMD_CORPUS)
def test_spmd_corpus_matches_local(case, ranks):
    import tests.test_ql_corpus2 as ref_tests
    _check(ranks, f"corpus-{case}",
           ordered="ORDER BY" in ref_tests._SPMD_SQL[case])


# --- tests/test_ql_window.py::test_spmd_window_matches_local -------------------


@pytest.mark.parametrize("mode", list(WINDOW_MODES))
@pytest.mark.parametrize("case", SPMD_WINDOW)
def test_spmd_window_matches_local(case, mode, ranks):
    """Rows keyed by the unique k, every column exact (a query with LIMIT:
    the sequence)."""
    import tests.test_ql_window as ref_tests
    name = f"window-{case}-{mode}"
    if "LIMIT" in ref_tests.SPMD_WINDOW_SQL[case]:
        _check(ranks, name, ordered=True)
        return
    from tests.test_torch_query import _assert_rows
    (run,) = _agreed(ranks, name)["runs"]
    _assert_rows(sorted(run["rows"], key=lambda r: r["k"]),
                 sorted(_oracle(name, 0), key=lambda r: r["k"]),
                 ordered=True)
