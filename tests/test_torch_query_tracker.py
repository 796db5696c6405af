"""The port's query tracker (`server/query_tracker.py`) and SQL dialect
(`ecosystem/sql.py`) against the JAX package's: the reference's own tests
(tests/test_query_tracker.py, 8, and tests/test_ecosystem_sql.py, 15) run
on the port; `translate_sql` gives the reference's QL text (or its error)
for every SQL string of those files, for the window dialect cases of
tests/test_ql_window.py and for a seeded set; and
`execute_sql` and the tracker's engines give the same rows on both
clients, the FROM-subquery case included. The port runs with
device="cpu".
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.harness import _canon_row
from tests.test_ql_window import SQL_DIALECT
from tests.test_torch_client import _connect, call_twin, port_twin, twin_cases
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.ecosystem import sql as ref_sql
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.server import query_tracker as ref_qt
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.ecosystem import sql
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.server import query_tracker

torch.set_num_threads(1)

_HERE = Path(__file__).parent

# --- the reference's tests, on the port --------------------------------------

_QT_TWIN = port_twin("test_query_tracker")
_QT_CASES = twin_cases(_QT_TWIN)
_SQL_TWIN = port_twin("test_ecosystem_sql")
_SQL_CASES = twin_cases(_SQL_TWIN)


def test_twin_lists_are_whole():
    assert len(_QT_CASES) == 8
    assert len(_SQL_CASES) == 15


@pytest.mark.parametrize("name", _QT_CASES)
def test_reference_query_tracker_case_on_the_port(name, tmp_path):
    def client():
        # The reference module's `client` fixture, on the port.
        c = _QT_TWIN.connect(str(tmp_path))
        c.write_table("//data/t", [{"k": i, "v": i * 10} for i in range(5)])
        return c
    call_twin(_QT_TWIN, name, {"client": client})


@pytest.mark.parametrize("name", _SQL_CASES)
def test_reference_ecosystem_sql_case_on_the_port(name, tmp_path):
    call_twin(_SQL_TWIN, name, {"tmp_path": tmp_path})


def test_client_serves_one_tracker(tmp_path):
    c = port_client.connect(str(tmp_path), device="cpu")
    assert c._query_tracker is None
    assert isinstance(c.query_tracker, query_tracker.QueryTracker)
    assert c.query_tracker is c.query_tracker


# --- translate_sql ------------------------------------------------------------


def _file_sql() -> list:
    """Every string constant of the reference's SQL and tracker tests that
    reads as a query."""
    out = []
    for name in ("test_ecosystem_sql.py", "test_query_tracker.py"):
        tree = ast.parse((_HERE / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    " from " in f" {node.value.lower()} ":
                out.append(node.value)
    return sorted(set(out))


_TABLES = ['"//facts"', "`//facts`", "[//facts]", "facts", "'//facts'",
           '"//facts" AS f', "`//facts` f"]
_ITEMS = ["g", "v", "f.v", "d.name", '"g"', "`v`", "sum(v) AS s",
          "count(*) AS c", "countIf(v > 2) AS ci", "sumIf(v, g = 1) AS si",
          "avgIf(v, g <> 0) AS ai", "minIf(v, v == 3) AS mi",
          "maxIf(v, g != 2) AS xi", "uniq(v) AS u", "uniqExact(g) AS ue",
          "any(v) AS a", "toInt64(v) AS i", "toUInt64(g) AS ug",
          "toFloat64(v) AS d", "toString(v) AS t", "v + 1 AS w",
          "if_null(v, 0) AS n", "sumIf(countIf(v > 1), g = 1) AS nest"]
_JOINS = ["", ' JOIN "//dims" USING g', " INNER JOIN `//dims` USING g",
          " ALL INNER JOIN [//dims] USING g", " ANY JOIN \"//dims\" USING g",
          ' LEFT JOIN "//dims" USING g', ' JOIN "//dims" d ON f.g = d.g',
          ' JOIN "//dims" AS d ON f.g = d.g AND f.h = d.h',
          ' JOIN "//dims" d ON f.k = d.j', " CROSS JOIN \"//dims\"",
          ' RIGHT JOIN "//dims" USING g', " FULL OUTER JOIN x USING g"]
_WHERES = ["", " WHERE v <> 2", " WHERE g == 1 AND v > 0.5",
           " WHERE name = 'from (x)'", " WHERE s = 'it''s'",
           " WHERE v >= 1e3 OR g < 2u", " WHERE ~~~"]
_TAILS = ["", " GROUP BY g", " GROUP BY g ORDER BY g", " ORDER BY v DESC",
          " ORDER BY v LIMIT 5", " LIMIT 20, 10", " LIMIT 10 OFFSET 20",
          " GROUP BY 1 AS one", " ORDER BY g LIMIT 3;"]


def _seeded_sql(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items = [_ITEMS[i] for i in rng.choice(len(_ITEMS),
                                               int(rng.integers(1, 4)),
                                               replace=False)]
        distinct = "DISTINCT " if rng.random() < 0.15 else ""
        select = "SELECT " if rng.random() < 0.9 else "select "
        body = (f"{select}{distinct}{', '.join(items)} FROM "
                f"{_TABLES[rng.integers(len(_TABLES))]}"
                f"{_JOINS[rng.integers(len(_JOINS))]}"
                f"{_WHERES[rng.integers(len(_WHERES))]}"
                f"{_TAILS[rng.integers(len(_TAILS))]}")
        if rng.random() < 0.2:
            body = (f"SELECT count(*) AS n, max(s) AS top FROM ({body}) "
                    f"AS inner_q WHERE n > 1 GROUP BY 1 AS one")
        out.append(body)
    return out


def _translation(translate, text, Error):
    try:
        return ("ok", translate(text))
    except Error as err:
        return ("err", int(err.code), err.message)


def _split(split, text, Error):
    try:
        return ("ok", split(text))
    except Error as err:
        return ("err", int(err.code), err.message)


_SQL_STRINGS = _file_sql() + [c[1] for c in SQL_DIALECT] + \
    _seeded_sql(12, 400)


def test_sql_corpus_is_broad():
    assert len(_file_sql()) >= 30
    outcomes = [_translation(sql.translate_sql, t, YtError)[0]
                for t in _SQL_STRINGS]
    assert outcomes.count("ok") > 200 and outcomes.count("err") > 30


@pytest.mark.parametrize("chunk", range(8))
def test_translate_sql_is_the_references(chunk):
    for text in _SQL_STRINGS[chunk::8]:
        assert _translation(sql.translate_sql, text, YtError) == \
            _translation(ref_sql.translate_sql, text, RefYtError), text
        assert _split(sql._split_subquery, text, YtError) == \
            _split(ref_sql._split_subquery, text, RefYtError), text


# --- execute_sql and the engines on both clients --------------------------------


def _tables(c):
    rng = np.random.default_rng(31)
    n = 500
    c.write_table("//facts", [
        {"k": int(i), "g": int(g), "v": int(v), "x": float(x)}
        for i, g, v, x in zip(range(n), rng.integers(0, 40, n),
                              rng.integers(0, 1000, n), rng.normal(size=n))])
    c.write_table("//dims", [{"g": g, "name": f"name{g % 7}"}
                             for g in range(35)])
    return c


_EXECUTE = [
    'SELECT g, sum(v) AS s, count(*) AS c FROM "//facts" GROUP BY g',
    'SELECT name, sum(v) AS s FROM "//facts" JOIN "//dims" USING g '
    "GROUP BY name ORDER BY sum(v) DESC LIMIT 5",
    'SELECT f.k, d.name FROM "//facts" AS f JOIN "//dims" AS d '
    "ON f.g = d.g ORDER BY f.k ASC LIMIT 7",
    'SELECT k, name FROM "//facts" LEFT JOIN "//dims" USING g '
    "WHERE g >= 35 ORDER BY k LIMIT 10",
    "SELECT countIf(v > 500) AS big, sumIf(v, g < 10) AS small, "
    "avgIf(x, g <> 3) AS ax FROM `//facts` GROUP BY 1 AS one",
    "SELECT DISTINCT g FROM `//facts` ORDER BY g DESC LIMIT 100",
    "SELECT uniq(g) AS u, any(k) AS a FROM `//facts` WHERE k == 4 "
    "GROUP BY 1 AS one",
    "SELECT k, toFloat64(v) AS d FROM facts WHERE v <> 3 "
    "ORDER BY k LIMIT 20, 10",
    # FROM-subqueries: the inner rows are materialized on the cluster's
    # device and the outer query runs over them.
    "SELECT count(*) AS n, max(total) AS top, sum(total) AS all_v FROM ("
    'SELECT g, sum(v) AS total FROM "//facts" GROUP BY g) AS per_g '
    "WHERE total > 1000 GROUP BY 1 AS one",
    "SELECT g, total FROM (SELECT g, sum(v) AS total FROM `//facts` "
    "GROUP BY g) ORDER BY total DESC LIMIT 6",
    "SELECT name, sum(s) AS t FROM (SELECT name, sum(v) AS s FROM "
    '"//facts" JOIN "//dims" USING g GROUP BY name) GROUP BY name',
    "SELECT v FROM (SELECT v FROM `//facts` WHERE v > 5000)",
    "SELECT count(*) AS n FROM (SELECT g FROM (SELECT g, v FROM "
    "`//facts` WHERE v < 100) WHERE g < 20) GROUP BY 1 AS one",
    'SELECT a FROM "//facts" CROSS JOIN "//dims"',
    "SELECT toString(v) FROM `//facts`",
    "SELECT ~~~ nonsense",
]


def _execute_script(c, execute, Error):
    out = []
    for text in _EXECUTE:
        try:
            out.append(("ok", sorted(_canon_row(r) for r in execute(c, text))))
        except Error as err:
            out.append(("err", int(err.code)))
    return out


def test_execute_sql_gives_the_references_rows(tmp_path):
    ref = _execute_script(_tables(_connect(ref_client, tmp_path / "ref")),
                          ref_sql.execute_sql, RefYtError)
    port = _execute_script(_tables(_connect(port_client, tmp_path / "port")),
                           sql.execute_sql, YtError)
    for text, p, r in zip(_EXECUTE, port, ref):
        assert p == r, text
    assert [o[0] for o in port].count("ok") == len(_EXECUTE) - 3


def test_subquery_chunk_lies_on_the_cluster_device(tmp_path, monkeypatch):
    c = _tables(port_client.connect(str(tmp_path), device="cpu"))
    from ytsaurus_tpu_torch.query.engine import evaluator
    seen = []
    real = evaluator.select_rows

    def spy(query, tables, *args, **kwargs):
        seen.append(({p: t.device for p, t in tables.items()},
                     kwargs.get("device"), kwargs.get("evaluator")))
        return real(query, tables, *args, **kwargs)

    monkeypatch.setattr("ytsaurus_tpu_torch.query.select_rows", spy)
    rows = sql.execute_sql(c, _EXECUTE[9])
    assert len(rows) == 6
    ((devices, device, ev),) = seen
    assert set(devices.values()) == {c.cluster.device} == {device}
    assert ev is c.cluster.evaluator


def _tracker_script(c, qt_module, Error):
    qt = qt_module.QueryTracker(c)
    out = []
    for engine, text in (
            ("ql", "g, sum(v) AS s FROM [//facts] GROUP BY g"),
            ("ql", "name, count(*) AS n FROM [//facts] JOIN [//dims] "
                   "USING g GROUP BY name"),
            ("chyt", _EXECUTE[1]), ("sql", _EXECUTE[8]),
            ("chyt", _EXECUTE[-1]), ("ql", "k FROM [//nope]")):
        qid = qt.start_query(text, engine=engine)
        record = qt.wait(qid)
        try:
            rows = sorted(_canon_row(r) for r in qt.read_query_result(qid))
        except Error as err:
            rows = ("err", int(err.code))
        out.append((engine, record["state"], record["truncated"], rows))
    out.append(sorted((q["engine"], q["state"])
                      for q in qt.list_queries()))
    return out


def test_tracker_engines_give_the_references_rows(tmp_path):
    ref = _tracker_script(_tables(_connect(ref_client, tmp_path / "ref")),
                          ref_qt, RefYtError)
    port = _tracker_script(_tables(_connect(port_client, tmp_path / "port")),
                           query_tracker, YtError)
    assert port == ref
    assert [entry[1] for entry in port[:-1]] == \
        ["completed"] * 4 + ["failed"] * 2
    assert port[4][3] == ("err", int(EErrorCode.OperationFailed))
