"""The reference's QL corpora run on the port (`ytsaurus_tpu_torch`) on the
CPU: every case of every list in tests/test_ql_corpus{,2,3}.py goes through
the port's `select_rows(..., device="cpu")` and is held to the case's own
expected rows under tests/harness.py's canon, the oracle the JAX package's
own tests are held to.

The cases run through the reference test functions themselves, with
`tests.harness` pointed at port adapters (`_port_harness`): its
`select_rows` builds or carries the tables onto the CPU and runs the port,
its `ColumnarChunk` and `TableSchema` are the port's, and a `YtError` of the
port is raised again as the JAX package's, with its code, so that the
reference's `pytest.raises` hold.

Left out, with the module each waits for:
  * test_ql_corpus2.py::test_spmd_matches_local — the mesh paths
    (`parallel/distributed.py`);
  * test_ql_corpus.py::test_string_between_via_dynamic_table — the client
    and its dynamic tables (the control plane).
"""

import inspect

import pytest
import torch

import tests.harness as harness
import tests.test_ql_corpus as corpus1
import tests.test_ql_corpus2 as corpus2
import tests.test_ql_corpus3 as corpus3
from tests.test_torch_query import _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query import select_rows
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

WAITING = {
    "test_spmd_matches_local": "the mesh paths (parallel/distributed.py)",
    "test_string_between_via_dynamic_table":
        "the client and its dynamic tables (the control plane)",
}


def _port_schema(spec):
    if isinstance(spec, TableSchema):
        return spec
    if isinstance(spec, RefSchema):
        spec = [(c.name, c.type.value)
                + ((c.sort_order.value,) if c.sort_order is not None else ())
                for c in spec]
    return TableSchema.make(spec)


class _AnyChunk(type):
    def __instancecheck__(cls, obj):
        return isinstance(obj, (ColumnarChunk, RefChunk))


class _ChunkAdapter(metaclass=_AnyChunk):
    """The harness's `ColumnarChunk`: rows build a port chunk on the CPU;
    a chunk of either package passes as a chunk."""

    @staticmethod
    def from_rows(schema, rows):
        return ColumnarChunk.from_rows(_port_schema(schema), rows,
                                       device="cpu")


class _SchemaAdapter:
    make = staticmethod(_port_schema)


def _port_select_rows(query, tables, schemas=None, **kwargs):
    chunks = {path: _to_port(c) if isinstance(c, RefChunk) else c
              for path, c in tables.items()}
    schemas = {p: _port_schema(s) for p, s in (schemas or {}).items()}
    try:
        return select_rows(query, chunks, schemas=schemas, device="cpu",
                           **kwargs)
    except YtError as exc:
        raise RefYtError(exc.message, code=exc.code) from exc


@pytest.fixture
def _port_harness(monkeypatch):
    monkeypatch.setattr(harness, "select_rows", _port_select_rows)
    monkeypatch.setattr(harness, "ColumnarChunk", _ChunkAdapter)
    monkeypatch.setattr(harness, "TableSchema", _SchemaAdapter)


def _reference_cases(module):
    """(id, test function, kwargs) for every case of every test function of
    a reference module, parametrized ones expanded by their own marks."""
    cases = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not callable(fn) or \
                name in WAITING:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            assert not inspect.signature(fn).parameters, name
            cases.append((name, fn, {}))
            continue
        (mark,) = marks
        argnames, values = mark.args[0], mark.args[1]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        ids = mark.kwargs.get("ids") or [str(i) for i in range(len(values))]
        for case_id, value in zip(ids, values):
            value = value.values if hasattr(value, "values") else value
            if len(argnames) == 1:
                value = (value,)
            cases.append((f"{name}[{case_id}]", fn,
                          dict(zip(argnames, value))))
    return cases


def _params(module):
    return [pytest.param(fn, kwargs, id=case_id)
            for case_id, fn, kwargs in _reference_cases(module)]


@pytest.mark.parametrize("fn,kwargs", _params(corpus1))
def test_corpus(fn, kwargs, _port_harness):
    fn(**kwargs)


@pytest.mark.parametrize("fn,kwargs", _params(corpus2))
def test_corpus2(fn, kwargs, _port_harness):
    fn(**kwargs)


@pytest.mark.parametrize("fn,kwargs", _params(corpus3))
def test_corpus3(fn, kwargs, _port_harness):
    fn(**kwargs)


def test_every_reference_case_is_run_or_listed():
    """No case of the corpora is dropped silently: the cases run here plus
    the tests listed as waiting cover every test function."""
    for module in (corpus1, corpus2, corpus3):
        run = {case_id.split("[")[0] for case_id, _, _ in
               _reference_cases(module)}
        tests = {n for n in vars(module) if n.startswith("test_")}
        assert tests - run <= set(WAITING), tests - run
