"""The reference's QL evaluation tests run on the port (`ytsaurus_tpu_torch`)
on the CPU: every `test_*` of tests/test_ql_evaluate.py, with
`tests.harness` pointed at the port adapters of tests/test_torch_corpus.py
(port chunks on the CPU, the port's `select_rows`, its `YtError` raised again
as the JAX package's with its code). Tables the reference tests build as JAX
chunks cross to the port bit for bit through `chunk_from_numpy`.

`test_fast_group_cache_not_reused_across_vocab_shapes` drives the JAX
`Evaluator` directly rather than through the harness; its port counterpart
is `test_vocab_shapes_across_chunks` below.
"""

import pytest
import torch

import tests.test_ql_evaluate as ref
from tests.test_torch_corpus import _port_harness  # noqa: F401 (fixture)
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

DIRECT = {"test_fast_group_cache_not_reused_across_vocab_shapes"}
CASES = sorted(n for n in vars(ref) if n.startswith("test_")
               and n not in DIRECT)


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name, _port_harness):  # noqa: F811
    getattr(ref, name)()


def test_vocab_shapes_across_chunks():
    """One plan over two chunks whose string keys have vocabularies of
    sizes (1, 2) and (2, 1): each run binds its own chunk's vocabularies."""
    schema = TableSchema.make([("a", "string"), ("b", "string"),
                               ("v", "int64")])
    c1 = ColumnarChunk.from_rows(schema, [("x", "p", 1), ("x", "q", 2)],
                                 device="cpu")
    c2 = ColumnarChunk.from_rows(schema, [("y", "m", 5), ("z", "m", 7)],
                                 device="cpu")
    plan = build_query("a, b, sum(v) AS s FROM [//t] GROUP BY a, b",
                       {"//t": schema})
    ev = Evaluator("cpu")
    r1 = ev.run_plan(plan, c1).to_rows()
    r2 = ev.run_plan(plan, c2).to_rows()
    assert sorted((r["a"], r["b"], r["s"]) for r in r1) == \
        [(b"x", b"p", 1), (b"x", b"q", 2)]
    assert sorted((r["a"], r["b"], r["s"]) for r in r2) == \
        [(b"y", b"m", 5), (b"z", b"m", 7)]
