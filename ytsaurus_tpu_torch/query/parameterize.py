"""The plan fingerprint that keys the port's per-shape memos.

Own copy of the JAX package's `query/parameterize.py::plan_fingerprint`:
the parameterized (shape) fingerprint, in which hoistable literal values
collapse and LIMIT / OFFSET bucket, so that the whole-plan rung's quota
memo and the mesh observatory key one entry per query shape. The
reference's `CompileConfig.parameterize` switch and its literal hoisting
for compiled programs have no counterpart: nothing here is compiled.
"""

from __future__ import annotations

from ytsaurus_tpu_torch.query import ir


def plan_fingerprint(plan: "ir.Query | ir.FrontQuery") -> str:
    return ir.fingerprint(plan, omit_values=True)
