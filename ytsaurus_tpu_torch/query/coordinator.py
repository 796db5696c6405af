"""Query coordination: the bottom/front split of a plan.

Port of the JAX package's `query/coordinator.py` as far as the mesh paths
use it: `split_plan` and its helpers (`_MERGE_FN`, `_to_double`,
`_AvgSubstituter`, `_subst_order`, `_subst_project`, `_default_project`)
and `_ordered_scan_direction`, an own copy over the port's `ir`. Analog of
the reference's coordinator algebra (library/query/engine_api/
coordinator.h: GetDistributedQueryPattern): a plan is split into a
`bottom` query that runs unchanged on every shard and a `front` query that
merges the partial results. Partial aggregate states are re-aggregated
with merge functions (count merges by SUM, avg decomposes into sum and
count state columns), ORDER BY re-sorts the per-shard top-K, and OFFSET
and LIMIT apply only at the front.

The host coordinator (`coordinate_and_execute`, the shard loop with its
retries and prefetch) is not ported here.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.schema import EValueType

# How each aggregate's partial state is merged at the front.
_MERGE_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
             "first": "first"}


def split_plan(plan: ir.Query) -> tuple[ir.Query, ir.FrontQuery]:
    """Split into (bottom, front) — ref GetDistributedQueryPattern."""
    limit_for_bottom = None
    if plan.limit is not None:
        limit_for_bottom = plan.offset + plan.limit

    if plan.window is not None:
        # Window functions need COMPLETE partitions: per-shard windows
        # over arbitrary row placement would be wrong, so the bottom
        # only filters and the window stage runs at the front over the
        # merged rowset (the shuffled SPMD path instead co-partitions by
        # the PARTITION BY key — parallel/distributed.py).
        bottom = replace(plan, window=None, having=None, order=None,
                         project=None, offset=0, limit=None)
        front = ir.FrontQuery(
            schema=bottom.output_schema(), window=plan.window,
            order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.group is not None and any(
            a.function == "cardinality" for a in plan.group.aggregate_items):
        # Distinct counts cannot merge from per-shard counts; ship the
        # filtered rows and run the whole group stage at the front.
        bottom = replace(plan, group=None, having=None, order=None,
                         project=None, offset=0, limit=None)
        front = ir.FrontQuery(
            schema=bottom.output_schema(), group=plan.group,
            having=plan.having, order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.group is not None:
        bottom_aggs: list[ir.AggregateItem] = []
        avg_map: dict[str, tuple[str, str]] = {}
        argfn_front: dict[str, tuple[str, str]] = {}
        for agg in plan.group.aggregate_items:
            if agg.function in ("argmin", "argmax"):
                v_name, b_name = f"{agg.name}__v", f"{agg.name}__b"
                bottom_aggs.append(ir.AggregateItem(
                    name=v_name, function=agg.function,
                    argument=agg.argument, type=agg.type,
                    state_type=agg.state_type,
                    by_argument=agg.by_argument))
                bottom_aggs.append(ir.AggregateItem(
                    name=b_name,
                    function="min" if agg.function == "argmin" else "max",
                    argument=agg.by_argument, type=agg.by_argument.type,
                    state_type=agg.by_argument.type))
                argfn_front[agg.name] = (v_name, b_name)
                continue
            if agg.function == "avg":
                s_name, c_name = f"{agg.name}__s", f"{agg.name}__c"
                arg = agg.argument
                bottom_aggs.append(ir.AggregateItem(
                    name=s_name, function="sum",
                    argument=_to_double(arg), type=EValueType.double,
                    state_type=EValueType.double))
                bottom_aggs.append(ir.AggregateItem(
                    name=c_name, function="count", argument=arg,
                    type=EValueType.int64, state_type=EValueType.int64))
                avg_map[agg.name] = (s_name, c_name)
            else:
                bottom_aggs.append(agg)
        bottom = replace(plan, group=ir.GroupClause(
            group_items=plan.group.group_items,
            aggregate_items=tuple(bottom_aggs), totals=False),
            having=None, order=None, project=None, offset=0, limit=None)
        inter_schema = bottom.output_schema()

        front_group_items = tuple(
            ir.NamedExpr(name=item.name,
                         expr=ir.TReference(type=item.expr.type, name=item.name))
            for item in plan.group.group_items)
        # Keep the ORIGINAL declaration order: output schemas must match the
        # single-node plan regardless of how states were decomposed.
        by_name = {a.name: a for a in plan.group.aggregate_items}
        front_agg_list = []
        for agg in plan.group.aggregate_items:
            if agg.name in argfn_front:
                v_name, b_name = argfn_front[agg.name]
                front_agg_list.append(ir.AggregateItem(
                    name=agg.name, function=agg.function,
                    argument=ir.TReference(type=agg.type, name=v_name),
                    type=agg.type, state_type=agg.state_type,
                    by_argument=ir.TReference(
                        type=agg.by_argument.type, name=b_name)))
            elif agg.function == "avg":
                s_name, c_name = avg_map[agg.name]
                for state_name, state_fn, ty in (
                        (s_name, "sum", EValueType.double),
                        (c_name, "sum", EValueType.int64)):
                    front_agg_list.append(ir.AggregateItem(
                        name=state_name, function=state_fn,
                        argument=ir.TReference(type=ty, name=state_name),
                        type=ty, state_type=ty))
            else:
                front_agg_list.append(ir.AggregateItem(
                    name=agg.name, function=_MERGE_FN[agg.function],
                    argument=ir.TReference(type=agg.state_type, name=agg.name),
                    type=agg.type, state_type=agg.state_type))
        front_aggs = tuple(front_agg_list)

        subst = _AvgSubstituter(avg_map)
        front = ir.FrontQuery(
            schema=inter_schema,
            group=ir.GroupClause(group_items=front_group_items,
                                 aggregate_items=front_aggs,
                                 totals=plan.group.totals),
            having=subst(plan.having),
            order=_subst_order(plan.order, subst),
            project=_subst_project(plan.project, subst,
                                   plan) if plan.project else _default_project(plan, subst),
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.order is not None:
        # Bottom keeps the full row set (identity projection) but can cut to
        # the per-shard top-(offset+limit); the front re-sorts and projects.
        bottom = replace(plan, having=None, project=None, offset=0,
                         limit=limit_for_bottom)
        front = ir.FrontQuery(
            schema=plan.schema, order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    bottom = replace(plan, offset=0, limit=limit_for_bottom)
    front = ir.FrontQuery(schema=bottom.output_schema(), offset=plan.offset,
                          limit=plan.limit)
    return bottom, front


def _to_double(expr: ir.TExpr) -> ir.TExpr:
    if expr.type is EValueType.double:
        return expr
    return ir.TFunction(type=EValueType.double, name="double", args=(expr,))


class _AvgSubstituter:
    """Rewrites references to an avg slot into state_sum / state_count."""

    def __init__(self, avg_map: dict[str, tuple[str, str]]):
        self.avg_map = avg_map

    def __call__(self, expr: Optional[ir.TExpr]) -> Optional[ir.TExpr]:
        if expr is None or not self.avg_map:
            return expr
        return ir.map_expr(expr, self._leaf)

    def _leaf(self, e: ir.TExpr) -> ir.TExpr:
        if isinstance(e, ir.TReference) and e.name in self.avg_map:
            s_name, c_name = self.avg_map[e.name]
            s_ref = ir.TReference(type=EValueType.double, name=s_name)
            c_ref = ir.TReference(type=EValueType.int64, name=c_name)
            return ir.TBinary(type=EValueType.double, op="/", lhs=s_ref,
                              rhs=_to_double(c_ref))
        return e


def _subst_order(order: Optional[ir.OrderClause],
                 subst: _AvgSubstituter) -> Optional[ir.OrderClause]:
    if order is None:
        return None
    return ir.OrderClause(items=tuple(
        ir.OrderItem(expr=subst(i.expr), descending=i.descending)
        for i in order.items))


def _subst_project(project: ir.ProjectClause, subst: _AvgSubstituter,
                   plan: ir.Query) -> ir.ProjectClause:
    return ir.ProjectClause(items=tuple(
        ir.NamedExpr(name=i.name, expr=subst(i.expr)) for i in project.items))


def _default_project(plan: ir.Query, subst: _AvgSubstituter
                     ) -> Optional[ir.ProjectClause]:
    """SELECT * with GROUP BY: reconstruct keys + original aggregate values
    (avg must be divided back out of its state columns)."""
    if not subst.avg_map:
        return None
    items = []
    for item in plan.group.group_items:
        items.append(ir.NamedExpr(
            name=item.name,
            expr=ir.TReference(type=item.expr.type, name=item.name)))
    for agg in plan.group.aggregate_items:
        items.append(ir.NamedExpr(
            name=agg.name,
            expr=subst(ir.TReference(type=agg.type, name=agg.name))))
    return ir.ProjectClause(items=tuple(items))


def _ordered_scan_direction(plan: ir.Query,
                            range_ordered_by) -> Optional[str]:
    """'asc'/'desc' when ORDER BY + LIMIT can stop scanning range-ordered
    shards early: every order item is a bare reference, the referenced
    names form a prefix of the shard-range key, and the direction is
    uniform.  None otherwise."""
    if not range_ordered_by or plan.order is None or \
            plan.limit is None or plan.group is not None:
        return None
    items = plan.order.items
    if not items or not all(isinstance(it.expr, ir.TReference)
                            for it in items):
        return None
    if len({it.descending for it in items}) != 1:
        return None
    names = [it.expr.name for it in items]
    if names != list(range_ordered_by)[: len(names)]:
        return None
    return "desc" if items[0].descending else "asc"
