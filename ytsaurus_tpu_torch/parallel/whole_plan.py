"""The whole-plan rung: a distributed query with ONE mesh-layer host read.

Port of the JAX package's `parallel/whole_plan.py`. The reference lowers
a fusable distributed plan (scan → filter → [partial aggregate] →
shuffle → aggregate / window → order / top-k / project) as one
`jit(shard_map(...))` program, whose exchange is sized by a static quota
and whose only host sync is the final stacked transfer of the result
count with the exchange's demand and overflow flag. PyTorch runs eagerly
and traces nothing, so there is no fused program here; what the port
keeps is the reference's host/device contract:

- every stage runs on each rank's device, one after another, with no
  device → host read between them: the exchange is
  `shuffle.route_rows_quota` (fixed blocks of `quota` rows, one
  `all_to_all_single` of n equal blocks per plane), sized by a memoized
  quota instead of a read of the transfer matrix;
- the result count, the overflow flag, the true transfer-matrix maximum
  (the quota demand) and the telemetry lanes go into one stacked int64
  tensor, replicated by one in-plan all_gather, and read once
  (`_read_counts`, counted by `distributed._note_host_sync`). So
  `host_sync_count()` rises by exactly 1 per query on this rung, on
  every shape;
- on overflow (a destination block was too small, so rows were dropped,
  never written past the block) the query re-runs at
  max(pow2(demand × headroom), 2 × quota), capped by the bound (a source
  cannot send more rows than it holds); at the bound it raises. The
  settled quota is memoized per plan shape on
  `DistributedEvaluator._quota_memo`, with hysteresis.

The staged programs below the mesh layer still read the host where the
single-chunk evaluator does (the radix argsort's constant-digit check,
a top-k's tie check); `host_sync_count` counts the mesh layer's reads
only, as the reference's XLA programs have none below it.

Shapes (`_shape_of`), as in the reference:

  gather           bottom per shard → all_gather → front
  exchange-states  bottom partial GROUP BY → the group STATES routed by
                   key hash → merge group + HAVING → all_gather → front
  exchange-rows    cardinality GROUP BY and PARTITION BY windows: the
                   filtered ROWS routed by key hash → the complete local
                   stage → all_gather → front
  join             planner-ordered broadcast (replicated sorted keys,
                   probed per shard) and partition (both sides routed by
                   key hash) joins, each partition join with its two
                   quotas and its match-expansion capacity, then the
                   gather shape

Every rank takes the same host decisions (the quota memo, the planner's
strategies, the stage validation, the overflow re-run) from values every
rank holds: the chunk list, the foreign chunks and the one stacked vector
the all_gather replicates.

Stage placement follows the reference's partition-rule registry: a stage
name matched against regexes to "sharded" (`("shard",)`) or "replicated"
(`()`); an unplaced or misplaced stage fails loudly, and the registry's
digest folds into the quota memo's key.

Not applicable (nothing is traced or compiled): `_scan_shardings` /
`_constrain_inputs` (`with_sharding_constraint` at the jit boundary; the
scan columns' rules are still validated), the whole-plan program cache
and its AOT disk tier, and the compile-time memory analysis of the mesh
observatory (blocks carry no `memory_watermark_bytes`).
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import replace as dc_replace
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import pad_capacity
from ytsaurus_tpu_torch.config import compile_config
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.parallel import distributed as dist
from ytsaurus_tpu_torch.parallel.mesh_observatory import (
    MESH_TELEMETRY_VERSION,
    exchange_entry,
    mesh_armed,
    mesh_block,
    publish_mesh,
    row_bytes,
)
from ytsaurus_tpu_torch.parallel.shuffle import cell_counts, route_rows_quota
from ytsaurus_tpu_torch.query import ir, planner
from ytsaurus_tpu_torch.query.coordinator import split_plan
from ytsaurus_tpu_torch.query.engine.expr import (
    BindContext,
    ColumnBinding,
    EmitContext,
    ExprBinder,
    bindings_to_device,
)
from ytsaurus_tpu_torch.query.engine.joins import (
    _bind_keys,
    _comparable_keys,
    _emit_encoded_keys,
    _lex_searchsorted,
    null_key_mask,
    probe_replicated,
    sort_foreign_keys,
    vocab_remap_slots,
)
from ytsaurus_tpu_torch.query.engine.lowering import prepare
from ytsaurus_tpu_torch.query.parameterize import plan_fingerprint
from ytsaurus_tpu_torch.schema import EValueType, TableSchema

SHARD_AXIS = "shard"
SHARDED = (SHARD_AXIS,)
REPLICATED = ()

# -- partition-rule registry ---------------------------------------------------

# Stage-name regex → placement, first hit wins: sharded stages run on each
# rank's shard, replicated ones over the all_gathered rowset on every rank.
DEFAULT_PARTITION_RULES: "tuple[tuple[str, tuple], ...]" = (
    (r"^(scan|filter|bottom|shuffle|local|join)(/|$)", SHARDED),
    (r"^(front|merge|order|topk|project|limit)(/|$)", REPLICATED),
)


def match_partition_rules(rules, name: str) -> tuple:
    """First rule whose regex matches `name` wins; no match is an error
    (an unplaceable stage must fail loudly, not silently replicate)."""
    for pattern, spec in rules:
        if re.search(pattern, name) is not None:
            return tuple(spec)
    raise YtError(f"No partition rule matches stage {name!r}",
                  code=EErrorCode.QueryExecutionError)


def rules_fingerprint(rules) -> str:
    """Stable digest of a rule set (a key of the quota memo)."""
    text = repr([(pattern, tuple(spec)) for pattern, spec in rules])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _validate_stages(rules, stages: "list[tuple[str, bool]]") -> None:
    """Check the registry places every (name, wants_sharded) stage where
    this rung runs it."""
    for name, want_sharded in stages:
        spec = match_partition_rules(rules, name)
        sharded = spec == SHARDED
        if sharded != want_sharded:
            where = "on the shard axis" if want_sharded else "replicated"
            raise YtError(
                f"partition rules place stage {name!r} as {spec!r} "
                f"but the whole-plan rung runs it {where}",
                code=EErrorCode.QueryExecutionError)


def _validate_scan(rules, names) -> None:
    """The scan columns' stages (`scan/<column>`) must be sharded: the
    planes are each rank's shard."""
    _validate_stages(rules, [(f"scan/{name}", True) for name in names])


# -- fusion gate ---------------------------------------------------------------


def can_fuse(plan: ir.Query) -> Optional[str]:
    """None when the whole plan runs on this rung; otherwise the reason it
    stays on the stitched ladder."""
    if plan.group is not None and plan.group.totals:
        return "WITH TOTALS concatenates two materialized rowsets"
    return None


def _shape_of(plan: ir.Query) -> str:
    """exchange-states (GROUP BY without cardinality), exchange-rows
    (cardinality GROUP BY, PARTITION BY windows) or gather."""
    if plan.group is not None and not plan.group.totals:
        if any(a.function == "cardinality"
               for a in plan.group.aggregate_items):
            return "exchange-rows"
        return "exchange-states"
    if plan.window is not None and plan.window.partition_items:
        return "exchange-rows"
    return "gather"


# -- entry ---------------------------------------------------------------------


def run_whole_plan(evaluator, plan: ir.Query, table, stats=None,
                   rules=None, foreign_chunks=None):
    """Execute `plan` over a ShardedTable with one mesh-layer host read.

    `evaluator` is the DistributedEvaluator holding the quota memo and the
    foreign-side memos; `foreign_chunks` maps join table path → chunk on
    the mesh's device (every rank passes all of them). Raises YtError for
    unfusable plans and in-plan faults; the caller's ladder then steps
    down to the stitched rungs."""
    reason = can_fuse(plan)
    if reason is not None:
        raise YtError(f"plan is not whole-plan fusable: {reason}",
                      code=EErrorCode.QueryUnsupported)
    rules = DEFAULT_PARTITION_RULES if rules is None else tuple(rules)
    if plan.joins:
        chunk = _run_join(evaluator, plan, table, rules, stats,
                          foreign_chunks or {})
    else:
        shape = _shape_of(plan)
        if shape == "gather":
            chunk = _run_gather(evaluator, plan, table, rules, stats)
        else:
            chunk = _run_exchange(evaluator, plan, table, rules, shape,
                                  stats)
    if stats is not None:
        stats.whole_plan = 1
    return chunk


def _read_counts(final: torch.Tensor) -> np.ndarray:
    """THE host read of this rung: one stacked device → host transfer of
    the result count and everything the host decides from (overflow
    flag, demands, telemetry lanes), as a 1-D int64 vector."""
    dist._note_host_sync("whole_plan._read_counts")
    with record_function("mesh.read"):
        return final.to(torch.int64).reshape(-1).cpu().numpy()


def _replicated(mesh, parts) -> torch.Tensor:
    """(n, k) int64: every rank's k local scalars (or (m,) vectors,
    flattened), by one all_gather, so every rank holds every rank's."""
    local = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    return mesh.all_gather(local).reshape(mesh.size, -1)


# -- mesh telemetry ------------------------------------------------------------

# The lanes ride the stacked read; the block built from them, and its
# publication, live in mesh_observatory.py, shared with the stitched rungs.


def _mesh_lanes(lanes: torch.Tensor) -> list:
    """[version] + per-shard live input rows + per-shard output rows, from
    the (n, >= 2) replicated lanes whose first two columns they are."""
    version = torch.full((1,), MESH_TELEMETRY_VERSION, dtype=torch.int64,
                         device=lanes.device)
    return [version, lanes[:, 0], lanes[:, 1]]


def _mesh_slices(vals, base: int, n: int):
    """Decode the lanes appended at index `base` of the read vector:
    (in_rows, out_rows, next_offset)."""
    version = int(vals[base])
    if version != MESH_TELEMETRY_VERSION:
        raise YtError(
            f"mesh telemetry version mismatch: the plan returned "
            f"{version}, the host decodes {MESH_TELEMETRY_VERSION}",
            code=EErrorCode.QueryExecutionError)
    in_rows = vals[base + 1: base + 1 + n]
    out_rows = vals[base + 1 + n: base + 1 + 2 * n]
    return in_rows, out_rows, base + 1 + 2 * n


# -- shared steps --------------------------------------------------------------


def _rep_chunk(capacity: int, columns: dict, device):
    return dist._RepChunk(capacity=capacity, columns=dict(columns),
                          device=device)


def _output_rep(output) -> dict:
    return {c.name: dist._RepColumn(type=c.type, dictionary=c.vocab)
            for c in output}


def _gather_front(evaluator, prepared_local, planes, count, front):
    """all_gather of a stage's output (planes and count, no host read),
    then the replicated front over the gathered rows."""
    gathered, g_mask, g_cap = evaluator._gather(prepared_local.output,
                                                planes, count)
    prepared_f = prepare(front, _rep_chunk(
        g_cap, _output_rep(prepared_local.output), evaluator.mesh.device))
    out_planes, out_count = prepared_f.run(gathered, g_mask)
    return prepared_f, out_planes, out_count


# -- gather shape --------------------------------------------------------------


def _run_gather(evaluator, plan: ir.Query, table, rules, stats=None):
    """bottom per shard → all_gather → replicated front."""
    dist._FP_GATHER.hit()
    mesh = table.mesh
    n = mesh.size
    armed = mesh_armed()
    bottom, front = split_plan(plan)
    names = [c.name for c in bottom.schema if c.name in table.columns]
    _validate_scan(rules, names)
    stages = [("bottom", True), ("front", False)]
    if plan.order is not None:
        stages.append(("order", False))
    if plan.project is not None:
        stages.append(("project", False))
    _validate_stages(rules, stages)
    prepared_b = prepare(bottom, _rep_chunk(
        table.capacity, dist._rep(table.columns), mesh.device))
    planes, count = prepared_b.run(
        {name: (table.columns[name].data, table.columns[name].valid)
         for name in names}, table.row_valid)
    prepared_f, out_planes, out_count = _gather_front(
        evaluator, prepared_b, planes, count, front)
    parts = [out_count.reshape(1).to(torch.int64)]
    if armed:
        parts += _mesh_lanes(_replicated(mesh, [table.row_valid.sum(),
                                                count]))
    vals = _read_counts(torch.cat(parts))
    if armed:
        in_rows, out_rows, _ = _mesh_slices(vals, 1, n)
        publish_mesh(stats, plan_fingerprint(plan),
                     mesh_block(n, in_rows, out_rows, exchanges=[]))
    return dist._assemble_chunk(prepared_f.output, out_planes, int(vals[0]))


# -- exchange shapes -----------------------------------------------------------


def _bind_route_keys(rep_columns, key_refs, where_expr):
    """Bind the routing keys (and an optional WHERE) against a namespace
    of _RepColumn carriers: (bind_ctx, where_b, key_b)."""
    bind_ctx = BindContext(columns={
        name: ColumnBinding(type=rc.type, vocab=rc.dictionary)
        for name, rc in rep_columns.items()})
    binder = ExprBinder(bind_ctx)
    where_b = binder.bind(where_expr) if where_expr is not None else None
    key_b = [binder.bind(expr) for expr in key_refs]
    return bind_ctx, where_b, key_b


def _dest_hash(key_b, ctx, mask, cap: int, n: int) -> torch.Tensor:
    """Destination rank by the canonical key hash, as the stitched shuffle
    routes, so both co-locate the same key sets; n for masked rows."""
    pid = dist._umod(dist._key_hash([kb.emit(ctx) for kb in key_b], cap,
                                    ctx.device), n)
    return torch.where(mask, pid, n)


def _initial_quota(memo: dict, memo_key, bound_cap: int, n: int,
                   headroom: float) -> "tuple[int, int]":
    """(starting quota, hard bound). The bound is the per-source live
    capacity: a source cannot send more rows than it holds to one
    destination, so a run at the bound never overflows."""
    bound = pad_capacity(bound_cap)
    start = memo.get(memo_key)
    if start is None:
        start = min(bound,
                    pad_capacity(max(64, int(bound_cap * headroom) // n)))
    return start, bound


def _settle_quota(memo: dict, memo_key, demand: int, bound: int) -> None:
    """Memoize the demand-sized quota for the next query of this shape:
    the pow2 rounding of the measured demand is the steady-state slack.
    Hysteresis: it shrinks only past a 4x gap, and grows always."""
    settled = min(bound, pad_capacity(max(int(demand), 64)))
    prev = memo.get(memo_key)
    if prev is None or settled > prev or settled * 4 <= prev:
        memo[memo_key] = settled


def _escalate(quota: int, demand: int, headroom: float, bound: int) -> int:
    return min(bound, max(pad_capacity(max(int(demand * headroom), 1)),
                          quota * 2))


def _run_exchange(evaluator, plan: ir.Query, table, rules, shape: str,
                  stats):
    """The co-partitioned shapes:

    exchange-states  scan → filter → partial group (per shard) → the
                     group states routed by key hash → merge group +
                     HAVING (complete groups per rank) → all_gather →
                     order / project / offset / limit;
    exchange-rows    scan → filter → the surviving rows routed by group /
                     PARTITION BY hash → the complete local stage →
                     all_gather → front.

    One quota sizes the exchange; the stacked read returns the true
    transfer-matrix maximum and the overflow flag with the count."""

    dist._FP_ALL_TO_ALL.hit()
    mesh = table.mesh
    n, device = mesh.size, mesh.device
    headroom = compile_config().whole_plan_headroom
    armed = mesh_armed()

    if shape == "exchange-states":
        bottom, front = split_plan(plan)
        scan_names = sorted(c.name for c in bottom.schema
                            if c.name in table.columns)
        # Routing keys: the group-key slots of the state rowset (the
        # bottom already evaluated the key expressions).
        key_refs = [ir.TReference(type=item.expr.type, name=item.name)
                    for item in bottom.group.group_items]
        where_expr = None                 # consumed by the bottom
        local_plan = ir.FrontQuery(schema=front.schema, group=front.group,
                                   having=front.having)
        front_final = ir.FrontQuery(
            schema=local_plan.output_schema(), order=front.order,
            project=front.project, offset=front.offset, limit=front.limit)
        stage_names = [("bottom/group", True), ("shuffle/group", True),
                       ("local/group", True), ("front", False)]
    else:
        bottom = None
        scan_names = [c.name for c in plan.schema if c.name in table.columns]
        key_items = plan.window.partition_items \
            if plan.window is not None else plan.group.group_items
        key_refs = [item.expr for item in key_items]
        where_expr = plan.where
        local_plan = dc_replace(plan, order=None, project=None, offset=0,
                                limit=None)
        front_final = ir.FrontQuery(
            schema=local_plan.output_schema(), order=plan.order,
            project=plan.project, offset=plan.offset, limit=plan.limit)
        kind = "window" if plan.window is not None else "group"
        stage_names = [(f"shuffle/{kind}", True), (f"local/{kind}", True),
                       ("front", False)]
    if plan.order is not None:
        stage_names.append(("order", False))
    if plan.project is not None:
        stage_names.append(("project", False))
    _validate_scan(rules, scan_names)
    _validate_stages(rules, stage_names)
    columns = {name: (table.columns[name].data, table.columns[name].valid)
               for name in scan_names}

    with record_function("mesh.count"):
        if bottom is not None:
            prepared_s1 = prepare(bottom, _rep_chunk(
                table.capacity, dist._rep(table.columns), device))
            planes, cnt = prepared_s1.run(columns, table.row_valid)
            route_rep = _output_rep(prepared_s1.output)
            routed = {c.name: plane
                      for c, plane in zip(prepared_s1.output, planes)}
            bound_cap = planes[0][0].shape[0]
            mask = torch.arange(bound_cap, device=device) < cnt
        else:
            route_rep = dist._rep({name: table.columns[name]
                                   for name in scan_names})
            routed = columns
            bound_cap = table.capacity
            mask = table.row_valid
        key_ctx, where_b, key_b = _bind_route_keys(route_rep, key_refs,
                                                   where_expr)
        ctx = EmitContext(columns=routed,
                          bindings=bindings_to_device(key_ctx.bindings,
                                                      device),
                          capacity=bound_cap, device=device)
        if where_b is not None:
            d, v = where_b.emit(ctx)
            mask = mask & v & d.to(torch.bool)
        pid = _dest_hash(key_b, ctx, mask, bound_cap, n)
        cells = cell_counts(pid, mask, n)
        del ctx, mask

    memo_key = (shape, plan_fingerprint(plan), n, bound_cap,
                rules_fingerprint(rules))
    quota, bound = _initial_quota(evaluator._quota_memo, memo_key,
                                  bound_cap, n, headroom)
    while True:
        recv, recv_mask = route_rows_quota(mesh, routed, pid, quota)
        prepared_local = prepare(local_plan, _rep_chunk(
            n * quota, route_rep, device))
        planes2, cnt2 = prepared_local.run(recv, recv_mask)
        del recv, recv_mask
        prepared_front, out_planes, out_count = _gather_front(
            evaluator, prepared_local, planes2, cnt2, front_final)
        del planes2
        lanes = _replicated(mesh, [table.row_valid.sum(), cnt2, cells])
        all_cells = lanes[:, 2:].reshape(-1)
        max_cell = all_cells.max()
        parts = [out_count.reshape(1), (max_cell > quota).reshape(1),
                 max_cell.reshape(1)]
        if armed:
            parts += _mesh_lanes(lanes) + [all_cells]
        vals = _read_counts(torch.cat([p.to(torch.int64) for p in parts]))
        count, over, demand = int(vals[0]), int(vals[1]), int(vals[2])
        if not over:
            break
        if quota >= bound:
            raise YtError(
                "whole-plan exchange overflowed at the maximal quota "
                f"(quota={quota}, demand={demand})",
                code=EErrorCode.QueryExecutionError)
        if stats is not None:
            stats.whole_plan_retries += 1
        del out_planes
        quota = _escalate(quota, demand, headroom, bound)
    _settle_quota(evaluator._quota_memo, memo_key, demand, bound)
    if armed:
        in_rows, out_rows, off = _mesh_slices(vals, 3, n)
        entry = exchange_entry(
            f"shuffle/{shape}", vals[off: off + n * n], demand, quota,
            row_bytes(route_rep))
        publish_mesh(stats, plan_fingerprint(plan),
                     mesh_block(n, in_rows, out_rows, [entry]))
    return dist._assemble_chunk(prepared_front.output, out_planes, count)


# -- joins ---------------------------------------------------------------------

_OUT_CAP_UNBOUNDED = 1 << 40      # a join's expansion has no per-source bound


def _join_flat_names(join, needed) -> "list[tuple[str, str]]":
    """(flat output name, foreign column) pairs this join pulls, pruned
    to what the plan reads."""
    pairs = [(f"{join.alias}.{f}" if join.alias else f, f)
             for f in join.foreign_columns]
    if needed is not None:
        pairs = [(flat, f) for flat, f in pairs if flat in needed]
    return pairs


def _gate_fusable_join(join, foreign) -> None:
    """A foreign side whose columns are missing or hold `any` values
    cannot run on this rung."""
    for fname in join.foreign_columns:
        fcol = foreign.columns.get(fname)
        if fcol is None:
            raise YtError(f"Join table {join.foreign_table!r} has no "
                          f"column {fname!r}",
                          code=EErrorCode.QueryExecutionError)
        if fcol.type is EValueType.any:
            raise YtError(
                f"join column {fname!r} holds `any` values — not "
                "whole-plan fusable", code=EErrorCode.QueryUnsupported)


class _BroadcastSetup:
    """A replicated probe: the sorted foreign keys and the pulled
    columns in key order, whole on every rank; no exchange."""

    strategy = "broadcast"

    def __init__(self, join, self_bound, self_slots, f_bound, f_sorted,
                 pulled, n_foreign, f_cap, flat_names):
        self.join = join
        self.self_bound = self_bound
        self.self_slots = self_slots
        self.f_bound = f_bound
        self.f_sorted = f_sorted
        self.pulled = pulled
        self.n_foreign = n_foreign
        self.f_cap = f_cap
        self.flat_names = flat_names


class _PartitionSetup:
    """A co-partition exchange: both sides routed by key hash, then the
    probe and the match expansion per rank. `f_cols` / `f_valid` hold
    this rank's 1/n slice of the foreign chunk."""

    strategy = "partition"

    def __init__(self, join, self_bound, self_slots, f_bound,
                 foreign_slots, f_cols, f_valid, f_slice, f_count,
                 flat_names):
        self.join = join
        self.self_bound = self_bound
        self.self_slots = self_slots
        self.f_bound = f_bound
        self.foreign_slots = foreign_slots
        self.f_cols = f_cols
        self.f_valid = f_valid
        self.f_slice = f_slice
        self.f_count = f_count
        self.flat_names = flat_names


def _foreign_slice(evaluator, foreign, f_names, n: int, rank: int):
    """This rank's 1/n slice of a foreign chunk (the planes of `f_names`
    and the live mask), memoized per (chunk identity, mesh shape)."""
    f_count = foreign.row_count
    f_slice = pad_capacity(max(-(-f_count // n), 1))
    key = ("join-fslice", id(foreign), n, rank, f_slice, tuple(f_names))

    def build():
        lo = min(rank * f_slice, f_count)
        hi = min(lo + f_slice, f_count)
        cols = {f: (dist._rows_padded(foreign.columns[f].data, lo, hi,
                                      f_slice),
                    dist._rows_padded(foreign.columns[f].valid, lo, hi,
                                      f_slice))
                for f in f_names}
        valid = torch.arange(f_slice, device=foreign.device) < hi - lo
        return cols, valid, f_slice

    return dist._chunk_memo(evaluator._cache, key, foreign, build)


def _pulled_planes(evaluator, foreign, f_order, flat_names):
    """The pulled columns of a broadcast join in sorted-key order,
    memoized with the foreign sort."""
    key = ("join-pulled", id(foreign), id(f_order),
           tuple(f for _flat, f in flat_names))
    return dist._chunk_memo(evaluator._cache, key, foreign, lambda: [
        (foreign.columns[f].data[f_order], foreign.columns[f].valid[f_order])
        for _flat, f in flat_names])


def _join_pid(keys, mask, n: int, rank: int, keep_null_local: bool):
    """Destination rank by the encoded keys' hash (the stitched
    partitioned join's routing): null-keyed live rows stay local for LEFT
    joins (they still emit an unmatched row), else are discarded."""
    pid = dist._umod(dist._key_hash([(d, v) for v, d in keys],
                                    mask.shape[0], mask.device), n)
    pid = torch.where(null_key_mask(keys), rank if keep_null_local else n,
                      pid)
    return torch.where(mask, pid, n)


def _run_join(evaluator, plan: ir.Query, table, rules, stats,
              foreign_chunks: dict):
    """Multi-way equi-join plans: the cost-based planner orders the joins
    and picks broadcast or partition per side from the chunk statistics;
    broadcast sides probe their replicated sorted keys per shard,
    partition sides route both inputs by key hash over the quota exchange
    and expand the matches into a fixed capacity; the joined rowset then
    takes the gather shape. Each partition join has three data-dependent
    capacities (the two exchange quotas, the expansion capacity), each
    started from the planner's estimate or the memo, its demand returned
    in the one stacked read; an overflow re-runs at the demanded rung and
    the settled values memoize."""

    mesh = table.mesh
    n, me, device = mesh.size, mesh.rank, mesh.device
    cap = table.capacity
    headroom = compile_config().whole_plan_headroom
    armed = mesh_armed()

    # -- plan: order, strategies and pushdown from the chunk statistics --
    jplan = planner.plan_for_chunks(plan, table.total_rows, foreign_chunks)
    plan_x = planner.apply_order(plan, jplan)
    decisions = jplan.decisions
    needed = ir.referenced_columns(plan_x)
    scan_names = sorted(name for name in table.columns
                        if needed is None or name in needed)

    # -- host phase: bind every join against the widening namespace ------
    bindings: list = []
    namespace = {name: ColumnBinding(type=col.type, vocab=col.dictionary)
                 for name, col in table.columns.items()}
    rep_columns = dist._rep(table.columns)
    cur_rep = {name: rep_columns[name] for name in scan_names}
    setups: list = []
    stage_row_bytes: list = []      # (self, foreign) bytes/row, or None
    for join, decision in zip(plan_x.joins, decisions):
        foreign = foreign_chunks.get(join.foreign_table)
        if foreign is None:
            raise YtError(
                f"No data provided for join table {join.foreign_table!r}",
                code=EErrorCode.QueryExecutionError)
        _gate_fusable_join(join, foreign)
        evaluator._check_device(foreign)
        binder = ExprBinder(BindContext(columns=dict(namespace),
                                        bindings=bindings))
        self_bound = [binder.bind(e) for e in join.self_equations]
        f_bound = _bind_keys(foreign, join.foreign_schema,
                             join.foreign_equations, bindings)
        self_slots, foreign_slots = vocab_remap_slots(self_bound, f_bound,
                                                      bindings)
        flat_names = _join_flat_names(join, needed)
        strategy = decision.strategy
        if strategy == "broadcast":
            # Broadcast needs unique foreign keys (the probe takes one
            # match row); the check is memoized per chunk, and a side
            # that fails it takes the partition exchange.
            f_order, f_sorted, unique = dist._foreign_host_order(
                evaluator._cache, join, foreign, self_bound, f_bound,
                foreign_slots, bindings)
            if not unique:
                strategy = "partition"
        if strategy == "broadcast":
            setups.append(_BroadcastSetup(
                join, self_bound, self_slots, f_bound, f_sorted,
                _pulled_planes(evaluator, foreign, f_order, flat_names),
                foreign.row_count, foreign.capacity, flat_names))
            stage_row_bytes.append(None)
        else:
            f_refs: set = set()
            for eq in join.foreign_equations:
                f_refs.update(ir.expr_references(eq))
            f_names = sorted(f_refs | {f for _flat, f in flat_names})
            f_cols, f_valid, f_slice = _foreign_slice(
                evaluator, foreign, f_names, n, me)
            setups.append(_PartitionSetup(
                join, self_bound, self_slots, f_bound, foreign_slots,
                f_cols, f_valid, f_slice, foreign.row_count, flat_names))
            stage_row_bytes.append((
                row_bytes(cur_rep),
                row_bytes(dist._rep({f: foreign.columns[f]
                                      for f in f_names}))))
        for flat, fname in flat_names:
            fcol = foreign.columns[fname]
            namespace[flat] = ColumnBinding(type=fcol.type,
                                            vocab=fcol.dictionary)
            rep_columns[flat] = dist._RepColumn(type=fcol.type,
                                                dictionary=fcol.dictionary)
            cur_rep[flat] = rep_columns[flat]

    # Semi-join pushdown: selective INNER sides' key ranges mask self rows
    # before the first exchange (only a row that could match survives it,
    # so the results are the same). uint64 ranges are left out: their
    # planes hold int64 bit patterns.
    push: list = []
    for name, lo, hi in jplan.pushdown_ranges():
        col = table.columns.get(name)
        if col is not None and col.type in (EValueType.int64,
                                            EValueType.double):
            push.append((name, lo, hi))

    # Collective fault sites: the plan ends in an all_gather, and
    # partition joins ride the exchange.
    dist._FP_GATHER.hit()
    if any(s.strategy == "partition" for s in setups):
        dist._FP_ALL_TO_ALL.hit()
    _validate_scan(rules, scan_names)
    stage_names = [(f"join/{i}", True) for i in range(len(setups))]
    stage_names += [(f"shuffle/join/{i}", True)
                    for i, s in enumerate(setups) if s.strategy == "partition"]
    stage_names += [("bottom", True), ("front", False)]
    _validate_stages(rules, stage_names)

    # -- the post-join plan: bottom per rank, all_gather, front ----------
    plan_nojoin = dc_replace(plan_x, joins=())
    if needed is not None:
        plan_nojoin = dc_replace(plan_nojoin, schema=TableSchema(
            columns=tuple(c for c in plan_x.schema if c.name in needed)))
    bottom, front = split_plan(plan_nojoin)

    token = tuple((d.index, s.strategy) for d, s in zip(decisions, setups)) \
        + (tuple(name for name, _lo, _hi in push),)
    memo_base = ("join", plan_fingerprint(plan_x), token, n, cap,
                 rules_fingerprint(rules))

    def initial(kind: str, j: int, est: int, bound: int) -> int:
        start = evaluator._quota_memo.get(memo_base + (j, kind))
        if start is None:
            # pow2 rounding is the first guess's slack; an overflow
            # applies the headroom.
            start = min(bound, pad_capacity(max(64, est)))
        return min(start, bound)

    quotas: dict = {}
    for j, (setup, decision) in enumerate(zip(setups, decisions)):
        if setup.strategy != "partition":
            continue
        quotas[j] = {
            # Expected max transfer cell ≈ rows per rank / n under uniform
            # hashing; the overflow protocol absorbs skew.
            "qs": initial("qs", j, max(decision.est_in, 1) // (n * n), cap),
            "qf": initial("qf", j, max(setup.f_count, 1) // (n * n),
                          setup.f_slice),
            "out": initial("out", j, max(max(decision.est_out, 1) // n, 128),
                           _OUT_CAP_UNBOUNDED),
        }

    bnd = bindings_to_device(bindings, device)
    while True:
        cur = {name: (table.columns[name].data, table.columns[name].valid)
               for name in scan_names}
        mask = table.row_valid
        for name, lo, hi in push:
            d, v = cur[name]
            mask = mask & v & (d >= lo) & (d <= hi)
        cur_cap = cap
        caps: list = []
        local_stats: list = []          # 4 scalars per join
        mats: list = []                 # (n,) cell counts per exchange
        for j, setup in enumerate(setups):
            caps.append(cur_cap)
            ctx = EmitContext(columns=cur, bindings=bnd, capacity=cur_cap,
                              device=device)
            self_keys = _emit_encoded_keys(setup.self_bound,
                                           setup.self_slots, ctx)
            zero = torch.zeros((), dtype=torch.int64, device=device)
            if setup.strategy == "broadcast":
                with record_function("mesh.probe"):
                    s_cmp, f_cmp = _comparable_keys(
                        self_keys, setup.f_sorted, setup.self_bound,
                        setup.f_bound)
                    sl = [p for vd in f_cmp for p in vd] + \
                        [p for dv in setup.pulled for p in dv] + \
                        [setup.n_foreign]
                    pulled, mask = probe_replicated(
                        sl, len(f_cmp), setup.f_cap, s_cmp, mask,
                        setup.join.is_left)
                cur = dict(cur)
                for (flat, _f), plane in zip(setup.flat_names, pulled):
                    cur[flat] = plane
                local_stats += [zero, zero, zero, mask.sum()]
                continue
            q = quotas[j]
            is_left = setup.join.is_left
            with record_function("mesh.count"):
                f_keys = _emit_encoded_keys(
                    setup.f_bound, setup.foreign_slots,
                    EmitContext(columns=setup.f_cols, bindings=bnd,
                                capacity=setup.f_slice, device=device))
                pid_s = _join_pid(self_keys, mask, n, me, is_left)
                pid_f = _join_pid(f_keys, setup.f_valid, n, me, False)
                cells_s = cell_counts(pid_s, pid_s < n, n)
                cells_f = cell_counts(pid_f, pid_f < n, n)
            recv_s, mask_s = route_rows_quota(mesh, cur, pid_s, q["qs"])
            recv_f, mask_f = route_rows_quota(mesh, setup.f_cols, pid_f,
                                              q["qf"])
            S, F = n * q["qs"], n * q["qf"]
            with record_function("mesh.join"):
                s_keys = _emit_encoded_keys(
                    setup.self_bound, setup.self_slots,
                    EmitContext(columns=recv_s, bindings=bnd, capacity=S,
                                device=device))
                r_keys = _emit_encoded_keys(
                    setup.f_bound, setup.foreign_slots,
                    EmitContext(columns=recv_f, bindings=bnd, capacity=F,
                                device=device))
                f_order, f_sorted = sort_foreign_keys(
                    r_keys, mask_f,
                    [b.type is EValueType.uint64 for b in setup.f_bound])
                s_cmp, f_cmp = _comparable_keys(s_keys, f_sorted,
                                                setup.self_bound,
                                                setup.f_bound)
                n_f = mask_f.sum()
                lo = _lex_searchsorted(f_cmp, n_f, F, s_cmp, "left")
                hi = _lex_searchsorted(f_cmp, n_f, F, s_cmp, "right")
                counts = torch.where(mask_s & ~null_key_mask(s_keys),
                                     hi - lo, torch.zeros_like(lo))
                per_row = torch.where(mask_s, counts.clamp(min=1),
                                      torch.zeros_like(counts)) \
                    if is_left else counts
                offsets = torch.cumsum(per_row, 0)
                total = offsets[-1]
                cur, mask = dist._expand(
                    recv_s, recv_f, setup.flat_names, per_row, offsets,
                    total, q["out"], lo, counts, f_order)
            del recv_s, recv_f, f_order, f_sorted, lo, hi
            cur_cap = q["out"]
            local_stats += [cells_s.max(), cells_f.max(), total, mask.sum()]
            mats += [cells_s, cells_f]

        rep = {name: rep_columns[name] for name in cur
               if name in rep_columns}
        prepared_b = prepare(bottom, _rep_chunk(cur_cap, rep, device))
        planes, cnt = prepared_b.run(
            {c.name: cur[c.name] for c in bottom.schema if c.name in cur},
            mask)
        prepared_f, out_planes, out_count = _gather_front(
            evaluator, prepared_b, planes, cnt, front)
        del planes, cur, mask
        k = len(local_stats)
        lanes = _replicated(mesh, local_stats + [table.row_valid.sum(), cnt]
                            + mats)
        telemetry = []
        over = torch.zeros((), dtype=torch.bool, device=device)
        for j in range(len(setups)):
            ds, df, dout = (lanes[:, 4 * j + i].max() for i in range(3))
            telemetry += [ds, df, dout, lanes[:, 4 * j + 3].sum()]
            if j in quotas:
                q = quotas[j]
                over = over | (ds > q["qs"]) | (df > q["qf"]) | \
                    (dout > q["out"])
        parts = [out_count.reshape(1), over.reshape(1)] + \
            [t.reshape(1) for t in telemetry]
        if armed:
            parts += _mesh_lanes(lanes[:, k:k + 2]) + [
                lanes[:, k + 2 + n * i: k + 2 + n * (i + 1)].reshape(-1)
                for i in range(len(mats))]
        vals = _read_counts(torch.cat([p.to(torch.int64) for p in parts]))
        count, overflowed = int(vals[0]), int(vals[1])
        if not overflowed:
            break
        if stats is not None:
            stats.whole_plan_retries += 1
        del out_planes
        escalated = False
        for j, setup in enumerate(setups):
            if setup.strategy != "partition":
                continue
            q = quotas[j]
            for kind, demand, bound in (
                    ("qs", int(vals[2 + 4 * j]), caps[j]),
                    ("qf", int(vals[3 + 4 * j]), setup.f_slice),
                    ("out", int(vals[4 + 4 * j]), _OUT_CAP_UNBOUNDED)):
                if demand <= q[kind]:
                    continue
                if q[kind] >= bound:
                    raise YtError(
                        "whole-plan join exchange overflowed at the "
                        f"maximal quota (join {j}, {kind}={q[kind]}, "
                        f"demand={demand})",
                        code=EErrorCode.QueryExecutionError)
                q[kind] = _escalate(q[kind], demand, headroom, bound)
                escalated = True
        if not escalated:
            raise YtError("whole-plan join overflow without a demand "
                          "above its quota: the telemetry is inconsistent",
                          code=EErrorCode.QueryExecutionError)

    for j, setup in enumerate(setups):
        if setup.strategy == "partition":
            for kind, i, bound in (("qs", 2, caps[j]),
                                   ("qf", 3, setup.f_slice),
                                   ("out", 4, _OUT_CAP_UNBOUNDED)):
                _settle_quota(evaluator._quota_memo, memo_base + (j, kind),
                              int(vals[i + 4 * j]), bound)
    if stats is not None:
        for j, (setup, decision) in enumerate(zip(setups, decisions)):
            stats.note_join_stage(
                j, setup.join.foreign_table, setup.strategy,
                est_rows=decision.est_out,
                actual_rows=int(vals[5 + 4 * j]))
    if armed:
        in_rows, out_rows, off = _mesh_slices(vals, 2 + 4 * len(setups), n)
        exchanges: list = []
        stages_meta: list = []
        for j, (setup, decision) in enumerate(zip(setups, decisions)):
            actual = int(vals[5 + 4 * j])
            stages_meta.append({
                "stage": j, "table": setup.join.foreign_table,
                "strategy": setup.strategy,
                "est_rows": int(decision.est_out), "actual_rows": actual,
                "drift": planner.est_drift(decision.est_out, actual)})
            if setup.strategy != "partition":
                continue
            self_bytes, f_bytes = stage_row_bytes[j]
            for side, demand, quota, side_bytes in (
                    ("self", vals[2 + 4 * j], quotas[j]["qs"], self_bytes),
                    ("foreign", vals[3 + 4 * j], quotas[j]["qf"], f_bytes)):
                exchanges.append(exchange_entry(
                    f"join[{j}]/{side}", vals[off: off + n * n],
                    int(demand), quota, side_bytes))
                off += n * n
        publish_mesh(stats, plan_fingerprint(plan_x),
                     mesh_block(n, in_rows, out_rows, exchanges,
                                stages=stages_meta))
    return dist._assemble_chunk(prepared_f.output, out_planes, count)
