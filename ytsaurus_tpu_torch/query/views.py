"""Continuous queries: incremental materialized views over ordered tablets
(the Flow / YQL-streaming analog). Own copy of the JAX package's
`query/views.py`.

A materialized view is a standing QL query over an ORDERED (queue) table
whose results live in a SORTED dynamic table readable by normal selects.
A refresher tails the source through a committed offset cursor (the same
consumer-table machinery `queue_agent` uses), runs the view's compiled
plan incrementally per micro-batch, and upserts results into the target —
with the offset commit and the target write in ONE 2PC transaction, so a
crash anywhere in the loop replays the batch instead of double-applying
it (exactly-once).

Incremental evaluation reuses the distributed GROUP BY machinery
verbatim: `coordinator.split_plan` already decomposes every aggregate
into a MERGEABLE partial state (avg → (sum, count), argmin/argmax →
(value, by) pairs, count merges by sum) so per-shard partials combine at
the front.  Here the "shards" are micro-batches separated in TIME rather
than space:

  batch_plan   the bottom query — group keys + partial aggregate states
               over one micro-batch chunk;
  merge_plan   the front combine — re-groups (stored states ∪ batch
               states) with each aggregate's merge function;
  finalize     states → reader-facing columns (avg divides its sum by
               its count; argmin keeps its `__b` state column alongside
               the value so the NEXT merge still has it).

Non-aggregating selects skip the merge: filtered/projected rows upsert
directly, keyed by the source `$row_index` (idempotent by construction).

Every batch and merge runs on the client's evaluator, on the cluster's
device (its GROUP BY sorts through the radix kernels). The reference pads
each batch to a power-of-two capacity so that one compiled program
replays; the port runs eagerly and compiles nothing, so a batch chunk is
as large as its rows, with the same results. Not ported: the view-lag
SLO evaluation (`utils/slo.py`); the refresher still counts
`/views/lag_ok` and `/views/lag_breach`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.coordinator import _MERGE_FN, split_plan
from ytsaurus_tpu_torch.schema import EValueType, TableSchema
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import child_span
from ytsaurus_tpu_torch.utils import sanitizers

VIEWS_ROOT = "//sys/views"

# Failpoint sites: batch_execute covers the read +
# incremental-evaluation leg; commit sits BETWEEN the staged target write
# and the offset commit — the exact spot where a two-transaction protocol
# would double-apply.  The chaos soak proves the single-2PC protocol
# keeps the view bit-identical to a full recompute across crashes here.
_FP_BATCH = failpoints.register_site("views.batch_execute")
_FP_COMMIT = failpoints.register_site("views.commit")


# -- incremental plan preparation ----------------------------------------------


@dataclass(frozen=True)
class _Finalizer:
    """How one original aggregate's merged state becomes reader columns."""
    name: str          # reader-facing column (the aggregate's alias)
    kind: str          # scalar | avg | argfn
    state_names: tuple[str, ...]   # state columns persisted in the target


@dataclass(frozen=True)
class IncrementalPlan:
    """Everything the refresher needs, prepared ONCE per view."""
    plan: ir.Query                    # full plan (the recompute oracle)
    batch_plan: ir.Query              # per-micro-batch (bottom) program
    merge_plan: Optional[ir.Query]    # state combine (None: plain select)
    state_schema: TableSchema         # batch_plan output namespace
    target_schema: TableSchema        # sorted target table schema
    key_names: tuple[str, ...]        # target key columns
    finalizers: tuple[_Finalizer, ...] = ()

    @property
    def aggregating(self) -> bool:
        return self.merge_plan is not None

    # -- state <-> stored row conversion ---------------------------------------

    def stored_to_state(self, row: dict) -> dict:
        """A target row (as lookup returns it) → a state-schema row."""
        out = {k: row[k] for k in self.key_names}
        for fin in self.finalizers:
            if fin.kind == "argfn":
                out[fin.state_names[0]] = row[fin.name]
                out[fin.state_names[1]] = row[fin.state_names[1]]
            else:
                for state in fin.state_names:
                    out[state] = row[state]
        return out

    def finalize(self, state_row: dict) -> dict:
        """A merged state row → the target upsert row (finalized columns
        for readers + the state columns the NEXT merge needs)."""
        out = {k: state_row[k] for k in self.key_names}
        for fin in self.finalizers:
            if fin.kind == "avg":
                s_name, c_name = fin.state_names
                s, c = state_row[s_name], state_row[c_name]
                out[fin.name] = (s / c) if c else None
                out[s_name] = s
                out[c_name] = c
            elif fin.kind == "argfn":
                v_name, b_name = fin.state_names
                out[fin.name] = state_row[v_name]
                out[b_name] = state_row[b_name]
            else:
                out[fin.name] = state_row[fin.name]
        return out


def _reject(condition: bool, what: str) -> None:
    if condition:
        raise YtError(
            f"Materialized views do not support {what}: a continuous "
            f"view must be incrementally mergeable per micro-batch",
            code=EErrorCode.QueryUnsupported)


ROW_INDEX = "$row_index"


def prepare_incremental(plan: ir.Query) -> IncrementalPlan:
    """Validate a view plan and derive its incremental decomposition.

    Supported: WHERE + projection (plain views, keyed by source
    $row_index) and GROUP BY with mergeable aggregates (sum/min/max/
    count/avg/first/argmin/argmax).  Rejected: joins, window functions,
    ORDER BY/LIMIT/OFFSET/HAVING/WITH TOTALS, and cardinality() —
    none of them merge from per-batch partials.
    """
    _reject(bool(plan.joins), "JOIN")
    _reject(plan.window is not None, "window functions")
    _reject(plan.order is not None, "ORDER BY")
    _reject(plan.limit is not None or plan.offset != 0, "LIMIT/OFFSET")
    _reject(plan.having is not None, "HAVING")
    if plan.group is not None:
        _reject(plan.group.totals, "WITH TOTALS")
        _reject(any(a.function == "cardinality"
                    for a in plan.group.aggregate_items),
                "cardinality() (distinct counts need the full rowset)")
        return _prepare_aggregating(plan)
    return _prepare_plain(plan)


def _prepare_plain(plan: ir.Query) -> IncrementalPlan:
    """Non-aggregating view: rows upsert keyed by the source $row_index
    (carried through the projection if one is declared)."""
    batch_plan = plan
    if plan.project is not None and not any(
            item.name == ROW_INDEX for item in plan.project.items):
        row_ref = ir.NamedExpr(
            name=ROW_INDEX,
            expr=ir.TReference(type=EValueType.int64, name=ROW_INDEX))
        batch_plan = replace(plan, project=ir.ProjectClause(
            items=(row_ref,) + tuple(plan.project.items)))
    out_schema = batch_plan.output_schema()
    cols = [(ROW_INDEX, "int64", "ascending")]
    cols += [(c.name, c.type.value) for c in out_schema
             if c.name != ROW_INDEX]
    target_schema = TableSchema.make(cols, unique_keys=True)
    return IncrementalPlan(
        plan=plan, batch_plan=batch_plan, merge_plan=None,
        state_schema=out_schema, target_schema=target_schema,
        key_names=(ROW_INDEX,))


def _normalize_agg_projection(plan: ir.Query) -> ir.Query:
    """Fold the projection into the group clause.

    The builder names aggregate slots `_aggN` internally and maps
    `... AS alias` through PROJECT references; an incremental view
    persists the group output as the TARGET TABLE, so the aliases must
    become the group/aggregate slot names themselves.  Only plain
    reference projections are mergeable — a computed projection over
    aggregates (`sum(a)/sum(b) AS ratio`) would need re-finalizing from
    states on every read, which plain selects on the target cannot do.
    Unprojected aggregates are dropped (dead state); unprojected group
    keys are kept (they ARE the target key)."""
    if plan.project is None:
        return plan
    key_names = {i.name for i in plan.group.group_items}
    agg_names = {a.name for a in plan.group.aggregate_items}
    rename: dict[str, str] = {}
    for item in plan.project.items:
        _reject(not isinstance(item.expr, ir.TReference)
                or item.expr.name not in key_names | agg_names,
                "computed projections over aggregates (select group "
                "keys and aggregates directly, e.g. `g, sum(v) AS s`)")
        rename[item.expr.name] = item.name
    group = ir.GroupClause(
        group_items=tuple(
            ir.NamedExpr(name=rename.get(i.name, i.name), expr=i.expr)
            for i in plan.group.group_items),
        aggregate_items=tuple(
            replace(a, name=rename[a.name])
            for a in plan.group.aggregate_items if a.name in rename))
    return replace(plan, group=group, project=None)


def _prepare_aggregating(plan: ir.Query) -> IncrementalPlan:
    """GROUP BY view: split_plan's bottom runs per batch; the merge plan
    re-groups stored ∪ fresh partial states with each aggregate's merge
    function (states stay states so the NEXT batch can merge again)."""
    plan = _normalize_agg_projection(plan)
    bottom, _front = split_plan(plan)
    state_schema = bottom.output_schema()
    key_names = tuple(item.name for item in plan.group.group_items)

    group_refs = tuple(
        ir.NamedExpr(name=item.name,
                     expr=ir.TReference(type=item.expr.type,
                                        name=item.name))
        for item in plan.group.group_items)

    merge_aggs: list[ir.AggregateItem] = []
    finalizers: list[_Finalizer] = []
    for agg in plan.group.aggregate_items:
        if agg.function in ("argmin", "argmax"):
            v_name, b_name = f"{agg.name}__v", f"{agg.name}__b"
            by_type = agg.by_argument.type
            merge_aggs.append(ir.AggregateItem(
                name=v_name, function=agg.function,
                argument=ir.TReference(type=agg.type, name=v_name),
                type=agg.type, state_type=agg.state_type,
                by_argument=ir.TReference(type=by_type, name=b_name)))
            merge_aggs.append(ir.AggregateItem(
                name=b_name,
                function="min" if agg.function == "argmin" else "max",
                argument=ir.TReference(type=by_type, name=b_name),
                type=by_type, state_type=by_type))
            finalizers.append(_Finalizer(agg.name, "argfn",
                                         (v_name, b_name)))
        elif agg.function == "avg":
            s_name, c_name = f"{agg.name}__s", f"{agg.name}__c"
            merge_aggs.append(ir.AggregateItem(
                name=s_name, function="sum",
                argument=ir.TReference(type=EValueType.double,
                                       name=s_name),
                type=EValueType.double, state_type=EValueType.double))
            merge_aggs.append(ir.AggregateItem(
                name=c_name, function="sum",
                argument=ir.TReference(type=EValueType.int64,
                                       name=c_name),
                type=EValueType.int64, state_type=EValueType.int64))
            finalizers.append(_Finalizer(agg.name, "avg",
                                         (s_name, c_name)))
        else:
            merge_aggs.append(ir.AggregateItem(
                name=agg.name, function=_MERGE_FN[agg.function],
                argument=ir.TReference(type=agg.state_type,
                                       name=agg.name),
                type=agg.type, state_type=agg.state_type))
            finalizers.append(_Finalizer(agg.name, "scalar",
                                         (agg.name,)))

    merge_plan = ir.Query(
        schema=state_schema,
        group=ir.GroupClause(group_items=group_refs,
                             aggregate_items=tuple(merge_aggs)))

    cols: list[tuple] = [(item.name, item.expr.type.value, "ascending")
                         for item in plan.group.group_items]
    for agg, fin in zip(plan.group.aggregate_items, finalizers):
        cols.append((agg.name, agg.type.value))
        if fin.kind == "avg":
            cols.append((fin.state_names[0], "double"))
            cols.append((fin.state_names[1], "int64"))
        elif fin.kind == "argfn":
            cols.append((fin.state_names[1],
                         agg.by_argument.type.value))
    target_schema = TableSchema.make(cols, unique_keys=True)
    return IncrementalPlan(
        plan=plan, batch_plan=bottom, merge_plan=merge_plan,
        state_schema=state_schema, target_schema=target_schema,
        key_names=key_names, finalizers=tuple(finalizers))


# -- view registry (Cypress-backed) --------------------------------------------


@dataclass
class ViewSpec:
    name: str
    query: str
    source: str
    target: str
    consumer: str
    pool: str = "views"
    batch_rows: int = 1024
    state: str = "running"        # running | paused

    def to_dict(self) -> dict:
        return {"name": self.name, "query": self.query,
                "source": self.source, "target": self.target,
                "consumer": self.consumer, "pool": self.pool,
                "batch_rows": self.batch_rows, "state": self.state}

    @classmethod
    def from_dict(cls, d: dict) -> "ViewSpec":
        return cls(name=d["name"], query=d["query"], source=d["source"],
                   target=d["target"], consumer=d["consumer"],
                   pool=d.get("pool", "views"),
                   batch_rows=int(d.get("batch_rows", 1024)),
                   state=d.get("state", "running"))


def _spec_path(name: str) -> str:
    return f"{VIEWS_ROOT}/{name}"


def build_view_plan(client, query: str) -> ir.Query:
    from ytsaurus_tpu_torch.client import _SchemaResolver
    from ytsaurus_tpu_torch.query.builder import build_query
    return build_query(query, _SchemaResolver(client))


def create_materialized_view(client, name: str, query: str,
                             source: Optional[str] = None,
                             target: Optional[str] = None,
                             pool: str = "views",
                             batch_rows: Optional[int] = None) -> dict:
    """Register a continuous view: validate the plan, create + mount the
    sorted target table (schema derived from the plan's incremental
    decomposition), register a VITAL offset consumer on the source queue
    (auto-trim then never outruns the view), and persist the spec at
    //sys/views/<name>.  Returns the spec as a dict."""
    if not name or "/" in name:
        raise YtError(f"Bad view name {name!r}",
                      code=EErrorCode.QueryTypeError)
    # A view exists once its @view_spec landed (the LAST step below):
    # keying on the spec rather than the bare node keeps a half-created
    # registry entry (a failure mid-create) re-creatable instead of
    # permanently wedging the name.
    if client.exists(_spec_path(name) + "/@view_spec"):
        raise YtError(f"View {name!r} already exists",
                      code=EErrorCode.AlreadyExists)
    if batch_rows is None:
        from ytsaurus_tpu_torch.config import views_config
        batch_rows = views_config().default_batch_rows
    if batch_rows <= 0:
        raise YtError("batch_rows must be positive",
                      code=EErrorCode.InvalidConfig)
    plan = build_view_plan(client, query)
    if source is not None and source != plan.source:
        raise YtError(
            f"View source {source!r} does not match the query's FROM "
            f"table {plan.source!r}", code=EErrorCode.QueryTypeError)
    source = plan.source
    from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
    (tablet,) = client._mounted_tablets(source)
    if not isinstance(tablet, OrderedTablet):
        raise YtError(
            f"View source {source!r} must be an ordered (queue) table",
            code=EErrorCode.QueryUnsupported)
    inc = prepare_incremental(plan)
    target = target or f"{VIEWS_ROOT}/{name}/target"
    consumer = f"{VIEWS_ROOT}/{name}/consumer"
    if client.exists(target):
        raise YtError(f"View target {target!r} already exists",
                      code=EErrorCode.AlreadyExists)
    client.create("map_node", _spec_path(name), recursive=True,
                  ignore_existing=True)
    try:
        client.create("table", target, recursive=True,
                      attributes={"schema": inc.target_schema,
                                  "dynamic": True})
        client.mount_table(target)
        client.register_queue_consumer(source, consumer, vital=True)
        spec = ViewSpec(name=name, query=query, source=source,
                        target=target, consumer=consumer, pool=pool,
                        batch_rows=batch_rows)
        client.set(_spec_path(name) + "/@view_spec", spec.to_dict())
    except Exception:
        # Failure-atomic registration: a half-created view (target
        # mounted but no spec, consumer registered but no spec) would
        # be unlistable AND unremovable.  Best-effort rollback; the
        # name stays re-creatable either way (the exists-precheck keys
        # on @view_spec).
        for cleanup in (
                lambda: client.unregister_queue_consumer(source,
                                                         consumer),
                lambda: client.remove(_spec_path(name), recursive=True),
                # We created the target above (pre-existing ones error
                # out earlier); an external one needs its own removal.
                lambda: client.exists(target) and
                client.remove(target, recursive=True)):
            try:
                cleanup()
            except YtError:
                pass
        raise
    return spec.to_dict()


def list_views(client) -> list[str]:
    if not client.exists(VIEWS_ROOT):
        return []
    return sorted(n for n in client.list(VIEWS_ROOT)
                  if client.exists(_spec_path(n) + "/@view_spec"))


def load_view(client, name: str) -> ViewSpec:
    path = _spec_path(name) + "/@view_spec"
    if not client.exists(path):
        raise YtError(f"No such view {name!r}",
                      code=EErrorCode.NoSuchNode)
    data = client.get(path)
    try:
        return ViewSpec.from_dict(data)
    except (KeyError, TypeError, ValueError, AttributeError) as exc:
        # A hand-edited @view_spec must surface as a diagnosable
        # YtError, not pierce the daemon/CLI as a bare KeyError.
        raise YtError(f"View {name!r} has a corrupt @view_spec "
                      f"({exc!r}): {data!r}",
                      code=EErrorCode.InvalidConfig) from exc


def set_view_state(client, name: str, state: str) -> dict:
    if state not in ("running", "paused"):
        raise YtError(f"Bad view state {state!r}",
                      code=EErrorCode.InvalidConfig)
    spec = load_view(client, name)
    spec.state = state
    client.set(_spec_path(name) + "/@view_spec", spec.to_dict())
    return spec.to_dict()


def remove_view(client, name: str, drop_target: bool = False) -> None:
    """Drop the view: registry node, consumer table (it lives under the
    registry node), and the source registration.  Target-table fate:
    a DEFAULT-path target (//sys/views/<name>/target) is owned by the
    view and would die with the registry node anyway — it is removed
    unless the caller parks it first with a Cypress move; an EXTERNAL
    target survives unless drop_target=True.  A missing source table
    (already dropped by the operator) must not wedge removal — the
    unregister is best-effort."""
    spec = load_view(client, name)
    try:
        client.unregister_queue_consumer(spec.source, spec.consumer)
    except YtError:
        # Source gone (or not a queue anymore): nothing to unregister,
        # and an unremovable view would error on every daemon pass.
        pass
    internal_target = spec.target.startswith(_spec_path(name) + "/")
    client.remove(_spec_path(name), recursive=True)
    if drop_target and not internal_target and \
            client.exists(spec.target):
        client.remove(spec.target, recursive=True)


def view_status(client, name: str) -> dict:
    """Spec + live cursor/lag + last-commit freshness — the `yt view
    show` / monitoring payload."""
    spec = load_view(client, name)
    from ytsaurus_tpu_torch.server.queue_agent import _consumer_offset
    offset = _consumer_offset(client, spec.consumer, spec.source)
    (tablet,) = client._mounted_tablets(spec.source)
    progress = {}
    progress_path = _spec_path(name) + "/@view_progress"
    if client.exists(progress_path):
        progress = client.get(progress_path)
    return {
        **spec.to_dict(),
        "offset": offset,
        "source_row_count": tablet.row_count,
        "source_trimmed_count": tablet.trimmed_count,
        "lag_rows": max(tablet.row_count - offset, 0),
        "progress": progress,
    }


# -- the incremental refresher -------------------------------------------------


@dataclass
class BatchResult:
    view: str
    rows_in: int = 0               # source rows consumed
    rows_out: int = 0              # target rows upserted
    offset: int = 0                # committed cursor after this batch
    lag_rows: int = 0
    commit_timestamp: Optional[int] = None
    empty: bool = False
    trim_skipped: int = 0
    batch_seconds: float = 0.0
    freshness_seconds: Optional[float] = None


class ViewRefresher:
    """One view's tail loop: pull a micro-batch at the committed offset,
    evaluate incrementally, upsert + advance the cursor in ONE 2PC
    transaction.  Thread-safe; a single instance serializes its own
    refreshes, and CONCURRENT writers (a second daemon, a manual
    `yt view refresh`) are safe too: a stale batch is rejected by the
    optimistic cursor check inside the commit window — or by the
    tablet's write-conflict check on the shared consumer row when the
    races overlap — so exactly one writer's batch lands and the loser
    replays from the committed cursor."""

    def __init__(self, client, spec: ViewSpec,
                 evaluator=None, accountant=None, config_provider=None):
        self.client = client
        self.spec = spec
        self.inc = prepare_incremental(build_view_plan(client, spec.query))
        self._evaluator = evaluator
        self._accountant = accountant
        # Where ViewsConfig knobs (lag_slo_rows) come from: the daemon
        # passes its own dynamically-configured view, standalone
        # refreshers fall back to the process-global config.
        self._config_provider = config_provider
        # The refresher's single-writer discipline: one refresh (the
        # read-merge-write critical section) at a time.
        # hot=False: this mutex COVERS the read-merge-write refresh
        # critical section — query execution, 2PC commit, the works —
        # by design (single-writer per view); hold-budget and
        # blocking-op rules don't apply to a coarse section lock.
        # guards: _last_result
        self._lock = sanitizers.register_lock(
            "views.ViewRefresher._lock", hot=False)
        self._last_result: Optional[BatchResult] = None
        prof = Profiler("/views").with_tags(view=spec.name)
        self._s_batches = prof.counter("batches")
        self._s_rows_in = prof.counter("rows_in")
        self._s_rows_out = prof.counter("rows_out")
        self._s_empty = prof.counter("empty_batches")
        self._s_conflicts = prof.counter("conflicts")
        self._s_trim_skips = prof.counter("trim_skipped_rows")
        self._s_lag = prof.gauge("lag_rows")
        self._s_fresh = prof.gauge("freshness_seconds")
        self._s_batch_seconds = prof.summary("batch_seconds")
        self._s_lag_ok = prof.counter("lag_ok")
        self._s_lag_breach = prof.counter("lag_breach")

    @property
    def evaluator(self):
        return self._evaluator or self.client.cluster.evaluator

    # -- one micro-batch -------------------------------------------------------

    def refresh_once(self) -> BatchResult:
        with self._lock:
            with child_span("views.refresh", view=self.spec.name):
                result = self._refresh_locked()
                self._last_result = result
                return result

    @property
    def last_result(self) -> "Optional[BatchResult]":
        with self._lock:
            return self._last_result

    def _refresh_locked(self) -> BatchResult:
        from ytsaurus_tpu_torch.server.queue_agent import (
            _consumer_offset,
            advance_consumer,
        )
        client, spec = self.client, self.spec
        t0 = time.perf_counter()
        result = BatchResult(view=spec.name)
        offset = _consumer_offset(client, spec.consumer, spec.source)
        (tablet,) = client._mounted_tablets(spec.source)
        trimmed = tablet.trimmed_count
        if offset < trimmed:
            # Rows were trimmed past the cursor (a non-vital operator
            # trim): they are unrecoverable, so skip the cursor to the
            # trim boundary — counted, never silent — instead of
            # spinning on an un-servable offset forever.
            result.trim_skipped = trimmed - offset
            self._s_trim_skips.increment(result.trim_skipped)
            advance_consumer(client, spec.consumer, spec.source, trimmed)
            offset = trimmed
        row_count = tablet.row_count
        if offset >= row_count:
            result.empty = True
            result.offset = offset
            self._s_empty.increment()
            self._observe_lag(result, row_count, offset, None)
            return result
        _FP_BATCH.hit()
        rows = client.pull_queue(spec.source, offset=offset,
                                 limit=spec.batch_rows)
        if not rows:                      # trimmed under us: retry next pass
            result.empty = True
            result.offset = offset
            self._s_empty.increment()
            self._observe_lag(result, row_count, offset, None)
            return result
        new_offset = rows[-1][ROW_INDEX] + 1
        max_source_ts = max((r.get("$timestamp") or 0) for r in rows)
        upserts = self._compute_upserts(rows)
        commit_ts = self._commit(upserts, new_offset,
                                 base_offset=offset)
        result.rows_in = len(rows)
        result.rows_out = len(upserts)
        result.offset = new_offset
        result.commit_timestamp = commit_ts
        result.batch_seconds = time.perf_counter() - t0
        self._s_batches.increment()
        self._s_rows_in.increment(len(rows))
        self._s_rows_out.increment(len(upserts))
        self._s_batch_seconds.record(result.batch_seconds)
        self._observe_lag(result, tablet.row_count, new_offset,
                          max_source_ts)
        self._record_progress(result)
        self._account(result)
        return result

    def _compute_upserts(self, rows: list[dict]) -> list[dict]:
        inc = self.inc
        device = self.evaluator.device
        chunk = ColumnarChunk.from_rows(inc.batch_plan.schema, rows,
                                        device=device)
        states = self.evaluator.run_plan(inc.batch_plan, chunk)
        if not inc.aggregating:
            return states.to_rows()
        fresh = states.to_rows()
        if not fresh:
            return []
        # Delta-merge: lookup the touched groups' stored states, then
        # re-group (stored ∪ fresh) with the merge combine — the same
        # mergeable-state algebra the GROUP BY shuffle uses, pointed at
        # micro-batches in time instead of shards in space.
        seen: set = set()
        keys = []
        for row in fresh:
            key = tuple(row[k] for k in inc.key_names)
            if key not in seen:
                seen.add(key)
                keys.append(key)
        stored = self.client._lookup_rows_direct(self.spec.target, keys)
        prev_states = [inc.stored_to_state(r) for r in stored
                       if r is not None]
        merged_in = states
        if prev_states:
            prev = ColumnarChunk.from_rows(inc.state_schema, prev_states,
                                           device=device)
            merged_in = concat_chunks(
                [prev, states.slice_rows(0, states.row_count)])
        merged = self.evaluator.run_plan(inc.merge_plan, merged_in)
        return [inc.finalize(r) for r in merged.to_rows()]

    def _commit(self, upserts: list[dict], new_offset: int,
                base_offset: int) -> Optional[int]:
        """Target write + offset advance, atomically.  An all-filtered
        batch has nothing to upsert: the cursor still must advance or
        the loop re-reads the batch forever — a monotonic
        advance_consumer (with the optimistic old_offset check) is
        exactly-once by idempotence there."""
        from ytsaurus_tpu_torch.server.queue_agent import (
            _consumer_offset,
            advance_consumer,
        )
        client, spec = self.client, self.spec
        if not upserts:
            _FP_COMMIT.hit()
            try:
                advance_consumer(client, spec.consumer, spec.source,
                                 new_offset, old_offset=base_offset)
            except YtError as err:
                if err.code == EErrorCode.TransactionLockConflict:
                    self._s_conflicts.increment()
                raise
            return None
        tx = client.start_transaction()
        try:
            # Optimistic cursor check INSIDE the transaction window: a
            # concurrent writer (second daemon / manual refresh) that
            # committed BEFORE our tx started moved the cursor — our
            # batch is stale and re-applying its delta would
            # double-count.  One that commits AFTER this read trips the
            # tablet's last-committed-timestamp conflict check on the
            # shared consumer row at 2PC prepare instead.  Either way
            # exactly one writer's batch lands.
            if _consumer_offset(client, spec.consumer,
                                spec.source) != base_offset:
                raise YtError(
                    f"View {self.spec.name!r} cursor moved past "
                    f"{base_offset} (concurrent refresher?); "
                    f"replaying the batch",
                    code=EErrorCode.TransactionLockConflict)
            client.insert_rows(spec.target, upserts, tx=tx)
            # The classic torn spot: target staged, offset not yet.  A
            # crash here must lose BOTH (the tx never commits) — never
            # one of them.
            _FP_COMMIT.hit()
            client.insert_rows(spec.consumer, [{
                "queue_path": spec.source, "partition_index": 0,
                "offset": new_offset}], tx=tx)
            return client.commit_transaction(tx)
        except YtError as err:
            if tx.state == "active":
                client.abort_transaction(tx)
            if err.code == EErrorCode.TransactionLockConflict:
                self._s_conflicts.increment()
            raise

    # -- bookkeeping -----------------------------------------------------------

    def _views_config(self):
        if self._config_provider is not None:
            return self._config_provider()
        from ytsaurus_tpu_torch.config import views_config
        return views_config()

    def _observe_lag(self, result: BatchResult, row_count: int,
                     offset: int, max_source_ts: Optional[int]) -> None:
        result.lag_rows = max(row_count - offset, 0)
        self._s_lag.set(result.lag_rows)
        if max_source_ts:
            from ytsaurus_tpu_torch.tablet.timestamp import COUNTER_BITS
            result.freshness_seconds = max(
                time.time() - (max_source_ts >> COUNTER_BITS), 0.0)
            self._s_fresh.set(result.freshness_seconds)
        # The view-lag SLO pair: every pass votes good/bad against the
        # configured freshness-lag objective; the burn-rate tracker
        # (utils/slo.py) alerts on the ratio over the history rings.
        if result.lag_rows > self._views_config().lag_slo_rows:
            self._s_lag_breach.increment()
        else:
            self._s_lag_ok.increment()

    def _record_progress(self, result: BatchResult) -> None:
        progress = {
            "offset": result.offset,
            "lag_rows": result.lag_rows,
            "last_commit_timestamp": result.commit_timestamp,
            "last_batch_rows": result.rows_in,
            "last_batch_seconds": round(result.batch_seconds, 6),
        }
        # Freshness rides the TARGET node so plain readers can check how
        # stale their select is without knowing the view registry.
        self.client.set(_spec_path(self.spec.name) + "/@view_progress",
                        progress)
        self.client.set(self.spec.target + "/@view_freshness", {
            "offset": result.offset,
            "commit_timestamp": result.commit_timestamp,
            "freshness_seconds": result.freshness_seconds,
        })

    def _account(self, result: BatchResult) -> None:
        """Refresh work folds into per-tenant accounting under the
        view's pool, so `yt top` attributes daemon load."""
        from ytsaurus_tpu_torch.query.accounting import get_accountant
        accountant = self._accountant or get_accountant()
        accountant.observe_view_batch(
            self.spec.pool, rows_read=result.rows_in,
            rows_written=result.rows_out,
            wall_seconds=result.batch_seconds)

    # -- drain -----------------------------------------------------------------

    def refresh(self, max_batches: int = 0) -> dict:
        """Run micro-batches until the cursor catches the head (or
        max_batches > 0 caps the pass).  Returns a roll-up."""
        batches = rows_in = rows_out = trim_skipped = 0
        lag = 0
        while True:
            result = self.refresh_once()
            lag = result.lag_rows
            trim_skipped += result.trim_skipped
            if result.empty:
                break
            batches += 1
            rows_in += result.rows_in
            rows_out += result.rows_out
            if result.lag_rows <= 0:
                break
            if max_batches and batches >= max_batches:
                break
        return {"view": self.spec.name, "batches": batches,
                "rows_in": rows_in, "rows_out": rows_out,
                "lag_rows": lag, "trim_skipped": trim_skipped}
