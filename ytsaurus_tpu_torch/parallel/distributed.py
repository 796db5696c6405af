"""Distributed query execution over a mesh of processes.

Port of the JAX package's `parallel/distributed.py` (`ShardedTable`,
`DistributedEvaluator` with its gather merge, broadcast join, partitioned
join and key-hash exchanges, `host_sync_count`). Every shard lives on its
own process (one rank of a `parallel/mesh.py` mesh) and device; the bottom
query runs on each rank's shard, and the partial results meet through
`torch.distributed` collectives:

  gather merge      bottom per shard → all_gather of the partial planes
                    and their row counts → the front on every rank
  broadcast join    unique foreign keys: each rank sorts the whole foreign
                    chunk once (memoized per chunk) and probes its shard
                    before the bottom query
  partitioned join  both sides routed by join-key hash over one exchange,
                    then a local sort-merge join with match expansion
  shuffled finish   GROUP BY (by group key) or a PARTITION BY window (by
                    partition key): rows routed by key hash, each rank
                    computes complete groups or partitions, then the front
                    (ORDER BY / projection / OFFSET / LIMIT) merges the
                    gathered results

The reference runs `run(plan, table)` once, from one controller. Here every
rank calls it with the same arguments and every rank returns the same
result chunk (the reference's replicated `out_specs=P()`). So every host
decision (join order, broadcast or partitioned, dense or general GROUP BY,
capacities) is made from data every rank holds: the plan, the chunk list
the table was made from, the foreign chunks (each rank is given all of
them), and the transfer matrices that one all_gather puts on every rank.
A decision taken from one rank's shard alone would let the ranks diverge
and their collectives hang.

An exchange is, in torch's idiom (`parallel/shuffle.py`): the (n,) send
counts of every rank, all_gathered into the (n_src, n_dst) matrix; one
host read of that matrix (the reference's "the quota is a host decision");
then one `all_to_all_single` per plane with exact split sizes. The rows a
rank receives lie source-major, as the reference's `prefix[dst, src]`
layout puts them, so a stable local sort gives the reference's order among
equal keys. The reference's fixed quota blocks and multi-round drain exist
for XLA's static shapes and have no counterpart.

Capacities stay equal on every rank at every stage (the shard capacity,
then the exchange's `pad_capacity` of the largest receive, then the join's
of the largest output), so that every rank binds the same programs and the
all_gathers see equal shapes. Key routing uses the reference's hash, so
that each key goes to the rank it goes to in the reference.

`host_sync_count()` counts the device → host reads of these paths (each
through `_host`): the gather merge costs one (the result's row count), a
shuffled GROUP BY two (the transfer matrix and the result), a partitioned
join two per join (its transfer matrices, then its output totals), and a
broadcast join's first run one more (the foreign keys' uniqueness check,
memoized per foreign chunk; the reference reads it too but does not count
it). The engine's own reads inside a shard's query (the radix sort's
histograms, the top-k's tie check) are not mesh reads and are not counted,
as the reference's XLA programs have none.

The paths above are the stitched rungs of `coordinate_distributed`, the
degradation ladder: the whole-plan rung (parallel/whole_plan.py: one
mesh-layer host read per query), then the stitched shuffle, then the
gather merge, then the host coordinator (query/coordinator.py) over the
shards on each rank. The stitched rungs publish the whole-plan rung's
mesh telemetry block from host values they already read
(`_stitched_mesh_block`, path "stitched"). Two fault sites guard the
collectives: `parallel.all_to_all` (every exchange) and `parallel.gather`
(every all_gather merge), hit on every rank before the step's first
collective.

Not applicable, since nothing here is compiled: the SPMD compile ladder
(`_dispatch_spmd`, `_compile_spmd`, `_observe_compiled`), the AOT disk tier,
buffer donation, program caches keyed on plan fingerprints.
"""

from __future__ import annotations

import logging
import weakref
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import (
    Column,
    ColumnarChunk,
    pad_capacity,
    remap_dictionary,
    unified_vocabulary,
)
from ytsaurus_tpu_torch.config import compile_config
from ytsaurus_tpu_torch.device import same_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.parallel.mesh import Mesh
from ytsaurus_tpu_torch.parallel.mesh_observatory import (
    exchange_entry,
    mesh_armed,
    mesh_block,
    publish_mesh,
    row_bytes,
)
from ytsaurus_tpu_torch.query import ir, planner
from ytsaurus_tpu_torch.query.coordinator import (
    coordinate_and_execute,
    split_plan,
)
from ytsaurus_tpu_torch.query.engine.expr import (
    _HASH_SEED,
    BindContext,
    ColumnBinding,
    EmitContext,
    ExprBinder,
    _combine_u64,
    _lshr,
    _mix_u64,
    bindings_to_device,
)
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
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
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.logging import get_logger, log_event
from ytsaurus_tpu_torch.utils.tracing import child_span

_ladder_log = get_logger("Distributed")


def _exchange_error(site: str) -> YtError:
    return YtError(f"injected collective failure at {site}",
                   code=EErrorCode.QueryExecutionError,
                   attributes={"failpoint": site})


# Collective fault sites: all_to_all guards every exchange, gather every
# all_gather merge. The degradation ladder steps down a rung when one
# fails.
_FP_ALL_TO_ALL = failpoints.register_site("parallel.all_to_all",
                                          error=_exchange_error)
_FP_GATHER = failpoints.register_site("parallel.gather",
                                      error=_exchange_error)

_host_syncs_n = 0


def _note_host_sync() -> None:
    global _host_syncs_n
    _host_syncs_n += 1


def host_sync_count() -> int:
    """Device → host reads the mesh paths made in this process so far."""
    return _host_syncs_n


def _host(t: torch.Tensor) -> np.ndarray:
    """One counted device → host read."""
    _note_host_sync()
    return t.cpu().numpy()


@dataclass
class _RepColumn:
    """Vocabulary/type carrier used to bind plans without device planes."""
    type: EValueType
    dictionary: Optional[np.ndarray]


@dataclass
class _RepChunk:
    capacity: int
    columns: dict
    device: torch.device


def _rep(columns: dict) -> dict:
    return {name: _RepColumn(type=c.type, dictionary=c.dictionary)
            for name, c in columns.items()}


class ShardedTable:
    """A table partitioned across a mesh: this rank's shard.

    All shards share one schema, one capacity and ONE unified string
    vocabulary per column, so dictionary codes agree across ranks.
    `columns` and `row_valid` hold this rank's (capacity,) planes on the
    mesh's device; `row_counts` holds every shard's row count.
    """

    def __init__(self, schema: TableSchema, mesh: Mesh, capacity: int,
                 columns: dict[str, Column], row_counts: list[int],
                 row_valid: torch.Tensor):
        self.schema = schema
        self.mesh = mesh
        self.capacity = capacity            # per shard
        self.columns = columns              # this rank's planes
        self.row_counts = row_counts
        self.row_valid = row_valid

    @property
    def n_shards(self) -> int:
        return len(self.row_counts)

    @property
    def total_rows(self) -> int:
        return sum(self.row_counts)

    @property
    def row_count(self) -> int:
        """This rank's row count."""
        return self.row_counts[self.mesh.rank]

    @staticmethod
    def from_chunks(mesh: Mesh, chunks: Sequence[ColumnarChunk]
                    ) -> "ShardedTable":
        """Every rank passes the same list, one chunk per shard (on any
        device). Only `chunks[mesh.rank]`'s planes are read, and moved to
        the mesh's device; of the others, the schema, capacity, row count
        and vocabularies."""
        n = mesh.size
        if len(chunks) != n:
            raise YtError(f"Need exactly {n} shards for this mesh, "
                          f"got {len(chunks)}",
                          code=EErrorCode.QueryExecutionError)
        schema = chunks[0].schema
        for c in chunks[1:]:
            if c.schema != schema:
                raise YtError("Shard schema mismatch",
                              code=EErrorCode.QueryExecutionError)
        cap = max(c.capacity for c in chunks)
        mine = chunks[mesh.rank]
        mine = ColumnarChunk(
            schema=schema, row_count=mine.row_count,
            columns={name: dc_replace(col, data=col.data.to(mesh.device),
                                      valid=col.valid.to(mesh.device))
                     for name, col in mine.columns.items()}
        ).with_capacity(cap)
        columns: dict[str, Column] = {}
        for col_schema in schema:
            col = mine.column(col_schema.name)
            if col_schema.type is EValueType.string:
                vocab = unified_vocabulary(
                    [c.column(col_schema.name) for c in chunks])
                col = remap_dictionary(col, vocab)
            columns[col_schema.name] = col
        return ShardedTable(
            schema=schema, mesh=mesh, capacity=cap, columns=columns,
            row_counts=[c.row_count for c in chunks],
            row_valid=torch.arange(cap, device=mesh.device) < mine.row_count)

    def local_chunk(self) -> ColumnarChunk:
        """This rank's shard as a chunk."""
        return ColumnarChunk(schema=self.schema, row_count=self.row_count,
                             columns=dict(self.columns))


def _assemble_chunk(prepared_output, out_planes, out_count) -> ColumnarChunk:
    """Materialize prepared-query output planes into a ColumnarChunk.
    `out_count` is the row count already on the host (an int), or a device
    count read here (one counted host read)."""
    out_columns: dict[str, Column] = {}
    out_schema_cols = []
    for out_col, (data, valid) in zip(prepared_output, out_planes):
        out_schema_cols.append((out_col.name, out_col.type.value))
        out_columns[out_col.name] = Column(
            type=out_col.type, data=data, valid=valid,
            dictionary=out_col.vocab)
    return ColumnarChunk(schema=TableSchema.make(out_schema_cols),
                         row_count=out_count if isinstance(out_count, int)
                         else int(_host(out_count)),
                         columns=out_columns)


def _canonical_hash_plane(data: torch.Tensor) -> torch.Tensor:
    """Canonicalize values before hashing for routing: -0.0 and +0.0
    compare equal but differ by bit pattern, so without this two rows
    that MATCH under the join/group comparison could land on different
    ranks and never meet."""
    if data.is_floating_point():
        return torch.where(data == 0, torch.zeros_like(data), data)
    return data


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """x mod n, x an int64 plane of uint64 bit patterns, 0 < n < 2^62."""
    return ((_lshr(x, 1) % n) * 2 + (x & 1)) % n


def _key_hash(keys, capacity: int, device: torch.device) -> torch.Tensor:
    """The reference's routing hash of (data, valid) key planes: each key's
    64-bit mix (0 for a null), folded from the seed."""
    acc = torch.full((capacity,), _HASH_SEED, dtype=torch.int64,
                     device=device)
    for data, valid in keys:
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        h = _mix_u64(_canonical_hash_plane(data.expand(capacity)))
        h = torch.where(valid.expand(capacity) > 0, h, torch.zeros_like(h))
        acc = _combine_u64(acc, h)
    return acc


@dataclass
class _JoinSetup:
    """A broadcast-join plan: each join's sorted foreign keys and pulled
    planes (whole, on every rank) and the per-shard probe step."""
    apply: Callable          # (columns, mask) -> (columns, mask)
    rep_columns: dict        # joined-namespace _RepColumns for prepare()


def _chunk_memo(cache: dict, key: tuple, chunk, build):
    """id()-keyed per-chunk memo with a weakref liveness guard and
    finalizer eviction: a recycled object id can never serve a DEAD
    chunk's planes, and a dead chunk's device buffers do not outlive it
    in the cache."""
    entry = cache.get(key)
    if entry is not None and entry[0]() is chunk:
        return entry[1]
    value = build()
    cache[key] = (weakref.ref(chunk), value)
    weakref.finalize(chunk, cache.pop, key, None)
    return value


def _foreign_host_order(cache: dict, join: ir.JoinClause, foreign,
                        self_bound, f_bound, foreign_slots, bindings):
    """Sort the foreign keys once, verify uniqueness, memoize per (join
    shape, foreign chunk identity, vocab identities). Returns (f_order,
    f_sorted, unique)."""
    device = foreign.device
    f_ctx = EmitContext(columns={
        name: (foreign.columns[name].data, foreign.columns[name].valid)
        for name in foreign.schema.column_names},
        bindings=bindings_to_device(bindings, device),
        capacity=foreign.capacity, device=device)
    n_foreign = foreign.row_count
    # The value-carrying fingerprint: this memo holds computed key planes,
    # so literals in the equations must distinguish. Remapped codes
    # depend on both sides' vocabularies: key on their identities.
    host_key = ("join-host", ir.fingerprint(ir.Query(
        schema=join.foreign_schema, source=join.foreign_table,
        joins=(join,))), id(foreign), foreign.capacity, n_foreign,
        tuple(id(b.vocab) if b.vocab is not None else None
              for b in list(self_bound) + list(f_bound)))

    def build():
        f_keys = _emit_encoded_keys(f_bound, foreign_slots, f_ctx)
        f_order, f_sorted = sort_foreign_keys(
            f_keys, foreign.row_valid,
            [b.type is EValueType.uint64 for b in f_bound])
        # Unique-key check over adjacent sorted pairs. Null-keyed rows
        # match nothing, so duplicates among them are fine.
        live = torch.arange(foreign.capacity, device=device) < n_foreign - 1
        same = torch.ones(foreign.capacity, dtype=torch.bool, device=device)
        non_null = torch.ones_like(same)
        for v, d in f_sorted:
            same = same & (v == torch.roll(v, -1)) & (d == torch.roll(d, -1))
            non_null = non_null & (v > 0)
        unique = not bool(_host((same & live & non_null).any()))
        return f_order, f_sorted, unique

    return _chunk_memo(cache, host_key, foreign, build)


def _stitched_mesh_block(stats, plan: ir.Query, n: int, in_rows, out_rows,
                         exchanges, stages=None) -> None:
    """The stitched rungs' mesh telemetry: the whole-plan rung's block
    shape, assembled from host values these rungs already read (no extra
    device read), published to the same surfaces with path "stitched".
    The stitched exchange moves exact splits, so each cell is granted
    exactly its rows: its entries report the demand as the quota."""
    if not mesh_armed():
        return
    publish_mesh(stats, plan_fingerprint(plan),
                 mesh_block(n, in_rows, out_rows, exchanges, stages=stages,
                            path="stitched"))


class DistributedEvaluator:
    """Runs plans over a ShardedTable on every rank of its mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._cache: dict = {}
        # Settled exchange quotas per whole-plan shape (whole_plan.py).
        self._quota_memo: dict = {}

    def _check_device(self, chunk: ColumnarChunk) -> None:
        if chunk.columns and not same_device(chunk.device, self.mesh.device):
            raise YtError(f"Chunk lies on {chunk.device}, the mesh runs on "
                          f"{self.mesh.device}",
                          code=EErrorCode.QueryExecutionError)

    def run(self, plan: ir.Query, table: ShardedTable,
            foreign_chunks: Optional[dict] = None,
            shuffle: Optional[bool] = None, stats=None) -> ColumnarChunk:
        """Execute a plan on every rank; every rank gets the same result.
        `shuffle=True` takes the exchange path for GROUP BY (ref
        CoordinateAndExecuteWithShuffle, engine_api/coordinator.h:92):
        rows move to hash(key)-owned ranks and each rank computes its
        COMPLETE groups. Default: the gather merge.

        Joined plans run one of two ways:
        - broadcast join (unique foreign keys, the lookup shape, e.g.
          TPC-H Q3): each foreign chunk is key-sorted once and probed per
          shard with a vectorized lexicographic binary search;
        - partitioned hash join (non-unique keys, or shuffle=True): BOTH
          sides are routed by join-key hash over one exchange so equal
          keys co-locate, then each rank joins locally with match
          expansion.
        String keys work on both paths via merged vocabularies. Each rank
        passes every foreign chunk whole, on the mesh's device. `stats`
        (query/statistics.QueryStatistics) receives the mesh telemetry
        block."""
        foreign_chunks = foreign_chunks or {}
        for chunk in foreign_chunks.values():
            self._check_device(chunk)
        join_setup = None
        if plan.joins:
            # Cost-based order from the foreign chunks' statistics and
            # the table's total rows: the same on every rank.
            plan, _ = planner.reorder_for_chunks(plan, table.total_rows,
                                                 foreign_chunks)
            join_setup = None if shuffle else self._prepare_joins(
                plan, table, foreign_chunks)
            if join_setup is None:
                return self._run_partitioned(plan, table, foreign_chunks,
                                             bool(shuffle), stats=stats)
        columns = {name: (col.data, col.valid)
                   for name, col in table.columns.items()}
        if plan.window is not None and plan.window.partition_items and \
                shuffle is not False and join_setup is None:
            # Co-partition by the PARTITION BY key (default path): each
            # rank then owns COMPLETE partitions and computes exact
            # windows locally. shuffle=False forces the gather merge (the
            # front recomputes the window over the gathered rows).
            return self._finish_shuffled(plan, columns, table.row_valid,
                                         _rep(table.columns), table.capacity,
                                         stats, list(table.row_counts))
        if shuffle and plan.group is not None and not plan.group.totals:
            return self._finish_shuffled(plan, columns, table.row_valid,
                                         _rep(table.columns), table.capacity,
                                         stats, list(table.row_counts))
        rep_columns = _rep(table.columns) if join_setup is None \
            else join_setup.rep_columns
        return self._finish_gather(plan, columns, table.row_valid,
                                   rep_columns, table.capacity,
                                   join_setup=join_setup, stats=stats,
                                   in_rows=list(table.row_counts))

    def _gather(self, output, planes, count):
        """Every rank's compacted rows: the planes all_gathered into
        (n * cap) rows, rank-major, and the mask of the live ones."""
        mesh = self.mesh
        with record_function("mesh.gather"):
            cap = planes[0][0].shape[0]
            counts = mesh.all_gather(count.reshape(1).to(torch.int64))
            iota = torch.arange(cap, device=mesh.device)
            g_mask = (iota[None, :] < counts[:, None]).reshape(-1)
            gathered = {out_col.name: (mesh.all_gather(d), mesh.all_gather(v))
                        for out_col, (d, v) in zip(output, planes)}
        return gathered, g_mask, mesh.size * cap

    def _finish_gather(self, plan: ir.Query, columns: dict, row_valid,
                       rep_columns: dict, cap: int,
                       join_setup: Optional[_JoinSetup] = None,
                       stats=None, in_rows=None) -> ColumnarChunk:
        """Bottom per shard + all_gather front merge over bare planes —
        run()'s tail for both the no-join and broadcast-join shapes, and
        after a partitioned join has replaced the table planes. With
        join_setup, the broadcast probe runs ahead of the bottom query.
        Its telemetry block has the shards' input rows as both spreads
        (the rung's only per-shard cardinality the host holds)."""
        _FP_GATHER.hit()
        device = self.mesh.device
        bottom, front = split_plan(plan)
        prepared_b = prepare(bottom, _RepChunk(capacity=cap,
                                               columns=dict(rep_columns),
                                               device=device))
        if join_setup is not None:
            columns, row_valid = join_setup.apply(columns, row_valid)
        planes, count = prepared_b.run(
            {c.name: columns[c.name] for c in bottom.schema
             if c.name in columns}, row_valid)
        gathered, g_mask, g_cap = self._gather(prepared_b.output, planes,
                                               count)
        prepared_f = prepare(front, _RepChunk(
            capacity=g_cap, columns={c.name: _RepColumn(c.type, c.vocab)
                                     for c in prepared_b.output},
            device=device))
        out_planes, out_count = prepared_f.run(gathered, g_mask)
        out = _assemble_chunk(prepared_f.output, out_planes, out_count)
        if in_rows is not None:
            _stitched_mesh_block(stats, plan, self.mesh.size, in_rows,
                                 in_rows, [])
        return out

    def _run_partitioned(self, plan: ir.Query, table: ShardedTable,
                         foreign_chunks: dict, shuffle: bool, stats=None
                         ) -> ColumnarChunk:
        """Partitioned hash join: route BOTH sides of each join by
        join-key hash over one exchange so equal keys co-locate, then
        join locally per rank with match expansion — the general
        fact-to-fact shape (non-unique foreign keys), composing with the
        shuffled GROUP BY. Ref: engine_api/coordinator.h:92-97.

        Per join: each rank takes its 1/n slice of the foreign chunk; one
        transfer-matrix read sizes both exchanges; the local probe finds
        each self row's match range; one read of every rank's match total
        sizes the expansion."""
        from ytsaurus_tpu_torch.parallel.shuffle import (
            route_rows,
            transfer_counts,
        )
        _FP_ALL_TO_ALL.hit()
        mesh = self.mesh
        n, me, device = mesh.size, mesh.rank, mesh.device
        cur_cap = table.capacity
        mesh_exchanges: list = []
        mesh_stages: list = []
        mesh_out_rows = list(table.row_counts)
        columns = {name: (col.data, col.valid)
                   for name, col in table.columns.items()}
        # Only planes the plan reads ride the exchange.
        needed = ir.referenced_columns(plan)
        if needed is not None:
            columns = {name: planes for name, planes in columns.items()
                       if name in needed}
        row_valid = table.row_valid
        namespace = {name: ColumnBinding(type=col.type, vocab=col.dictionary)
                     for name, col in table.columns.items()}
        rep_columns = _rep(table.columns)

        for join_index, join in enumerate(plan.joins):
            foreign = foreign_chunks.get(join.foreign_table)
            if foreign is None:
                raise YtError(
                    f"No data provided for join table "
                    f"{join.foreign_table!r}",
                    code=EErrorCode.QueryExecutionError)
            bindings: list = []
            binder = ExprBinder(BindContext(columns=dict(namespace),
                                            bindings=bindings))
            self_bound = [binder.bind(e) for e in join.self_equations]
            f_bound = _bind_keys(foreign, join.foreign_schema,
                                 join.foreign_equations, bindings)
            self_slots, foreign_slots = vocab_remap_slots(
                self_bound, f_bound, bindings)
            bnd = bindings_to_device(bindings, device)
            is_left = join.is_left

            flat_names = [
                (f"{join.alias}.{f}" if join.alias else f, f)
                for f in join.foreign_columns]
            if needed is not None:
                flat_names = [(flat, f) for flat, f in flat_names
                              if flat in needed]
            # This rank's 1/n slice of the foreign chunk: the planes of
            # the key expressions' sources and the pulled columns.
            f_count = foreign.row_count
            f_slice = pad_capacity(max(-(-f_count // n), 1))
            f_lo = min(me * f_slice, f_count)
            f_hi = min(f_lo + f_slice, f_count)
            f_refs: set = set()
            for eq in join.foreign_equations:
                f_refs.update(ir.expr_references(eq))
            f_cols = {}
            for fname in sorted(f_refs | {f for _, f in flat_names}):
                fcol = foreign.columns[fname]
                f_cols[fname] = (_rows_padded(fcol.data, f_lo, f_hi, f_slice),
                                 _rows_padded(fcol.valid, f_lo, f_hi,
                                              f_slice))
            f_valid = torch.arange(f_slice, device=device) < f_hi - f_lo

            def keys(bound, slots, cols, capacity):
                return _emit_encoded_keys(bound, slots, EmitContext(
                    columns=cols, bindings=bnd, capacity=capacity,
                    device=device))

            def dest(enc_keys, mask, keep_null_local: bool):
                """Destination rank by key hash; null-keyed live rows stay
                local for LEFT joins (they must still emit an unmatched
                output row) and are discarded otherwise."""
                capacity = mask.shape[0]
                pid = _umod(_key_hash([(d, v) for v, d in enc_keys],
                                      capacity, device), n)
                null = null_key_mask(enc_keys)
                pid = torch.where(null, me if keep_null_local else n, pid)
                return torch.where(mask, pid, n)

            with record_function("mesh.count"):
                pid_s = dest(keys(self_bound, self_slots, columns, cur_cap),
                             row_valid, is_left)
                pid_f = dest(keys(f_bound, foreign_slots, f_cols, f_slice),
                             f_valid, False)
                counts_s, counts_f = transfer_counts(mesh, pid_s, pid_f)
            for side, counts, reps in (
                    ("self", counts_s, {name: rep_columns[name]
                                        for name in columns}),
                    ("foreign", counts_f, _rep({
                        name: foreign.columns[name] for name in f_cols}))):
                demand = int(counts.max())
                mesh_exchanges.append(exchange_entry(
                    f"join[{join_index}]/{side}", None, demand, demand,
                    row_bytes(reps)))
            recv_s, mask_s = route_rows(mesh, columns, pid_s, counts_s)
            recv_f, mask_f = route_rows(mesh, f_cols, pid_f, counts_f)
            del pid_s, pid_f, f_cols
            s_cap, f_cap = mask_s.shape[0], mask_f.shape[0]
            n_f = int(counts_f[:, me].sum())
            with record_function("mesh.join"):
                s_keys = keys(self_bound, self_slots, recv_s, s_cap)
                f_keys = keys(f_bound, foreign_slots, recv_f, f_cap)
                f_order, f_sorted = sort_foreign_keys(
                    f_keys, mask_f,
                    [b.type is EValueType.uint64 for b in f_bound])
                s_cmp, f_cmp = _comparable_keys(s_keys, f_sorted,
                                                self_bound, f_bound)
                lo = _lex_searchsorted(f_cmp, n_f, f_cap, s_cmp, "left")
                hi = _lex_searchsorted(f_cmp, n_f, f_cap, s_cmp, "right")
                counts = torch.where(mask_s & ~null_key_mask(s_keys),
                                     hi - lo, torch.zeros_like(lo))
                per_row = torch.where(mask_s, counts.clamp(min=1),
                                      torch.zeros_like(counts)) \
                    if is_left else counts
                offsets = torch.cumsum(per_row, 0)
                totals = _host(mesh.all_gather(offsets[-1:]))
                out_cap = pad_capacity(max(int(totals.max()), 1))
                mesh_out_rows = [int(t) for t in totals.reshape(-1)]
                mesh_stages.append({
                    "stage": join_index, "table": join.foreign_table,
                    "strategy": "partition", "est_rows": 0,
                    "actual_rows": int(totals.sum()), "drift": 0.0})
                columns, row_valid = _expand(
                    recv_s, recv_f, flat_names, per_row, offsets,
                    int(totals[me]), out_cap, lo, counts, f_order)
            cur_cap = out_cap
            for flat, fname in flat_names:
                fcol = foreign.columns[fname]
                namespace[flat] = ColumnBinding(type=fcol.type,
                                                vocab=fcol.dictionary)
                rep_columns[flat] = _RepColumn(type=fcol.type,
                                               dictionary=fcol.dictionary)

        _stitched_mesh_block(stats, plan, n, list(table.row_counts),
                             mesh_out_rows, mesh_exchanges,
                             stages=mesh_stages)
        plan_nojoin = dc_replace(plan, joins=())
        if needed is not None:
            # The finish stages bind every schema column; drop the ones
            # pruned out of the exchange so the namespaces agree.
            plan_nojoin = dc_replace(plan_nojoin, schema=TableSchema(
                columns=tuple(c for c in plan.schema if c.name in needed)))
        if plan_nojoin.window is not None and \
                plan_nojoin.window.partition_items and shuffle:
            return self._finish_shuffled(plan_nojoin, columns, row_valid,
                                         rep_columns, cur_cap, stats,
                                         mesh_out_rows)
        if shuffle and plan.group is not None and not plan.group.totals:
            return self._finish_shuffled(plan_nojoin, columns, row_valid,
                                         rep_columns, cur_cap, stats,
                                         mesh_out_rows)
        return self._finish_gather(plan_nojoin, columns, row_valid,
                                   rep_columns, cur_cap, stats=stats,
                                   in_rows=mesh_out_rows)

    def _finish_shuffled(self, plan: ir.Query, columns: dict, row_valid,
                         rep_columns: dict, cap: int, stats=None,
                         in_rows=None) -> ColumnarChunk:
        """Key-hash exchange finish, shared by two stage shapes:

        - GROUP BY (route by group key): every rank owns complete groups,
          so group + having run fully local;
        - window stage (route by PARTITION BY key): every rank owns
          complete partitions, so the window stage is exact per rank.

        Only order/project/offset/limit merge at the front. Operates on
        bare planes so it also finishes partitioned-join outputs. Its
        telemetry block carries the transfer matrix the exchange read."""
        from ytsaurus_tpu_torch.parallel.shuffle import (
            route_rows,
            transfer_counts,
        )
        _FP_ALL_TO_ALL.hit()
        mesh = self.mesh
        n, device = mesh.size, mesh.device
        key_items = plan.window.partition_items if plan.window is not None \
            else plan.group.group_items
        bind_ctx = BindContext(columns={
            name: ColumnBinding(type=rc.type, vocab=rc.dictionary)
            for name, rc in rep_columns.items()})
        binder = ExprBinder(bind_ctx)
        where_b = binder.bind(plan.where) if plan.where is not None else None
        key_b = [binder.bind(item.expr) for item in key_items]
        bnd = bindings_to_device(bind_ctx.bindings, device)
        columns = {c.name: columns[c.name] for c in plan.schema
                   if c.name in columns}

        with record_function("mesh.count"):
            ctx = EmitContext(columns=columns, bindings=bnd, capacity=cap,
                              device=device)
            mask = row_valid
            if where_b is not None:
                d, v = where_b.emit(ctx)
                mask = mask & v & d.to(torch.bool)
            pid = _umod(_key_hash([kb.emit(ctx) for kb in key_b], cap,
                                  device), n)
            pid = torch.where(mask, pid, n)
            counts, = transfer_counts(mesh, pid)
        recv, recv_mask = route_rows(mesh, columns, pid, counts)
        del pid, mask, ctx

        local_plan = dc_replace(plan, order=None, project=None, offset=0,
                                limit=None)
        prepared_local = prepare(local_plan, _RepChunk(
            capacity=recv_mask.shape[0], columns=dict(rep_columns),
            device=device))
        planes, count = prepared_local.run(recv, recv_mask)
        del recv, recv_mask
        gathered, g_mask, g_cap = self._gather(prepared_local.output, planes,
                                               count)
        front = ir.FrontQuery(
            schema=local_plan.output_schema(), order=plan.order,
            project=plan.project, offset=plan.offset, limit=plan.limit)
        prepared_front = prepare(front, _RepChunk(
            capacity=g_cap, columns={c.name: _RepColumn(c.type, c.vocab)
                                     for c in prepared_local.output},
            device=device))
        out_planes, out_count = prepared_front.run(gathered, g_mask)
        out = _assemble_chunk(prepared_front.output, out_planes, out_count)
        demand = int(counts.max())
        entry = exchange_entry(
            "shuffle/stitched", counts.reshape(-1), demand, demand,
            row_bytes({name: rep_columns[name] for name in columns}))
        _stitched_mesh_block(
            stats, plan, n,
            in_rows if in_rows is not None
            else [int(r) for r in counts.sum(axis=1)],
            [int(r) for r in counts.sum(axis=0)], [entry])
        return out

    def _prepare_joins(self, plan: ir.Query, table: ShardedTable,
                       foreign_chunks: dict) -> Optional[_JoinSetup]:
        """Bind every join as a replicated lookup: sort the foreign side
        once, verify key uniqueness, and return the per-shard probe step.
        String keys ride merged vocabularies (both sides' codes remapped
        through binding tables). Returns None when any join's foreign
        keys are NOT unique — the caller takes the partitioned path."""
        device = self.mesh.device
        cap = table.capacity
        bindings: list = []
        namespace = {name: ColumnBinding(type=col.type, vocab=col.dictionary)
                     for name, col in table.columns.items()}
        rep_columns = _rep(table.columns)
        steps = []

        for join in plan.joins:
            foreign = foreign_chunks.get(join.foreign_table)
            if foreign is None:
                raise YtError(
                    f"No data provided for join table "
                    f"{join.foreign_table!r}",
                    code=EErrorCode.QueryExecutionError)
            binder = ExprBinder(BindContext(columns=dict(namespace),
                                            bindings=bindings))
            self_bound = [binder.bind(e) for e in join.self_equations]
            f_bound = _bind_keys(foreign, join.foreign_schema,
                                 join.foreign_equations, bindings)
            self_slots, foreign_slots = vocab_remap_slots(
                self_bound, f_bound, bindings)
            # Cached per (join shape, foreign chunk identity): repeated
            # queries against an unchanged dimension table neither re-sort
            # it nor re-read the uniqueness check.
            f_order, f_sorted, unique = _foreign_host_order(
                self._cache, join, foreign, self_bound, f_bound,
                foreign_slots, bindings)
            if not unique:
                return None     # fact-to-fact: the partitioned path
            pulled = []
            flat_names = []
            for fname in join.foreign_columns:
                fcol = foreign.columns[fname]
                flat = f"{join.alias}.{fname}" if join.alias else fname
                flat_names.append(flat)
                pulled.append((fcol.data[f_order], fcol.valid[f_order]))
                namespace[flat] = ColumnBinding(type=fcol.type,
                                                vocab=fcol.dictionary)
                rep_columns[flat] = _RepColumn(type=fcol.type,
                                               dictionary=fcol.dictionary)
            steps.append((self_bound, self_slots, f_bound, f_sorted, pulled,
                          flat_names, join.is_left, foreign.row_count,
                          foreign.capacity))

        def apply(columns, mask):
            bnd = bindings_to_device(bindings, device)
            for (self_bound, self_slots, f_bound, f_sorted, pulled,
                 flat_names, is_left, n_foreign, f_cap) in steps:
                with record_function("mesh.probe"):
                    ctx = EmitContext(columns=columns, bindings=bnd,
                                      capacity=cap, device=device)
                    self_keys = _emit_encoded_keys(self_bound, self_slots,
                                                   ctx)
                    s_cmp, f_cmp = _comparable_keys(self_keys, f_sorted,
                                                    self_bound, f_bound)
                    sl = [p for vd in f_cmp for p in vd] + \
                        [p for dv in pulled for p in dv] + [n_foreign]
                    planes, mask = probe_replicated(
                        sl, len(f_cmp), f_cap, s_cmp, mask, is_left)
                columns = dict(columns)
                for flat, plane in zip(flat_names, planes):
                    columns[flat] = plane
            return columns, mask

        return _JoinSetup(apply=apply, rep_columns=rep_columns)


def _rows_padded(plane: torch.Tensor, lo: int, hi: int,
                 capacity: int) -> torch.Tensor:
    """Rows [lo, hi) of a plane at the front of `capacity` zeroed rows."""
    out = torch.zeros((capacity,) + tuple(plane.shape[1:]), dtype=plane.dtype,
                      device=plane.device)
    out[:hi - lo] = plane[lo:hi]
    return out


def _expand(recv_s: dict, recv_f: dict, flat_names, per_row, offsets,
            total: int, out_cap: int, lo, counts, f_order):
    """The partitioned join's output planes: each output row's self row
    (by a search of the running match counts) and foreign row (its match
    range start plus its place in the range, through the foreign sort
    order), self-row-major."""
    device = per_row.device
    s_cap = per_row.shape[0]
    f_cap = f_order.shape[0]
    starts = offsets - per_row
    out_idx = torch.arange(out_cap, dtype=torch.int64, device=device)
    self_row = torch.searchsorted(offsets, out_idx, right=True
                                  ).clamp(0, s_cap - 1)
    within = out_idx - starts[self_row]
    matched = counts[self_row] > 0
    f_row = f_order[(lo[self_row] + within).clamp(0, f_cap - 1)]
    live = out_idx < total
    out = {name: (d[self_row], v[self_row] & live)
           for name, (d, v) in recv_s.items()}
    for flat, fname in flat_names:
        d, v = recv_f[fname]
        out[flat] = (d[f_row], v[f_row] & live & matched)
    return out, live


def _is_port_fault(err: BaseException) -> bool:
    """A fault no rung may hide: a kernel that did not build (`_build`
    raises InvalidConfig, as does a device that is absent) or did not
    launch (the `kernel` attribute of the wrappers' errors), or a CUDA
    error."""
    if isinstance(err, YtError):
        return err.code == EErrorCode.InvalidConfig or \
            "kernel" in err.attributes
    return isinstance(err, RuntimeError) and "CUDA" in str(err)


def _on_device(chunk: ColumnarChunk, device: torch.device) -> ColumnarChunk:
    if not chunk.columns or same_device(chunk.device, device):
        return chunk
    return ColumnarChunk(
        schema=chunk.schema, row_count=chunk.row_count,
        columns={name: dc_replace(col, data=col.data.to(device),
                                  valid=col.valid.to(device))
                 for name, col in chunk.columns.items()},
        sorted_by=chunk.sorted_by)


def coordinate_distributed(plan: ir.Query, mesh: Mesh,
                           chunks: Sequence,
                           foreign_chunks: Optional[dict] = None,
                           evaluator: Optional[DistributedEvaluator] = None,
                           stats=None) -> ColumnarChunk:
    """Distributed execution with a degradation ladder:

        whole-plan  →  stitched shuffle  →  gather merge  →  host
                                                              coordinator

    Every rank calls it with the same arguments (all the shards, each
    chunk on any device, and the foreign chunks on the mesh's device) and
    gets the same result. Each rung trades speed for fewer moving parts:
    the whole-plan rung (parallel/whole_plan.py, gated by `can_fuse` and
    `CompileConfig.whole_plan`) reads the host once; the stitched shuffle
    needs every exchange; the gather merge only the all_gather; the host
    coordinator no collective at all (each rank runs every shard on its
    own device, with the per-shard retry of query/coordinator.py). A fault
    on one rung degrades to the next, one span per rung (tagged with its
    `rung`); when every rung fails, the error aggregates theirs. A fault
    of the port itself (`_is_port_fault`: a kernel that did not build or
    launch, a CUDA error) is raised, never degraded. Ref: the coordinator
    falling back from CoordinateAndExecuteWithShuffle to
    CoordinateAndExecute (engine_api/coordinator.h:92)."""
    from ytsaurus_tpu_torch.parallel.whole_plan import can_fuse, run_whole_plan

    errors: "list[YtError]" = []
    de = evaluator if evaluator is not None else DistributedEvaluator(mesh)
    table = None
    if len(chunks) == mesh.size and all(not callable(c) for c in chunks):
        try:
            table = ShardedTable.from_chunks(mesh, list(chunks))
        except YtError:
            table = None        # ragged shards: the host rung takes them
    if table is not None:
        if compile_config().whole_plan and can_fuse(plan) is None:
            try:
                with child_span("distributed.whole_plan", rung=0,
                                shards=len(chunks)):
                    return run_whole_plan(de, plan, table, stats=stats,
                                          foreign_chunks=foreign_chunks)
            except Exception as err:   # noqa: BLE001 — the rung degrades
                # on any fault of its own (the reference's contract), but
                # not on one of the port's kernels or of the card.
                if _is_port_fault(err):
                    raise
                if not isinstance(err, YtError):
                    err = YtError(f"whole-plan execution failed: {err!r}",
                                  code=EErrorCode.QueryExecutionError)
                errors.append(err)
                log_event(_ladder_log, logging.WARNING,
                          "degrade_to_stitched", error=str(err))
        shuffled_shape = (plan.group is not None and not plan.group.totals) \
            or (plan.window is not None and bool(plan.window.partition_items))
        if shuffled_shape and not plan.joins:
            try:
                with child_span("distributed.shuffle", rung=1,
                                shards=len(chunks)):
                    return de.run(plan, table, foreign_chunks,
                                  shuffle=True, stats=stats)
            except YtError as err:
                if _is_port_fault(err):
                    raise
                errors.append(err)
                log_event(_ladder_log, logging.WARNING,
                          "degrade_to_gather", error=str(err))
        try:
            with child_span("distributed.gather_merge", rung=2,
                            shards=len(chunks)):
                return de.run(plan, table, foreign_chunks, shuffle=False,
                              stats=stats)
        except YtError as err:
            if _is_port_fault(err):
                raise
            errors.append(err)
            log_event(_ladder_log, logging.WARNING,
                      "degrade_to_host", error=str(err))
    host_evaluator = Evaluator(mesh.device)
    shards = [c if callable(c) else
              (c if not c.columns or same_device(c.device,
                                                 host_evaluator.device)
               else (lambda c=c: _on_device(c, host_evaluator.device)))
              for c in chunks]
    try:
        with child_span("distributed.host_coordinate", rung=3,
                        shards=len(chunks)):
            return coordinate_and_execute(plan, shards, foreign_chunks,
                                          evaluator=host_evaluator,
                                          stats=stats)
    except YtError as err:
        if not errors or _is_port_fault(err):
            raise
        raise YtError(
            "distributed query failed on every rung of the degradation "
            "ladder", code=EErrorCode.QueryExecutionError,
            inner_errors=[*errors, err]) from err
