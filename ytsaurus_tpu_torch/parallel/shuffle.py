"""Distributed sort: range partition → all-to-all → per-rank sort, and the
row exchange of every mesh path.

Port of the JAX package's `parallel/shuffle.py`, a redesign of the
reference MapReduce Sort pipeline (sort_controller.cpp: TPartitionTask +
TSortTask; partition_job.cpp routing rows by partitioner and
partition_sort_job.cpp merging):

  reference                               this port
  ---------                               ---------
  samples_fetcher → partition key bounds  per-shard key samples, gathered
                                          to every rank → host pivots
  partition jobs route rows to chunks     `_partition_ids` on the device
  shuffle = readers pull blocks over TCP  one all_to_all_single per plane
  partition_sort heap merge per partition `sort_chunk` per rank (the radix
                                          kernels on the card)

The stitched exchange (`transfer_counts`, `route_rows`) moves rows of the
stitched mesh paths: every rank's (n,) send counts are all_gathered into
the (n_src, n_dst) transfer matrix, which is read to the host once, and
each plane then crosses in one `all_to_all_single` with exact split
sizes; the receive capacity is the `pad_capacity` of the largest column
sum. The whole-plan rung's exchange (`cell_counts`, `route_rows_quota`)
is the reference's static-quota form and reads nothing: each
destination's rows go into a fixed block of `quota` slots, rows past the
quota are dropped (the caller sees the overflow in the counts, on the
device), and each plane crosses in one `all_to_all_single` of n equal
blocks, padding included. In both, rows arrive source-major, each
source's in its local order, so a stable local sort gives the reference's
order among equal keys.

`_encode_key_plane`, `_lex_less_const`, `_partition_ids` and
`quantile_pivots` also serve the external sort (`ops/bigsort.py`).

uint64 key planes are int64 bit patterns in the port. `_encode_key_plane`
takes an `unsigned` flag and flips their sign bit, so that the signed
compares of `_lex_less_const` order them as the reference's uint64
compares do; `pivot_value_plane` encodes the pivots' values alike, from
numpy uint64 arrays, never through float64. Doubles compare by value on
both sides (NaN equal to nothing, -0.0 == +0.0), as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk, pad_capacity
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.parallel.distributed import ShardedTable, _host
from ytsaurus_tpu_torch.schema import EValueType

_SIGN64 = -(1 << 63)          # the int64 with only the sign bit set


def _encode_key_plane(data: torch.Tensor, valid: torch.Tensor,
                      unsigned: bool = False):
    """(null_rank, value) encoding: null sorts before any value. Invalid
    values are zeroed; `unsigned` marks an int64 plane of uint64 bit
    patterns, whose sign bit is flipped after the zeroing."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    value = torch.where(valid, data, torch.zeros_like(data))
    if unsigned:
        value = value ^ _SIGN64
    return valid.to(torch.int8), value


def pivot_value_plane(values: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """The pivots' values of one key column (a numpy array in the key
    plane's host dtype, np.uint64 for uint64) as a device plane that
    compares against `_encode_key_plane`'s value plane."""
    if values.dtype == np.uint64:
        return torch.from_numpy(values.view(np.int64) ^ np.int64(_SIGN64)
                                ).to(device)
    if values.dtype == np.bool_:
        values = values.astype(np.int8)
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def _lex_less_const(row_planes, pivot_planes, pivot_idx, or_equal: bool):
    """Lexicographic row < pivots[pivot_idx] over encoded planes.

    row_planes: [(v, d)] each (cap,); pivot_planes: [(v, d)] each (n_piv,).
    """
    shape = row_planes[0][0].shape
    device = row_planes[0][0].device
    result = torch.full(shape, or_equal, dtype=torch.bool, device=device)
    for (rv, rd), (pv, pd) in reversed(list(zip(row_planes, pivot_planes))):
        p_v, p_d = pv[pivot_idx], pd[pivot_idx]
        lt = (rv < p_v) | ((rv == p_v) & (rd < p_d))
        eq = (rv == p_v) & (rd == p_d)
        result = lt | (eq & result)
    return result


def _partition_ids(row_planes, pivot_planes, n_pivots: int) -> torch.Tensor:
    """For each row, the number of pivots ≤ row (lexicographic) — i.e. its
    destination range in [0, n_pivots]. One pass over the rows per pivot
    (a Python loop, as in the reference)."""
    cap = row_planes[0][0].shape[0]
    pid = torch.zeros(cap, dtype=torch.int32, device=row_planes[0][0].device)
    for i in range(n_pivots):
        # row >= pivots[i]  ⇔  not (row < pivots[i])
        ge = ~_lex_less_const(row_planes, pivot_planes, i, or_equal=False)
        pid = pid + ge.to(torch.int32)
    return pid


def quantile_pivots(sample_rows: "list[tuple]", n: int,
                    key_arity: int) -> "list[tuple]":
    """n-1 quantile pivots from sampled (valid, value) key tuples; the
    shared samples→bounds step of every range-partition path (ref
    partitioning_parameters_evaluator.cpp). uint64 values are Python ints
    in [0, 2^64), as the reference's samples hold them, so that `sorted`
    orders them unsigned."""
    sample_rows = sorted(sample_rows)
    pivots = []
    for j in range(1, n):
        pivots.append(sample_rows[(j * len(sample_rows)) // n]
                      if sample_rows
                      else tuple((False, 0) for _ in range(key_arity)))
    return pivots


def cell_counts(pid: torch.Tensor, row_valid, n: int) -> torch.Tensor:
    """This rank's (n,) int64 row counts per destination (`pid` in
    [0, n) for rows that move; rows outside `row_valid`, when given, move
    nowhere), on the device (ref shuffle.py `transfer_counts`, the
    in-program form)."""
    if row_valid is not None:
        pid = torch.where(row_valid, pid, n)
    return torch.stack([(pid == dest).sum() for dest in range(n)]
                       ).to(torch.int64)


def _dest_slots(pid: torch.Tensor, starts: Sequence[int], dump: int,
                quota=None) -> torch.Tensor:
    """Each row's slot in a send buffer grouped by destination:
    `starts[dest]` plus the row's rank among the rows to that destination
    (a stable count, no sort); `dump` for discards (pid == n) and, given a
    `quota`, for rows past it."""
    slot = torch.full_like(pid, dump, dtype=torch.int64)
    for dest, start in enumerate(starts):
        hit = pid == dest
        rank = torch.cumsum(hit, 0) - 1
        if quota is not None:
            hit = hit & (rank < quota)
        slot = torch.where(hit, start + rank, slot)
    return slot


def transfer_counts(mesh, *pids: torch.Tensor) -> list[np.ndarray]:
    """The (n_src, n_dst) transfer matrix of each routing `pid` (in
    [0, n) for rows that move, n for discards), as every rank sees it:
    one all_gather of the stacked local counts and one host read for all
    of them."""
    n = mesh.size
    local = torch.cat([cell_counts(pid, None, n) for pid in pids])
    matrix = _host(mesh.all_gather(local)).reshape(n, len(pids), n)
    return [matrix[:, i, :] for i in range(len(pids))]


def _dest_order(pid: torch.Tensor, send: Sequence[int]) -> torch.Tensor:
    """The rows that move, grouped by destination, each group in row
    order: a stable counting sort by `pid` over the send counts (known on
    the host), with no device sort and no host read."""
    starts = np.concatenate([[0], np.cumsum(send)[:-1]]).tolist()
    total = int(sum(send))
    order = torch.empty(total + 1, dtype=torch.int64, device=pid.device)
    order.scatter_(0, _dest_slots(pid, starts, total),
                   torch.arange(pid.shape[0], device=pid.device))
    return order[:total]


def route_rows(mesh, planes: dict, pid: torch.Tensor, counts: np.ndarray
               ) -> tuple[dict, torch.Tensor]:
    """Send this rank's rows to their `pid` ranks (discards at n) and
    receive every rank's rows for this one, source-major, at the front of
    planes of the receive capacity (the same on every rank). `counts` is
    `transfer_counts`'s matrix for `pid`. Returns (received planes, the
    received-row mask)."""
    me = mesh.rank
    send = [int(c) for c in counts[me]]
    recv = [int(c) for c in counts[:, me]]
    cap = pad_capacity(max(int(counts.sum(axis=0).max()), 1))
    with record_function("mesh.route"):
        order = _dest_order(pid, send)
        out: dict = {}
        for name, (data, valid) in planes.items():
            r_data = torch.zeros((cap,) + tuple(data.shape[1:]),
                                 dtype=data.dtype, device=data.device)
            r_valid = torch.zeros(cap, dtype=torch.bool, device=data.device)
            mesh.all_to_all(data[order], send, recv, out=r_data)
            mesh.all_to_all(valid[order], send, recv, out=r_valid)
            out[name] = (r_data, r_valid)
    mask = torch.arange(cap, device=pid.device) < sum(recv)
    return out, mask


def route_rows_quota(mesh, planes: dict, pid: torch.Tensor, quota: int
                     ) -> tuple[dict, torch.Tensor]:
    """Send this rank's rows to their `pid` ranks (discards at n) in
    fixed blocks of `quota` rows, one `all_to_all_single` of n equal
    blocks per plane (ref shuffle.py `route_rows`). Rows past a
    destination's quota are dropped, never written past the block.
    Returns (received planes, the received-row mask), n * quota rows,
    source-major; vector planes keep their trailing dimension.

    One scatter of row indices fills the send order (every discard into
    one dump slot past the blocks); each plane is then a gather, zeroed
    in the slots no row filled."""
    n = mesh.size
    total = n * quota
    cap = pid.shape[0]
    split = [quota] * n
    with record_function("mesh.route"):
        src = torch.full((total + 1,), cap, dtype=torch.int64,
                         device=pid.device)
        src.scatter_(0, _dest_slots(pid, range(0, total, quota), total,
                                    quota),
                     torch.arange(cap, dtype=torch.int64, device=pid.device))
        src = src[:total]
        sent = src < cap
        src = src.clamp(max=cap - 1)
        recv_mask = mesh.all_to_all(sent, split, split)
        out: dict = {}
        for name, (data, valid) in planes.items():
            filled = sent.reshape((total,) + (1,) * (data.ndim - 1))
            buf = torch.where(filled, data[src],
                              torch.zeros((), dtype=data.dtype,
                                          device=data.device))
            r_data = mesh.all_to_all(buf, split, split)
            r_valid = mesh.all_to_all(valid[src] & sent, split, split)
            out[name] = (r_data, r_valid & recv_mask)
    return out, recv_mask


def _sample_pivots(table: ShardedTable, key_names: list[str],
                   samples_per_shard: int = 256) -> list[tuple]:
    """Evenly sample keys from every shard, gather the samples to every
    rank (one all_gather, one host read), take quantile pivots. Ref:
    ytlib/table_client/samples_fetcher.h + partitioning_parameters_
    evaluator.cpp."""
    mesh = table.mesh
    n = table.n_shards
    takes = [min(samples_per_shard, c) for c in table.row_counts]
    if not any(takes):
        return [tuple((False, 0) for _ in key_names) for _ in range(n - 1)]
    mine = takes[mesh.rank]
    idx = torch.from_numpy(np.linspace(
        0, table.row_count - 1, mine, dtype=np.int64)).to(mesh.device)
    # Every key's data and valid planes as int64 words (doubles by their
    # bits), padded to samples_per_shard rows: one gather for all.
    words = []
    for name in key_names:
        col = table.columns[name]
        data = col.data[idx]
        data = data.view(torch.int64) if data.dtype == torch.float64 \
            else data.to(torch.int64)
        words += [data, col.valid[idx].to(torch.int64)]
    local = torch.zeros((len(words), samples_per_shard), dtype=torch.int64,
                        device=mesh.device)
    local[:, :mine] = torch.stack(words)
    host = _host(mesh.all_gather(local.reshape(-1))).reshape(
        n, len(words), samples_per_shard)
    sample_rows: list[tuple] = []
    for shard, take in enumerate(takes):
        values = []
        for ki, name in enumerate(key_names):
            data = host[shard, 2 * ki, :take]
            ty = table.columns[name].type
            if ty is EValueType.double:
                data = data.view(np.float64)
            elif ty is EValueType.uint64:
                data = data.view(np.uint64)
            elif ty is EValueType.boolean:
                data = data.astype(np.bool_)
            values.append((data.tolist(),
                           host[shard, 2 * ki + 1, :take].astype(bool)))
        for i in range(take):
            sample_rows.append(tuple((bool(valid[i]), data[i])
                                     for data, valid in values))
    return quantile_pivots(sample_rows, n, len(key_names))


def sort_table(table: ShardedTable, key_columns: Sequence[str],
               descending: bool = False) -> ShardedTable:
    """Globally sort a ShardedTable by `key_columns` across the mesh.

    Result: shard i holds the i-th key range, sorted within the shard —
    i.e. globally sorted in shard-major order. Every rank calls it."""
    key_names = list(key_columns)
    for name in key_names:
        if name not in table.columns:
            raise YtError(f"No such key column {name!r}",
                          code=EErrorCode.QueryExecutionError)
    if table.n_shards == 1:
        return _sort_single(table, key_names, descending)
    return _sort_table_sharded(table, key_names, descending)


def _host_plane_dtype(col: Column):
    if col.type is EValueType.uint64:
        return np.uint64
    if col.type is EValueType.double:
        return np.float64
    if col.type is EValueType.boolean:
        return np.bool_
    return np.int64


def _sort_table_sharded(table: ShardedTable, key_names: "list[str]",
                        descending: bool) -> ShardedTable:
    mesh = table.mesh
    n = table.n_shards
    with record_function("sort.partition"):
        pivots = _sample_pivots(table, key_names)
        pivot_planes = []
        for ki, name in enumerate(key_names):
            col = table.columns[name]
            vals = np.array([p[ki][1] for p in pivots],
                            dtype=_host_plane_dtype(col))
            ranks = np.array([1 if p[ki][0] else 0 for p in pivots],
                             dtype=np.int8)
            pivot_planes.append((torch.from_numpy(ranks).to(mesh.device),
                                 pivot_value_plane(vals, mesh.device)))
        row_planes = [_encode_key_plane(
            table.columns[name].data, table.columns[name].valid,
            table.columns[name].type is EValueType.uint64)
            for name in key_names]
        pid = _partition_ids(row_planes, pivot_planes, n - 1)
        del row_planes
        if descending:
            pid = (n - 1) - pid                 # shard 0 takes the top range
        pid = torch.where(table.row_valid, pid, n)
        counts, = transfer_counts(mesh, pid)
    recv, mask = route_rows(mesh, {name: (col.data, col.valid)
                                   for name, col in table.columns.items()},
                            pid, counts)
    del pid
    received = ColumnarChunk(
        schema=table.schema, row_count=int(counts[:, mesh.rank].sum()),
        columns={name: Column(type=col.type, data=recv[name][0],
                              valid=recv[name][1],
                              dictionary=col.dictionary)
                 for name, col in table.columns.items()})
    del recv
    out = _sort_local(received, key_names, descending, mesh.device)
    return ShardedTable(schema=out.schema, mesh=mesh, capacity=out.capacity,
                        columns=dict(out.columns),
                        row_counts=[int(c) for c in counts.sum(axis=0)],
                        row_valid=mask)


def _sort_single(table: ShardedTable, key_names: list[str],
                 descending: bool = False) -> ShardedTable:
    """One-rank mesh: the local sort alone, same result contract."""
    out = _sort_local(table.local_chunk(), key_names, descending,
                      table.mesh.device)
    return ShardedTable(schema=out.schema, mesh=table.mesh,
                        capacity=table.capacity, columns=dict(out.columns),
                        row_counts=list(table.row_counts),
                        row_valid=table.row_valid)


def _sort_local(chunk: ColumnarChunk, key_names: list[str],
                descending: bool, device) -> ColumnarChunk:
    """The per-rank sort: `sort_chunk` (masked rows last, then the keys,
    stable), whose schema is the reference's `_sorted_schema`: the keys
    first, in sort order."""
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
    with record_function("sort.local"):
        return sort_chunk(chunk, key_names, descending, device=device)
