"""The mesh observatory: a bounded per-fingerprint roll-up of the mesh
telemetry blocks.

Own copy of the JAX package's `parallel/mesh_observatory.py` (it imports
no jax there either). Every whole-plan execution publishes one versioned
block (`mesh_block`: per-shard input and output rows, the all_to_all
transfer matrices, quota demand against the quota granted), and the
stitched rungs publish the same shape from host values they already read;
both build it here and hand it to `publish_mesh`. This module folds the
blocks into per-fingerprint roll-ups (`totals`, `top`, `snapshot`) and the
`/query/mesh` sensors, and counts each execution as balanced or skewed
against `TelemetryConfig.mesh_max_imbalance`, the events of
`MESH_SKEW_SLO`.

Not applicable, since nothing here is an XLA executable: the reference's
compile-time capture (`record_compile`, `memory_analysis_dict`,
`peak_bytes`). `memory_for` answers None, as the reference's does when a
backend reports no memory analysis, so no block carries a
`memory_watermark_bytes`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ytsaurus_tpu_torch.config import telemetry_config
from ytsaurus_tpu_torch.schema import EValueType
from ytsaurus_tpu_torch.utils import sanitizers, tracing
from ytsaurus_tpu_torch.utils.profiling import Profiler

# /query/mesh sensors: gauges track the last executed program's shape,
# counters accumulate exchange traffic and the balanced / skewed split.
_mesh_profiler = Profiler("/query/mesh")
_skew_gauge = _mesh_profiler.gauge("skew_max")
_headroom_gauge = _mesh_profiler.gauge("quota_headroom")
_watermark_gauge = _mesh_profiler.gauge("memory_watermark_bytes")
_exchange_bytes_counter = _mesh_profiler.counter("exchange_bytes")
_balanced_counter = _mesh_profiler.counter("balanced")
_skewed_counter = _mesh_profiler.counter("skewed")

# Skew burn-rate SLO: at least `objective` of mesh executions stay under
# TelemetryConfig.mesh_max_imbalance, over the balanced / skewed counters.
MESH_SKEW_SLO = {
    "kind": "ratio",
    "good_sensor": "/query/mesh/balanced",
    "bad_sensor": "/query/mesh/skewed",
    "objective": 0.99,
    "burn_threshold": 10.0,
}

_TOP_FIELDS = {
    "skew": "skew_max",
    "bytes": "exchange_bytes",
    "memory": "memory_watermark_bytes",
    "executions": "executions",
    "drift": "drift_max",
}


class MeshObservatory:
    """Bounded per-fingerprint roll-up of mesh telemetry blocks."""

    PROGRAM_CAP = 256       # distinct plan fingerprints retained
    COMPILED_CAP = 512      # the reference's per-executable capture bound

    def __init__(self):
        # guards: _programs, executions_n, balanced_n, skewed_n
        self._lock = sanitizers.register_lock(
            "mesh_observatory.MeshObservatory._lock")
        self._programs: "OrderedDict[str, dict]" = OrderedDict()
        self.executions_n = 0
        self.balanced_n = 0
        self.skewed_n = 0

    def memory_for(self, key) -> Optional[int]:
        """Peak device bytes of the program behind `key`: None, since no
        memory analysis exists for an eager program."""
        return None

    def record_execution(self, fingerprint: str, block: dict) -> None:
        """Fold one executed program's block (whole-plan or stitched) into
        the per-fingerprint roll-up and the /query/mesh sensors."""
        max_imbalance = telemetry_config().mesh_max_imbalance
        skew = float(block.get("skew", 1.0))
        xbytes = int(block.get("exchange_bytes", 0))
        headroom = max([float(e.get("headroom", 0.0))
                        for e in block.get("exchanges", ())] or [0.0])
        watermark = block.get("memory_watermark_bytes")
        drift = max([float(s.get("drift", 0.0))
                     for s in block.get("stages", ())] or [0.0])
        out_rows = block.get("out_rows") or ()
        skewed = int(block.get("shards", 1)) > 1 and sum(out_rows) > 0 \
            and skew > max_imbalance
        with self._lock:
            self.executions_n += 1
            if skewed:
                self.skewed_n += 1
            else:
                self.balanced_n += 1
            entry = self._programs.get(fingerprint)
            if entry is None:
                entry = self._programs[fingerprint] = {
                    "executions": 0, "skew_max": 0.0, "skew_last": 0.0,
                    "exchange_bytes": 0, "rows_out": 0,
                    "quota_headroom": 0.0, "drift_max": 0.0,
                    "memory_watermark_bytes": 0, "skewed": 0,
                    "path": block.get("path", "fused"),
                    "shards": int(block.get("shards", 0)),
                    "last_block": None,
                }
            self._programs.move_to_end(fingerprint)
            entry["executions"] += 1
            entry["skew_last"] = skew
            entry["skew_max"] = max(entry["skew_max"], skew)
            entry["exchange_bytes"] += xbytes
            entry["rows_out"] += int(sum(out_rows))
            entry["quota_headroom"] = headroom
            entry["drift_max"] = max(entry["drift_max"], drift)
            if watermark:
                entry["memory_watermark_bytes"] = max(
                    entry["memory_watermark_bytes"], int(watermark))
            if skewed:
                entry["skewed"] += 1
            entry["path"] = block.get("path", entry["path"])
            entry["last_block"] = block
            while len(self._programs) > self.PROGRAM_CAP:
                self._programs.popitem(last=False)
        _skew_gauge.set(skew)
        _headroom_gauge.set(headroom)
        if watermark:
            _watermark_gauge.set(int(watermark))
        if xbytes:
            _exchange_bytes_counter.increment(xbytes)
        if skewed:
            _skewed_counter.increment()
        else:
            _balanced_counter.increment()

    def totals(self) -> dict:
        with self._lock:
            return {"executions": self.executions_n,
                    "balanced": self.balanced_n,
                    "skewed": self.skewed_n,
                    "programs": len(self._programs),
                    "compiled": 0}

    def top(self, n: int = 20, by: str = "skew") -> list[dict]:
        """Programs ranked by `by` (skew | bytes | memory | executions |
        drift, or any numeric roll-up field)."""
        field = _TOP_FIELDS.get(by, by)
        with self._lock:
            rows = [{"fingerprint": fp,
                     **{k: v for k, v in entry.items()
                        if k != "last_block"}}
                    for fp, entry in self._programs.items()]
        rows.sort(key=lambda r: (-float(r.get(field) or 0.0),
                                 r["fingerprint"]))
        return rows[:n] if n else rows

    def snapshot(self, top: int = 50) -> dict:
        with self._lock:
            blocks = {fp: entry["last_block"]
                      for fp, entry in self._programs.items()
                      if entry["last_block"] is not None}
        return {"totals": self.totals(),
                "programs": self.top(top),
                "last_blocks": blocks,
                "slo": dict(MESH_SKEW_SLO)}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self.executions_n = 0
            self.balanced_n = 0
            self.skewed_n = 0


_mesh_observatory = MeshObservatory()


def get_mesh_observatory() -> MeshObservatory:
    return _mesh_observatory


# -- telemetry blocks ----------------------------------------------------------

# Layout version of the telemetry lanes and of the block; the lanes carry
# it first so that a decoder cannot misread a layout change.
MESH_TELEMETRY_VERSION = 1


def mesh_armed() -> bool:
    """Whether the telemetry lanes ride the read and a block is published
    (TelemetryConfig.mesh_telemetry)."""
    return bool(telemetry_config().mesh_telemetry)


def row_bytes(rep_columns) -> int:
    """Bytes per routed row, estimated on the host: each column's plane
    itemsize (strings as int32 codes, booleans 1 byte, else 8) plus 1 for
    its validity plane. An accounting estimate, never a capacity."""
    sizes = {EValueType.boolean: 1, EValueType.string: 4}
    return sum(sizes.get(rc.type, 8) + 1 for rc in rep_columns.values())


def exchange_entry(stage: str, matrix, demand: int, quota: int,
                   bytes_per_row: int) -> dict:
    """One exchange's telemetry: the flattened source-major n*n transfer
    matrix, rows and bytes moved, and quota demand against granted."""
    cells = [int(x) for x in matrix] if matrix is not None else None
    rows = sum(cells) if cells else 0
    return {"stage": stage, "matrix": cells, "rows": rows,
            "bytes": rows * int(bytes_per_row), "demand": int(demand),
            "quota": int(quota),
            "headroom": round(float(demand) / float(quota), 4)
            if quota else 0.0}


def mesh_block(n: int, in_rows, out_rows, exchanges, stages=None,
               path: str = "fused") -> dict:
    """The versioned per-query telemetry block, of the same shape on the
    whole-plan rung ("fused") and the stitched rungs ("stitched")."""
    out = [int(x) for x in out_rows]
    total = sum(out)
    mean = total / float(n) if n else 0.0
    skew = (max(out) / mean) if mean > 0 else 1.0
    block = {"version": MESH_TELEMETRY_VERSION, "path": path,
             "shards": int(n),
             "in_rows": [int(x) for x in in_rows],
             "out_rows": out,
             "skew": round(float(skew), 4),
             "exchange_bytes": int(sum(e["bytes"] for e in exchanges)),
             "exchanges": list(exchanges)}
    if stages:
        block["stages"] = list(stages)
    return block


def publish_mesh(stats, fingerprint: str, block: dict) -> None:
    """Fan one decoded block out to the query's statistics, the mesh
    observatory (and its /query/mesh sensors) and the ambient trace span.
    Host bookkeeping over values already read: no device read."""
    if stats is not None:
        stats.note_mesh_block(block)
    _mesh_observatory.record_execution(fingerprint, block)
    span = tracing.current_trace()
    if span is not None and span.sampled:
        out_rows = block.get("out_rows") or []
        span.add_tag("mesh_skew", block.get("skew"))
        span.add_tag("mesh_exchange_bytes", block.get("exchange_bytes", 0))
        if out_rows:
            hot = int(max(range(len(out_rows)), key=out_rows.__getitem__))
            span.add_tag("mesh_hot_shard", hot)
            span.add_tag("mesh_hot_shard_rows", int(out_rows[hot]))
