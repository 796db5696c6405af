"""Shard pruning: WHERE-derived column intervals vs chunk statistics.

Analog of the reference's range inference (library/query/base/key_trie.h +
CreateNewRangeInferrer): instead of building key ranges for tablet
coordination, the coordinator here prunes whole shards (chunks/tablets)
whose per-column min/max statistics cannot intersect the predicate.
Conservative: only top-level AND conjunctions of `col OP literal`,
BETWEEN and IN contribute; everything else keeps the shard.

Own copy of the JAX package's `query/pruning.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ytsaurus_tpu_torch.query import ir

_NEG_INF = object()
_POS_INF = object()


@dataclass
class Interval:
    lo: object = _NEG_INF
    hi: object = _POS_INF
    lo_incl: bool = True
    hi_incl: bool = True

    def intersect_point_set(self, values) -> "Interval":
        # IN (...) → widen to [min, max] of the set (conservative).
        lo = min(values)
        hi = max(values)
        return self.narrow(Interval(lo=lo, hi=hi))

    def narrow(self, other: "Interval") -> "Interval":
        lo, lo_incl = self.lo, self.lo_incl
        if other.lo is not _NEG_INF and (
                lo is _NEG_INF or _cmp(other.lo, lo) > 0 or
                (_cmp(other.lo, lo) == 0 and not other.lo_incl)):
            lo, lo_incl = other.lo, other.lo_incl
        hi, hi_incl = self.hi, self.hi_incl
        if other.hi is not _POS_INF and (
                hi is _POS_INF or _cmp(other.hi, hi) < 0 or
                (_cmp(other.hi, hi) == 0 and not other.hi_incl)):
            hi, hi_incl = other.hi, other.hi_incl
        return Interval(lo=lo, hi=hi, lo_incl=lo_incl, hi_incl=hi_incl)


def _cmp(a, b) -> int:
    a = _canon(a)
    b = _canon(b)
    return (a > b) - (a < b)


def _canon(v):
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, bool):
        return int(v)
    return v


def extract_column_intervals(where: Optional[ir.TExpr]) -> dict[str, Interval]:
    """Per-column intervals implied by the predicate (conjunctions only)."""
    out: dict[str, Interval] = {}
    if where is None:
        return out

    def visit(e: ir.TExpr) -> None:
        if isinstance(e, ir.TBinary) and e.op == "and":
            visit(e.lhs)
            visit(e.rhs)
            return
        if isinstance(e, ir.TBinary) and e.op in ("=", "<", "<=", ">", ">="):
            ref, lit, op = _ref_literal(e)
            if ref is None:
                return
            iv = out.setdefault(ref, Interval())
            value = lit
            if op == "=":
                out[ref] = iv.narrow(Interval(lo=value, hi=value))
            elif op == "<":
                out[ref] = iv.narrow(Interval(hi=value, hi_incl=False))
            elif op == "<=":
                out[ref] = iv.narrow(Interval(hi=value))
            elif op == ">":
                out[ref] = iv.narrow(Interval(lo=value, lo_incl=False))
            elif op == ">=":
                out[ref] = iv.narrow(Interval(lo=value))
            return
        if isinstance(e, ir.TBetween) and not e.negated and \
                len(e.operands) == 1 and len(e.ranges) == 1 and \
                isinstance(e.operands[0], ir.TReference):
            (lower, upper) = e.ranges[0]
            # Null bounds admit null rows (null sorts first), which min/max
            # stats over non-null values cannot prune — no constraint.
            if len(lower) == 1 and len(upper) == 1 and \
                    lower[0] is not None and upper[0] is not None:
                name = e.operands[0].name
                iv = out.setdefault(name, Interval())
                out[name] = iv.narrow(Interval(lo=lower[0], hi=upper[0]))
            return
        if isinstance(e, ir.TIn) and len(e.operands) == 1 and \
                isinstance(e.operands[0], ir.TReference) and e.values:
            flat = [tup[0] for tup in e.values if tup[0] is not None]
            if flat and len(flat) == len(e.values):
                name = e.operands[0].name
                iv = out.setdefault(name, Interval())
                out[name] = iv.intersect_point_set(flat)
            return
        # Anything else (OR, functions, negations) → no constraint.

    visit(where)
    return out


def _ref_literal(e: ir.TBinary):
    """Normalize `ref OP literal` / `literal OP ref` to (ref, literal, op)."""
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    if isinstance(e.lhs, ir.TReference) and isinstance(e.rhs, ir.TLiteral) \
            and e.rhs.value is not None:
        return e.lhs.name, e.rhs.value, e.op
    if isinstance(e.rhs, ir.TReference) and isinstance(e.lhs, ir.TLiteral) \
            and e.lhs.value is not None:
        return e.rhs.name, e.lhs.value, flip[e.op]
    return None, None, None


def chunk_may_match(stats: dict, intervals: dict[str, Interval]) -> bool:
    """False only when a column's [min, max] provably misses its interval."""
    for name, interval in intervals.items():
        col = stats.get(name)
        if not col or col.get("min") is None or col.get("max") is None:
            continue
        cmin, cmax = _canon(col["min"]), _canon(col["max"])
        if interval.lo is not _NEG_INF:
            lo = _canon(interval.lo)
            # (Nulls never satisfy comparisons, so has_null cannot rescue a
            # shard whose non-null range misses the interval.)
            if cmax < lo or (cmax == lo and not interval.lo_incl):
                return False
        if interval.hi is not _POS_INF:
            hi = _canon(interval.hi)
            if cmin > hi or (cmin == hi and not interval.hi_incl):
                return False
    return True


def compute_column_stats(chunk) -> dict:
    """Host-side per-column min/max/has_null for pruning metadata.

    Since the stats moved into the chunk wire format (written once at
    serialize/seal time, read via `FsChunkStore.read_stats`), this is
    the BACKFILL path for already-decoded chunks — the implementation
    lives with the chunk layout in `chunks/columnar.py`."""
    from ytsaurus_tpu_torch.chunks.columnar import chunk_column_stats
    return chunk_column_stats(chunk)
