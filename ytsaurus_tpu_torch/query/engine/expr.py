"""Expression lowering: typed IR → torch, with host-side vocabulary binding.

Port of the JAX package's `query/engine/expr.py` (`ExprBinder`), all of it:

  * Device planes are (data, valid) pairs; null logic is three-valued and
    vectorized.
  * Work that inspects string bytes (comparisons against literals,
    cross-vocabulary equality, LIKE and regex, lower/upper/concat/substr,
    length, hashes of strings) is evaluated on the host over the chunk
    vocabulary and shipped to the device as a table that one gather on
    the dictionary codes reads.
  * A vector literal is a `(dim,)` binding; the distance functions take a
    `(capacity, dim)` plane against it in one matrix-vector product.

Two phases walk the IR in the same order: bind (per chunk, on the host,
numpy) appends bound values to a list; emit (at run time) builds the torch
computation, reading the bound values positionally from the bindings tuple,
which the evaluator has moved to the device.

uint64 planes hold int64 bit patterns (torch has no unsigned arithmetic on
the CPU): comparisons flip the sign bit, conversions to double split the
word, division and modulo run `_udivmod`, right shifts mask, and the hash
mixes shift logically.

One departure from the JAX package: `concat` refuses a vocabulary cross
product above 2^24 pairs, where the JAX package refuses one above 2^16
(its bound keeps the traced table shapes small; the port compiles no
programs, and the reference's own concat has no bound at all).
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import next_pow2
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.schema import EValueType, device_dtype

_EMPTY_VOCAB = np.array([], dtype=object)
_SIGN64 = -(1 << 63)
_M32 = 0xFFFFFFFF
_MAX64 = (1 << 63) - 1
_CONCAT_MAX_PAIRS = 1 << 24


def _i64(value: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    value %= 1 << 64
    return value - (1 << 64) if value >= (1 << 63) else value


_HASH_SEED = _i64(0x9E3779B97F4A7C15)
_MIX_MUL = _i64(0xFF51AFD7ED558CCD)

_NP_DTYPES = {torch.int64: np.int64, torch.float64: np.float64,
              torch.bool: np.bool_, torch.int32: np.int32,
              torch.int8: np.int8, torch.float32: np.float32}


def _np_dtype_for(ty: EValueType):
    return _NP_DTYPES[device_dtype(ty)]


def not_ported(what: str) -> YtError:
    return YtError(f"{what} is not yet ported to ytsaurus_tpu_torch",
                   code=EErrorCode.QueryUnsupported)


# --- bind-phase context -------------------------------------------------------


@dataclass
class ColumnBinding:
    """Host view of one input column at bind time."""
    type: EValueType
    vocab: Optional[np.ndarray]  # for string columns


@dataclass
class BindContext:
    """Per-chunk bind state: column vocabs in, bound host arrays out."""
    columns: dict[str, ColumnBinding]
    bindings: list = field(default_factory=list)

    def add(self, value) -> int:
        self.bindings.append(np.asarray(value))
        return len(self.bindings) - 1


@dataclass
class EmitContext:
    """Run-time state: column planes + the bindings tuple on the device."""
    columns: dict[str, tuple[torch.Tensor, torch.Tensor]]
    bindings: tuple
    capacity: int
    device: torch.device


@dataclass
class BoundExpr:
    """Result of binding one IR node for one chunk."""
    type: EValueType
    vocab: Optional[np.ndarray]          # result vocabulary if string-typed
    emit: Callable[[EmitContext], tuple[torch.Tensor, torch.Tensor]]


def order_key_bits(bound: BoundExpr) -> int:
    """Packed-key width of one sort key (ORDER BY, window PARTITION BY and
    ORDER BY): dictionary codes and bools need few bits; everything else
    is full-width."""
    if bound.type is EValueType.boolean:
        return 1
    if bound.type is EValueType.string and bound.vocab is not None:
        return max(len(bound.vocab) - 1, 1).bit_length()
    return 64


def bindings_to_device(bindings: list, device: torch.device) -> tuple:
    """Bound host arrays as torch tensors on `device` (uint64 as int64)."""
    out = []
    for value in bindings:
        arr = np.asarray(value)
        if arr.dtype == np.uint64:
            arr = arr.view(np.int64)
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return tuple(out)


def _vocab_bucket(n: int) -> int:
    """Pad vocab-indexed bound arrays to power-of-two buckets >= 8."""
    return next_pow2(n, floor=8)


def _pad_np(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _vocab_code(vocab: np.ndarray, value: bytes) -> int:
    """Code of `value` in sorted vocab, or -1 if absent."""
    idx = np.searchsorted(vocab, value) if len(vocab) else 0
    if idx < len(vocab) and vocab[idx] == value:
        return int(idx)
    return -1


def _range_code(vocab: np.ndarray, value: bytes) -> int:
    """Order-preserving encoding of `value` against a sorted vocab in the
    doubled space where row code c sits at 2c+1: a present value lands
    exactly on its row encoding, an absent one on the even insertion
    point between its neighbors (comparable, never equal)."""
    idx = int(np.searchsorted(vocab, value)) if len(vocab) else 0
    if idx < len(vocab) and vocab[idx] == value:
        return 2 * idx + 1
    return 2 * idx


def _remap_table(old_vocab: np.ndarray, new_vocab: np.ndarray) -> np.ndarray:
    lookup = {v: i for i, v in enumerate(new_vocab)}
    table = np.array([lookup[v] for v in old_vocab], dtype=np.int32)
    if len(table) == 0:
        table = np.zeros(1, dtype=np.int32)
    return table


def _merge_vocabs(*vocabs: Optional[np.ndarray]) -> np.ndarray:
    values = set()
    for v in vocabs:
        if v is not None:
            values.update(v)
    return np.array(sorted(values), dtype=object)


def _gather_binding(slot: int):
    """Emit helper: codes -> bound table lookup (clipped; callers mask
    validity themselves)."""
    def gather(ctx: EmitContext, codes: torch.Tensor) -> torch.Tensor:
        table = ctx.bindings[slot]
        return table[codes.to(torch.int64).clamp(0, table.shape[0] - 1)]
    return gather


def _u64_to_f64(data: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns (int64) → float64 with one rounding."""
    hi = ((data >> 32) & _M32).to(torch.float64)
    lo = (data & _M32).to(torch.float64)
    return hi * 4294967296.0 + lo


def cast_plane(data: torch.Tensor, src: EValueType,
               dst: EValueType) -> torch.Tensor:
    """Convert a plane of logical type `src` to the plane of `dst`, as the
    reference's `astype` to dst's device dtype does."""
    if dst is EValueType.boolean:
        return data != 0
    if dst is EValueType.double:
        if src is EValueType.uint64:
            return _u64_to_f64(data)
        return data.to(torch.float64)
    if dst in (EValueType.int64, EValueType.uint64) and \
            data.is_floating_point():
        return _saturating_int64(data, dst is EValueType.uint64)
    return data.to(device_dtype(dst))


_TWO63 = 9223372036854775808.0
_TWO64 = 18446744073709551616.0
# The largest doubles below 2^63 and 2^64: clamped values convert exactly.
_BELOW_TWO63 = 9223372036854774784.0
_BELOW_TWO64 = 18446744073709549568.0


def _saturating_int64(data: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Doubles truncated to int64 (or to uint64 bit patterns), saturating
    as the reference's `astype` does: NaN gives 0, values beyond the
    type's range give its bound (uint64: anything below 0 gives 0). Every
    value is clamped into range before it is converted, so the result
    does not depend on how the device converts out-of-range doubles."""
    data = data.to(torch.float64)
    nan = torch.isnan(data)
    if unsigned:
        big = data >= _TWO63
        low = torch.where(big | nan, 0.0, data).clamp(0.0, _BELOW_TWO63)
        high = torch.where(big, data, _TWO63).clamp(_TWO63, _BELOW_TWO64)
        out = torch.where(big, (high - _TWO64).to(torch.int64),
                          low.to(torch.int64))
        return torch.where(data >= _TWO64, torch.full_like(out, -1), out)
    safe = torch.where(nan, 0.0, data).clamp(-_TWO63, _BELOW_TWO63)
    out = safe.to(torch.int64)
    return torch.where(data >= _TWO63, torch.full_like(out, _MAX64), out)


def _compare(op: str, lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    if op == "=":
        return lhs == rhs
    if op == "!=":
        return lhs != rhs
    if op == "<":
        return lhs < rhs
    if op == "<=":
        return lhs <= rhs
    if op == ">":
        return lhs > rhs
    if op == ">=":
        return lhs >= rhs
    raise AssertionError(op)


def _comparable_pair(ld, lt: EValueType, rd, rt: EValueType):
    """Planes of two numeric operands in one ordered representation,
    matching the reference's promotion: uint64 against uint64 compares
    unsigned; uint64 against int64 or double compares as double."""
    if lt is EValueType.uint64 and rt is EValueType.uint64:
        return ld ^ _SIGN64, rd ^ _SIGN64
    if EValueType.uint64 in (lt, rt) and EValueType.null not in (lt, rt):
        return cast_plane(ld, lt, EValueType.double), \
            cast_plane(rd, rt, EValueType.double)
    return ld, rd


_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")


class ExprBinder:
    """Binds a typed IR expression for one chunk (host phase)."""

    def __init__(self, bind_ctx: BindContext):
        self.ctx = bind_ctx

    def bind(self, node: ir.TExpr) -> BoundExpr:
        method = getattr(self, f"_bind_{type(node).__name__}", None)
        if method is None:
            raise YtError(f"Cannot lower {type(node).__name__}",
                          code=EErrorCode.QueryUnsupported)
        return method(node)

    # -- leaves ---------------------------------------------------------------

    def _bind_TLiteral(self, node: ir.TLiteral) -> BoundExpr:
        ty = node.type
        if ty is EValueType.null:
            def emit_null(ctx: EmitContext):
                zeros = torch.zeros(ctx.capacity, dtype=torch.int8,
                                    device=ctx.device)
                return zeros, torch.zeros(ctx.capacity, dtype=torch.bool,
                                          device=ctx.device)
            return BoundExpr(type=ty, vocab=None, emit=emit_null)
        if ty is EValueType.string:
            # The literal is code 0 of its own one-entry vocabulary; every
            # consumer reads the bytes through bound tables.
            vocab = np.array([node.value], dtype=object)

            def emit_str(ctx: EmitContext):
                return (torch.zeros(ctx.capacity, dtype=torch.int32,
                                    device=ctx.device),
                        torch.ones(ctx.capacity, dtype=torch.bool,
                                   device=ctx.device))
            return BoundExpr(type=ty, vocab=vocab, emit=emit_str)
        if not isinstance(ty, EValueType):
            # A vector literal (the NEAREST query vector): a (dim,) float32
            # binding.
            vec_slot = self.ctx.add(np.asarray(node.value, dtype=np.float32))

            def emit_vec(ctx: EmitContext):
                return (ctx.bindings[vec_slot],
                        torch.ones(ctx.capacity, dtype=torch.bool,
                                   device=ctx.device))
            return BoundExpr(type=ty, vocab=None, emit=emit_vec)
        if ty is EValueType.uint64:
            value = np.array([int(node.value) % (1 << 64)],
                             dtype=np.uint64).view(np.int64)[0]
        else:
            value = np.asarray(node.value, dtype=_np_dtype_for(ty))
        slot = self.ctx.add(value)

        def emit(ctx: EmitContext):
            return (ctx.bindings[slot].expand(ctx.capacity),
                    torch.ones(ctx.capacity, dtype=torch.bool,
                               device=ctx.device))
        return BoundExpr(type=ty, vocab=None, emit=emit)

    def _bind_TReference(self, node: ir.TReference) -> BoundExpr:
        binding = self.ctx.columns.get(node.name)
        if binding is None:
            raise YtError(f"Unbound column {node.name!r}",
                          code=EErrorCode.QueryExecutionError)
        name = node.name

        def emit(ctx: EmitContext):
            return ctx.columns[name]
        return BoundExpr(type=node.type, vocab=binding.vocab, emit=emit)

    # -- operators ------------------------------------------------------------

    def _bind_TUnary(self, node: ir.TUnary) -> BoundExpr:
        operand = self.bind(node.operand)
        op = node.op

        def emit(ctx: EmitContext):
            data, valid = operand.emit(ctx)
            if op == "not":
                return ~data.to(torch.bool), valid
            if op == "-":
                return -data, valid
            if op == "~":
                return ~data, valid
            raise AssertionError(op)
        return BoundExpr(type=node.type, vocab=None, emit=emit)

    def _bind_TBinary(self, node: ir.TBinary) -> BoundExpr:
        op = node.op
        lhs_b = self.bind(node.lhs)
        rhs_b = self.bind(node.rhs)

        if op in ("and", "or"):
            def emit_logical(ctx: EmitContext):
                ld, lv = lhs_b.emit(ctx)
                rd, rv = rhs_b.emit(ctx)
                ld, rd = ld.to(torch.bool), rd.to(torch.bool)
                if op == "and":
                    known_false = (lv & ~ld) | (rv & ~rd)
                    valid = (lv & rv) | known_false
                    data = (ld | ~lv) & (rd | ~rv)
                    return data & valid, valid
                known_true = (lv & ld) | (rv & rd)
                valid = (lv & rv) | known_true
                return (ld & lv) | (rd & rv), valid
            return BoundExpr(type=EValueType.boolean, vocab=None,
                             emit=emit_logical)

        if EValueType.string in (lhs_b.type, rhs_b.type) and \
                lhs_b.type is not EValueType.null and \
                rhs_b.type is not EValueType.null:
            encoded = self._bind_string_literal_cmp(node, op, lhs_b, rhs_b)
            if encoded is not None:
                return encoded
            # Decoded path: remap both sides onto their merged vocabulary.
            merged = _merge_vocabs(lhs_b.vocab, rhs_b.vocab)
            l_vocab = lhs_b.vocab if lhs_b.vocab is not None else _EMPTY_VOCAB
            r_vocab = rhs_b.vocab if rhs_b.vocab is not None else _EMPTY_VOCAB
            l_slot = self.ctx.add(_pad_np(_remap_table(l_vocab, merged),
                                          _vocab_bucket(max(len(l_vocab), 1)),
                                          0))
            r_slot = self.ctx.add(_pad_np(_remap_table(r_vocab, merged),
                                          _vocab_bucket(max(len(r_vocab), 1)),
                                          0))
            l_gather = _gather_binding(l_slot)
            r_gather = _gather_binding(r_slot)

            def emit_strcmp(ctx: EmitContext):
                ld, lv = lhs_b.emit(ctx)
                rd, rv = rhs_b.emit(ctx)
                return _compare(op, l_gather(ctx, ld), r_gather(ctx, rd)), \
                    lv & rv
            return BoundExpr(type=EValueType.boolean, vocab=None,
                             emit=emit_strcmp)

        if op in _CMP_OPS:
            def emit_cmp(ctx: EmitContext):
                ld, lv = lhs_b.emit(ctx)
                rd, rv = rhs_b.emit(ctx)
                ld, rd = _comparable_pair(ld, lhs_b.type, rd, rhs_b.type)
                return _compare(op, ld, rd), lv & rv
            return BoundExpr(type=EValueType.boolean, vocab=None,
                             emit=emit_cmp)

        target = node.type
        unsigned = target is EValueType.uint64

        def emit(ctx: EmitContext):
            ld, lv = lhs_b.emit(ctx)
            rd, rv = rhs_b.emit(ctx)
            valid = lv & rv
            ld = cast_plane(ld, lhs_b.type, target)
            rd = cast_plane(rd, rhs_b.type, target)
            integer = not ld.is_floating_point()
            if op == "+":
                data = ld + rd
            elif op == "-":
                data = ld - rd
            elif op == "*":
                data = ld * rd
            elif op in ("/", "%") and integer:
                safe = torch.where(rd == 0, torch.ones_like(rd), rd)
                if unsigned:
                    q, r = _udivmod(ld, safe)
                    data = q if op == "/" else r
                else:
                    data = torch.div(ld, safe, rounding_mode="trunc") \
                        if op == "/" else torch.fmod(ld, safe)
                valid = valid & (rd != 0)
            elif op == "/":
                data = ld / rd
            elif op == "%":
                data = torch.fmod(ld, rd)
            elif op == "|":
                data = ld | rd
            elif op == "&":
                data = ld & rd
            elif op == "^":
                data = ld ^ rd
            elif op == "<<":
                data = ld << rd
            elif op == ">>":
                data = _ushr(ld, rd) if unsigned else ld >> rd
            else:
                raise AssertionError(op)
            return data, valid
        return BoundExpr(type=node.type, vocab=None, emit=emit)

    def _bind_string_literal_cmp(self, node: ir.TBinary, op: str,
                                 lhs_b: BoundExpr,
                                 rhs_b: BoundExpr) -> Optional[BoundExpr]:
        """A literal against a dict-encoded side compares CODES: =/!= bind
        the literal's exact code (-1 when absent), range ops bind in the
        doubled space of _range_code."""
        if op not in _CMP_OPS:
            return None
        if not (lhs_b.type is EValueType.string
                and rhs_b.type is EValueType.string):
            return None
        if isinstance(node.rhs, ir.TLiteral) and lhs_b.vocab is not None:
            col_b, lit, lit_on_right = lhs_b, node.rhs.value, True
        elif isinstance(node.lhs, ir.TLiteral) and rhs_b.vocab is not None:
            col_b, lit, lit_on_right = rhs_b, node.lhs.value, False
        else:
            return None
        if lit is None:
            return None
        vocab = col_b.vocab
        if op in ("=", "!="):
            slot = self.ctx.add(np.int32(_vocab_code(vocab, lit)))

            def emit_eq(ctx: EmitContext):
                data, valid = col_b.emit(ctx)
                code = ctx.bindings[slot]
                out = (data == code) if op == "=" else (data != code)
                return out, valid
            return BoundExpr(type=EValueType.boolean, vocab=None,
                             emit=emit_eq)
        slot = self.ctx.add(np.int32(_range_code(vocab, lit)))

        def emit_rng(ctx: EmitContext):
            data, valid = col_b.emit(ctx)
            doubled = data.to(torch.int32) * 2 + 1
            code = ctx.bindings[slot]
            out = _compare(op, doubled, code) if lit_on_right \
                else _compare(op, code, doubled)
            return out, valid
        return BoundExpr(type=EValueType.boolean, vocab=None, emit=emit_rng)

    # -- functions ------------------------------------------------------------

    def _bind_TFunction(self, node: ir.TFunction) -> BoundExpr:
        name = node.name
        args = [self.bind(a) for a in node.args]
        if name == "if":
            return self._bind_if(node, args)
        if name in ("l2_distance", "distance", "cosine_distance",
                    "dot_product"):
            return _bind_distance(name, args[0], args[1])
        if name == "is_null":
            a = args[0]

            def emit_is_null(ctx):
                _, valid = a.emit(ctx)
                return ~valid, torch.ones_like(valid)
            return BoundExpr(type=EValueType.boolean, vocab=None,
                             emit=emit_is_null)
        if name == "if_null":
            return self._bind_merge_select(
                node, [args[0], args[1]],
                lambda planes: (
                    torch.where(planes[0][1], planes[0][0], planes[1][0]),
                    planes[0][1] | planes[1][1]),
                string_operands=(0, 1), value_operands=(0, 1))
        if name in ("int64", "uint64", "double", "boolean"):
            return _unary_map(node.type, args[0],
                              lambda d, src: cast_plane(d, src, node.type))
        if name == "abs":
            return _unary_map(node.type, args[0], lambda d, src: d if src in (
                EValueType.uint64, EValueType.null) else torch.abs(d))
        if name in ("floor", "ceil", "sqrt"):
            fn = {"floor": torch.floor, "ceil": torch.ceil,
                  "sqrt": torch.sqrt}[name]
            return _unary_map(node.type, args[0], lambda d, src: fn(
                _as_type(d, src, EValueType.double)))
        if name in ("is_finite", "is_nan"):
            fn = torch.isfinite if name == "is_finite" else torch.isnan
            return _unary_map(EValueType.boolean, args[0], lambda d, src: fn(
                _as_type(d, src, EValueType.double)))
        if name.startswith("timestamp_floor_"):
            unit = name[len("timestamp_floor_"):]
            if unit not in ("hour", "day", "week", "month", "year"):
                raise YtError(f"Unknown timestamp unit {unit!r}",
                              code=EErrorCode.QueryUnsupported)
            return _unary_map(EValueType.int64, args[0], lambda d, src:
                              _timestamp_floor(d.to(torch.int64), unit))
        if name in ("min_of", "max_of"):
            return _bind_min_max(node.type, args, name == "min_of")
        if name in ("lower", "upper"):
            return self._bind_string_map(
                args[0], (lambda v: v.lower()) if name == "lower" else
                (lambda v: v.upper()))
        if name == "concat":
            return self._bind_concat(args[0], args[1])
        if name == "length":
            return self._bind_vocab_table(args[0], EValueType.int64,
                                          _vocab_table(args[0], len,
                                                       np.int64))
        if name in ("is_prefix", "is_substr"):
            # Literal patterns arrive as TStringPredicate.
            raise YtError(f"{name} requires a literal pattern",
                          code=EErrorCode.QueryUnsupported)
        if name == "farm_hash":
            return self._bind_hash(args)
        if name in ("regex_full_match", "regex_partial_match"):
            rx = _compile_regex(_literal_bytes(node.args[0], name), name)
            full = name == "regex_full_match"
            return self._bind_vocab_table(args[1], EValueType.boolean,
                                          _vocab_table(
                args[1], (lambda v: rx.fullmatch(v) is not None) if full
                else (lambda v: rx.search(v) is not None), np.bool_))
        if name in ("regex_replace_first", "regex_replace_all"):
            rx = _compile_regex(_literal_bytes(node.args[0], name), name)
            rewrite = _literal_bytes(node.args[2], name)
            count = 1 if name == "regex_replace_first" else 0
            try:
                return self._bind_string_map(
                    args[1], lambda v: rx.sub(rewrite, v, count=count))
            except re.error as exc:
                raise YtError(f"{name}: invalid rewrite {rewrite!r}: {exc}",
                              code=EErrorCode.QueryParseError)
        if name == "regex_escape":
            return self._bind_string_map(args[0], re.escape)
        if name == "sha256":
            return self._bind_string_map(
                args[0], lambda v: hashlib.sha256(v).digest())
        if name == "bigb_hash":
            # farm_hash's string hash, domain-separated by a prefix.
            vocab = _vocab_of(args[0])
            table = _bytes_hash_table([b"bigb:" + bytes(v) for v in vocab])
            return self._bind_vocab_table(args[0], EValueType.uint64,
                                          table if len(table) else
                                          np.zeros(1, dtype=np.uint64))
        if name == "parse_int64":
            return self._bind_parse_int64(args[0])
        if name == "substr":
            start = int(_literal_int(node.args[1], name))
            length = int(_literal_int(node.args[2], name)) \
                if len(node.args) > 2 else None
            if start < 0 or (length is not None and length < 0):
                raise YtError("substr: start/length must be >= 0",
                              code=EErrorCode.QueryTypeError)
            end = None if length is None else start + length
            return self._bind_string_map(args[0], lambda v: v[start:end])
        raise YtError(f"Function {name!r} has no lowering",
                      code=EErrorCode.QueryUnsupported)

    def _bind_if(self, node: ir.TFunction, args: list[BoundExpr]
                 ) -> BoundExpr:
        def select(planes):
            cd, cv = planes[0]
            td, tv = planes[1]
            ed, ev = planes[2]
            take_then = cv & cd.to(torch.bool)
            take_else = cv & ~cd.to(torch.bool)
            data = torch.where(take_then, td, ed)
            valid = torch.where(take_then, tv, take_else & ev)
            return data, valid
        return self._bind_merge_select(node, args, select,
                                       string_operands=(1, 2),
                                       value_operands=(1, 2))

    def _bind_merge_select(self, node, args: list[BoundExpr], select,
                           string_operands: tuple[int, ...],
                           value_operands: tuple[int, ...]) -> BoundExpr:
        """Shared lowering for if/if_null: the value operands come to the
        result's plane type (string codes onto the merged vocabulary of
        the value operands), then `select` picks per row."""
        ty = node.type
        remap = {}
        merged = None
        if ty is EValueType.string:
            merged = _merge_vocabs(*[args[i].vocab for i in string_operands])
            for i in string_operands:
                vocab = _vocab_of(args[i])
                slot = self.ctx.add(_pad_np(
                    _remap_table(vocab, merged),
                    _vocab_bucket(max(len(vocab), 1)), 0))
                remap[i] = _gather_binding(slot)

        def emit(ctx):
            planes = []
            for i, a in enumerate(args):
                d, v = a.emit(ctx)
                if i in remap and a.type is EValueType.string:
                    d = remap[i](ctx, d)
                elif i in value_operands and ty not in (EValueType.null,
                                                        EValueType.string):
                    d = _as_type(d, a.type, ty)
                planes.append((d, v))
            return select(planes)
        return BoundExpr(type=ty, vocab=merged, emit=emit)

    def _bind_concat(self, a: BoundExpr, b: BoundExpr) -> BoundExpr:
        """String concatenation at the vocabulary level: the result vocab is
        the sorted, deduplicated cross product of the operand vocabs; the
        device computes the pair index c_a * |v_b| + c_b and gathers
        through a bound remap."""
        va, vb = _vocab_of(a), _vocab_of(b)
        na, nb = max(len(va), 1), max(len(vb), 1)
        if na * nb > _CONCAT_MAX_PAIRS:
            raise YtError(
                f"concat() vocabulary cross product too large "
                f"({len(va)}x{len(vb)}); reduce distinct values",
                code=EErrorCode.QueryUnsupported)
        pairs = [bytes(x) + bytes(y)
                 for x in (va if len(va) else [b""])
                 for y in (vb if len(vb) else [b""])]
        merged = np.array(sorted(set(pairs)), dtype=object)
        lookup = {v: i for i, v in enumerate(merged)}
        table = np.array([lookup[p] for p in pairs], dtype=np.int32)
        gather = _gather_binding(self.ctx.add(
            _pad_np(table, _vocab_bucket(len(table)), 0)))

        def emit(ctx):
            da, valid_a = a.emit(ctx)
            db, valid_b = b.emit(ctx)
            pair = da.to(torch.int64) * nb + db.to(torch.int64)
            return gather(ctx, pair), valid_a & valid_b
        return BoundExpr(type=EValueType.string, vocab=merged, emit=emit)

    def _bind_vocab_table(self, a: BoundExpr, result_type: EValueType,
                          table: np.ndarray) -> BoundExpr:
        """String → scalar through a host table over the vocabulary and
        one device gather on the codes (length, regex matches, hashes)."""
        gather = _gather_binding(self.ctx.add(
            _pad_np(table, _vocab_bucket(len(table)), 0)))

        def emit(ctx):
            data, valid = a.emit(ctx)
            return gather(ctx, data), valid
        return BoundExpr(type=result_type, vocab=None, emit=emit)

    def _bind_string_map(self, a: BoundExpr, fn) -> BoundExpr:
        """Vocabulary-level string → string transform (lower, upper,
        substr, regex replace, ...)."""
        new_values = [fn(v) for v in _vocab_of(a)]
        new_vocab = np.array(sorted(set(new_values)), dtype=object)
        lookup = {v: i for i, v in enumerate(new_vocab)}
        table = np.array([lookup[v] for v in new_values], dtype=np.int32)
        if len(table) == 0:
            table = np.zeros(1, dtype=np.int32)
        gather = _gather_binding(self.ctx.add(
            _pad_np(table, _vocab_bucket(len(table)), 0)))

        def emit(ctx):
            data, valid = a.emit(ctx)
            return gather(ctx, data), valid
        return BoundExpr(type=EValueType.string, vocab=new_vocab, emit=emit)

    def _bind_parse_int64(self, s: BoundExpr) -> BoundExpr:
        """Optional sign and digits only, and the value must fit int64;
        anything else parses to null."""
        def try_parse(v: bytes):
            text = v.strip()
            if not re.fullmatch(rb"[+-]?[0-9]+", text):
                return 0, False
            value = int(text)
            if not (-(1 << 63) <= value < (1 << 63)):
                return 0, False
            return value, True
        parsed = [try_parse(v) for v in _vocab_of(s)]
        val_t = np.array([p[0] for p in parsed] or [0], dtype=np.int64)
        ok_t = np.array([p[1] for p in parsed] or [False], dtype=np.bool_)
        g_val = _gather_binding(self.ctx.add(
            _pad_np(val_t, _vocab_bucket(len(val_t)), 0)))
        g_ok = _gather_binding(self.ctx.add(
            _pad_np(ok_t, _vocab_bucket(len(ok_t)), False)))

        def emit(ctx):
            data, valid = s.emit(ctx)
            return g_val(ctx, data), valid & g_ok(ctx, data)
        return BoundExpr(type=EValueType.int64, vocab=None, emit=emit)

    def _bind_hash(self, args: list[BoundExpr]) -> BoundExpr:
        hashed_args = []
        for a in args:
            gather = None
            if a.type is EValueType.string:
                table = _bytes_hash_table(_vocab_of(a))
                if len(table) == 0:
                    table = np.zeros(1, dtype=np.uint64)
                gather = _gather_binding(self.ctx.add(
                    _pad_np(table, _vocab_bucket(len(table)), 0)))
            hashed_args.append((a, gather))

        def emit(ctx):
            # A null argument contributes 0: the result is always valid.
            acc = torch.full((ctx.capacity,), _HASH_SEED, dtype=torch.int64,
                             device=ctx.device)
            for a, gather in hashed_args:
                data, valid = a.emit(ctx)
                h = gather(ctx, data) if gather is not None \
                    else _mix_u64(data)
                acc = _combine_u64(acc, torch.where(valid, h,
                                                    torch.zeros_like(h)))
            return acc, torch.ones(ctx.capacity, dtype=torch.bool,
                                   device=ctx.device)
        return BoundExpr(type=EValueType.uint64, vocab=None, emit=emit)

    # -- membership / ranges ---------------------------------------------------

    def _bind_TIn(self, node: ir.TIn) -> BoundExpr:
        operands = [self.bind(o) for o in node.operands]
        n_bucket = next_pow2(len(node.values))
        value_slots, valid_slots = self._bind_value_tuples(
            operands, node.values, pad_to=n_bucket)
        present_np = np.zeros(n_bucket, dtype=bool)
        present_np[: len(node.values)] = True
        present_slot = self.ctx.add(present_np)

        def emit(ctx):
            op_planes = [o.emit(ctx) for o in operands]
            match_any = torch.zeros(ctx.capacity, dtype=torch.bool,
                                    device=ctx.device)
            present = ctx.bindings[present_slot]
            for vi in range(n_bucket):
                row_match = present[vi].expand(ctx.capacity)
                for oi, (data, valid) in enumerate(op_planes):
                    const = ctx.bindings[value_slots[oi]][vi]
                    cvalid = ctx.bindings[valid_slots[oi]][vi]
                    # A null element matches null rows; a value matches
                    # equal valid rows (null == null, as CompareRowValues).
                    row_match = row_match & torch.where(
                        cvalid, valid & (data == const), ~valid)
                match_any = match_any | row_match
            return match_any, torch.ones(ctx.capacity, dtype=torch.bool,
                                         device=ctx.device)
        return BoundExpr(type=EValueType.boolean, vocab=None, emit=emit)

    def _bind_TBetween(self, node: ir.TBetween) -> BoundExpr:
        operands = [self.bind(o) for o in node.operands]
        bound_ranges = []
        for lower, upper in node.ranges:
            lo = self._bind_value_tuples(operands[: len(lower)], [lower],
                                         range_encode=True)
            up = self._bind_value_tuples(operands[: len(upper)], [upper],
                                         range_encode=True)
            bound_ranges.append((len(lower), lo, len(upper), up))

        def emit(ctx):
            op_planes = []
            for operand in operands:
                data, valid = operand.emit(ctx)
                if operand.type is EValueType.string:
                    data = data.to(torch.int32) * 2 + 1   # see _range_code
                elif operand.type is EValueType.uint64:
                    data = data ^ _SIGN64                 # unsigned order
                op_planes.append((data, valid))
            in_any = torch.zeros(ctx.capacity, dtype=torch.bool,
                                 device=ctx.device)
            for lo_len, lo_slots, up_len, up_slots in bound_ranges:
                ge = _lex_compare(ctx, op_planes[:lo_len], lo_slots, 0, ">=")
                le = _lex_compare(ctx, op_planes[:up_len], up_slots, 0, "<=")
                in_any = in_any | (ge & le)
            result = ~in_any if node.negated else in_any
            return result, torch.ones(ctx.capacity, dtype=torch.bool,
                                      device=ctx.device)
        return BoundExpr(type=EValueType.boolean, vocab=None, emit=emit)

    def _bind_TTransform(self, node: ir.TTransform) -> BoundExpr:
        """The first from-tuple a row matches picks its to-value; a row
        that matches none takes the default (or null)."""
        operands = [self.bind(o) for o in node.operands]
        from_slots, from_valids = self._bind_value_tuples(
            operands, node.from_values)
        default = self.bind(node.default) if node.default is not None \
            else None
        ty = node.type
        to_valid = np.array([v is not None for v in node.to_values] or
                            [False])
        out_vocab = None
        default_gather = None
        if ty is EValueType.string:
            out_vocab = _merge_vocabs(
                np.array([v for v in node.to_values if v is not None],
                         dtype=object),
                default.vocab if default is not None else None)
            to_table = np.array([_vocab_code(out_vocab, v) if v is not None
                                 else 0 for v in node.to_values] or [0],
                                dtype=np.int32)
            if default is not None and default.type is EValueType.string:
                vocab = _vocab_of(default)
                default_gather = _gather_binding(self.ctx.add(_pad_np(
                    _remap_table(vocab, out_vocab),
                    _vocab_bucket(max(len(vocab), 1)), 0)))
        elif ty is EValueType.uint64:
            to_table = np.array([_i64(v) if v is not None else 0
                                 for v in node.to_values] or [0],
                                dtype=np.int64)
        else:
            to_table = np.array([v if v is not None else 0
                                 for v in node.to_values] or [0],
                                dtype=_np_dtype_for(ty))
        to_slot = self.ctx.add(to_table)
        to_valid_slot = self.ctx.add(to_valid)
        n_values = len(node.from_values)

        def emit(ctx):
            op_planes = [o.emit(ctx) for o in operands]
            match_idx = torch.full((ctx.capacity,), n_values,
                                   dtype=torch.int64, device=ctx.device)
            for vi in range(n_values - 1, -1, -1):
                row_match = torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device)
                for oi, (data, valid) in enumerate(op_planes):
                    const = ctx.bindings[from_slots[oi]][vi]
                    cvalid = ctx.bindings[from_valids[oi]][vi]
                    row_match = row_match & torch.where(
                        cvalid, valid & (data == const), ~valid)
                match_idx = torch.where(row_match, vi, match_idx)
            matched = match_idx < n_values
            safe_idx = match_idx.clamp(0, max(n_values - 1, 0))
            data = ctx.bindings[to_slot][safe_idx]
            valid = matched & ctx.bindings[to_valid_slot][safe_idx]
            if default is not None:
                dd, dv = default.emit(ctx)
                if default_gather is not None:
                    dd = default_gather(ctx, dd)
                elif ty is not EValueType.string:
                    dd = _as_type(dd, default.type, ty)
                data = torch.where(matched, data, dd.to(data.dtype))
                valid = torch.where(matched, valid, dv)
            return data, valid
        return BoundExpr(type=ty, vocab=out_vocab, emit=emit)

    def _bind_TStringPredicate(self, node: ir.TStringPredicate) -> BoundExpr:
        """LIKE / ILIKE, prefix, substring and regex: a match table over
        the operand's vocabulary, read by one gather on its codes."""
        operand = self.bind(node.operand)
        matcher = _string_matcher(node)
        table = _vocab_table(operand, matcher, np.bool_)
        if node.negated:
            table = ~table
        gather = _gather_binding(self.ctx.add(
            _pad_np(table, _vocab_bucket(len(table)), False)))

        def emit(ctx):
            data, valid = operand.emit(ctx)
            return gather(ctx, data), valid
        return BoundExpr(type=EValueType.boolean, vocab=None, emit=emit)

    def _bind_value_tuples(self, operands: list[BoundExpr], values,
                           range_encode: bool = False,
                           pad_to: Optional[int] = None
                           ) -> tuple[list[int], list[int]]:
        """Bind literal tuples column-wise: one slot per operand with the
        per-tuple constants (strings → codes; uint64 → int64 bits, sign
        flipped for range compares) and one with the per-tuple element
        validity (False where the literal is null).

        range_encode=True (BETWEEN bounds): string literals absent from the
        column's vocabulary still order correctly against row codes, in the
        doubled space of _range_code."""
        slots = []
        valid_slots = []
        for oi, operand in enumerate(operands):
            col = [tup[oi] if oi < len(tup) else None for tup in values]
            if operand.type is EValueType.string:
                vocab = operand.vocab if operand.vocab is not None \
                    else _EMPTY_VOCAB
                if range_encode:
                    arr = np.array([_range_code(vocab, v) if v is not None
                                    else 0 for v in col], dtype=np.int32)
                else:
                    arr = np.array([_vocab_code(vocab, v) if v is not None
                                    else -2 for v in col], dtype=np.int32)
            elif operand.type is EValueType.uint64:
                bits = [(int(v) % (1 << 64)) if v is not None else 0
                        for v in col]
                arr = np.array(bits, dtype=np.uint64).view(np.int64)
                if range_encode:
                    arr = arr ^ np.int64(_SIGN64)
            else:
                dt = _np_dtype_for(operand.type) \
                    if operand.type is not EValueType.null else np.int64
                arr = np.array([v if v is not None else 0 for v in col],
                               dtype=dt)
            ok = np.array([v is not None for v in col], dtype=bool)
            if len(arr) == 0:
                arr = np.zeros(1, dtype=arr.dtype)
                ok = np.zeros(1, dtype=bool)
            if pad_to is not None and len(arr) < pad_to:
                arr = _pad_np(arr, pad_to, 0)
                ok = _pad_np(ok, pad_to, False)
            slots.append(self.ctx.add(arr))
            valid_slots.append(self.ctx.add(ok))
        return slots, valid_slots


def _lex_compare(ctx: EmitContext, op_planes, slots, vi: int,
                 op: str) -> torch.Tensor:
    """Lexicographic tuple comparison against bound constants (tuple index
    vi). Null sorts before every value and equals null."""
    value_slots, valid_slots = slots
    cap = ctx.capacity
    result = torch.full((cap,), op in ("<=", ">="), dtype=torch.bool,
                        device=ctx.device)
    for oi in range(len(op_planes) - 1, -1, -1):
        data, valid = op_planes[oi]
        const = ctx.bindings[value_slots[oi]][vi]
        cvalid = ctx.bindings[valid_slots[oi]][vi]
        eq = torch.where(cvalid, valid & (data == const), ~valid)
        if op in ("<=", "<"):
            lt = cvalid & ((~valid) | (data < const))
            result = lt | (eq & result)
        else:
            gt = torch.where(cvalid, valid & (data > const), valid)
            result = gt | (eq & result)
    return result


# --- helpers of the function lowerings ----------------------------------------


def _vocab_of(bound: BoundExpr) -> np.ndarray:
    return bound.vocab if bound.vocab is not None else _EMPTY_VOCAB


def _vocab_table(bound: BoundExpr, fn, np_dtype) -> np.ndarray:
    """`fn` over the operand's vocabulary (one dummy entry when empty)."""
    return np.array([fn(v) for v in _vocab_of(bound)] or [np_dtype()],
                    dtype=np_dtype)


def _as_type(data: torch.Tensor, src, dst) -> torch.Tensor:
    """A plane of logical type `src` as the plane of `dst` (a null plane
    becomes zeros of dst's dtype)."""
    if src is EValueType.null:
        return data.to(device_dtype(dst))
    return cast_plane(data, src, dst)


def _unary_map(result_type, a: BoundExpr, fn) -> BoundExpr:
    """A one-argument function: fn(data, argument type), validity kept."""
    src = a.type

    def emit(ctx):
        data, valid = a.emit(ctx)
        return fn(data, src), valid
    return BoundExpr(type=result_type, vocab=None, emit=emit)


def _select_type(a, b):
    """The plane type two operands of min_of/max_of meet in, as the
    reference's dtype promotion has it: int64 against uint64 is double."""
    if a is b or b is EValueType.null:
        return a
    if a is EValueType.null:
        return b
    if {a, b} == {EValueType.int64, EValueType.uint64}:
        return EValueType.double
    return a if a is EValueType.double else b


def _bind_min_max(result_type, args: list[BoundExpr],
                  pick_min: bool) -> BoundExpr:
    """min_of / max_of: the least (greatest) non-null argument per row;
    null only where every argument is."""
    def emit(ctx):
        data, valid = args[0].emit(ctx)
        ty = args[0].type
        for a in args[1:]:
            d, v = a.emit(ctx)
            common = _select_type(a.type, ty)
            d, data = _as_type(d, a.type, common), _as_type(data, ty, common)
            ty = common
            kd, kdata = (d ^ _SIGN64, data ^ _SIGN64) \
                if ty is EValueType.uint64 else (d, data)
            better = (kd < kdata) if pick_min else (kd > kdata)
            take = v & (~valid | better)
            data = torch.where(take, d, data)
            valid = valid | v
        if result_type is not EValueType.null:
            data = _as_type(data, ty, result_type)
        return data, valid
    return BoundExpr(type=result_type, vocab=None, emit=emit)


def _bind_distance(metric: str, a: BoundExpr, b: BoundExpr) -> BoundExpr:
    """l2_distance / distance / cosine_distance / dot_product in float32:
    a (capacity, dim) plane against a (dim,) vector is one matrix-vector
    product, L2 by the norm trick off the same product; the double result
    spans the capacity."""
    def emit(ctx):
        da, va = a.emit(ctx)
        db, vb = b.emit(ctx)
        da = da.to(torch.float32)
        db = db.to(torch.float32)
        if da.ndim == 1 and db.ndim == 2:
            da, db, va, vb = db, da, vb, va
        if da.ndim == 2 and db.ndim == 1:
            dot = da @ db
        elif da.ndim == 2:
            dot = (da * db).sum(dim=1)     # column against column, row-wise
        else:
            dot = da @ db                  # two literals: a scalar
        na2 = (da * da).sum(dim=-1)
        nb2 = (db * db).sum(dim=-1)
        if metric == "dot_product":
            out = dot
        elif metric == "cosine_distance":
            denom = torch.sqrt(na2) * torch.sqrt(nb2)
            out = torch.where(denom > 0.0, 1.0 - dot / denom,
                              torch.ones_like(dot))
        else:
            out = torch.sqrt(torch.clamp(na2 - 2.0 * dot + nb2, min=0.0))
        out = out.to(torch.float64).expand(ctx.capacity)
        return out, va & vb
    return BoundExpr(type=EValueType.double, vocab=None, emit=emit)


# --- uint64 arithmetic on int64 bit patterns ---------------------------------


def _lshr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits by a constant 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _udivmod(a: torch.Tensor, b: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 64-bit quotient and remainder of int64 bit patterns (b is
    never 0). A divisor at or above 2^63 has quotient 0 or 1; below it,
    q = ((a >>> 1) / b) << 1 is at most one short, and one unsigned
    compare of the remainder corrects it."""
    big = b < 0
    q_big = ((a ^ _SIGN64) >= (b ^ _SIGN64)).to(torch.int64)
    bb = torch.where(big, torch.ones_like(b), b)
    q = torch.div(_lshr(a, 1), bb, rounding_mode="trunc") << 1
    r = a - q * bb
    q = q + ((r ^ _SIGN64) >= (bb ^ _SIGN64)).to(torch.int64)
    q = torch.where(big, q_big, q)
    return q, a - q * b


def _ushr(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bits by per-row amounts: 0 for
    amounts outside [0, 64), as XLA's shift_right_logical gives."""
    sh = s.clamp(0, 63)
    out = torch.where(sh == 0, a, _lshr(a, 1) >> (sh - 1).clamp(min=0))
    return torch.where((s < 0) | (s >= 64), torch.zeros_like(a), out)


def _mix_u64(data: torch.Tensor) -> torch.Tensor:
    """The 64-bit finalizer of farm_hash's non-string arguments; doubles
    are hashed through their bits."""
    x = data.view(torch.int64) if data.dtype == torch.float64 \
        else data.to(torch.int64)
    x = x ^ _lshr(x, 33)
    x = x * _MIX_MUL
    return x ^ _lshr(x, 33)


def _combine_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ b) * _HASH_SEED + (a << 6)


def _bytes_hash_table(values) -> np.ndarray:
    """64-bit FNV-1a of every entry, as the JAX package's `_bytes_hash`
    computes one entry at a time, here vectorized over the entries by byte
    position (longest entries first, so the live entries are a prefix)."""
    entries = [bytes(v) for v in values]
    n = len(entries)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    lengths = np.fromiter(map(len, entries), dtype=np.int64, count=n)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    buf = np.frombuffer(b"".join(entries) + b"\0", dtype=np.uint8)
    order = np.argsort(-lengths, kind="stable")
    neg_len = -lengths[order]
    starts = starts[order]
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    with np.errstate(over="ignore"):
        for pos in range(int(-neg_len[0])):
            live = int(np.searchsorted(neg_len, -pos, side="left"))
            h[:live] = (h[:live] ^ buf[starts[:live] + pos]) * prime
    out[order] = h
    return out


# --- string patterns ---------------------------------------------------------


def _string_matcher(node: ir.TStringPredicate):
    pattern = node.pattern
    if node.kind == "prefix":
        return lambda v: v.startswith(pattern)
    if node.kind == "substr":
        return lambda v: pattern in v
    if node.kind == "regex":
        rx = _compile_regex(pattern, "regex predicate")
        return lambda v: rx.fullmatch(v) is not None
    if node.kind == "like":
        rx = _like_to_regex(pattern, node.case_insensitive)
        return lambda v: rx.fullmatch(v) is not None
    raise YtError(f"Unknown string predicate {node.kind!r}")


def _like_to_regex(pattern: bytes, case_insensitive: bool):
    """SQL LIKE → regex: % and _ are wildcards; a backslash escapes %, _
    or a backslash, and anything else after it is a pattern error."""
    out = []
    chars = pattern.decode("utf-8", errors="surrogateescape")
    i = 0
    while i < len(chars):
        ch = chars[i]
        if ch == "\\":
            if i + 1 >= len(chars) or chars[i + 1] not in "%_\\":
                raise YtError(
                    f"LIKE: invalid escape in pattern {pattern!r} "
                    f"(backslash must precede %, _ or \\)",
                    code=EErrorCode.QueryParseError)
            out.append(re.escape(chars[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
    return re.compile("".join(out).encode("utf-8", errors="surrogateescape"),
                      flags)


def _compile_regex(pattern: bytes, what: str):
    try:
        return re.compile(pattern)
    except re.error as exc:
        raise YtError(f"{what}: invalid regex {pattern!r}: {exc}",
                      code=EErrorCode.QueryParseError)


def _literal_bytes(arg, what: str) -> bytes:
    """A pattern or rewrite must be a literal string: it is compiled
    against the vocabulary at bind time."""
    if not isinstance(arg, ir.TLiteral) or \
            not isinstance(arg.value, (bytes, str)):
        raise YtError(f"{what} requires a literal string argument",
                      code=EErrorCode.QueryUnsupported)
    value = arg.value
    return value.encode() if isinstance(value, str) else value


def _literal_int(arg, what: str) -> int:
    if not isinstance(arg, ir.TLiteral) or not isinstance(arg.value, int):
        raise YtError(f"{what} requires a literal integer argument",
                      code=EErrorCode.QueryUnsupported)
    return arg.value


# --- calendar ----------------------------------------------------------------


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _days_to_civil(days: torch.Tensor):
    """Days since the epoch → (year, month, day), proleptic Gregorian (the
    civil-from-days algorithm in integer ops; `//` floors, as jnp's)."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _civil_to_days(y: torch.Tensor, m: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.remainder(m + 9, 12)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _timestamp_floor(ts: torch.Tensor, unit: str) -> torch.Tensor:
    """Floor unix seconds to a calendar boundary (weeks start Monday)."""
    if unit == "hour":
        return ts - torch.remainder(ts, 3600)
    if unit == "day":
        return ts - torch.remainder(ts, 86400)
    days = _fdiv(ts, 86400)
    if unit == "week":
        return (days - torch.remainder(days + 3, 7)) * 86400
    y, m, _ = _days_to_civil(days)
    one = torch.ones_like(m)
    if unit == "month":
        return _civil_to_days(y, m, one) * 86400
    return _civil_to_days(y, one, one) * 86400
