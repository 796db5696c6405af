"""Erasure coding: systematic Reed–Solomon and LRC over GF(2^8).

Port of the JAX package's `chunks/erasure.py` (the GF(2^8) tables over the
polynomial 0x11D with generator 2, the systematic Vandermonde generator,
`ErasureCodec` with `encode`, `decode`, `locality_group` and
`repair_part`, the greedy full-rank row selection, the LRC generator and
`get_erasure_codec` for `rs_6_3`, `rs_3_2` and `lrc_12_2_2`), with the
`chunks.erasure.decode` failpoint site. For the same blob and codec every
part is byte for byte the reference's, and the same erasure patterns are
refused with the same error code.

Ref: library/cpp/erasure (codecs RS(6,3), LRC(12,2,2) via ISA-L/Jerasure,
wrapped by yt/yt/library/erasure). rs_6_3 matches the reference's default
storage codec shape; lrc_12_2_2 is the production-default family: 12 data
parts in two locality groups of 6, one XOR parity per group (a single
lost part repairs from its group alone) plus two Vandermonde global
parities (every 3-erasure pattern and many 4-erasure patterns
reconstruct).

The codec is host numpy, as the reference's is. One difference of means,
not of result: a product of a byte plane by a constant is one lookup in
that constant's row of a 256 x 256 product table (built from the same
log and exp tables), where the reference takes logs, adds and
exponentiates per product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import failpoints

_FP_DECODE = failpoints.register_site(
    "chunks.erasure.decode",
    error=lambda s: YtError(f"injected erasure decode failure at {s}",
                            code=EErrorCode.ChunkFormatError))

# --- GF(2^8) arithmetic (poly 0x11D, generator 2) ----------------------------

_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]

# _MUL[c, x] = c * x in GF(2^8): row c is the product-by-c lookup table.
_MUL = np.zeros((256, 256), dtype=np.uint8)
_MUL[1:, 1:] = _EXP[(_LOG[1:, None] + _LOG[None, 1:]) % 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_EXP[255 - _LOG[a]])


def _gf_matmul_vec(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(r, k) GF matrix × (k, n) byte planes → (r, n)."""
    r, k = matrix.shape
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(k):
            c = int(matrix[i, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= data[j]
            else:
                acc ^= _MUL[c][data[j]]
    return out


def _gf_constant_mul(row: np.ndarray, c: int) -> np.ndarray:
    return _MUL[c][row]


def _gf_gauss_invert(matrix: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan elimination."""
    n = matrix.shape[0]
    aug = np.concatenate(
        [matrix.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise YtError("Singular matrix during erasure repair",
                          code=EErrorCode.ChunkFormatError)
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = _gf_inv(int(aug[col, col]))
        aug[col] = _gf_constant_mul(aug[col], inv)
        for row in range(n):
            if row != col and aug[row, col] != 0:
                factor = int(aug[row, col])
                aug[row] ^= _gf_constant_mul(aug[col], factor)
    return aug[:, n:]


def _gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * e) % 255])


def _systematic_generator(k: int, m: int) -> np.ndarray:
    """(k+m, k) systematic generator: top k rows identity, bottom m parity.

    Vandermonde over distinct evaluation points 0..k+m-1 (any k rows are
    independent), right-multiplied by the inverse of its top k×k block.
    """
    v = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k + m):
        for j in range(k):
            v[i, j] = _gf_pow(i, j)
    top_inv = _gf_gauss_invert(v[:k].copy())
    return _gf_matrix_mul(v, top_inv)


def _gf_matrix_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    r, k = a.shape
    k2, c = b.shape
    assert k == k2
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            acc = 0
            for t in range(k):
                acc ^= _gf_mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


@dataclass(frozen=True)
class ErasureCodec:
    name: str
    data_parts: int          # k
    parity_parts: int        # m
    generator: np.ndarray    # (k+m, k) systematic
    # Locality groups (LRC): part-index tuples whose members XOR to
    # zero, so any single member rebuilds from the rest of its group.
    # Empty for MDS codes (RS).
    groups: "tuple[tuple[int, ...], ...]" = ()

    @property
    def total_parts(self) -> int:
        return self.data_parts + self.parity_parts

    # -- encode ----------------------------------------------------------------

    def encode(self, blob: bytes) -> list[bytes]:
        """Split into k data parts (padded) + m parity parts.  Part 0 carries
        no length header; callers must remember the original byte length."""
        return self.encode_parts(blob, range(self.total_parts))

    def encode_parts(self, blob: bytes,
                     indices: Sequence[int]) -> list[bytes]:
        """The parts at `indices` of `encode(blob)`, computing only the
        parity rows asked for (repair-on-read rewrites just the lost
        parts)."""
        k = self.data_parts
        part_len = (len(blob) + k - 1) // k
        part_len = max(part_len, 1)
        data = np.frombuffer(
            blob.ljust(k * part_len, b"\0"), dtype=np.uint8).reshape(k, part_len)
        parity_rows = [i for i in indices if i >= k]
        parity = dict(zip(parity_rows, _gf_matmul_vec(
            self.generator[parity_rows], data))) if parity_rows else {}
        return [data[i].tobytes() if i < k else parity[i].tobytes()
                for i in indices]

    # -- decode / repair -------------------------------------------------------

    def decode(self, parts: Sequence[Optional[bytes]], size: int) -> bytes:
        """Reconstruct the original blob from a recoverable subset of
        parts. Row selection is rank-aware: for MDS codes (RS) any k parts
        work; for LRC some k-subsets are dependent (e.g. both local
        parities against erasures concentrated in one group), so the
        decoder picks an invertible row set from everything available
        instead of blindly taking the first k."""
        _FP_DECODE.hit()
        return self._data_matrix(parts).reshape(-1).tobytes()[:size]

    def _data_matrix(self, parts: Sequence[Optional[bytes]]) -> np.ndarray:
        k = self.data_parts
        available = [i for i, p in enumerate(parts) if p is not None]
        if available[: k] == list(range(k)):
            return np.stack([np.frombuffer(parts[i], dtype=np.uint8)
                             for i in range(k)])
        use = _select_invertible_rows(self.generator, available, k)
        if use is None:
            raise YtError(
                f"Erasure decode: available parts {available} do not "
                f"span the data (codec {self.name}); unrecoverable "
                "erasure pattern", code=EErrorCode.ChunkFormatError)
        sub = self.generator[use]                        # (k, k)
        inv = _gf_gauss_invert(sub)
        received = np.stack([np.frombuffer(parts[i], dtype=np.uint8)
                             for i in use])
        return _gf_matmul_vec(inv, received)

    def locality_group(self, index: int) -> "Optional[list[int]]":
        """The part indices whose XOR rebuilds `index` (its locality
        group minus `index`); None when the codec has no locality
        structure or the part belongs to no group (global parity)."""
        for group in self.groups:
            if index in group:
                return [m for m in group if m != index]
        return None

    def repair_part(self, parts: Sequence[Optional[bytes]],
                    index: int) -> bytes:
        """Rebuild ONE part. LRC's locality benefit: a part inside a
        locality group XOR-repairs from the 6 other group members (the
        other group and the global parities may be unavailable); the
        general path reconstructs the data matrix and re-encodes."""
        group = self.locality_group(index)
        if group is not None and all(parts[m] is not None for m in group):
            acc = np.frombuffer(parts[group[0]], dtype=np.uint8).copy()
            for m in group[1:]:
                acc ^= np.frombuffer(parts[m], dtype=np.uint8)
            return acc.tobytes()
        data = self._data_matrix(parts)
        return _gf_matmul_vec(self.generator[index: index + 1],
                              data)[0].tobytes()


def _select_invertible_rows(generator: np.ndarray, available: list,
                            k: int) -> "Optional[list]":
    """Greedy full-rank row selection over GF(2^8): walk the available
    generator rows, keep each row that is independent of those already
    kept (Gaussian reduction), stop at k. Prefers data rows (identity —
    cheapest) because `available` is index-ordered."""
    chosen: list = []
    basis: list = []            # reduced rows with their pivot columns
    for idx in available:
        row = generator[idx].astype(np.uint8).copy()
        for pivot_col, basis_row in basis:
            if row[pivot_col]:
                row = row ^ _gf_constant_mul(basis_row, int(row[pivot_col]))
        nz = np.nonzero(row)[0]
        if len(nz) == 0:
            continue            # dependent on rows already chosen
        pivot = int(nz[0])
        row = _gf_constant_mul(row, _gf_inv(int(row[pivot])))
        basis.append((pivot, row))
        chosen.append(idx)
        if len(chosen) == k:
            return chosen
    return None


def _lrc_generator() -> np.ndarray:
    """LRC(12,2,2): identity for the 12 data parts, one XOR row per
    locality group of 6 (parts 12, 13), two Vandermonde global parity
    rows over distinct nonzero field elements (parts 14, 15). Distinct
    alphas make every within-group Vandermonde minor invertible, so all
    3-erasure patterns reconstruct; squaring is a field automorphism, so
    the second global row stays independent."""
    k = 12
    rows = [np.eye(k, dtype=np.uint8)]
    l0 = np.array([1] * 6 + [0] * 6, dtype=np.uint8)
    l1 = np.array([0] * 6 + [1] * 6, dtype=np.uint8)
    alphas = [int(_EXP[i]) for i in range(k)]       # 2^i, all distinct
    g0 = np.array(alphas, dtype=np.uint8)
    g1 = np.array([_gf_mul(a, a) for a in alphas], dtype=np.uint8)
    rows.append(np.stack([l0, l1, g0, g1]))
    return np.vstack(rows)


_CODECS: dict[str, ErasureCodec] = {}


def get_erasure_codec(name: str) -> ErasureCodec:
    codec = _CODECS.get(name)
    if codec is None:
        if name == "rs_6_3":
            codec = ErasureCodec("rs_6_3", 6, 3, _systematic_generator(6, 3))
        elif name == "rs_3_2":
            codec = ErasureCodec("rs_3_2", 3, 2, _systematic_generator(3, 2))
        elif name == "lrc_12_2_2":
            codec = ErasureCodec(
                "lrc_12_2_2", 12, 4, _lrc_generator(),
                groups=(tuple(range(0, 6)) + (12,),
                        tuple(range(6, 12)) + (13,)))
        else:
            raise YtError(f"Unknown erasure codec {name!r}",
                          code=EErrorCode.ChunkFormatError)
        _CODECS[name] = codec
    return codec
