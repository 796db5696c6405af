"""The dense GROUP BY's reductions on the card: `csrc/dense_reduce.cu`.

`dense_reduce` takes every reduction of a group stage over at most
MAX_SEGMENTS segments (counts, sums, mins and maxes of int64 and float64
planes) and computes them all in one pass over the rows and a fold: two
kernels, whatever the number of reductions or segments. It runs only on a
CUDA tensor and raises on any other; the plain version is the per-segment
loop of `ops/segments.py`, which `segments.segment_reduce_many` runs on the
CPU. The result is the same on every run; float sums add in another order
than the plain version's.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

MAX_SEGMENTS = 16
# Jobs a launch carries in its parameters; more take several launches.
MAX_JOBS = 64
_OPS = {("count", False): 0, ("sum", False): 1, ("sum", True): 2,
        ("min", False): 3, ("max", False): 4, ("min", True): 5,
        ("max", True): 6}

# Launches since the last reset, each the pass and its fold (a call of
# dense_reduce makes one for every MAX_JOBS jobs), so that a run can show
# that its group stages went through the kernel.
launches = {"dense_reduce": 0}


def reset_launches() -> None:
    launches["dense_reduce"] = 0


def _fail(msg: str) -> YtError:
    return YtError(msg, code=EErrorCode.QueryExecutionError,
                   attributes={"kernel": "dense_reduce"})


def _bits(value, is_float: bool) -> int:
    """A neutral value as the int64 bit pattern the kernel starts from."""
    if is_float:
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    return int(value)


def _plane(t: torch.Tensor, n: int):
    """(plane, stride): the rows as a contiguous tensor of n rows (stride
    1), or one value broadcast to every row (stride 0)."""
    if t.dim() != 1:
        t = t.reshape(-1)
    if t.shape[0] != n or (n > 1 and t.stride(0) == 0):
        if t.shape[0] != 1 and t.stride(0) != 0:
            raise _fail(f"dense_reduce takes planes of {n} rows or one, "
                        f"got {t.shape[0]}")
        return t[:1].contiguous(), 0
    return t.contiguous(), 1


def dense_reduce(jobs, seg_ids: torch.Tensor, num_segments: int,
                 width: "int | None" = None) -> torch.Tensor:
    """jobs: (function, data, valid, init). function is "count" (data
    None: the valid rows), "sum", "min" or "max"; data an int64 or float64
    plane; valid a bool plane; a plane has as many rows as seg_ids, or
    one, broadcast. init is the neutral value each segment
    starts from (a Python number). Returns (len(jobs), width) int64 (width
    defaults to num_segments): row j is job j's result per segment,
    float64 bit patterns for a float plane, and zero past the last
    segment. Rows whose segment id lies outside [0, num_segments) count in
    no segment."""
    if seg_ids.device.type != "cuda":
        raise _fail(f"dense_reduce runs on a CUDA tensor, got "
                    f"{seg_ids.device}")
    width = num_segments if width is None else width
    if not 1 <= num_segments <= min(MAX_SEGMENTS, width):
        raise _fail(f"dense_reduce takes 1 to {MAX_SEGMENTS} segments, at "
                    f"most its width {width}, got {num_segments}")
    n = seg_ids.shape[0]
    dev = seg_ids.device
    seg = seg_ids.to(torch.int64).contiguous()
    if width > num_segments:
        out = torch.zeros((len(jobs), width), dtype=torch.int64, device=dev)
    else:
        out = torch.empty((len(jobs), width), dtype=torch.int64, device=dev)
    for start in range(0, len(jobs), MAX_JOBS):
        _launch(jobs[start:start + MAX_JOBS], seg, n, num_segments,
                out[start:start + MAX_JOBS])
    return out


def _launch(jobs, seg, n, num_segments, out):
    from ytsaurus_tpu_torch import _build
    count = len(jobs)
    keep = []                         # the planes, alive through the launch
    data = (ctypes.c_longlong * count)()
    valid = (ctypes.c_longlong * count)()
    init = (ctypes.c_longlong * count)()
    op = (ctypes.c_int * count)()
    stride = (ctypes.c_int * count)()
    for j, (function, d, v, neutral) in enumerate(jobs):
        is_float = d is not None and d.dtype == torch.float64
        if (function, is_float) not in _OPS or v.dtype != torch.bool or \
                (function == "count") != (d is None) or \
                (d is not None and d.dtype not in (torch.int64,
                                                   torch.float64)):
            raise _fail(f"dense_reduce has no {function!r} over "
                        f"{None if d is None else d.dtype} data and "
                        f"{v.dtype} validity")
        op[j] = _OPS[(function, is_float)]
        init[j] = _bits(neutral, is_float)
        flags = 0
        for plane, bit, slot in ((d, 1, data), (v, 2, valid)):
            if plane is None:         # a count's data
                continue
            if plane.device != seg.device:
                raise _fail(f"dense_reduce planes on {seg.device} and "
                            f"{plane.device}")
            plane, s = _plane(plane, n)
            keep.append(plane)
            slot[j] = plane.data_ptr()
            flags |= bit * s
        stride[j] = flags
    fn = _build.function(
        "dense_reduce", "dense_reduce_launch",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p])
    blocks = _build.function("dense_reduce", "dense_reduce_blocks",
                             [ctypes.c_longlong])(n)
    partial = torch.empty(blocks * count * MAX_SEGMENTS,
                          dtype=torch.int64, device=seg.device)
    with torch.cuda.device(seg.device):
        err = fn(count, data, valid, init, op, stride, seg.data_ptr(), n,
                 num_segments, partial.data_ptr(), out.data_ptr(),
                 out.shape[1],
                 torch.cuda.current_stream(seg.device).cuda_stream)
    if err != 0:
        raise _fail(f"dense_reduce kernel launch failed (CUDA error {err})")
    launches["dense_reduce"] += 1
