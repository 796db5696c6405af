"""Process groups: the port's counterpart of the JAX package's device mesh.

Port of the JAX package's `parallel/mesh.py`. The reference places table
shards on a single-controller JAX `Mesh` of n devices and moves data with
XLA collectives under `shard_map`. PyTorch has no single controller: a mesh
here is a `torch.distributed` process group, one process per shard, and
every process runs the same code (the SPMD program the reference traces
once). A `Mesh` holds the group, this process's rank, the world size and
the rank's device, and the two collectives the mesh paths use:

  all_gather   one `all_gather_single` (`all_gather_into_tensor` before
               torch renamed it; the reference's all_gather)
  all_to_all   one `all_to_all_single` with exact split sizes (the
               reference's all_to_all over fixed quota blocks)

The backend follows the device: "cuda" means NCCL, "cpu" means gloo. Either
may be named explicitly; gloo also takes a CUDA device where the installed
torch can hand CUDA tensors to gloo. There is no silent switch: a card that
is asked for and absent raises (`device.resolve_device`), and so does a
backend that cannot take the device.

Boolean planes cross the collectives as uint8 views (neither NCCL nor gloo
has a boolean type); every other dtype crosses as it is.

The reference's `compat.py` (its `shard_map` import shim) has no
counterpart: nothing here is traced.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

def _mesh_error(msg: str) -> YtError:
    return YtError(msg, code=EErrorCode.InvalidConfig)


@dataclass(frozen=True)
class Mesh:
    """One process's view of a 1-D mesh over table shards."""

    group: "dist.ProcessGroup | None"   # None: the default group
    rank: int
    size: int
    device: torch.device
    backend: str

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's `tensor` (same shape on every rank), concatenated
        along dim 0 in rank order."""
        src = _wire(tensor.contiguous())
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _all_gather_single(out, src, group=self.group)
        return _unwire(out, tensor.dtype)

    def all_to_all(self, tensor: torch.Tensor, send_splits: Sequence[int],
                   recv_splits: Sequence[int],
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows [sum(send_splits[:d]), +send_splits[d]) of `tensor` go to
        rank d; the rows received lie source-major (rank 0's first). `out`
        (optional) receives them: its first sum(recv_splits) rows."""
        n_recv = int(sum(recv_splits))
        if out is None:
            out = torch.empty((n_recv,) + tuple(tensor.shape[1:]),
                              dtype=tensor.dtype, device=tensor.device)
        dst = _wire(out[:n_recv])
        dist.all_to_all_single(dst, _wire(tensor.contiguous()),
                               output_split_sizes=[int(s) for s in
                                                   recv_splits],
                               input_split_sizes=[int(s) for s in
                                                  send_splits],
                               group=self.group)
        return out


# torch renamed all_gather_into_tensor to all_gather_single (same
# arguments) and deprecated the old name; take the new one where it exists.
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def make_mesh(device: "str | torch.device" = DEFAULT_DEVICE,
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: int = 0, world_size: int = 1,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """A mesh over the default process group, which this call initializes
    unless it is already up (then `rank`, `world_size` and `init_method`
    come from it). A world of one needs no `init_method`: its store lives
    in this process. Give every process of a larger world the same
    `init_method` ("tcp://localhost:<port>" or "file://<path>") and its
    own rank."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise _mesh_error(f"Unsupported mesh backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise _mesh_error("The NCCL backend needs a CUDA device, the mesh "
                          f"was asked for {str(dev)!r}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise _mesh_error("This torch has no NCCL backend")
    if backend == "gloo" and not dist.is_gloo_available():
        raise _mesh_error("This torch has no gloo backend")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise _mesh_error(f"The process group runs {dist.get_backend()}, "
                              f"the mesh was asked for {backend}")
    else:
        kwargs = {} if timeout is None else {"timeout": timeout}
        if init_method is None:
            if world_size != 1:
                raise _mesh_error("A mesh of several processes needs an "
                                  "init_method")
            kwargs["store"] = dist.HashStore()
        else:
            kwargs["init_method"] = init_method
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(backend, rank=rank, world_size=world_size,
                                **kwargs)
    return Mesh(group=None, rank=dist.get_rank(),
                size=dist.get_world_size(), device=dev, backend=backend)


def destroy_mesh() -> None:
    """Tear down the default process group, if it is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
