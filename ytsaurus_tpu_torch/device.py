"""Resolution of the `device=` argument of the port's entry points.

The port runs on the card unless the caller asks for the CPU. There is no
silent fallback: asking for a CUDA device on a machine without one raises.
"""

from __future__ import annotations

import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = DEFAULT_DEVICE
                   ) -> torch.device:
    """`device` as a torch.device; raises YtError when it names a CUDA
    device and no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise YtError(
                f"Device {str(dev)!r} was asked for but no CUDA device is "
                "present; pass device=\"cpu\" to run on the CPU",
                code=EErrorCode.InvalidConfig)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise YtError(f"Unsupported device {str(dev)!r}",
                      code=EErrorCode.InvalidConfig)
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type == "cpu" or a.index == b.index)


def resolve_for(chunk, device: "str | torch.device | None", what: str
                ) -> torch.device:
    """`device` resolved as by `resolve_device`; raises YtError unless the
    chunk (a ColumnarChunk) lies on it. `what` names the operation."""
    dev = resolve_device(device)
    if chunk.columns and not same_device(chunk.device, dev):
        raise YtError(f"Chunk lies on {chunk.device}, {what} runs on {dev}",
                      code=EErrorCode.InvalidConfig)
    return dev
