"""Host RPC plane: framed multipart packets over TCP + a service/channel
layer — the control-plane half of the reference's bus/RPC split.

Own copy of the JAX package's `rpc/`: the same packets byte for byte and
the same envelopes, so a channel of either package calls a server of the
other. It is host code only; a handler that reaches the card passes the
cluster's device explicitly.

Ref mapping (design, not translation):
  framed multipart packets w/ per-part checksums  → rpc/packet.py
    (core/bus/tcp/packet.h:9)
  TTcpConnection multiplexing                     → rpc/channel.py
    (core/bus/tcp/connection.h)
  service method registry + concurrency limits    → rpc/server.py
    (core/rpc/service_detail.h)
  retrying channels                               → rpc/channel.py
    (core/rpc/retrying_channel.h)

The data plane deliberately does NOT ride on this: rowset movement between
devices is torch.distributed collectives (parallel/); this bus carries
metadata, driver commands and their rows.  Bodies are binary YSON;
bulk bytes travel as zero-copy attachment parts.
"""

from ytsaurus_tpu_torch.rpc.channel import (
    Channel,
    FailoverChannel,
    HedgingChannel,
    RetryingChannel,
)
from ytsaurus_tpu_torch.rpc.packet import PacketError, read_packet, write_packet
from ytsaurus_tpu_torch.rpc.server import RpcServer, Service, rpc_method

__all__ = [
    "Channel", "FailoverChannel", "HedgingChannel", "RetryingChannel",
    "PacketError", "read_packet", "write_packet", "RpcServer", "Service",
    "rpc_method",
]
