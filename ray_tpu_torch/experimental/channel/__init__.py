"""Compiled-graph channels: shm channels and per-edge tiered transports.

Counterpart of ``ray_tpu/experimental/channel/``.  Not ported yet: the
communicators (``Communicator``, ``CpuCommunicator``, ``TpuCommunicator``
wait for the NCCL collectives), ``CompositeChannel`` and
``gather_endpoint_info`` (which needs actors).
"""

from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
from ray_tpu_torch.experimental.channel.transport import (
    TIER_DEVICE,
    TIER_FUSED,
    TIER_HOST,
    EdgeTransport,
    EndpointInfo,
    attach_edge_transport,
    device_ring_copy,
    local_endpoint_info,
    make_edge_transport,
    negotiate,
    negotiate_channel,
)

__all__ = [
    "Channel", "ChannelClosedError", "ChannelTimeoutError",
    "EdgeTransport", "EndpointInfo", "TIER_DEVICE", "TIER_FUSED",
    "TIER_HOST", "attach_edge_transport", "device_ring_copy",
    "local_endpoint_info", "make_edge_transport", "negotiate",
    "negotiate_channel",
]
