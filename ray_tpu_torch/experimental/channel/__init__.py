"""Compiled-graph channels: shm channels, per-edge tiered transports and
the communicators (counterpart of ``ray_tpu/experimental/channel/``)."""

from ray_tpu_torch.experimental.channel.communicator import (
    Communicator,
    CpuCommunicator,
    CudaCommunicator,
)
from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
    CompositeChannel,
)
from ray_tpu_torch.experimental.channel.transport import (
    TIER_DEVICE,
    TIER_FUSED,
    TIER_HOST,
    EdgeTransport,
    EndpointInfo,
    attach_edge_transport,
    device_ring_copy,
    gather_endpoint_info,
    local_endpoint_info,
    make_edge_transport,
    negotiate,
    negotiate_channel,
)

__all__ = [
    "Channel", "ChannelClosedError", "ChannelTimeoutError",
    "Communicator", "CompositeChannel", "CpuCommunicator",
    "CudaCommunicator", "EdgeTransport", "EndpointInfo", "TIER_DEVICE",
    "TIER_FUSED", "TIER_HOST", "attach_edge_transport", "device_ring_copy",
    "gather_endpoint_info", "local_endpoint_info", "make_edge_transport",
    "negotiate", "negotiate_channel",
]
