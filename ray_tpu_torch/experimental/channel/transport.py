"""Tiered per-edge transport for compiled-graph channels.

Counterpart of ``ray_tpu/experimental/channel/transport.py`` on CUDA.
Every cross-process edge gets a transport **tier**, negotiated once from
the two endpoints' placement and device info, and the payload encoding
and the read-side landing path follow the tier:

- **Tier A, fused** (``TIER_FUSED``): both endpoints are one process; the
  edge needs no channel.  Negotiation reports it for completeness.
- **Tier B, device** (``TIER_DEVICE``): both endpoints hold CUDA devices
  on one node.  Tensor payloads move as a *device frame*: pickle-5
  out-of-band buffers serialized straight into the shm segment, landed by
  the reader with an H2D copy **straight from the shm view** into a fresh
  tensor on its device (a CUDA reader page-locks its mapping of the
  segment, so the copy is DMA), the stream synchronised before the
  segment is released.  Between the devices of one process, :func:`device_ring_copy`
  moves each rank's tensor to its ring neighbour with K4
  (``ops/cuda/remote_copy.py``), the counterpart of the reference's
  ``ici_device_copy`` and of its Pallas form ``_pallas_remote_copy``.
  With ``RAY_TPU_TORCH_DEVICE_EMULATE=1``, CPU endpoints on one node
  negotiate this tier too, so its framing, alias guard and degradation run
  in the CPU tests.
- **Tier C, host** (``TIER_HOST``): the portable path.  Payloads serialize
  straight into the segment and the reader decodes owned copies before it
  acks.

**Alias guard.**  The segment is reused: the writer overwrites it as soon
as every reader acks.  A CPU tensor built on the shm view aliases it, so a
device-frame read copies (or, inside ``read_borrowed``, aliases only for
the borrow) and a CUDA landing synchronises its H2D copies before the
release.  The release is version-guarded: an overwrite while a view was
live raises instead of corrupting silently.

**Degradation ladder.**  A device-frame encode or decode failure flips the
transport to ``TIER_HOST`` (sticky, counted in ``stats["degraded"]``);
both encodings share one wire format (a marker word ahead of the payload),
so a degraded writer never desyncs its readers.

**Attribution.**  Every read books its wait to the ``channel_wait`` bucket
of a running step ledger (``_private/durations.py``) and to the health
plane's per-edge latency tracker (``util/health.note_edge_latency``,
keyed by the edge's name), which a rank's step records ship as
``edges``.  A borrowed read books its acquire and decode only: the
consumer's ``fn`` is not the channel's time.

**Native channels.**  The compiled DAG and :func:`make_edge_transport`
create their channels with ``native=False``: device frames serialize
straight into the segment and reads defer their ack, which the native
data plane cannot do.  A transport over a native channel writes staged
host frames through ``write_bytes`` and reads owned copies.

Each actor's endpoint info comes from one ``_remote_call`` round over the
process actors (:func:`gather_endpoint_info`, ``ray_tpu_torch.actor``).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import struct
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._private import durations, serialization
from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    Channel,
    ChannelClosedError,
)
from ray_tpu_torch.ops.cuda.remote_copy import (check_remote_copies,
                                                remote_copy)
from ray_tpu_torch.util.health import note_edge_latency

TIER_FUSED = "A-fused"
TIER_DEVICE = "B-device"
TIER_HOST = "C-shm"

#: arm the CPU emulation of tier B: CPU endpoints on one node negotiate
#: the device tier, so its framing, guard and degradation run on the CPU
ENV_EMULATE_DEVICE = "RAY_TPU_TORCH_DEVICE_EMULATE"

# frame layout: one 64-byte slot ahead of the serialized payload keeps the
# pickle-5 buffer alignment intact; word 0 is the encoding marker
_FRAME_HDR = 64
_MARK_HOST = 0
_MARK_DEVICE = 1


#: files that name this boot of the host's kernel, first found first: a
#: hostname alone is shared by containers made from one image
_HOST_ID_FILES = ("/proc/sys/kernel/random/boot_id", "/etc/machine-id")


def _emulate_device() -> bool:
    return os.environ.get(ENV_EMULATE_DEVICE, "") not in ("", "0", "false")


def _host_identity() -> str:
    """This host's identity for negotiation: the hostname and the kernel's
    boot id (or the machine id), so that two processes share it only when
    they run under one kernel on one host; the hostname alone where
    neither file can be read."""
    host = socket.gethostname()
    for path in _HOST_ID_FILES:
        try:
            with open(path) as f:
                ident = f.read().strip()
        except OSError:
            continue
        if ident:
            return f"{host}/{ident}"
    return host


# ---------------------------------------------------------------------------
# Endpoint placement and device info
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EndpointInfo:
    """Where one endpoint runs and what devices it holds.

    Device frames land from the node's shared memory and peer copies need
    the node's NVLink, so the reference's TPU ``slice_name`` has no field
    here: two CUDA endpoints reach each other's devices when their
    ``node_id`` (:func:`_host_identity`) is the same."""

    node_id: str = ""
    pid: int = 0
    platform: str = "none"       # "cuda", "cpu" under emulation, or "none"
    device_ids: Tuple[int, ...] = ()

    def holds_devices(self) -> bool:
        return self.platform not in ("", "none") and bool(self.device_ids)


def local_endpoint_info() -> EndpointInfo:
    """Probe THIS process without side effects: ``platform`` is "cuda"
    only when the process has already initialised CUDA (a probe must not
    create a CUDA context in a process that never uses the card).  Under
    the emulation a process without CUDA reports "cpu" with one synthetic
    device."""
    platform, device_ids = "none", ()
    if torch.cuda.is_initialized():
        platform = "cuda"
        device_ids = tuple(range(torch.cuda.device_count()))
    elif _emulate_device():
        platform, device_ids = "cpu", (0,)
    return EndpointInfo(node_id=_host_identity(), pid=os.getpid(),
                        platform=platform, device_ids=device_ids)


def _probe_endpoint(instance) -> EndpointInfo:
    """``_remote_call`` body: runs inside the actor process."""
    return local_endpoint_info()


def gather_endpoint_info(handles: Sequence[Any], *,
                         timeout: float = 30.0
                         ) -> Dict[Any, Optional[EndpointInfo]]:
    """One ``_remote_call`` round over the actor ``handles``: actor id ->
    its endpoint info.  A failed probe maps to None (its edges negotiate
    tier C)."""
    from ray_tpu_torch import actor

    refs = [h._remote_call.remote(_probe_endpoint) for h in handles]
    deadline = time.monotonic() + timeout
    out: Dict[Any, Optional[EndpointInfo]] = {}
    for h, ref in zip(handles, refs):
        try:
            out[h._actor_id] = actor.get(
                ref, timeout=max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 — probe failure: portable tier
            out[h._actor_id] = None
    return out


def negotiate(writer: Optional[EndpointInfo],
              reader: Optional[EndpointInfo]) -> str:
    """Pick the tier for one writer -> reader edge:

    - unknown endpoint (no info) -> ``TIER_HOST``;
    - same process -> ``TIER_FUSED``;
    - both endpoints hold CUDA devices on the same node -> ``TIER_DEVICE``;
    - emulation armed: both CPU endpoints on one node -> ``TIER_DEVICE``;
    - everything else -> ``TIER_HOST``.
    """
    if writer is None or reader is None:
        return TIER_HOST
    if writer.pid == reader.pid and writer.node_id == reader.node_id:
        return TIER_FUSED
    if (writer.platform == "cuda" and reader.platform == "cuda"
            and writer.holds_devices() and reader.holds_devices()
            and writer.node_id and writer.node_id == reader.node_id):
        return TIER_DEVICE
    if (_emulate_device() and writer.platform == "cpu"
            and reader.platform == "cpu"
            and writer.node_id == reader.node_id):
        return TIER_DEVICE
    return TIER_HOST


def negotiate_channel(writer: Optional[EndpointInfo],
                      readers: Sequence[Optional[EndpointInfo]]) -> str:
    """One channel serves every reader with a single wire encoding, so the
    channel's tier is the weakest of its edges: device frames only when
    EVERY reader negotiates the device tier."""
    tiers = [negotiate(writer, r) for r in readers]
    if tiers and all(t == TIER_DEVICE for t in tiers):
        return TIER_DEVICE
    return TIER_HOST


# ---------------------------------------------------------------------------
# Device payloads and the device ring hop
# ---------------------------------------------------------------------------


def _leaves(value: Any) -> Iterator[Any]:
    """The leaves of nested dicts, lists and tuples (None is no leaf)."""
    if isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    elif value is not None:
        yield value


def _is_device_payload(value: Any) -> bool:
    """True when the payload holds a tensor and no numpy array: the device
    frame's precondition.  A numpy leaf would come back as a zero-copy view
    of the reusable segment with no rebuild hook to guard it, so any numpy
    leaf forces the host encoding."""
    saw_tensor = False
    for leaf in _leaves(value):
        if isinstance(leaf, torch.Tensor):
            saw_tensor = True
        elif isinstance(leaf, np.ndarray):
            return False
    return saw_tensor


def device_ring_copy(shards: Sequence[torch.Tensor],
                     shift: int = 1) -> List[torch.Tensor]:
    """Move every rank's tensor ``shift`` steps around the ring: the
    in-process device leg of tier B, counterpart of the reference's
    ``ici_device_copy``.

    ``shards[i]`` is rank i's tensor on rank i's device; the result is the
    shifted list, ``out[(i + shift) % n]`` equal to ``shards[i]`` and on
    rank ``(i + shift) % n``'s device.  On CUDA each hop is one launch of
    K4, which stores into the neighbour's memory on the same card or over
    NVLink.  A hop within one card is ordered by the card's stream alone;
    a hop onto another card also queues a wait on that card's stream, and
    the call then checks the waits and raises if one ran out.  On the CPU
    each hop is K4's plain version."""
    n = len(shards)
    out: List[Optional[torch.Tensor]] = [None] * n
    for i, x in enumerate(shards):
        j = (i + shift) % n
        out[j] = torch.empty_like(x, device=shards[j].device)
        remote_copy(x, out[j])
    if any(x.is_cuda for x in shards):
        check_remote_copies()
    return out


# ---------------------------------------------------------------------------
# The per-edge transport
# ---------------------------------------------------------------------------


class EdgeTransport:
    """One edge's data plane: a :class:`Channel`, the negotiated tier and
    the reader's device (``None``: the card).  Picklable."""

    def __init__(self, channel: Channel, tier: str = TIER_HOST,
                 edge: str = "", device=None):
        self.channel = channel
        self.tier = tier
        self.edge = edge
        self.device = None if device is None else torch.device(device)
        self.stats = {"sends": 0, "recvs": 0, "bytes_sent": 0,
                      "write_wait_s": 0.0, "read_wait_s": 0.0,
                      "device_frames": 0, "degraded": 0,
                      # the last read's decode (its landing), waits aside
                      "last_land_s": 0.0}

    @property
    def name(self) -> str:
        return self.channel.name

    def set_reader_slot(self, slot: int) -> "EdgeTransport":
        self.channel.set_reader_slot(slot)
        return self

    def close(self) -> None:
        """Close the channel: every peer's waits raise
        ``ChannelClosedError`` from now on."""
        self.channel.close()

    def destroy(self) -> None:
        self.channel.destroy()

    def __reduce__(self):
        return (_rebuild_transport,
                (self.channel, self.tier, self.edge,
                 None if self.device is None else str(self.device)))

    # -- data plane ---------------------------------------------------------
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        try:
            if not self.channel.supports_zero_copy:
                n = self._write_frame_staged(value, timeout)
            elif self.tier == TIER_DEVICE and _is_device_payload(value):
                try:
                    n = self._write_frame(value, _MARK_DEVICE, timeout)
                    self.stats["device_frames"] += 1
                except (ChannelClosedError, ValueError, TimeoutError):
                    raise  # lifecycle, size, deadline: not a tier problem
                except Exception:  # noqa: BLE001 — degrade, don't drop
                    self._degrade("device-frame encode failed")
                    n = self._write_frame(value, _MARK_HOST, timeout)
            else:
                n = self._write_frame(value, _MARK_HOST, timeout)
            self.stats["sends"] += 1
            self.stats["bytes_sent"] += n
        finally:
            self.stats["write_wait_s"] += time.perf_counter() - t0

    def read(self, timeout: Optional[float] = None) -> Any:
        """The next value, owned: nothing in it aliases the segment."""
        t0 = time.perf_counter()
        try:
            if self.channel.supports_zero_copy:
                view, version = self.channel.read_acquire(timeout)
                t_land = time.perf_counter()
                try:
                    value = self._decode(view)
                finally:
                    self.channel.read_release(version)
            else:  # the native plane: an owned copy of the frame
                view = memoryview(self.channel.read_bytes(timeout))
                t_land = time.perf_counter()
                value = self._decode(view)
            self.stats["recvs"] += 1
            self.stats["last_land_s"] = time.perf_counter() - t_land
            return value
        finally:
            self._note_wait(time.perf_counter() - t0)

    def read_borrowed(self, fn, timeout: Optional[float] = None) -> Any:
        """Device-landing read: apply ``fn`` to the value while it still
        *borrows* the channel buffer, then release.  Device-frame tensors
        land on a CUDA reader by an H2D copy straight from the shm view (no
        host copy), and on a CPU reader alias the segment for the borrow.
        ``fn`` must consume the value (reduce it, feed it to a step, copy
        what it keeps): retaining it past the borrow would read a buffer
        the writer reuses.  The reader's stream is synchronised before the
        release, so queued work cannot outlive the buffer, and the release
        is version-guarded: an overwrite while ``fn`` runs raises."""
        if not self.channel.supports_zero_copy:
            return fn(self.read(timeout))  # read books its own wait
        t0 = time.perf_counter()
        dt = None  # acquire + decode only: fn's compute is the consumer's
        try:
            device = self._landing_device()
            view, version = self.channel.read_acquire(timeout)
            try:
                marker = struct.unpack_from("<Q", view, 0)[0]
                with serialization.device_rebuild_guard(
                        borrow=(marker == _MARK_DEVICE)):
                    value = serialization.deserialize(
                        view[_FRAME_HDR:], zero_copy=(marker == _MARK_DEVICE),
                        device=device)
                dt = time.perf_counter() - t0
                out = fn(value)
                del value
            finally:
                # whether or not fn returned: no copy from the segment may
                # still be in flight once the writer can reuse it
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                self.channel.read_release(version)
            self.stats["recvs"] += 1
            return out
        finally:
            self._note_wait(time.perf_counter() - t0 if dt is None else dt)

    # -- internals ----------------------------------------------------------
    def _note_wait(self, dt: float) -> None:
        """Book one read's wait: the transport's counter, the
        ``channel_wait`` bucket of a running step ledger, and the edge's
        latency in the health plane's tracker (best effort)."""
        self.stats["read_wait_s"] += dt
        durations.note_duration("channel_wait", dt)
        try:
            note_edge_latency(self.edge or self.channel.name, dt)
        except Exception:  # noqa: BLE001 — evidence stays best-effort
            pass
    def _landing_device(self) -> torch.device:
        """The reader's device; a CUDA reader page-locks its mapping of the
        segment on first use, so device frames land by DMA from shm."""
        device = resolve_device(self.device)
        if device.type == "cuda":
            self.channel.pin_for_cuda()
        return device

    def _degrade(self, why: str) -> None:
        if self.tier != TIER_HOST:
            import logging

            logging.getLogger(__name__).warning(
                "channel %s: %s; edge degrades %s -> %s",
                self.edge or self.channel.name, why, self.tier, TIER_HOST)
            self.tier = TIER_HOST
            self.stats["degraded"] += 1

    def _write_frame(self, value: Any, marker: int,
                     timeout: Optional[float]) -> int:
        core, raw_bufs, total = serialization.serialize_parts(value)
        buf = self.channel.acquire_write_buffer(_FRAME_HDR + total, timeout)
        struct.pack_into("<Q", buf, 0, marker)
        serialization.write_parts(buf[_FRAME_HDR:], core, raw_bufs)
        self.channel.commit_write(_FRAME_HDR + total)
        return total

    def _write_frame_staged(self, value: Any,
                            timeout: Optional[float]) -> int:
        """A host frame built in a buffer of its own, then handed to the
        native plane's ``write_bytes``."""
        core, raw_bufs, total = serialization.serialize_parts(value)
        out = bytearray(_FRAME_HDR + total)
        struct.pack_into("<Q", out, 0, _MARK_HOST)
        serialization.write_parts(memoryview(out)[_FRAME_HDR:], core,
                                  raw_bufs)
        self.channel.write_bytes(out, timeout)
        return total

    def _decode(self, view: memoryview) -> Any:
        """Decode one frame into owned values on the reader's device."""
        marker = struct.unpack_from("<Q", view, 0)[0]
        payload = view[_FRAME_HDR:]
        device = self._landing_device()
        if marker == _MARK_DEVICE:
            try:
                # device landing: straight from the shm view, copies done
                # before the buffer is released
                with serialization.device_rebuild_guard() as guard:
                    value = serialization.deserialize(
                        payload, zero_copy=True, device=device)
                guard.synchronize()
                return value
            except Exception:  # noqa: BLE001 — decode trouble: host path
                self._degrade("device-frame decode failed")
        return serialization.deserialize(payload, zero_copy=False,
                                         device=device)


def _rebuild_transport(channel: Channel, tier: str, edge: str,
                       device: Optional[str]) -> EdgeTransport:
    return EdgeTransport(channel, tier, edge, device)


def make_edge_transport(*, tier: str, edge: str = "",
                        buffer_size: int = 1 << 20,
                        num_readers: int = 1) -> EdgeTransport:
    """Create the writer-side transport for one negotiated edge, on a
    channel of the Python data plane (``native=False``): device frames and
    deferred-ack reads need direct access to the segment."""
    return EdgeTransport(Channel(buffer_size=buffer_size,
                                 num_readers=num_readers, native=False),
                         tier, edge)


def attach_edge_transport(transport: EdgeTransport, slot: int,
                          device=None) -> EdgeTransport:
    """Reader-side attach: the transport on a channel handle of its own
    (each reader owns an ack slot), landing values on ``device`` (``None``:
    the card; the CPU only when asked for)."""
    ch = Channel(transport.channel.name,
                 buffer_size=transport.channel.buffer_size,
                 num_readers=transport.channel.num_readers, _create=False)
    ch.set_reader_slot(slot)
    return EdgeTransport(ch, transport.tier, transport.edge,
                         resolve_device(device))
