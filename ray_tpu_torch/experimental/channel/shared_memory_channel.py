"""Mutable shared-memory channels: the compiled-graph data plane.

Counterpart of ``ray_tpu/experimental/channel/shared_memory_channel.py``
(the pure-Python data plane), with the same segment layout and protocol,
so one segment serves a writer and readers of either package.  One
writer, N readers, a single versioned buffer in POSIX shm::

    [u64 version][u64 payload_len][u64 n_readers][u64 ack[r] ...][payload]

Protocol (seqlock-flavoured; no cross-process locks, because there is
exactly one writer and each reader owns its ack slot):

- write: wait until every ``ack[r] == version`` (all readers consumed the
  previous value), write the payload, set ``version += 2``.
- read (reader r): wait until ``version > ack[r]``, use the payload, set
  ``ack[r] = version``.

The high bit of the ``n_readers`` word marks the channel closed; the
writer never stores to that word, so a close is sticky even mid-write.
Waits are a short hot spin, then sleeps that back off from 0.1 ms to 1 ms.

:class:`CompositeChannel` reads several channels as one tuple.

Not ported: the reference's native data plane (``ray_tpu/_native/``
channel.cc, the ``_NATIVE_BIT`` mode); a segment created in native mode
is refused here.
"""

from __future__ import annotations

import struct
import time
import uuid
from typing import Any, List, Optional, Tuple

from ray_tpu_torch._private.shm import open_shm

_U64 = struct.Struct("<Q")
_HDR = 24  # version, payload_len, n_readers
_CLOSED_BIT = 1 << 63  # high bit of the n_readers word: channel torn down
_NATIVE_BIT = 1 << 62  # the reference's native data plane owns the segment
# a wait's sleeps after its hot spin: from the first to the longest
_SLEEP_MIN_S = 0.0001
_SLEEP_MAX_S = 0.001


class ChannelTimeoutError(TimeoutError):
    pass


class ChannelClosedError(RuntimeError):
    pass


# Writer-side copy accounting: every memcpy of payload bytes into the
# segment adds here, so a path that reintroduces an intermediate staging
# copy shows up as bytes_copied ~ 2x payload instead of ~ 1x.
COPY_STATS = {"bytes_copied": 0, "payloads": 0, "payload_bytes": 0}


def _count_copy(nbytes: int, payload: Optional[int] = None) -> None:
    COPY_STATS["bytes_copied"] += nbytes
    if payload is not None:
        COPY_STATS["payloads"] += 1
        COPY_STATS["payload_bytes"] += payload


def reset_copy_stats() -> None:
    COPY_STATS.update(bytes_copied=0, payloads=0, payload_bytes=0)


class Channel:
    """Handle to one shm channel; picklable (reattaches by name)."""

    def __init__(self, name: Optional[str] = None, *,
                 buffer_size: int = 1 << 20, num_readers: int = 1,
                 _create: bool = True):
        self.name = name or f"rtpu_ch_{uuid.uuid4().hex[:16]}"
        self.buffer_size = buffer_size
        self.num_readers = num_readers
        self._reader_slot: Optional[int] = None
        self._pinned: Optional[int] = None  # address page-locked for CUDA
        if _create:
            self._seg = open_shm(name=self.name, create=True,
                                 size=_HDR + 8 * num_readers + buffer_size)
            self._seg.buf[:_HDR + 8 * num_readers] = bytes(
                _HDR + 8 * num_readers)
            _U64.pack_into(self._seg.buf, 16, num_readers)
        else:
            self._seg = open_shm(name=self.name)
            if _U64.unpack_from(self._seg.buf, 16)[0] & _NATIVE_BIT:
                self._seg.close()
                raise RuntimeError(
                    f"channel {self.name} runs the reference's native data "
                    f"plane, which the port does not have; create it with "
                    f"native=False")

    # -- pickling ----------------------------------------------------------
    def __reduce__(self):
        return (_attach_channel, (self.name, self.buffer_size,
                                  self.num_readers, self._reader_slot))

    # -- header access ------------------------------------------------------
    def _version(self) -> int:
        return _U64.unpack_from(self._seg.buf, 0)[0]

    def _ack(self, slot: int) -> int:
        return _U64.unpack_from(self._seg.buf, _HDR + 8 * slot)[0]

    def _set_ack(self, slot: int, v: int) -> None:
        _U64.pack_into(self._seg.buf, _HDR + 8 * slot, v)

    def _is_closed(self) -> bool:
        return bool(_U64.unpack_from(self._seg.buf, 16)[0] & _CLOSED_BIT)

    def _payload(self, nbytes: int) -> memoryview:
        base = _HDR + 8 * self.num_readers
        return self._seg.buf[base:base + nbytes]

    def _wait(self, pred, timeout: Optional[float], what: str) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        spins, delay = 0, _SLEEP_MIN_S
        while not pred():
            if self._is_closed():
                raise ChannelClosedError(f"channel {self.name} closed")
            spins += 1
            if spins < 200:
                continue  # hot spin: tens of microseconds
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"channel {self.name}: timeout waiting for {what}")
            # sleep, with backoff: a long wait must not keep taking the
            # interpreter lock from the process's other threads
            time.sleep(delay)
            delay = min(2 * delay, _SLEEP_MAX_S)

    def wait_readers(self, timeout: Optional[float] = None) -> None:
        """Wait until every reader has consumed the last value written."""
        v = self._version()
        self._wait(
            lambda: all(self._ack(r) >= v for r in range(self.num_readers)),
            timeout, "readers to consume previous value")

    def _check_size(self, nbytes: int) -> None:
        if nbytes > self.buffer_size:
            raise ValueError(
                f"payload of {nbytes}B exceeds channel buffer "
                f"{self.buffer_size}B (set buffer_size at compile time)")

    # -- byte data plane ----------------------------------------------------
    def write_bytes(self, payload: bytes,
                    timeout: Optional[float] = None) -> None:
        self._check_size(len(payload))
        if self._is_closed():
            raise ChannelClosedError(f"channel {self.name} closed")
        self.wait_readers(timeout)
        self._payload(len(payload))[:] = payload
        _count_copy(len(payload))
        _U64.pack_into(self._seg.buf, 8, len(payload))
        _U64.pack_into(self._seg.buf, 0, self._version() + 2)

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        view, v = self.read_acquire(timeout)
        out = bytes(view)
        self._set_ack(self._reader_slot or 0, v)
        return out

    # -- zero-copy data plane -----------------------------------------------
    #
    # write_value() serializes with pickle-5 out-of-band buffers packed
    # STRAIGHT into the segment: one copy of the big buffers in all.
    # read_acquire()/read_release() expose the payload as a memoryview over
    # the segment WITHOUT consuming the reader's ack slot, so a transport
    # can deserialize zero-copy (or land tensors on the device straight
    # from shm) and ack only once no live alias of the buffer remains.
    #
    # write_value/read_value carry the BARE serialized payload;
    # EdgeTransport frames payloads with a 64-byte marker header, so both
    # peers of a channel must use the same plane.

    def acquire_write_buffer(self, nbytes: int,
                             timeout: Optional[float] = None) -> memoryview:
        """Wait until every reader consumed the previous value, then hand
        out a writable view of the payload region.  The caller fills it
        and MUST call :meth:`commit_write` to publish."""
        self._check_size(nbytes)
        if self._is_closed():
            raise ChannelClosedError(f"channel {self.name} closed")
        self.wait_readers(timeout)
        return self._payload(nbytes)

    def commit_write(self, nbytes: int) -> None:
        """Publish the payload staged by :meth:`acquire_write_buffer`."""
        _count_copy(nbytes, payload=nbytes)
        _U64.pack_into(self._seg.buf, 8, nbytes)
        _U64.pack_into(self._seg.buf, 0, self._version() + 2)

    def write_value(self, value, timeout: Optional[float] = None) -> int:
        """Serialize ``value`` straight into the segment; returns the
        payload's bytes."""
        from ray_tpu_torch._private import serialization

        core, raw_bufs, total = serialization.serialize_parts(value)
        buf = self.acquire_write_buffer(total, timeout)
        serialization.write_parts(buf, core, raw_bufs)
        self.commit_write(total)
        return total

    def read_acquire(self, timeout: Optional[float] = None
                     ) -> Tuple[memoryview, int]:
        """Wait for an unread value and return ``(payload_view, version)``
        WITHOUT acking: the writer cannot reuse the buffer until
        :meth:`read_release` runs.  Pair with read_release on every path."""
        last = self._ack(self._reader_slot or 0)
        self._wait(lambda: self._version() > last, timeout, "a new value")
        v = self._version()
        if self._is_closed():
            raise ChannelClosedError(f"channel {self.name} closed")
        return self._payload(_U64.unpack_from(self._seg.buf, 8)[0]), v

    def read_release(self, version: int) -> None:
        """Ack the value acquired at ``version``.  Raises if the segment
        was overwritten while the view was live (a reuse-protocol
        violation: the alias guard's backstop)."""
        cur = self._version()
        if cur != version and not self._is_closed():
            raise RuntimeError(
                f"channel {self.name}: buffer overwritten while a "
                f"zero-copy view was live (read v{version}, now v{cur})")
        self._set_ack(self._reader_slot or 0, version)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """The reference's ``write``: :meth:`write_value`."""
        self.write_value(value, timeout)

    def read(self, timeout: Optional[float] = None) -> Any:
        """The reference's ``read``: :meth:`read_value` onto the host."""
        return self.read_value(timeout, device="cpu")

    def read_value(self, timeout: Optional[float] = None, device=None):
        """Safe value read: deserialize with owned (copied) buffers, then
        ack; the value never aliases the segment.  Tensors land on
        ``device`` (``None``: the card; the CPU only when asked for)."""
        from ray_tpu_torch._private import serialization

        view, v = self.read_acquire(timeout)
        try:
            return serialization.deserialize(view, zero_copy=False,
                                             device=device)
        finally:
            self.read_release(v)

    # -- lifecycle ------------------------------------------------------------
    def set_reader_slot(self, slot: int) -> "Channel":
        if not 0 <= slot < self.num_readers:
            raise ValueError(f"reader slot {slot} out of range")
        self._reader_slot = slot
        return self

    def close(self) -> None:
        """Mark the channel closed: every peer's waits raise
        :class:`ChannelClosedError` from now on."""
        if self._seg.buf is None:  # this handle is detached
            return
        cur = _U64.unpack_from(self._seg.buf, 16)[0]
        _U64.pack_into(self._seg.buf, 16, cur | _CLOSED_BIT)

    def pin_for_cuda(self) -> None:
        """Page-lock this handle's mapping of the segment for CUDA
        (``cudaHostRegister``), so that copies between the payload and a
        card are DMA straight from shm, with no staging copy.  Once per
        handle; :meth:`detach` undoes it."""
        if self._pinned is not None:
            return
        import ctypes

        import torch

        anchor = ctypes.c_char.from_buffer(self._seg.buf)
        addr = ctypes.addressof(anchor)
        del anchor  # the address outlives the export; the mapping stays
        portable = 1  # cudaHostRegisterPortable: pinned for every device
        err = int(torch.cuda.cudart().cudaHostRegister(addr, self._seg.size,
                                                       portable))
        if err:
            raise RuntimeError(f"channel {self.name}: cudaHostRegister "
                               f"failed with CUDA error {err}")
        self._pinned = addr

    def detach(self) -> None:
        """Unmap this handle's view of the segment.  A zero-copy view still
        alive keeps the mapping until it is collected."""
        if self._pinned is not None:
            import torch

            torch.cuda.cudart().cudaHostUnregister(self._pinned)
            self._pinned = None
        try:
            self._seg.close()
        except BufferError:
            pass

    def destroy(self) -> None:
        """Close, unmap and unlink the segment (the creator's job)."""
        self.close()
        self.detach()
        try:
            self._seg.unlink()
        except FileNotFoundError:
            pass


def _attach_channel(name: str, buffer_size: int, num_readers: int,
                    reader_slot: Optional[int]) -> Channel:
    ch = Channel(name, buffer_size=buffer_size, num_readers=num_readers,
                 _create=False)
    ch._reader_slot = reader_slot
    return ch


class CompositeChannel:
    """Fan-in of several channels read as one tuple, one value per channel
    in order (counterpart of the reference's ``CompositeChannel``).  Each
    member needs ``read(timeout)`` and ``close()``: a :class:`Channel`
    (its values on the host) or an ``EdgeTransport``."""

    def __init__(self, channels: List[Any]):
        self.channels = list(channels)
        # values already drained for the in-progress read: a mid-tuple
        # timeout has consumed those channels' ack slots, so a retry must
        # resume, not re-read (the compiled DAG's get does the same)
        self._partial: List[Any] = []

    def read(self, timeout: Optional[float] = None) -> tuple:
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(self._partial) < len(self.channels):
            budget = (None if deadline is None
                      else max(0.0, deadline - time.monotonic()))
            self._partial.append(
                self.channels[len(self._partial)].read(budget))
        out, self._partial = tuple(self._partial), []
        return out

    def close(self) -> None:
        for c in self.channels:
            c.close()
