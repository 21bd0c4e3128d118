"""Serialization for the channel plane: pickle protocol 5 with out-of-band
buffers packed straight into shared memory.

Counterpart of ``ray_tpu/_private/serialization.py``, with the same wire
layout, so a frame written by either package decodes in the other::

    u32 magic | u32 n_buffers | u64 core_len | n*u64 buffer_len
    core pickle bytes | padding to 64 | buffer0 | padding to 64 | buffer1 ...

Differences from the reference:

- The pickler is the standard library's (protocol 5 with a
  ``reducer_override``), not cloudpickle: channel payloads are data, and
  functions travel by import path.
- There is no ObjectRef tracking: the port has no object store yet, so
  ``serialize_parts`` returns ``(core, buffers, total)`` and
  ``deserialize`` returns the value alone.
- A ``torch.Tensor`` travels as its raw bytes in one out-of-band buffer,
  with its dtype and shape beside it (bf16 has no numpy dtype).  A CUDA
  tensor is copied to the host on the writer, as ``np.asarray`` does with
  a jax array in the reference.

On the reader, tensors are rebuilt on the reader's device (``device`` of
``deserialize``; ``None`` means the card, as at every entry point of the
port, resolved at the first tensor, so a payload without tensors decodes
on a host without CUDA).  Under :class:`device_rebuild_guard` (a reusable source
buffer such as a channel segment) a CUDA tensor is an H2D copy straight
from the buffer and a CPU tensor an owned copy, or with ``borrow=True``
a view of the buffer itself; without the guard every tensor is owned.
"""

from __future__ import annotations

import io
import pickle
import struct
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

_MAGIC = 0x52545055  # "RTPU"
_HDR = struct.Struct("<II Q")
_ALIGN = 64

_local = threading.local()


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class device_rebuild_guard:
    """Alias guard for deserializing tensors from a REUSABLE buffer (a
    channel segment that the writer overwrites once its readers ack).

    Inside this context a tensor is rebuilt on the reader's device without
    keeping the source buffer alive: on CUDA by an H2D copy straight from
    the buffer into a fresh tensor, on the CPU by an owned copy.  Every
    rebuilt tensor is collected in ``.arrays``, so that the caller can
    :meth:`synchronize` the copies before it releases the buffer.

    ``borrow=True`` skips the owned copy on the CPU: the rebuilt tensors
    alias the source buffer and are valid only until it is released, so
    they are strictly for borrow-scoped consumption
    (``EdgeTransport.read_borrowed``), never for values that escape.
    """

    def __init__(self, borrow: bool = False):
        self.arrays: List[torch.Tensor] = []
        self.borrow = borrow

    def __enter__(self) -> "device_rebuild_guard":
        _local.rebuild_guard = self
        return self

    def __exit__(self, *exc):
        _local.rebuild_guard = None

    def synchronize(self) -> None:
        """Wait for the H2D copies of the CUDA tensors rebuilt so far (the
        stream synchronisation that must precede the buffer's release)."""
        for dev in {t.device for t in self.arrays if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()


def _reduce_tensor(t: torch.Tensor):
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()  # the D2H copy, as np.asarray does for a jax array
    t = t.resolve_conj().resolve_neg().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(t.dtype).removeprefix("torch."),
             tuple(t.shape)))


def _host_view(buf, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor over ``buf`` itself, no copy."""
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    if mv.readonly:  # torch.frombuffer wants a writable buffer
        mv = memoryview(bytearray(mv))
    return torch.frombuffer(mv, dtype=dtype).reshape(shape)


def _rebuild_tensor(buf, dtype_name: str, shape: Tuple[int, ...]
                    ) -> torch.Tensor:
    view = _host_view(buf, getattr(torch, dtype_name), shape)
    device = resolve_device(getattr(_local, "device", None))
    guard = getattr(_local, "rebuild_guard", None)
    if guard is None:
        return view.to(device, copy=True)
    if device.type == "cuda":
        out = torch.empty(view.shape, dtype=view.dtype, device=device)
        out.copy_(view, non_blocking=True)
    elif guard.borrow:
        out = view
    else:
        out = view.clone()
    guard.arrays.append(out)
    return out


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.layout == torch.strided:
            return _reduce_tensor(obj)
        return NotImplemented


def serialize_parts(value: Any) -> Tuple[bytes, List[memoryview], int]:
    """Two-phase serialization: pickle once, learn the total size WITHOUT
    copying the out-of-band buffers, then ``write_parts`` packs straight
    into the destination (shm): one copy of the big buffers in all.

    Returns ``(core_bytes, raw_buffers, total_nbytes)``.
    """
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffers.append).dump(value)
    core = f.getvalue()
    raw_bufs = [b.raw() for b in buffers]
    total = _pad(_HDR.size + 8 * len(raw_bufs)) + _pad(len(core)) + sum(
        _pad(b.nbytes) for b in raw_bufs)
    return core, raw_bufs, total


def _copy_into(out, off: int, b) -> None:
    n = b.nbytes if hasattr(b, "nbytes") else len(b)
    if n >= (1 << 20):
        # bulk memcpy through numpy: faster than memoryview slice
        # assignment for the multi-MiB buffers that dominate payloads
        np.copyto(np.frombuffer(out, np.uint8, n, off),
                  np.frombuffer(b, np.uint8, n))
    else:
        out[off:off + n] = b


def write_parts(out, core: bytes, raw_bufs) -> None:
    """Pack the output of ``serialize_parts`` into writable buffer ``out``."""
    _HDR.pack_into(out, 0, _MAGIC, len(raw_bufs), len(core))
    off = _HDR.size
    for b in raw_bufs:
        struct.pack_into("<Q", out, off, b.nbytes)
        off += 8
    off = _pad(off)
    _copy_into(out, off, core)
    off = _pad(off + len(core))
    for b in raw_bufs:
        _copy_into(out, off, b)
        off = _pad(off + b.nbytes)


def deserialize(payload, zero_copy: bool = True,
                device: Optional[torch.device] = None) -> Any:
    """Decode one wire-format payload (bytes, or a memoryview over shared
    memory).  With ``zero_copy`` numpy arrays view ``payload`` directly;
    without it every buffer is copied first.  Tensors land on ``device``
    (``None``: the card; the CPU only when asked for), as
    :class:`device_rebuild_guard` says."""
    view = memoryview(payload)
    magic, n_bufs, core_len = _HDR.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("bad object payload magic")
    off = _HDR.size
    lens = [struct.unpack_from("<Q", view, off + 8 * i)[0]
            for i in range(n_bufs)]
    off = _pad(off + 8 * n_bufs)
    core = view[off:off + core_len]
    off = _pad(off + core_len)
    bufs = []
    for blen in lens:
        b = view[off:off + blen]
        bufs.append(b if zero_copy else bytearray(b))
        off = _pad(off + blen)
    prev = getattr(_local, "device", None)
    _local.device = device
    try:
        return pickle.loads(core, buffers=bufs)
    finally:
        _local.device = prev
