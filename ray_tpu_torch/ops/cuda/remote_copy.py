"""Remote copy as a hand-written CUDA kernel: K4.

K4 replaces ``ray_tpu/experimental/channel/transport.py::
_pallas_remote_copy`` (the Pallas shape of the tier-B chip-to-chip hop:
an async copy of a device's whole array into its right neighbour with
send/recv DMA semaphores).  Source: ``csrc/remote_copy.cu``, CUDA C++ for
sm_90a, built on first use by ``_build.py`` and called through its plain
C interface with ``ctypes``.  The note at its top says what bounds it
(bytes) and how the TPU design changes.

The copy is one launch of a persistent grid (:func:`grid_blocks`), at
most one block per SM: the whole 16-byte vectors are cut into chunks of
``STAGE_BYTES``, dealt to the blocks in turn, and each block streams its
chunks through a ring of ``STAGES`` stages of shared memory with TMA bulk
loads and stores.

What a hop needs after the copy depends on where it lands
(:func:`needs_completion`):

- On the source's own card, nothing: the copy runs on the card's current
  stream, which is the stream later work on that card is queued on, so
  stream order gives that work the bytes (the role of the TPU kernel's
  recv semaphore).  No flag, no wait, no completion state.
- On a peer card, the copy's last block publishes the hop's epoch to a
  flag in the destination's memory, and a one-thread wait on the
  destination device's current stream spins on it with acquire loads, so
  later work on that stream sees the bytes.  Each source stream has a
  flag of its own on each destination, since hops from two streams may
  run at once.  The wait is bounded in time; a wait that runs out sets a
  status word that :func:`check_remote_copies` turns into an error.  Peer
  access is enabled on first use and refused where
  ``can_device_access_peer`` says no; there is no fallback to ``copy_``.

``remote_copy_plain`` (``dst.copy_(src)``) is the plain version: the CPU
tests use it, and ``chip_smoke.py`` holds the kernel against it.  The
wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  ``remote_copy.launches`` counts K4's copy
launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

#: the ring of each block, as ``remote_copy.cu`` is compiled with it
#: (its ``STAGES`` and ``STAGE_BYTES``): stages, and bytes per stage, the
#: fastest of the rings read on the card (PERF.md)
STAGES, STAGE_BYTES = 8, 16 * 1024
#: the wait kernel gives up after this long (then check_remote_copies raises)
WAIT_TIMEOUT_S = 10.0


def remote_copy_plain(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Plain PyTorch version of K4: ``dst.copy_(src)``."""
    dst.copy_(src)


def grid_blocks(nbytes: int, sms: int) -> int:
    """K4's grid for ``nbytes``: one block per SM, never more blocks than
    chunks of ``STAGE_BYTES`` of whole 16-byte vectors, and at least
    one (which copies the bytes past the last whole vector)."""
    return max(1, min(sms, -(-(nbytes // 16 * 16) // STAGE_BYTES)))


def needs_completion(src: torch.device, dst: torch.device) -> bool:
    """Whether a hop from ``src`` to ``dst`` needs the flag and the wait:
    only when it lands on another card, whose current stream is not the
    one the copy runs on."""
    return src != dst


def _check(src: torch.Tensor, dst: torch.Tensor) -> None:
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"K4 copies between tensors of one dtype and shape: "
                         f"src {src.dtype} {tuple(src.shape)}, dst "
                         f"{dst.dtype} {tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("K4 needs contiguous src and dst")
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError(f"K4 needs 16-byte aligned src and dst, got "
                         f"addresses {src.data_ptr():#x}, {dst.data_ptr():#x}")


def _lib() -> ctypes.CDLL:
    from ray_tpu_torch.ops.cuda import _build

    lib = _build.load("remote_copy")
    if not lib.ray_tpu_remote_copy.argtypes:
        ptr, u64, i32 = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int
        lib.ray_tpu_remote_copy.argtypes = [ptr, ptr, u64, ptr, u64, i32,
                                            i32, ptr]
        lib.ray_tpu_remote_copy.restype = i32
        lib.ray_tpu_remote_wait.argtypes = [ptr, u64, u64, i32, ptr]
        lib.ray_tpu_remote_wait.restype = i32
        lib.ray_tpu_remote_copy_enable_peer.argtypes = [i32, i32]
        lib.ray_tpu_remote_copy_enable_peer.restype = i32
        lib.ray_tpu_remote_copy_error_string.argtypes = [i32]
        lib.ray_tpu_remote_copy_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"K4 {what} failed: "
                           + lib.ray_tpu_remote_copy_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Completion:
    """The completion state of the hops from one source stream to one
    destination device: a buffer of four words on the destination (u64
    flag, u32 block counter, i32 status) and the epoch of the last hop.

    The kernel's count of finished blocks and its monotone flag hold only
    while the hops that share them run one after another, so they belong
    to one stream: hops from two streams may run at once, and each stream
    gets a completion of its own."""

    def __init__(self, src: torch.device, dst: torch.device, stream: int):
        self.src, self.dst, self.stream = src, dst, stream
        self.words = torch.zeros(4, dtype=torch.int64, device=dst)
        self.epoch = 0


class _Registry:
    """Completion states by (source device, destination device, source
    stream)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pairs: Dict[Tuple[int, int, int], _Completion] = {}


_REG = _Registry()


def _completion(lib, src: torch.device, dst: torch.device,
                stream: int) -> _Completion:
    """The completion of hops from ``stream`` (a ``cuda_stream`` handle on
    ``src``) into ``dst``, made on first use."""
    key = (src.index, dst.index, stream)
    with _REG.lock:
        comp = _REG.pairs.get(key)
        if comp is None:
            if src != dst:
                if not torch.cuda.can_device_access_peer(src.index,
                                                         dst.index):
                    raise RuntimeError(
                        f"K4: {src} cannot access {dst} as a peer; a remote "
                        f"copy between them needs peer access (NVLink or "
                        f"PCIe P2P)")
                _raise_on(lib, lib.ray_tpu_remote_copy_enable_peer(
                    src.index, dst.index), "enabling peer access")
            comp = _REG.pairs[key] = _Completion(src, dst, stream)
        return comp


def _launch_wait(lib, comp: _Completion, epoch: int, timeout_s: float,
                 stream: Optional[torch.cuda.Stream] = None) -> None:
    """The wait for ``epoch`` on ``stream``, by default the destination
    device's current stream."""
    stream = stream or torch.cuda.current_stream(comp.dst)
    _raise_on(lib, lib.ray_tpu_remote_wait(
        comp.words.data_ptr(), epoch, int(timeout_s * 1e9), comp.dst.index,
        stream.cuda_stream), "wait launch")


def _launch_copy(lib, src: torch.Tensor, dst: torch.Tensor,
                 comp: Optional[_Completion] = None, epoch: int = 0) -> None:
    """K4's copy on ``src``'s current stream; with ``comp``, its last block
    publishes ``epoch`` to the completion's flag."""
    nbytes = src.numel() * src.element_size()
    _raise_on(lib, lib.ray_tpu_remote_copy(
        src.data_ptr(), dst.data_ptr(), nbytes,
        comp.words.data_ptr() if comp is not None else None, epoch,
        grid_blocks(nbytes, _sms(src.device.index)), src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream), "copy launch")
    remote_copy.launches += 1


def _flagged_hop(lib, src: torch.Tensor, dst: torch.Tensor,
                 comp: _Completion, wait_stream: torch.cuda.Stream) -> None:
    """A hop with its completion: the copy on ``src``'s current stream and
    its wait on ``wait_stream``.  The epoch and both launches under one
    lock: hops of one completion reach its stream in the order of their
    epochs, whatever the thread."""
    with _REG.lock:
        comp.epoch += 1
        _launch_copy(lib, src, dst, comp, comp.epoch)
        _launch_wait(lib, comp, comp.epoch, WAIT_TIMEOUT_S, wait_stream)


def _launch(src: torch.Tensor, dst: torch.Tensor) -> None:
    lib = _lib()
    if not needs_completion(src.device, dst.device):
        _launch_copy(lib, src, dst)
        return
    src_stream = torch.cuda.current_stream(src.device)
    dst_stream = torch.cuda.current_stream(dst.device)
    comp = _completion(lib, src.device, dst.device, src_stream.cuda_stream)
    # dst (and the completion words) were last used on dst's stream
    src_stream.wait_stream(dst_stream)
    _flagged_hop(lib, src, dst, comp, dst_stream)


def remote_copy(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` (same dtype and shape, contiguous, 16-byte
    aligned).  CUDA tensors launch K4 on ``src``'s device, whether ``dst``
    lies on the same card or on a peer; a hop onto a peer also queues its
    wait on ``dst``'s current stream.  The call returns at once, and
    :func:`check_remote_copies` reports a wait that ran out.  CPU tensors
    run ``remote_copy_plain``."""
    _check(src, dst)
    if src.device.type == "cpu" and dst.device.type == "cpu":
        remote_copy_plain(src, dst)
        return
    if not (src.is_cuda and dst.is_cuda):
        raise ValueError(f"K4 copies between CUDA tensors (or runs its plain "
                         f"version between CPU ones), not {src.device} -> "
                         f"{dst.device}")
    _launch(src, dst)


remote_copy.launches = 0


def check_remote_copies() -> None:
    """Raise if the wait of any K4 hop so far ran out of time (its flag
    never reached the hop's epoch), and clear the status.  Reads one word
    per completion, so it synchronises with the destinations' streams; a
    process whose hops all stayed on one card has none to read."""
    with _REG.lock:
        pairs = list(_REG.pairs.values())
    failed = [c for c in pairs if int(c.words[2])]
    for c in failed:
        c.words[2].zero_()
    if failed:
        where = ", ".join(f"{c.src} -> {c.dst} (stream {c.stream:#x})"
                          for c in failed)
        raise RuntimeError(f"K4: the completion wait timed out on {where}: "
                           f"the copy's flag never reached its epoch")
