"""Collective types (counterpart of ``ray_tpu/util/collective/types.py``).

The rank-per-process backends are ``torch.distributed``'s: gloo for host
tensors and NCCL for device tensors.  The mesh backend is one process
owning several cards.
"""

from __future__ import annotations

import enum


class Backend(str, enum.Enum):
    """Collective backends.

    - TCP: host-memory collectives between worker processes, over gloo
      (the reference's TCP/GLOO role; also accepted as ``"gloo"``).
    - NCCL: device-memory collectives between worker processes, one card
      each, over NCCL (the role of the reference's XLA backend).
    - MESH: the single-process fast path: ONE process owns several cards
      and the group's ranks are its cards (``CudaMeshGroup``, the
      reference's ``"xla_mesh"``; also accepted as ``"xla_mesh"``).

    The reference's ``"xla"`` names JAX's rank-per-process device
    collectives: it raises and names ``"nccl"``.
    """

    TCP = "tcp"
    NCCL = "nccl"
    MESH = "mesh"

    @staticmethod
    def parse(v) -> "Backend":
        if isinstance(v, Backend):
            return v
        v = str(v).lower()
        if v in ("tcp", "gloo", "cpu"):
            return Backend.TCP
        if v in ("nccl", "cuda", "gpu"):
            return Backend.NCCL
        if v in ("mesh", "xla_mesh"):
            return Backend.MESH
        if v in ("xla", "ici", "tpu"):
            raise ValueError(
                f"collective backend {v!r} is JAX's device plane; on the "
                "GPU use backend='nccl' (one rank per process and card)")
        raise ValueError(f"unknown collective backend {v!r}")


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class GroupState(str, enum.Enum):
    """Supervised lifecycle of a collective group membership.

    READY -> ABORTED (watchdog or transport abort: current and future ops
    raise ``CollectiveAbortError``) -> DESTROYED (``destroy_group``; the
    name may then be re-initialized under a new epoch).
    """

    READY = "READY"
    ABORTED = "ABORTED"
    DESTROYED = "DESTROYED"


unset_timeout_ms = 30_000
