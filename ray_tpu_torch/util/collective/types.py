"""Collective types (counterpart of ``ray_tpu/util/collective/types.py``).

The backends are ``torch.distributed``'s, one rank per process: gloo for
host tensors and NCCL for device tensors.
"""

from __future__ import annotations

import enum


class Backend(str, enum.Enum):
    """Collective backends.

    - TCP: host-memory collectives between worker processes, over gloo
      (the reference's TCP/GLOO role; also accepted as ``"gloo"``).
    - NCCL: device-memory collectives between worker processes, one card
      each, over NCCL (the role of the reference's XLA backend).

    The reference's ``"xla"`` and ``"xla_mesh"`` name JAX's device
    collectives, which the port does not have: they raise and name
    ``"nccl"``.
    """

    TCP = "tcp"
    NCCL = "nccl"

    @staticmethod
    def parse(v) -> "Backend":
        if isinstance(v, Backend):
            return v
        v = str(v).lower()
        if v in ("tcp", "gloo", "cpu"):
            return Backend.TCP
        if v in ("nccl", "cuda", "gpu"):
            return Backend.NCCL
        if v in ("xla", "ici", "tpu", "xla_mesh", "mesh"):
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
