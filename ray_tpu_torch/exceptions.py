"""Public exception types of the port (counterpart of
``ray_tpu/exceptions.py``, the part the train and collective tiers
raise)."""

from __future__ import annotations

from typing import Optional


class RayTpuError(Exception):
    """Base class for the port's framework errors."""


class CollectiveAbortError(RayTpuError):
    """A collective group was aborted mid-operation.

    Raised on every member of the group, for the op in flight when the
    abort fired (the watchdog or the transport's own timeout ended it)
    and for every op attempted afterwards, until the group is torn down
    and re-formed (``destroy_collective_group`` +
    ``init_collective_group``).

    Carries the supervision layer's diagnosis of why: the op and its
    sequence number, and this process's flight-recorder tail
    (``diagnosis``).
    """

    def __init__(self, group_name: str = "", rank: Optional[int] = None,
                 seq: Optional[int] = None, reason: str = "",
                 diagnosis: str = ""):
        self.group_name = group_name
        self.rank = rank
        self.seq = seq
        self.reason = reason
        self.diagnosis = diagnosis
        where = [f"rank {rank}"] if rank is not None else []
        if seq is not None:
            where.append(f"seq {seq}")
        loc = f" ({', '.join(where)})" if where else ""
        msg = f"collective group {group_name!r} aborted{loc}: {reason}"
        if diagnosis:
            msg += f"\n{diagnosis}"
        super().__init__(msg)

    def __reduce__(self):
        return (type(self), (self.group_name, self.rank, self.seq,
                             self.reason, self.diagnosis))
