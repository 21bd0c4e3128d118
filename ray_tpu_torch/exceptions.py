"""Public exception types of the port (counterpart of
``ray_tpu/exceptions.py``, the part the train, collective and serve tiers
raise)."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for the port's framework errors."""


class TaskError(RayTpuError):
    """A call raised an exception; re-raised at ``get`` with the remote
    traceback (reference: ``TaskError``, ``RayTaskError``).  A compiled
    DAG carries it through its channels to every downstream consumer."""

    def __init__(self, cause_repr: str, remote_traceback: str,
                 cause: Optional[BaseException] = None):
        self.cause_repr = cause_repr
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(
            f"{cause_repr}\n\nRemote traceback:\n{remote_traceback}")

    @classmethod
    def from_exception(cls, e: BaseException) -> "TaskError":
        return cls(repr(e), "".join(traceback.format_exception(
            type(e), e, e.__traceback__)), e)

    @classmethod
    def from_traceback(cls, remote_traceback: str) -> "TaskError":
        """From a traceback's text alone (a process's error reply): its
        last line names the exception."""
        lines = [ln for ln in remote_traceback.strip().splitlines() if ln]
        return cls(lines[-1] if lines else "remote error", remote_traceback)

    def __reduce__(self):
        # the cause may not pickle: keep it where it does, else its repr
        import pickle

        cause = self.cause
        try:
            pickle.dumps(cause)
        except Exception:  # noqa: BLE001 — any pickling failure
            cause = None
        return (TaskError, (self.cause_repr, self.remote_traceback, cause))


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


class ActorDiedError(RayTpuError):
    """The process serving a call is dead or died while executing it
    (reference: ``ActorDiedError``).  An actor is a process of its own
    (``ray_tpu_torch/actor.py``), as a serve replica is
    (``serve/replica.py``): a call pending on one that exits fails with
    this error, which names it, so a caller can tell its death from an
    error its code raised."""

    def __init__(self, actor_id=None, msg: str = ""):
        self.actor_id = actor_id
        self.msg = msg
        super().__init__(msg or f"Actor {actor_id} is dead")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.msg))


class GetTimeoutError(RayTpuError, TimeoutError):
    """A wait for a call's result exceeded its timeout (reference:
    ``GetTimeoutError``)."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")

    def __reduce__(self):
        return (type(self), (self.task_id,))


class BackPressureError(RayTpuError):
    """A serve deployment shed this request at admission: every replica is
    at ``max_ongoing_requests`` and the router's wait queue already holds
    ``max_queued_requests`` requests.

    Fail-fast by design: the request never reaches a replica, so the
    caller may retry after ``retry_after_s`` (the HTTP proxy answers 503
    with ``Retry-After``).  The router never retries it itself.
    """

    def __init__(self, deployment: str = "", queued: int = 0,
                 limit: int = 0, retry_after_s: float = 1.0):
        self.deployment = deployment
        self.queued = queued
        self.limit = limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"deployment {deployment!r} is overloaded: {queued} request(s) "
            f"already queued (max_queued_requests={limit}); retry after "
            f"~{retry_after_s:.1f}s")

    def __reduce__(self):
        return (type(self), (self.deployment, self.queued, self.limit,
                             self.retry_after_s))


class DeadlineExceededError(RayTpuError, TimeoutError):
    """A serve request's end-to-end budget was spent before the work could
    (or did) complete, so the request was rejected or abandoned at
    ``stage`` rather than executed for a client that stopped waiting.
    Every hop (router, replica, engine host) checks the remaining budget.
    """

    def __init__(self, request_id: str = "", deployment: str = "",
                 stage: str = "", overrun_s: float = 0.0):
        self.request_id = request_id
        self.deployment = deployment
        self.stage = stage
        self.overrun_s = overrun_s
        where = f" at {stage}" if stage else ""
        super().__init__(
            f"request {request_id or '<unknown>'} for deployment "
            f"{deployment!r} exceeded its deadline{where} "
            f"(over by {overrun_s:.2f}s)")

    def __reduce__(self):
        return (type(self), (self.request_id, self.deployment, self.stage,
                             self.overrun_s))
