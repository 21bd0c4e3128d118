"""Serve request context: request id + absolute deadline, minted at the
ingress and carried through every hop of the serving data plane
(counterpart of ``ray_tpu/serve/context.py``).

The proxy mints one :class:`RequestContext` per route invocation; the
router checks the budget before dispatch, the replica checks it again
before invoking the user callable, and nested ``DeploymentHandle`` calls
made inside a replica inherit the remaining budget through the
contextvar, so a composition chain shares one deadline.

The reference's trace context rides the same object; the port has no
tracing plane yet, so the context carries the id and the deadline only.
Its overload counters are plain counts (no metrics registry).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class ReplicaContext:
    """Identity of the replica hosting the current callable: deployment
    name + replica id, so a callable can label what it publishes (the
    LLM engine-stats records) without threading its name through init
    args."""

    deployment: str
    replica_id: str


_replica_context: Optional[ReplicaContext] = None


def _set_replica_context(ctx: Optional[ReplicaContext]) -> None:
    global _replica_context
    _replica_context = ctx


def get_replica_context() -> Optional[ReplicaContext]:
    """The hosting replica's context, or None outside a replica."""
    return _replica_context


@dataclasses.dataclass(frozen=True)
class RequestContext:
    """One serving request's identity and end-to-end budget.

    ``deadline_s`` is an absolute ``time.time()`` instant (``None``: no
    budget).  Wall-clock is the right base: the deadline travels between
    processes, where a monotonic reading is meaningless.
    """

    request_id: str
    deadline_s: Optional[float] = None

    def remaining_s(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - time.time()

    def expired(self) -> bool:
        return self.deadline_s is not None and time.time() > self.deadline_s

    def overrun_s(self) -> float:
        if self.deadline_s is None:
            return 0.0
        return max(0.0, time.time() - self.deadline_s)

    def to_dict(self) -> Dict[str, Any]:
        return {"request_id": self.request_id, "deadline_s": self.deadline_s}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]
                  ) -> Optional["RequestContext"]:
        if not d:
            return None
        return cls(request_id=d.get("request_id", ""),
                   deadline_s=d.get("deadline_s"))


_request_ctx: contextvars.ContextVar[Optional[RequestContext]] = \
    contextvars.ContextVar("ray_tpu_torch_serve_request_context",
                           default=None)


def current_context() -> Optional[RequestContext]:
    """The in-flight request's context, or None outside a request scope."""
    return _request_ctx.get()


def new_request_context(*, timeout_s: Optional[float],
                        request_id: Optional[str] = None) -> RequestContext:
    """Mint an ingress context: ``timeout_s`` from now becomes the
    request's absolute deadline."""
    return RequestContext(
        request_id=request_id or uuid.uuid4().hex[:16],
        deadline_s=None if timeout_s is None else time.time() + timeout_s)


@contextlib.contextmanager
def scope(ctx: Optional[RequestContext]) -> Iterator[None]:
    """Install ``ctx`` as the current request context for the duration
    (the proxy around dispatch, the replica around the user callable)."""
    token = _request_ctx.set(ctx)
    try:
        yield
    finally:
        _request_ctx.reset(token)


@contextlib.contextmanager
def request_scope(*, timeout_s: Optional[float],
                  request_id: Optional[str] = None) -> Iterator[RequestContext]:
    """Mint-and-install in one step: the driver-side opt-in for handle
    calls that want a budget without going through the proxy::

        with serve.request_scope(timeout_s=2.0):
            handle.remote(body).result()   # the whole chain shares 2 s
    """
    ctx = new_request_context(timeout_s=timeout_s, request_id=request_id)
    with scope(ctx):
        yield ctx


class OverloadStats:
    """A deployment's degradation counters in one router process: shed
    (rejected at admission), expired (dropped with the deadline spent),
    cancelled (abandoned by the client) and the queued gauge.  The router
    publishes its snapshot into the serve store, where ``serve.status()``
    sums the reporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.shed = 0
        self.expired = 0
        self.cancelled = 0
        self.queued = 0
        self.peak_queued = 0

    def note_shed(self):
        with self._lock:
            self.shed += 1

    def note_expired(self):
        with self._lock:
            self.expired += 1

    def note_cancelled(self):
        with self._lock:
            self.cancelled += 1

    def note_queued(self, delta: int):
        with self._lock:
            self.queued += delta
            self.peak_queued = max(self.peak_queued, self.queued)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"shed": self.shed, "expired": self.expired,
                    "cancelled": self.cancelled, "queued": self.queued,
                    "peak_queued": self.peak_queued}
