"""Replica: one process hosting one copy of the user callable (counterpart
of ``ray_tpu/serve/replica.py``).

The reference's replica is an actor.  The port's is a process forked by
the worker zygote (``_private/worker_zygote.py``; never a fork of the
controller: a forked child of a process that has touched CUDA cannot
use the card), as a rank of ``train/worker_group.py`` is.  Its ``ReplicaActor`` methods become
:class:`Replica`'s, served over the loopback wire of ``serve/_wire.py``;
the controller keeps a pipe to the process for its lifecycle (ready or
the start's traceback, then ``shutdown``).  A replica placed on a card
(``num_gpus > 0``) makes that card its current device before the
callable is built.

The callable travels by reference, as a trainer's loop does (the card's
machine has no cloudpickle): ``(module, qualname)`` of a top-level class
or function, decorated with ``@serve.deployment`` or not.

A deployment's constructor may start processes: process actors, and a
compiled DAG over them that concurrent requests, each on a wire thread of
its own, ``execute`` and ``get`` (the DAG's buffered results keep them
apart).  They fork from the worker zygote the replica inherited and end
with the replica, killed or not: their pipe to it closes.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.context import (  # noqa: F401 — re-exported here
    ReplicaContext,
    get_replica_context,
)


class _BatchQueue:
    """Accumulate calls, flush at max_batch_size or batch_wait_timeout_s."""

    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._items: List = []
        self._flush_at: Optional[float] = None
        self._cond = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None

    def submit(self, item: Any) -> Dict[str, Any]:
        slot = {"done": threading.Event(), "item": item, "result": None,
                "error": None}
        with self._cond:
            if self._worker is None:
                self._worker = threading.Thread(target=self._run, daemon=True,
                                                name="serve-batch")
                self._worker.start()
            self._items.append(slot)
            if self._flush_at is None:
                self._flush_at = time.monotonic() + self._timeout
            self._cond.notify()
        return slot

    def _run(self):
        while True:
            with self._cond:
                while not self._items or (
                        len(self._items) < self._max
                        and time.monotonic() < (self._flush_at or 0)):
                    wait = (None if not self._items
                            else max(0.0, self._flush_at - time.monotonic()))
                    self._cond.wait(timeout=wait)
                batch = self._items[:self._max]
                self._items = self._items[self._max:]
                self._flush_at = (time.monotonic() + self._timeout
                                  if self._items else None)
            try:
                results = self._fn([s["item"] for s in batch])
                if len(results) != len(batch):
                    raise ValueError(
                        f"@serve.batch fn returned {len(results)} results "
                        f"for a batch of {len(batch)}")
                for s, r in zip(batch, results):
                    s["result"] = r
                    s["done"].set()
            except BaseException as e:  # noqa: BLE001 — each caller gets it
                for s in batch:
                    s["error"] = e
                    s["done"].set()


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch``: calls to the wrapped method are grouped into
    lists (the replica runs each call on a thread of its own, so calls
    meet here).  First-call queue creation races are settled by the
    atomic ``dict.setdefault``."""

    def wrap(f):
        attr = f"__serve_batch_queue_{f.__name__}"

        def call(self, item):
            q = self.__dict__.get(attr)
            if q is None:
                q = self.__dict__.setdefault(
                    attr, _BatchQueue(lambda items: f(self, items),
                                      max_batch_size, batch_wait_timeout_s))
            slot = q.submit(item)
            slot["done"].wait()
            if slot["error"] is not None:
                raise slot["error"]
            return slot["result"]

        call.__name__ = f.__name__
        call._is_serve_batch = True
        return call

    if fn is not None:
        return wrap(fn)
    return wrap


def target_ref(target: Any) -> Tuple[str, str]:
    """``(module, qualname)`` by which a replica imports ``target``;
    refuses what no other process can import."""
    module = getattr(target, "__module__", None)
    qualname = getattr(target, "__qualname__", "")
    if not module or "<locals>" in qualname or "<lambda>" in qualname:
        raise TypeError(
            f"serve: {target!r} must be a class or function at the top "
            "level of an importable module (replicas import it by name)")
    return module, qualname


def resolve_target(ref: Tuple[str, str]) -> Any:
    """The class or function behind ``ref``; a name that a
    ``@serve.deployment`` decorator rebound gives its wrapped target."""
    from ray_tpu_torch.serve.deployment import Deployment

    module, qualname = ref
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj._target if isinstance(obj, Deployment) else obj


class Replica:
    """Wraps the user callable; tracks the ongoing-request count for the
    pow-2 router."""

    CONTROL = ("get_queue_len", "stats", "check_health", "reconfigure")
    # how often a call waiting for a slot checks its deadline and cancel
    SLOT_POLL_S = 0.05

    def __init__(self, target: Any, init_args: tuple, init_kwargs: dict,
                 user_config: Optional[dict], deployment_name: str,
                 replica_id: str, max_ongoing_requests: int = 16):
        from ray_tpu_torch.serve import context as serve_context

        self._deployment = deployment_name
        self._replica_id = replica_id
        # the reference actor's concurrency: max(2, max_ongoing_requests)
        # calls run at once (@serve.batch needs several), the rest wait
        self._slots = threading.BoundedSemaphore(
            max(2, max_ongoing_requests))
        self._ongoing = 0
        self._total = 0
        self._expired = 0
        self._cancelled = 0
        self._lock = threading.Lock()
        serve_context._set_replica_context(
            ReplicaContext(deployment_name, replica_id))
        if isinstance(target, type):
            from ray_tpu_torch.train.worker_group import allow_children

            # the replica is a daemonic process: a constructor that starts
            # processes of its own (actors, a compiled DAG's stages) starts
            # them inside this block; they die with the replica, killed or
            # not, when their pipe to it closes
            with allow_children():
                self._callable = target(*init_args, **init_kwargs)
        else:
            # plain function deployment: calls go straight to it
            self._callable = target
        if user_config is not None and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def control(self, name: str, args: tuple) -> Any:
        if name not in self.CONTROL:
            raise AttributeError(f"replica has no control method {name!r}")
        return getattr(self, name)(*args)

    def reconfigure(self, user_config: dict) -> bool:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def _admit(self, ctx, cancelled: Optional[threading.Event]):
        """Admission (the ``serve.replica.call`` fault site rides this
        edge): wait for a slot; a request whose deadline expires, or whose
        caller cancels it, before it runs is dropped without running.
        Returns holding a slot."""
        from ray_tpu_torch.exceptions import (DeadlineExceededError,
                                              TaskCancelledError)
        from ray_tpu_torch.util.fault_injection import fault_point

        fault_point("serve.replica.call")
        while True:
            if cancelled is not None and cancelled.is_set():
                with self._lock:
                    self._cancelled += 1
                raise TaskCancelledError(ctx.request_id if ctx else None)
            if ctx is not None and ctx.expired():
                with self._lock:
                    self._expired += 1
                raise DeadlineExceededError(
                    request_id=ctx.request_id, deployment=self._deployment,
                    stage="replica-queue", overrun_s=ctx.overrun_s())
            if self._slots.acquire(timeout=self.SLOT_POLL_S):
                return

    def _method(self, method: str):
        fn = getattr(self._callable, method, None)
        if fn is None:
            raise AttributeError(f"deployment {self._deployment} has no "
                                 f"method {method!r}")
        return fn

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       request_context: Optional[dict] = None,
                       cancelled: Optional[threading.Event] = None):
        from ray_tpu_torch.serve.context import RequestContext, scope

        ctx = RequestContext.from_dict(request_context)
        self._admit(ctx, cancelled)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            # scope(ctx): nested DeploymentHandle calls made by the user
            # callable inherit the remaining budget through the contextvar
            with scope(ctx):
                result = self._method(method)(*args, **kwargs)
                if asyncio.iscoroutine(result):
                    result = asyncio.run(result)
                return result
        finally:
            with self._lock:
                self._ongoing -= 1
            self._slots.release()

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: dict,
                                 request_context: Optional[dict] = None,
                                 cancelled: Optional[threading.Event] = None):
        """Generator twin of ``handle_request``: each item reaches the
        caller the moment the user generator yields it."""
        from ray_tpu_torch.serve.context import RequestContext, scope

        ctx = RequestContext.from_dict(request_context)
        self._admit(ctx, cancelled)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            with scope(ctx):
                yield from self._method(method)(*args, **kwargs)
        except GeneratorExit:
            with self._lock:
                self._cancelled += 1
            raise
        finally:
            with self._lock:
                self._ongoing -= 1
            self._slots.release()

    def get_queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        return {"replica_id": self._replica_id, "ongoing": self._ongoing,
                "total": self._total, "expired": self._expired,
                "cancelled": self._cancelled, "pid": os.getpid()}

    def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def shutdown(self) -> None:
        """The user callable's shutdown hook: its ``__del__``, called
        explicitly as Ray Serve does (threads the callable started keep
        it alive, so collection alone would never run it)."""
        hook = getattr(type(self._callable), "__del__", None)
        if hook is not None:
            hook(self._callable)


def replica_main(conn, spec: Dict[str, Any]) -> None:
    """A replica process: set its environment and card, build the
    callable, listen, report ``("ready", address, pid)`` (or
    ``("error", traceback)``) on the controller's pipe, then serve until
    the controller says ``shutdown`` or its end of the pipe closes."""
    os.environ.update(spec["env"])
    server = replica = None
    try:
        card = spec.get("card")
        if card is not None:
            import torch

            torch.cuda.set_device(card)
        from ray_tpu_torch.serve._wire import ReplicaServer

        init_args, init_kwargs = pickle.loads(spec["init"])
        replica = Replica(resolve_target(spec["target"]), init_args,
                          init_kwargs, spec.get("user_config"),
                          spec["deployment"], spec["replica_id"],
                          spec["max_ongoing_requests"])
        server = ReplicaServer(replica, spec["authkey"])
        server.start()
        conn.send_bytes(pickle.dumps(("ready", server.address,
                                      os.getpid())))
    except BaseException:  # noqa: BLE001 — reported to the controller
        try:
            conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        except (OSError, ValueError):
            pass
        _exit()
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            break
        if msg == "shutdown":
            break
    server.stop()
    try:
        replica.shutdown()
    except Exception:  # noqa: BLE001 — the process exits regardless
        traceback.print_exc()
    _exit()


def _exit() -> None:
    """Leave at once: request threads of the callable may still block
    (an engine loop, a landing thread) and the process is discarded
    whole, as a trainer's worker whose loop runs on."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
