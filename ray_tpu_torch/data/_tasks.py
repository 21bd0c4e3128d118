"""In-process stand-in for the four core calls the data package makes:
``remote``, ``get``, ``wait`` and ``put`` (the reference's
``ray_tpu.remote`` tasks and actors over its object store).

The port has no task runtime, and it runs on one machine, so a
data task is a call on one shared ``ThreadPoolExecutor`` (its size is
``DataContext.task_pool_size``, default the host's CPU count) and an
object ref wraps the call's ``Future``.  Threads suffice because the
block work is numpy, which releases the interpreter lock; a row-wise
Python ``map`` holds it, which is the divergence this design accepts.

- ``remote(fn).remote(*args)`` submits ``fn`` with its ref arguments
  resolved; ``remote(num_returns="streaming")`` makes a generator task,
  whose call gives a generator of refs that a pool thread feeds (the
  reference's streaming generator).
- ``remote(cls)`` gives an actor class: each handle owns one thread of
  its own, so its methods run in call order and the instance is built
  once (``ActorPoolStrategy``'s ``MapWorker``).  These are the data
  plane's own: the port's process actors (``ray_tpu_torch/actor.py``,
  one spawned process each, what the compiled DAG runs over) would cost
  a process start per map worker.
- ``put(value)`` returns a resolved ref.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import os
import queue
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

_pool: Optional[cf.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()
_END = object()
_actor_ids = itertools.count()


class ObjectRef:
    """A reference to a task's result (or a ``put`` value)."""

    __slots__ = ("_future",)

    def __init__(self, future: cf.Future):
        self._future = future


def _task_pool() -> cf.ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            from ray_tpu_torch.data.context import DataContext

            size = DataContext.get_current().task_pool_size or \
                os.cpu_count() or 1
            _pool = cf.ThreadPoolExecutor(max_workers=size,
                                          thread_name_prefix="rtpu-data-task")
        return _pool


def _resolve(args: Sequence[Any], kwargs: dict) -> Tuple[list, dict]:
    return ([get(a) if isinstance(a, ObjectRef) else a for a in args],
            {k: get(v) if isinstance(v, ObjectRef) else v
             for k, v in kwargs.items()})


def _call(fn: Callable, args: Sequence[Any], kwargs: dict):
    args, kwargs = _resolve(args, kwargs)
    return fn(*args, **kwargs)


def put(value: Any) -> ObjectRef:
    f: cf.Future = cf.Future()
    f.set_result(value)
    return ObjectRef(f)


def get(refs, timeout: Optional[float] = None):
    """The value of a ref, or the values of a list of refs; a task's
    exception is raised here."""
    if isinstance(refs, ObjectRef):
        return refs._future.result(timeout)
    deadline = None if timeout is None else time.monotonic() + timeout
    out = []
    for r in refs:
        left = None if deadline is None else max(0.0,
                                                 deadline - time.monotonic())
        out.append(r._future.result(left))
    return out


def wait(refs: List[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """Split ``refs`` into ``(ready, not_ready)``, with at most
    ``num_returns`` ready ones, in the order given; waits until that many
    are done or ``timeout`` passes."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        ready = [r for r in refs if r._future.done()][:num_returns]
        left = None if deadline is None else deadline - time.monotonic()
        if len(ready) >= min(num_returns, len(refs)) or \
                (left is not None and left <= 0):
            ready_ids = {id(r) for r in ready}
            return ready, [r for r in refs if id(r) not in ready_ids]
        cf.wait([r._future for r in refs if not r._future.done()],
                timeout=left, return_when=cf.FIRST_COMPLETED)


class _StreamingRefs:
    """Refs of a generator task's items, in order, as the pool thread
    produces them; the task's exception is raised at its position."""

    def __init__(self, fn: Callable, args, kwargs):
        self._q: "queue.Queue" = queue.Queue()  # unbounded: never blocks
        self._future = _task_pool().submit(self._produce, fn, args, kwargs)

    def _produce(self, fn, args, kwargs):
        try:
            for item in _call(fn, args, kwargs):
                self._q.put(put(item))
        except BaseException as e:  # noqa: BLE001 — raised in order
            self._q.put(e)
        finally:
            self._q.put(_END)

    def __iter__(self) -> Iterator[ObjectRef]:
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class RemoteFunction:
    def __init__(self, fn: Callable, streaming: bool = False):
        self._fn = fn
        self._streaming = streaming

    def remote(self, *args, **kwargs):
        if self._streaming:
            return _StreamingRefs(self._fn, args, kwargs)
        return ObjectRef(_task_pool().submit(_call, self._fn, args, kwargs))


class _ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        h = self._handle
        return ObjectRef(h._thread.submit(
            lambda: _call(getattr(h._instance.result(), self._name),
                          args, kwargs)))


class ActorHandle:
    """One instance on one thread of its own (not a process actor of
    ``ray_tpu_torch.actor``)."""

    def __init__(self, cls: type, args, kwargs):
        self._thread = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=(
                f"rtpu-data-{cls.__name__}-{next(_actor_ids)}"))
        self._instance = self._thread.submit(_call, cls, args, kwargs)

    def __getattr__(self, name: str) -> _ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self, name)

    def _kill(self) -> None:
        self._thread.shutdown(wait=False, cancel_futures=True)


class ActorClass:
    def __init__(self, cls: type):
        self._cls = cls

    def remote(self, *args, **kwargs) -> ActorHandle:
        return ActorHandle(self._cls, args, kwargs)


def remote(fn_or_class=None, *, num_returns=None):
    """``@remote`` / ``@remote(num_returns="streaming")`` for functions,
    ``@remote`` for actor classes."""
    def wrap(obj):
        if isinstance(obj, type):
            return ActorClass(obj)
        return RemoteFunction(obj, streaming=num_returns == "streaming")

    return wrap(fn_or_class) if fn_or_class is not None else wrap


def kill(actor: ActorHandle) -> None:
    actor._kill()
