"""Process actors: ``remote``, ``get`` and ``kill`` (counterpart of
``ray_tpu/actor.py`` and of ``ray_tpu.get``/``kill``,
``ray_tpu/__init__.py:177``, ``:202``).

The reference registers an actor with the GCS, which leases it a worker
process.  The port has no GCS or raylet: as the trainer's workers
(``train/worker_group.py``) and the env runners are, an actor is one OS
process forked by the worker zygote (``_private/worker_zygote.py``).  The
process
builds the instance, answers with its pid (or the constructor's
traceback), then serves the instance's methods as commands over a pipe
(``train/worker_group.serve_commands``).  Calls run one at a time on the
process's main thread, in the order they were submitted, and are
answered in that order, which the 1F1B pipeline runner relies on.

The data plane's ``ActorHandle`` (``data/_tasks.py``) is another thing:
an instance on a thread of the calling process, for map operators that
need no process of their own.

What travels:
- Messages are stdlib ``pickle``: an actor class, and a function sent
  through ``handle._remote_call``, travel by reference, so each must be
  defined at a module's top level (the child re-imports a script's main
  module, as ``spawn`` does, so a driver script needs its
  ``if __name__ == "__main__"`` guard).
- A call's arguments may be refs (an :class:`ActorRef`, from any actor):
  they are resolved to their values in the driver before the call is sent,
  on a sender thread of the handle, so ``remote()`` never blocks.  An
  argument whose call failed fails the call without running it.

Devices: an actor holds the card unless it is built with ``device="cpu"``
(``Cls.options(device="cpu").remote(...)``; a CPU actor sees no card).  A
card actor binds its card (``"cuda"``: card 0, or ``"cuda:<i>"``) and
brings CUDA up before its constructor runs, so its endpoint info reports
the card.  Without CUDA a card actor raises at ``remote()``.

Every actor process gets the address of a run store
(``_private/kv.py``, ``RAY_TPU_TORCH_KV``) for collective rendezvous: the
caller's own where its environment names one, else one this process
hosts.  A process that starts actors while it is a daemonic train worker
starts them inside ``train/worker_group.allow_children``.

Death: an actor whose process exits fails its pending and later calls
with ``ActorDiedError``, which names it; ``kill(handle)`` ends the
process.  An actor lives until it is killed or its creator exits (actor
processes are daemonic).

Remote functions (``remote(fn)``) run on a thread pool of the calling
process: the DAG interpreter's ``FunctionNode`` needs them, and the port
has no task workers.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import importlib
import inspect
import itertools
import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, Optional, Sequence, Union

from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                      TaskError)

#: this process's device when it is an actor ("cpu", "cuda:<i>"), else None
_PROCESS_DEVICE: Optional[str] = None

_store_lock = threading.Lock()
_hosted_store = None  # the run store this process hosts for its actors
_task_pool: Optional[cf.ThreadPoolExecutor] = None
_names = itertools.count()


# ---------------------------------------------------------------------------
# Refs
# ---------------------------------------------------------------------------


class ActorRef:
    """The result of one call: ``get(timeout)`` waits for it and returns
    the value or raises the call's error (``TaskError`` for an exception
    the call raised, ``ActorDiedError`` when its actor died).  Refs stay
    in the process that made them."""

    __slots__ = ("_event", "_value", "_error", "_what")

    def __init__(self, what: str):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._what = what

    def _set(self, value: Any = None,
             error: Optional[BaseException] = None) -> None:
        self._value, self._error = value, error
        self._event.set()

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise GetTimeoutError(
                f"{self._what} did not finish within {timeout} s")
        if self._error is not None:
            raise self._error
        return self._value

    def __repr__(self) -> str:
        return f"ActorRef({self._what})"

    def __reduce__(self):
        raise TypeError("an ActorRef stays in the process that made it; "
                        "pass its value (get()) or pass it as a call's "
                        "argument, which resolves it")


def put(value: Any) -> ActorRef:
    """A ref that holds ``value`` already."""
    ref = ActorRef("put")
    ref._set(value)
    return ref


def _resolve(v: Any) -> Any:
    return v.get() if isinstance(v, ActorRef) else v


def get(refs: Union[ActorRef, Sequence[ActorRef]], *,
        timeout: Optional[float] = None):
    """The value of a ref, or the values of a list of refs, within one
    ``timeout`` for them all (``GetTimeoutError`` past it)."""
    if isinstance(refs, ActorRef):
        return refs.get(timeout)
    deadline = None if timeout is None else time.monotonic() + timeout
    out = []
    for r in refs:
        left = None if deadline is None else max(
            0.0, deadline - time.monotonic())
        out.append(r.get(left))
    return out


# ---------------------------------------------------------------------------
# The actor process
# ---------------------------------------------------------------------------


def _load_class(module: str, qualname: str) -> type:
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj._cls if isinstance(obj, ActorClass) else obj


class _ActorServer:
    """The commands an actor process serves: ``call`` (a method of the
    instance) and ``rcall`` (a module-level ``fn(instance, *args)``)."""

    def __init__(self, instance: Any):
        self.instance = instance

    def call(self, method: str, args, kwargs):
        return getattr(self.instance, method)(*args, **kwargs)

    def rcall(self, fn, args, kwargs):
        return fn(self.instance, *args, **kwargs)


def _actor_main(conn, module: str, qualname: str, args, kwargs,
                device: str, env: Dict[str, str]) -> None:
    """An actor process: set its environment and device, build the
    instance, answer with the pid or the constructor's traceback, then
    serve calls until the creator's end of the pipe closes."""
    import traceback

    global _PROCESS_DEVICE
    os.environ.update(env)
    if device == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _PROCESS_DEVICE = device
    from ray_tpu_torch.train.worker_group import serve_commands

    try:
        bind_thread_device()
        if device.startswith("cuda"):
            import torch

            torch.cuda.init()
        instance = _load_class(module, qualname)(*args, **kwargs)
    except BaseException:  # noqa: BLE001 — reported to the creator
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        conn.close()
        return
    conn.send_bytes(pickle.dumps(("ok", os.getpid())))
    serve_commands(conn, _ActorServer(instance))


def bind_thread_device() -> None:
    """Bind the calling thread to this actor's card (CUDA's current device
    is per thread): a thread an actor starts calls this first.  A no-op
    outside a card actor."""
    if _PROCESS_DEVICE is not None and _PROCESS_DEVICE.startswith("cuda"):
        import torch

        torch.cuda.set_device(torch.device(_PROCESS_DEVICE))


def process_device() -> Optional[str]:
    """This process's device when it is an actor ("cpu", "cuda:<i>"),
    else None."""
    return _PROCESS_DEVICE


def _store_address() -> str:
    """The run store actors rendezvous through: the one this process's
    environment names, else one this process hosts (once)."""
    global _hosted_store
    from ray_tpu_torch._private import kv as kv_mod

    addr = kv_mod.address()
    if addr:
        return addr
    with _store_lock:
        if _hosted_store is None:
            _hosted_store = kv_mod.host()
        return _hosted_store.addr


def run_store():
    """A connection to the run store this process's actors use."""
    from ray_tpu_torch._private import kv as kv_mod

    addr = _store_address()
    return kv_mod.client() if addr == kv_mod.address() else _hosted_store


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._options = dict(options or {})

    def options(self, **opts) -> "ActorMethod":
        """Per-call options; the compiled DAG reads ``jit=True`` (tier A
        fusion), a direct call ignores it."""
        return ActorMethod(self._handle, self._method_name,
                           {**self._options, **opts})

    def remote(self, *args, **kwargs) -> ActorRef:
        return self._handle._submit(
            "call", self._method_name, args, kwargs,
            f"{self._handle._class_name}.{self._method_name}")

    def bind(self, *args, **kwargs):
        """A DAG node for this call (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs,
                               options=self._options)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor method {self._method_name!r} cannot be "
                        "called directly; use .remote()")


class _RemoteCall:
    """``handle._remote_call.remote(fn, *args)``: run the module-level
    ``fn(instance, *args)`` in the actor's process."""

    def __init__(self, handle: "ActorHandle"):
        self._handle = handle

    def remote(self, fn, *args, **kwargs) -> ActorRef:
        return self._handle._submit(
            "rcall", fn, args, kwargs,
            f"{self._handle._class_name}._remote_call("
            f"{getattr(fn, '__name__', fn)})")


class ActorHandle:
    """One actor process, its pipe, and the threads that send its calls
    (resolving ref arguments in submission order) and match its answers
    to their refs (in the same order)."""

    def __init__(self, proc, conn, class_name: str, method_names,
                 device: str):
        self._actor_id = os.urandom(16)
        self._class_name = class_name
        self._method_names = frozenset(method_names)
        self._device = device
        self._proc = proc
        self._conn = conn
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._outbox: queue.SimpleQueue = queue.SimpleQueue()
        self._dead: Optional[ActorDiedError] = None
        self._killed = False
        # the constructor's answer is the pipe's first
        self._ready = ActorRef(f"{class_name}.__init__")
        self._pending.append(self._ready)
        tag = f"{class_name}-{self._actor_id.hex()[:6]}"
        threading.Thread(target=self._send_loop, daemon=True,
                         name=f"actor-send-{tag}").start()
        threading.Thread(target=self._recv_loop, daemon=True,
                         name=f"actor-recv-{tag}").start()

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor class {self._class_name!r} has no method {name!r}")
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        raise TypeError("an actor handle stays in the process that "
                        "created the actor")

    @property
    def _remote_call(self) -> _RemoteCall:
        return _RemoteCall(self)

    @property
    def _pid(self) -> Optional[int]:
        return self._proc.pid

    def _death(self) -> Optional[ActorDiedError]:
        """The actor's death, once it is known (None while it lives)."""
        if self._dead is None and not self._proc.is_alive():
            self._died(f"its process exited with code {self._proc.exitcode}")
        return self._dead

    # -- submission ---------------------------------------------------------
    def _submit(self, kind: str, target, args, kwargs, what: str) -> ActorRef:
        ref = ActorRef(what)
        with self._lock:
            if self._dead is not None:
                ref._set(error=self._dead)
            else:
                self._outbox.put((kind, target, args, kwargs, ref))
        return ref

    def _send_loop(self) -> None:
        while True:
            item = self._outbox.get()
            if item is None:
                return
            kind, target, args, kwargs, ref = item
            try:
                args = [_resolve(a) for a in args]
                kwargs = {k: _resolve(v) for k, v in kwargs.items()}
            except BaseException as e:  # noqa: BLE001 — an upstream failure
                ref._set(error=e)
                continue
            try:
                data = pickle.dumps((kind, (target, args, kwargs)))
            except Exception as e:  # noqa: BLE001 — reported to the caller
                ref._set(error=TypeError(
                    f"{ref._what}: the call does not pickle ({e!r}); an "
                    "actor's functions and classes must be module-level"))
                continue
            with self._lock:
                if self._dead is not None:
                    ref._set(error=self._dead)
                    continue
                self._pending.append(ref)
            try:
                self._conn.send_bytes(data)
            except (OSError, ValueError):
                self._died("its pipe closed")

    def _recv_loop(self) -> None:
        while True:
            try:
                raw = self._conn.recv_bytes()
            except (EOFError, OSError):
                break
            ref = self._pending.popleft()
            try:
                status, value = pickle.loads(raw)
            except Exception as e:  # noqa: BLE001 — an answer that won't load
                ref._set(error=TaskError.from_exception(e))
                continue
            if status == "ok":
                ref._set(value)
            elif ref is self._ready:
                ref._set(error=TaskError.from_traceback(value))
                self._died(f"its constructor raised:\n{value}")
                self._proc.kill()
                return
            else:
                ref._set(error=TaskError.from_traceback(value))
        self._proc.join(1.0)
        self._died("killed by kill()" if self._killed else
                   f"its process exited with code {self._proc.exitcode}")

    def _died(self, cause: str) -> None:
        with self._lock:
            if self._dead is not None:
                return
            self._dead = ActorDiedError(
                self._actor_id,
                f"actor {self._class_name} ({self._actor_id.hex()[:12]}, "
                f"pid {self._proc.pid}) died: {cause}")
            pending, self._pending = list(self._pending), collections.deque()
        for ref in pending:
            ref._set(error=self._dead)
        while True:  # calls queued before the death: fail them too
            try:
                item = self._outbox.get_nowait()
            except queue.Empty:
                break
            item[-1]._set(error=self._dead)
        self._outbox.put(None)  # ends the sender thread


class ActorClass:
    """``remote(cls)``: ``.remote(*args)`` starts an actor process and
    returns its handle; ``.options(device=...)`` picks its device."""

    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        self.__name__ = cls.__name__
        self.__qualname__ = cls.__qualname__
        self.__module__ = cls.__module__
        self.__doc__ = cls.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor class {self._cls.__name__!r} cannot be "
                        f"instantiated directly; use .remote()")

    def options(self, *, device: Optional[str] = None) -> "ActorClass":
        """``device``: ``"cpu"``, or the card (``None`` or ``"cuda"``:
        card 0, ``"cuda:<i>"``)."""
        return ActorClass(self._cls, {**self._options, "device": device})

    def _device(self) -> str:
        import torch

        dev = self._options.get("device")
        dev = torch.device("cuda" if dev is None else dev)
        if dev.type == "cpu":
            return "cpu"
        if dev.type != "cuda":
            raise ValueError(f"an actor's device is 'cpu' or a card, got "
                             f"{dev}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"actor {self._cls.__name__}: CUDA is not available; "
                "options(device='cpu') runs the actor on the host")
        return f"cuda:{dev.index or 0}"

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private import worker_zygote
        from ray_tpu_torch.train.worker_group import allow_children

        cls = self._cls
        if "<locals>" in cls.__qualname__:
            raise TypeError(f"actor class {cls.__qualname__} must be "
                            "defined at a module's top level (its process "
                            "imports it by name)")
        device = self._device()
        from ray_tpu_torch._private.kv import ENV_KV

        env = {ENV_KV: _store_address()}
        methods = [n for n, _ in inspect.getmembers(cls, callable)
                   if not n.startswith("_")]
        ctx = worker_zygote.get_context()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_actor_main, daemon=True,
            name=f"actor-{cls.__name__}-{next(_names)}",
            args=(child, cls.__module__, cls.__qualname__, args, kwargs,
                  device, env))
        with allow_children():
            proc.start()
        child.close()
        return ActorHandle(proc, parent, cls.__name__, methods, device)


class RemoteFunction:
    """``remote(fn)``: ``.remote(*args)`` runs ``fn`` on a thread pool of
    this process (ref arguments resolved first); ``.bind`` makes a DAG
    node for interpreted execution."""

    def __init__(self, fn):
        self._fn = fn
        self.__name__ = getattr(fn, "__name__", "function")

    def __call__(self, *args, **kwargs):
        raise TypeError(f"remote function {self.__name__!r} cannot be "
                        "called directly; use .remote()")

    def remote(self, *args, **kwargs) -> ActorRef:
        global _task_pool
        with _store_lock:
            if _task_pool is None:
                _task_pool = cf.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="rtpu-task")
        ref = ActorRef(self.__name__)

        def run():
            try:
                a = [_resolve(x) for x in args]
                kw = {k: _resolve(v) for k, v in kwargs.items()}
                ref._set(self._fn(*a, **kw))
            except TaskError as e:
                ref._set(error=e)
            except BaseException as e:  # noqa: BLE001 — the call's error
                ref._set(error=TaskError.from_exception(e))

        _task_pool.submit(run)
        return ref

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)


def remote(obj):
    """``@remote`` on a class (an actor class) or a function."""
    if isinstance(obj, type):
        return ActorClass(obj)
    if callable(obj):
        return RemoteFunction(obj)
    raise TypeError(f"remote() takes a class or a function, got {obj!r}")


def kill(actor: ActorHandle) -> None:
    """End the actor's process; its pending and later calls fail with
    ``ActorDiedError``."""
    actor._killed = True
    actor._proc.kill()
    actor._proc.join(10.0)
    if actor._dead is None:
        actor._died("killed by kill()")

