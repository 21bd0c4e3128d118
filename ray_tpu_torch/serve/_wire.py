"""The serve plane's wire: calls to replica processes over loopback
connections.

The reference reaches a replica by actor RPCs.  The port's replica is a
process (``serve/replica.py``) listening on a loopback address of its own
with ``multiprocessing.connection``, under an authkey the controller
mints.  A process keeps one connection per replica it calls, and the
connection carries many concurrent calls, each tagged with an id::

    caller -> replica   ("call", cid, kind, method, blob)
                        kind: "unary" | "stream" | "control"
                        ("cancel", cid)
    replica -> caller   ("ok", cid, blob)   ("err", cid, blob)
                        ("item", cid, blob) ("end", cid)

A blob is the stdlib pickle of a payload (the arguments with the request
context, a result, an exception or a stream item) apart from its frame,
so a payload that fails to decode fails its own call only.  A stream's
items arrive in order (one connection, one writer lock).  ``cancel``
stops a stream's producer at its next item (the generator is closed, so
its ``finally`` runs), and a unary call not yet admitted; a unary call
already running runs on.

A replica that exits closes its end: the connection's reader thread then
fails every pending call with :class:`ActorDiedError` at once, so a dead
replica's calls fail within the kernel's socket teardown.  A caller that
goes away cancels everything it had in flight on that replica.
"""

from __future__ import annotations

import itertools
import os
import pickle
import queue
import threading
import traceback
from multiprocessing.connection import AuthenticationError, Client, Listener
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.net import LOOPBACK
from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                      TaskCancelledError)


def dump_error(e: BaseException) -> bytes:
    """An exception as a blob: itself with the replica's traceback as a
    note when it survives a pickle round trip, else a ``RuntimeError``
    carrying its type, text and traceback."""
    tb = traceback.format_exc()
    try:
        e.add_note(f"raised in the replica (pid {os.getpid()}):\n{tb}")
        blob = pickle.dumps(e)
        pickle.loads(blob)
        return blob
    except Exception:  # noqa: BLE001 — unpicklable: carry its text
        return pickle.dumps(RuntimeError(f"{type(e).__name__}: {e}\n{tb}"))


class Call:
    """The caller's side of one call: ``result()`` for a unary or control
    call, iteration for a stream."""

    def __init__(self, conn: "_Conn", cid: int, streaming: bool):
        self._conn = conn
        self.cid = cid
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[[], None]] = []
        self._items: Optional[queue.Queue] = queue.Queue() if streaming \
            else None

    def _push(self, blob: bytes) -> None:
        self._items.put_nowait(("item", blob))

    def _finish(self, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._value, self._error = value, error
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        if self._items is not None:
            self._items.put_nowait(("end", None))
        for fn in callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a callback never kills the reader
                pass

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` once the call ends (success, error, cancel or the
        replica's death), at once when it already has."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise GetTimeoutError(
                f"call {self.cid} to replica {self._conn.label} not done "
                f"in {timeout} s")
        if self._error is not None:
            raise self._error
        return self._value

    def cancel(self) -> None:
        """Ask the replica to stop this call."""
        self._conn.send_cancel(self.cid)

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        while True:
            try:
                kind, blob = self._items.get(timeout=1.0)
            except queue.Empty:
                continue  # a dead replica ends the stream through _finish
            if kind == "item":
                return pickle.loads(blob)
            self._items.put_nowait(("end", None))  # stays ended
            if self._error is not None:
                raise self._error
            raise StopIteration

    def close(self) -> None:
        """Stop reading a stream: cancel its producer and drop whatever
        it still sends."""
        if not self._done.is_set():
            self.cancel()
            self._conn.forget(self.cid)
            self._finish(error=TaskCancelledError(self.cid))


class _Conn:
    """One process's connection to one replica, with its reader thread."""

    def __init__(self, address: Tuple[str, int], authkey: bytes, label: str):
        self.label = label
        self._c = Client(tuple(address), authkey=authkey)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._calls: Dict[int, Call] = {}
        self._ids = itertools.count()
        self._broken: Optional[str] = None
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"serve-wire-{label}")
        self._reader.start()

    @property
    def alive(self) -> bool:
        return self._broken is None

    def start(self, kind: str, method: str, args: tuple, kwargs: dict,
              context: Optional[dict]) -> Call:
        blob = pickle.dumps((args, kwargs, context))
        call = Call(self, next(self._ids), kind == "stream")
        with self._lock:
            if self._broken is not None:
                raise ActorDiedError(self.label, f"replica {self.label} is "
                                     f"gone: {self._broken}")
            self._calls[call.cid] = call
        try:
            with self._send_lock:
                self._c.send_bytes(pickle.dumps(("call", call.cid, kind,
                                                 method, blob)))
        except (OSError, ValueError) as e:
            self._fail_all(f"send failed: {e!r}")
            raise ActorDiedError(self.label, f"replica {self.label} is "
                                 f"gone: {e!r}") from e
        return call

    def send_cancel(self, cid: int) -> None:
        try:
            with self._send_lock:
                self._c.send_bytes(pickle.dumps(("cancel", cid)))
        except (OSError, ValueError):
            pass  # gone: the replica's end cancels what it ran for us

    def forget(self, cid: int) -> None:
        with self._lock:
            self._calls.pop(cid, None)

    def _read_loop(self) -> None:
        while True:
            try:
                msg = pickle.loads(self._c.recv_bytes())
            except (EOFError, OSError) as e:
                self._fail_all(f"connection closed ({e!r})")
                return
            op, cid = msg[0], msg[1]
            with self._lock:
                call = self._calls.get(cid) if op == "item" \
                    else self._calls.pop(cid, None)
            if call is None:
                continue  # closed by its caller
            if op == "item":
                call._push(msg[2])
            elif op == "end":
                call._finish()
            elif op == "ok":
                try:
                    call._finish(value=pickle.loads(msg[2]))
                except Exception as e:  # noqa: BLE001 — this call's payload only
                    call._finish(error=e)
            else:
                try:
                    err = pickle.loads(msg[2])
                except Exception as e:  # noqa: BLE001
                    err = e
                call._finish(error=err)

    def _fail_all(self, why: str) -> None:
        with self._lock:
            if self._broken is None:
                self._broken = why
            calls, self._calls = list(self._calls.values()), {}
        for call in calls:
            call._finish(error=ActorDiedError(
                self.label, f"replica {self.label} died with the call "
                f"pending: {why}"))
        try:
            self._c.close()
        except OSError:
            pass


_conns: Dict[Tuple[Tuple[str, int], int], _Conn] = {}
_conns_lock = threading.Lock()


def _connection(address: Tuple[str, int], authkey: bytes,
                label: str) -> _Conn:
    key = (tuple(address), os.getpid())
    with _conns_lock:
        conn = _conns.get(key)
        if conn is not None and conn.alive:
            return conn
        try:
            conn = _Conn(address, authkey, label)
        except (OSError, EOFError, AuthenticationError) as e:
            raise ActorDiedError(label, f"cannot reach replica {label} at "
                                 f"{address}: {e!r}") from e
        _conns[key] = conn
        return conn


class ReplicaHandle:
    """A picklable reference to one replica process: its deployment, id,
    loopback address, authkey and pid.  The reference's actor handle:
    the router dispatches through it, and a prefill replica receives the
    decode replica's to open the KV channel on it."""

    def __init__(self, deployment: str, replica_id: str,
                 address: Tuple[str, int], authkey: bytes, pid: int):
        self.deployment = deployment
        self.replica_id = replica_id
        self.address = tuple(address)
        self.authkey = authkey
        self.pid = pid

    def __reduce__(self):
        return (ReplicaHandle, (self.deployment, self.replica_id,
                                self.address, self.authkey, self.pid))

    def __repr__(self):
        return f"ReplicaHandle({self.replica_id}, pid {self.pid})"

    def _start(self, kind: str, method: str, args: tuple = (),
               kwargs: Optional[dict] = None,
               request_context: Optional[dict] = None) -> Call:
        conn = _connection(self.address, self.authkey, self.replica_id)
        return conn.start(kind, method, tuple(args), dict(kwargs or {}),
                          request_context)

    def handle_request(self, method: str, args: tuple = (),
                       kwargs: Optional[dict] = None,
                       request_context: Optional[dict] = None) -> Call:
        """Call the deployment's ``method``; ``result()`` waits for it."""
        return self._start("unary", method, args, kwargs, request_context)

    def handle_request_streaming(self, method: str, args: tuple = (),
                                 kwargs: Optional[dict] = None,
                                 request_context: Optional[dict] = None
                                 ) -> Call:
        """Call a generator method; iterate the result for its items."""
        return self._start("stream", method, args, kwargs, request_context)

    def control(self, name: str, *args, timeout: float = 30.0) -> Any:
        """The replica's own methods (``get_queue_len``, ``stats``,
        ``check_health``, ``reconfigure``), waited for up to
        ``timeout``."""
        return self._start("control", name, args).result(timeout=timeout)


class ReplicaServer:
    """The replica's end: a loopback listener; each connection gets a
    reader thread, each call a thread of its own."""

    def __init__(self, replica, authkey: bytes):
        self._replica = replica
        self._listener = Listener((LOOPBACK, 0), authkey=authkey)
        self.address: Tuple[str, int] = self._listener.address
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="serve-replica-accept")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                continue
            except (OSError, EOFError):
                if self._stopped.is_set():
                    return
                continue
            _ServerConn(self._replica, conn).start()


class _ServerConn:
    """One caller's connection inside the replica."""

    def __init__(self, replica, conn):
        self._replica = replica
        self._c = conn
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._cancels: Dict[int, threading.Event] = {}
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="serve-replica-conn")

    def start(self) -> None:
        self._thread.start()

    def _send(self, msg) -> bool:
        try:
            with self._send_lock:
                self._c.send_bytes(pickle.dumps(msg))
            return True
        except (OSError, ValueError):
            return False  # the caller is gone

    def _read_loop(self) -> None:
        while True:
            try:
                msg = pickle.loads(self._c.recv_bytes())
            except (EOFError, OSError):
                break
            if msg[0] == "cancel":
                with self._lock:
                    ev = self._cancels.get(msg[1])
                if ev is not None:
                    ev.set()
                continue
            _, cid, kind, method, blob = msg
            cancelled = threading.Event()
            with self._lock:
                self._cancels[cid] = cancelled
            threading.Thread(target=self._run,
                             args=(cid, kind, method, blob, cancelled),
                             daemon=True, name=f"serve-call-{method}").start()
        # the caller went away: cancel everything it had in flight here
        with self._lock:
            pending = list(self._cancels.values())
        for ev in pending:
            ev.set()
        try:
            self._c.close()
        except OSError:
            pass

    def _run(self, cid: int, kind: str, method: str, blob: bytes,
             cancelled: threading.Event) -> None:
        try:
            args, kwargs, ctx = pickle.loads(blob)
            if kind == "control":
                value = self._replica.control(method, args)
                self._send(("ok", cid, pickle.dumps(value)))
            elif kind == "unary":
                value = self._replica.handle_request(method, args, kwargs,
                                                     ctx, cancelled)
                self._send(("ok", cid, pickle.dumps(value)))
            else:
                gen = self._replica.handle_request_streaming(
                    method, args, kwargs, ctx, cancelled)
                try:
                    for item in gen:
                        if cancelled.is_set() or not self._send(
                                ("item", cid, pickle.dumps(item))):
                            break
                finally:
                    gen.close()  # a stopped stream's producer unwinds here
                self._send(("end", cid))
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            self._send(("err", cid, dump_error(e)))
        finally:
            with self._lock:
                self._cancels.pop(cid, None)
