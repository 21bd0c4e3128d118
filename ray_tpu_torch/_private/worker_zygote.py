"""Worker zygote: every process the port starts forks from one preloaded
process (counterpart of ``ray_tpu/_private/worker_zygote.py``).

A cold start pays for an interpreter and for importing ``torch``, numpy
and the port, seconds before the child's own work begins.  Here one
zygote process per starting process pays that once: it imports
``PRELOAD`` and then forks a child for each start.  It never touches
CUDA (no ``torch.cuda`` query, no kernel library: a forked child of a
process that has initialised the driver cannot use the card) and holds
no thread when it forks: the preload ends with one throw-away fork,
whose pre-fork handlers stop the thread pool numpy's OpenBLAS starts at
import.  It refuses to serve if either still holds.

The mechanism is ``multiprocessing``'s forkserver: the zygote runs its
serve loop (``multiprocessing.forkserver.main``), and each start is a
``Process`` of ``get_context()``, so the ``Process``/``Pipe`` contract
stays: picklable targets, ``sentinel``, ``join``, ``kill``, ``exitcode``.
What the port adds on top:

- **The environment, per start.**  A forked child inherits the zygote's
  environment, not its parent's current one.  ``start()`` snapshots
  ``os.environ`` and the child replaces its own with it first of all
  (``worker_proc.enter``, before the main module and the target's module
  are imported), so a knob set or removed after the zygote started
  reaches the child as it would through ``spawn``.  The working directory, ``sys.path`` and ``__main__`` are
  carried as ``spawn`` carries them (``multiprocessing.spawn.prepare``).
- **Identity.**  A child is the zygote's child, not its starter's, so its
  pid may be recycled once the zygote reaps it.  A child is its pid
  together with its kernel start time (``proc_starttime``), read when it
  starts: a kill or a liveness probe never reaches a recycled pid.  Its
  exit code comes from the zygote; a child that outlives a dead zygote
  is probed by that identity until it exits.
- **Lifetime.**  The zygote starts at a process's first start and serves
  it and every process forked from it; it exits once that process and
  all of them have exited (they all hold its "alive" pipe).  A nested
  start (a train worker's rollout processes, an actor started by an
  actor) reaches the same zygote: the child inherits its address and
  its alive pipe, and costs one fork, not a second preload.
- **Its death.**  A dead zygote (SIGKILL, a crash) is replaced by a new
  one at the next start (``stats()["restarts"]``); a zygote that cannot
  fork a child within ``zygote_spawn_timeout_s`` is killed and that
  start goes through ``spawn`` (``stats()["fallbacks"]``).
  ``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0`` is the one way to start every
  process cold on purpose (``stats()["cold"]``).
"""

from __future__ import annotations

import importlib
import io
import os
import signal
import socket
import sys
import threading
import time
from multiprocessing import (connection, context, forkserver, popen_forkserver,
                             reduction, resource_tracker, spawn, util)
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.config import knob

#: what the zygote imports before its first fork: what the start sites'
#: children import anyway (a name that fails to import is skipped and
#: listed in ``preload_report()["failed"]``)
PRELOAD = (
    "numpy", "torch", "ray_tpu_torch", "ray_tpu_torch.models.llama",
    "ray_tpu_torch.models.training", "ray_tpu_torch.ops.cuda.flash_attention",
    "ray_tpu_torch.train", "ray_tpu_torch.train.worker_group",
    "ray_tpu_torch.actor", "ray_tpu_torch.dag", "ray_tpu_torch.serve.replica",
    "ray_tpu_torch.llm.serving", "ray_tpu_torch.rl.env_runner",
    "ray_tpu_torch.rl.rlhf", "ray_tpu_torch.util.checkpoint_replica",
    "ray_tpu_torch._private.health_plane",
    "ray_tpu_torch.experimental.channel", "ray_tpu_torch._private.worker_proc",
)


def proc_starttime(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot) from /proc/<pid>/stat —
    a (pid, starttime) pair uniquely identifies a process incarnation, so
    liveness probes and kills can't hit a recycled pid.  None if gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # field 2 (comm) may contain spaces/parens; fields after the LAST
        # ')' are well-formed — starttime is the 20th of those
        return int(data.rsplit(b")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def _stat_fields(pid: int):
    """The fields of /proc/<pid>/stat after ``comm`` (state first), or
    None if the process is gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b")", 1)[1].split()
    except (OSError, IndexError):
        return None


def alive(pid: int, starttime: Optional[int]) -> bool:
    """Whether the process that started as ``(pid, starttime)`` still runs:
    the pid exists, is not a zombie, and started at ``starttime``."""
    fields = _stat_fields(pid)
    if fields is None or fields[0] in (b"Z", b"X") or starttime is None:
        return False
    return int(fields[19]) == starttime


def proc_start_epoch(pid: int) -> Optional[float]:
    """When ``pid`` was created (fork), in seconds since the epoch, to the
    kernel's clock tick (10 ms): its start time is kept in ticks since
    boot (``CLOCK_BOOTTIME``)."""
    ticks = proc_starttime(pid)
    if ticks is None:
        return None
    age = time.clock_gettime(time.CLOCK_BOOTTIME) \
        - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


class ZygoteTimeout(OSError):
    """The zygote forked no child within ``zygote_spawn_timeout_s``."""


# ---------------------------------------------------------------------------
# the zygote process
# ---------------------------------------------------------------------------

#: what the preload left, in the zygote and (copied at fork) in each child
_REPORT: Dict[str, Any] = {}


def _zygote_main(listener_fd: int, alive_r: int, t0: float) -> None:
    """The zygote: import ``PRELOAD``, check that it is safe to fork, then
    serve forks until every holder of the alive pipe has exited.  ``t0``
    is when its command began, before it imported this module (and with
    it the port's package and ``torch``)."""
    loaded, failed = [], {}
    for name in PRELOAD:
        try:
            importlib.import_module(name)
            loaded.append(name)
        except Exception as e:  # noqa: BLE001 — recorded; a child imports it
            failed[name] = repr(e)
    t1 = time.time()
    # a throw-away fork runs every library's pre-fork handler (OpenBLAS's
    # stops its thread pool); children start their pools again on use
    pid = os.fork()
    if pid == 0:
        os._exit(0)
    os.waitpid(pid, 0)
    torch = sys.modules.get("torch")
    _REPORT.update(
        pid=os.getpid(), created=proc_start_epoch(os.getpid()),
        preload_start=t0, preload_s=t1 - t0, ready=time.time(),
        threads=len(os.listdir("/proc/self/task")),
        cuda_initialized=bool(torch is not None
                              and torch.cuda.is_initialized()),
        loaded=loaded, failed=failed)
    if _REPORT["threads"] != 1 or _REPORT["cuda_initialized"]:
        sys.stderr.write(f"worker zygote: not safe to fork after its preload "
                         f"({_REPORT['threads']} threads, CUDA initialised: "
                         f"{_REPORT['cuda_initialized']}); exiting\n")
        os._exit(1)
    forkserver.main(listener_fd, alive_r, [])


def preload_report() -> Dict[str, Any]:
    """The zygote's preload record as this process inherited it at its
    fork (``pid``, ``created`` and ``ready`` epoch seconds, ``preload_s``,
    ``threads`` and ``cuda_initialized`` when it began to serve, the
    modules ``loaded`` and ``failed``); empty in a process that no zygote
    forked."""
    return dict(_REPORT)


# ---------------------------------------------------------------------------
# the starting side
# ---------------------------------------------------------------------------


class _Zygote:
    """This process's zygote: started here, or inherited from the zygote
    that forked this process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.address: Optional[str] = None
        self.alive_w: Optional[int] = None  # keeps the zygote serving
        self.pid: Optional[int] = None
        self.starttime: Optional[int] = None
        self.own = False  # this process started it (and reaps it)
        self.counts = {"zygote_starts": 0, "restarts": 0, "children": 0,
                       "fallbacks": 0, "cold": 0}

    def count(self, key: str) -> None:
        with self.lock:
            self.counts[key] += 1

    def info(self) -> Tuple[Optional[str], Optional[int], Optional[int]]:
        return self.address, self.pid, self.starttime

    def inherit(self, address: str, pid: int, starttime: int,
                alive_w: int) -> None:
        with self.lock:
            self.address, self.pid, self.starttime = address, pid, starttime
            self.alive_w, self.own = alive_w, False

    def _alive(self) -> bool:
        if self.own:
            # reap it if it died, as forkserver.ensure_running does
            return os.waitpid(self.pid, os.WNOHANG)[0] == 0
        return alive(self.pid, self.starttime)

    def _forget(self) -> None:
        if self.alive_w is not None:
            os.close(self.alive_w)
        self.address = self.alive_w = self.pid = self.starttime = None
        self.own = False

    def ensure(self) -> None:
        """Start the zygote unless a live one serves this process."""
        with self.lock:
            if self.pid is not None:
                if self._alive():
                    return
                self._forget()
                self.counts["restarts"] += 1
            self._start()

    def _start(self) -> None:
        address = connection.arbitrary_address("AF_UNIX")
        with socket.socket(socket.AF_UNIX) as listener:
            listener.bind(address)
            os.chmod(address, 0o600)
            listener.listen()
            alive_r, alive_w = os.pipe()
            try:
                cmd = ("import sys, time; t0 = time.time(); sys.path[:] = "
                       "%r; from ray_tpu_torch._private.worker_zygote import "
                       "_zygote_main; _zygote_main(%d, %d, t0)"
                       % (sys.path, listener.fileno(), alive_r))
                exe = spawn.get_executable()
                args = [exe, *util._args_from_interpreter_flags(), "-c", cmd]
                pid = util.spawnv_passfds(exe, args,
                                          [listener.fileno(), alive_r])
            except BaseException:
                os.close(alive_w)
                raise
            finally:
                os.close(alive_r)
        self.address, self.alive_w, self.pid = address, alive_w, pid
        self.starttime = proc_starttime(pid)
        self.own = True
        self.counts["zygote_starts"] += 1

    def connect(self, fds) -> Tuple[int, int]:
        """Ask the zygote for a child (``forkserver.connect_to_new_process``
        on this zygote): ``(status_r, data_w)``."""
        with socket.socket(socket.AF_UNIX) as client:
            client.connect(self.address)
            parent_r, child_w = os.pipe()
            child_r, parent_w = os.pipe()
            allfds = [child_r, child_w, self.alive_w,
                      resource_tracker.getfd(), *fds]
            try:
                reduction.sendfds(client, allfds)
                return parent_r, parent_w
            except BaseException:
                os.close(parent_r)
                os.close(parent_w)
                raise
            finally:
                os.close(child_r)
                os.close(child_w)

    def stop(self) -> None:
        """Kill the zygote (when this process started it) and forget it:
        the next start starts another.  Children it forked run on."""
        with self.lock:
            if self.pid is None:
                return
            if self.own:
                try:
                    os.kill(self.pid, signal.SIGKILL)
                    os.waitpid(self.pid, 0)
                except (ProcessLookupError, ChildProcessError):
                    pass
            self._forget()


_ZYGOTE = _Zygote()


class _Popen(popen_forkserver.Popen):
    """A child forked by the zygote, known by its pid and start time."""

    def __init__(self, process_obj):
        self.starttime: Optional[int] = None
        self._orphan = False  # the zygote died: it cannot report the exit
        super().__init__(process_obj)

    def _launch(self, process_obj):
        _ZYGOTE.ensure()
        prep_data = spawn.get_preparation_data(process_obj._name)
        # unpickled in the child first of all, before spawn.prepare imports
        # the main module and before the target's module is imported
        prep_data["worker_proc"] = _Entry(dict(os.environ))
        buf = io.BytesIO()
        context.set_spawning_popen(self)
        try:
            reduction.dump(prep_data, buf)
            reduction.dump(process_obj, buf)
        finally:
            context.set_spawning_popen(None)
        self.sentinel, w = _ZYGOTE.connect(self._fds)
        # a duplicate of the data pipe's write end is the child's sentinel
        # of this process (as forkserver's Popen keeps it)
        _parent_w = os.dup(w)
        self.finalizer = util.Finalize(self, util.close_fds,
                                       (_parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            # the pid first: a zygote that does not fork leaves the data
            # unread, and a write larger than the pipe would block
            if not connection.wait([self.sentinel],
                                   knob("zygote_spawn_timeout_s")):
                raise ZygoteTimeout("the worker zygote forked no child in "
                                    f"{knob('zygote_spawn_timeout_s'):g} s")
            self.pid = forkserver.read_signed(self.sentinel)
            self.starttime = proc_starttime(self.pid)
            f.write(buf.getbuffer())

    def poll(self, flag=os.WNOHANG):
        if self.returncode is not None:
            return self.returncode
        if flag != os.WNOHANG:
            return self.wait()
        if not self._orphan:
            if not connection.wait([self.sentinel], 0):
                return None
            try:
                self.returncode = forkserver.read_signed(self.sentinel)
                return self.returncode
            except (OSError, EOFError):
                self._orphan = True
        if alive(self.pid, self.starttime):
            return None
        self.returncode = 255  # gone; its exit code died with the zygote
        return self.returncode

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return None
            if self._orphan:
                time.sleep(0.01 if left is None else min(0.01, left))
            else:
                connection.wait([self.sentinel], left)

    def _send_signal(self, sig):
        if self.poll() is None and alive(self.pid, self.starttime):
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass


class _Entry:
    """Unpickles, in the child, as ``worker_proc.enter``'s call on this
    process's environment at the start and the zygote (its address, pid,
    start time and a write end of its alive pipe, passed as an fd)."""

    def __init__(self, env: Dict[str, str]):
        self.env = env

    def __reduce__(self):
        from ray_tpu_torch._private import worker_proc

        address, pid, starttime = _ZYGOTE.info()
        return worker_proc.enter, (self.env, (
            address, pid, starttime, reduction.DupFd(_ZYGOTE.alive_w)))


class ZygoteProcess(context.ForkServerProcess):
    """A process forked by the zygote, with this process's environment as
    it is at ``start()``."""

    # the child's default multiprocessing context, as under spawn
    _start_method = "spawn"

    @staticmethod
    def _Popen(process_obj):
        try:
            popen = _Popen(process_obj)
        except (OSError, EOFError) as e:
            if isinstance(e, ZygoteTimeout):
                _ZYGOTE.stop()
            _ZYGOTE.count("fallbacks")
            from multiprocessing.popen_spawn_posix import Popen

            return Popen(process_obj)
        _ZYGOTE.count("children")
        return popen


class _ZygoteContext(context.ForkServerContext):
    Process = ZygoteProcess


class _ColdContext(context.SpawnContext):
    """``spawn``'s context, each process counted (``use_worker_zygote=0``).
    Its processes are multiprocessing's own, so a cold child imports
    nothing of the port before its target."""

    @staticmethod
    def Process(*args, **kwargs):
        _ZYGOTE.count("cold")
        return context.SpawnProcess(*args, **kwargs)


_CONTEXTS = {True: _ZygoteContext(), False: _ColdContext()}


def get_context():
    """The ``multiprocessing`` context every start site of the port uses in
    place of ``get_context("spawn")``: the zygote's, or ``spawn``'s under
    ``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0`` (read at each call)."""
    return _CONTEXTS[bool(knob("use_worker_zygote"))]


def inherit(zygote) -> None:
    """In a child: take over the zygote that forked it, for nested starts
    (``zygote`` is ``(address, pid, starttime, alive pipe)``, the pipe a
    ``DupFd``)."""
    address, pid, starttime, alive_fd = zygote
    _ZYGOTE.inherit(address, pid, starttime, alive_fd.detach())


def stats() -> Dict[str, Any]:
    """This process's starts: ``children`` forked by the zygote,
    ``zygote_starts``, ``restarts`` (a dead zygote replaced),
    ``fallbacks`` (a start that went through ``spawn`` because the zygote
    failed), ``cold`` (starts under ``use_worker_zygote=0``), and the
    zygote's ``zygote_pid`` (None before the first start)."""
    with _ZYGOTE.lock:
        return {**_ZYGOTE.counts, "zygote_pid": _ZYGOTE.pid,
                "zygote_inherited": _ZYGOTE.pid is not None
                and not _ZYGOTE.own}


def stop() -> None:
    """Kill this process's zygote now (tests; a child forked from it runs
    on and is probed by its identity)."""
    _ZYGOTE.stop()
