"""Train worker group: N worker processes, one rank each (counterpart of
``ray_tpu/train/worker_group.py``).

The reference runs each rank in an actor that a placement group
gang-schedules.  The port reaches one node, so each rank is an OS
process forked by the worker zygote (``_private/worker_zygote.py``:
one preloaded process that has never touched CUDA, so a child can still
use the card; ``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0`` starts each cold
through ``spawn``).  ``TrainWorker``'s methods are commands the process serves
over a pipe, as the reference's actor methods; the user loop runs in a
thread of the worker, and the controller polls for its status.  Pipe
messages are stdlib ``pickle``, so a loop travels by reference: it must
be a module-level function the worker can import.

Each rank is placed on a unit of its own: a card (``"cuda:<i>"``) or,
for host workers, a slot (``"slot:<i>"``); its ``LOCAL_RANK`` is the
unit's index.  The controller hands the group the units that are not
quarantined; a worker finds its unit in ``RAY_TPU_TORCH_NODE_ID`` and
arms the faults armed on it (``_private/node_faults.py``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class WorkerStatus:
    """One worker's poll snapshot."""

    rank: int
    running: bool
    finished: bool
    error: Optional[str]
    results: List[Dict[str, Any]]  # drained (metrics, checkpoint) rows
    dead: bool = False  # the process is gone or does not answer
    # the tiered status of this rank's AsyncCheckpointer's last save (None
    # in sync mode or before a save)
    ckpt: Optional[Dict[str, Any]] = None


class TrainWorker:
    """The commands one worker process serves; runs the user loop in a
    thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session = None

    def get_metadata(self) -> Dict[str, Any]:
        from ray_tpu_torch._private.accelerators import node_id
        from ray_tpu_torch._private.net import LOOPBACK

        return {
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "ip": LOOPBACK,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "node_id": node_id(),
        }

    def find_free_port(self) -> int:
        """A free port on this worker's host (for rank 0's process-group
        store: the bind happens in this process later, so this is
        best-effort)."""
        from ray_tpu_torch._private.net import free_port

        return free_port()

    def setup_distributed(self, env: Dict[str, str]) -> None:
        """Install the process group's variables (before the loop joins
        it)."""
        os.environ.update(env)

    def start_loop(
        self,
        fn_payload: bytes,
        config: Dict[str, Any],
        rank: int,
        world_size: int,
        group_name: str,
        checkpoint_path: Optional[str],
        dataset_shard: Any = None,
        mesh_config: Any = None,
        axis_rules: Any = None,
        device: str = "cpu",
        ckpt_plane: Optional[Dict[str, Any]] = None,
    ) -> None:
        from ray_tpu_torch.train import session as session_mod

        fn = pickle.loads(fn_payload)
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        sess = session_mod._start_session(
            rank=rank,
            world_size=world_size,
            group_name=group_name,
            config=config,
            checkpoint=ckpt,
            mesh_config=mesh_config,
            axis_rules=axis_rules,
            device=device,
            local_rank=int(os.environ.get("LOCAL_RANK", rank)),
            ckpt_plane=ckpt_plane,
        )
        sess.dataset_shard = dataset_shard
        self._session = sess

        def _run():
            try:
                if device == "cuda":
                    import torch

                    # the current device is per thread: bind the loop's
                    torch.cuda.set_device(sess.local_rank)
                if _takes_config(fn):
                    fn(config)
                else:
                    fn()
            except BaseException as e:  # noqa: BLE001 — reported to controller
                sess.error = e
                sess.error_tb = traceback.format_exc()
            finally:
                sess.finished.set()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="train-loop")
        self._thread.start()

    def request_checkpoint(self, tier: str = "any",
                           avoid_nodes: Optional[List[str]] = None) -> bool:
        """Drain-notice leg: ask the loop to checkpoint at its next step
        boundary (``get_context().drain_requested()`` flips true).
        ``tier="memory"``: the deadline is too short for the disk tier,
        the loop should ``commit_ram()`` and report once the peer acks.
        ``avoid_nodes``: the drained units, where no emergency replica
        may land."""
        sess = self._session
        if sess is None:
            return False
        sess.checkpoint_request_avoid = set(avoid_nodes or ())
        sess.checkpoint_request_tier = tier
        sess.checkpoint_requested.set()
        return True

    def poll(self) -> Dict[str, Any]:
        sess = self._session
        if sess is None:
            return {"running": False, "finished": False, "error": None,
                    "results": []}
        # read the flag before draining: every row a finished loop
        # reported is then in the queue
        finished = sess.finished.is_set()
        rows = []
        while True:
            try:
                rows.append(sess.results.get_nowait())
            except Exception:
                break
        # checkpoints travel as paths; the controller re-wraps them.  A
        # tiered handle travels as its generation index: its durability
        # rides the poll's ``ckpt`` status, since the background persist
        # usually ends after the row drains
        out_rows = []
        for r in rows:
            ck = r["checkpoint"]
            row = {"metrics": r["metrics"], "checkpoint_path": None}
            if ck is not None and hasattr(ck, "ram_acked"):
                row["checkpoint_index"] = ck.index
                row["checkpoint_path"] = ck.committed_path
            elif ck is not None:
                row["checkpoint_path"] = ck.path
            out_rows.append(row)
        err = None
        if sess.error is not None:
            err = sess.error_tb or repr(sess.error)
        ckpt = None
        last = sess._checkpointer.last if sess._checkpointer else None
        if last is not None:
            ckpt = {"index": last.index, "tier": last.tier,
                    "ram_acked": last.ram_acked,
                    "committed_path": last.committed_path,
                    "world": last.world}
        return {
            "running": self._thread is not None and self._thread.is_alive(),
            "finished": finished,
            "error": err,
            "results": out_rows,
            "ckpt": ckpt,
        }

    def shutdown(self) -> bool:
        return True


def _takes_config(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(params) >= 1


def serve_commands(conn, target) -> None:
    """Serve ``target``'s methods as commands over the pipe ``conn``: each
    message is a pickled ``(method, args)``, each answer ``("ok",
    value)`` or ``("error", traceback)``, until ``shutdown`` or until the
    other end closes.  Closes ``conn``.

    Commands run one at a time on the calling thread, in the order they
    arrive, and are answered in that order, so a caller may send several
    before it reads the first answer.  A value that does not pickle is
    answered as an error.  The env runners of ``ray_tpu_torch.rl`` and
    the process actors of ``ray_tpu_torch.actor`` serve theirs the same
    way."""
    while True:
        try:
            cmd, args = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            break
        try:
            reply = pickle.dumps(("ok", getattr(target, cmd)(*args)))
        except BaseException:  # noqa: BLE001 — reported to the caller
            reply = pickle.dumps(("error", traceback.format_exc()))
        try:
            conn.send_bytes(reply)
        except (OSError, ValueError):
            break
        if cmd == "shutdown":
            break
    conn.close()


def _worker_main(conn, env: Dict[str, str]) -> None:
    """A worker process: set its environment (``LOCAL_RANK``, the run's
    store) before anything touches CUDA, then serve ``TrainWorker``
    commands until ``shutdown`` or until the controller's end of the
    pipe closes."""
    os.environ.update(env)
    from ray_tpu_torch._private import accelerators, kv as kv_mod

    halt_watcher = None
    if kv_mod.address() and accelerators.node_id():
        from ray_tpu_torch._private.node_faults import start_watcher

        halt_watcher = start_watcher(kv_mod.address(),
                                     accelerators.node_id())
    worker = TrainWorker()
    serve_commands(conn, worker)
    sess = worker._session
    if sess is None or sess.finished.is_set():
        if halt_watcher is not None:
            halt_watcher()
        _release_groups()
        return
    # the loop still runs (a drain or a restart tore the group down): its
    # thread may be inside a collective, which the interpreter's
    # finalisation would abort under it; the process is discarded whole
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _release_groups() -> None:
    """Tear down this process's collective groups and default process
    group once its loop has ended, so that none is left to its
    destructor at exit."""
    import sys

    col = sys.modules.get("ray_tpu_torch.util.collective.collective")
    if col is not None:
        for name in list(col._group_mgr._groups):
            try:
                col.destroy_collective_group(name)
            except Exception:  # noqa: BLE001 — best effort at exit
                pass
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — best effort at exit
            pass


class WorkerDied(RuntimeError):
    """A worker process is gone or did not answer a command in time."""


class WorkerGroup:
    """Lifecycle of the N worker processes of one generation."""

    def __init__(self, scaling_config, group_name: str, units: List[str],
                 env: Optional[Dict[str, str]] = None):
        self.scaling_config = scaling_config
        self.group_name = group_name
        self.env = dict(env or {})
        self.units = list(units)  # the cards or slots to place ranks on
        self.workers: List[Any] = []  # (process, connection) per rank
        self.worker_metadata: List[Dict[str, Any]] = []
        self._started = False

    def start(self) -> None:
        """Check that the group fits this node (as a placement group
        that cannot place fails), then start one process per rank, rank
        r on the r-th unit with ``RAY_TPU_TORCH_NODE_ID`` and
        ``LOCAL_RANK`` (the unit's index: its card, or its slot) set,
        and wait until every one answers."""
        import torch

        from ray_tpu_torch._private import worker_zygote
        from ray_tpu_torch._private.accelerators import (ENV_NODE_ID,
                                                         default_resources,
                                                         unit_index)

        sc = self.scaling_config
        if sc.use_gpu and not torch.cuda.is_available():
            raise RuntimeError(
                f"worker group {self.group_name}: use_gpu=True but CUDA is "
                "not available; ScalingConfig(use_gpu=False) runs the "
                "workers on the host")
        res = sc.worker_resources()
        have = default_resources()
        for key, per in res.items():
            if key != "memory" and per * sc.num_workers > have.get(key, 0):
                raise RuntimeError(
                    f"worker group {self.group_name} cannot be placed: "
                    f"{sc.num_workers} workers x {res} need "
                    f"{key}={per * sc.num_workers:g}, this node has "
                    f"{have.get(key, 0):g}")
        units = self.units
        if len(units) < sc.num_workers:
            raise RuntimeError(
                f"worker group {self.group_name} cannot be placed: "
                f"{sc.num_workers} workers, {len(units)} "
                f"{'cards' if sc.use_gpu else 'slots'} free ({units})")
        ctx = worker_zygote.get_context()
        try:
            for rank in range(sc.num_workers):
                parent, child = ctx.Pipe()
                unit = units[rank]
                env = {**self.env, ENV_NODE_ID: unit,
                       "LOCAL_RANK": str(unit_index(unit))}
                proc = ctx.Process(target=_worker_main, args=(child, env),
                                   name=f"train-worker-{rank}", daemon=True)
                proc.start()
                child.close()
                self.workers.append((proc, parent))
            self.worker_metadata = [self.call(r, "get_metadata", timeout=120)
                                    for r in range(sc.num_workers)]
        except BaseException:
            self.shutdown()
            raise
        self._started = True

    def call(self, rank: int, cmd: str, *args, timeout: float = 60.0):
        """Run command ``cmd`` on worker ``rank`` and return its result;
        ``WorkerDied`` when the process is gone or silent past
        ``timeout``, ``RuntimeError`` with the worker's traceback when
        the command raised."""
        proc, conn = self.workers[rank]
        try:
            conn.send_bytes(pickle.dumps((cmd, args)))
            if not conn.poll(timeout):
                raise WorkerDied(
                    f"worker {rank} (pid {proc.pid}) did not answer "
                    f"{cmd!r} in {timeout:g} s")
            status, value = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError) as e:
            raise WorkerDied(
                f"worker {rank} (pid {proc.pid}) died (exit code "
                f"{proc.exitcode}): {e!r}") from e
        if status != "ok":
            raise RuntimeError(f"worker {rank} {cmd!r} failed:\n{value}")
        return value

    def worker_node_ids(self) -> List[str]:
        """The unit each rank is bound to, by rank."""
        return [m["node_id"] for m in self.worker_metadata]

    def request_checkpoint(self, tier: str = "any",
                           avoid_nodes: Optional[List[str]] = None) -> None:
        """Best-effort fan-out of the drain notice to every rank."""
        for rank in range(len(self.workers)):
            try:
                self.call(rank, "request_checkpoint", tier,
                          list(avoid_nodes or ()), timeout=5.0)
            except (WorkerDied, RuntimeError):
                pass

    def run_train_fn(
        self,
        fn_payload: bytes,
        config: Dict[str, Any],
        checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[List[Any]] = None,
        dist_env: Optional[List[Dict[str, str]]] = None,
        mesh_config: Any = None,
        axis_rules: Any = None,
        ckpt_planes: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        n = len(self.workers)
        device = "cuda" if self.scaling_config.use_gpu else "cpu"
        if dist_env is not None:
            for rank in range(n):
                self.call(rank, "setup_distributed", dist_env[rank])
        for rank in range(n):
            shard = dataset_shards[rank] if dataset_shards else None
            self.call(rank, "start_loop", fn_payload, config, rank, n,
                      self.group_name,
                      checkpoint.path if checkpoint else None, shard,
                      mesh_config, axis_rules, device,
                      ckpt_planes[rank] if ckpt_planes else None)

    def poll(self, timeout: float = 30.0) -> List[WorkerStatus]:
        """Poll every worker; a dead or silent process yields a
        ``dead=True`` status."""
        statuses: List[WorkerStatus] = []
        for rank in range(len(self.workers)):
            try:
                st = self.call(rank, "poll", timeout=timeout)
                statuses.append(WorkerStatus(
                    rank=rank, running=st["running"],
                    finished=st["finished"], error=st["error"],
                    results=st["results"], ckpt=st.get("ckpt")))
            except (WorkerDied, RuntimeError) as e:
                statuses.append(WorkerStatus(
                    rank=rank, running=False, finished=False,
                    error=f"worker {rank} unreachable: {e}", results=[],
                    dead=True))
        return statuses

    def shutdown(self, timeout: float = 30.0) -> None:
        """Ask every worker to exit, join each within ``timeout``, then
        kill what is left."""
        for _, conn in self.workers:
            try:
                conn.send_bytes(pickle.dumps(("shutdown", ())))
            except (OSError, ValueError):
                pass
        import time

        deadline = time.monotonic() + timeout
        for proc, _ in self.workers:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc, conn in self.workers:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout)
            conn.close()
        self.workers = []
        self._started = False


class allow_children:
    """Let this process start child processes while the block runs.

    A train worker is a daemonic process (its controller's exit takes it
    down), and ``multiprocessing`` refuses children to a daemonic
    process.  A loop that starts processes of its own (the RLHF loop's
    rollout processes) starts them daemonic inside this block: they die
    with the worker's normal exit, and their pipe to it closes when it is
    killed, which ends them too (``serve_commands`` returns on EOF)."""

    def __enter__(self):
        import multiprocessing

        self._proc = multiprocessing.current_process()
        self._was = self._proc.daemon
        if self._was:
            self._proc.daemon = False
        return self

    def __exit__(self, *exc):
        if self._was:
            self._proc.daemon = True
        return False
