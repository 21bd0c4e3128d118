"""ServeController: the reconciliation loop (counterpart of
``ray_tpu/serve/controller.py``), cut for processes.

The reference's controller is a named actor behind the GCS.  The port's
is a thread of the driver process, one per process (:func:`get_controller`).
It hosts one ``TCPStore`` as the serve store (``_private/kv.py``), where
it publishes each deployment's replicas (picklable
:class:`~ray_tpu_torch.serve._wire.ReplicaHandle`\\ s) with a version,
the route table and the app ingresses.  A router in any process, a
replica holding nested handles among them, reads them there; replicas
find the store in ``RAY_TPU_TORCH_SERVE_STORE``.

It deploys and deletes, starts replica processes (forked by the worker
zygote) and admits each into the routed set once it reports ready,
prunes a replica whose process exited the tick it happens and starts a
replacement, and health checks the running ones (three failures in a row: killed and replaced).
A replica that fails to start before its deployment ever had a ready
one is not retried: ``serve.run`` raises with its traceback.  The
engine-signal pool autoscaler and drain migration wait (ROADMAP).
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import kv as kv_mod, worker_zygote
from ray_tpu_torch._private.accelerators import ENV_NODE_ID
from ray_tpu_torch.serve._wire import ReplicaHandle
from ray_tpu_torch.serve.replica import replica_main, target_ref

ENV_SERVE_STORE = "RAY_TPU_TORCH_SERVE_STORE"  # "host:port" of the store
ROUTES_KEY = "serve/routes"
APPS_KEY = "serve/apps"


def deployment_key(name: str) -> str:
    return f"serve/deployment/{name}"


def overload_prefix(name: str) -> str:
    return f"serve/overload/{name}/"


class _ReplicaProc:
    """The controller's record of one replica process."""

    def __init__(self, replica_id: str, proc, conn):
        self.replica_id = replica_id
        self.proc = proc
        self.conn = conn  # the lifecycle pipe
        self.started = time.monotonic()
        self.handle: Optional[ReplicaHandle] = None
        self.health_fails = 0


class ServeController:
    RECONCILE_INTERVAL_S = 0.5
    HEALTH_CHECK_EVERY = 20  # ticks (~10 s)
    HEALTH_CHECK_TIMEOUT_S = 10.0
    HEALTH_FAILS_TO_REPLACE = 3
    # a replica's start: spawn, imports, the callable's __init__ (a 7B
    # engine builds its weights on the card)
    START_TIMEOUT_S = 600.0
    RESTART_BACKOFF_S = 1.0

    def __init__(self):
        self.store = kv_mod.host()
        self._authkey = os.urandom(32)
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._routes: Dict[str, str] = {}  # route_prefix -> deployment
        self._apps: Dict[str, str] = {}    # app name -> ingress deployment
        self._next_card = 0
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._loop = threading.Thread(target=self._reconcile_loop,
                                      daemon=True, name="serve-controller")
        self._loop.start()

    # -- deploy / delete -----------------------------------------------------

    def deploy(self, name: str, target: Any, init_args: tuple,
               init_kwargs: dict, config: Dict[str, Any],
               route_prefix: Optional[str],
               app_name: Optional[str] = None) -> None:
        """Register (or replace) deployment ``name`` and start its
        replicas (``wait_ready`` waits for them)."""
        ref = target_ref(target)
        init = pickle.dumps((init_args, init_kwargs))
        old: List[_ReplicaProc] = []
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                st = {"replicas": [], "starting": [], "version": 0,
                      "ever_ready": False, "next_start": 0.0}
                self._deployments[name] = st
            elif (st["target"], st["init"], st["config"]) != (ref, init,
                                                              config):
                # code, args or config changed: the running replicas hold
                # the old ones, so all of them restart (not rolling)
                old = st["replicas"] + st["starting"]
                st.update(replicas=[], starting=[], ever_ready=False)
            st.update(target=ref, init=init, config=config,
                      goal=int(config["num_replicas"]), error=None)
            st["version"] += 1
            if app_name:
                self._apps[app_name] = name
            if route_prefix:
                self._routes[route_prefix] = name
            self._publish_routes()
            self._publish(name)
        self._stop_replicas(old)
        self._reconcile_once()

    def wait_ready(self, names: List[str]) -> None:
        """Block until every deployment in ``names`` has its goal of ready
        replicas; raise with a replica's traceback if one failed to start
        before its deployment was ever ready."""
        deadline = time.monotonic() + self.START_TIMEOUT_S
        with self._cond:
            while True:
                pending = []
                for n in names:
                    st = self._deployments.get(n)
                    if st is None:
                        raise KeyError(f"no deployment {n!r}")
                    if st.get("error") and not st["ever_ready"]:
                        raise RuntimeError(
                            f"serve: a replica of deployment {n!r} failed "
                            f"to start:\n{st['error']}")
                    if len(st["replicas"]) < st["goal"]:
                        pending.append(n)
                if not pending:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"serve: {pending} not ready in "
                                       f"{self.START_TIMEOUT_S} s")
                self._cond.wait(min(0.5, remaining))

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            st = self._deployments.pop(name, None)
            self._routes = {r: d for r, d in self._routes.items() if d != name}
            self._apps = {a: d for a, d in self._apps.items() if d != name}
            self.store.delete(deployment_key(name))
            self._publish_routes()
        if st:
            self._stop_replicas(st["replicas"] + st["starting"],
                                st["config"]["graceful_shutdown_timeout_s"])
        return st is not None

    def shutdown(self) -> None:
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete_deployment(n)
        self._stop.set()
        self._loop.join(timeout=5.0)

    # -- queries -------------------------------------------------------------

    def get_deployment_info(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            st = self._deployments.get(name)
            return None if st is None else self._info(st)

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = [(n, len(st["replicas"]), st["goal"], st["version"])
                     for n, st in self._deployments.items()]
        return {n: {"num_replicas": have, "goal": goal, "version": version,
                    "overload": self._overload_total(n)}
                for n, have, goal, version in items}

    def _overload_total(self, name: str) -> Dict[str, int]:
        """The deployment's overload counters summed over every router
        that reported them (driver, proxy, composing replicas)."""
        total = {"shed": 0, "expired": 0, "cancelled": 0, "queued": 0}
        for key in self.store.keys(overload_prefix(name)):
            raw = self.store.get(key)
            if raw:
                snap = json.loads(raw)
                for k in total:
                    total[k] += int(snap.get(k, 0))
        return total

    # -- publishing ----------------------------------------------------------

    @staticmethod
    def _info(st: Dict[str, Any]) -> Dict[str, Any]:
        cfg = st["config"]
        return {"replicas": [r.handle for r in st["replicas"]],
                "max_ongoing_requests": cfg["max_ongoing_requests"],
                "max_queued_requests": cfg.get("max_queued_requests", -1),
                "version": st["version"]}

    def _publish(self, name: str) -> None:
        """Lock held: the deployment's routed replicas into the store."""
        st = self._deployments.get(name)
        if st is not None:
            self.store.put(deployment_key(name), pickle.dumps(self._info(st)))

    def _publish_routes(self) -> None:
        self.store.put(ROUTES_KEY, json.dumps(self._routes).encode())
        self.store.put(APPS_KEY, json.dumps(self._apps).encode())

    # -- replica processes ---------------------------------------------------

    def _start_replica(self, name: str, st: Dict[str, Any]) -> None:
        """Lock held: spawn one replica process of ``name``."""
        rid = f"{name}#{uuid.uuid4().hex[:6]}"
        opts = st["config"].get("ray_actor_options") or {}
        env = {ENV_SERVE_STORE: self.store.addr}
        card = None
        if float(opts.get("num_gpus", 0) or 0) > 0:
            import torch

            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if count == 0:
                st["error"] = (f"ray_actor_options={opts} asks for a card "
                               "but CUDA is not available")
                self._cond.notify_all()
                return
            card = self._next_card % count
            self._next_card += 1
            env.update({ENV_NODE_ID: f"cuda:{card}", "LOCAL_RANK": str(card)})
        spec = {"env": env, "card": card, "target": st["target"],
                "init": st["init"], "user_config":
                st["config"].get("user_config"), "deployment": name,
                "replica_id": rid, "authkey": self._authkey,
                "max_ongoing_requests":
                st["config"]["max_ongoing_requests"]}
        ctx = worker_zygote.get_context()
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=replica_main, args=(child, spec),
                           name=f"serve-replica-{rid}", daemon=True)
        proc.start()
        child.close()
        st["starting"].append(_ReplicaProc(rid, proc, parent))

    def _stop_replicas(self, reps: List[_ReplicaProc],
                       graceful_s: float = 10.0) -> None:
        """Ask each to shut down (its callable's ``__del__`` runs), join
        them within ``graceful_s``, then kill what is left."""
        for r in reps:
            try:
                r.conn.send_bytes(pickle.dumps("shutdown"))
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + graceful_s
        for r in reps:
            r.proc.join(max(0.0, deadline - time.monotonic()))
        for r in reps:
            if r.proc.is_alive():
                r.proc.kill()
                r.proc.join(5.0)
            r.conn.close()

    def _poll_starting(self) -> None:
        """Admit replicas that reported ready; record the ones that failed
        (their traceback, or how they exited)."""
        now = time.monotonic()
        with self._lock:
            for name, st in self._deployments.items():
                for r in list(st["starting"]):
                    msg = None
                    if r.conn.poll(0):
                        try:
                            msg = pickle.loads(r.conn.recv_bytes())
                        except (EOFError, OSError):
                            r.proc.join(1.0)
                            msg = ("error", f"replica {r.replica_id} exited "
                                   f"(code {r.proc.exitcode}) before it was "
                                   "ready")
                    elif not r.proc.is_alive():
                        msg = ("error", f"replica {r.replica_id} exited "
                               f"(code {r.proc.exitcode}) before it was ready")
                    elif now - r.started > self.START_TIMEOUT_S:
                        msg = ("error", f"replica {r.replica_id} not ready "
                               f"in {self.START_TIMEOUT_S} s")
                    if msg is None:
                        continue
                    st["starting"].remove(r)
                    if msg[0] == "ready":
                        r.handle = ReplicaHandle(name, r.replica_id, msg[1],
                                                 self._authkey, msg[2])
                        st["replicas"].append(r)
                        st["ever_ready"] = True
                        st["version"] += 1
                        self._publish(name)
                    else:
                        st["error"] = msg[1]
                        st["next_start"] = now + self.RESTART_BACKOFF_S
                        if r.proc.is_alive():
                            r.proc.kill()
                        r.conn.close()
                    self._cond.notify_all()

    def _prune_dead_replicas(self) -> None:
        """Drop replicas whose process exited, the tick it happens."""
        with self._lock:
            for name, st in self._deployments.items():
                gone = [r for r in st["replicas"] if not r.proc.is_alive()]
                for r in gone:
                    st["replicas"].remove(r)
                    r.conn.close()
                if gone:
                    st["version"] += 1
                    self._publish(name)

    def _reconcile_once(self) -> None:
        now = time.monotonic()
        extra: List[_ReplicaProc] = []
        with self._lock:
            for name, st in self._deployments.items():
                if st.get("error") and not st["ever_ready"]:
                    continue  # a start that never worked is not retried
                while (len(st["replicas"]) + len(st["starting"]) < st["goal"]
                       and now >= st["next_start"]):
                    self._start_replica(name, st)
                    if st.get("error") and not st["ever_ready"]:
                        break
                while len(st["replicas"]) > st["goal"]:
                    extra.append(st["replicas"].pop())
                    st["version"] += 1
                    self._publish(name)
        self._stop_replicas(extra)

    def _health_check_once(self) -> None:
        with self._lock:
            items = [(n, list(st["replicas"]))
                     for n, st in self._deployments.items()]
        for name, reps in items:
            for r in reps:
                try:
                    r.handle.control("check_health",
                                     timeout=self.HEALTH_CHECK_TIMEOUT_S)
                    r.health_fails = 0
                    continue
                except Exception:  # noqa: BLE001 — counted below
                    # a slow check is not death: replace only after
                    # consecutive failures
                    r.health_fails += 1
                    if r.health_fails < self.HEALTH_FAILS_TO_REPLACE:
                        continue
                with self._lock:
                    st = self._deployments.get(name)
                    if st is None or r not in st["replicas"]:
                        continue
                    st["replicas"].remove(r)
                    st["version"] += 1
                    self._publish(name)
                r.proc.kill()
                r.proc.join(5.0)
                r.conn.close()

    def _reconcile_loop(self) -> None:
        n = 0
        while not self._stop.is_set():
            try:
                self._poll_starting()
                self._prune_dead_replicas()
                self._reconcile_once()
                if n % self.HEALTH_CHECK_EVERY == self.HEALTH_CHECK_EVERY - 1:
                    self._health_check_once()
            except Exception:  # noqa: BLE001 — the loop outlives one bad tick
                import traceback

                traceback.print_exc()
            n += 1
            self._stop.wait(self.RECONCILE_INTERVAL_S)


_controller: Optional[ServeController] = None
_controller_lock = threading.Lock()
_store_clients: Dict[Any, kv_mod.RunKV] = {}


def get_controller(create: bool = True) -> Optional[ServeController]:
    """This process's controller (created on first use when ``create``)."""
    global _controller
    with _controller_lock:
        if _controller is None and create:
            _controller = ServeController()
        return _controller


def _drop_controller() -> Optional[ServeController]:
    global _controller
    with _controller_lock:
        ctrl, _controller = _controller, None
        return ctrl


def serve_store() -> kv_mod.RunKV:
    """The serve store: the controller's own in the driver, a connection
    to ``RAY_TPU_TORCH_SERVE_STORE`` in a replica."""
    ctrl = get_controller(create=False)
    if ctrl is not None:
        return ctrl.store
    addr = os.environ.get(ENV_SERVE_STORE)
    if not addr:
        raise RuntimeError(
            "serve is not running in this process: call serve.start() or "
            "serve.run() first (a replica finds the store in "
            f"{ENV_SERVE_STORE})")
    key = (addr, os.getpid())
    with _controller_lock:
        store = _store_clients.get(key)
        if store is None:
            store = _store_clients[key] = kv_mod.connect(addr)
        return store
