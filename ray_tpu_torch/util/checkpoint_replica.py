"""Peer-RAM checkpoint replica plane: host-memory shard replication
(counterpart of ``ray_tpu/util/checkpoint_replica.py``).

The emergency tier of the train checkpoint ladder (local RAM -> peer RAM
-> committed disk, see ``ray_tpu_torch.train.checkpoint_async``).  One
:class:`CheckpointReplicaServer` process serves each unit a run places
ranks on (a card ``cuda:<i>`` or a host slot ``slot:<i>``, as the health
plane names them).  The train controller owns these processes, outside
the worker group, so they survive the group restarts they exist for: a
restarted worker restores the shards a dead one pushed, with zero disk
reads.

Topology: rank ``r`` pushes its shard to the server of the unit of rank
``(r + 1) % world`` (a ring that skips its own unit where it can).  On one
card the ring degenerates: a rank replicates to its own unit's server,
which still outlives the worker.

Wire: the reference's actor calls become calls over a loopback
``multiprocessing.connection`` with an authkey, as ``serve/_wire.py``
reaches its replicas; a server's address and authkey are in the run's
store under ``ckpt_replica/<server name>``.  A shard's bytes follow its
call raw on the same socket (``sendall`` / ``recv_into`` a buffer of the
known size), never as one pickled message.  A server keeps blobs in its
own memory and reuses an evicted generation's buffer for the next, but
never one that a fetch is still sending: a fetch ships the blob that was
pushed, whatever pushes land meanwhile.

Every wait across processes is bounded (the RPC timeout,
``train_checkpoint_replica_rpc_timeout_s``): a dead or wedged server
degrades the ladder to disk, never hangs a restore.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private.config import knob
from ray_tpu_torch.util.fault_injection import fault_point

logger = logging.getLogger(__name__)

# generations of shard blobs a server retains per run (the newest
# complete one plus the one being written)
KEEP_GENERATIONS = 2
_KEY = "ckpt_replica/"
# bulk bytes move in pieces of this size
_PIECE = 64 << 20


def _rpc_timeout(timeout):
    """An explicit bound wins, else ``train_checkpoint_replica_rpc_timeout_s``."""
    return knob("train_checkpoint_replica_rpc_timeout_s") \
        if timeout is None else timeout


def server_name(run: str, node_id: str) -> str:
    """The name of the replica server of ``run`` on unit ``node_id``: a
    restarted worker re-finds its peers by it in the run's store."""
    return f"_ckpt_replica::{run}::{node_id}"


def _as_bytes_view(blob) -> memoryview:
    """A flat byte view of a blob (bytes-like, a numpy array or a CPU
    tensor)."""
    if hasattr(blob, "numpy") and hasattr(blob, "device"):
        blob = blob.numpy()
    return memoryview(blob).cast("B")


def _send_raw(conn, view: memoryview) -> None:
    sock = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        sock.setblocking(True)
        for off in range(0, len(view), _PIECE):
            sock.sendall(view[off:off + _PIECE])
    finally:
        sock.close()


def _recv_raw(conn, out: np.ndarray) -> None:
    mv = memoryview(out).cast("B")
    sock = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        sock.setblocking(True)
        got = 0
        while got < len(mv):
            n = sock.recv_into(mv[got:], min(len(mv) - got, _PIECE))
            if n == 0:
                raise EOFError("the peer closed mid-transfer")
            got += n
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class CheckpointReplicaServer:
    """Shard blobs of one run in host RAM, for one unit.

    Keyed storage: ``(ckpt_index, writer_rank) -> (blob, meta)``; a blob is
    the exact bytes the disk tier writes (``shard_rNN``), so a restore can
    reassemble from any mix of RAM and disk sources.  Retention is
    bounded to :data:`KEEP_GENERATIONS` indices."""

    def __init__(self, run: str):
        self._run = run
        self._gens: Dict[int, Dict[int, Tuple[np.ndarray,
                                              Dict[str, Any]]]] = {}
        self._lock = threading.Lock()
        self._spare: List[np.ndarray] = []  # evicted buffers, reused
        # id(blob) -> fetches still sending it: such a blob is never reused
        self._sending: Dict[int, int] = {}
        self._pushes = 0
        self._fetches = 0

    def buffer(self, nbytes: int) -> np.ndarray:
        """A buffer for an incoming blob: an evicted one of the same size
        when there is one (its pages are already faulted in)."""
        with self._lock:
            for i, b in enumerate(self._spare):
                if b.nbytes == nbytes:
                    return self._spare.pop(i)
        return np.empty(nbytes, np.uint8)

    def put_shard(self, index: int, writer_rank: int, blob: np.ndarray,
                  meta: Dict[str, Any]) -> bool:
        """Store one writer rank's shard of checkpoint ``index``; True is
        the replication ack."""
        with self._lock:
            old = self._gens.setdefault(index, {}).get(writer_rank)
            freed = [] if old is None else [old[0]]
            self._gens[index][writer_rank] = (blob, dict(meta))
            self._pushes += 1
            while len(self._gens) > KEEP_GENERATIONS:
                evicted = self._gens.pop(min(self._gens))
                freed += [b for b, _ in evicted.values()]
            # a blob a fetch is sending is left to that fetch, never reused
            self._spare += [b for b in freed if id(b) not in self._sending]
            del self._spare[:-1]  # keep one spare buffer
        return True

    def get_shard(self, index: int, writer_rank: int
                  ) -> Optional[Tuple[np.ndarray, Dict[str, Any]]]:
        """The stored ``(blob, meta)``, or None.  A fetch sends the blob
        after the lock is released, so the blob is not reused for another
        push until :meth:`checkin`."""
        with self._lock:
            got = self._gens.get(index, {}).get(writer_rank)
            if got is not None:
                self._fetches += 1
                key = id(got[0])
                self._sending[key] = self._sending.get(key, 0) + 1
            return got

    def checkin(self, blob: np.ndarray) -> None:
        with self._lock:
            key = id(blob)
            self._sending[key] -= 1
            if not self._sending[key]:
                del self._sending[key]

    def manifest(self) -> Dict[int, List[int]]:
        """``{ckpt_index: [writer_ranks held]}``."""
        with self._lock:
            return {idx: sorted(ranks) for idx, ranks in self._gens.items()}

    def manifest_meta(self) -> Dict[int, Dict[str, Any]]:
        """``{ckpt_index: {"ranks": [...], "world": w}}``, ``world`` the
        writing world size from the pushed meta (None if no shard carried
        it): lets clients judge a generation's completeness."""
        with self._lock:
            return {
                idx: {"ranks": sorted(shards),
                      "world": next((m["world"] for (_b, m) in shards.values()
                                     if m.get("world")), None)}
                for idx, shards in self._gens.items()}

    def drop(self, index: Optional[int] = None) -> None:
        with self._lock:
            if index is None:
                self._gens.clear()
            else:
                self._gens.pop(index, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"run": self._run, "pid": os.getpid(),
                    "generations": sorted(self._gens),
                    "shards": sum(len(g) for g in self._gens.values()),
                    "bytes": sum(b.nbytes for g in self._gens.values()
                                 for (b, _m) in g.values()),
                    "pushes": self._pushes, "fetches": self._fetches}


def _serve_conn(server: CheckpointReplicaServer, conn) -> None:
    """One caller's connection: ``(method, args)`` calls, each answered
    ``("ok", value)`` or ``("err", text)``.  ``put_shard``'s blob follows
    its call raw; ``get_shard``'s follows its answer."""
    try:
        while True:
            try:
                method, args = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                return
            got = None
            try:
                if method == "put_shard":
                    index, rank, nbytes, meta = args
                    buf = server.buffer(nbytes)
                    _recv_raw(conn, buf)
                    reply = ("ok", server.put_shard(index, rank, buf, meta))
                elif method == "get_shard":
                    got = server.get_shard(*args)
                    reply = ("ok", None if got is None else
                             (got[0].nbytes, got[1]))
                else:
                    reply = ("ok", getattr(server, method)(*args))
            except Exception as e:  # noqa: BLE001 — reported to the caller
                reply = ("err", f"{type(e).__name__}: {e}")
            if got is None:
                conn.send_bytes(pickle.dumps(reply))
                continue
            try:
                conn.send_bytes(pickle.dumps(reply))
                _send_raw(conn, memoryview(got[0]))
            finally:
                server.checkin(got[0])
    except (OSError, EOFError):
        pass
    finally:
        conn.close()


def _server_main(run: str, authkey: bytes, parent) -> None:
    """A replica server process: listen on loopback, send the address up
    the pipe, serve until the pipe's other end (the controller) is gone."""
    from multiprocessing.connection import AuthenticationError, Listener

    from ray_tpu_torch._private.net import LOOPBACK

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    server = CheckpointReplicaServer(run)
    listener = Listener((LOOPBACK, 0), authkey=authkey)
    parent.send(listener.address)

    def accept_loop():
        while True:
            try:
                conn = listener.accept()
            except AuthenticationError:
                continue
            except (OSError, EOFError):
                return
            threading.Thread(target=_serve_conn, args=(server, conn),
                             daemon=True, name="ckpt-replica-conn").start()

    threading.Thread(target=accept_loop, daemon=True,
                     name="ckpt-replica-accept").start()
    try:
        while True:
            parent.recv_bytes()  # only EOF ever arrives: the owner died
    except (EOFError, OSError):
        pass
    os._exit(0)


# ---------------------------------------------------------------------------
# the controller's side: one server process per unit
# ---------------------------------------------------------------------------


class ReplicaPlane:
    """Lifecycle of one run's replica servers, owned by the
    ``TrainController`` (not the worker group): a server is started once
    per unit and reused across group generations, so its RAM replicas
    survive the restarts they exist to serve.  Addresses go into the run's
    store ``kv``."""

    def __init__(self, run: str, kv=None):
        from ray_tpu_torch._private import kv as kv_mod

        self.run = run
        self.kv = kv if kv is not None else kv_mod.client()
        self._servers: Dict[str, Tuple[Any, Any]] = {}  # unit -> proc, pipe
        self._starting: Dict[str, Tuple[Any, Any, bytes]] = {}

    def start(self, node_ids: Sequence[str]) -> None:
        """Spawn a server for each unit that has none yet, without waiting
        for it (the controller starts them beside the workers, whose
        start-up they would otherwise add to)."""
        from ray_tpu_torch._private import worker_zygote

        ctx = worker_zygote.get_context()
        for node_id in node_ids:
            if not node_id or node_id in self._servers \
                    or node_id in self._starting:
                continue
            authkey = os.urandom(16)
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_server_main,
                               args=(self.run, authkey, child), daemon=True,
                               name=f"ckpt-replica-{node_id}")
            proc.start()
            child.close()
            self._starting[node_id] = (proc, parent, authkey)

    def ensure_for_nodes(self, node_ids: Sequence[str],
                         timeout: float = 120.0) -> None:
        """Start one server for each unit that has none yet (idempotent);
        waits, bounded, for each to listen and records its address."""
        self.start(node_ids)
        for node_id in node_ids:
            got = self._starting.pop(node_id, None)
            if got is None:
                continue
            proc, parent, authkey = got
            if not parent.poll(timeout):
                proc.kill()
                raise TimeoutError(f"replica server for {node_id} did not "
                                   f"listen within {timeout:g} s")
            address = parent.recv()
            self._servers[node_id] = (proc, parent)
            self.kv.put(_KEY + server_name(self.run, node_id), json.dumps({
                "address": list(address), "authkey": authkey.hex(),
                "pid": proc.pid}).encode())

    def drop_node(self, node_id: str) -> None:
        """Kill the server on ``node_id`` and forget it."""
        got = self._servers.pop(node_id, None)
        try:
            self.kv.delete(_KEY + server_name(self.run, node_id))
        except Exception:  # noqa: BLE001 — the store may be gone
            pass
        if got is not None:
            proc, pipe = got
            proc.kill()
            proc.join(10)
            pipe.close()

    def pid(self, node_id: str) -> Optional[int]:
        got = self._servers.get(node_id)
        return None if got is None else got[0].pid

    @property
    def node_ids(self) -> List[str]:
        return list(self._servers)

    def server_names(self) -> List[str]:
        return [server_name(self.run, n) for n in self._servers]

    def peer_assignment(self, worker_node_ids: Sequence[str]) -> List[str]:
        """Per-rank peer server name: rank ``r`` replicates to the server
        of the unit of rank ``(r+1) % world``, skipping forward to the
        first rank on another unit when there is one.  On one unit the
        local server is the only (degenerate) choice."""
        world = len(worker_node_ids)
        names: List[str] = []
        for r in range(world):
            chosen = worker_node_ids[(r + 1) % world]
            for step in range(1, world):
                cand = worker_node_ids[(r + step) % world]
                if cand != worker_node_ids[r]:
                    chosen = cand
                    break
            names.append(server_name(self.run, chosen))
        return names

    def ram_manifest(self, timeout: Optional[float] = None
                     ) -> Dict[int, List[int]]:
        """Union of every live server's manifest; dead or slow servers are
        skipped (bounded)."""
        return ram_manifest_by_names(self.server_names(), timeout=timeout,
                                     kv=self.kv)

    def shutdown(self) -> None:
        for proc, pipe, _ in self._starting.values():
            proc.kill()
            proc.join(10)
            pipe.close()
        self._starting.clear()
        for node_id in list(self._servers):
            self.drop_node(node_id)


# ---------------------------------------------------------------------------
# the worker's side: servers found by name in the run's store
# ---------------------------------------------------------------------------


def _lookup(name: str, kv=None) -> Tuple[Tuple[str, int], bytes]:
    from ray_tpu_torch._private import kv as kv_mod

    raw = (kv if kv is not None else kv_mod.client()).get(_KEY + name)
    if raw is None:
        raise LookupError(f"no replica server {name!r} in the run's store")
    rec = json.loads(raw)
    return tuple(rec["address"]), bytes.fromhex(rec["authkey"])


def _call(name: str, method: str, args: tuple = (), *, timeout: float,
          send: Optional[memoryview] = None, recv: bool = False, kv=None):
    """One call to server ``name`` on a connection of its own, the
    connect, the call and any bulk bytes all within ``timeout``: the work
    runs on a helper thread, and past the bound the connection is closed
    under it and ``TimeoutError`` raised."""
    from multiprocessing.connection import Client

    address, authkey = _lookup(name, kv)
    box: Dict[str, Any] = {}

    def run():
        try:
            conn = Client(address, authkey=authkey)
            box["conn"] = conn
            try:
                conn.send_bytes(pickle.dumps((method, args)))
                if send is not None:
                    _send_raw(conn, send)
                status, value = pickle.loads(conn.recv_bytes())
                if status != "ok":
                    raise RuntimeError(f"replica server {name}: {value}")
                if recv and value is not None:
                    nbytes, meta = value
                    out = np.empty(nbytes, np.uint8)
                    _recv_raw(conn, out)
                    value = (out, meta)
                box["value"] = value
            finally:
                conn.close()
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            box["error"] = e

    th = threading.Thread(target=run, daemon=True, name="ckpt-replica-call")
    th.start()
    th.join(timeout)
    if th.is_alive():
        conn = box.get("conn")
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        raise TimeoutError(f"replica server {name}: {method} did not finish "
                           f"within {timeout:g} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def push_shard(peer_name: str, index: int, writer_rank: int, blob,
               meta: Dict[str, Any], timeout: Optional[float] = None,
               kv=None) -> bool:
    """Replicate one shard blob to the peer's RAM.  True only on an
    explicit ack; any failure (a dead peer, the bound, a fault armed at
    ``train.checkpoint.peer_push``) is False: the checkpoint is then
    durable only at the tiers that did land."""
    fault_point("train.checkpoint.peer_push")
    view = _as_bytes_view(blob)
    try:
        ack = _call(peer_name, "put_shard",
                    (index, writer_rank, len(view), dict(meta)),
                    timeout=_rpc_timeout(timeout), send=view, kv=kv)
        return ack is True
    except Exception as e:  # noqa: BLE001 — the tier failed
        logger.warning("peer-RAM push of checkpoint_%06d rank %d to %s "
                       "failed: %r", index, writer_rank, peer_name, e)
        return False


def fetch_shard(server_names_: Sequence[str], index: int, writer_rank: int,
                timeout: Optional[float] = None,
                deadline_s: float = 120.0, kv=None
                ) -> Optional[Tuple[np.ndarray, Dict[str, Any]]]:
    """One writer rank's shard from whichever live server holds it (each
    call bounded, all of them by ``deadline_s``); None means the RAM tier
    lost it and the ladder falls through to disk."""
    timeout = _rpc_timeout(timeout)
    deadline = time.monotonic() + deadline_s
    for name in server_names_:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            got = _call(name, "get_shard", (index, writer_rank),
                        timeout=min(timeout, max(0.1, left)), recv=True,
                        kv=kv)
        except Exception:  # noqa: BLE001 — dead or slow: the next one
            continue
        if got is not None:
            return got
    return None


def _manifests(server_names_: Sequence[str], method: str,
               timeout: Optional[float], kv=None) -> List[Dict[int, Any]]:
    out = []
    for name in server_names_:
        try:
            out.append(_call(name, method, timeout=_rpc_timeout(timeout),
                             kv=kv))
        except Exception:  # noqa: BLE001 — a dead server shrinks the union
            continue
    return out


def ram_manifest_by_names(server_names_: Sequence[str],
                          timeout: Optional[float] = None,
                          kv=None) -> Dict[int, List[int]]:
    """Union manifest of the named servers: ``{ckpt_index: sorted writer
    ranks held anywhere}``."""
    union: Dict[int, set] = {}
    for mf in _manifests(server_names_, "manifest", timeout, kv):
        for idx, ranks in mf.items():
            union.setdefault(idx, set()).update(ranks)
    return {idx: sorted(r) for idx, r in union.items()}


def ram_complete_generations(server_names_: Sequence[str],
                             timeout: Optional[float] = None,
                             kv=None) -> List[int]:
    """Sorted indices whose shard set is COMPLETE across the plane's RAM
    (every writer rank ``0..world-1`` of the generation's own world held
    somewhere).  First-save index discovery keys on this: a sibling's
    half-pushed generation is presence, not a generation."""
    ranks_by_idx: Dict[int, set] = {}
    world_by_idx: Dict[int, int] = {}
    for mf in _manifests(server_names_, "manifest_meta", timeout, kv):
        for idx, info in mf.items():
            ranks_by_idx.setdefault(idx, set()).update(info["ranks"])
            if info.get("world"):
                world_by_idx[idx] = info["world"]
    return sorted(
        idx for idx, ranks in ranks_by_idx.items()
        if idx in world_by_idx and ranks >= set(range(world_by_idx[idx])))
