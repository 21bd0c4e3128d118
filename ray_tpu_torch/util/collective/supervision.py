"""Collective supervision: flight recorder, watchdog threads, abort
(counterpart of ``ray_tpu/util/collective/supervision.py``).

The spine that turns a silent collective hang into an attributable,
recoverable failure (reference: PyTorch distributed's NCCL watchdog +
``TORCH_NCCL_TRACE_BUFFER`` flight recorder):

- every op on every member gets a monotonically increasing **sequence
  number** and a bounded in-memory **flight recorder** entry
  (seq, op, group, rank, shape/dtype, t_start, t_end, status);
- a per-group **watchdog thread** aborts the group when an op exceeds the
  configured ``timeout_s`` (group init option,
  ``RAY_TPU_TORCH_COLLECTIVE_TIMEOUT`` env, or 120 s);
- ``abort()`` asks the transport to give up any blocked op, marks the
  group ``ABORTED``, and makes current and future ops raise
  :class:`~ray_tpu_torch.exceptions.CollectiveAbortError` carrying the
  diagnosis of which op and seq ended it;
- the watchdog heartbeats each member's progress (state, last completed
  seq, in-flight op) into the run's KV (``_private/kv.py``), where
  peers read it for their diagnoses.

The reference's watchdog also aborts on GCS node and actor death and on
node drain events; the port has no GCS, so a member's death surfaces as
its peers' transport error or timeout, and the train controller sees the
dead process itself.

``destroy_group`` + ``init_collective_group`` on an aborted group is the
supported re-init path: rendezvous keys are epoch-versioned, so a
re-formed group can never join a stale incarnation.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch._private.durations import note_duration
from ray_tpu_torch.exceptions import CollectiveAbortError
from ray_tpu_torch.util.collective.types import GroupState, ReduceOp
from ray_tpu_torch.util.fault_injection import fault_point

logger = logging.getLogger(__name__)

ENV_TIMEOUT = "RAY_TPU_TORCH_COLLECTIVE_TIMEOUT"
ENV_TRACE_BUFFER = "RAY_TPU_TORCH_COLLECTIVE_TRACE_BUFFER"
DEFAULT_TIMEOUT_S = 120.0  # the reference's ``collective_op_timeout_s``

# errors meaning the transport under a collective died (peer gone, the
# transport's own timeout, the store vanished) — any of these mid-op
# aborts the group; application errors (bad shapes caught before
# dispatch, unknown ops) surface as themselves
_TRANSPORT_ERRS = (ConnectionError, OSError, EOFError, TimeoutError)


def resolve_timeout(timeout_s: Optional[float] = None) -> float:
    """Effective per-op timeout: explicit arg >
    ``RAY_TPU_TORCH_COLLECTIVE_TIMEOUT`` env > 120 s."""
    if timeout_s is not None:
        return float(timeout_s)
    env = os.environ.get(ENV_TIMEOUT)
    if env:
        return float(env)
    return DEFAULT_TIMEOUT_S


def _shape_of(t) -> Optional[tuple]:
    s = getattr(t, "shape", None)
    if s is None:
        return None
    try:
        return tuple(s)
    except TypeError:
        return None


def _dtype_of(t) -> Optional[str]:
    d = getattr(t, "dtype", None)
    return str(d) if d is not None else None


class FlightRecorder:
    """Process-wide bounded per-group trace of collective ops."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._by_group: Dict[str, deque] = {}

    def start(self, group: str, rank: int, op: str, seq: int,
              shape, dtype) -> Dict[str, Any]:
        entry = {
            "group": group, "rank": rank, "op": op, "seq": seq,
            "shape": shape, "dtype": dtype,
            "t_start": time.time(), "t_end": None, "status": "in_flight",
        }
        with self._lock:
            q = self._by_group.setdefault(group, deque(maxlen=self.capacity))
            q.append(entry)
        return entry

    def finish(self, entry: Dict[str, Any], status: str) -> None:
        entry["t_end"] = time.time()
        entry["status"] = status

    def dump(self, group_name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if group_name is not None:
                return [dict(e) for e in self._by_group.get(group_name, ())]
            out: List[Dict[str, Any]] = []
            for q in self._by_group.values():
                out.extend(dict(e) for e in q)
            return out

    def drop(self, group_name: str) -> None:
        with self._lock:
            self._by_group.pop(group_name, None)


_recorder = FlightRecorder(int(os.environ.get(ENV_TRACE_BUFFER, "256") or 256))


def flight_recorder_dump(group_name: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
    """This process's flight-recorder entries (all groups, or one)."""
    return _recorder.dump(group_name)


def format_flight_tail(group_name: str, n: int = 8) -> str:
    """Human-readable tail of the recorder for abort diagnoses/logs."""
    entries = _recorder.dump(group_name)[-n:]
    if not entries:
        return "  (flight recorder empty)"
    lines = []
    for e in entries:
        dur = (f"{(e['t_end'] - e['t_start']) * 1000:.1f}ms"
               if e["t_end"] else
               f"in flight {time.time() - e['t_start']:.1f}s")
        lines.append(
            f"  seq={e['seq']} op={e['op']} rank={e['rank']} "
            f"shape={e['shape']} dtype={e['dtype']} "
            f"status={e['status']} ({dur})")
    return "\n".join(lines)


def _status_key(group_name: str, rank: int) -> str:
    return f"collective/{group_name}/status/{rank}"


def _run_kv() -> Optional[kv_mod.RunKV]:
    """The run's KV, or None in a process that has none."""
    if kv_mod.address() is None:
        return None
    return kv_mod.client()


def drop_group_status_keys(group_name: str) -> None:
    """Sweep a group's member status records: a new incarnation's rank 0
    calls this after bumping the epoch, so records of ranks that died
    without cleanup cannot haunt the re-formed group's diagnoses."""
    try:
        kv = _run_kv()
        if kv is None:
            return
        for key in kv.keys(f"collective/{group_name}/status/"):
            kv.delete(key)
    except Exception:  # noqa: BLE001 — best-effort hygiene
        pass


def drop_group_keys(group_name: str) -> None:
    """Best-effort sweep of a group's KV footprint (rendezvous entry,
    member status records).  The epoch COUNTER is deliberately kept: a
    straggler from a destroyed generation may still be polling
    rendezvous, and must never pass the next incarnation's epoch
    check."""
    try:
        kv = _run_kv()
        if kv is None:
            return
        prefix = f"collective/{group_name}/"
        for key in kv.keys(prefix):
            if key != f"{prefix}epoch":
                kv.delete(key)
    except Exception:  # noqa: BLE001 — the store may already be down
        pass


def aggregate_status_records(records) -> List[Dict[str, Any]]:
    """Fold per-member status records (the watchdog KV heartbeats) into
    per-group summaries (the reference's one aggregation behind its
    state API, CLI and dashboard; here the health plane's reader of
    member records)."""
    # ghosts first: records of a dead incarnation that escaped the
    # leader's sweep must not merge into (or ABORT-promote) the current
    # epoch's summary
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("group_name"):
            by_name.setdefault(rec["group_name"], []).append(rec)
    records = []
    for recs in by_name.values():
        top = max(r.get("epoch", 0) for r in recs)
        records.extend(r for r in recs if r.get("epoch", 0) == top)
    groups: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        name = rec.get("group_name")
        if not name:
            continue
        g = groups.setdefault(name, {
            "group_name": name,
            "world_size": rec.get("world_size"),
            "backend": rec.get("backend", ""),
            "epoch": rec.get("epoch", 0),
            "state": "READY",
            "members": [],
        })
        g["members"].append(rec)
        g["epoch"] = max(g["epoch"], rec.get("epoch", 0))
        if rec.get("state") == "ABORTED":
            g["state"] = "ABORTED"
            if rec.get("abort_reason"):
                g["abort_reason"] = rec["abort_reason"]
    for g in groups.values():
        g["members"].sort(key=lambda m: m.get("rank") or 0)
        g["joined"] = len(g["members"])
    return sorted(groups.values(), key=lambda g: g["group_name"])


def _supervised(fn):
    """Route a group op through the supervision spine (seq number, flight
    recorder, ``collective.op`` fault site, abort-aware error mapping)."""

    @functools.wraps(fn)
    def wrapper(self: "SupervisedGroup", *args, **kwargs):
        return self._execute(fn.__name__, fn, args, kwargs)

    wrapper.__supervised__ = True
    return wrapper


class SupervisedGroup:
    """Wraps a backend group with the supervision spine.

    Every op: sequence number + flight-recorder entry + the
    ``collective.op`` fault site; transport failures and watchdog aborts
    surface as ``CollectiveAbortError`` with a diagnosis.  A per-group
    :class:`Watchdog` enforces the op timeout.
    """

    def __init__(self, inner, *, timeout_s: Optional[float] = None,
                 backend: str = ""):
        self._inner = inner
        self._timeout_s = resolve_timeout(timeout_s)
        self._backend = str(backend)
        self._state = GroupState.READY
        self._abort_info: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._last_done_seq = 0  # seq of the last success
        self._lock = threading.Lock()
        self._inflight: Optional[Dict[str, Any]] = None
        self._publish_status()
        self._watchdog = Watchdog(self)
        self._watchdog.start()

    # -- delegated identity -------------------------------------------------
    @property
    def rank(self) -> int:
        return self._inner.rank

    @property
    def world_size(self) -> int:
        return self._inner.world_size

    @property
    def group_name(self) -> str:
        return self._inner.group_name

    @property
    def state(self) -> GroupState:
        return self._state

    @property
    def timeout_s(self) -> float:
        return self._timeout_s

    def __getattr__(self, name):
        # backend extras (.device, .epoch, ...) pass through
        if name.startswith("__") or name == "_inner":
            raise AttributeError(name)
        return getattr(self.__dict__["_inner"], name)

    # -- supervised ops -----------------------------------------------------
    # every public collective op routes through _execute (seq + flight
    # recorder + ``collective.op`` site + abort mapping)

    @_supervised
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return self._inner.allreduce(tensor, op)

    @_supervised
    def barrier(self) -> None:
        return self._inner.barrier()

    @_supervised
    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        return self._inner.reduce(tensor, dst_rank, op)

    @_supervised
    def broadcast(self, tensor, src_rank: int = 0):
        return self._inner.broadcast(tensor, src_rank)

    @_supervised
    def allgather(self, tensor):
        return self._inner.allgather(tensor)

    @_supervised
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return self._inner.reducescatter(tensor, op)

    @_supervised
    def send(self, tensor, dst_rank: int, tag: int = 0) -> None:
        return self._inner.send(tensor, dst_rank, tag)

    @_supervised
    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        return self._inner.recv(shape, dtype, src_rank, tag)

    @_supervised
    def permute(self, tensor, perm):
        return self._inner.permute(tensor, perm)

    # -- the spine ----------------------------------------------------------
    def _execute(self, op: str, fn, args, kwargs):
        with self._lock:
            if self._state is not GroupState.READY:
                raise self._abort_error(op, None)
            self._seq += 1
            seq = self._seq
        tensor = args[0] if args else None
        entry = _recorder.start(self.group_name, self.rank, op, seq,
                                _shape_of(tensor), _dtype_of(tensor))
        self._inflight = entry
        try:
            fault_point("collective.op")
            try:
                out = fn(self, *args, **kwargs)
            finally:
                # the op's wall time feeds the step ledger's
                # collective_wait bucket, on failure too
                note_duration("collective_wait",
                              time.time() - entry["t_start"])
            if self._state is GroupState.ABORTED:
                # the watchdog fired while this op was still running and
                # the backend could not interrupt it: a locally-completed
                # result must not read as success on this rank only
                _recorder.finish(entry, "aborted")
                raise self._abort_error(op, seq)
            _recorder.finish(entry, "done")
            self._last_done_seq = seq
            return out
        except CollectiveAbortError as e:
            _recorder.finish(entry, "aborted")
            self._mark_aborted(e.reason or str(e), diagnosis=e.diagnosis)
            raise
        except BaseException as e:  # noqa: BLE001 — classified below
            if self._state is GroupState.ABORTED:
                # the watchdog aborted while this op was blocked: the
                # transport error is the abort surfacing, not the cause
                _recorder.finish(entry, "aborted")
                raise self._abort_error(op, seq) from e
            if isinstance(e, _TRANSPORT_ERRS):
                _recorder.finish(entry, "aborted")
                self.abort(f"transport failure during {op} seq={seq}: "
                           f"{e!r}")
                raise self._abort_error(op, seq) from e
            _recorder.finish(entry, "error")
            raise
        finally:
            self._inflight = None

    def _abort_error(self, op: str, seq: Optional[int]
                     ) -> CollectiveAbortError:
        info = self._abort_info or {}
        return CollectiveAbortError(
            group_name=self.group_name, rank=self.rank, seq=seq,
            reason=info.get("reason", f"group aborted (op {op} rejected)"),
            diagnosis=info.get("diagnosis", ""))

    def _mark_aborted(self, reason: str, diagnosis: str = "") -> bool:
        with self._lock:
            if self._state is not GroupState.READY:
                return False
            self._state = GroupState.ABORTED
            self._abort_info = {"reason": reason, "diagnosis": diagnosis,
                                "t": time.time()}
        return True

    def abort(self, reason: str, diagnosis: str = "") -> None:
        """Abort the group: ask the transport to give up (unblocking any
        op stuck in it where it can), mark ABORTED, log the flight
        recorder."""
        if not diagnosis:
            diagnosis = ("flight recorder (this rank):\n"
                         + format_flight_tail(self.group_name))
        if not self._mark_aborted(reason, diagnosis):
            return
        try:
            self._inner.abort(reason)
        except Exception:  # noqa: BLE001 — transport may already be gone
            pass
        logger.error(
            "collective group %r rank %d ABORTED: %s\n%s",
            self.group_name, self.rank, reason, diagnosis)
        self._publish_status()

    # -- lifecycle ----------------------------------------------------------
    def destroy_group(self) -> None:
        with self._lock:
            self._state = GroupState.DESTROYED
        self._watchdog.stop()
        try:
            kv = _run_kv()
            if kv is not None:
                kv.delete(_status_key(self.group_name, self.rank))
        except Exception:  # noqa: BLE001 — the store may be down
            pass
        _recorder.drop(self.group_name)
        self._inner.destroy_group()

    # -- run-visible status -------------------------------------------------
    def _status_record(self) -> Dict[str, Any]:
        inflight = self._inflight
        rec = {
            "group_name": self.group_name,
            "rank": self.rank,
            "world_size": self.world_size,
            "backend": self._backend,
            "epoch": getattr(self._inner, "epoch", 0),
            "state": self._state.value,
            "pid": os.getpid(),
            # the card or slot this rank is bound to: the health plane
            # maps ranks to the units it judges through it
            "node_id": accelerators.node_id(),
            "last_done_seq": self._last_done_seq,
            "op_count": self._seq,
            "inflight": ({"op": inflight["op"], "seq": inflight["seq"],
                          "t_start": inflight["t_start"]}
                         if inflight else None),
            "timeout_s": self._timeout_s,
            "t": time.time(),
        }
        if self._abort_info:
            rec["abort_reason"] = self._abort_info["reason"]
        return rec

    def _publish_status(self) -> None:
        if self._state is GroupState.DESTROYED:
            # destroy_group deleted our status key; a late watchdog tick
            # must not resurrect it
            return
        try:
            kv = _run_kv()
            if kv is not None:
                kv.put(_status_key(self.group_name, self.rank),
                       json.dumps(self._status_record()).encode())
        except Exception:  # noqa: BLE001 — best-effort surfacing
            pass


class Watchdog(threading.Thread):
    """Per-group supervisor: op-timeout abort and progress heartbeats
    into the run's KV.

    The backend's own op timeout (gloo's) usually ends a hung op first,
    as a transport error; this thread is the backstop for a transport
    that does not time out by itself, one tick past ``timeout_s``.
    """

    def __init__(self, group: SupervisedGroup):
        self._group = group
        self._interval = max(0.25, min(1.0, group.timeout_s / 4.0))
        super().__init__(
            daemon=True, name=f"coll-watchdog-{group.group_name}")
        self._stop_evt = threading.Event()
        self._members: Dict[int, Dict[str, Any]] = {}
        self._members_refreshed = 0.0
        self._last_published: Any = None

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        g = self._group
        while not self._stop_evt.wait(self._interval):
            if g._state is not GroupState.READY:
                self._heartbeat()
                return
            try:
                entry = g._inflight
                if entry is not None and entry["t_end"] is None:
                    age = time.time() - entry["t_start"]
                    if age > g.timeout_s + 2 * self._interval:
                        g.abort(
                            f"op {entry['op']} seq={entry['seq']} exceeded "
                            f"timeout ({age:.1f}s > {g.timeout_s:.1f}s) — "
                            f"a peer is behind or gone",
                            diagnosis=self._peer_diagnosis())
                        continue
                self._heartbeat()
            except Exception:  # noqa: BLE001 — supervisor must not die
                logger.debug("collective watchdog tick failed",
                             exc_info=True)

    # -- KV heartbeat -------------------------------------------------------
    def _heartbeat(self) -> None:
        g = self._group
        rec = g._status_record()
        fingerprint = (rec["state"], rec["last_done_seq"],
                       bool(rec["inflight"]))
        # publish on change, and periodically while an op is in flight so
        # peers can diagnose who is behind from a fresh record
        if fingerprint != self._last_published or rec["inflight"]:
            self._last_published = fingerprint
            g._publish_status()

    def _refresh_members(self) -> None:
        now = time.time()
        if self._members and now - self._members_refreshed < 5.0:
            return
        g = self._group
        try:
            kv = _run_kv()
            if kv is None:
                return
            for key in kv.keys(f"collective/{g.group_name}/status/"):
                raw = kv.get(key)
                if not raw:
                    continue
                rec = json.loads(raw)
                # a record from another incarnation must not enter this
                # group's view
                if rec.get("epoch", 0) != getattr(g._inner, "epoch", 0):
                    continue
                self._members[int(rec["rank"])] = rec
            self._members_refreshed = now
        except Exception:  # noqa: BLE001 — KV hiccup
            pass

    def _peer_diagnosis(self) -> str:
        """Who is behind, from the peers' last KV heartbeats + the local
        flight recorder."""
        g = self._group
        lines = [f"flight recorder (rank {g.rank}):",
                 format_flight_tail(g.group_name)]
        self._refresh_members()
        if self._members:
            lines.append("peer progress (last heartbeat):")
            for rank, rec in sorted(self._members.items()):
                inflight = rec.get("inflight")
                where = (f"in flight op={inflight['op']} "
                         f"seq={inflight['seq']}" if inflight
                         else f"idle after seq={rec.get('last_done_seq')}")
                lines.append(
                    f"  rank {rank}: {rec.get('state')} {where} "
                    f"(heartbeat {time.time() - rec.get('t', 0):.1f}s ago)")
        return "\n".join(lines)
