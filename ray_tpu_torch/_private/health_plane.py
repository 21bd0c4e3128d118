"""HealthMonitor: the driving loop of the hardware health plane
(counterpart of ``ray_tpu/_private/health_plane.py``).

``ray_tpu_torch.util.health`` owns the pure math (median/MAD outlier
test, hysteresis, signal extractors, verdict records); this module owns
the *loop* that turns the ledgers a run publishes into verdicts on its
units and actuates them:

1. **Passive scoring** (every ``health_monitor_interval_s``): read the
   per-rank step records (``train/step_breakdown/<group>/<rank>`` in the
   run's key-value store) and score each group with
   :func:`~ray_tpu_torch.util.health.score_step_records`: the straggler
   is the rank with outlier *own time* whose ``collective_wait`` is
   below the group median.  Collective status records corroborate
   (completed-seq lag, in-flight op age) and map ranks to units.
2. **Active confirmation** (on SUSPECT, after ``health_suspect_windows``
   consecutive outlier windows): run :func:`_probe_payload` (a timed
   matmul loop threaded through the ``health.probe`` fault site, a ring
   ping over the probing process's cards, the SDC canary) in a process
   bound to the suspect unit AND to a healthy reference unit.
   Suspect/reference elapsed ratio >= ``health_probe_factor`` confirms
   *slow*; a canary digest mismatch confirms *corrupting* (hardware); a
   probe that times out while the reference answered confirms by
   silence.
3. **Quarantine** (on CONFIRMED): the unit moves to QUARANTINED on the
   run's node-health ladder (:func:`set_node_health`).  The train
   controller then asks the group for a checkpoint, restarts it without
   charging ``FailureConfig.max_failures``, and places no rank on the
   unit again.

The unit judged here is the card a worker is bound to (``"cuda:<i>"``)
or a host worker's slot (``"slot:<i>"``): every port process on one
machine is one node, so the card is the smallest unit that can be sick
on its own.  The node-health ladder, the GCS's ``set_node_health`` in
the reference, lives in the run's key-value store (``health/node/<id>``).

An optional **probe sweep** leg (``probe_sweep=True``) periodically
probes every unit of the run and MAD-tests the elapsed times, so
detection needs no train group's records; any canary mismatch
quarantines at once.

The reference counts its work on ``health_*`` Counters and Gauges; the
port has no metrics plane, so the same counts are plain numbers in
:meth:`HealthMonitor.summary` (``counts``, ``probe_s``).  Every verdict
is also published as a :class:`~ray_tpu_torch.util.health.HealthVerdict`
record (``health/verdict/<kind>/<subject>``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.util import health as H
from ray_tpu_torch.util.fault_injection import fault_point

logger = logging.getLogger(__name__)

_STEP_PREFIX = "train/step_breakdown/"
_COLLECTIVE_PREFIX = "collective/"
_NODE_PREFIX = "health/node/"
_UNITS_KEY = "health/units"

# the reference's knobs (``ray_tpu/_private/config.py``), with its
# values; the monitor's constructor overrides its own
DEFAULTS = {
    "health_monitor_interval_s": 2.0,
    "health_mad_threshold": 3.5,
    "health_suspect_windows": 3,
    "health_probe_factor": 2.0,
    "health_probe_timeout_s": 30.0,
    # how long a quarantined unit's group has for its checkpoint
    "health_quarantine_drain_deadline_s": 15.0,
    # the controller's wait for that checkpoint (also capped by the
    # deadline above)
    "train_drain_checkpoint_wait_s": 10.0,
}


# ---------------------------------------------------------------------------
# the node-health ladder in the run's key-value store
# ---------------------------------------------------------------------------


def node_health(kv) -> Dict[str, Dict[str, Any]]:
    """Every unit's ladder record in the run ``kv``: ``{node_id: {"health",
    "reason", "hw_confirmed", "ts", "drain_deadline"}}`` (units never
    judged have none and are HEALTHY)."""
    out = {}
    for key in kv.keys(_NODE_PREFIX):
        raw = kv.get(key)
        if raw is not None:
            out[key[len(_NODE_PREFIX):]] = json.loads(raw)
    return out


def set_node_health(kv, node_id: str, health: str, reason: str = "",
                    hw_confirmed: bool = False) -> Dict[str, Any]:
    """Move ``node_id`` on the ladder (HEALTHY -> SUSPECT -> QUARANTINED).
    QUARANTINED is sticky: verdicts only escalate, and the way back for
    the capacity is another card.  A quarantine carries the deadline of
    the drain it opens (``health_quarantine_drain_deadline_s`` from
    now); the train controller reads it.  Returns the reference's
    acknowledgement: ``{"accepted", "node_id", "health", "previous"}``
    or ``{"accepted": False, "rejection_reason"}``."""
    if health not in (H.HEALTHY, H.SUSPECT, H.QUARANTINED):
        return {"accepted": False,
                "rejection_reason": f"unknown health {health!r}"}
    key = _NODE_PREFIX + node_id
    raw = kv.get(key)
    prev = json.loads(raw) if raw else {"health": H.HEALTHY}
    if prev["health"] == H.QUARANTINED and health != H.QUARANTINED:
        return {"accepted": False, "health": prev["health"],
                "rejection_reason": "QUARANTINED is sticky"}
    now = time.time()
    rec = {"health": health, "reason": reason,
           "hw_confirmed": bool(hw_confirmed or prev.get("hw_confirmed")),
           "ts": now}
    if health == H.QUARANTINED:
        rec["drain_deadline"] = prev.get("drain_deadline") or (
            now + DEFAULTS["health_quarantine_drain_deadline_s"])
    if prev["health"] != health:
        logger.warning("unit %s health %s -> %s: %s", node_id,
                       prev["health"], health, reason or "<no reason>")
    kv.put(key, json.dumps(rec).encode())
    return {"accepted": True, "node_id": node_id, "health": health,
            "previous": prev["health"]}


def publish_units(kv, units: List[str]) -> None:
    """Record the units a run may place ranks on (the monitor's view of
    the alive nodes)."""
    kv.put(_UNITS_KEY, json.dumps(list(units)).encode())


# ---------------------------------------------------------------------------
# the active probe, in a process bound to the probed unit
# ---------------------------------------------------------------------------


def _probe_payload(n: int = 96, iters: int = 30, seed: int = 7) -> Dict:
    """The active probe body, run in a process bound to the probed unit.

    Three measurements: a timed small matmul loop threaded through the
    ``health.probe`` fault site (so rehearsed degradation, the ``slow``
    kind armed on the unit, shows up exactly like a slow card), a ring
    ping over this process's cards when it sees more than one (one K4
    launch per hop, ``device_ring_copy``; the reference's ``ppermute``
    ring; none with one card), and the SDC canary digest (an int64
    modular matmul chain, bit-exact on every honest host)."""
    import time as _t

    import numpy as np

    from ray_tpu_torch._private.accelerators import node_id
    from ray_tpu_torch.util import health as _health
    from ray_tpu_torch.util.fault_injection import fault_point as _fp

    out: Dict[str, Any] = {"node_id": node_id()}
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    a @ b  # the first product of a fresh process, outside the clock
    t0 = _t.monotonic()
    for _ in range(iters):
        a = (a @ b) / float(n)
        _fp("health.probe")
    out["elapsed_s"] = _t.monotonic() - t0
    out.update(_ring_ping())
    out["digest"] = _health.sdc_digest(seed=seed)
    return out


def _ring_ping(numel: int = 128) -> Dict[str, Any]:
    """One timed ring ping over this process's cards: each card's tensor
    moves to the next card (``device_ring_copy``, one K4 launch per hop),
    after an untimed ping that builds and loads the kernel.  Nothing
    with fewer than two cards, or where CUDA is not initialised."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized() or \
            torch.cuda.device_count() < 2:
        return {}
    from ray_tpu_torch.experimental.channel.transport import \
        device_ring_copy
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy

    n = torch.cuda.device_count()
    shards = [torch.arange(numel, dtype=torch.float32, device=f"cuda:{i}")
              + 1000 * i for i in range(n)]
    device_ring_copy(shards)
    for i in range(n):
        torch.cuda.synchronize(i)
    before = remote_copy.launches
    t1 = time.monotonic()
    landed = device_ring_copy(shards)
    for i in range(n):
        torch.cuda.synchronize(i)
    ping_s = time.monotonic() - t1
    return {"ppermute_s": ping_s, "ping_hops": n,
            "ping_k4_launches": remote_copy.launches - before,
            "ping_bit_equal": all(
                torch.equal(landed[(i + 1) % n].cpu(), shards[i].cpu())
                for i in range(n))}


def _bound_main(conn, node_id: str, kv_addr: Optional[str], fn, args):
    """A process bound to ``node_id``: its card made current (the process
    sees every card of the node), the faults armed on the unit armed here
    too, then ``fn(*args)``; its result (or an error) goes back on
    ``conn``."""
    from ray_tpu_torch._private import accelerators
    from ray_tpu_torch._private import node_faults

    os.environ[accelerators.ENV_NODE_ID] = node_id
    try:
        if node_id.startswith("cuda:"):
            import torch

            torch.cuda.set_device(accelerators.unit_index(node_id))
            torch.zeros(1, device="cuda")  # the context, outside fn
        if kv_addr:
            from ray_tpu_torch._private import kv as kv_mod

            node_faults.arm_pending(kv_mod.connect(kv_addr), node_id)
        conn.send(("ok", fn(*args)))
    except BaseException as e:  # noqa: BLE001 — reported to the caller
        conn.send(("error", repr(e)))
    finally:
        conn.close()


def run_bound(node_id: str, fn: Callable, *args, timeout: float,
              kv_addr: Optional[str] = None):
    """``fn(*args)`` (a module-level function) in a new process bound to
    ``node_id``, with the faults armed on it in the run at ``kv_addr``;
    its result, or None when it does not answer within ``timeout`` (the
    process is killed) or raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_bound_main,
                       args=(child, node_id, kv_addr, fn, args),
                       name=f"bound-{node_id}", daemon=True)
    proc.start()
    child.close()
    try:
        if not parent.poll(timeout):
            return None
        status, value = parent.recv()
        if status != "ok":
            logger.debug("bound call on %s failed: %s", node_id, value)
            return None
        return value
    except (EOFError, OSError):
        return None
    finally:
        parent.close()
        proc.join(5.0)
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


class HealthMonitor(threading.Thread):
    """Background straggler/degradation detector of one run, in the
    process that runs its trainer.

    It reads and writes the run's key-value store: ``kv`` (a
    ``_private.kv.RunKV``), or the store of ``trainer``'s run, found on
    each tick (none before ``trainer.fit()`` hosts it, so the monitor
    may start first)::

        trainer = TorchTrainer(loop, ...)
        mon = HealthMonitor(trainer=trainer)   # knobs default from DEFAULTS
        mon.start()
        trainer.fit()
        mon.stop()

    Every threshold is constructor-overridable for tests; the
    ``probe_fn`` hook lets tests substitute the probe (e.g. a canary that
    lies) without processes."""

    def __init__(self, *,
                 trainer=None,
                 kv=None,
                 interval_s: Optional[float] = None,
                 mad_threshold: Optional[float] = None,
                 suspect_windows: Optional[int] = None,
                 probe_factor: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 probe_sweep: bool = False,
                 probe_sweep_every: int = 3,
                 probe_fn=None):
        super().__init__(name="health-monitor", daemon=True)
        self._trainer = trainer
        self._fixed_kv = kv
        self._conn = None  # (address, RunKV) of the trainer's run
        self.interval_s = float(interval_s if interval_s is not None
                                else DEFAULTS["health_monitor_interval_s"])
        self.mad_threshold = float(
            mad_threshold if mad_threshold is not None
            else DEFAULTS["health_mad_threshold"])
        self.suspect_windows = int(
            suspect_windows if suspect_windows is not None
            else DEFAULTS["health_suspect_windows"])
        self.probe_factor = float(
            probe_factor if probe_factor is not None
            else DEFAULTS["health_probe_factor"])
        self.probe_timeout_s = float(
            probe_timeout_s if probe_timeout_s is not None
            else DEFAULTS["health_probe_timeout_s"])
        self.probe_sweep = bool(probe_sweep)
        self.probe_sweep_every = max(1, int(probe_sweep_every))
        self._probe_fn = probe_fn
        self._stop_event = threading.Event()
        self._lock = threading.Lock()  # guards _ticks across thread+tests
        self._rank_hyst = H.HysteresisTracker(self.suspect_windows)
        self._node_hyst = H.HysteresisTracker(self.suspect_windows)
        self._quarantined: set = set()       # node_ids we actuated
        self._suspect_since: Dict[str, float] = {}   # node_id -> wall ts
        self._ticks = 0
        self._counts = {"suspects": 0, "quarantines": 0, "probes": 0}
        self._probe_s: Dict[str, float] = {}  # node_id -> latest elapsed
        self.events: List[Dict[str, Any]] = []  # detection timeline
        self.probes: List[Dict[str, Any]] = []  # every probe's result

    # ------------------------------------------------------------- control

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout=timeout)

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.debug("health tick failed", exc_info=True)
            self._stop_event.wait(self.interval_s)

    def summary(self) -> Dict[str, Any]:
        """Detection timeline + outcome, for bench/chaos records.  When
        a quarantine happened, ``detection_to_quarantine_s`` is the
        SUSPECT->QUARANTINED latency.  ``counts`` and ``probe_s`` stand
        in for the reference's ``health_*`` metrics."""
        with self._lock:
            ticks = self._ticks
        out: Dict[str, Any] = {
            "ticks": ticks,
            "quarantined": sorted(self._quarantined),
            "events": list(self.events),
            "counts": {"ticks": ticks, **self._counts},
            "probe_s": dict(self._probe_s),
        }
        sus = {e["node_id"]: e["t"] for e in self.events
               if e["event"] == "suspect" and e.get("node_id")}
        for e in self.events:
            if e["event"] == "quarantine":
                t0 = sus.get(e["node_id"])
                if t0 is not None:
                    out["detection_to_quarantine_s"] = round(
                        e["t"] - t0, 3)
        return out

    # ----------------------------------------------------------- main loop

    def tick(self) -> None:
        """One passive-scoring pass (public so tests can drive the
        monitor synchronously, without the thread)."""
        with self._lock:
            self._ticks += 1
            ticks = self._ticks
        statuses = self._read_collective_statuses()
        rank_nodes = self._rank_node_map(statuses)
        step_groups = self._read_step_groups()
        for group, records in step_groups.items():
            self._score_group(group, records, statuses.get(group, []),
                              rank_nodes.get(group, {}))
        if self.probe_sweep and \
                ticks % self.probe_sweep_every == 1 % self.probe_sweep_every:
            self._sweep_nodes()

    # ------------------------------------------------------- passive reads

    def _run_kv(self):
        """The run's store: the fixed ``kv``, or a connection of this
        monitor's own to ``trainer``'s run (None before it hosts one)."""
        if self._fixed_kv is not None:
            return self._fixed_kv
        ctl = getattr(self._trainer, "controller", None)
        kv = getattr(ctl, "kv", None)
        if kv is None:
            return None
        if self._conn is None or self._conn[0] != kv.addr:
            from ray_tpu_torch._private import kv as kv_mod

            self._conn = (kv.addr, kv_mod.connect(kv.addr))
        return self._conn[1]

    def _kv_prefix(self, prefix: str) -> Dict[str, bytes]:
        try:
            kv = self._run_kv()
            if kv is None:
                return {}
            out = {}
            for key in kv.keys(prefix):
                raw = kv.get(key)
                if raw is not None:
                    out[key] = raw
            return out
        except Exception:  # noqa: BLE001 — no run / mid-shutdown
            return {}

    def _read_step_groups(self) -> Dict[str, List[Dict[str, Any]]]:
        groups: Dict[str, List[Dict[str, Any]]] = {}
        for raw in self._kv_prefix(_STEP_PREFIX).values():
            try:
                rec = json.loads(raw)
                groups.setdefault(str(rec["group"]), []).append(rec)
            except Exception:  # noqa: BLE001 — record mid-write
                continue
        return groups

    def _read_collective_statuses(self) -> Dict[str, List[Dict[str, Any]]]:
        from ray_tpu_torch.util.collective.supervision import \
            aggregate_status_records

        records = []
        for key, raw in self._kv_prefix(_COLLECTIVE_PREFIX).items():
            if "/status/" not in key:
                continue
            try:
                records.append(json.loads(raw))
            except Exception:  # noqa: BLE001 — record mid-write
                continue
        out: Dict[str, List[Dict[str, Any]]] = {}
        for grp in aggregate_status_records(records):
            out[str(grp.get("group_name", ""))] = grp.get("members", [])
        return out

    @staticmethod
    def _rank_node_map(statuses: Dict[str, List[Dict[str, Any]]]
                       ) -> Dict[str, Dict[int, str]]:
        out: Dict[str, Dict[int, str]] = {}
        for group, members in statuses.items():
            for m in members:
                node = m.get("node_id")
                if node and m.get("rank") is not None:
                    out.setdefault(group, {})[int(m["rank"])] = node
        return out

    # ---------------------------------------------------------- rank leg

    def _score_group(self, group: str, records: List[Dict[str, Any]],
                     members: List[Dict[str, Any]],
                     rank_nodes: Dict[int, str]) -> None:
        # step records carry their publisher's node_id; collective
        # statuses refine/override (a group need not run a supervised
        # collective to get straggler coverage)
        rank_nodes = dict(rank_nodes)
        for rec in records:
            if rec.get("node_id") and rec.get("rank") is not None:
                rank_nodes.setdefault(int(rec["rank"]), rec["node_id"])
        score = H.score_step_records(records,
                                     mad_threshold=self.mad_threshold)
        population = [(group, r) for r in score["ranks"]]
        outliers = [(group, r) for r in score["suspects"]]
        promoted = self._rank_hyst.observe(outliers, population)
        if not promoted:
            return
        # corroborating signals: completed-seq lag + in-flight op ages
        seqs = {int(m["rank"]): int(m.get("last_done_seq", 0))
                for m in members if m.get("rank") is not None}
        max_seq = max(seqs.values(), default=0)
        ages = H.pending_age_lags(members)
        for _g, rank in promoted:
            node_id = rank_nodes.get(rank, "")
            if node_id in self._quarantined:
                continue
            detail = dict(score["ranks"].get(rank, {}))
            signals = {
                "own_time_z": detail.get("z"),
                "own_s": detail.get("own_s"),
                "collective_wait_s": detail.get("collective_wait_s"),
                "seq_lag": (max_seq - seqs[rank]) if rank in seqs else None,
                "pending_age_s": round(ages[rank], 3)
                if rank in ages else None,
                "windows": self.suspect_windows,
            }
            self._mark_suspect(kind="rank", subject=f"{group}/{rank}",
                               group=group, rank=rank, node_id=node_id,
                               reason="own-time outlier with low "
                                      "collective wait",
                               signals=signals)
            if node_id:
                reference = self._pick_reference(group, rank_nodes,
                                                 exclude=node_id)
                self._confirm_and_quarantine(node_id, reference,
                                             group=group, rank=rank,
                                             signals=signals)

    def _pick_reference(self, group: str, rank_nodes: Dict[int, str],
                        exclude: str) -> Optional[str]:
        """A healthy unit to race the probe against: prefer one hosting
        another rank of the same group (same hardware class), else any
        other unit of the run that is not quarantined."""
        for _rank, node in sorted(rank_nodes.items()):
            if node and node != exclude and node not in self._quarantined:
                return node
        for n in self._alive_nodes():
            nid = n.get("node_id", "")
            if nid and nid != exclude and nid not in self._quarantined \
                    and n.get("health") != H.QUARANTINED:
                return nid
        return None

    # ---------------------------------------------------------- node sweep

    def _sweep_nodes(self) -> None:
        """Probe every unit of the run and MAD-test the elapsed times: the
        train-free detection leg (needs >= 3 units for a verdict; any
        canary mismatch quarantines immediately)."""
        nodes = [n.get("node_id", "") for n in self._alive_nodes()
                 if n.get("health") != H.QUARANTINED]
        nodes = [n for n in nodes if n and n not in self._quarantined]
        if len(nodes) < 3:
            return
        results: Dict[str, Dict[str, Any]] = {}
        expected = H.sdc_digest(seed=7)
        for nid in nodes:
            res = self._run_probe(nid)
            if res is None:
                continue
            results[nid] = res
            if res.get("digest") and res["digest"] != expected:
                # a corrupting card: binary evidence, no hysteresis
                self._mark_suspect(
                    kind="node", subject=nid, node_id=nid,
                    reason="SDC canary digest mismatch",
                    signals={"digest": res["digest"],
                             "expected": expected})
                self._quarantine(nid, reason="SDC canary digest mismatch",
                                 hw_confirmed=True,
                                 signals={"digest": res["digest"],
                                          "expected": expected})
        if len(results) < 3:
            return
        ordered = sorted(results)
        elapsed = [results[n]["elapsed_s"] for n in ordered]
        zs = H.robust_z(elapsed)
        outliers = [n for n, z in zip(ordered, zs)
                    if z > self.mad_threshold]
        promoted = self._node_hyst.observe(outliers, ordered)
        for nid in promoted:
            if nid in self._quarantined:
                continue
            signals = {"probe_elapsed_s":
                       round(results[nid]["elapsed_s"], 4),
                       "probe_z": round(zs[ordered.index(nid)], 3),
                       "windows": self.suspect_windows}
            self._mark_suspect(kind="node", subject=nid, node_id=nid,
                               reason="probe-sweep elapsed outlier",
                               signals=signals)
            reference = min(
                (n for n in ordered if n != nid),
                key=lambda n: results[n]["elapsed_s"], default=None)
            self._confirm_and_quarantine(nid, reference, signals=signals)

    # ------------------------------------------------------- active probe

    def _run_probe(self, node_id: str) -> Optional[Dict[str, Any]]:
        """One probe of ``node_id`` (None on timeout or failure):
        :func:`_probe_payload` in a process bound to the unit
        (:func:`run_bound`).  ``probe_fn`` substitutes the whole leg in
        tests."""
        self._counts["probes"] += 1
        if self._probe_fn is not None:
            res = self._probe_fn(node_id)
        else:
            try:
                fault_point("health.probe")
                kv = self._run_kv()
                res = run_bound(node_id, _probe_payload,
                                timeout=self.probe_timeout_s,
                                kv_addr=None if kv is None else kv.addr)
            except Exception:  # noqa: BLE001 — timeout / no process
                res = None
        if res is not None:
            self._probe_s[node_id] = res.get("elapsed_s", 0.0)
            self.probes.append({"t": time.time(), **res})
        return res

    def _confirm_and_quarantine(self, node_id: str,
                                reference: Optional[str],
                                group: str = "", rank: Optional[int] = None,
                                signals: Optional[Dict[str, Any]] = None
                                ) -> bool:
        """The SUSPECT -> CONFIRMED leg: probe suspect vs reference.
        Quarantines (and returns True) when the suspect is
        ``probe_factor`` x slower than the reference, silent while the
        reference answers, or failing the SDC canary."""
        signals = dict(signals or {})
        ref_res = self._run_probe(reference) if reference else None
        sus_res = self._run_probe(node_id)
        if ref_res is None:
            # no healthy yardstick: cannot confirm — leave SUSPECT, the
            # hysteresis streak resets and scoring continues
            self._rank_hyst.reset()
            return False
        expected = H.sdc_digest(seed=7)
        if sus_res is None:
            signals["probe"] = "timeout"
            self._quarantine(node_id, reason="probe timed out while "
                             "reference answered", group=group, rank=rank,
                             signals=signals)
            return True
        if sus_res.get("digest") and sus_res["digest"] != expected:
            signals["digest"] = sus_res["digest"]
            signals["expected"] = expected
            self._quarantine(node_id, reason="SDC canary digest mismatch",
                             hw_confirmed=True, group=group, rank=rank,
                             signals=signals)
            return True
        ratio = sus_res.get("elapsed_s", 0.0) / max(
            ref_res.get("elapsed_s", 0.0), 1e-9)
        signals["probe_ratio"] = round(ratio, 2)
        signals["probe_suspect_s"] = round(sus_res.get("elapsed_s", 0.0), 4)
        signals["probe_reference_s"] = round(
            ref_res.get("elapsed_s", 0.0), 4)
        if "ppermute_s" in sus_res and "ppermute_s" in ref_res:
            signals["ppermute_ratio"] = round(
                sus_res["ppermute_s"] / max(ref_res["ppermute_s"], 1e-9), 2)
        if ratio >= self.probe_factor:
            self._quarantine(node_id, reason=f"probe {ratio:.1f}x slower "
                             "than reference", group=group, rank=rank,
                             signals=signals)
            return True
        # probe cleared it: false alarm — reset the streaks so a fresh
        # run of outlier windows is required before the next probe
        if rank is not None:
            self._rank_hyst.reset((group, rank))
        self._node_hyst.reset(node_id)
        return False

    # ----------------------------------------------------------- verdicts

    def _mark_suspect(self, *, kind: str, subject: str, node_id: str,
                      reason: str, signals: Dict[str, Any],
                      group: str = "", rank: Optional[int] = None) -> None:
        now = time.time()
        if node_id and node_id not in self._suspect_since:
            self._suspect_since[node_id] = now
        self._counts["suspects"] += 1
        self.events.append({"t": now, "event": "suspect", "kind": kind,
                            "subject": subject, "node_id": node_id,
                            "reason": reason})
        logger.warning("health: %s %s SUSPECT (%s)", kind, subject, reason)
        H.publish_health_verdict(H.HealthVerdict(
            kind=kind, subject=subject, health=H.SUSPECT, reason=reason,
            node_id=node_id, group=group, rank=rank, signals=signals,
            suspect_ts=self._suspect_since.get(node_id, now)),
            kv=self._run_kv())
        if node_id:
            self._set_node_health(node_id, H.SUSPECT, reason)

    def _quarantine(self, node_id: str, *, reason: str,
                    hw_confirmed: bool = False, group: str = "",
                    rank: Optional[int] = None,
                    signals: Optional[Dict[str, Any]] = None) -> None:
        if node_id in self._quarantined:
            return
        self._quarantined.add(node_id)
        now = time.time()
        self._counts["quarantines"] += 1
        self.events.append({"t": now, "event": "quarantine",
                            "node_id": node_id, "reason": reason,
                            "hw_confirmed": hw_confirmed})
        logger.warning("health: unit %s QUARANTINED (%s)%s", node_id,
                       reason, " [hw-confirmed]" if hw_confirmed else "")
        H.publish_health_verdict(H.HealthVerdict(
            kind="node", subject=node_id, health=H.QUARANTINED,
            reason=reason, node_id=node_id, group=group, rank=rank,
            signals=dict(signals or {}), hw_confirmed=hw_confirmed,
            suspect_ts=self._suspect_since.get(node_id), quarantine_ts=now),
            kv=self._run_kv())
        self._set_node_health(node_id, H.QUARANTINED, reason,
                              hw_confirmed=hw_confirmed)

    # ------------------------------------------------------- ladder legs

    def _alive_nodes(self) -> List[Dict[str, Any]]:
        """The units of the run with their ladder health (the
        reference's alive nodes from the GCS)."""
        try:
            kv = self._run_kv()
            if kv is None:
                return []
            raw = kv.get(_UNITS_KEY)
            ladder = node_health(kv)
        except Exception:  # noqa: BLE001 — no run
            return []
        units = json.loads(raw) if raw else []
        return [{"node_id": u, "alive": True,
                 "health": ladder.get(u, {}).get("health", H.HEALTHY)}
                for u in units]

    def _set_node_health(self, node_id: str, health: str, reason: str,
                         hw_confirmed: bool = False) -> None:
        try:
            kv = self._run_kv()
            if kv is not None:
                set_node_health(kv, node_id, health, reason,
                                hw_confirmed=hw_confirmed)
        except Exception:  # noqa: BLE001 — the verdict record stands
            logger.debug("set_node_health(%s, %s) failed", node_id, health,
                         exc_info=True)
