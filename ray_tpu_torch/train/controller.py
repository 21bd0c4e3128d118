"""Train controller: the explicit control loop driving a worker group
(counterpart of ``ray_tpu/train/controller.py``).

Parity: Train-v2 ``TrainController``
(``python/ray/train/v2/_internal/execution/controller/controller.py:91``):
poll the group, collect reported (metrics, checkpoint) rows, consult the
FailurePolicy on errors and the ScalingPolicy when (re)starting the
group.  Recovery is checkpoint-restore with a fresh group; elastic
resize works the same way (the new group re-forms the mesh).

The controller hosts the run's key-value store (``_private/kv.py``),
which every worker reaches through ``RAY_TPU_TORCH_KV``: collective
rendezvous and status records, step breakdowns, the run's own status
under ``train/<name>``, and the node-health ladder of its units (cards,
or host slots) that the health plane writes.

The drain branch is the reference's (``_maybe_handle_drain``) with a
quarantine on the ladder in place of a GCS drain notice: when a unit of
the running group is QUARANTINED, the controller asks every rank for a
checkpoint, waits for one (bounded by the quarantine's drain deadline),
and restarts the group off the unit without charging
``FailureConfig.max_failures``.  Groups are placed only on units that
are not quarantined.  Under ``CheckpointConfig(mode="tiered")`` the
controller owns the checkpoint replica plane (one
``CheckpointReplicaServer`` process per unit, outside the worker group,
reused across generations), follows each rank's tiered saves from the
poll status, and counts a generation acked in peer RAM by every rank as
the drain's checkpoint; a drain deadline below
``train_drain_memory_tier_floor_s`` asks for that memory tier.  The
reference's gang fate-share branch needs its cluster core and is not
ported.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private import health_plane
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch._private.config import knob
from ray_tpu_torch._private.shm import sweep_segments
from ray_tpu_torch._private.net import address_in_use
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.policies import (
    DefaultFailurePolicy,
    FailureDecision,
    FailurePolicy,
    FixedScalingPolicy,
    ResizeDecision,
    ScalingPolicy,
    TrainRunContext,
)
from ray_tpu_torch.train.worker_group import WorkerGroup, WorkerStatus

logger = logging.getLogger(__name__)


class TrainController:
    def __init__(
        self,
        fn_payload: bytes,
        train_loop_config: Dict[str, Any],
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        failure_policy: Optional[FailurePolicy] = None,
        scaling_policy: Optional[ScalingPolicy] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dist_env_fn: Optional[Callable[[WorkerGroup],
                                       Optional[List[Dict[str, str]]]]] = None,
        poll_interval_s: float = 0.05,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.fn_payload = fn_payload
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config
        self.run_config = run_config
        self.failure_policy = failure_policy or DefaultFailurePolicy(
            run_config.failure_config.max_failures)
        self.scaling_policy = scaling_policy or FixedScalingPolicy()
        self.datasets = datasets or {}
        self.dist_env_fn = dist_env_fn
        self.poll_interval_s = poll_interval_s
        self.name = run_config.name or f"train-{uuid.uuid4().hex[:8]}"

        ckpt_cfg = run_config.checkpoint_config
        storage = None
        if run_config.storage_path:
            storage = os.path.join(run_config.storage_path, self.name)
        self.checkpoint_manager = CheckpointManager(
            storage_dir=storage,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        if resume_from_checkpoint is not None:
            self.checkpoint_manager.register(resume_from_checkpoint, {})
        # the tiered plane: replica servers owned HERE, outside the worker
        # group, so the emergency tier survives the restarts it serves
        self._tiered_mode = ckpt_cfg.mode == "tiered"
        self._peer_replication = ckpt_cfg.peer_replication
        self.replica_plane = None
        # index -> {"ranks_ram": set, "world": int, "path": str|None,
        # "registered": bool}, from the poll-time checkpointer status
        self._tiered: Dict[int, Dict[str, Any]] = {}
        self.kv: Optional[kv_mod.RunKV] = None
        self.metrics_history: List[Dict[str, Any]] = []
        self._ctx = TrainRunContext()
        # report-row bookkeeping: rows are aligned by per-rank *absolute*
        # index within a group generation, not by poll-window position (a
        # rank's row can straddle poll boundaries)
        self._generation = 0
        self._rank_row_counts: Dict[int, int] = {}
        self._step_buffer: Dict[tuple, Dict[int, Dict[str, Any]]] = {}
        self._emitted: Dict[tuple, Dict[str, Any]] = {}
        self._ckpt_registered: set = set()
        # a restart after a port race (EADDRINUSE) is not charged to the
        # failure budget, once per run
        self._port_retried = False
        # the node-health ladder, polled at most twice a second
        self._last_drain_check = 0.0
        self._ladder: Dict[str, Dict[str, Any]] = {}
        self._drains_handled: set = set()
        # planned migrations (quarantine drains) taken, not charged
        self.drain_restarts = 0
        # the streaming_splits feeding the running group
        self._splits: List[Any] = []

    # -- units and the node-health ladder ----------------------------------
    def _units(self) -> List[str]:
        """The cards (or host slots) this run places ranks on: every card
        of this node, or as many slots as the run may have workers."""
        sc = self.scaling_config
        slots = max(sc.num_workers,
                    getattr(self.scaling_policy, "max_workers", 0))
        return accelerators.node_units(sc.use_gpu, slots)

    def _poll_ladder(self, force: bool = False) -> Dict[str, Dict[str, Any]]:
        now = time.time()
        if force or now - self._last_drain_check >= 0.5:
            self._last_drain_check = now
            try:
                self._ladder = health_plane.node_health(self.kv)
            except Exception:  # noqa: BLE001 — a store hiccup
                pass
        return self._ladder

    def _quarantined(self, force: bool = False) -> Dict[str, Dict[str, Any]]:
        return {n: rec for n, rec in self._poll_ladder(force).items()
                if rec.get("health") == "QUARANTINED"}

    # -- group lifecycle ---------------------------------------------------
    def _start_group(self) -> WorkerGroup:
        bad = self._quarantined(force=True)
        units = [u for u in self._units() if u not in bad]
        decision = self.scaling_policy.make_decision_for_non_running_worker_group(
            self.scaling_config, units_left=len(units))
        sc = self.scaling_config
        if isinstance(decision, ResizeDecision) and \
                decision.num_workers != sc.num_workers:
            import dataclasses

            sc = dataclasses.replace(sc, num_workers=decision.num_workers)
            logger.info("train %s: elastic resize to %d workers",
                        self.name, sc.num_workers)
        if self._tiered_mode:
            # rank r lands on units[r]: their replica servers start beside
            # the workers (``_wire_replica_plane`` waits for them)
            self._replica_plane().start(units[:sc.num_workers])
        # Generation-scoped name: collective groups and report indices from
        # a previous (possibly abruptly killed) group can never alias the
        # new one's.
        self._generation += 1
        self._rank_row_counts = {}
        group = WorkerGroup(sc, f"{self.name}/g{self._generation}", units,
                            env={kv_mod.ENV_KV: self.kv.addr})
        group.start()
        try:
            shards = self._split_datasets(sc.num_workers)
            dist_env = (self.dist_env_fn(group) if self.dist_env_fn
                        else None)
            # the REQUESTED mesh ships to every generation unchanged;
            # workers resolve it against the ranks they have (clamp_to)
            group.run_train_fn(
                self.fn_payload, self.train_loop_config,
                self.checkpoint_manager.latest, shards, dist_env,
                mesh_config=sc.mesh_config(),
                axis_rules=sc.logical_axis_rules,
                ckpt_planes=self._wire_replica_plane(group))
        except BaseException:
            group.shutdown()
            raise
        return group

    def _replica_plane(self):
        if self.replica_plane is None:
            from ray_tpu_torch.util.checkpoint_replica import ReplicaPlane

            self.replica_plane = ReplicaPlane(self.name, kv=self.kv)
        return self.replica_plane

    def _wire_replica_plane(self, group: WorkerGroup
                            ) -> Optional[List[Dict[str, Any]]]:
        """Tiered mode: start a replica server for each unit of this
        generation that has none, and return each rank's wiring (storage
        dir, run name, its peer server, every server's name).  Servers
        are reused across generations; a quarantined unit's server stays
        (its replicas are host memory, which the quarantine does not
        touch)."""
        if not self._tiered_mode:
            return None
        plane = self._replica_plane()
        node_ids = group.worker_node_ids()
        plane.ensure_for_nodes(node_ids)
        servers = plane.server_names()
        peers = plane.peer_assignment(node_ids) if self._peer_replication \
            else [None] * len(node_ids)
        return [{"mode": "tiered", "run": self.name,
                 "storage_dir": self.checkpoint_manager.storage_dir,
                 "peer": peers[rank], "servers": servers}
                for rank in range(len(node_ids))]

    def _restart_group(self) -> WorkerGroup:
        """Start a replacement group, treating start-time failures as
        ordinary failures: consult the FailurePolicy and retry."""
        while True:
            try:
                return self._start_group()
            except Exception as e:  # noqa: BLE001 — start errors
                self._ctx.errors_seen += 1
                decision = self.failure_policy.make_decision(
                    self._ctx, str(e))
                if decision != FailureDecision.RETRY:
                    raise
                logger.warning(
                    "train %s: group start failed (%d so far), retrying "
                    "with a fresh scaling decision:\n%s",
                    self.name, self._ctx.errors_seen, e)
                time.sleep(1.0)

    def _split_datasets(self, n: int) -> Optional[List[Any]]:
        """One shard dict per rank: a ``ray_tpu_torch.data.Dataset``
        becomes ``streaming_split(n, equal=True)``, a fresh split per
        attempt (the previous attempt's is shut down and its segments
        destroyed first); any other value is replicated to each rank."""
        self._shutdown_splits()
        if not self.datasets:
            return None
        from ray_tpu_torch.data import Dataset

        per_rank: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if isinstance(ds, Dataset):
                parts = ds.streaming_split(n, equal=True)
                self._splits.append(parts)
                for r in range(n):
                    per_rank[r][name] = parts[r]
            else:
                for r in range(n):
                    per_rank[r][name] = ds
        return per_rank

    def _shutdown_splits(self) -> None:
        """Stop every split of this run and destroy its segments."""
        while self._splits:
            self._splits.pop().shutdown()

    # -- run status ---------------------------------------------------------
    def _publish_status(self, group, status: str) -> None:
        """Best-effort run snapshot into the run's KV (``train/<name>``).
        Throttled to ~1/s and deduped while RUNNING."""
        now = time.time()
        if status == "RUNNING" and \
                now - getattr(self, "_last_status_t", 0.0) < 1.0:
            return
        latest = self.metrics_history[-1] if self.metrics_history else {}
        world = len(group.workers) if group and group.workers else \
            getattr(self, "_last_world_size", 0)
        snap = {
            "name": self.name, "status": status,
            "world_size": world,
            "iteration": latest.get("training_iteration"),
            "latest_metrics": {
                k: v for k, v in latest.items()
                if isinstance(v, (int, float, str))},
            "restarts": self._ctx.errors_seen,
            "drain_restarts": self.drain_restarts,
            "started_at": getattr(self, "_started_at", 0.0),
        }
        blob = json.dumps(snap, default=str).encode()
        if status == "RUNNING" and \
                blob == getattr(self, "_last_status_blob", None):
            return
        try:
            self.kv.put(f"train/{self.name}", blob)
            self._last_status_t = now
            self._last_status_blob = blob
        except Exception:  # noqa: BLE001 — the status view is best-effort
            pass

    def status(self) -> Optional[Dict[str, Any]]:
        """The run's last published status, read back from its KV."""
        raw = self.kv.get(f"train/{self.name}") if self.kv else None
        return json.loads(raw) if raw else None

    # -- drain on quarantine ------------------------------------------------
    def _maybe_handle_drain(self, group: WorkerGroup) -> bool:
        """React to a quarantine of a unit hosting this group: ask every
        rank for an immediate checkpoint, wait (bounded by the
        quarantine's drain deadline and ``train_drain_checkpoint_wait_s``)
        for one to be reported and registered, and tell the caller to
        restart the group, which is then placed off the unit.  The
        after-the-corpse half (worker death -> FailurePolicy -> restore)
        stays the fallback."""
        bad = self._quarantined()
        overlap = {nid: rec for nid, rec in bad.items()
                   if nid in set(group.worker_node_ids())
                   and nid not in self._drains_handled}
        if not overlap:
            return False
        self._drains_handled.update(overlap)
        wait_s = health_plane.DEFAULTS["train_drain_checkpoint_wait_s"]
        deadline = min(rec.get("drain_deadline") or time.time() + wait_s
                       for rec in overlap.values())
        window = max(0.0, deadline - time.time())
        # a window too short for the disk persist asks for the memory
        # tier: the peer-RAM ack is the commit, and the restarted group
        # restores from the replica plane with zero disk reads
        tier = "any"
        if self._tiered_mode and \
                window < knob("train_drain_memory_tier_floor_s"):
            tier = "memory"
        logger.warning(
            "train %s: unit(s) %s hosting workers quarantined (%.1fs to "
            "the drain deadline); requesting an immediate %s-tier "
            "checkpoint and restarting off them", self.name, sorted(overlap),
            window, tier)
        pre_ckpts = len(self._ckpt_registered) + self._tiered_durable_count()
        # the drained units ride along: an emergency replica must not land
        # on one of them
        group.request_checkpoint(tier=tier, avoid_nodes=sorted(overlap))
        # a margin before the deadline for the group's teardown
        wait_until = min(deadline - 1.0, time.time() + wait_s)
        while time.time() < wait_until:
            statuses = group.poll()
            self._collect_results(statuses)
            # finished beats checkpointed: a run completing during the
            # wait must not be torn down and re-run from its checkpoint
            if all(s.finished for s in statuses):
                return False
            if len(self._ckpt_registered) + self._tiered_durable_count() \
                    > pre_ckpts:
                break  # the pre-drain checkpoint is durable (some tier)
            if any(s.error for s in statuses):
                break  # restart from what there is
            time.sleep(self.poll_interval_s)
        return True

    def _tiered_durable_count(self) -> int:
        """Tiered generations durable at ANY tier: registered from disk,
        or acked in peer RAM by every rank (the ``memory``-tier
        commit)."""
        n = 0
        for info in self._tiered.values():
            if info.get("registered"):
                n += 1
            elif info.get("world") and \
                    len(info["ranks_ram"]) >= info["world"]:
                n += 1
        return n

    # -- control loop ------------------------------------------------------
    def run(self) -> Result:
        self._started_at = time.time()
        self.kv = kv_mod.host()
        health_plane.publish_units(self.kv, self._units())
        group = self._start_group()
        self._last_world_size = len(group.workers)
        error: Optional[BaseException] = None
        try:
            while True:
                self._last_world_size = len(group.workers)
                statuses = group.poll()
                self._collect_results(statuses)
                self._publish_status(group, "RUNNING")

                if not all(s.finished for s in statuses) and \
                        self._maybe_handle_drain(group):
                    # a planned migration, not a failure: no charge to
                    # the failure budget; the restart re-runs the
                    # ScalingPolicy over the units left
                    self.drain_restarts += 1
                    group.shutdown()
                    group = self._restart_group()
                    continue

                errs = [s for s in statuses if s.error]
                if errs and not self._port_retried and \
                        any(address_in_use(s.error) for s in errs):
                    # a free port taken by another process between its
                    # choice and its bind: retry once, uncharged
                    self._port_retried = True
                    logger.warning(
                        "train %s: a rendezvous port was taken; restarting "
                        "the group once:\n%s", self.name, errs[0].error)
                    group.shutdown()
                    group = self._restart_group()
                    continue
                if errs:
                    self._ctx.errors_seen += 1
                    first = errs[0].error
                    decision = self.failure_policy.make_decision(self._ctx, first)
                    if decision == FailureDecision.RETRY:
                        logger.warning(
                            "train %s: worker failure (%d so far), restarting "
                            "from latest checkpoint:\n%s",
                            self.name, self._ctx.errors_seen, first)
                        group.shutdown()
                        group = self._restart_group()
                        continue
                    error = RuntimeError(
                        f"training failed after {self._ctx.errors_seen} "
                        f"failure(s):\n{first}")
                    break

                if all(s.finished for s in statuses):
                    break
                time.sleep(self.poll_interval_s)
        except BaseException as e:  # noqa: BLE001 — status must not lie
            error = e
            raise
        finally:
            group.shutdown()
            self._shutdown_splits()
            if self.replica_plane is not None:
                # the RAM tier lives as long as the run: disk commits
                # survive it, the replicas do not
                self.replica_plane.shutdown()
            self._publish_status(
                group, "FAILED" if error is not None else "FINISHED")
            # segments a worker registered (weight-sync payloads) go with
            # the store, the only way to find them
            try:
                sweep_segments(self.kv)
            except Exception:  # noqa: BLE001 — best effort at the end
                logger.warning("train %s: segment sweep failed", self.name,
                               exc_info=True)

        return Result(
            metrics=self.metrics_history[-1] if self.metrics_history else None,
            checkpoint=self.checkpoint_manager.best,
            path=self.checkpoint_manager.storage_dir,
            error=error,
            metrics_history=list(self.metrics_history),
        )

    def _collect_results(self, statuses: List[WorkerStatus]) -> None:
        """Merge per-rank reports.

        Rows are keyed (generation, per-rank absolute row index): rank r's
        i-th ``report()`` call pairs with every other rank's i-th call no
        matter how the rows split across poll windows.  Rank-0 metrics are
        canonical; the first checkpoint seen for a step is registered
        (rank 0 wins when it arrives in the same poll).
        """
        for s in statuses:
            base = self._rank_row_counts.get(s.rank, 0)
            for off, row in enumerate(s.results):
                key = (self._generation, base + off)
                self._step_buffer.setdefault(key, {})[s.rank] = row
            self._rank_row_counts[s.rank] = base + len(s.results)
            if s.ckpt:
                self._note_tiered_status(s.rank, s.ckpt)

        for key in sorted(self._step_buffer):
            rows = self._step_buffer[key]
            if key not in self._emitted:
                if 0 not in rows:
                    continue  # wait for the canonical rank
                metrics = dict(rows[0]["metrics"])
                metrics.setdefault("training_iteration",
                                   len(self.metrics_history) + 1)
                self.metrics_history.append(metrics)
                self._emitted[key] = metrics
            if key not in self._ckpt_registered:
                for rank in sorted(rows):
                    path = rows[rank].get("checkpoint_path")
                    if path:
                        self.checkpoint_manager.register(
                            Checkpoint(path), self._emitted[key])
                        self._ckpt_registered.add(key)
                        break
            if len(rows) == len(statuses) and key in self._emitted:
                del self._step_buffer[key]

    def _note_tiered_status(self, rank: int, st: Dict[str, Any]) -> None:
        """Fold one rank's poll-time checkpointer status into the
        per-index durability record.  A committed sharded dir is adopted
        into the CheckpointManager in place (it already lives in the
        storage dir), which gives it top-K eviction and
        ``Result.checkpoint`` visibility."""
        idx = st.get("index")
        if idx is None:
            return
        info = self._tiered.setdefault(
            idx, {"ranks_ram": set(), "world": st.get("world"),
                  "path": None, "registered": False})
        if st.get("world"):
            info["world"] = st["world"]
        if st.get("ram_acked"):
            info["ranks_ram"].add(rank)
        path = st.get("committed_path")
        if path and not info["registered"] and os.path.isdir(path):
            metrics = self.metrics_history[-1] if self.metrics_history \
                else {}
            self.checkpoint_manager.register(Checkpoint(path), metrics)
            info["registered"] = True
            info["path"] = path
