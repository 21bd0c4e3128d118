"""Worker-side training session: ``report``, ``get_context``, the mesh and
sharding helpers (counterpart of ``ray_tpu/train/session.py``).

Parity: ``ray.train.report`` / ``ray.train.get_context``
(``python/ray/train/_internal/session.py``).  The session lives in the
worker process; ``report()`` enqueues (metrics, checkpoint) rows the
controller polls over the worker's pipe (``train/worker_group.py``).

Checkpoints are the sync mode's directories, or under
``CheckpointConfig(mode="tiered")`` the async sharded plane
(``checkpointer()``, an ``AsyncCheckpointer`` wired to the run's storage
and its peer replica server; ``restore_checkpoint()`` walks the ladder
local RAM -> peer RAM -> committed disk).  A drain notice (the
controller's, when the health plane quarantines a card of the group) asks
the loop for a checkpoint at its next step boundary: ``drain_requested()``,
at the tier ``drain_checkpoint_tier()`` names.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


class StepLedger:
    """Per-training-step wall-time attribution: where did this step go?

    Buckets every second of a step into ``data_wait``, ``h2d``,
    ``compute``, ``collective_wait`` (supervised collective ops —
    attributed through the duration sinks, no loop changes),
    ``channel_wait``, ``checkpoint_snapshot``, ``checkpoint_persist``,
    ``weight_publish`` and ``other`` (the unexplained remainder)::

        ledger = train.get_context().step_ledger()
        for batch in it:
            with ledger.step():
                with ledger.bucket("compute"):
                    state, m = train_step(state, batch)

    Emission: a ``train/step_breakdown/<group>/<rank>`` record in the
    run's KV (throttled).  The reference's metric histogram and trace
    span are not ported.  Standalone-constructible
    (``StepLedger(group_name="bench", publish=False)``).
    """

    BUCKETS = ("data_wait", "h2d", "compute", "collective_wait",
               "channel_wait", "checkpoint_snapshot", "checkpoint_persist",
               "weight_publish")

    _PUBLISH_EVERY_S = 2.0
    _HISTORY = 64

    def __init__(self, group_name: str = "", rank: int = 0,
                 publish: bool = True):
        self.group_name = group_name
        self.rank = rank
        self._publish = publish
        self._lock = threading.Lock()
        self._cur: Dict[str, float] = {}
        self._in_step = False
        self._step_idx = 0
        self._history: deque = deque(maxlen=self._HISTORY)
        self._totals: Dict[str, float] = {}
        self._total_wall = 0.0
        self._last_publish = 0.0

    # -- accumulation -------------------------------------------------------

    def note(self, bucket: str, seconds: float) -> None:
        """Attribute ``seconds`` to ``bucket`` in the current step (no-op
        between steps)."""
        if not self._in_step or seconds <= 0:
            return
        with self._lock:
            if self._in_step:
                self._cur[bucket] = self._cur.get(bucket, 0.0) + seconds

    @contextlib.contextmanager
    def bucket(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def step(self) -> Iterator["StepLedger"]:
        """Mark one training-step boundary; nesting is rejected."""
        from ray_tpu_torch._private import durations

        if self._in_step:
            raise RuntimeError("StepLedger.step() does not nest")
        with self._lock:
            self._cur = {}
            self._in_step = True
        token = durations.register_duration_sink(self.note)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            wall = time.perf_counter() - t0
            durations.unregister_duration_sink(token)
            with self._lock:
                self._in_step = False
                buckets = dict(self._cur)
            self._finish_step(buckets, wall)

    def _finish_step(self, buckets: Dict[str, float], wall: float) -> None:
        accounted = sum(buckets.values())
        buckets["other"] = max(0.0, wall - accounted)
        self._step_idx += 1
        self._history.append({"step": self._step_idx, "wall_s": wall,
                              "buckets": buckets})
        for k, v in buckets.items():
            self._totals[k] = self._totals.get(k, 0.0) + v
        self._total_wall += wall
        if self._publish and \
                time.time() - self._last_publish > self._PUBLISH_EVERY_S:
            self._last_publish = time.time()
            try:
                self._publish_kv()
            except Exception:  # noqa: BLE001 — best-effort surfacing
                pass

    # -- read-out -----------------------------------------------------------

    def last_breakdown(self) -> Optional[Dict[str, Any]]:
        return dict(self._history[-1]) if self._history else None

    def recent_breakdown(self, n: int = 16) -> Optional[Dict[str, Any]]:
        """Mean wall + per-bucket seconds over the last ``n`` steps."""
        with self._lock:
            hist = list(self._history)[-n:]
        if not hist:
            return None
        steps = len(hist)
        wall = sum(h["wall_s"] for h in hist)
        buckets: Dict[str, float] = {}
        for h in hist:
            for k, v in h["buckets"].items():
                buckets[k] = buckets.get(k, 0.0) + v
        return {"steps": steps, "wall_s_per_step": wall / steps,
                "buckets_s": {k: v / steps for k, v in buckets.items()}}

    def breakdown(self) -> Dict[str, Any]:
        """Aggregate view: mean seconds and fraction per bucket across
        recorded steps."""
        n = max(self._step_idx, 1)
        wall = self._total_wall
        return {
            "steps": self._step_idx,
            "step_wall_s": wall / n,
            "buckets_s": {k: v / n for k, v in self._totals.items()},
            "fractions": {k: (v / wall if wall > 0 else 0.0)
                          for k, v in self._totals.items()},
        }

    def _publish_kv(self) -> None:
        from ray_tpu_torch._private import accelerators
        from ray_tpu_torch._private import kv as kv_mod
        from ray_tpu_torch.util.health import edge_latency_snapshot

        if kv_mod.address() is None:
            return
        rec = {"ts": time.time(), "group": self.group_name,
               "rank": self.rank, **self.breakdown(),
               "last": self.last_breakdown(),
               # health-plane inputs: the recent scoring window, the card
               # or slot this rank runs on, and the per-edge channel
               # latencies its process observed
               "recent": self.recent_breakdown(),
               "node_id": accelerators.node_id()}
        edges = edge_latency_snapshot()
        if edges:
            rec["edges"] = edges
        key = (f"train/step_breakdown/{self.group_name or 'default'}/"
               f"{self.rank}")
        kv_mod.client().put(key, json.dumps(rec).encode())


class _TrainSession:
    def __init__(
        self,
        rank: int,
        world_size: int,
        group_name: str,
        config: Dict[str, Any],
        checkpoint: Optional[Checkpoint],
        mesh_config: Any = None,
        axis_rules: Optional[Dict[str, Any]] = None,
        device: str = "cpu",
        local_rank: Optional[int] = None,
        ckpt_plane: Optional[Dict[str, Any]] = None,
    ):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = rank if local_rank is None else local_rank
        self.group_name = group_name
        self.config = config
        self.latest_checkpoint = checkpoint
        self.results: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self.error_tb: Optional[str] = None
        self.dataset_shard: Any = None
        # the REQUESTED mesh (MeshConfig or None) + rule-table override
        # from ScalingConfig; get_mesh() resolves it against the ranks
        # this generation actually has
        self.mesh_config = mesh_config
        self.axis_rules = axis_rules
        self.device = device  # "cuda" (this rank's card) or "cpu"
        self._mesh = None  # resolved DeviceMesh, built lazily once
        self._ledger: Optional[StepLedger] = None
        # set by the controller when a card (or slot) of the group is
        # quarantined: the loop should checkpoint at its next step
        # boundary; cleared when a checkpoint is reported.  The tier is
        # "memory" when the drain deadline is below disk-write time, and
        # the avoided units are the ones the drain covers
        self.checkpoint_requested = threading.Event()
        self.checkpoint_request_tier = "any"
        self.checkpoint_request_avoid: set = set()
        # the tiered plane's wiring from the controller (None: sync mode)
        self.ckpt_plane = ckpt_plane
        self._checkpointer = None  # the AsyncCheckpointer, built lazily


def _start_session(**kw) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(**kw)
        return _session


def _get_session() -> _TrainSession:
    s = _session
    if s is None:
        raise RuntimeError(
            "No training session active — this API must be called inside "
            "a train_loop_per_worker"
        )
    return s


def report(
    metrics: Dict[str, Any], checkpoint: Optional[Any] = None
) -> None:
    """Report metrics (and optionally a checkpoint) to the controller.

    ``checkpoint`` is a directory :class:`Checkpoint` or a
    ``checkpoint_async.TieredCheckpoint`` handle from
    ``get_context().checkpointer().save(...)``: its row carries the
    generation index, and the controller follows each tier's progress
    from the poll-time checkpointer status (the background persist ends
    after this call returns)."""
    s = _get_session()
    if checkpoint is not None:
        s.checkpoint_requested.clear()
        s.checkpoint_request_tier = "any"
        s.checkpoint_request_avoid = set()
    s.results.put({"metrics": dict(metrics), "checkpoint": checkpoint})


# -- the mesh and sharding (worker-side face of ScalingConfig.mesh) -----------


def _torch_device():
    import torch

    s = _get_session()
    if s.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def worker_device():
    """This train worker's ``torch.device``, or ``None`` outside a train
    loop."""
    return _torch_device() if _session is not None else None


def get_mesh():
    """The resolved ``DeviceMesh`` for this worker generation.

    Joins the run's default process group first
    (``initialize_torch_distributed``), then resolves the *requested*
    ``ScalingConfig.mesh`` against the ranks actually present —
    ``MeshConfig.clamp_to`` degrades fixed axes that no longer fit, so a
    restart on fewer ranks re-forms a valid smaller mesh instead of
    dying on a divisibility error.  No mesh request means pure data
    parallelism over every rank.  Built once per session and cached.
    """
    s = _get_session()
    if s._mesh is not None:
        return s._mesh
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.train.trainer import initialize_torch_distributed

    initialize_torch_distributed(device=s.device)
    requested = s.mesh_config or MeshConfig(dp=-1)
    n = dist.get_world_size()
    concrete = requested.clamp_to(n)
    try:
        fits = requested.resolve(n) == concrete.resolve(n)
    except ValueError:
        fits = False
    if not fits:
        logging.getLogger(__name__).warning(
            "train %s: requested mesh (%s) does not fit %d ranks; "
            "clamped to (%s)", s.group_name, requested._named(), n,
            concrete._named())
    s._mesh = create_mesh(concrete, device=s.device)
    return s._mesh


def _as_tensor(x, device):
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device)


def shard_params(params: Any, spec_tree: Any, rules=None):
    """Place a param tree (tensors or numpy arrays, which every rank
    holds whole) on the session mesh as DTensors, per its logical-axis
    ``spec_tree`` (e.g. ``llama_param_specs(cfg)``) and the session's
    rule table: each rank keeps its shards (``parallel.shard_tree``)."""
    from ray_tpu_torch.parallel.local import tree_map
    from ray_tpu_torch.parallel.sharding import shard_tree

    s = _get_session()
    mesh = get_mesh()
    dev = _torch_device()
    return shard_tree(tree_map(lambda t: _as_tensor(t, dev), params),
                      spec_tree, mesh, rules or s.axis_rules)


def shard_inputs(batch: Any, logical_axes=("batch",), rules=None):
    """Shard per-step inputs over the session mesh's data axes.

    ``logical_axes`` names each dimension (default: the leading "batch"
    dim over dp x fsdp, the rest replicated).  Each rank passes its
    *local* rows, and they make one global batch in the order of the
    data shards (ranks that share a shard, over tp or sp, pass the same
    rows): DTensors from the local shards, with no communication.
    """
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.local import tree_map
    from ray_tpu_torch.parallel.mesh import compute_mesh
    from ray_tpu_torch.parallel.sharding import logical_to_placements

    s = _get_session()
    mesh = compute_mesh(get_mesh())
    placements = logical_to_placements(logical_axes, rules or s.axis_rules,
                                       mesh=mesh)
    dev = _torch_device()
    return tree_map(lambda x: DTensor.from_local(
        _as_tensor(x, dev), mesh, placements, run_check=False), batch)


class TrainContext:
    def get_world_size(self) -> int:
        return _get_session().world_size

    def get_world_rank(self) -> int:
        return _get_session().rank

    def get_local_rank(self) -> int:
        return _get_session().local_rank

    def get_node_id(self) -> str:
        """The unit this worker is bound to: its card (``"cuda:<i>"``)
        or, on the host, its slot (``"slot:<i>"``)."""
        from ray_tpu_torch._private.accelerators import node_id

        return node_id()

    def get_trial_name(self) -> str:
        return _get_session().group_name

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return _get_session().latest_checkpoint

    def get_config(self) -> Dict[str, Any]:
        return _get_session().config

    def get_device(self):
        """This worker's ``torch.device``: its card, or the CPU."""
        return _torch_device()

    def get_mesh(self):
        """The resolved mesh for this generation (see :func:`get_mesh`)."""
        return get_mesh()

    def shard_params(self, params: Any, spec_tree: Any, rules=None):
        """Place params on the mesh per a logical-axis spec tree (see
        :func:`shard_params`)."""
        return shard_params(params, spec_tree, rules=rules)

    def shard_inputs(self, batch: Any, logical_axes=("batch",), rules=None):
        """Shard this rank's input rows over the mesh's data axes (see
        :func:`shard_inputs`)."""
        return shard_inputs(batch, logical_axes=logical_axes, rules=rules)

    def step_ledger(self) -> StepLedger:
        """This worker's step-time attribution ledger (one per
        session)."""
        s = _get_session()
        if s._ledger is None:
            s._ledger = StepLedger(group_name=s.group_name, rank=s.rank)
        return s._ledger

    def drain_requested(self) -> bool:
        """True when the card (or slot) of a worker of this group was
        quarantined and the controller asked for an immediate
        checkpoint: report one at the next step boundary; steps since
        the last reported checkpoint will be re-run by the replacement
        group.  Loops that checkpoint every step can ignore this."""
        return _get_session().checkpoint_requested.is_set()

    def drain_checkpoint_tier(self) -> str:
        """The durability tier the pending drain checkpoint must reach:
        ``"any"`` (let the disk tier land) or ``"memory"`` (the drain
        deadline is below disk-write time: the peer-RAM ack is the
        commit; call ``checkpointer().commit_ram()`` and report)."""
        return _get_session().checkpoint_request_tier

    def checkpoint_mode(self) -> str:
        """``"tiered"`` when the controller wired the async sharded plane
        into this session (``CheckpointConfig(mode="tiered")``), else
        ``"sync"``."""
        return "tiered" if _get_session().ckpt_plane is not None else "sync"

    def checkpointer(self, writers: Optional[int] = None):
        """This rank's :class:`~ray_tpu_torch.train.checkpoint_async.
        AsyncCheckpointer` (one per session, wired to the run's storage
        dir, its peer replica server and this session's step ledger).
        ``writers`` sets the writer group's size when fewer ranks than
        the world save (``writers=1``: a sole-writer generation, as the
        RLHF loop's rank 0).  Usable in sync mode too, with the local-RAM
        tier alone."""
        s = _get_session()
        if s._checkpointer is None:
            from ray_tpu_torch.train.checkpoint_async import \
                AsyncCheckpointer

            plane = s.ckpt_plane or {}
            s._checkpointer = AsyncCheckpointer(
                storage_dir=plane.get("storage_dir"),
                run=plane.get("run", s.group_name),
                rank=s.rank,
                world=writers if writers is not None else s.world_size,
                peer_name=plane.get("peer"),
                server_names=plane.get("servers", ()),
                ledger=self.step_ledger(),
                # a memory-tier drain request preempts save()'s disk
                # backpressure: the emergency checkpoint commits at the
                # RAM tier inside the window even behind a slow persist
                preempt_ram=lambda: (
                    s.checkpoint_requested.is_set()
                    and s.checkpoint_request_tier == "memory"),
                drain_avoid=lambda: s.checkpoint_request_avoid,
            )
        elif writers is not None:
            # built earlier (a restore) with the world's size: the writer
            # group is the caller's
            s._checkpointer.world = writers
        return s._checkpointer

    def restore_checkpoint(self):
        """Restore the newest complete checkpoint for this mode: tiered
        walks the per-shard ladder (local RAM -> peer RAM -> committed
        disk) and reassembles the whole tree whatever world wrote it;
        sync loads the controller's latest directory checkpoint.  Returns
        a ``checkpoint_async.RestoreResult`` (``.tree``, ``.meta``,
        ``.index``, ``.tier``), or None before any checkpoint exists.
        The tree's tensors are on the host."""
        s = _get_session()
        if s.ckpt_plane is not None:
            return self.checkpointer().restore()
        ck = s.latest_checkpoint
        if ck is None:
            return None
        import re

        from ray_tpu_torch.train.checkpoint_async import RestoreResult

        m = re.search(r"checkpoint_(\d+)$", ck.path)
        return RestoreResult(
            tree=ck.to_state_dict(), meta={},
            index=int(m.group(1)) if m else 0, world=s.world_size,
            tier_by_rank={}, disk_reads=1, path=ck.path)

    def collective_group(self, backend: str = "tcp",
                         timeout_s: Optional[float] = None) -> str:
        """Join (once) the all-workers collective group; returns its name.

        The DP pattern: compute grads locally,
        ``col.allreduce(grads, ctx.collective_group("nccl"))``, apply
        locally.  The group name is generation-scoped, so a restarted
        worker group forms a fresh group — an aborted generation's
        rendezvous state never leaks into its replacement.
        ``timeout_s`` bounds every op: a peer that dies or hangs
        mid-allreduce surfaces as ``CollectiveAbortError`` (or, under
        NCCL, as this worker's death), a failure the controller restarts
        from the latest checkpoint.
        """
        from ray_tpu_torch.util import collective as col

        s = _get_session()
        name = f"train::{s.group_name}"
        if not col.is_group_initialized(name):
            col.init_collective_group(
                s.world_size, s.rank, backend, name, timeout_s=timeout_s
            )
        return name


def get_context() -> TrainContext:
    return TrainContext()


def get_dataset_shard(name: str = "train"):
    """This rank's dataset shard (parity: ``ray.train.get_dataset_shard``)
    of ``DataParallelTrainer(datasets={name: ds})``: for a
    ``ray_tpu_torch.data.Dataset``, this rank's ``DataIterator`` of a
    ``streaming_split(world_size, equal=True)`` made for this attempt
    (``iter_torch_batches`` lands its batches on this worker's device);
    any other value, replicated to every rank."""
    s = _get_session()
    shards = s.dataset_shard
    if shards is None:
        raise KeyError(
            f"no datasets were passed to the trainer (requested {name!r})")
    if isinstance(shards, dict):
        if name not in shards:
            raise KeyError(f"no dataset shard named {name!r}; have {list(shards)}")
        return shards[name]
    return shards


class _ProfileCapture:
    """Context manager for ``ray_tpu_torch.train.profile``: a
    ``torch.profiler`` capture (host ops, and the card's kernels on a
    GPU worker) written as a Chrome trace, ``trace.json``, into
    ``logdir`` (loadable in Perfetto or TensorBoard)."""

    def __init__(self, logdir: Optional[str] = None):
        import os

        if logdir is None:
            rank = _session.rank if _session is not None else 0
            logdir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                                  "profiles", f"rank{rank}")
        self.logdir = logdir
        self.trace_path = os.path.join(logdir, "trace.json")
        self._prof = None

    def __enter__(self):
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.logdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self._prof.export_chrome_trace(self.trace_path)
        return False


def profile(logdir: Optional[str] = None) -> _ProfileCapture:
    """Capture a profiler trace around training steps::

        with train.profile():
            for _ in range(3):
                state, m = trainer.step(state, batch)

    Writes ``trace.json`` per rank under the temp dir by default."""
    return _ProfileCapture(logdir)
