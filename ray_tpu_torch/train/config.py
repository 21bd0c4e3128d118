"""Train configuration dataclasses (counterpart of
``ray_tpu/train/config.py``).

Parity: ``ray.train`` configs (``python/ray/air/config.py`` —
ScalingConfig/RunConfig/CheckpointConfig/FailureConfig).  The scaling
unit is one worker process per card: ``use_gpu`` and ``gpus_per_worker``
take the place of the reference's ``use_tpu`` and ``chips_per_worker``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional, Union

if TYPE_CHECKING:
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    num_workers: training worker processes, one rank each.
    use_gpu: each worker runs on a card of its own (NCCL), bound by its
    local rank; False runs the workers on the host (gloo).
    gpus_per_worker: GPUs reserved for each worker (default 1 with
    ``use_gpu``); the group must fit the cards this node has.  A worker
    computes on one card: a mesh spans one card per rank.
    resources_per_worker: extra resources reserved per worker.
    mesh: the mesh the worker group should form over its ranks — a
    ``parallel.MeshConfig`` or a preset name ("dp", "fsdp", "fsdp_tp").
    This is the *requested* shape: each worker generation re-resolves it
    against the ranks actually present (``MeshConfig.clamp_to``), so an
    elastic restart that shrinks the group re-forms a valid smaller
    mesh.  ``train.get_mesh()`` inside the loop returns the resolved
    ``DeviceMesh``.
    logical_axis_rules: override for the logical-axis → mesh-axis rule
    table (default ``parallel.sharding.DEFAULT_RULES``) used by
    ``train.shard_params`` / ``train.shard_inputs``.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: Optional[float] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: Union[str, "MeshConfig", None] = None
    logical_axis_rules: Optional["LogicalAxisRules"] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        gpus = self.gpus_per_worker
        if self.use_gpu:
            res["GPU"] = 1.0 if gpus is None else float(gpus)
        return res

    def mesh_config(self) -> Optional["MeshConfig"]:
        """The requested mesh as a concrete MeshConfig (preset names
        resolved; None when no mesh was requested).  Raises ValueError
        on an unknown preset — callers validate at trainer construction
        so a typo fails before any worker starts."""
        if self.mesh is None:
            return None
        from ray_tpu_torch.parallel.mesh import resolve_mesh_config

        return resolve_mesh_config(self.mesh)


@dataclasses.dataclass
class CheckpointConfig:
    """Checkpoint bookkeeping.

    mode: ``"sync"`` — the loop reports whole-tree directory checkpoints
    that the controller copies into storage.  The reference's
    ``"tiered"`` plane (per-rank shards persisted in the background,
    peer-RAM replicas) is not ported, and asking for it raises.
    """

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    mode: str = "sync"

    def __post_init__(self):
        if self.mode != "sync":
            raise ValueError(
                f"CheckpointConfig(mode={self.mode!r}): the port has only "
                "mode='sync' (the tiered checkpoint plane is not ported)")


@dataclasses.dataclass
class FailureConfig:
    """max_failures: group restarts allowed (-1 = unlimited)."""

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig
    )


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Any]
    path: Optional[str]
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None
