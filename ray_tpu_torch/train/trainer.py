"""User-facing trainers (counterpart of ``ray_tpu/train/trainer.py``).

Parity: ``DataParallelTrainer``
(``python/ray/train/data_parallel_trainer.py:26``, v2
``python/ray/train/v2/api/data_parallel_trainer.py:96 fit()``).
``TorchTrainer`` is the counterpart of the reference's ``JaxTrainer``: it
gives each worker the variables ``torch.distributed`` joins a process
group from (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), so the ranks form one default group, NCCL over their
cards (gloo on the host), on which ``train.get_mesh()`` lays the mesh.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController
from ray_tpu_torch.train.policies import FailurePolicy, ScalingPolicy


class DataParallelTrainer:
    """SPMD trainer: run one function on N worker processes, one rank
    each.

    The loop travels to the workers by stdlib ``pickle``, by reference:
    it must be a module-level function that a freshly started process
    can import (no closures or lambdas), and its config must pickle too;
    both are checked here, before any process starts.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        failure_policy: Optional[FailurePolicy] = None,
        scaling_policy: Optional[ScalingPolicy] = None,
    ):
        try:
            self._fn_payload = pickle.dumps(train_loop_per_worker)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"train_loop_per_worker {train_loop_per_worker!r} cannot "
                "travel to the worker processes: it must be a module-level "
                "function they can import (stdlib pickle; no closure, "
                f"lambda or nested function): {e}") from e
        self.train_loop_config = train_loop_config or {}
        try:
            pickle.dumps(self.train_loop_config)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"train_loop_config cannot travel to the worker processes "
                f"(stdlib pickle): {e}") from e
        self.scaling_config = scaling_config or ScalingConfig()
        # a bad mesh preset must fail HERE, not after workers started
        self.scaling_config.mesh_config()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.failure_policy = failure_policy
        self.scaling_policy = scaling_policy
        self.controller: Optional[TrainController] = None

    def _dist_env_fn(self, group) -> Optional[List[Dict[str, str]]]:
        return None

    def fit(self) -> Result:
        self.controller = TrainController(
            fn_payload=self._fn_payload,
            train_loop_config=self.train_loop_config,
            scaling_config=self.scaling_config,
            run_config=self.run_config,
            failure_policy=self.failure_policy,
            scaling_policy=self.scaling_policy,
            datasets=self.datasets,
            dist_env_fn=self._dist_env_fn,
            resume_from_checkpoint=self.resume_from_checkpoint,
        )
        return self.controller.run()


class TorchTrainer(DataParallelTrainer):
    """Forms one ``torch.distributed`` default group across the worker
    group.

    Each worker gets ``MASTER_ADDR`` / ``MASTER_PORT`` (a free port of
    rank 0's process) / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, so the
    loop (``train.get_mesh()``, or ``initialize_torch_distributed()``)
    joins one group of all ranks.  With one worker no variables are
    needed: the group is a world of one.
    """

    def _dist_env_fn(self, group) -> Optional[List[Dict[str, str]]]:
        num_workers = len(group.workers)
        if num_workers <= 1:
            return None
        # the store is bound by rank 0 *inside its worker*, so the port
        # must be free on that worker's host
        ip = group.worker_metadata[0]["ip"]
        port = group.call(0, "find_free_port", timeout=30)
        return [
            {
                "MASTER_ADDR": ip,
                "MASTER_PORT": str(port),
                "RANK": str(rank),
                "WORLD_SIZE": str(num_workers),
                "LOCAL_RANK": str(group.worker_metadata[rank]["local_rank"]),
            }
            for rank in range(num_workers)
        ]


def initialize_torch_distributed(device=None) -> None:
    """Inside a TorchTrainer worker loop: join the run's default process
    group (``parallel.ensure_process_group``; NCCL on the card unless
    ``device="cpu"``), then check that it holds the world size and this
    worker's rank the trainer assigned, so that a group formed under
    another rank fails here instead of training on the wrong rows."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import ensure_process_group

    ensure_process_group(device)
    want_world = int(os.environ.get("WORLD_SIZE", "1"))
    want_rank = int(os.environ.get("RANK", "0"))
    if dist.get_world_size() != want_world:
        raise RuntimeError(
            f"the process group holds {dist.get_world_size()} rank(s), "
            f"expected {want_world}")
    if dist.get_rank() != want_rank:
        raise RuntimeError(
            f"the process group's rank {dist.get_rank()} != assigned rank "
            f"{want_rank}: this process joined a group formed under "
            "another rank")
