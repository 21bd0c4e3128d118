"""ray_tpu_torch.train: SPMD training over a group of worker processes,
one rank per card (counterpart of ``ray_tpu.train``).

Parity target: ``ray.train`` (v2 control-loop design,
``python/ray/train/v2/``); see ``trainer.TorchTrainer``.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_async import (
    AsyncCheckpointer,
    RestoreResult,
    TieredCheckpoint,
)
from ray_tpu_torch.train.checkpoint_manager import latest_committed_checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.policies import (
    DefaultFailurePolicy,
    ElasticScalingPolicy,
    FailureDecision,
    FailurePolicy,
    FixedScalingPolicy,
    ResizeDecision,
    ScalingPolicy,
)
from ray_tpu_torch.train.session import (
    StepLedger,
    TrainContext,
    get_context,
    get_dataset_shard,
    get_mesh,
    profile,
    report,
    shard_inputs,
    shard_params,
)
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    TorchTrainer,
    initialize_torch_distributed,
)

__all__ = [
    "AsyncCheckpointer", "RestoreResult", "TieredCheckpoint",
    "Checkpoint", "CheckpointConfig", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "DefaultFailurePolicy", "ElasticScalingPolicy",
    "FailureDecision", "FailurePolicy", "FixedScalingPolicy", "ResizeDecision",
    "ScalingPolicy", "TrainContext", "get_context", "get_dataset_shard",
    "get_mesh", "shard_inputs", "shard_params",
    "profile", "report", "StepLedger", "DataParallelTrainer", "TorchTrainer",
    "initialize_torch_distributed", "latest_committed_checkpoint",
]
