"""ray_tpu_torch.rl: reinforcement learning (counterpart of
``ray_tpu.rl``; reference: ``rllib/``).

PPO with rollouts on the learner's device for torch envs
(``TorchVectorEnv``: the batched CartPole runs as tensors on the card) or
EnvRunner processes for python/gym envs (the reference's architecture,
with one process per runner in place of an actor), IMPALA/APPO, DQN,
SAC, BC/MARWIL, CQL, multi-agent PPO and DreamerV3.  Entry points take a
``device``: None means the card.

Not ported yet (the next slice): the RLHF loop (``RLHFConfig``,
``RLHFLoop``, ``RolloutActor``/``RolloutGroup``, ``TrajectoryLedger``)
and ``weight_sync``'s names (``WeightPublisher``, ``WeightSubscriber``,
``WeightVersion``, ``WeightSyncError``, ``WeightsStaleError``,
``NoWeightsPublishedError``).
"""

from ray_tpu_torch.rl.algorithm import PPO, Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.bc import BC, MARWIL, MARWILParams
from ray_tpu_torch.rl.cql import CQL, CQLParams
from ray_tpu_torch.rl.dqn import DQN, DQNConfig, DQNParams, ReplayBuffer
from ray_tpu_torch.rl.dreamer import DreamerParams, DreamerV3
from ray_tpu_torch.rl.env import (
    CartPoleEnv,
    EnvSpec,
    GymVectorEnv,
    TorchVectorEnv,
    make_env,
    register_env,
)
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.impala import (APPO, IMPALA, ImpalaLearner,
                                     ImpalaParams, vtrace)
from ray_tpu_torch.rl.models import ActorCriticModule
from ray_tpu_torch.rl.multi_agent_env import PursuitTagEnv, TorchMultiAgentEnv
from ray_tpu_torch.rl.multi_agent_ppo import (
    MultiAgentPPO,
    make_multi_agent_rollout_fn,
)
from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner, compute_gae
from ray_tpu_torch.rl.sac import SAC, SACConfig, SACParams

__all__ = [
    "APPO", "BC", "CQL", "CQLParams", "DQN", "DQNConfig", "DQNParams",
    "DreamerParams", "DreamerV3", "IMPALA",
    "ImpalaLearner", "ImpalaParams", "MARWIL", "MARWILParams",
    "ReplayBuffer", "PPO", "SAC", "SACConfig", "SACParams",
    "Algorithm", "AlgorithmConfig", "ActorCriticModule",
    "CartPoleEnv", "EnvRunner", "EnvRunnerGroup", "EnvSpec", "GymVectorEnv",
    "MultiAgentPPO", "PPOConfig", "PPOLearner", "PursuitTagEnv",
    "TorchMultiAgentEnv", "TorchVectorEnv", "compute_gae",
    "make_multi_agent_rollout_fn", "make_env", "register_env", "vtrace",
]
