"""Algorithm facade: config -> build() -> train() iterations.

Counterpart of ``ray_tpu/rl/algorithm.py`` (reference:
``rllib/algorithms/algorithm.py:207``, Algorithm orchestrating
EnvRunnerGroup + LearnerGroup, and ``algorithm_config.py``'s builder).
Two execution modes:

- env_runners(num_env_runners=0) + a torch env: everything — rollout, GAE,
  minibatch epochs — runs as tensor ops on the learner's device in this
  process, and the host reads the iteration's metrics once.
- num_env_runners>0 (or a gym env): EnvRunner processes collect on the
  host's CPU, the learner updates on its device — the reference's
  architecture.

The learner's device is the config's ``device``: None means the card
(``_device.resolve_device``); the tests pass ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import TorchVectorEnv, make_env
from ray_tpu_torch.rl.models import ActorCriticModule
from ray_tpu_torch.rl.ppo import (PPOConfig, PPOLearner, compute_gae,
                                  make_rollout_fn)


class AlgorithmConfig:
    def __init__(self, algo_class=None, device=None):
        self.algo_class = algo_class or PPO
        self.env_name: Optional[str] = None
        self.num_env_runners = 0
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 128
        self.hidden_sizes = (64, 64)
        self.ppo = PPOConfig()
        self.seed = 0
        self.device = device

    def environment(self, env: str) -> "AlgorithmConfig":
        self.env_name = env
        return self

    def env_runners(self, num_env_runners: int = 0,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 128) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 clip_eps: Optional[float] = None,
                 entropy_coef: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 num_minibatches: Optional[int] = None,
                 hidden_sizes=None) -> "AlgorithmConfig":
        kw = {k: v for k, v in dict(
            lr=lr, gamma=gamma, clip_eps=clip_eps, entropy_coef=entropy_coef,
            num_epochs=num_epochs, num_minibatches=num_minibatches,
        ).items() if v is not None}
        self.ppo = dataclasses.replace(self.ppo, **kw)
        if hidden_sizes is not None:
            self.hidden_sizes = tuple(hidden_sizes)
        return self

    def seed_(self, seed: int) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def device_(self, device) -> "AlgorithmConfig":
        self.device = device
        return self

    def build(self) -> "Algorithm":
        return self.algo_class(self)


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        self.config = config

    def train(self) -> Dict[str, Any]:
        raise NotImplementedError

    def stop(self):
        pass


def episode_reward(algo, n_steps: int, stats: Dict[str, torch.Tensor]
                   ) -> float:
    """The vectorized path's episode reward estimate from a rollout's
    device stats, read in one host sync: reward per step times steps over
    episodes finished; with no episode finished this fragment, the
    previous estimate is carried rather than the whole batch's reward."""
    eps, rps = torch.stack([stats["episodes_done"].float(),
                            stats["reward_per_step"].float()]).tolist()
    if eps > 0:
        algo._last_ep_reward = rps * n_steps / eps
    return algo._last_ep_reward


class PPO(Algorithm):
    def __init__(self, config: AlgorithmConfig):
        super().__init__(config)
        env = make_env(config.env_name)
        self.is_torch_env = isinstance(env, TorchVectorEnv)
        self.env = env
        spec = env.spec
        self.device = resolve_device(config.device)
        self.module = ActorCriticModule(spec.obs_dim, spec.num_actions,
                                        config.hidden_sizes)
        self.learner = PPOLearner(self.module, config.ppo, seed=config.seed,
                                  device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.iteration = 0
        self._ep_returns: List[float] = []
        self._last_ep_reward = float("nan")
        if self.is_torch_env and config.num_env_runners == 0:
            self.env_state, self.obs = env.reset(
                self.gen, config.num_envs_per_runner)
            self._rollout = make_rollout_fn(
                self.module, env, config.rollout_fragment_length, config.ppo)
            self.runner_group = None
        else:
            from ray_tpu_torch.rl.env_runner import EnvRunnerGroup

            self.runner_group = EnvRunnerGroup(
                config.env_name, max(1, config.num_env_runners),
                config.num_envs_per_runner,
                {"obs_dim": spec.obs_dim, "num_actions": spec.num_actions,
                 "hidden": config.hidden_sizes, "gamma": config.ppo.gamma},
                seed=config.seed)
            self.runner_group.sync_weights(self.learner.get_weights())

    # -- one training iteration -------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        if self.runner_group is None:
            self.env_state, self.obs, batch, stats = self._rollout(
                self.learner.params, self.env_state, self.obs, self.gen)
            metrics = self.learner.update(batch, self.gen)
            n_steps = int(batch["obs"].shape[0])
            ep_reward = episode_reward(self, n_steps, stats)
        else:
            trajs = self.runner_group.sample(cfg.rollout_fragment_length)
            batch = self._assemble(trajs)
            metrics = self.learner.update(batch, self.gen)
            self.runner_group.sync_weights(self.learner.get_weights())
            n_steps = int(batch["obs"].shape[0])
            done_eps = self.runner_group.episode_stats()
            self._ep_returns.extend(done_eps)
            recent = self._ep_returns[-50:]
            ep_reward = float(np.mean(recent)) if recent else float("nan")
        self.iteration += 1
        metrics.update({
            "training_iteration": self.iteration,
            "env_steps_this_iter": n_steps,
            "env_steps_per_sec": n_steps / (time.perf_counter() - t0),
            "episode_reward_mean": ep_reward,
        })
        return metrics

    def _assemble(self, trajs: List[Dict[str, np.ndarray]]):
        """The runners' fragments as one flat batch on the learner's
        device, rows in the reference's order (fragment by fragment, each
        [T, B] row-major).  GAE runs on each column alone, so the
        fragments' columns side by side take one reverse loop over T
        there, not one per fragment."""
        dev, ppo = self.device, self.config.ppo

        def cols(key, dtype=torch.float32):
            return torch.as_tensor(np.concatenate(
                [t[key] for t in trajs], axis=-1), dtype=dtype).to(dev)

        advs, rets = compute_gae(cols("rewards"), cols("values"),
                                 cols("dones", torch.bool),
                                 cols("last_value"), ppo.gamma,
                                 ppo.gae_lambda)
        widths = [t["rewards"].shape[1] for t in trajs]

        def flat(x):  # [T, sum B] -> each fragment's [T, B] row-major
            return torch.cat([c.reshape(-1)
                              for c in torch.split(x, widths, dim=1)])

        def rows(key, dtype=None):
            return torch.as_tensor(np.concatenate(
                [t[key].reshape(-1, *t[key].shape[2:]) for t in trajs]),
                dtype=dtype).to(dev)

        return {"obs": rows("obs", torch.float32), "actions": rows("actions"),
                "logp_old": rows("logp_old", torch.float32),
                "advantages": flat(advs), "returns": flat(rets)}

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"learner": self.learner.get_state(),
                "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        if "learner" in state:
            self.learner.set_state(state["learner"])
        else:  # params-only checkpoint (older format)
            self.learner.set_weights(state["params"])
        self.iteration = state["iteration"]
        if self.runner_group is not None:
            self.runner_group.sync_weights(self.learner.get_weights())

    def stop(self):
        if self.runner_group is not None:
            self.runner_group.stop()
