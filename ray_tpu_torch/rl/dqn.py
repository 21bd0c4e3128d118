"""DQN: double deep Q-learning with a host-side replay buffer.

Counterpart of ``ray_tpu/rl/dqn.py`` (reference: ``rllib/algorithms/dqn/``,
replay buffer + TorchLearner update).  Acting and the double-DQN update
run on the learner's device; the replay ring buffer is host numpy
(sampling is random access — a host structure feeding device batches,
the same host/device split the reference uses).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import TorchVectorEnv, make_env
from ray_tpu_torch.rl.models import (Adam, as_tensors, copy_tree, grad_step,
                                     mlp_apply, mlp_init, take, to_device,
                                     to_host)


@dataclasses.dataclass(frozen=True)
class DQNParams:
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    # both in ENV steps: one gradient update per update_every env steps,
    # target-network sync every target_update_freq env steps
    target_update_freq: int = 500
    update_every: int = 4
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 3_000
    hidden: Tuple[int, ...] = (64, 64)


class ReplayBuffer:
    """Uniform ring buffer (reference: ``utils/replay_buffers``)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.terminals = np.zeros((capacity,), np.float32)
        self.pos = 0
        self.size = 0

    def add_batch(self, obs, actions, rewards, next_obs, terminals):
        for i in range(len(actions)):
            j = self.pos
            self.obs[j] = obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.next_obs[j] = next_obs[i]
            self.terminals[j] = terminals[i]
            self.pos = (self.pos + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx], "next_obs": self.next_obs[idx],
                "terminals": self.terminals[idx]}


class DQNConfig:
    """Builder mirroring AlgorithmConfig's surface for the DQN family;
    ``device`` None means the card."""

    def __init__(self, device=None):
        self.env_name: Optional[str] = None
        self.num_envs = 8
        self.params = DQNParams()
        self.seed = 0
        self.device = device

    def environment(self, env: str) -> "DQNConfig":
        self.env_name = env
        return self

    def env_runners(self, num_envs_per_env_runner: int = 8) -> "DQNConfig":
        self.num_envs = num_envs_per_env_runner
        return self

    def training(self, **kw) -> "DQNConfig":
        self.params = dataclasses.replace(self.params, **kw)
        return self

    def seed_(self, seed: int) -> "DQNConfig":
        self.seed = seed
        return self

    def device_(self, device) -> "DQNConfig":
        self.device = device
        return self

    def build(self) -> "DQN":
        return DQN(self)


def dqn_loss(q_params, target_params, batch, gamma: float,
             n_layers: int) -> torch.Tensor:
    """Double-DQN TD loss: online argmax, target-net evaluation, Huber
    (delta 1, optax's) on the TD error against a detached target."""
    q = mlp_apply(q_params, batch["obs"], n_layers)
    q_sel = take(q, batch["actions"])
    with torch.no_grad():
        next_online = mlp_apply(q_params, batch["next_obs"], n_layers)
        next_a = torch.argmax(next_online, 1)
        next_target = mlp_apply(target_params, batch["next_obs"], n_layers)
        next_q = take(next_target, next_a)
        target = batch["rewards"] + gamma * next_q * (
            1.0 - batch["terminals"])
    return F.huber_loss(q_sel, target, delta=1.0, reduction="none").mean()


class DQN:
    def __init__(self, config: DQNConfig):
        self.config = config
        p = config.params
        env = make_env(config.env_name)
        if not isinstance(env, TorchVectorEnv):
            raise TypeError("DQN here drives torch envs; wrap gym envs via "
                            "register_env with a TorchVectorEnv")
        self.env = env
        spec = env.spec
        self.device = dev = resolve_device(config.device)
        self.sizes = [spec.obs_dim, *p.hidden, spec.num_actions]
        self.n_layers = len(self.sizes) - 1
        self.q_params = mlp_init(
            torch.Generator(device=dev).manual_seed(config.seed), self.sizes)
        self.target_params = copy_tree(self.q_params)
        self.tx = Adam(p.lr)
        self.opt_state = self.tx.init(self.q_params)
        self.rng = np.random.default_rng(config.seed)
        self.gen = torch.Generator(device=dev).manual_seed(config.seed + 1)
        self.buffer = ReplayBuffer(p.buffer_size, spec.obs_dim)
        self.env_state, self.obs = env.reset(
            torch.Generator(device=dev).manual_seed(config.seed),
            config.num_envs)
        self.total_steps = 0
        self.updates = 0
        self.iteration = 0
        self._update_base: Optional[int] = None
        self._last_sync = -1
        self._ep_returns = np.zeros(config.num_envs)
        self._completed: List[float] = []

    def q_values(self, params, obs):
        return mlp_apply(params, obs, self.n_layers)

    @torch.no_grad()
    def _act(self, params, obs, eps: float) -> torch.Tensor:
        greedy = torch.argmax(self.q_values(params, obs), 1)
        explore = torch.randint(0, self.env.spec.num_actions, greedy.shape,
                                generator=self.gen, device=self.device)
        coin = torch.rand(greedy.shape, generator=self.gen,
                          device=self.device)
        return torch.where(coin < eps, explore, greedy).int()

    def _update(self, batch) -> torch.Tensor:
        """One gradient step of the double-DQN loss on ``batch`` (host
        arrays or tensors); the loss as a device scalar."""
        batch = as_tensors(batch, self.device)
        loss = dqn_loss(self.q_params, self.target_params, batch,
                        self.config.params.gamma, self.n_layers)
        grad_step(loss, self.q_params, self.tx, self.opt_state)
        return loss.detach()

    def _epsilon(self) -> float:
        p = self.config.params
        frac = min(1.0, self.total_steps / p.epsilon_decay_steps)
        return p.epsilon_start + frac * (p.epsilon_end - p.epsilon_start)

    def train(self, steps_per_iteration: int = 512) -> Dict[str, Any]:
        p = self.config.params
        losses = []
        n_env = self.config.num_envs
        for _ in range(steps_per_iteration // n_env):
            actions = self._act(self.q_params, self.obs, self._epsilon())
            (self.env_state, next_obs, reward, terminated, truncated,
             final_obs) = self.env.step(self.env_state, actions, self.gen)
            host = to_host({"obs": self.obs, "actions": actions,
                            "reward": reward, "final_obs": final_obs,
                            "terminated": terminated,
                            "done": terminated | truncated})
            # store the TRUE successor (pre-reset) and terminal flags that
            # exclude time-limit truncation (bootstrap through it)
            self.buffer.add_batch(
                host["obs"], host["actions"], host["reward"],
                host["final_obs"], host["terminated"].astype(np.float32))
            self._ep_returns += host["reward"]
            for i in np.nonzero(host["done"])[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self.obs = next_obs
            self.total_steps += n_env
            if self.buffer.size >= p.learning_starts:
                # keep the update:env-step ratio at 1:update_every even with
                # vectorized envs (n_env steps advance per loop turn); no
                # backfill for the pre-learning warmup period
                if self._update_base is None:
                    self._update_base = self.total_steps // p.update_every
                due = ((self.total_steps // p.update_every)
                       - self._update_base - self.updates)
                for _ in range(max(0, due)):
                    losses.append(self._update(self.buffer.sample(
                        p.train_batch_size, self.rng)))
                    self.updates += 1
                if (self.total_steps // p.target_update_freq) > \
                        self._last_sync:
                    self._last_sync = self.total_steps // p.target_update_freq
                    self.target_params = copy_tree(self.q_params)
        recent = self._completed[-50:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "total_env_steps": self.total_steps,
            "num_updates": self.updates,
            "epsilon": self._epsilon(),
            "loss": (float(torch.stack(losses).mean()) if losses
                     else float("nan")),
            "episode_reward_mean": (float(np.mean(recent)) if recent
                                    else float("nan")),
        }

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"q_params": to_host(self.q_params),
                "target_params": to_host(self.target_params),
                "opt_state": to_host(self.opt_state),
                "total_steps": self.total_steps,
                "updates": self.updates, "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        self.q_params = to_device(state["q_params"], self.device,
                                  requires_grad=True)
        self.target_params = to_device(state["target_params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.total_steps = state["total_steps"]
        self.updates = state["updates"]
        self.iteration = state["iteration"]
        # align the update schedule with the restored counters, else `due`
        # stays negative for updates*update_every env steps after resume
        p = self.config.params
        self._update_base = (self.total_steps // p.update_every
                             - self.updates)
        self._last_sync = self.total_steps // p.target_update_freq

    def stop(self):
        pass
