"""RL environments: device-resident torch vector envs + gymnasium adapter.

Counterpart of ``ray_tpu/rl/env.py``.  A ``TorchVectorEnv`` (the
counterpart of ``JaxVectorEnv``) keeps its state as tensors on one
device and steps every env of the batch with tensor ops: ``step(state,
action, generator) -> (state, obs, reward, terminated, truncated,
final_obs)``.  A rollout is then a loop of such steps on the card, where
the reference runs it inside one jitted ``lax.scan``; the env never
leaves the device.  Randomness comes from an explicit ``torch.Generator``
on the state's device, where the reference takes a key.  Python/gym envs
are still supported through ``GymVectorEnv`` for the runner-process path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    obs_dim: int
    num_actions: int
    max_episode_steps: int


def uniform(shape, low: float, high: float,
            generator: torch.Generator) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=low, maxval=high)`` on the
    generator's device (fp32)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


class TorchVectorEnv:
    """ABC for device-resident vector envs (see CartPoleEnv)."""

    spec: EnvSpec

    def reset(self, generator: torch.Generator, batch: int):
        raise NotImplementedError

    def step(self, state, action, generator: torch.Generator):
        """-> (next_state, obs, reward, terminated, truncated, final_obs).

        ``terminated`` = true episode end (bootstrap value 0);
        ``truncated`` = time-limit cut (bootstrap from ``final_obs``, the
        pre-auto-reset observation).  ``obs`` is post-auto-reset.
        """
        raise NotImplementedError


class CartPoleEnv(TorchVectorEnv):
    """CartPole-v1 dynamics, batched, in torch (matches gymnasium's
    physics).  The state lives on the device of the generator it was
    reset with."""

    spec = EnvSpec(obs_dim=4, num_actions=2, max_episode_steps=500)

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4

    def reset(self, generator: torch.Generator, batch: int):
        state = uniform((batch, 4), -0.05, 0.05, generator)
        steps = torch.zeros((batch,), dtype=torch.int32,
                            device=state.device)
        return (state, steps), state

    def step(self, env_state, action, generator: torch.Generator):
        state, steps = env_state
        x, x_dot, theta, theta_dot = state.unbind(1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        steps = steps + 1
        terminated = ((torch.abs(x) > self.x_threshold)
                      | (torch.abs(theta) > self.theta_threshold))
        truncated = (steps >= self.spec.max_episode_steps) & ~terminated
        done = terminated | truncated
        reward = torch.ones_like(x)
        final_obs = torch.stack([x, x_dot, theta, theta_dot], dim=1)
        # auto-reset finished envs (standard vector-env semantics); a fresh
        # state is drawn for every row and kept where the episode ended
        fresh = uniform(final_obs.shape, -0.05, 0.05, generator)
        next_state = torch.where(done[:, None], fresh, final_obs)
        steps = torch.where(done, 0, steps)
        return ((next_state, steps), next_state, reward, terminated,
                truncated, final_obs)


_ENVS: Dict[str, Callable[[], Any]] = {
    "CartPole-v1": CartPoleEnv,
}


def register_env(name: str, factory: Callable[[], Any]) -> None:
    _ENVS[name] = factory


def env_factory(name: str) -> Optional[Callable[[], Any]]:
    """The factory registered under ``name`` in this process, or None.
    ``EnvRunnerGroup`` carries it to its runner processes, whose registry
    starts empty of what the driver registered."""
    return _ENVS.get(name)


def make_env(name: str):
    if name in _ENVS:
        return _ENVS[name]()
    return GymVectorEnv(name)  # fall back to gymnasium


class GymVectorEnv:
    """Host-side gymnasium vector env for the runner-process path."""

    def __init__(self, name: str):
        import gymnasium as gym

        self._gym = gym
        self.name = name
        self.envs = None
        probe = gym.make(name)
        self.spec = EnvSpec(
            obs_dim=int(np.prod(probe.observation_space.shape)),
            num_actions=int(probe.action_space.n),
            max_episode_steps=probe.spec.max_episode_steps or 1000)
        probe.close()

    def make_batch(self, num_envs: int, seed: int = 0):
        # SAME_STEP autoreset: the step that ends an episode returns the
        # reset obs but surfaces the true final obs in info["final_obs"] —
        # gymnasium>=1.0's NEXT_STEP default would inject a phantom
        # transition (ignored action, zero reward) into the training data.
        kw = {}
        if hasattr(self._gym.vector, "AutoresetMode"):
            kw["autoreset_mode"] = self._gym.vector.AutoresetMode.SAME_STEP
        self.envs = self._gym.vector.SyncVectorEnv(
            [lambda: self._gym.make(self.name) for _ in range(num_envs)], **kw)
        obs, _ = self.envs.reset(seed=seed)
        return obs

    def step(self, actions: np.ndarray):
        """-> (obs, reward, terminated, truncated, final_obs)."""
        obs, rew, term, trunc, info = self.envs.step(actions)
        final_obs = obs
        done = term | trunc
        if done.any() and "final_obs" in info:
            final_obs = obs.copy()
            for i in np.nonzero(done)[0]:
                fo = info["final_obs"][i]
                if fo is not None:
                    final_obs[i] = np.asarray(fo).reshape(obs.shape[1:])
        return obs, rew, term, trunc, final_obs
