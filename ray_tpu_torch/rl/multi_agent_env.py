"""Multi-agent environments: dict-keyed agents over batched torch dynamics.

Counterpart of ``ray_tpu/rl/multi_agent_env.py`` (reference:
``rllib/env/multi_agent_env.py:30``, ``MultiAgentEnv`` — obs / rewards /
dones keyed by agent id — and the policy-mapping contract of
``rllib``'s multi-agent episodes).

A ``TorchMultiAgentEnv`` (the counterpart of ``JaxMultiAgentEnv``) is a
simultaneous-move env over BATCHED per-agent tensors on one device, so
the whole multi-agent rollout (every agent's action sampling + the joint
env step) is a loop of tensor ops there.  Episode boundaries are shared
across agents (simultaneous termination — the common case for team and
zero-sum games); per-agent "agent done" masking composes on top as an
env-level reward mask if needed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ray_tpu_torch.rl.env import EnvSpec, uniform


class TorchMultiAgentEnv:
    """ABC: batched simultaneous-move multi-agent env on a device.

    ``agent_ids`` is the ordered tuple of agent names; ``specs`` maps each
    to its (obs_dim, num_actions, max_episode_steps).
    """

    agent_ids: Tuple[str, ...]
    specs: Dict[str, EnvSpec]

    def reset(self, generator: torch.Generator, batch: int):
        """-> (state, obs: {agent_id: [B, obs_dim]})."""
        raise NotImplementedError

    def step(self, state, actions: Dict[str, torch.Tensor],
             generator: torch.Generator):
        """-> (next_state, obs, rewards, terminated, truncated, final_obs).

        ``obs`` / ``rewards`` / ``final_obs`` are dicts keyed by agent id;
        ``terminated`` / ``truncated`` are SHARED ``[B]`` masks (episodes
        end jointly).  ``obs`` is post-auto-reset; ``final_obs`` is the
        pre-reset observation used for time-limit bootstrapping.
        """
        raise NotImplementedError


class PursuitTagEnv(TorchMultiAgentEnv):
    """Two-agent zero-sum tag on a bounded 1-D line.

    The *pursuer* is rewarded for closing the distance to the *evader*
    (+10 bonus on a catch, which terminates the episode); the evader gets
    the exact negative.  Optimal play is OPPOSITE per role — the test that
    independent policies actually diverge.  Actions: 0 left / 1 stay /
    2 right; obs per agent: [own_pos, other_pos, signed_diff, t/T].
    """

    agent_ids = ("pursuer", "evader")
    _spec = EnvSpec(obs_dim=4, num_actions=3, max_episode_steps=128)
    specs = {"pursuer": _spec, "evader": _spec}

    move = 0.08
    evader_move = 0.05  # slower evader: catches are possible
    catch_radius = 0.1
    bound = 1.0

    def reset(self, generator: torch.Generator, batch: int):
        pos = uniform((batch, 2), -0.8, 0.8, generator)
        steps = torch.zeros((batch,), dtype=torch.int32, device=pos.device)
        state = (pos, steps)
        return state, self._obs(state)

    def _obs(self, state):
        pos, steps = state
        t = steps.float() / self._spec.max_episode_steps
        p, e = pos[:, 0], pos[:, 1]
        return {
            "pursuer": torch.stack([p, e, e - p, t], 1),
            "evader": torch.stack([e, p, p - e, t], 1),
        }

    def step(self, state, actions, generator: torch.Generator):
        pos, steps = state
        d_p = (actions["pursuer"].float() - 1.0) * self.move
        d_e = (actions["evader"].float() - 1.0) * self.evader_move
        p = torch.clamp(pos[:, 0] + d_p, -self.bound, self.bound)
        e = torch.clamp(pos[:, 1] + d_e, -self.bound, self.bound)
        dist = torch.abs(p - e)
        caught = dist < self.catch_radius
        steps = steps + 1
        terminated = caught
        truncated = (steps >= self._spec.max_episode_steps) & ~terminated
        done = terminated | truncated
        # zero-sum: pursuer earns the negative distance (+catch bonus)
        r_p = -dist + torch.where(caught, 10.0, 0.0)
        rewards = {"pursuer": r_p, "evader": -r_p}
        final_state = (torch.stack([p, e], 1), steps)
        final_obs = self._obs(final_state)
        # auto-reset finished envs
        fresh = uniform((pos.shape[0], 2), -0.8, 0.8, generator)
        next_pos = torch.where(done[:, None], fresh, final_state[0])
        next_steps = torch.where(done, 0, steps)
        next_state = (next_pos, next_steps)
        return (next_state, self._obs(next_state), rewards, terminated,
                truncated, final_obs)
