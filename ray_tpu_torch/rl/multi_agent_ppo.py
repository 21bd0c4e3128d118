"""Multi-agent PPO: per-agent policy mapping over shared or independent
learners.

Counterpart of ``ray_tpu/rl/multi_agent_ppo.py`` (reference: rllib's
multi-agent stack — ``MultiAgentEnv`` (``rllib/env/multi_agent_env.py:30``),
the ``policy_mapping_fn`` contract (``algorithm_config.py``
``multi_agent()``), and multi-module learners
(``core/rl_module/multi_rl_module.py``)).

The JOINT rollout — every agent's action sampling plus the simultaneous
env step — is a loop of tensor ops on the learners' device, with
per-agent GAE there too.  Policy mapping is static at build time (agent
id → policy id).  Mapping every agent to one policy id gives parameter
sharing (one learner trained on all agents' data); distinct policy ids
give independent learners.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.models import ActorCriticModule
from ray_tpu_torch.rl.multi_agent_env import TorchMultiAgentEnv
from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner, compute_gae


def make_multi_agent_rollout_fn(
    modules: Dict[str, ActorCriticModule],
    policy_of: Dict[str, str],
    env: TorchMultiAgentEnv,
    num_steps: int,
    config: PPOConfig,
):
    """Joint rollout: each step samples EVERY agent's action from its
    mapped policy, steps the env once, and the fragment ends in per-agent
    trajectories with GAE targets — with no read back to the host."""

    agent_ids = tuple(env.agent_ids)
    keys = ("obs", "actions", "logp_old", "rewards", "raw_rewards", "dones",
            "values")

    @torch.no_grad()
    def rollout(params_by_pid, env_state, obs, generator):
        traj = {aid: {k: [] for k in keys} for aid in agent_ids}
        for _ in range(num_steps):
            actions, logps, values = {}, {}, {}
            for aid in agent_ids:
                pid = policy_of[aid]
                m = modules[pid]
                a, lp = m.sample_action(params_by_pid[pid], obs[aid],
                                        generator)
                actions[aid] = a
                logps[aid] = lp
                values[aid] = m.value(params_by_pid[pid], obs[aid])
            (env_state, next_obs, rewards, terminated, truncated,
             final_obs) = env.step(env_state, actions, generator)
            done = terminated | truncated
            for aid in agent_ids:
                pid = policy_of[aid]
                # time-limit bootstrap per agent (ppo.py semantics)
                v_final = modules[pid].value(params_by_pid[pid],
                                             final_obs[aid])
                train_rew = rewards[aid] + config.gamma * v_final * truncated
                for k, v in zip(keys, (obs[aid], actions[aid], logps[aid],
                                       train_rew, rewards[aid], done,
                                       values[aid])):
                    traj[aid][k].append(v)
            obs = next_obs
        batches, stats = {}, {}
        for aid in agent_ids:
            pid = policy_of[aid]
            t = {k: torch.stack(v) for k, v in traj[aid].items()}
            last_value = modules[pid].value(params_by_pid[pid], obs[aid])
            advs, returns = compute_gae(
                t["rewards"], t["values"], t["dones"], last_value,
                config.gamma, config.gae_lambda)
            batches[aid] = {
                "obs": t["obs"].reshape(-1, t["obs"].shape[-1]),
                "actions": t["actions"].reshape(-1),
                "logp_old": t["logp_old"].reshape(-1),
                "advantages": advs.reshape(-1),
                "returns": returns.reshape(-1),
            }
            stats[aid] = {"reward_per_step": t["raw_rewards"].mean(),
                          "episodes_done": t["dones"].sum()}
        return env_state, obs, batches, stats

    return rollout


class MultiAgentPPO:
    """2+ agents, shared or independent PPO learners.

    ``policy_mapping`` maps agent id → policy id; omitted agents map to a
    policy named after themselves (fully independent).  All agents mapped
    to one policy id share parameters AND training data (the reference's
    parameter-sharing mode).  ``device`` None means the card."""

    def __init__(
        self,
        env: TorchMultiAgentEnv,
        *,
        policy_mapping: Optional[Dict[str, str]] = None,
        config: Optional[PPOConfig] = None,
        hidden_sizes: Tuple[int, ...] = (64, 64),
        num_envs: int = 16,
        rollout_len: int = 64,
        seed: int = 0,
        device=None,
    ):
        self.env = env
        self.config = config or PPOConfig()
        self.device = resolve_device(device)
        self.policy_of = {
            aid: (policy_mapping or {}).get(aid, aid)
            for aid in env.agent_ids
        }
        self.policy_ids = tuple(sorted(set(self.policy_of.values())))
        # one module per policy; agents sharing a policy must agree on
        # observation/action shapes
        self.modules: Dict[str, ActorCriticModule] = {}
        for pid in self.policy_ids:
            agents = [a for a, p in self.policy_of.items() if p == pid]
            shapes = {(env.specs[a].obs_dim, env.specs[a].num_actions)
                      for a in agents}
            if len(shapes) != 1:
                raise ValueError(
                    f"agents {agents} share policy {pid!r} but have "
                    f"mismatched obs/action shapes {shapes}")
            obs_dim, num_actions = next(iter(shapes))
            self.modules[pid] = ActorCriticModule(obs_dim, num_actions,
                                                  hidden_sizes)
        self.learners: Dict[str, PPOLearner] = {
            pid: PPOLearner(self.modules[pid], self.config, seed=seed,
                            device=self.device)
            for pid in self.policy_ids
        }
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.env_state, self.obs = env.reset(self.gen, num_envs)
        self._rollout = make_multi_agent_rollout_fn(
            self.modules, self.policy_of, env, rollout_len, self.config)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        params = {pid: ln.params for pid, ln in self.learners.items()}
        self.env_state, self.obs, batches, stats = self._rollout(
            params, self.env_state, self.obs, self.gen)
        metrics: Dict[str, Any] = {}
        agent_steps = 0
        # group agent batches by policy: shared policies train on the
        # CONCATENATION of their agents' data
        for pid in self.policy_ids:
            agents = [a for a, p in self.policy_of.items() if p == pid]
            joint = {
                k: torch.cat([batches[a][k] for a in agents])
                for k in batches[agents[0]]
            }
            metrics[f"policy/{pid}"] = self.learners[pid].update(joint,
                                                                 self.gen)
            agent_steps += int(joint["obs"].shape[0])
        # every agent's stats in one host read
        aids = self.env.agent_ids
        flat = torch.stack([stats[a][k].float() for a in aids
                            for k in ("reward_per_step", "episodes_done")]
                           ).tolist()
        for i, aid in enumerate(aids):
            metrics[f"agent/{aid}/reward_per_step"] = flat[2 * i]
            metrics[f"agent/{aid}/episodes_done"] = flat[2 * i + 1]
        # env steps = true env transitions; agent steps = one per agent
        # per transition (the reference distinguishes
        # num_env_steps_sampled from num_agent_steps_sampled)
        env_steps = int(batches[aids[0]]["obs"].shape[0])
        self.iteration += 1
        dt = time.perf_counter() - t0
        metrics.update({
            "training_iteration": self.iteration,
            "env_steps_this_iter": env_steps,
            "agent_steps_this_iter": agent_steps,
            "env_steps_per_sec": env_steps / dt,
            "agent_steps_per_sec": agent_steps / dt,
        })
        return metrics

    # -- checkpointing ----------------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"learners": {pid: ln.get_state()
                             for pid, ln in self.learners.items()},
                "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        for pid, st in state["learners"].items():
            self.learners[pid].set_state(st)
        self.iteration = state["iteration"]

    def get_policy_params(self, policy_id: str):
        return self.learners[policy_id].get_weights()
