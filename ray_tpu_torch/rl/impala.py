"""IMPALA / APPO: V-trace off-policy actor-critic on one device.

Counterpart of ``ray_tpu/rl/impala.py`` (reference:
``rllib/algorithms/impala/``, V-trace in the ``vtrace_torch.py`` lineage,
and ``rllib/algorithms/appo/``).  The V-trace correction is a reverse loop
over the fragment on the learner's device, and the update one gradient
step there; runner processes reuse the EnvRunnerGroup, whose stale-policy
lag is exactly what V-trace corrects.

Set ``clip_ratio`` (APPO) to bound the policy update like PPO; leave None
for plain IMPALA.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, episode_reward
from ray_tpu_torch.rl.env import TorchVectorEnv, make_env
from ray_tpu_torch.rl.models import (ActorCriticModule, Adam, as_tensors,
                                     grad_step, mean_metrics, take, to_device,
                                     to_host)


@dataclasses.dataclass(frozen=True)
class ImpalaParams:
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.5
    # V-trace clipping (Espeholt et al. 2018): rho-bar bounds the value
    # target correction, c-bar bounds the trace propagation.
    rho_clip: float = 1.0
    c_clip: float = 1.0
    # APPO: additionally clip the surrogate ratio PPO-style; None = IMPALA.
    clip_ratio: Optional[float] = None


@torch.no_grad()
def vtrace(behaviour_logp, target_logp, rewards, values, dones, last_value,
           gamma, rho_clip=1.0, c_clip=1.0):
    """V-trace targets and policy-gradient advantages.

    All inputs [T, B] (time-major); last_value [B].  Returns (vs, pg_adv):
    vs are the corrected value targets, pg_adv the clipped-IS advantages
    ``rho_t * (r_t + gamma * vs_{t+1} - V(x_t))``; neither carries a
    gradient (the reference's ``stop_gradient``).
    """
    rho = torch.exp(target_logp - behaviour_logp)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=c_clip)
    nonterminal = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_value[None]], 0)
    # v_{t+1} is zero after a terminal inside the fragment.
    deltas = rho_bar * (rewards + gamma * next_values * nonterminal - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * nonterminal[t] * c_bar[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    next_vs = torch.cat([vs[1:], last_value[None]], 0)
    pg_adv = rho_bar * (rewards + gamma * next_vs * nonterminal - values)
    return vs, pg_adv


class ImpalaLearner:
    """Params + optimizer on one device; one update over a time-major
    fragment."""

    def __init__(self, module: ActorCriticModule, params_cfg: ImpalaParams,
                 seed: int = 0, device=None):
        self.module = module
        self.cfg = params_cfg
        self.device = resolve_device(device)
        self.params = module.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self.tx = Adam(params_cfg.lr, params_cfg.max_grad_norm)
        self.opt_state = self.tx.init(self.params)

    def _loss(self, params, batch):
        c = self.cfg
        T, B = batch["actions"].shape
        obs_flat = batch["obs"].reshape(T * B, -1)
        logits, values = self.module.forward(params, obs_flat)
        logits = logits.reshape(T, B, -1)
        values = values.reshape(T, B)
        logp_all = torch.log_softmax(logits, -1)
        logp = take(logp_all, batch["actions"])

        vs, pg_adv = vtrace(
            batch["behaviour_logp"], logp.detach(), batch["rewards"],
            values.detach(), batch["dones"], batch["last_value"],
            c.gamma, c.rho_clip, c.c_clip)

        if c.clip_ratio is not None:  # APPO surrogate
            ratio = torch.exp(logp - batch["behaviour_logp"])
            unclipped = ratio * pg_adv
            clipped = torch.clamp(
                ratio, 1 - c.clip_ratio, 1 + c.clip_ratio) * pg_adv
            pi_loss = -torch.minimum(unclipped, clipped).mean()
        else:  # IMPALA policy gradient
            pi_loss = -(logp * pg_adv).mean()
        vf_loss = torch.mean((values - vs) ** 2)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, -1).mean()
        total = pi_loss + c.vf_coef * vf_loss - c.entropy_coef * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def update(self, batch) -> Dict[str, float]:
        batch = as_tensors(batch, self.device)
        total, aux = self._loss(self.params, batch)
        grad_step(total, self.params, self.tx, self.opt_state)
        return mean_metrics([aux])

    def get_state(self) -> Dict[str, Any]:
        return {"params": to_host(self.params),
                "opt_state": to_host(self.opt_state)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device,
                                requires_grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)


class IMPALA(Algorithm):
    """Rollouts on the learner's device for torch envs or EnvRunner
    processes for gym envs; behaviour logp is captured at collection time
    so the update is off-policy-correct even with stale runners."""

    def __init__(self, config: AlgorithmConfig):
        super().__init__(config)
        self.params_cfg = getattr(config, "impala", ImpalaParams())
        env = make_env(config.env_name)
        self.env = env
        spec = env.spec
        self.device = resolve_device(config.device)
        self.module = ActorCriticModule(spec.obs_dim, spec.num_actions,
                                        config.hidden_sizes)
        self.learner = ImpalaLearner(self.module, self.params_cfg,
                                     seed=config.seed, device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.iteration = 0
        self._last_ep_reward = float("nan")
        self._ep_returns: List[float] = []
        if isinstance(env, TorchVectorEnv) and config.num_env_runners == 0:
            self.env_state, self.obs = env.reset(
                self.gen, config.num_envs_per_runner)
            self._rollout = self._make_rollout(
                config.rollout_fragment_length)
            self.runner_group = None
        else:
            from ray_tpu_torch.rl.env_runner import EnvRunnerGroup

            self.runner_group = EnvRunnerGroup(
                config.env_name, max(1, config.num_env_runners),
                config.num_envs_per_runner,
                {"obs_dim": spec.obs_dim, "num_actions": spec.num_actions,
                 "hidden": config.hidden_sizes,
                 "gamma": self.params_cfg.gamma},
                seed=config.seed)
            self.runner_group.sync_weights(self._weights())

    def _weights(self):
        return to_host(self.learner.params)

    def _make_rollout(self, num_steps: int):
        module, env, gamma = self.module, self.env, self.params_cfg.gamma

        @torch.no_grad()
        def rollout(params, env_state, obs, generator):
            keys = ("obs", "actions", "behaviour_logp", "rewards",
                    "raw_rewards", "dones")
            traj: Dict[str, list] = {k: [] for k in keys}
            for _ in range(num_steps):
                action, logp = module.sample_action(params, obs, generator)
                (env_state, next_obs, reward, terminated, truncated,
                 final_obs) = env.step(env_state, action, generator)
                v_final = module.value(params, final_obs)
                train_reward = reward + gamma * v_final * truncated
                for k, v in zip(keys, (obs, action, logp, train_reward,
                                       reward, terminated | truncated)):
                    traj[k].append(v)
                obs = next_obs
            out = {k: torch.stack(v) for k, v in traj.items()}
            out["last_value"] = module.value(params, obs)
            stats = {"reward_per_step": out.pop("raw_rewards").mean(),
                     "episodes_done": out["dones"].sum()}
            return env_state, obs, out, stats

        return rollout

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        if self.runner_group is None:
            self.env_state, self.obs, batch, stats = self._rollout(
                self.learner.params, self.env_state, self.obs, self.gen)
            metrics = self.learner.update(batch)
            n_steps = int(batch["actions"].numel())
            ep_reward = episode_reward(self, n_steps, stats)
        else:
            trajs = self.runner_group.sample(cfg.rollout_fragment_length)
            batch = self._assemble(trajs)
            metrics = self.learner.update(batch)
            self.runner_group.sync_weights(self._weights())
            n_steps = int(np.prod(batch["actions"].shape))
            self._ep_returns.extend(self.runner_group.episode_stats())
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
        # EnvRunner fragments are [T, B]-shaped already; stack over B.
        batch = {}
        for key in ("obs", "actions", "rewards", "dones"):
            batch[key] = np.concatenate([t[key] for t in trajs], axis=1)
        batch["behaviour_logp"] = np.concatenate(
            [t["logp_old"] for t in trajs], axis=1)
        batch["last_value"] = np.concatenate(
            [t["last_value"] for t in trajs], axis=0)
        return batch

    def save_checkpoint(self) -> Dict[str, Any]:
        return {"learner": self.learner.get_state(),
                "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        self.learner.set_state(state["learner"])
        self.iteration = state["iteration"]
        if self.runner_group is not None:
            self.runner_group.sync_weights(self._weights())

    def stop(self):
        if self.runner_group is not None:
            self.runner_group.stop()


class APPO(IMPALA):
    """IMPALA with a PPO-style clipped surrogate (reference:
    ``rllib/algorithms/appo/``)."""

    def __init__(self, config: AlgorithmConfig):
        if getattr(config, "impala", None) is None or (
            getattr(config, "impala", ImpalaParams()).clip_ratio is None
        ):
            config.impala = dataclasses.replace(
                getattr(config, "impala", ImpalaParams()), clip_ratio=0.3)
        super().__init__(config)
