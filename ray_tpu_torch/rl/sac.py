"""SAC (discrete-action): twin soft Q-networks + entropy-tuned policy.

Counterpart of ``ray_tpu/rl/sac.py`` (reference: ``rllib/algorithms/sac/``).
Discrete variant (Christodoulou 2019): the categorical policy gives exact
expectations over actions, so no reparameterization trick is needed — the
soft targets are ``E_pi[min(Q1,Q2) - alpha*log pi]`` computed in closed
form.  Acting, the twin-Q/policy/temperature update and the Polyak target
sync run on the learner's device; the replay ring buffer is host numpy
(same host/device split as ``rl/dqn.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.dqn import ReplayBuffer
from ray_tpu_torch.rl.env import TorchVectorEnv, make_env
from ray_tpu_torch.rl.models import (Adam, as_tensors, categorical,
                                     copy_tree, grad_step, mean_metrics,
                                     mlp_apply, mlp_init, polyak, take,
                                     to_device, to_host)


@dataclasses.dataclass(frozen=True)
class SACParams:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005              # polyak target smoothing
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    update_every: int = 4           # env steps per gradient update
    target_entropy_scale: float = 0.7  # target H = scale * log(n_actions)
    hidden: Tuple[int, ...] = (64, 64)


class SACConfig:
    """Builder mirroring AlgorithmConfig's surface for the SAC family;
    ``device`` None means the card."""

    def __init__(self, device=None):
        self.env_name: Optional[str] = None
        self.num_envs = 8
        self.params = SACParams()
        self.seed = 0
        self.device = device

    def environment(self, env: str) -> "SACConfig":
        self.env_name = env
        return self

    def env_runners(self, num_envs_per_env_runner: int = 8) -> "SACConfig":
        self.num_envs = num_envs_per_env_runner
        return self

    def training(self, **kw) -> "SACConfig":
        self.params = dataclasses.replace(self.params, **kw)
        return self

    def seed_(self, seed: int) -> "SACConfig":
        self.seed = seed
        return self

    def device_(self, device) -> "SACConfig":
        self.device = device
        return self

    def build(self) -> "SAC":
        return SAC(self)


def pi_dist(params, obs, n_layers: int):
    logp = torch.log_softmax(mlp_apply(params["pi"], obs, n_layers), -1)
    return torch.exp(logp), logp


def sac_loss(params, target, batch, gamma: float, target_entropy: float,
             n_layers: int):
    """The twin-Q TD loss against the soft target, the policy loss under
    the current Qs and the temperature loss toward the entropy target,
    summed; with the reference's metrics."""
    alpha = torch.exp(params["log_alpha"]).detach()
    with torch.no_grad():
        # E_pi[min(Q1t,Q2t) - alpha log pi], exact over actions
        probs_n, logp_n = pi_dist(params, batch["next_obs"], n_layers)
        qmin_n = torch.minimum(
            mlp_apply(target["q1"], batch["next_obs"], n_layers),
            mlp_apply(target["q2"], batch["next_obs"], n_layers))
        v_next = torch.sum(probs_n * (qmin_n - alpha * logp_n), -1)
        y = batch["rewards"] + gamma * v_next * (1.0 - batch["terminals"])
    q1a = mlp_apply(params["q1"], batch["obs"], n_layers)
    q2a = mlp_apply(params["q2"], batch["obs"], n_layers)
    q1 = take(q1a, batch["actions"])
    q2 = take(q2a, batch["actions"])
    q_loss = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()
    # policy loss: maximize soft value under current Qs
    probs, logp = pi_dist(params, batch["obs"], n_layers)
    qmin = torch.minimum(q1a, q2a).detach()
    pi_loss = torch.sum(probs * (alpha * logp - qmin), -1).mean()
    # temperature loss toward the entropy target
    entropy = -torch.sum(probs * logp, -1).mean()
    alpha_loss = params["log_alpha"] * (entropy - target_entropy).detach()
    return q_loss + pi_loss + alpha_loss, {
        "q_loss": q_loss, "pi_loss": pi_loss, "entropy": entropy,
        "alpha": alpha}


class SAC:
    def __init__(self, config: SACConfig):
        self.config = config
        p = config.params
        env = make_env(config.env_name)
        if not isinstance(env, TorchVectorEnv):
            raise TypeError("SAC here drives torch envs; wrap gym envs via "
                            "register_env with a TorchVectorEnv")
        self.env = env
        spec = env.spec
        self.device = dev = resolve_device(config.device)
        n_actions = spec.num_actions
        sizes = [spec.obs_dim, *p.hidden, n_actions]
        self.n_layers = len(sizes) - 1
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        self.params = {
            "pi": mlp_init(gen, sizes),
            "q1": mlp_init(gen, sizes),
            "q2": mlp_init(gen, sizes),
            # log temperature, auto-tuned toward the entropy target
            "log_alpha": torch.zeros((), device=dev, requires_grad=True),
        }
        self.target = {"q1": copy_tree(self.params["q1"]),
                       "q2": copy_tree(self.params["q2"])}
        self.tx = Adam(p.lr)
        self.opt_state = self.tx.init(self.params)
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
        self._ep_returns = np.zeros(config.num_envs)
        self._completed: List[float] = []
        self.target_entropy = p.target_entropy_scale * float(
            np.log(n_actions))

    @torch.no_grad()
    def _act(self, params, obs) -> torch.Tensor:
        _, logp = pi_dist(params, obs, self.n_layers)
        return categorical(logp, self.gen).int()

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """One step of the summed loss on ``batch``, then the Polyak
        target sync; the metrics as device scalars."""
        p = self.config.params
        batch = as_tensors(batch, self.device)
        total, aux = sac_loss(self.params, self.target, batch, p.gamma,
                              self.target_entropy, self.n_layers)
        grad_step(total, self.params, self.tx, self.opt_state)
        polyak(self.target, {"q1": self.params["q1"],
                             "q2": self.params["q2"]}, p.tau)
        return {k: v.detach() for k, v in aux.items()}

    def train(self, steps_per_iteration: int = 512) -> Dict[str, Any]:
        p = self.config.params
        aux_hist: List[Dict[str, torch.Tensor]] = []
        n_env = self.config.num_envs
        for _ in range(steps_per_iteration // n_env):
            actions = self._act(self.params, self.obs)
            (self.env_state, next_obs, reward, terminated, truncated,
             final_obs) = self.env.step(self.env_state, actions, self.gen)
            host = to_host({"obs": self.obs, "actions": actions,
                            "reward": reward, "final_obs": final_obs,
                            "terminated": terminated,
                            "done": terminated | truncated})
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
                if self._update_base is None:
                    self._update_base = self.total_steps // p.update_every
                due = ((self.total_steps // p.update_every)
                       - self._update_base - self.updates)
                for _ in range(max(0, due)):
                    aux_hist.append(self._update(self.buffer.sample(
                        p.train_batch_size, self.rng)))
                    self.updates += 1
        recent = self._completed[-50:]
        self.iteration += 1
        out = {
            "training_iteration": self.iteration,
            "total_env_steps": self.total_steps,
            "num_updates": self.updates,
            "episode_reward_mean": (float(np.mean(recent)) if recent
                                    else float("nan")),
        }
        out.update(mean_metrics(aux_hist))
        return out

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"params": to_host(self.params),
                "target": to_host(self.target),
                "opt_state": to_host(self.opt_state),
                "total_steps": self.total_steps,
                "updates": self.updates, "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        self.params = to_device(state["params"], self.device,
                                requires_grad=True)
        self.target = to_device(state["target"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.total_steps = state["total_steps"]
        self.updates = state["updates"]
        self.iteration = state["iteration"]
        p = self.config.params
        self._update_base = (self.total_steps // p.update_every
                             - self.updates)

    def stop(self):
        pass
