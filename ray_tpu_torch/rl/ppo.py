"""PPO learner: GAE + clipped surrogate, on one device.

Counterpart of ``ray_tpu/rl/ppo.py`` (reference: ``rllib/algorithms/ppo/``,
``ppo_torch_learner.py``, and ``core/learner/learner.py:107``).  The
reference's rollout and update are each one jitted program; here they are
loops of tensor ops on the learner's device: GAE is a reverse loop over
the fragment's T steps, the update a loop of ``num_epochs x
num_minibatches`` gradient steps, and neither reads a value back to the
host inside its loop.

Truncation handling: a time-limit cut bootstraps the return from the value
of the pre-reset final observation (folded into the reward:
``r += gamma * V(final_obs)``), while true termination bootstraps 0 — the
standard partial-episode bootstrapping fix the reference also applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.models import (ActorCriticModule, Adam, as_tensors,
                                     grad_step, mean_metrics, take, to_device,
                                     to_host)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    num_epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5


@torch.no_grad()
def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """Generalized advantage estimation by a reverse loop over T (the
    reference's reverse ``lax.scan``).

    rewards/values/dones: [T, B]; last_value: [B].
    """
    dones = dones.float()
    advs = torch.empty_like(values)
    gae, next_value = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        advs[t] = gae
        next_value = values[t]
    return advs, advs + values


class PPOLearner:
    """Holds params + (clip + adam) state on one device; ``update()`` runs
    the minibatch epochs there and reads the metrics back once."""

    def __init__(self, module: ActorCriticModule, config: PPOConfig,
                 seed: int = 0, device=None):
        self.module = module
        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = module.init(gen)
        self.tx = Adam(config.lr, config.max_grad_norm)
        self.opt_state = self.tx.init(self.params)
        self.step_count = 0

    def _loss(self, params, batch):
        c = self.config
        logits, values = self.module.forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = take(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        # jnp's std divides by n
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - c.clip_eps, 1 + c.clip_eps) * adv
        pi_loss = -torch.minimum(unclipped, clipped).mean()
        vf_loss = torch.mean((values - batch["returns"]) ** 2)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, -1).mean()
        total = pi_loss + c.vf_coef * vf_loss - c.entropy_coef * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "approx_kl": (batch["logp_old"] - logp).mean()}

    def _update_with_perms(self, batch: Dict[str, Any],
                           perms: Sequence[torch.Tensor]) -> Dict[str, float]:
        """``num_epochs`` passes, one per permutation of the batch's rows
        in ``perms``, each of ``num_minibatches`` gradient steps over
        consecutive slices of its permutation; the metrics' mean over
        every step."""
        c = self.config
        batch = as_tensors(batch, self.device)
        n = batch["obs"].shape[0]
        mb = n // c.num_minibatches
        auxs: List[Dict[str, torch.Tensor]] = []
        for perm in perms:
            perm = torch.as_tensor(perm).to(self.device)
            for i in range(c.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                mb_batch = {k: v[idx] for k, v in batch.items()}
                total, aux = self._loss(self.params, mb_batch)
                grad_step(total, self.params, self.tx, self.opt_state)
                self.step_count += 1
                auxs.append(aux)
        return mean_metrics(auxs)

    def update(self, batch: Dict[str, Any],
               generator: torch.Generator) -> Dict[str, float]:
        n = len(batch["obs"])
        perms = [torch.randperm(n, generator=generator,
                                device=generator.device)
                 for _ in range(self.config.num_epochs)]
        return self._update_with_perms(batch, perms)

    def get_weights(self):
        return to_host(self.params)

    def set_weights(self, params):
        self.params = to_device(params, self.device, requires_grad=True)

    def get_state(self) -> Dict[str, Any]:
        """Full training state (params + optimizer moments + step)."""
        return {"params": to_host(self.params),
                "opt_state": to_host(self.opt_state),
                "step_count": self.step_count}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device,
                                requires_grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.step_count = state["step_count"]


def make_rollout_fn(module: ActorCriticModule, env, num_steps: int,
                    config: PPOConfig):
    """Rollout for a TorchVectorEnv: ``num_steps`` env steps on the env's
    device collect the whole trajectory batch AND its GAE targets, with
    no read back to the host."""

    @torch.no_grad()
    def rollout(params, env_state, obs, generator):
        keys = ("obs", "actions", "logp_old", "rewards", "raw_rewards",
                "dones", "values")
        traj: Dict[str, list] = {k: [] for k in keys}
        for _ in range(num_steps):
            action, logp = module.sample_action(params, obs, generator)
            value = module.value(params, obs)
            (env_state, next_obs, reward, terminated, truncated,
             final_obs) = env.step(env_state, action, generator)
            # time-limit bootstrap: fold V(final_obs) into the TRAINING
            # reward at truncations, then treat them as terminal for GAE;
            # the raw env reward is kept separately for progress metrics
            v_final = module.value(params, final_obs)
            train_reward = reward + config.gamma * v_final * truncated
            for k, v in zip(keys, (obs, action, logp, train_reward, reward,
                                   terminated | truncated, value)):
                traj[k].append(v)
            obs = next_obs
        t = {k: torch.stack(v) for k, v in traj.items()}
        last_value = module.value(params, obs)
        advs, returns = compute_gae(
            t["rewards"], t["values"], t["dones"], last_value,
            config.gamma, config.gae_lambda)
        flat = {
            "obs": t["obs"].reshape(-1, t["obs"].shape[-1]),
            "actions": t["actions"].reshape(-1),
            "logp_old": t["logp_old"].reshape(-1),
            "advantages": advs.reshape(-1),
            "returns": returns.reshape(-1),
        }
        stats = {"reward_per_step": t["raw_rewards"].mean(),
                 "episodes_done": t["dones"].sum()}
        return env_state, obs, flat, stats

    return rollout
