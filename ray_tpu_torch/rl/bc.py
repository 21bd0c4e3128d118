"""Offline RL: MARWIL (advantage-weighted imitation) and BC (beta=0).

Counterpart of ``ray_tpu/rl/bc.py`` (reference:
``rllib/algorithms/marwil/`` and ``rllib/algorithms/bc/`` — in the
reference BC literally subclasses MARWIL with beta=0; the same
relationship holds here).  Offline batches come from the port's data tier
(a ``ray_tpu_torch.data.Dataset`` of {obs, actions[, returns]} rows),
row dicts or plain numpy arrays; each update is one gradient step on the
learner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.models import (Adam, as_tensors, grad_step,
                                     mean_metrics, mlp_apply, mlp_init, take,
                                     to_device, to_host)


@dataclasses.dataclass(frozen=True)
class MARWILParams:
    lr: float = 1e-3
    # beta=0 -> plain behavior cloning; beta>0 weights the log-likelihood
    # by exp(beta * normalized advantage) so better-than-average actions
    # are imitated harder.
    beta: float = 1.0
    vf_coef: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)


def marwil_loss(params, batch, p: MARWILParams, n_layers: int):
    logits = mlp_apply(params["pi"], batch["obs"], n_layers)
    logp = take(torch.log_softmax(logits, -1), batch["actions"])
    if p.beta == 0.0:
        pi_loss = -logp.mean()
        vf_loss = torch.zeros((), device=logp.device)
    else:
        values = mlp_apply(params["vf"], batch["obs"], n_layers)[:, 0]
        adv = batch["returns"] - values
        vf_loss = (adv ** 2).mean()
        # moving-free normalization: batch std, dividing by n as jnp's
        # (reference keeps a running MA of the squared advantage norm)
        adv_n = adv / (torch.std(adv.detach(), correction=0) + 1e-8)
        w = torch.exp(torch.clamp(p.beta * adv_n.detach(), -10.0, 10.0))
        pi_loss = -(w * logp).mean()
    total = pi_loss + p.vf_coef * vf_loss
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss}


class MARWIL:
    """``device`` None means the card."""

    def __init__(self, obs_dim: int, num_actions: int,
                 params: Optional[MARWILParams] = None, seed: int = 0,
                 device=None):
        self.p = params or MARWILParams()
        p = self.p
        self.device = dev = resolve_device(device)
        pi_sizes = [obs_dim, *p.hidden, num_actions]
        vf_sizes = [obs_dim, *p.hidden, 1]
        self.n_layers = len(pi_sizes) - 1
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params = {"pi": mlp_init(gen, pi_sizes),
                       "vf": mlp_init(gen, vf_sizes)}
        self.tx = Adam(p.lr)
        self.opt_state = self.tx.init(self.params)
        self.iteration = 0

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        batch = as_tensors(batch, self.device)
        total, aux = marwil_loss(self.params, batch, self.p, self.n_layers)
        # BC's loss does not reach the value tower: its grads are zero,
        # and Adam's zero step leaves it as it is
        grad_step(total, self.params, self.tx, self.opt_state)
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def act_greedy(self, params, obs) -> torch.Tensor:
        obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device) \
            if not isinstance(obs, torch.Tensor) else obs
        logits = mlp_apply(params["pi"], obs, self.n_layers)
        return torch.argmax(logits, -1).int()

    def _to_batch(self, rows) -> Dict[str, np.ndarray]:
        if isinstance(rows, dict):
            from ray_tpu_torch.rl.cql import _densify

            batch = {k: _densify(v) for k, v in rows.items()}
        else:
            batch = {
                "obs": np.stack([np.asarray(r["obs"], np.float32)
                                 for r in rows]),
                "actions": np.asarray([r["actions"] for r in rows],
                                      np.int32),
            }
            if rows and "returns" in rows[0]:
                batch["returns"] = np.asarray(
                    [r["returns"] for r in rows], np.float32)
        if self.p.beta != 0.0 and "returns" not in batch:
            raise ValueError("MARWIL (beta>0) needs 'returns' in the data; "
                             "use beta=0 (BC) for (obs, actions)-only data")
        return batch

    def train_on(self, data, *, batch_size: int = 256,
                 epochs: int = 1) -> Dict[str, float]:
        """``data``: a ray_tpu_torch.data.Dataset of rows, an iterable of
        row dicts, or a column dict of arrays."""
        auxs = []
        for _ in range(epochs):
            for batch in self._iter_batches(data, batch_size):
                auxs.append(self._update(batch))
        self.iteration += 1
        out = mean_metrics(auxs)
        out["training_iteration"] = self.iteration
        return out

    def _iter_batches(self, data, batch_size: int):
        if hasattr(data, "iter_batches"):  # ray_tpu_torch.data.Dataset
            for b in data.iter_batches(batch_size=batch_size):
                yield self._to_batch(b)
            return
        if isinstance(data, dict):
            n = len(data["actions"])
            for i in range(0, n, batch_size):
                yield self._to_batch(
                    {k: np.asarray(v)[i:i + batch_size]
                     for k, v in data.items()})
            return
        rows = list(data)
        for i in range(0, len(rows), batch_size):
            yield self._to_batch(rows[i:i + batch_size])

    def save_checkpoint(self) -> Dict[str, Any]:
        return {"params": to_host(self.params),
                "opt_state": to_host(self.opt_state),
                "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        self.params = to_device(state["params"], self.device,
                                requires_grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]


class BC(MARWIL):
    """Behavior cloning = MARWIL with beta=0 (as in the reference)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 params: Optional[MARWILParams] = None, seed: int = 0,
                 device=None):
        params = dataclasses.replace(params or MARWILParams(), beta=0.0)
        super().__init__(obs_dim, num_actions, params, seed, device)
