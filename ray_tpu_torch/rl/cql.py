"""CQL: conservative Q-learning for offline RL (discrete actions).

Counterpart of ``ray_tpu/rl/cql.py`` (reference: ``rllib/algorithms/cql/``,
a SAC-based learner with the conservative regularizer).  The CQL(H)
penalty for discrete actions is exact: ``E_s[logsumexp_a Q(s,a) - Q(s,
a_data)]`` pushes down Q on out-of-distribution actions and up on dataset
actions, so the greedy policy stays inside the data's support.  Built on
the same twin-Q + double-DQN-style target as ``rl/dqn.py`` but trained
purely from a fixed batch (no environment interaction); each update is
one gradient step on the learner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.models import (Adam, as_tensors, copy_tree, grad_step,
                                     mean_metrics, mlp_apply, mlp_init,
                                     polyak, take, to_device, to_host)


def _densify(col) -> np.ndarray:
    """Data-tier batches may hand array-valued columns back as object
    arrays of per-row ndarrays; stack them into one dense array."""
    arr = np.asarray(col)
    if arr.dtype == object:
        arr = np.stack([np.asarray(x) for x in col])
    return arr


@dataclasses.dataclass(frozen=True)
class CQLParams:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005            # polyak target smoothing
    cql_alpha: float = 1.0        # conservative-penalty weight
    hidden: Tuple[int, ...] = (64, 64)


def cql_loss(params, target, batch, p: CQLParams, n_layers: int):
    """Twin-Q TD loss against the double-Q target plus the CQL(H)
    penalty, with the reference's metrics."""
    q1 = mlp_apply(params["q1"], batch["obs"], n_layers)
    q2 = mlp_apply(params["q2"], batch["obs"], n_layers)
    q1_sel = take(q1, batch["actions"])
    q2_sel = take(q2, batch["actions"])
    with torch.no_grad():
        # double-Q target: online argmax, min of targets evaluates
        next_a = torch.argmax(
            mlp_apply(params["q1"], batch["next_obs"], n_layers), 1)
        t1 = take(mlp_apply(target["q1"], batch["next_obs"], n_layers),
                  next_a)
        t2 = take(mlp_apply(target["q2"], batch["next_obs"], n_layers),
                  next_a)
        y = batch["rewards"] + p.gamma * torch.minimum(t1, t2) * (
            1.0 - batch["terminals"])
    td = ((q1_sel - y) ** 2).mean() + ((q2_sel - y) ** 2).mean()
    # CQL(H) conservative penalty, exact for discrete actions
    cql = ((torch.logsumexp(q1, 1) - q1_sel).mean()
           + (torch.logsumexp(q2, 1) - q2_sel).mean())
    total = td + p.cql_alpha * cql
    return total, {"td_loss": td, "cql_penalty": cql}


class CQL:
    """Offline Q-learning over {obs, actions, rewards, next_obs, terminals}
    batches (a ``ray_tpu_torch.data.Dataset`` of rows, a column dict or an
    iterable of row dicts); ``device`` None means the card."""

    REQUIRED = ("obs", "actions", "rewards", "next_obs", "terminals")

    def __init__(self, obs_dim: int, num_actions: int,
                 params: Optional[CQLParams] = None, seed: int = 0,
                 device=None):
        self.p = params or CQLParams()
        p = self.p
        self.device = dev = resolve_device(device)
        sizes = [obs_dim, *p.hidden, num_actions]
        self.n_layers = len(sizes) - 1
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params = {"q1": mlp_init(gen, sizes), "q2": mlp_init(gen, sizes)}
        self.target = copy_tree(self.params)
        self.tx = Adam(p.lr)
        self.opt_state = self.tx.init(self.params)
        self.iteration = 0

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        batch = as_tensors(batch, self.device)
        total, aux = cql_loss(self.params, self.target, batch, self.p,
                              self.n_layers)
        grad_step(total, self.params, self.tx, self.opt_state)
        polyak(self.target, self.params, self.p.tau)
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def act_greedy(self, params, obs) -> torch.Tensor:
        obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device) \
            if not isinstance(obs, torch.Tensor) else obs
        q = mlp_apply(params["q1"], obs, self.n_layers)
        return torch.argmax(q, 1).int()

    def train_on(self, data, *, batch_size: int = 256,
                 epochs: int = 1) -> Dict[str, float]:
        auxs = []
        for _ in range(epochs):
            for batch in self._iter_batches(data, batch_size):
                auxs.append(self._update(batch))
        self.iteration += 1
        out = {k: v for k, v in mean_metrics(auxs).items()}
        out["training_iteration"] = self.iteration
        return out

    def _iter_batches(self, data, batch_size: int):
        if hasattr(data, "iter_batches"):  # ray_tpu_torch.data.Dataset
            for b in data.iter_batches(batch_size=batch_size):
                yield self._check(b)
            return
        if isinstance(data, dict):
            self._check(data)
            n = len(data["actions"])
            for i in range(0, n, batch_size):
                yield self._check({k: np.asarray(v)[i:i + batch_size]
                                   for k, v in data.items()})
            return
        rows = list(data)
        for i in range(0, len(rows), batch_size):
            chunk = rows[i:i + batch_size]
            yield self._check({
                k: np.stack([np.asarray(r[k]) for r in chunk])
                for k in self.REQUIRED})

    def _check(self, batch):
        missing = [k for k in self.REQUIRED if k not in batch]
        if missing:
            raise ValueError(f"CQL batch missing columns {missing}; "
                             f"needs {self.REQUIRED}")
        return {k: _densify(v) for k, v in batch.items()}

    def save_checkpoint(self) -> Dict[str, Any]:
        return {"params": to_host(self.params),
                "target": to_host(self.target),
                "opt_state": to_host(self.opt_state),
                "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        self.params = to_device(state["params"], self.device,
                                requires_grad=True)
        self.target = to_device(state["target"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
