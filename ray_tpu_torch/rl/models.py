"""RL policy/value networks over plain parameter dicts, and the optimizer
the RL learners share.

Counterpart of ``ray_tpu/rl/models.py`` (RLlib's ``RLModule``,
``core/rl_module/rl_module.py:260``): a module is (init, apply) over a
nested dict of leaf tensors, keyed as the reference's pytree
(``{"pi": {"w0", "b0", ...}, "vf": ...}``, ``w{i}`` shaped ``[din,
dout]``, the product ``x @ w + b``), so a converted JAX tree maps key for
key (``rl/convert.py``).  Parameters are leaf tensors with
``requires_grad``; a learner takes their grads with
``torch.autograd.grad`` and updates them in place (``Adam``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# optax.adam's defaults (eps_root 0)
B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict (or list), in insertion order: params,
    grads and optimizer moments built alike line up."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nested dict, list or tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_host(tree):
    """A nested dict of tensors as numpy arrays (the counterpart of
    ``jax.device_get``); other leaves pass through."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def to_device(tree, device, requires_grad: bool = False):
    """A nested dict of arrays or tensors as fresh fp32/int tensors on
    ``device`` (floating leaves ``requires_grad`` when asked)."""
    def one(x):
        if not isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
            return x
        t = (x.detach() if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x))).to(device).clone()
        if t.is_floating_point():
            t = t.float().requires_grad_(requires_grad)
        return t
    return tree_map(one, tree)


def detached(tree):
    """The tree's tensors detached (no graph is recorded through them)."""
    return tree_map(lambda t: t.detach(), tree)


def mlp_init(generator: torch.Generator, sizes: Sequence[int]
             ) -> Dict[str, torch.Tensor]:
    """He-normal weights and zero biases, drawn from ``generator`` on its
    device, as leaf tensors that require grad."""
    dev = generator.device
    params = {}
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((din, dout), generator=generator, device=dev)
        params[f"w{i}"] = (w * float(np.sqrt(2.0 / din))).requires_grad_()
        params[f"b{i}"] = torch.zeros((dout,), device=dev,
                                      requires_grad=True)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise as ``jax.random.gumbel`` draws it:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator]
                = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A sample of the last axis's categorical, as
    ``jax.random.categorical``: ``argmax(logits + Gumbel noise)``.  The
    noise is drawn from ``generator`` unless given (``noise``, the
    shape of ``logits``)."""
    if noise is None:
        noise = gumbel(logits.shape, generator)
    return torch.argmax(logits + noise, dim=-1)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in fp32: an index outside ``[0, n)``
    (``-1``) is a row of zeros, where ``F.one_hot`` raises."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(values, idx[..., None], -1)[..., 0]``."""
    return values.gather(-1, idx.long()[..., None])[..., 0]


def global_norm_clip(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm(max_norm)`` in place: ``g`` as it is
    where the global norm is below ``max_norm``, else ``g / norm *
    max_norm`` (``clip_grad_norm_`` would add 1e-6 to the norm)."""
    from ray_tpu_torch.models.training import global_norm

    norm = global_norm(grads)
    keep = norm < max_norm
    div = torch.where(keep, 1.0, norm)
    mul = torch.where(keep, 1.0, max_norm)
    for g in grads:
        g.div_(div).mul_(mul)


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), after
    ``optax.clip_by_global_norm(max_grad_norm)`` when that is given.  Its
    state is ``{"count", "mu", "nu"}`` with the moments shaped as the
    params' tree; each leaf of the tree is one parameter (SAC's scalar
    ``log_alpha`` too)."""

    def __init__(self, lr: float, max_grad_norm: Optional[float] = None):
        self.lr = lr
        self.max_grad_norm = max_grad_norm

    def init(self, params) -> Dict[str, Any]:
        def zeros(t):
            return torch.zeros_like(t, requires_grad=False)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, params, grads: List[torch.Tensor],
               state: Dict[str, Any]) -> None:
        """One step in place on the leaves of ``params`` (``grads`` in the
        same order, clipped where they lie) and on ``state``."""
        if self.max_grad_norm is not None:
            global_norm_clip(grads, self.max_grad_norm)
        count = state["count"] + 1
        bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
        for p, g, m, v in zip(tree_leaves(params), grads,
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (m / bc1) / ((v / bc2).sqrt_().add_(EPS))
            p.add_(u, alpha=-self.lr)
        state["count"] = count


def grad_step(loss: torch.Tensor, params, tx: Adam,
              opt_state: Dict[str, Any]) -> None:
    """The grads of ``loss`` w.r.t. every leaf of ``params`` (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives), then one ``tx``
    step on them."""
    leaves = tree_leaves(params)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    tx.update(params, grads, opt_state)


@torch.no_grad()
def polyak(target, online, tau: float) -> None:
    """``target = (1 - tau) * target + tau * online`` in place, leaf by
    leaf."""
    for t, o in zip(tree_leaves(target), tree_leaves(online)):
        t.mul_(1 - tau).add_(o, alpha=tau)


def copy_tree(tree):
    """Detached copies of the tree's tensors (``jax.tree.map(jnp.copy)``)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def mean_metrics(auxs: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over ``auxs``, read with one host sync."""
    if not auxs:
        return {}
    keys = list(auxs[0])
    stacked = torch.stack([torch.stack([a[k].detach().float()
                                        for k in keys]) for a in auxs])
    return dict(zip(keys, stacked.mean(0).tolist()))


def as_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of arrays or tensors on ``device``: floats as fp32,
    integers as they are, booleans as they are."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
            v = torch.from_numpy(v if v.flags.writeable else v.copy())
        out[k] = (v.float() if v.is_floating_point() else v).to(device)
    return out


class ActorCriticModule:
    """Separate policy and value MLP towers (RLlib's default PPO module)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.pi_sizes = [obs_dim, *hidden, num_actions]
        self.vf_sizes = [obs_dim, *hidden, 1]

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        return {"pi": mlp_init(generator, self.pi_sizes),
                "vf": mlp_init(generator, self.vf_sizes)}

    def logits(self, params, obs) -> torch.Tensor:
        return mlp_apply(params["pi"], obs, len(self.pi_sizes) - 1)

    def value(self, params, obs) -> torch.Tensor:
        return mlp_apply(params["vf"], obs, len(self.vf_sizes) - 1)[..., 0]

    def forward(self, params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.logits(params, obs), self.value(params, obs)

    def sample_action(self, params, obs, generator=None, noise=None):
        logits = self.logits(params, obs)
        action = categorical(logits, generator, noise)
        logp = torch.log_softmax(logits, -1)
        return action, take(logp, action)
