"""The train step: optimizer, trainer, make_llama_trainer.

Counterpart of ``ray_tpu/models/training.py``.  ``default_optimizer`` is
optax's chain as JAX builds it: ``clip_by_global_norm``, then ``adamw``
(decay on every leaf) under ``warmup_cosine_decay_schedule``.  ``Trainer``
stands in for ``ShardedTrainer``: the step runs the loss and its backward
per microbatch (``accum_steps``), then updates params and optimizer state
leaf by leaf in place, where JAX donates the state buffers.  Under a mesh
the params and both AdamW moments are DTensors placed by the model's spec
tree (``shard_tree``), the grads are reduced to the params' placements,
the update runs on each rank's local shards and the clip's global norm
is taken over all shards.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.local import to_local, tree_map

# adamw's constants in ``default_optimizer`` (optax's eps, eps_root = 0)
B1, B2, EPS = 0.9, 0.95, 1e-8


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (or list) of tensors, in insertion
    order: params and optimizer moments built alike line up."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, fp32, as a device scalar.
    DTensors are counted over all their shards: each rank sums the squares
    of its local shard divided by the number of ranks that hold the same
    shard (the product of the replicated mesh dims), and one all-reduce
    over the world adds them up."""
    from torch.distributed.tensor import DTensor, Replicate

    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]))
    squares = []
    for t in tensors:
        sq = torch.linalg.vector_norm(to_local(t), dtype=torch.float32) ** 2
        if isinstance(t, DTensor):
            sq = sq / math.prod(n for n, p in zip(t.device_mesh.shape,
                                                  t.placements)
                                if isinstance(p, Replicate))
        squares.append(sq)
    total = torch.stack(squares).sum()
    dist.all_reduce(total)
    return total.sqrt()


def warmup_cosine_decay(count: int, peak: float, warmup: int,
                        decay_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``
    at ``count``: linear from 0 to ``peak`` over ``warmup`` steps, then
    cosine to 0 at ``decay_steps``."""
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay_steps - warmup)
    return peak * 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW under a warmup-cosine schedule, as
    ``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, B1, B2,
    EPS, weight_decay))``.  The learning rate is the schedule at the count
    before the step (so the first step runs at 0)."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    decay_steps: int = 10000
    grad_clip: float = 1.0

    def learning_rate(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup,
                                   self.decay_steps)

    def init(self, params) -> Dict[str, Any]:
        zeros = functools.partial(tree_map, torch.zeros_like)
        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: List[torch.Tensor]) -> torch.Tensor:
        """One step, in place on ``params``, ``state`` and ``grads`` (the
        grads are clipped where they lie; DTensors on their local shards,
        with grads placed as their params).  Returns the global grad norm
        before clipping, as a device scalar (no host sync)."""
        norm = global_norm(grads)
        # optax: g if norm < clip else (g / norm) * clip
        keep = norm < self.grad_clip
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, self.grad_clip)
        count = state["count"]
        lr = self.learning_rate(count)
        bc1 = 1 - B1 ** (count + 1)
        bc2 = 1 - B2 ** (count + 1)
        for leaf in zip(params, grads, tree_leaves(state["mu"]),
                        tree_leaves(state["nu"])):
            p, g, m, v = map(to_local, leaf)
            g.div_(div).mul_(mul)
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = torch.div(m, bc1)
            u.div_(v.div(bc2).sqrt_().add_(EPS))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count + 1
        return norm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, decay_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, warmup=warmup,
                 decay_steps=max(decay_steps, warmup + 1),
                 grad_clip=grad_clip)


class Trainer:
    """The port's ``ShardedTrainer``, on one device or on a mesh.

    ``init_fn(seed, device) -> params`` and ``loss_fn(params, batch) ->
    scalar``.  ``step(state, batch)`` takes the full batch, splits it into
    ``accum_steps`` microbatches along dim 0, sums their grads, averages,
    and applies one optimizer update in place.  It returns the same state
    and ``{"loss", "grad_norm"}`` as device scalars.

    ``mesh`` (a ``DeviceMesh`` of ``parallel.create_mesh``) needs
    ``param_specs``, the model's logical-axis spec tree, placed by
    ``rules`` (None = ``DEFAULT_RULES``); the device is then this rank's
    card (or the CPU for a gloo mesh).
    """

    def __init__(self, init_fn: Callable[[int, torch.device], Any],
                 loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                                   torch.Tensor], *,
                 optimizer: Optional[AdamW] = None, accum_steps: int = 1,
                 device=None, mesh=None, param_specs=None, rules=None):
        from ray_tpu_torch.parallel.mesh import compute_mesh

        mesh = compute_mesh(mesh)
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if param_specs is None:
                raise ValueError("a Trainer on a mesh needs param_specs")
            if mesh.size() != dist.get_world_size():
                raise ValueError(f"the mesh holds {mesh.size()} of "
                                 f"{dist.get_world_size()} ranks")
            self.device = (torch.device("cuda", torch.cuda.current_device())
                           if mesh.device_type == "cuda"
                           else torch.device(mesh.device_type))
            if device is not None and torch.device(device).type != \
                    self.device.type:
                raise ValueError(f"device {device} on a "
                                 f"{mesh.device_type} mesh")
        self.mesh = mesh
        self.param_specs = param_specs
        self.rules = rules
        self.optimizer = optimizer or default_optimizer()
        self.accum_steps = max(1, int(accum_steps))
        self._init_fn = init_fn
        self._loss_fn = loss_fn

    def init_state(self, seed: int = 0, params=None) -> Dict[str, Any]:
        """Fresh params from ``init_fn(seed)``, or the given ``params``
        (converted weights, say) moved to the trainer's device; under a
        mesh placed by the spec tree (``shard_tree``: every rank builds
        or holds them whole, then keeps its shards) unless they are
        DTensors placed already (``train.shard_params``); zero moments;
        step 0."""
        from torch.distributed.tensor import DTensor

        placed = params is not None and all(
            isinstance(t, DTensor) for t in tree_leaves(params))
        if params is None:
            params = self._init_fn(seed, self.device)
        elif placed and self.mesh is None:
            raise ValueError("DTensor params for a Trainer with no mesh")
        elif not placed:
            params = tree_map(lambda t: t.to(self.device), params)
        if self.mesh is not None and not placed:
            from ray_tpu_torch.parallel.sharding import shard_tree

            params = shard_tree(params, self.param_specs, self.mesh,
                                self.rules)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def shard_batch(self, batch: Dict[str, torch.Tensor], *,
                    local_rows: bool = False) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device; under a mesh as DTensors
        with rows over the rule table's "batch" axes.  By default every
        rank passes the same global batch and keeps its rows (no
        communication); ``local_rows=True`` takes each rank's own rows,
        which make the global batch in the order of the data shards
        (ranks that share a shard pass the same rows)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.sharding import (distribute,
                                                     logical_to_placements)

        placements = logical_to_placements(("batch",), self.rules,
                                           mesh=self.mesh)
        out = {}
        for k, v in batch.items():
            if isinstance(v, DTensor):
                out[k] = v
            elif local_rows:
                out[k] = DTensor.from_local(v, self.mesh, placements,
                                            run_check=False)
            else:
                out[k] = distribute(v, self.mesh, placements)
        return out

    def _microbatches(self, batch):
        a = self.accum_steps
        if a == 1:
            return [batch]
        for x in batch.values():
            if x.dim() == 0 or x.shape[0] % a:
                raise ValueError(
                    f"batch leaf shape {tuple(x.shape)} is not divisible "
                    f"into accum_steps={a} microbatches (every leaf needs a "
                    "leading batch dim that is a multiple of accum_steps)")
        if self.mesh is not None:
            # microbatch i is rows [i b / a, (i + 1) b / a) of the global
            # batch, as the reference's: gathered (token ids, small) and
            # sharded again per microbatch
            batch = {k: v.full_tensor() for k, v in batch.items()}
            return [self.shard_batch({k: v.chunk(a)[i]
                                      for k, v in batch.items()})
                    for i in range(a)]
        return [{k: v.chunk(a)[i] for k, v in batch.items()}
                for i in range(a)]

    def _grads(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each param's grad (zeros where it has none), under a mesh
        reduced to the param's placements (a grad computed from a rank's
        rows is a partial sum over the data axes)."""
        grads = []
        for p in leaves:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if self.mesh is not None and g.placements != p.placements:
                g = g.redistribute(self.mesh, p.placements)
            grads.append(g)
        return grads

    def step(self, state, batch) -> Tuple[Dict[str, Any],
                                          Dict[str, torch.Tensor]]:
        leaves = tree_leaves(state["params"])
        for p in leaves:
            p.grad = None
        batch = self.shard_batch(batch)
        loss = torch.zeros((), device=self.device)
        for mb in self._microbatches(batch):
            mb_loss = self._loss_fn(state["params"], mb)
            mb_loss.backward()
            loss += to_local(mb_loss.detach())
        grads = self._grads(leaves)
        if self.accum_steps > 1:
            loss /= self.accum_steps
            for g in grads:
                g.div_(self.accum_steps)
        grad_norm = self.optimizer.update(grads, state["opt_state"], leaves)
        for p in leaves:
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm}


def make_llama_trainer(cfg, mesh=None, *, optimizer: Optional[AdamW] = None,
                       rules=None, accum_steps: int = 1,
                       device=None) -> Trainer:
    """A ``Trainer`` for ``ray_tpu_torch.models.llama``, on ``mesh`` when
    given (params placed by ``llama_param_specs`` through ``rules``, the
    loss constrained through the same table).  Raises at once for an
    unknown remat policy."""
    from ray_tpu_torch.models.llama import (layer_remat, llama_init,
                                            llama_loss, llama_param_specs)

    layer_remat(cfg)
    return Trainer(lambda seed, dev: llama_init(cfg, seed, device=dev),
                   functools.partial(llama_loss, cfg=cfg, mesh=mesh,
                                     rules=rules),
                   optimizer=optimizer, accum_steps=accum_steps,
                   device=device, mesh=mesh,
                   param_specs=llama_param_specs(cfg), rules=rules)
