"""Pipeline parallelism over the ``pp`` mesh axis: the counterpart of
``ray_tpu/parallel/pipeline.py``.

Stacked layer params ``[L, ...]`` are sharded over ``pp``: each stage
holds ``L / S`` contiguous layers.  The microbatch schedule is the
reference's tick schedule: over ``M + S - 1`` ticks stage ``p`` runs
microbatch ``t - p`` at tick ``t``, stage 0 ingests microbatch ``t`` and
the last stage emits microbatch ``t - (S - 1)``; between ticks every stage
passes its activation one stage down the ring.  The reference's ring is a
``jnp.roll`` on a stage-sharded buffer, lowered to a collective-permute;
here it is a point-to-point pair per tick (``RingShift``) whose backward
passes the gradient one stage back, so the backward is the mirrored
schedule.  A stage skips its compute on the ticks where it holds no
microbatch (the reference computes on padding there and masks it out).

Bubble fraction is ``(S - 1) / (M + S - 1)`` for S stages and M
microbatches.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_size, compute_mesh
from ray_tpu_torch.parallel.p2p import RingShift
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, as_global,
                                             shard_layout)


def pp_size(mesh, axis: str = "pp") -> int:
    """Number of pipeline stages in the mesh (1 when no pp axis)."""
    return axis_size(compute_mesh(mesh), axis)


def pipeline_microbatches(cfg_microbatches: Optional[int], mesh,
                          axis: str = "pp") -> int:
    """Default microbatch count: 2 * stages (a bubble of ~14 % at S=4,
    against 25 % at M = S)."""
    return cfg_microbatches or 2 * pp_size(mesh, axis)


def reject_pp(mesh, family: str, rules=None):
    """Guard for model families without a pipeline apply path.

    Raises on pp > 1 meshes, and, only when the caller supplied no rule
    table of their own, replicates stacked layers over pp instead of
    stage-sharding them.  Returns the rule table to use.
    """
    if pp_size(mesh) > 1:
        raise ValueError(
            f"{family} has no pipeline (pp) apply path; use dp/fsdp/tp/sp "
            "axes (pp is llama-only for now)")
    if rules is None:
        return {**DEFAULT_RULES, "layers": None}
    return rules


class _FromLastStage(torch.autograd.Function):
    """Every stage gets the last stage's output (a sum over the stages,
    where the others contribute zeros).  The loss downstream is computed
    alike on every stage, so each stage's gradient is already the whole
    one: the backward passes it through."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _run_stages(layer_fn, remat, x, *leaves, keys, mesh, axis, M):
    """The tick schedule on this rank's local blocks: ``x`` the local rows
    ``[b, ...]``, ``leaves`` this stage's ``[L / S, ...]`` layer params."""
    S = pp_size(mesh, axis)
    p = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    nxt = dist.get_global_rank(group, (p + 1) % S)
    prv = dist.get_global_rank(group, (p - 1) % S)
    views = [t.unbind(0) for t in leaves]
    layers = [dict(zip(keys, lp)) for lp in zip(*views)]
    micro = x.chunk(M)
    # every rank's ring of shifts must be in its graph, its bubble ticks'
    # (which pass zeros) too, so each stage runs as many backward shifts
    # as its peers
    buf = torch.zeros_like(micro[0]).requires_grad_(torch.is_grad_enabled())
    outs = []
    for t in range(M + S - 1):
        if p == 0 and t < M:
            # ``0 * buf`` keeps the discarded ring input in the graph, so
            # this stage runs every tick's backward step, as its peers do
            buf = micro[t] + 0 * buf
        if 0 <= t - p < M:
            for lp in layers:
                buf = layer_fn(buf, lp) if remat is None else remat(
                    layer_fn, buf, lp)
            if p == S - 1:
                outs.append(buf)
        if t < M + S - 2:  # the last tick's rotation is read by nobody
            buf = RingShift.apply(buf, group, nxt, prv)
    y = torch.cat(outs) if p == S - 1 else torch.zeros_like(x)
    # the input and the ring's end enter every stage's output, so every
    # rank gets their (zero) grads and joins the collectives after them
    return _FromLastStage.apply(y + 0 * (buf.sum() + x.sum()), group)


def pipeline_apply(layer_fn: Callable[[torch.Tensor, Dict[str, Any]],
                                      torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   *, mesh, num_microbatches: Optional[int] = None,
                   axis: str = "pp", remat: Optional[Callable] = None
                   ) -> torch.Tensor:
    """Run ``x`` through L stacked layers pipelined over the ``axis``
    stages.

    ``layer_fn(x, layer_params) -> x`` is the per-layer body on plain
    local tensors, run as ``remat(layer_fn, x, lp)`` when ``remat`` is
    given.  ``stacked_params`` is a dict of DTensors with a leading layer
    dim L; each stage gathers its L / S layers whole (over the axes other
    than ``axis``).  ``x`` is a global-view ``[batch, ...]`` DTensor
    whose batch divides into ``num_microbatches``; it runs with its rows
    split over dp/fsdp and everything else whole, or, when a
    microbatch's rows do not split over dp/fsdp, with its rows whole on
    every rank.  Returns the activations after all L layers, a DTensor
    in that layout.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = compute_mesh(mesh)
    S = pp_size(mesh, axis)
    M = num_microbatches or S
    b = x.shape[0]
    if b % M != 0:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % S != 0:
        raise ValueError(f"{n_layers} layers not divisible by {S} stages")
    names = mesh.mesh_dim_names
    data = [n for n, s in zip(names, mesh.shape) if n in ("dp", "fsdp")
            and s > 1]
    # the reference splits the global batch into M microbatches and
    # shards each over the data axes; a microbatch whose rows do not
    # split over them runs with its rows whole on each rank of the stage
    split = (b // M) % math.prod(axis_size(mesh, n) for n in data) == 0
    x_layout = shard_layout(mesh, (("dp", "fsdp"),)) if split \
        else [Replicate()] * len(names)
    x = as_global(x, mesh)
    if list(x.placements) != x_layout:
        x = x.redistribute(mesh, x_layout)
    stage = [Shard(0) if n == axis else Replicate() for n in names]
    # each stage's layers see only its rows: their grads are partial sums
    # over the data axes, reduced when they leave the stage (with the
    # rows whole, each rank's grads are the whole ones)
    stage_grad = [Partial() if n in data and split else pl
                  for n, pl in zip(names, stage)]
    # only stage 0 reads the input: its grad is a sum over the stages
    x_grad = [Partial() if n == axis else pl
              for n, pl in zip(names, x_layout)]
    keys = list(stacked_params)
    leaves = [as_global(stacked_params[k], mesh) for k in keys]
    leaves = [t if list(t.placements) == stage
              else t.redistribute(mesh, stage) for t in leaves]

    def run(x, *leaves):
        return _run_stages(layer_fn, remat, x, *leaves, keys=keys,
                           mesh=mesh, axis=axis, M=M)

    return local_map(run, out_placements=x_layout,
                     in_placements=(x_layout,) + (stage,) * len(leaves),
                     in_grad_placements=(x_grad,)
                     + (stage_grad,) * len(leaves),
                     device_mesh=mesh)(x, *leaves)
