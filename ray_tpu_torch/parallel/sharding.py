"""Logical-axis → mesh-axis sharding rules as DTensor placements: the
counterpart of ``ray_tpu/parallel/sharding.py``.

Model code names the axes of its arrays by *logical* names ("batch",
"embed", "mlp", "heads", "seq", "vocab"); a rule table maps those to mesh
axes, and switching strategy is switching the table, not the model.  Where
the reference turns a spec into a ``PartitionSpec`` for GSPMD, the port
turns it into one DTensor placement per mesh dim (``Shard(tensor_dim)`` or
``Replicate()``): params become DTensors through ``distribute_tensor``
(``shard_tree``) and each activation constraint is a ``redistribute``
(``with_logical_constraint``), the identity without a mesh.

Two differences of representation, neither of layout:
- A mesh axis of size 1 shards nothing: it gets ``Replicate()``, and the
  DTensors live on ``compute_mesh(mesh)``, which leaves such axes out.
  JAX's spec naming the axis is the same layout.
- DTensor splits a tensor dim sharded over several mesh axes in the
  mesh's order, so a rule's tuple of axes must name them in that order
  (``("dp", "fsdp")``, as the reference's major-to-minor order).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import compute_mesh

#: A/B switch of the reference's multichip bench: ``1`` restores the
#: legacy constraint set (no gather-operand constraints in the embedding
#: lookup).  Read at each call.
ENV_LEGACY_SHARDING = "RAY_TPU_LEGACY_SHARDING"


def legacy_sharding_enabled() -> bool:
    """True when the legacy constraint set is requested via
    :data:`ENV_LEGACY_SHARDING`."""
    return os.environ.get(ENV_LEGACY_SHARDING, "").strip().lower() in (
        "1", "true", "yes")


# A logical axis maps to one mesh axis, a tuple of mesh axes, or None
# (replicated).
LogicalAxisRules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rules: batch over (dp, fsdp); weights sharded over fsdp on their
# largest dim and over tp Megatron-style; sequence over sp for ring
# attention.  Every logical axis a spec tree of ``models/`` uses appears
# here: an explicit None records a deliberate replication.
DEFAULT_RULES: LogicalAxisRules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "qkv": None,
    "head_dim": None,
    "vocab": "tp",
    "expert": "tp",
    "layers": "pp",
    # norm scales / biases: O(hidden) vectors, replicated
    "norm": None,
}

# Rules for inference-style TP-only sharding (no fsdp axis in use).
TP_INFERENCE_RULES: LogicalAxisRules = {
    **DEFAULT_RULES,
    "embed": None,
    "batch": "dp",
}


def logical_to_placements(logical_axes: Sequence[Optional[str]],
                          rules: Optional[LogicalAxisRules] = None, *,
                          mesh) -> Tuple[Placement, ...]:
    """One placement per mesh dim for a tensor whose dims carry
    ``logical_axes`` (the counterpart of ``logical_to_pspec``).

    Axes not in the rule table (or mapped to None) are replicated, mesh
    axes missing from the mesh are dropped, and a mesh axis is used at
    most once per spec: a later dim that wants it is replicated.  ``mesh``
    needs only ``mesh_dim_names`` and ``shape``.
    """
    rules = DEFAULT_RULES if rules is None else rules
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    used: set = set()
    for dim, ax in enumerate(logical_axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        axes = tuple(a for a in axes if a in names and a not in used)
        used.update(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"logical axis {ax!r} maps to mesh axes {axes}, which must "
                f"be named in the mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def shard_layout(mesh, dims: Sequence[Sequence[str]]) -> list:
    """Placements for a tensor whose dim ``i`` is sharded over the mesh
    axes ``dims[i]`` (those of size > 1 the mesh has)."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dim = [i for i, axes in enumerate(dims) if name in axes]
        out.append(Shard(dim[0]) if dim and size > 1 else Replicate())
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map_specs(fn, spec_tree, *trees):
    if _is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(spec_tree))
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def spec_tree_to_placements(spec_tree: Any, mesh,
                            rules: Optional[LogicalAxisRules] = None) -> Any:
    """A tree of logical-axis tuples as a tree of placement tuples."""
    return _map_specs(
        lambda axes: logical_to_placements(axes, rules, mesh=mesh), spec_tree)


def distribute(t: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> DTensor:
    """A DTensor of ``t``, which every rank holds whole, by local slicing
    (no communication).  A shard is copied out, so ``t`` can be freed."""
    d = distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)
    if any(isinstance(p, Shard) for p in placements):
        d = d.clone()
    return d


def shard_tree(tree: Any, spec_tree: Any, mesh: DeviceMesh,
               rules: Optional[LogicalAxisRules] = None) -> Any:
    """Place a tree of tensors, which every rank holds whole, on the mesh
    by its logical-axis spec tree: a tree of DTensors."""
    mesh = compute_mesh(mesh)
    return _map_specs(
        lambda axes, t: distribute(
            t, mesh, logical_to_placements(axes, rules, mesh=mesh)),
        spec_tree, tree)


def as_global(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """``x`` as a DTensor: a DTensor as it is, a plain tensor (which every
    rank holds whole) replicated, differentiably and without
    communication."""
    if isinstance(x, DTensor):
        return x
    mesh = compute_mesh(mesh)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _GradLayout(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to
    ``placements``: the cotangent half of a constraint.  DTensor's
    ``redistribute`` sends the gradient back in whatever layout it
    arrives (a ``Partial`` sum, say), and the next op's backward then
    reshards its operands implicitly; JAX's sharding constraint pins the
    cotangent to the same sharding as the value."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def with_logical_constraint(x: torch.Tensor, mesh: Optional[DeviceMesh],
                            *axes: Optional[str],
                            rules: Optional[LogicalAxisRules] = None
                            ) -> torch.Tensor:
    """Pin an intermediate value's layout by LOGICAL axis names resolved
    through the rule table: a ``redistribute`` (differentiable), so the
    table that shards the params decides the activation layout too, and
    the gradient's layout in the backward pass, as JAX's constraint pins
    the cotangent (``RAY_TPU_LEGACY_SHARDING=1`` leaves the gradient
    as it comes).  ``mesh=None`` is the identity, so model code stays
    mesh-optional; a plain tensor under a mesh is taken as the global
    value (``as_global``)."""
    if mesh is None:
        return x
    mesh = compute_mesh(mesh)
    x = as_global(x, mesh)
    placements = logical_to_placements(axes, rules, mesh=mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    if x.requires_grad and not legacy_sharding_enabled():
        x = _GradLayout.apply(x, mesh, placements)
    return x


def with_named_sharding(x: torch.Tensor, mesh: DeviceMesh,
                        *axes: Optional[str]) -> torch.Tensor:
    """Back-compat alias: :func:`with_logical_constraint` under
    :data:`DEFAULT_RULES`."""
    return with_logical_constraint(x, mesh, *axes)
