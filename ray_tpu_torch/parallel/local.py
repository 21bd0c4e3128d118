"""One rank's shard of a serving mesh, computed on plain local tensors.

The serving path places the weights and the KV pool as DTensors
(``shard_tree`` by ``TP_INFERENCE_RULES``; the pool over its kv-head dim
and, with ``pp > 1``, its layer dim) but runs on their local shards, with
the collectives written out: DTensor's dispatch, op by op, costs more
host time than a decode step's device time (``PERF.md``).  ``LocalShard``
holds what a rank needs for that:

- over ``tp`` (Megatron): the sum after each row-parallel product
  (``wo``, ``w_down``) and after the vocab-parallel lookup, and the
  gather of the head's vocab slices into whole logits;
- over ``pp``: each stage runs its ``L / pp`` layers, receives the
  activation from the stage before it and sends it to the one after it
  (``p2p.send``/``recv``), and the last stage's logits reach every stage
  (a broadcast).

The other axes (dp, fsdp, sp) hold replicas, which compute the same
values and need no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import p2p
from ray_tpu_torch.parallel.mesh import axis_size


@dataclasses.dataclass
class LocalShard:
    """This rank's place on the mesh's ``tp`` and ``pp`` axes: its index
    and group on each (a group of None where the axis has size 1), and
    the global ranks of its pipeline in stage order."""

    tp_rank: int = 0
    tp_size: int = 1
    tp_group: Any = None
    pp_rank: int = 0
    pp_size: int = 1
    pp_group: Any = None
    pp_ranks: Tuple[int, ...] = ()

    @classmethod
    def of(cls, mesh) -> "LocalShard":
        """The shard of this rank on ``mesh`` (a ``DeviceMesh`` with named
        axes; a missing axis counts as size 1)."""
        out = cls()
        if axis_size(mesh, "tp") > 1:
            out.tp_size = axis_size(mesh, "tp")
            out.tp_rank = mesh.get_local_rank("tp")
            out.tp_group = mesh.get_group("tp")
        if axis_size(mesh, "pp") > 1:
            out.pp_size = axis_size(mesh, "pp")
            out.pp_rank = mesh.get_local_rank("pp")
            out.pp_group = mesh.get_group("pp")
            out.pp_ranks = tuple(dist.get_global_rank(out.pp_group, p)
                                 for p in range(out.pp_size))
        return out

    @property
    def first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pp_rank == self.pp_size - 1

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the tp group, in place (identity at tp=1)."""
        if self.tp_size > 1:
            dist.all_reduce(x, group=self.tp_group)
        return x

    def row_parallel(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for a weight split over tp along its input dim (``wo``,
        ``w_down``): this rank's partial product, summed over tp, in
        ``a``'s dtype.  The partials stay fp32 from the product through
        the sum and are rounded once, as one card's product accumulates in
        fp32 and rounds once: rounding each partial (and, in NCCL's ring,
        each hop) to a 16-bit type moves the logits by more than one
        card's rounding does.  On CUDA the product leaves the GEMM in fp32
        (``out_dtype``); elsewhere its operands are upcast."""
        if self.tp_size == 1:
            return a @ w
        a2 = a.reshape(-1, a.shape[-1])
        if a.is_cuda:
            y = torch.mm(a2, w, out_dtype=torch.float32)
        else:
            y = a2.float() @ w.float()
        dist.all_reduce(y, group=self.tp_group)
        return y.to(a.dtype).reshape(*a.shape[:-1], w.shape[-1])

    def tp_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The tp group's slices of ``x`` joined along ``dim`` in tp order
        (``x`` itself at tp=1)."""
        return _gather(x, self.tp_group, self.tp_size, dim)

    def pool_whole(self, t: torch.Tensor) -> torch.Tensor:
        """A KV pool tensor's slice (layers on dim 0, kv heads on dim 3)
        gathered over pp and tp into the whole tensor."""
        return _gather(self.tp_gather(t, dim=3), self.pp_group,
                       self.pp_size, 0)

    def pool_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole KV pool tensor (layers on dim 0,
        kv heads on dim 3): ``pool_whole``'s inverse."""
        L, kvh = t.shape[0] // self.pp_size, t.shape[3] // self.tp_size
        return t.narrow(0, self.pp_rank * L, L).narrow(
            3, self.tp_rank * kvh, kvh)

    def stage_input(self, make: Callable[[], torch.Tensor], shape,
                    dtype: torch.dtype, device) -> torch.Tensor:
        """The activation entering this stage's layers: ``make()`` on the
        first stage, else what the stage before sends (of ``shape`` and
        ``dtype``)."""
        if self.first_stage:
            return make()
        return p2p.recv(torch.empty(shape, dtype=dtype, device=device),
                        self.pp_ranks[self.pp_rank - 1], self.pp_group)

    def stage_output(self, x: torch.Tensor) -> None:
        """Send this stage's activation to the next stage (none from the
        last)."""
        if not self.last_stage:
            p2p.send(x, self.pp_ranks[self.pp_rank + 1], self.pp_group)

    def from_last_stage(self, y: torch.Tensor) -> torch.Tensor:
        """The last stage's ``y`` on every stage, the others giving a
        buffer of its shape and dtype (a broadcast over pp; ``y`` itself
        at pp=1)."""
        if self.pp_size == 1:
            return y
        y = y.contiguous()
        dist.broadcast(y, self.pp_ranks[-1], group=self.pp_group)
        return y


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict, list or tuple, in the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` joined along ``dim`` in group order
    (``x`` itself for a group of one)."""
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
