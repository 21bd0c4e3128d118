"""One process's cards as a collective group: the port's counterpart of
``XlaMeshGroup`` (``ray_tpu/util/collective/collective_group/
xla_group.py:107``).

One process owns several cards and the group's ranks are those cards,
the single-process fast path beside the rank-per-process
``TorchDistributedGroup``.  A value stays on the cards from op to op and
is never staged through the host.

Input: a list of per-rank tensors (tensor i on rank i's device), or one
tensor stacked on dim 0 (``[world, ...]``, as the reference takes it),
which is placed one row per rank.  Results are per-rank tensors, one per
rank: a replicated result (``allreduce``, ``reduce``, ``allgather``) is
an equal copy on every card, a result sharded over the ranks
(``broadcast``, ``reducescatter``, ``permute``) has row i on card i.

On the cards ``allreduce``, ``reduce``, ``broadcast``, ``allgather`` and
``reducescatter`` are NCCL's single-process collectives over every card
(``torch.cuda.nccl``, which keeps one communicator per list of cards and
queues each op on every card's current stream), the counterpart of the
ICI collectives.  ``permute`` is K4 (``ops/cuda/remote_copy.py``): one
``remote_copy`` per (src, dst) pair onto the destination card, then one
``check_remote_copies``; a card no pair sends to gets zeros.  A failed
launch raises; nothing falls back to ``copy_``.

Host ranks (``devices=["cpu"] * n``, asked for explicitly, as the CPU
tests do) are separate host tensors; the NCCL ops then run their plain
versions (the ``*_plain`` functions below, which ``chip_smoke.py`` holds
the cards against), and ``permute`` runs K4's wrapper, whose plain
version serves host tensors.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops.cuda.remote_copy import check_remote_copies, remote_copy
from ray_tpu_torch.util.collective.collective_group.base_collective_group import (  # noqa: E501
    BaseGroup,
)
from ray_tpu_torch.util.collective.types import ReduceOp

#: NCCL's ``ncclRedOp_t`` values, as ``torch.cuda.nccl`` takes them
_NCCL_OP = {ReduceOp.SUM: 0, ReduceOp.PRODUCT: 1, ReduceOp.MAX: 2,
            ReduceOp.MIN: 3}


# -- plain versions, on lists of per-rank tensors -----------------------------
def allreduce_plain(shards: Sequence[torch.Tensor],
                    op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """The reduction over the ranks: sum, amax, amin or prod of dim 0 of
    the stack (prod is a true product: exact for zeros and negatives)."""
    x = torch.stack([s.cpu() for s in shards])
    op = ReduceOp(op)
    if op == ReduceOp.SUM:
        return x.sum(0)
    if op == ReduceOp.MAX:
        return x.amax(0)
    if op == ReduceOp.MIN:
        return x.amin(0)
    return x.prod(0)


def broadcast_plain(shards: Sequence[torch.Tensor], src_rank: int
                    ) -> List[torch.Tensor]:
    """Every rank's row: the source's."""
    return [shards[src_rank].cpu().clone() for _ in shards]


def allgather_plain(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every rank's row, stacked: ``[world, ...]``."""
    return torch.stack([s.cpu() for s in shards])


def reducescatter_plain(shards: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Rank i's row: row i of the sum over the ranks of their
    ``[world, ...]`` inputs."""
    total = allreduce_plain(shards, ReduceOp.SUM)
    return [total[i] for i in range(len(shards))]


def permute_plain(shards: Sequence[torch.Tensor],
                  perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``ppermute``: rank dst's row is rank src's for each pair, zeros
    where no pair sends."""
    out = [torch.zeros_like(s.cpu()) for s in shards]
    for src, dst in perm:
        out[dst] = shards[src].cpu().clone()
    return out


def _check_perm(perm, n: int) -> List[Tuple[int, int]]:
    perm = [(int(s), int(d)) for s, d in perm]
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"permute: pair {(s, d)} outside {n} ranks")
    for side, name in ((0, "source"), (1, "destination")):
        seen = [p[side] for p in perm]
        if len(set(seen)) != len(seen):
            raise ValueError(f"permute: a {name} repeats in {perm}")
    return perm


def _resolve_devices(world_size: int, devices) -> List[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CudaMeshGroup: CUDA is not available and no devices were "
                "given; pass devices=['cpu'] * n for host ranks")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:world_size]
    devs = [torch.device("cuda", d) if isinstance(d, int) else
            torch.device(d) for d in devices]
    if len(devs) < world_size:
        raise ValueError(f"need {world_size} devices, have {len(devs)}")
    kinds = {d.type for d in devs}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"a mesh group's ranks are all cards or all host "
                         f"ranks, got {[str(d) for d in devs]}")
    if kinds == {"cuda"}:
        devs = [torch.device("cuda", d.index or 0) for d in devs]
        if len(set(devs)) != len(devs):
            raise ValueError(f"a card is named twice in "
                             f"{[str(d) for d in devs]}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"CudaMeshGroup over {devs[0]}: CUDA is not "
                               "available")
    return devs


class CudaMeshGroup(BaseGroup):
    """Collectives over the cards of one process (ranks = cards)."""

    def __init__(self, world_size: int, rank: int = 0,
                 group_name: str = "default", *,
                 devices: Optional[Sequence[Any]] = None):
        super().__init__(world_size, rank, group_name)
        self.devices = _resolve_devices(world_size, devices)
        self.on_host = self.devices[0].type == "cpu"

    # -- tensors in -----------------------------------------------------------
    def _shards(self, tensor) -> List[torch.Tensor]:
        """``tensor`` as one contiguous tensor per rank on its device: a
        list's tensors as they are (each must lie on its rank's device),
        a stacked tensor's rows copied one per rank."""
        n = len(self.devices)
        if isinstance(tensor, (list, tuple)):
            if len(tensor) != n:
                raise ValueError(f"{len(tensor)} tensors for {n} ranks")
            out = []
            for i, (t, dev) in enumerate(zip(tensor, self.devices)):
                if t.device != dev:
                    raise ValueError(f"rank {i}'s tensor lies on {t.device}, "
                                     f"its rank's device is {dev}")
                out.append(t.contiguous())
            return out
        if not isinstance(tensor, torch.Tensor):
            tensor = torch.from_numpy(np.array(tensor))
        if tensor.dim() == 0 or tensor.shape[0] != n:
            raise ValueError(f"a stacked input has {n} rows on dim 0, got "
                             f"shape {tuple(tensor.shape)}")
        return [tensor[i].to(dev, copy=True) for i, dev in
                enumerate(self.devices)]

    # -- ops --------------------------------------------------------------
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM
                  ) -> List[torch.Tensor]:
        """The reduction (SUM, MAX, MIN or PRODUCT), a copy on every
        rank."""
        op = ReduceOp(op)
        shards = self._shards(tensor)
        if self.on_host:
            total = allreduce_plain(shards, op)
            return [total.clone() for _ in shards]
        from torch.cuda import nccl

        outs = [torch.empty_like(s) for s in shards]
        nccl.all_reduce(shards, outs, op=_NCCL_OP[op])
        return outs

    def barrier(self) -> None:
        """Every card has reached this point: an allreduce on every card,
        then each card's stream drained."""
        self.allreduce([torch.zeros(1, device=d) for d in self.devices])
        if not self.on_host:
            for d in self.devices:
                torch.cuda.synchronize(d)

    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM) -> List[torch.Tensor]:
        return self.allreduce(tensor, op)  # every rank, dst included

    def broadcast(self, tensor, src_rank: int = 0) -> List[torch.Tensor]:
        """The source's row on every rank."""
        shards = self._shards(tensor)
        if not 0 <= src_rank < len(shards):
            raise ValueError(f"broadcast from rank {src_rank} of "
                             f"{len(shards)}")
        if self.on_host:
            return broadcast_plain(shards, src_rank)
        from torch.cuda import nccl

        outs = [s.clone() if i == src_rank else torch.empty_like(s)
                for i, s in enumerate(shards)]
        # torch.cuda.nccl broadcasts from the list's first tensor whatever
        # its ``root`` says, so the source goes first (a communicator per
        # order of the cards, made on first use and kept)
        nccl.broadcast([outs[src_rank]] + outs[:src_rank]
                       + outs[src_rank + 1:])
        return outs

    def allgather(self, tensor) -> List[torch.Tensor]:
        """Every rank's row stacked (``[world, ...]``), a copy on every
        rank."""
        shards = self._shards(tensor)
        if self.on_host:
            whole = allgather_plain(shards)
            return [whole.clone() for _ in shards]
        from torch.cuda import nccl

        outs = [torch.empty((len(shards), *s.shape), dtype=s.dtype,
                            device=s.device) for s in shards]
        nccl.all_gather(shards, outs)
        return outs

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM
                      ) -> List[torch.Tensor]:
        """Each rank holds ``[world, ...]``; rank i gets row i of their
        sum (``psum_scatter`` with ``tiled=False``)."""
        if ReduceOp(op) != ReduceOp.SUM:
            raise NotImplementedError("reducescatter supports SUM on the "
                                      "mesh group")
        shards = self._shards(tensor)
        n = len(shards)
        if any(s.dim() == 0 or s.shape[0] != n for s in shards):
            raise ValueError(f"reducescatter: each rank's tensor has {n} "
                             f"rows, got {[tuple(s.shape) for s in shards]}")
        if self.on_host:
            return reducescatter_plain(shards)
        from torch.cuda import nccl

        outs = [torch.empty(s.shape[1:], dtype=s.dtype, device=s.device)
                for s in shards]
        nccl.reduce_scatter(shards, outs, op=_NCCL_OP[ReduceOp.SUM])
        return outs

    def send(self, tensor, dst_rank: int, tag: int = 0) -> None:
        raise NotImplementedError(
            "point-to-point on the mesh group: use permute()")

    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        raise NotImplementedError(
            "point-to-point on the mesh group: use permute()")

    def permute(self, tensor, perm: Sequence[Tuple[int, int]]
                ) -> List[torch.Tensor]:
        """``ppermute``: ``perm`` is ``[(src, dst), ...]``; rank dst gets
        rank src's row by one K4 hop onto dst's card, and a rank no pair
        sends to gets zeros."""
        shards = self._shards(tensor)
        perm = _check_perm(perm, len(shards))
        dsts = {d for _, d in perm}
        outs = [torch.empty_like(s) if i in dsts else torch.zeros_like(s)
                for i, s in enumerate(shards)]
        for src, dst in perm:
            remote_copy(shards[src], outs[dst])
        if not self.on_host and perm:
            check_remote_copies()
        return outs

    def destroy_group(self) -> None:
        """Nothing to release: NCCL's communicators over a list of cards
        belong to the process (``torch.cuda.nccl`` keeps them)."""
