"""``torch.distributed`` collective groups: the port's counterpart of
``XlaDistributedGroup`` (``ray_tpu/util/collective/collective_group/
xla_group.py:221``), one rank per process.

The group is a process group of its own, built on a ``PrefixStore`` of
the run's store (``_private/kv.py``) under an epoch-versioned prefix: it
is not the default group, which belongs to the mesh
(``parallel.mesh.ensure_process_group``), so the two never share a
communicator.  gloo serves host tensors and NCCL device tensors, each
with the group's op timeout.  The group's first op is a barrier inside
the constructor, so NCCL builds its communicator there and not inside
the first op a caller times.

Tensors may be torch tensors or numpy arrays (a numpy result for a numpy
input).  The ops follow ``XlaDistributedGroup``'s results: ``allreduce``
and ``reduce`` give every rank the reduction, ``allgather`` a list of
every rank's tensor, ``reducescatter`` this rank's slice of dim 0 of the
reduction, ``broadcast`` the source's tensor; ``permute`` is
``ppermute``'s (zeros where no pair sends to this rank).
"""

from __future__ import annotations

import datetime
import json
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch.util.collective.collective_group.base_collective_group import (  # noqa: E501
    BaseGroup,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp
from ray_tpu_torch.util.fault_injection import fault_point

_TORCH_OP = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


def _transport_error(e: RuntimeError) -> Exception:
    """A backend's failure inside an op as the transport error the
    supervision layer aborts on: gloo reports a timeout or a closed peer
    as a bare ``RuntimeError``."""
    text = str(e)
    if "timed out" in text.lower() or "timeout" in text.lower():
        return TimeoutError(text)
    return ConnectionError(text)


class TorchDistributedGroup(BaseGroup):
    """Rank-per-process group over ``torch.distributed`` (gloo or NCCL).

    Rendezvous: rank 0 bumps ``collective/{group}/epoch`` in the run's
    store and publishes ``collective/{group}/leader`` with it; the other
    ranks wait (within the timeout) for a leader entry of the current
    epoch, and all build the backend on the prefix
    ``collective/{group}/e{epoch}/``.
    """

    def __init__(self, world_size: int, rank: int, group_name: str,
                 *, backend: Backend = Backend.TCP,
                 timeout_s: Optional[float] = None):
        super().__init__(world_size, rank, group_name)
        from ray_tpu_torch.util.collective.supervision import (
            drop_group_status_keys, resolve_timeout)

        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self._timeout_s = resolve_timeout(timeout_s)
        self.backend = Backend.parse(backend)
        if self.backend is Backend.NCCL:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend='nccl' needs CUDA; use backend='tcp' (gloo) "
                    "for host tensors")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        kv = kv_mod.client()
        epoch_key = f"collective/{group_name}/epoch"
        leader_key = f"collective/{group_name}/leader"
        if rank == 0:
            fault_point("collective.rendezvous")
            self.epoch = int(kv.store.add(epoch_key, 1))
            drop_group_status_keys(group_name)
            kv.put(leader_key, json.dumps({"epoch": self.epoch}).encode())
        else:
            deadline = time.monotonic() + self._timeout_s
            self.epoch = 0
            while True:
                fault_point("collective.rendezvous")
                raw = kv.get(leader_key)
                if raw:
                    entry = json.loads(raw)
                    current = int(kv.store.add(epoch_key, 0))
                    if entry["epoch"] == current:
                        self.epoch = current
                        break
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"collective group {group_name!r}: rank 0 never "
                        "published the current epoch's rendezvous")
                time.sleep(0.02)
        timeout = datetime.timedelta(seconds=self._timeout_s)
        # a connection of its own, so the rendezvous waits for late ranks
        # up to the group's timeout and not the run KV's
        self._store = kv_mod.connect(kv.addr, timeout_s=self._timeout_s)
        prefixed = dist.PrefixStore(
            f"collective/{group_name}/e{self.epoch}/", self._store.store)
        if self.backend is Backend.NCCL:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._pg = dist.ProcessGroupNCCL(prefixed, rank, world_size,
                                             opts)
        else:
            self._pg = dist.ProcessGroupGloo(prefixed, rank, world_size,
                                             timeout)
        self.barrier()

    # -- tensors in and out -------------------------------------------------
    def _in(self, tensor) -> Tuple[torch.Tensor, bool]:
        """``tensor`` as a contiguous copy on the group's device, and
        whether it came as numpy."""
        if isinstance(tensor, torch.Tensor):
            if tensor.device.type != self.device.type:
                raise ValueError(
                    f"a {tensor.device.type} tensor on a "
                    f"{self.backend.value} group (its tensors live on "
                    f"{self.device.type})")
            return tensor.detach().clone(
                memory_format=torch.contiguous_format), False
        return torch.from_numpy(np.array(tensor)).to(self.device), True

    @staticmethod
    def _out(t: torch.Tensor, as_numpy: bool):
        return t.cpu().numpy() if as_numpy else t

    def _wait(self, work) -> None:
        try:
            work.wait()
        except RuntimeError as e:
            raise _transport_error(e) from e

    # -- ops --------------------------------------------------------------
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        t, np_in = self._in(tensor)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _TORCH_OP[ReduceOp(op)]
        self._wait(self._pg.allreduce([t], opts))
        return self._out(t, np_in)

    def barrier(self) -> None:
        self._wait(self._pg.allreduce([torch.zeros(1, device=self.device)]))

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        # the reference's XLA group gives every rank the reduction
        return self.allreduce(tensor, op)

    def broadcast(self, tensor, src_rank: int = 0):
        t, np_in = self._in(tensor)
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        opts.rootTensor = 0
        self._wait(self._pg.broadcast([t], opts))
        return self._out(t, np_in)

    def allgather(self, tensor) -> List[Any]:
        t, np_in = self._in(tensor)
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        self._wait(self._pg.allgather([outs], [t]))
        return [self._out(o, np_in) for o in outs]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        t, np_in = self._in(tensor)
        if t.dim() == 0 or t.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter: dim 0 of shape {tuple(t.shape)} does not "
                f"split into {self.world_size} ranks")
        out = torch.empty((t.shape[0] // self.world_size, *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _TORCH_OP[ReduceOp(op)]
        self._wait(self._pg._reduce_scatter_base(out, t, opts))
        return self._out(out, np_in)

    def send(self, tensor, dst_rank: int, tag: int = 0) -> None:
        t, _ = self._in(tensor)
        self._wait(self._pg.send([t], dst_rank, tag))

    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        if shape is None or dtype is None:
            raise ValueError("recv on a torch.distributed group needs the "
                             "shape and dtype of the tensor it receives")
        as_numpy = not isinstance(dtype, torch.dtype)
        tdtype = (torch.from_numpy(np.empty(0, dtype=dtype)).dtype
                  if as_numpy else dtype)
        out = torch.empty(tuple(shape), dtype=tdtype, device=self.device)
        self._wait(self._pg.recv([out], src_rank, tag))
        return self._out(out, as_numpy)

    def permute(self, tensor, perm: Sequence[Tuple[int, int]]):
        """``ppermute`` by send/recv pairs: ``perm`` is ``[(src, dst),
        ...]`` with every dst at most once; this rank gets what its src
        sent, or zeros.  With each peer, the lower rank sends first and
        the higher receives first, so a swap cannot deadlock on one
        peer-to-peer channel."""
        t, np_in = self._in(tensor)
        perm = [(int(s), int(d)) for s, d in perm]
        dsts = [d for _, d in perm]
        if len(set(dsts)) != len(dsts):
            raise ValueError(f"permute: a destination repeats in {perm}")
        out = torch.zeros_like(t)
        peers = sorted({p for pair in perm if self.rank in pair
                        for p in pair if p != self.rank})
        works = []
        for peer in peers:
            ops = []
            if (self.rank, peer) in perm:
                ops.append(("send", peer))
            if (peer, self.rank) in perm:
                ops.append(("recv", peer))
            if self.rank > peer:
                ops.reverse()
            for kind, p in ops:
                works.append(self._pg.send([t], p, 0) if kind == "send"
                             else self._pg.recv([out], p, 0))
        for w in works:
            self._wait(w)
        if (self.rank, self.rank) in perm:
            out.copy_(t)
        return self._out(out, np_in)

    # -- lifecycle ----------------------------------------------------------
    def abort(self, reason: str = "") -> None:
        """NCCL can abort its communicators under a blocked op; a gloo op
        ends at its own timeout."""
        if self.backend is Backend.NCCL:
            self._pg.abort()

    def destroy_group(self) -> None:
        from ray_tpu_torch.util.collective.supervision import drop_group_keys

        drop_group_keys(self.group_name)
        shutdown = getattr(self._pg, "shutdown", None)
        if self.backend is Backend.NCCL and shutdown is not None:
            shutdown()
        self._pg = None
