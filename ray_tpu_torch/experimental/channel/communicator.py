"""Communicators for compiled-graph peers (counterpart of
``ray_tpu/experimental/channel/communicator.py``).

:class:`Communicator` is the interface (initialize, send, recv and the
collectives).  :class:`CpuCommunicator` runs it over the port's
collective groups (``util/collective``, gloo for host tensors).
:class:`CudaCommunicator` takes the place of the reference's
``TpuCommunicator``: tensors on a card are staged through the host and
sent over the same gloo group, as the reference stages device arrays
through host memory.  Bulk data between a DAG's actors does not go
through either: it rides the tier-negotiated ``EdgeTransport`` of each
edge (``transport.py``).
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional

_REDUCE_OPS = ("sum", "product", "min", "max")


class Communicator(abc.ABC):
    @abc.abstractmethod
    def initialize(self, rank: int) -> None: ...

    @abc.abstractmethod
    def get_rank(self, actor) -> int: ...

    @abc.abstractmethod
    def get_world_size(self) -> int: ...

    @abc.abstractmethod
    def send(self, tensor: Any, peer_rank: int) -> None: ...

    @abc.abstractmethod
    def recv(self, shape, dtype, peer_rank: int) -> Any: ...

    @abc.abstractmethod
    def allreduce(self, tensor: Any, op: str = "sum") -> Any: ...

    def allgather(self, tensor: Any) -> List[Any]:
        raise NotImplementedError

    def reducescatter(self, tensor: Any, op: str = "sum") -> Any:
        raise NotImplementedError

    @abc.abstractmethod
    def destroy(self) -> None: ...


class CpuCommunicator(Communicator):
    """Host-memory communicator over one of the port's collective groups
    (backend ``"tcp"``: gloo).  Tensors may be host tensors or numpy
    arrays."""

    def __init__(self, world_size: int, group_name: str,
                 actor_ranks: Optional[dict] = None):
        self.world_size = world_size
        self.group_name = group_name
        self._rank: Optional[int] = None
        self._actor_ranks = actor_ranks or {}

    def initialize(self, rank: int) -> None:
        """Join the group as ``rank`` (rendezvous through the run store
        the process's environment names)."""
        from ray_tpu_torch.util import collective as col

        self._rank = rank
        if not col.is_group_initialized(self.group_name):
            col.init_collective_group(
                self.world_size, rank, backend="tcp",
                group_name=self.group_name)

    def get_rank(self, actor) -> int:
        key = getattr(actor, "_actor_id", None) or actor
        rank = self._actor_ranks.get(key)
        if rank is None:
            # a silent -1 here becomes a wrong-peer send downstream —
            # name the actor instead
            raise ValueError(
                f"actor {actor!r} is not a member of communicator group "
                f"{self.group_name!r} (known ranks: "
                f"{sorted(map(repr, self._actor_ranks))})")
        return rank

    def get_world_size(self) -> int:
        return self.world_size

    def send(self, tensor, peer_rank: int) -> None:
        from ray_tpu_torch.util import collective as col

        col.send(tensor, peer_rank, group_name=self.group_name)

    def recv(self, shape, dtype, peer_rank: int):
        from ray_tpu_torch.util import collective as col

        return col.recv(shape, dtype, peer_rank, group_name=self.group_name)

    def allreduce(self, tensor, op: str = "sum"):
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.types import ReduceOp

        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported reduce op {op!r}: expected one "
                             f"of {_REDUCE_OPS}")
        return col.allreduce(tensor, group_name=self.group_name,
                             op=ReduceOp(op))

    def allgather(self, tensor):
        from ray_tpu_torch.util import collective as col

        return col.allgather(tensor, group_name=self.group_name)

    def reducescatter(self, tensor, op: str = "sum"):
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.types import ReduceOp

        return col.reducescatter(tensor, group_name=self.group_name,
                                 op=ReduceOp(op))

    def destroy(self) -> None:
        from ray_tpu_torch.util import collective as col

        if col.is_group_initialized(self.group_name):
            col.destroy_collective_group(self.group_name)


class CudaCommunicator(CpuCommunicator):
    """Card-tensor communicator, staged through the host: the counterpart
    of the reference's ``TpuCommunicator``, which stages device arrays
    through host memory (``device_get`` before a send, ``device_put``
    after a receive).  A tensor on a card is copied to the host, moved
    over the group's gloo transport, and a received one lands on
    ``device`` (default: this process's current card).  Device-resident
    collectives between processes are the ``"nccl"`` backend of
    ``util/collective`` and the DAG's collective nodes."""

    def __init__(self, world_size: int, group_name: str,
                 actor_ranks: Optional[dict] = None, device=None):
        super().__init__(world_size, group_name, actor_ranks)
        self.device = device

    def _landing(self):
        import torch

        return torch.device("cuda", torch.cuda.current_device()) \
            if self.device is None else torch.device(self.device)

    def _land(self, value):
        import torch

        if isinstance(value, list):
            return [self._land(v) for v in value]
        return value.to(self._landing()) if isinstance(
            value, torch.Tensor) else value

    @staticmethod
    def _host(tensor):
        import torch

        return tensor.cpu() if isinstance(tensor, torch.Tensor) else tensor

    def send(self, tensor, peer_rank: int) -> None:
        super().send(self._host(tensor), peer_rank)

    def recv(self, shape, dtype, peer_rank: int):
        return self._land(super().recv(shape, dtype, peer_rank))

    def allreduce(self, tensor, op: str = "sum"):
        return self._land(super().allreduce(self._host(tensor), op))

    def allgather(self, tensor):
        return self._land(super().allgather(self._host(tensor)))

    def reducescatter(self, tensor, op: str = "sum"):
        return self._land(super().reducescatter(self._host(tensor), op))
