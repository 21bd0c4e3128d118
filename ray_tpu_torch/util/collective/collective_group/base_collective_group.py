"""Abstract collective group: a copy of the reference's
``ray_tpu/util/collective/collective_group/base_collective_group.py``
(parity: ``BaseGroup``,
``python/ray/util/collective/collective_group/base_collective_group.py:15``)."""

from __future__ import annotations

import abc
from typing import Any, List

from ray_tpu_torch.util.collective.types import ReduceOp


class BaseGroup(abc.ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def group_name(self) -> str:
        return self._group_name

    def abort(self, reason: str = "") -> None:
        """Tear the transport out from under any blocked op so it raises
        promptly (watchdog abort).  Default: nothing to close — backends
        whose ops block in an interruptible transport override this;
        the others rely on the supervision wrapper poisoning future ops
        instead."""

    @abc.abstractmethod
    def destroy_group(self) -> None: ...

    @abc.abstractmethod
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM): ...

    @abc.abstractmethod
    def barrier(self) -> None: ...

    @abc.abstractmethod
    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM): ...

    @abc.abstractmethod
    def broadcast(self, tensor, src_rank: int = 0): ...

    @abc.abstractmethod
    def allgather(self, tensor) -> List[Any]: ...

    @abc.abstractmethod
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM): ...

    @abc.abstractmethod
    def send(self, tensor, dst_rank: int, tag: int = 0) -> None: ...

    @abc.abstractmethod
    def recv(self, shape, dtype, src_rank: int, tag: int = 0): ...
