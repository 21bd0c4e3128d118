"""Public collective API: the process-local group registry and the module
functions (counterpart of ``ray_tpu/util/collective/collective.py``).

Each participating process calls ``init_collective_group`` (a train
worker through ``train.get_context().collective_group()``), then the
module-level ops.  Every group is wrapped in a :class:`~ray_tpu_torch.
util.collective.supervision.SupervisedGroup`, so every public op carries
a sequence number, lands in the flight recorder, and raises
``CollectiveAbortError`` (instead of hanging) when the group aborts.
``destroy_collective_group`` + ``init_collective_group`` is the
supported re-init path after an abort.

``create_collective_group(actors)`` makes process actors
(``ray_tpu_torch.actor``) a group from their creator: it dispatches the
join into each actor's process through ``_remote_call``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import accelerators
from ray_tpu_torch.util.collective.supervision import (  # noqa: F401
    SupervisedGroup,
    drop_group_keys,
    flight_recorder_dump,
    resolve_timeout,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp


class GroupManager:
    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create(self, backend, world_size: int, rank: int, group_name: str,
               timeout_s: Optional[float] = None, devices=None):
        backend = Backend.parse(backend)
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(
                    f"collective group {group_name!r} already initialized"
                )
        if backend is Backend.MESH:
            # one PROCESS owning the cards: "ranks" are its cards, so the
            # declared (process) world size must be 1
            from ray_tpu_torch.util.collective.collective_group.mesh_group import (  # noqa: E501
                CudaMeshGroup,
            )

            _refuse_multi_process_mesh(world_size)
            cards = (accelerators.detect_gpus() if devices is None
                     else len(devices))
            inner = CudaMeshGroup(cards, 0, group_name, devices=devices)
        else:
            from ray_tpu_torch.util.collective.collective_group.torch_group import (  # noqa: E501
                TorchDistributedGroup,
            )

            if devices is not None:
                raise ValueError("devices= names a mesh group's ranks; a "
                                 f"{backend.value} group has one per process")
            inner = TorchDistributedGroup(world_size, rank, group_name,
                                          backend=backend,
                                          timeout_s=timeout_s)
        g = SupervisedGroup(inner, timeout_s=timeout_s,
                            backend=backend.value)
        with self._lock:
            self._groups[group_name] = g
        return g

    def get(self, group_name: str):
        g = self._groups.get(group_name)
        if g is None:
            raise RuntimeError(
                f"collective group {group_name!r} is not initialized in "
                f"this process; call init_collective_group first"
            )
        return g

    def exists(self, group_name: str) -> bool:
        return group_name in self._groups

    def destroy(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy_group()


_group_mgr = GroupManager()
logger = logging.getLogger(__name__)


def _refuse_multi_process_mesh(world_size: int) -> None:
    if world_size != 1:
        raise ValueError(
            "backend='mesh' (the reference's 'xla_mesh') is the "
            "single-process fast path: exactly one participating process "
            f"owns the cards (got world_size={world_size}); use "
            "backend='nccl' for rank-per-process groups")


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "tcp",
    group_name: str = "default",
    timeout_s: Optional[float] = None,
    devices: Optional[List[Any]] = None,
) -> None:
    """Initialize this process's membership in a collective group.

    ``backend`` is ``"tcp"`` (also ``"gloo"``: host tensors), ``"nccl"``
    (tensors on this process's card) or ``"mesh"`` (also ``"xla_mesh"``:
    this one process's cards are the ranks, ``world_size`` must be 1;
    ``devices`` names them, every visible card by default, or
    ``["cpu"] * n`` for host ranks).  ``timeout_s`` bounds rendezvous AND
    every op on this member (abort past it); default from
    ``RAY_TPU_TORCH_COLLECTIVE_TIMEOUT`` or 120 s.  Rendezvous goes
    through the run's KV (``RAY_TPU_TORCH_KV``).
    """
    _group_mgr.create(backend, world_size, rank, group_name,
                      timeout_s=timeout_s, devices=devices)


def _join(instance, world_size, rank, backend, group_name, timeout_s,
          devices=None):
    """``_remote_call`` body: join the group in the actor's process."""
    init_collective_group(world_size, rank, backend, group_name,
                          timeout_s=timeout_s, devices=devices)
    return rank


def _leave(instance, group_name):
    """``_remote_call`` body: leave the group if this process joined."""
    if is_group_initialized(group_name):
        destroy_collective_group(group_name)
    return True


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: Optional[List[int]] = None,
    backend: str = "tcp",
    group_name: str = "default",
    timeout_s: Optional[float] = None,
    devices: Optional[List[Any]] = None,
) -> None:
    """Creator-side setup: make the process ``actors`` a collective group.

    Dispatches ``init_collective_group`` into every actor (through
    ``_remote_call``, so their classes need no special method) and waits
    until every rank has joined: ``"tcp"`` (gloo) for host tensors,
    ``"nccl"`` for actors on one card each, ``"mesh"`` for ONE actor
    whose cards (or ``devices``) are the ranks.  The wait is bounded: an actor
    that dies before joining fails the call within the timeout, and the
    partly formed group is torn down (joined ranks leave, rendezvous
    keys are dropped) so the name can be used again.
    """
    from ray_tpu_torch import actor as actor_mod

    if ranks is None:
        ranks = list(range(len(actors)))
    if len(actors) != len(ranks) or len(actors) != world_size:
        raise ValueError(
            f"{len(actors)} actors, {len(ranks)} ranks, world={world_size}")
    if Backend.parse(backend) is Backend.MESH:
        _refuse_multi_process_mesh(world_size)
    op_timeout = resolve_timeout(timeout_s)
    try:
        refs = [a._remote_call.remote(_join, world_size, r, backend,
                                      group_name, timeout_s, devices)
                for a, r in zip(actors, ranks)]
        # margin above the rendezvous timeout: the joins themselves must
        # be reached in each actor's call order
        actor_mod.get(refs, timeout=op_timeout + 30.0)
    except Exception:
        logger.warning("collective group %r: not all %d rank(s) joined; "
                       "tearing down the partial group", group_name,
                       world_size)
        leave_refs = [a._remote_call.remote(_leave, group_name)
                      for a in actors]
        for ref in leave_refs:
            try:
                ref.get(timeout=10)
            except Exception:  # noqa: BLE001 — a dead actor
                pass
        drop_group_keys(group_name, kv=actor_mod.run_store())
        raise


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.exists(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _group_mgr.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get(group_name).world_size


def get_group_state(group_name: str = "default") -> str:
    """Supervision state of this process's membership (READY | ABORTED).
    A destroyed group is removed from the registry entirely, so querying
    it raises RuntimeError like any other uninitialized name."""
    return _group_mgr.get(group_name).state.value


def allreduce(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _group_mgr.get(group_name).allreduce(tensor, op)


def barrier(group_name: str = "default") -> None:
    _group_mgr.get(group_name).barrier()


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op=ReduceOp.SUM):
    return _group_mgr.get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group_mgr.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return _group_mgr.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _group_mgr.get(group_name).reducescatter(tensor, op)


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    return _group_mgr.get(group_name).send(tensor, dst_rank, tag)


def recv(shape=None, dtype=None, src_rank: int = 0,
         group_name: str = "default", tag: int = 0):
    return _group_mgr.get(group_name).recv(shape, dtype, src_rank, tag)


def permute(tensor, perm, group_name: str = "default"):
    """``ppermute`` over the group: ``perm`` is ``[(src, dst), ...]``."""
    return _group_mgr.get(group_name).permute(tensor, perm)
