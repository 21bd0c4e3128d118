"""Collective nodes: allreduce, allgather and reducescatter as compiled-DAG
ops (counterpart of ``ray_tpu/dag/collective_node.py``).

Usage (one output node per input, each bound to the same actor)::

    with InputNode() as inp:
        g0 = w0.grad.bind(inp)
        g1 = w1.grad.bind(inp)
        r0, r1 = allreduce.bind([g0, g1], backend="nccl")
        dag = MultiOutputNode([w0.apply.bind(r0), w1.apply.bind(r1)])
    cdag = dag.experimental_compile()

Execution model: at compile time the DAG's actors are joined into a
collective group (``util.collective.create_collective_group``): backend
``"tcp"`` (gloo, host tensors; the default), ``"nccl"`` (one card per
actor process) or ``"mesh"`` (also ``"xla_mesh"``: ONE actor whose cards
are the ranks, ``CudaMeshGroup``; its value is a ``[world, ...]`` stack
or a list of per-card tensors, its result a list of per-card tensors
handed to the next method in the process; ``devices=`` names the ranks,
every card the actor sees by default).  Inside each actor's exec loop
the collective task calls the group's op with its local value.  Overlap: the exec loop launches the
collective on a background thread and joins it at the first task that
consumes its result, so independent compute between the op and its
consumer runs while it communicates.

Error semantics: a rank whose upstream failed skips the collective and
propagates the TaskError; its peers then fail the iteration at the
group's op timeout rather than hanging.
"""

from __future__ import annotations

import uuid
from typing import Any, List, Optional

from ray_tpu_torch.dag.dag_node import ClassMethodNode, DAGNode


class _CollectiveGroup:
    """One joint operation over N actor-resident values."""

    def __init__(self, inputs: List[ClassMethodNode], op: str,
                 backend: str, timeout_s: Optional[float] = None,
                 devices: Optional[List[Any]] = None):
        if not inputs:
            raise ValueError("collective bind() needs at least one node")
        for n in inputs:
            if not isinstance(n, ClassMethodNode):
                raise TypeError(
                    "collective inputs must be actor-method nodes, got "
                    f"{type(n).__name__}")
        actors = [n.actor._actor_id for n in inputs]
        if len(set(actors)) != len(actors):
            raise ValueError(
                "collective inputs must live on distinct actors (one rank "
                "per process)")
        from ray_tpu_torch.util.collective.types import Backend

        self.inputs = list(inputs)
        self.op = op
        # an unknown backend, or JAX's "xla", fails here
        self.backend = Backend.parse(backend).value
        # a mesh group's ranks (None: every card of the actor's process)
        self.devices = None if devices is None else [str(d) for d in devices]
        # threaded into the supervised group at compile time: a rank
        # whose upstream failed leaves its peers to fail THIS iteration
        # at the group's op timeout, not hang the exec loops
        self.timeout_s = timeout_s
        self.group_name = f"dag_collective_{uuid.uuid4().hex[:12]}"

    @property
    def world_size(self) -> int:
        return len(self.inputs)


class CollectiveNode(DAGNode):
    """Rank ``index``'s output of a joint collective op.  Lives on the same
    actor as its input node (reference ``CollectiveOutputNode``)."""

    def __init__(self, group: _CollectiveGroup, index: int):
        super().__init__((group.inputs[index],), {})
        self.group = group
        self.index = index
        self.method_name = f"__collective_{group.op}__"

    @property
    def actor(self):
        return self.group.inputs[self.index].actor

    @property
    def input_node(self) -> ClassMethodNode:
        return self.group.inputs[self.index]

    def __repr__(self):
        return (f"CollectiveNode({self.group.op}, rank={self.index}/"
                f"{self.group.world_size})")


class _CollectiveBinder:
    """``allreduce.bind([n0, n1, ...], op=..., backend=...)``."""

    def __init__(self, kind: str):
        self.kind = kind

    def bind(self, nodes: List[ClassMethodNode], *, op: str = "sum",
             backend: str = "tcp", timeout_s: Optional[float] = None,
             transport: Optional[Any] = None,
             devices: Optional[List[Any]] = None) -> List[CollectiveNode]:
        del transport  # custom Communicators select via backend string
        if self.kind == "allreduce":
            if op not in ("sum", "prod", "min", "max"):
                raise ValueError(
                    f"unsupported reduce op {op!r}: expected one of "
                    f"sum/prod/min/max")
            kind = f"allreduce_{op}"
        else:
            kind = self.kind
        group = _CollectiveGroup(nodes, kind, backend, timeout_s=timeout_s,
                                 devices=devices)
        return [CollectiveNode(group, i) for i in range(len(nodes))]


allreduce = _CollectiveBinder("allreduce")
allgather = _CollectiveBinder("allgather")
reducescatter = _CollectiveBinder("reducescatter")


def run_collective(kind: str, value, group_name: str):
    """Execute one collective op inside an actor's exec loop."""
    from ray_tpu_torch.util.collective import collective as coll
    from ray_tpu_torch.util.collective.types import ReduceOp

    if kind.startswith("allreduce_"):
        op = {"sum": ReduceOp.SUM, "prod": ReduceOp.PRODUCT,
              "min": ReduceOp.MIN, "max": ReduceOp.MAX}[
                  kind[len("allreduce_"):]]
        return coll.allreduce(value, group_name=group_name, op=op)
    if kind == "allgather":
        return coll.allgather(value, group_name=group_name)
    if kind == "reducescatter":
        return coll.reducescatter(value, group_name=group_name)
    raise ValueError(f"unknown collective kind {kind!r}")
