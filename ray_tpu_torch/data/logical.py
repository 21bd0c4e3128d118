"""Logical plan: lazy operator tree + optimizer rules (counterpart of
``ray_tpu/data/logical.py``).

Reference: ``python/ray/data/_internal/logical/interfaces/logical_operator.py``
and the rule set in ``python/ray/data/_internal/logical/rules/`` (notably
``operator_fusion.py``).  A Dataset holds a ``LogicalPlan``; execution
plans it into physical operators (``planner.py`` here) only when an
action runs.  ``Sort``, ``Aggregate`` and ``Join`` wait for their numpy
transforms; a map takes no ``num_cpus`` or ``num_tpus``: the port's
data tasks run on host threads.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional

from ray_tpu_torch.data.context import DataContext


class LogicalOperator:
    def __init__(self, name: str, inputs: List["LogicalOperator"]):
        self.name = name
        self.inputs = inputs

    def __repr__(self):
        return self.name


class Read(LogicalOperator):
    def __init__(self, datasource, parallelism: int = -1):
        super().__init__(f"Read{datasource.name}", [])
        self.datasource = datasource
        self.parallelism = parallelism


class InputData(LogicalOperator):
    """Already-materialized block refs (e.g. from a previous execution)."""

    def __init__(self, ref_bundles):
        super().__init__("InputData", [])
        self.ref_bundles = ref_bundles


class AbstractMap(LogicalOperator):
    """Row/batch transform applied independently per block — fusable."""

    def __init__(self, name: str, input_op: LogicalOperator,
                 fn: Callable, *, fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                 batch_size: Optional[int] = None, batch_format: str = "numpy",
                 compute: Optional[Any] = None, kind: str = "batches"):
        super().__init__(name, [input_op])
        self.fn = fn
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.compute = compute  # None => task pool; ActorPoolStrategy => actors
        self.kind = kind  # "batches" | "rows" | "flat" | "filter"


class MapBatches(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        super().__init__(f"MapBatches({_fn_name(fn)})", input_op, fn,
                         kind="batches", **kw)


class MapRows(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        super().__init__(f"Map({_fn_name(fn)})", input_op, fn, kind="rows", **kw)


class FlatMap(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        super().__init__(f"FlatMap({_fn_name(fn)})", input_op, fn, kind="flat", **kw)


class Filter(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        super().__init__(f"Filter({_fn_name(fn)})", input_op, fn, kind="filter", **kw)


class AbstractAllToAll(LogicalOperator):
    """Barrier ops that need all upstream blocks (shuffle family)."""

    def __init__(self, name: str, input_op: LogicalOperator,
                 num_outputs: Optional[int] = None):
        super().__init__(name, [input_op])
        self.num_outputs = num_outputs


class Repartition(AbstractAllToAll):
    def __init__(self, input_op, num_blocks: int, shuffle: bool = False):
        super().__init__(f"Repartition({num_blocks})", input_op, num_blocks)
        self.shuffle = shuffle


class RandomShuffle(AbstractAllToAll):
    def __init__(self, input_op, seed: Optional[int] = None,
                 num_outputs: Optional[int] = None):
        super().__init__("RandomShuffle", input_op, num_outputs)
        self.seed = seed


class Limit(LogicalOperator):
    def __init__(self, input_op, limit: int):
        super().__init__(f"Limit({limit})", [input_op])
        self.limit = limit


class Union(LogicalOperator):
    def __init__(self, *input_ops):
        super().__init__("Union", list(input_ops))


class Zip(LogicalOperator):
    def __init__(self, left, right):
        super().__init__("Zip", [left, right])


class RandomizeBlocks(LogicalOperator):
    def __init__(self, input_op, seed: Optional[int] = None):
        super().__init__("RandomizeBlocks", [input_op])
        self.seed = seed


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", None) or type(fn).__name__


class LogicalPlan:
    def __init__(self, dag: LogicalOperator):
        self.dag = dag

    def copy_with(self, op_cls, *args, **kwargs) -> "LogicalPlan":
        return LogicalPlan(op_cls(self.dag, *args, **kwargs))

    def explain(self) -> str:
        lines: List[str] = []

        def walk(op: LogicalOperator, depth: int):
            lines.append("  " * depth + f"- {op.name}")
            for child in op.inputs:
                walk(child, depth + 1)

        walk(self.dag, 0)
        return "\n".join(lines)


# -- optimizer --------------------------------------------------------------


def fuse_map_operators(dag: LogicalOperator) -> LogicalOperator:
    """Fuse chains of AbstractMap into a single op so one task applies all
    transforms per block (reference rule: ``logical/rules/operator_fusion.py``).

    Two adjacent maps fuse when neither runs on an actor pool.
    """
    dag = copy.copy(dag)
    dag.inputs = [fuse_map_operators(i) for i in dag.inputs]
    if (isinstance(dag, AbstractMap) and len(dag.inputs) == 1
            and isinstance(dag.inputs[0], AbstractMap)):
        up = dag.inputs[0]
        if dag.compute is None and up.compute is None:
            fused = FusedMap(up, dag)
            fused.inputs = up.inputs
            return fused
    return dag


class FusedMap(AbstractMap):
    def __init__(self, first: AbstractMap, second: AbstractMap):
        chain = []
        for op in (first, second):
            chain.extend(op.chain if isinstance(op, FusedMap) else [op])
        super().__init__(
            "->".join(c.name for c in chain), first.inputs[0] if first.inputs else None,
            fn=None, compute=first.compute, batch_format=first.batch_format,
            batch_size=first.batch_size,
        )
        self.inputs = list(first.inputs)
        self.chain = chain


def optimize(plan: LogicalPlan) -> LogicalPlan:
    ctx = DataContext.get_current()
    dag = plan.dag
    if ctx.enable_operator_fusion:
        dag = fuse_map_operators(dag)
    return LogicalPlan(dag)
