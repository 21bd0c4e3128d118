"""ray_tpu_torch.dag: lazy DAGs over process actors, and their compiled
execution (counterpart of ``ray_tpu/dag/``)."""

from ray_tpu_torch.dag.collective_node import (
    CollectiveNode,
    allgather,
    allreduce,
    reducescatter,
)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "DAGNode", "InputNode", "InputAttributeNode", "ClassMethodNode",
    "FunctionNode", "MultiOutputNode", "CompiledDAG", "CompiledDAGRef",
    "CollectiveNode", "allreduce", "allgather", "reducescatter",
]
