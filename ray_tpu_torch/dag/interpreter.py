"""Interpreted DAG execution (counterpart of
``ray_tpu/dag/interpreter.py``): every node becomes an actor call or a
remote function call whose arguments are the upstream refs, which the
call resolves before it runs (``ray_tpu_torch.actor``)."""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)


class _WholeInput:
    """Marks the raw multi-arg input; consuming it whole is an error (same
    semantics as the compiled path)."""

    def __init__(self, args, kwargs):
        self.args = args
        self.kwargs = kwargs


def execute_interpreted(root: DAGNode, args, kwargs):
    results: Dict[int, Any] = {}

    def resolve(v):
        if not isinstance(v, DAGNode):
            return v
        out = results[id(v)]
        if isinstance(out, _WholeInput):
            raise TypeError(
                "DAG input consumed whole but execute() got multiple args; "
                "bind inp[i]/inp.key instead")
        return out

    for node in root._collect():
        if isinstance(node, InputNode):
            if len(args) == 1 and not kwargs:
                results[id(node)] = args[0]
            else:
                results[id(node)] = _WholeInput(args, kwargs)
        elif isinstance(node, InputAttributeNode):
            key = node.key
            results[id(node)] = (
                kwargs[key] if isinstance(key, str) else args[key])
        elif isinstance(node, ClassMethodNode):
            a = [resolve(x) for x in node._bound_args]
            kw = {k: resolve(v) for k, v in node._bound_kwargs.items()}
            method = getattr(node.actor, node.method_name)
            if node.options:
                method = method.options(**node.options)
            results[id(node)] = method.remote(*a, **kw)
        elif isinstance(node, FunctionNode):
            a = [resolve(x) for x in node._bound_args]
            kw = {k: resolve(v) for k, v in node._bound_kwargs.items()}
            results[id(node)] = node.remote_function.remote(*a, **kw)
        elif isinstance(node, MultiOutputNode):
            results[id(node)] = [resolve(o) for o in node.outputs]
        else:
            raise TypeError(f"unknown DAG node type {type(node)}")
    out = results[id(root)]
    # Plain input passthrough isn't a ref; wrap for a uniform return type.
    if isinstance(root, (InputNode, InputAttributeNode)):
        from ray_tpu_torch import actor

        return actor.put(out)
    return out
