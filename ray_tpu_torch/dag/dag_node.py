"""DAG node types: lazy call graphs over tasks and actor methods
(counterpart of ``ray_tpu/dag/dag_node.py``).

Two execution modes:
- **interpreted** ``dag.execute(*args)``: walks the graph submitting
  actor calls (``ray_tpu_torch.actor``) and remote functions, every edge
  a pickled value through the driver;
- **compiled** ``dag.experimental_compile()``: shm channels per edge and
  a standing exec loop in each actor process (``compiled_dag.py``), no
  call per node on the hot path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: a lazily-evaluated call with possibly-DAG args."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -- traversal ---------------------------------------------------------
    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def _collect(self) -> List["DAGNode"]:
        """All reachable nodes, topo-ordered (upstream before downstream)."""
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen[id(n)] = n
            for u in n._upstream():
                visit(u)
            order.append(n)

        visit(self)
        return order

    # -- execution ---------------------------------------------------------
    def execute(self, *args, **kwargs):
        """Interpreted execution; returns ref(s) for this node."""
        from ray_tpu_torch.dag.interpreter import execute_interpreted

        return execute_interpreted(self, args, kwargs)

    def experimental_compile(
        self,
        *,
        buffer_size_bytes: int = 1 << 20,
        submit_timeout: float = 30.0,
        enable_asyncio: bool = False,
    ):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        if enable_asyncio:
            raise NotImplementedError(
                "enable_asyncio is not supported yet; use execute() + "
                "ref.get() from a thread")
        dag = CompiledDAG(self, buffer_size_bytes=buffer_size_bytes,
                          submit_timeout=submit_timeout)
        dag._compile()
        return dag

    def __reduce__(self):
        raise TypeError("DAG nodes are not serializable; compile or execute them")


class InputNode(DAGNode):
    """The DAG's input placeholder; context manager like the reference's.

    ``with InputNode() as inp:`` — ``inp`` stands for the (single) execute
    arg; ``inp[i]`` / ``inp.key`` address positional/keyword args of
    ``execute`` (reference ``InputAttributeNode``).
    """

    _current: Optional["InputNode"] = None
    _lock = threading.Lock()

    def __init__(self):
        super().__init__((), {})
        self._attrs: Dict[Any, "InputAttributeNode"] = {}

    def __enter__(self) -> "InputNode":
        InputNode._lock.acquire()
        InputNode._current = self
        return self

    def __exit__(self, *exc):
        InputNode._current = None
        InputNode._lock.release()
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return self._attr(key)

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        return self._attr(key)

    def _attr(self, key) -> "InputAttributeNode":
        if key not in self._attrs:
            self._attrs[key] = InputAttributeNode(self, key)
        return self._attrs[key]


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self.key = key

    @property
    def parent(self) -> InputNode:
        return self._bound_args[0]


class ClassMethodNode(DAGNode):
    """A bound actor-method call."""

    def __init__(self, actor_handle, method_name: str, args, kwargs,
                 options: Optional[Dict[str, Any]] = None):
        super().__init__(args, kwargs)
        self.actor = actor_handle
        self.method_name = method_name
        self.options = dict(options or {})

    def __repr__(self):
        return (f"ClassMethodNode({self.actor._class_name}."
                f"{self.method_name})")


class FunctionNode(DAGNode):
    """A bound task call (interpreted mode only, like the reference)."""

    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self.remote_function = remote_function

    def __repr__(self):
        return f"FunctionNode({self.remote_function.__name__})"


class MultiOutputNode(DAGNode):
    """Aggregates several terminal nodes; execute/get returns a list."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    @property
    def outputs(self) -> List[DAGNode]:
        return list(self._bound_args)
