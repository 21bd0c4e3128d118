"""Workflow execution: checkpointed step-by-step DAG runs (counterpart of
``ray_tpu/workflow/api.py``).

A workflow walks a DAG of function nodes (``remote(fn).bind(...)``) in
topological order.  Each step's id is a content hash of its function
(module, qualname, bytecode) and of its inputs (the upstream steps' ids
and the constants, by position), so two runs of one DAG give equal ids,
the same ids as the reference's, and a changed step or input changes its
id and every id downstream.  A step whose result is on disk is restored;
any other runs through ``actor.get(fn.remote(...))``: a remote function
of the port runs on a thread pool of the calling process.  Actor steps
are refused, as in the reference.

Storage: ``{root}/{workflow_id}/`` holds ``steps/<step_id>.pkl``,
``input.pkl`` (the first run's arguments, which ``resume`` replays),
``output.pkl`` and ``meta.json`` (status and step counts), each written
to a temporary file and renamed.  The root is ``storage=``, else
``RAY_TPU_WORKFLOW_STORAGE``, else ``~/.ray_tpu_workflows``.
"""

from __future__ import annotations

import concurrent.futures
import enum
import hashlib
import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import actor
from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)


class WorkflowStatus(str, enum.Enum):
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    CANCELED = "CANCELED"
    RESUMABLE = "RESUMABLE"


_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_workflows")


def _storage_root(storage: Optional[str]) -> str:
    return storage or os.environ.get("RAY_TPU_WORKFLOW_STORAGE",
                                     _DEFAULT_STORAGE)


def _wf_dir(workflow_id: str, storage: Optional[str]) -> str:
    return os.path.join(_storage_root(storage), workflow_id)


def _step_id(node: DAGNode, id_of) -> str:
    """Content-addressed step id: the function's identity and bytecode,
    then each argument by position (``f(inp, 1)`` and ``f(1, inp)`` differ):
    an upstream node by its id (``id_of(node)``), a constant by its
    pickle."""
    h = hashlib.sha256()
    if isinstance(node, FunctionNode):
        fn = node.remote_function._fn
        h.update(getattr(fn, "__module__", "").encode())
        h.update(getattr(fn, "__qualname__", "").encode())
        code = getattr(fn, "__code__", None)
        if code is not None:
            h.update(code.co_code)
    else:
        h.update(type(node).__name__.encode())
        h.update(repr(getattr(node, "key", "")).encode())
    slots = [(f"arg{i}", a) for i, a in enumerate(node._bound_args)]
    slots += sorted(((f"kw:{k}", v) for k, v in node._bound_kwargs.items()),
                    key=lambda kv: kv[0])
    for label, a in slots:
        h.update(label.encode())
        if isinstance(a, DAGNode):
            h.update(b"\x00dag:" + id_of(a).encode())
        else:
            try:
                h.update(b"\x00const:" + pickle.dumps(a))
            except (pickle.PicklingError, TypeError, AttributeError):
                h.update(b"\x00const:" + repr(a).encode())
    return h.hexdigest()[:24]


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_meta(wf_dir: str, meta: Dict[str, Any]) -> None:
    _write_atomic(os.path.join(wf_dir, "meta.json"),
                  json.dumps(meta).encode())


def _read_meta(wf_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(wf_dir, "meta.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class _StepStore:
    """One workflow's step results, a pickle per step id."""

    def __init__(self, wf_dir: str):
        self.dir = os.path.join(wf_dir, "steps")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"{step_id}.pkl")

    def has(self, step_id: str) -> bool:
        return os.path.exists(self._path(step_id))

    def load(self, step_id: str) -> Any:
        with open(self._path(step_id), "rb") as f:
            return pickle.load(f)

    def save(self, step_id: str, value: Any) -> None:
        _write_atomic(self._path(step_id), pickle.dumps(value))


def _execute_workflow(dag: DAGNode, args, kwargs, workflow_id: str,
                      storage: Optional[str]) -> Any:
    """Walk the DAG, restoring or running each step and checkpointing
    each result; the meta file ends ``SUCCESSFUL`` with the step counts,
    or ``RESUMABLE`` with the error, which is raised."""
    wf_dir = _wf_dir(workflow_id, storage)
    os.makedirs(wf_dir, exist_ok=True)
    store = _StepStore(wf_dir)
    # the first run's arguments: resume() replays them
    input_path = os.path.join(wf_dir, "input.pkl")
    if os.path.exists(input_path):
        with open(input_path, "rb") as f:
            args, kwargs = pickle.load(f)
    else:
        _write_atomic(input_path, pickle.dumps((args, kwargs)))

    _write_meta(wf_dir, {"status": WorkflowStatus.RUNNING,
                         "workflow_id": workflow_id,
                         "start_time": time.time()})
    results: Dict[int, Any] = {}
    step_ids: Dict[int, str] = {}
    n_restored = n_executed = 0
    try:
        for node in dag._collect():
            if isinstance(node, InputNode):
                results[id(node)] = (args[0] if len(args) == 1 and not kwargs
                                     else (args, kwargs))
                step_ids[id(node)] = hashlib.sha256(
                    pickle.dumps((args, kwargs))).hexdigest()[:24]
                continue
            if isinstance(node, InputAttributeNode):
                key = node.key
                results[id(node)] = (kwargs[key] if isinstance(key, str)
                                     else args[key])
                step_ids[id(node)] = _step_id(node,
                                              lambda n: step_ids[id(n)])
                continue
            if isinstance(node, MultiOutputNode):
                results[id(node)] = [results[id(o)] for o in node.outputs]
                continue
            if not isinstance(node, FunctionNode):
                raise TypeError(
                    f"workflows support task (function) steps; got "
                    f"{type(node).__name__} — wrap actor state in steps")
            sid = _step_id(node, lambda n: step_ids[id(n)])
            step_ids[id(node)] = sid
            if store.has(sid):
                results[id(node)] = store.load(sid)
                n_restored += 1
                continue
            a = [results[id(x)] if isinstance(x, DAGNode) else x
                 for x in node._bound_args]
            kw = {k: results[id(v)] if isinstance(v, DAGNode) else v
                  for k, v in node._bound_kwargs.items()}
            value = actor.get(node.remote_function.remote(*a, **kw))
            store.save(sid, value)
            results[id(node)] = value
            n_executed += 1
    except BaseException as e:
        _write_meta(wf_dir, {"status": WorkflowStatus.RESUMABLE,
                             "workflow_id": workflow_id,
                             "error": repr(e), "end_time": time.time()})
        raise
    output = results[id(dag)]
    _write_atomic(os.path.join(wf_dir, "output.pkl"), pickle.dumps(output))
    _write_meta(wf_dir, {"status": WorkflowStatus.SUCCESSFUL,
                         "workflow_id": workflow_id,
                         "steps_executed": n_executed,
                         "steps_restored": n_restored,
                         "end_time": time.time()})
    return output


def _new_id() -> str:
    return f"wf-{int(time.time() * 1000):x}"


# -- public API --------------------------------------------------------------


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        storage: Optional[str] = None, **kwargs) -> Any:
    """Run a DAG as a durable workflow; blocks until the output is ready."""
    return _execute_workflow(dag, args, kwargs, workflow_id or _new_id(),
                             storage)


def run_async(dag: DAGNode, *args, workflow_id: Optional[str] = None,
              storage: Optional[str] = None, **kwargs):
    """Run on a background thread; returns ``(workflow_id, future)``."""
    workflow_id = workflow_id or _new_id()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(_execute_workflow, dag, args, kwargs, workflow_id,
                      storage)
    pool.shutdown(wait=False)
    return workflow_id, fut


def resume(workflow_id: str, dag: DAGNode, *,
           storage: Optional[str] = None) -> Any:
    """Run a workflow again with its first run's arguments: completed
    steps restore from their checkpoints.  The caller supplies the DAG
    again (the reference's contract); the step ids line the results up."""
    if not os.path.isdir(_wf_dir(workflow_id, storage)):
        raise ValueError(f"no workflow {workflow_id!r}")
    return _execute_workflow(dag, (), {}, workflow_id, storage)


def get_status(workflow_id: str, *, storage: Optional[str] = None
               ) -> Optional[WorkflowStatus]:
    meta = _read_meta(_wf_dir(workflow_id, storage))
    return WorkflowStatus(meta["status"]) if meta else None


def get_metadata(workflow_id: str, *, storage: Optional[str] = None
                 ) -> Optional[Dict[str, Any]]:
    return _read_meta(_wf_dir(workflow_id, storage))


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    path = os.path.join(_wf_dir(workflow_id, storage), "output.pkl")
    if not os.path.exists(path):
        status = get_status(workflow_id, storage=storage)
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status: {status})")
    with open(path, "rb") as f:
        return pickle.load(f)


def list_all(*, storage: Optional[str] = None
             ) -> List[Tuple[str, Optional[WorkflowStatus]]]:
    root = _storage_root(storage)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    out = []
    for d in names:
        meta = _read_meta(os.path.join(root, d))
        out.append((d, WorkflowStatus(meta["status"]) if meta else None))
    return out


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    shutil.rmtree(_wf_dir(workflow_id, storage), ignore_errors=True)
