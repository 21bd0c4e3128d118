"""Implicit DTensor redistributes, counted: the port's counterpart of
``ray_tpu/parallel/xla_warnings.py``.

The reference counts the layout transitions XLA's SPMD partitioner had
to invent ("involuntary full rematerialization"), which it reports on
fd 2.  Under DTensor the same fault is an **implicit redistribute**: an
op whose inputs' placements its sharding rule cannot take as they are,
so DTensor's op dispatch redistributes them first (an all-gather, an
all-to-all, a reduce of a ``Partial``) without the model asking.  A
layout change the code asks for, through ``DTensor.redistribute`` and
the logical constraints of ``parallel/sharding.py``, is explicit and is
not counted, nor is the backward of such a call.

The hook wraps the one place DTensor's dispatch reshards an argument:
``torch.distributed.tensor._dispatch``'s ``redistribute_local_tensor``,
called from ``OpDispatcher.redistribute_local_args`` (whose op schema
names the op).  Both are private API; :func:`attach` checks that both
exist, on torch 2.11 and 2.13 alike, and raises where they do not, so a
count never reads 0 because nothing was listening.  The wrappers are
installed once per process and record only inside a capture.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator, List, Union

import torch

#: the prefix of one recorded line: one implicit redistribute of one
#: argument of one op
MARKER = "implicit redistribute:"

_lock = threading.Lock()
_active: List[Dict] = []   # the open captures, innermost last
_local = threading.local()  # the op whose arguments are being resharded
_attached = False


def _op_name(schema) -> str:
    op = getattr(schema, "op", None)
    return str(op) if op is not None else "?"


def attach() -> None:
    """Install the wrappers around DTensor's implicit resharding (once
    per process).  Raises ``RuntimeError`` where this torch's DTensor
    has no such hook points."""
    global _attached
    with _lock:
        if _attached:
            return
        try:
            from torch.distributed.tensor import _dispatch
        except ImportError as e:
            raise RuntimeError(
                "implicit redistribute count: this torch has no "
                f"torch.distributed.tensor._dispatch ({e})") from e
        reshard = getattr(_dispatch, "redistribute_local_tensor", None)
        dispatcher = getattr(_dispatch, "OpDispatcher", None)
        local_args = (None if dispatcher is None else
                      dispatcher.__dict__.get("redistribute_local_args"))
        if reshard is None or not isinstance(local_args, staticmethod):
            raise RuntimeError(
                "implicit redistribute count: DTensor's dispatch has no "
                "redistribute_local_tensor / static OpDispatcher."
                "redistribute_local_args to attach to (torch "
                f"{torch.__version__}); the count would read 0 unheard")
        args_fn = local_args.__func__

        def redistribute_local_args(op_info, suggested_input_schema,
                                    *rest, **kw):
            prev = getattr(_local, "op", None)
            _local.op = _op_name(suggested_input_schema)
            try:
                return args_fn(op_info, suggested_input_schema, *rest, **kw)
            finally:
                _local.op = prev

        def redistribute_local_tensor(local_tensor, current_spec,
                                      target_spec, *rest, **kw):
            if _active:
                _record(getattr(_local, "op", None) or "?",
                        current_spec, target_spec)
            return reshard(local_tensor, current_spec, target_spec, *rest,
                           **kw)

        dispatcher.redistribute_local_args = staticmethod(
            redistribute_local_args)
        _dispatch.redistribute_local_tensor = redistribute_local_tensor
        _attached = True


def _placements(spec) -> str:
    return "(" + ", ".join(str(p) for p in getattr(spec, "placements", ())
                           ) + ")"


def _record(op: str, src, dst) -> None:
    line = f"{MARKER} {op} {_placements(src)} -> {_placements(dst)}"
    with _lock:
        for cap in _active:
            cap["lines"].append(line)


def count_implicit_redistributes(text: Union[str, Iterable[str]]) -> int:
    """Number of implicit-redistribute lines in ``text`` (a string or its
    lines), as a capture records them."""
    lines = text.splitlines() if isinstance(text, str) else text
    return sum(1 for line in lines if line.startswith(MARKER))


@contextlib.contextmanager
def redistribute_capture() -> Iterator[Dict]:
    """Count the implicit redistributes DTensor's dispatch runs in this
    process inside the scope (the counterpart of
    ``sharding_warning_capture``).  Yields a dict that gains ``"count"``
    and ``"ops"`` (each redistribute's op name, in order) on exit, and
    holds ``"lines"`` as they come::

        with redistribute_capture() as r:
            state, metrics = trainer.step(state, batch)
        assert r["count"] == 0, r["lines"]

    Captures nest; each sees every redistribute inside it."""
    attach()
    cap: Dict = {"lines": []}
    with _lock:
        _active.append(cap)
    try:
        yield cap
    finally:
        with _lock:
            _active.remove(cap)
        cap["count"] = count_implicit_redistributes(cap["lines"])
        cap["ops"] = [line[len(MARKER):].split()[0] for line in cap["lines"]]
