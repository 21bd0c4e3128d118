"""Faults armed on a node: a fault-injection window for every port
process bound to one card or slot.

Counterpart of the GCS verb ``arm_node_fault`` and the raylet's fault
registry (``ray_tpu/_private/gcs.py:1018``).  The injection registry
(``util/fault_injection.py``) is per process and reads its environment
once, so degrading a unit whose workers already run needs a registry of
its own: the spec goes into the run's key-value store under
``faults/node/<node_id>/<id>``; each worker bound to that unit watches
the key (:func:`start_watcher`) and a probe process started there later
arms it at its start (:func:`arm_pending`), each for what is left of the
window.  Every process that arms a spec acknowledges it under
``faults/ack/<id>/<pid>``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Set

from ray_tpu_torch.util import fault_injection as fi

_PREFIX = "faults/node/"
_ACKS = "faults/ack/"
WATCH_INTERVAL_S = 0.25


def arm_node_fault(kv, node_id: str, site: str, *, start_s: float = 0.0,
                   duration_s: float = 60.0, nth: int = 1,
                   count: int = 1 << 30, exc: str = "slow:3",
                   timeout: float = 5.0, expect: int = 1) -> Dict[str, Any]:
    """Arm ``site`` with ``exc`` (``fault_injection``'s vocabulary:
    ``"slow:3"``, ``"delay:30"``, ``"runtime"``, ...) from ``start_s``
    for ``duration_s`` seconds in every process bound to ``node_id``, of
    the run whose key-value store is ``kv``.  Waits up to ``timeout``
    for ``expect`` processes to acknowledge; returns ``{"armed": n,
    "node_id": node_id}`` with the acknowledgements seen."""
    spec_id = uuid.uuid4().hex[:12]
    spec = {"id": spec_id, "site": site, "start_s": float(start_s),
            "duration_s": float(duration_s), "nth": int(nth),
            "count": int(count), "exc": str(exc), "t": time.time()}
    kv.put(f"{_PREFIX}{node_id}/{spec_id}", json.dumps(spec).encode())
    deadline = time.monotonic() + timeout
    while True:
        acks = kv.keys(f"{_ACKS}{spec_id}/")
        if len(acks) >= expect or time.monotonic() >= deadline:
            return {"armed": len(acks), "node_id": node_id}
        time.sleep(0.05)


def arm_pending(kv, node_id: str, seen: Optional[Set[str]] = None) -> int:
    """Arm in this process every spec for ``node_id`` not in ``seen``
    (which it updates), each for what is left of its window; returns how
    many it armed."""
    seen = set() if seen is None else seen
    armed = 0
    for key in kv.keys(f"{_PREFIX}{node_id}/"):
        if key in seen:
            continue
        seen.add(key)
        raw = kv.get(key)
        if raw is None:
            continue
        spec = json.loads(raw)
        start = spec["t"] + spec["start_s"]
        end = start + spec["duration_s"]
        now = time.time()
        if now >= end:
            continue
        fi.arm_window(spec["site"], max(0.0, start - now),
                      end - max(now, start), nth=spec["nth"],
                      count=spec["count"], exc=spec["exc"])
        kv.put(f"{_ACKS}{spec['id']}/{os.getpid()}", b"1")
        armed += 1
    return armed


def start_watcher(kv_addr: str, node_id: str,
                  interval_s: float = WATCH_INTERVAL_S
                  ) -> Callable[[], None]:
    """Start a daemon thread that arms each new spec for ``node_id`` in
    this process, on a connection of its own to the store at
    ``kv_addr``; returns the call that stops it (before the process
    exits, so that no store operation is cut off by its
    finalisation)."""
    from ray_tpu_torch._private import kv as kv_mod

    stop = threading.Event()

    def watch():
        seen: Set[str] = set()
        kv = None
        while not stop.is_set():
            try:
                if kv is None:
                    kv = kv_mod.connect(kv_addr)
                arm_pending(kv, node_id, seen)
            except Exception:  # noqa: BLE001 — the store may be gone
                kv = None
            stop.wait(interval_s)

    thread = threading.Thread(target=watch, name="node-fault-watcher",
                              daemon=True)
    thread.start()

    def halt():
        stop.set()
        thread.join(timeout=15.0)

    return halt
