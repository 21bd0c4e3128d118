"""POSIX shared-memory segments that the resource tracker does not own.

Counterpart of ``open_shm`` in ``ray_tpu/_private/object_store.py``.  A
segment's lifetime belongs to whoever created it (a channel's writer),
not to Python's ``resource_tracker``: a tracked segment would be unlinked
when any process that attached it exits, under a reader still using it.
Python 3.13 has ``SharedMemory(track=False)``; on 3.12 the tracker's
register/unregister calls are suppressed around the constructor and
``unlink`` instead.  That suppression patches the process-wide tracker
functions for those calls, so another thread creating its own segment in
exactly that window would go untracked: a narrow race with no cleaner
seam before ``track=``.
"""

from __future__ import annotations

import inspect
import threading
from typing import Optional
from multiprocessing import resource_tracker, shared_memory

# RLock: 3.12's SharedMemory.__init__ calls self.unlink() in its own
# OSError handler (a full /dev/shm), re-entering the patched unlink while
# __init__ still holds the lock
_track_lock = threading.RLock()


class _UntrackedSharedMemory(shared_memory.SharedMemory):
    """Python <= 3.12: registration and unregistration suppressed."""

    def __init__(self, *args, **kwargs):
        with _track_lock:
            orig = resource_tracker.register
            resource_tracker.register = lambda *_a, **_k: None
            try:
                super().__init__(*args, **kwargs)
            finally:
                resource_tracker.register = orig

    def unlink(self):
        with _track_lock:
            orig = resource_tracker.unregister
            resource_tracker.unregister = lambda *_a, **_k: None
            try:
                super().unlink()
            finally:
                resource_tracker.unregister = orig


if "track" in inspect.signature(shared_memory.SharedMemory.__init__).parameters:
    def open_shm(*args, **kwargs) -> shared_memory.SharedMemory:
        return shared_memory.SharedMemory(*args, track=False, **kwargs)
else:
    open_shm = _UntrackedSharedMemory


# -- segments registered in the run's store ------------------------------------
#
# A segment whose writer may die before it unlinks (a weight-sync payload,
# a checkpoint shard held in peer RAM) is registered in the run's
# key-value store under ``shm/<name>``, with its owner as the value; the
# train controller sweeps every registered segment at the end of ``fit()``
# (the store dies with it, and with it every way to find the segment).

_REGISTRY = "shm/"


def register_segment(kv, name: str, owner: str = "") -> None:
    """Record segment ``name`` (owned by ``owner``) in the run store
    ``kv`` (a no-op without one)."""
    if kv is not None:
        kv.put(_REGISTRY + name, owner.encode())


def unlink_segment(name: str, kv=None) -> None:
    """Unlink segment ``name`` if it still exists, and drop its record."""
    try:
        seg = open_shm(name=name)
    except FileNotFoundError:
        pass
    else:
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
    if kv is not None:
        try:
            kv.delete(_REGISTRY + name)
        except Exception:  # noqa: BLE001 — the store may be gone
            pass


def sweep_segments(kv, owner: Optional[str] = None) -> int:
    """Unlink every segment registered in ``kv`` (only ``owner``'s when
    given); returns how many records were swept."""
    n = 0
    for key in kv.keys(_REGISTRY):
        if owner is not None and (kv.get(key) or b"").decode() != owner:
            continue
        unlink_segment(key[len(_REGISTRY):], kv)
        n += 1
    return n
