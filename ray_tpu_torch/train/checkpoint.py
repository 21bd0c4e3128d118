"""Directory-based checkpoints (counterpart of ``ray_tpu/train/checkpoint.py``;
parity: ``ray.train.Checkpoint``, ``python/ray/train/_checkpoint.py``),
with tensor-tree save and load in place of the reference's orbax pytree
helpers.

``Checkpoint.from_state_dict`` is the counterpart of ``from_pytree``,
which fetches the whole tree to the host: each DTensor is gathered whole
(``full_tensor()``) and rank 0 writes the host tree with ``torch.save``.
``to_state_dict`` is the counterpart of ``to_pytree``: it loads the tree
and, given a ``target``, places each tensor on the target's device and,
for a DTensor, its mesh and placements.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import uuid
from typing import Any, Iterator, Optional

STATE_FILE = "state.pt"


class Checkpoint:
    """A checkpoint is a directory; this class is a handle to it."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize the checkpoint at ``path`` with the same
        tmp+fsync+rename commit discipline as the checkpoint manager: a
        process crashing mid-copy leaves only a ``<path>.tmp`` staging
        dir, never a restore-shaped torn directory at ``path``.  An
        existing ``path`` is atomically replaced only when empty; a
        non-empty one is merged into, after the staging step."""
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        from ray_tpu_torch.train.checkpoint_manager import (_fsync_dir,
                                                            _fsync_tree)

        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(self.path, tmp)
        _fsync_tree(tmp)
        if os.path.isdir(path) and os.listdir(path):
            shutil.copytree(tmp, path, dirs_exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            if os.path.isdir(path):
                os.rmdir(path)
            os.rename(tmp, path)
        _fsync_dir(parent)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    # --- tensor trees -------------------------------------------------------
    @classmethod
    def from_state_dict(cls, tree: Any,
                        path: Optional[str] = None) -> "Checkpoint":
        """Save a tree (dicts, lists and tuples of tensors, DTensors and
        plain values) to ``path`` (default a new directory under the temp
        dir).  In a process group of several ranks every rank calls this
        together: the DTensors are gathered whole on every rank, rank 0
        chooses the path and writes, and all return once it is written."""
        import torch
        import torch.distributed as dist

        group = dist.is_initialized() and dist.get_world_size() > 1
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                f"rtpu-ckpt-{uuid.uuid4().hex[:12]}")
            if group:
                chosen = [path]
                dist.broadcast_object_list(chosen, src=0)
                path = chosen[0]
        host = _tree_map(_to_host, tree)
        if not group or dist.get_rank() == 0:
            os.makedirs(path, exist_ok=True)
            torch.save(host, os.path.join(path, STATE_FILE))
        if group:
            dist.barrier()
        return cls(path)

    def to_state_dict(self, target: Any = None) -> Any:
        """Load the tree; with ``target`` (a tree of the same structure),
        each tensor goes to its target's device, and onto a DTensor
        target's mesh and placements (every rank loads the whole tree
        and keeps its shards, without communication)."""
        import torch

        tree = torch.load(os.path.join(self.path, STATE_FILE),
                          map_location="cpu", weights_only=True)
        return tree if target is None else _place_like(tree, target)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_host(x):
    import torch

    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.cpu()


def _place_like(x, target):
    import torch

    if isinstance(x, dict):
        return {k: _place_like(v, target[k]) if k in target else v
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_place_like(v, t) for v, t in zip(x, target))
    if not isinstance(x, torch.Tensor) or not isinstance(target,
                                                         torch.Tensor):
        return x
    if hasattr(target, "placements"):
        from ray_tpu_torch.parallel.sharding import distribute

        return distribute(x.to(target.to_local().device),
                          target.device_mesh, target.placements)
    return x.to(target.device)
