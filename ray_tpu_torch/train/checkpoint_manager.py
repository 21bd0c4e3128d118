"""Top-K checkpoint bookkeeping for a train run: a copy of
``ray_tpu/train/checkpoint_manager.py``.

Parity: ``python/ray/train/_internal/checkpoint_manager.py`` (keep top-K by
score) and ``storage.py`` (persist to run storage dir).

Persistence is CRASH-ATOMIC (the discipline of Orbax emergency
checkpointing, and of the GCS WAL's torn-tail truncation): a checkpoint
is staged into ``checkpoint_NNNNNN.tmp``, fsynced, and committed with a
single ``os.rename`` — a process SIGKILLed mid-write (a preempted
host, the chief failure mode this exists for) can only ever leave a
``*.tmp`` staging dir behind, never a half-written directory that
restore would load.  ``latest_committed_checkpoint`` and the stale-tmp
sweep ignore/remove such torn leftovers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train.checkpoint import Checkpoint

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint_(\d{6,})$")


@dataclasses.dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without dir fds: rename atomicity still holds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(root: str) -> None:
    """fsync every file then every directory under ``root`` so the
    rename-commit publishes fully-durable content (rename alone orders
    the NAME, not the bytes, across a power cut)."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            try:
                fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            except OSError:
                continue
            try:
                os.fsync(fd)
            except OSError:
                pass
            finally:
                os.close(fd)
        _fsync_dir(dirpath)


def committed_checkpoint_dirs(storage_dir: str) -> List[Tuple[int, str]]:
    """(index, abspath) of every COMMITTED checkpoint under
    ``storage_dir``, sorted by index.  Skips ``*.tmp`` staging dirs (a
    crash mid-copy) and anything not matching the committed name pattern
    — the restore-side half of the atomic-commit contract."""
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir(storage_dir)
    except OSError:
        return out
    for name in entries:
        m = _CKPT_RE.match(name)
        if not m:
            continue
        path = os.path.join(storage_dir, name)
        if os.path.isdir(path):
            out.append((int(m.group(1)), os.path.abspath(path)))
    out.sort()
    return out


def latest_committed_checkpoint(storage_dir: str) -> Optional[Checkpoint]:
    """The newest checkpoint a crashed/preempted run durably committed
    (None if there is none).  The resume entry point: pass it as
    ``resume_from_checkpoint`` to continue from where the dead run left
    off with zero risk of loading a torn directory."""
    dirs = committed_checkpoint_dirs(storage_dir)
    return Checkpoint(dirs[-1][1]) if dirs else None


class CheckpointManager:
    def __init__(self, storage_dir: Optional[str], num_to_keep: Optional[int],
                 score_attribute: Optional[str], score_order: str = "max"):
        self.storage_dir = storage_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: List[_Tracked] = []
        self._index = 0
        if storage_dir:
            os.makedirs(storage_dir, exist_ok=True)
            # sweep staging dirs a killed writer left behind, and resume
            # indexing ABOVE existing commits so a restarted run can
            # never overwrite a checkpoint the dead run durably owns
            for name in os.listdir(storage_dir):
                if name.endswith(".tmp") and _CKPT_RE.match(name[:-4]):
                    logger.warning(
                        "removing torn checkpoint staging dir %s "
                        "(writer died mid-commit)", name)
                    shutil.rmtree(os.path.join(storage_dir, name),
                                  ignore_errors=True)
            committed = committed_checkpoint_dirs(storage_dir)
            if committed:
                self._index = committed[-1][0]

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=lambda t: t.index).checkpoint

    @property
    def best(self) -> Optional[Checkpoint]:
        t = self._best_tracked()
        return t.checkpoint if t else None

    def _best_tracked(self) -> Optional[_Tracked]:
        if not self._tracked:
            return None
        if not self.score_attribute:
            return max(self._tracked, key=lambda t: t.index)
        scored = [t for t in self._tracked if self.score_attribute in t.metrics]
        if not scored:
            return max(self._tracked, key=lambda t: t.index)
        key = lambda t: t.metrics[self.score_attribute]  # noqa: E731
        return (max if self.score_order == "max" else min)(scored, key=key)

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> Checkpoint:
        """Persist (if storage configured) and track; evicts beyond top-K.

        The persist is a two-phase commit: stage into ``<dest>.tmp``,
        fsync, rename to ``<dest>``.  Dying anywhere before the rename
        (the ``train.checkpoint.commit`` fault site sits exactly there)
        leaves only a ``.tmp`` dir that restore ignores and the next
        manager sweeps.
        """
        from ray_tpu_torch.util.fault_injection import fault_point

        # adopt-in-place: a checkpoint ALREADY committed inside this
        # manager's storage dir (the tiered sharded writer renames
        # checkpoint_NNNNNN directly into storage) keeps its index and
        # is tracked without a copy — re-copying a multi-gigabyte
        # sharded checkpoint to a second slot would defeat the plane
        if self.storage_dir:
            abspath = os.path.abspath(checkpoint.path)
            m = _CKPT_RE.match(os.path.basename(abspath))
            if m and os.path.dirname(abspath) == \
                    os.path.abspath(self.storage_dir):
                idx = int(m.group(1))
                self._index = max(self._index, idx)
                for t in self._tracked:
                    if t.index == idx:  # already adopted (re-report)
                        return t.checkpoint
                self._tracked.append(
                    _Tracked(checkpoint, dict(metrics), idx))
                self._evict()
                return checkpoint
        self._index += 1
        if self.storage_dir:
            dest = os.path.join(self.storage_dir,
                                f"checkpoint_{self._index:06d}")
            if os.path.abspath(checkpoint.path) != dest:
                # index collision (another writer / a restart race):
                # NEVER delete a committed checkpoint to make room —
                # a crash between its removal and our rename would
                # destroy durable state.  Skip to the next free slot.
                while os.path.exists(dest):
                    self._index += 1
                    dest = os.path.join(
                        self.storage_dir,
                        f"checkpoint_{self._index:06d}")
                tmp = dest + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.copytree(checkpoint.path, tmp)
                _fsync_tree(tmp)
                # the commit point: everything staged + durable, one
                # rename publishes it.  A kill here (chaos tests arm
                # this site, incl. with a real SIGKILL) must never
                # yield a dir restore would load.
                fault_point("train.checkpoint.commit")
                os.rename(tmp, dest)
                _fsync_dir(self.storage_dir)
            checkpoint = Checkpoint(dest)
        self._tracked.append(_Tracked(checkpoint, dict(metrics), self._index))
        self._evict()
        return checkpoint

    def _evict(self) -> None:
        if not self.num_to_keep or len(self._tracked) <= self.num_to_keep:
            return
        # never evict the best or the latest
        keep_ids = set()
        best = self._best_tracked()
        if best:
            keep_ids.add(id(best))
        latest = max(self._tracked, key=lambda t: t.index)
        keep_ids.add(id(latest))
        candidates = sorted(
            (t for t in self._tracked if id(t) not in keep_ids),
            key=lambda t: t.index)
        while len(self._tracked) > self.num_to_keep and candidates:
            victim = candidates.pop(0)
            self._tracked.remove(victim)
            if self.storage_dir and victim.checkpoint.path.startswith(
                    os.path.abspath(self.storage_dir)):
                shutil.rmtree(victim.checkpoint.path, ignore_errors=True)
