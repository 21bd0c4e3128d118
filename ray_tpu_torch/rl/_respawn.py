"""Shared respawn-or-drop accounting for groups of runner processes
(counterpart of ``ray_tpu/rl/_respawn.py``, numpy-free and jax-free as
there).

Both rollout planes (``EnvRunnerGroup`` for gym env runners, and the
generation group of the RLHF loop, ``rlhf.RolloutGroup``) settle dead members
the same way: respawn while a bounded budget lasts, past it drop the member
with a logged count and keep operating at reduced strength.  One
implementation so a fix to the pattern reaches both planes (the same
reasoning as ``_private/concurrency.py`` for the liveness loops).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List

logger = logging.getLogger(__name__)


class RespawnBudget:
    """Tracks respawns-remaining and dropped-member counts for a group.

    ``replace(survivors, n_dead, spawn)`` appends one ``spawn()`` result
    per dead slot while the budget lasts; past it the member is dropped
    (counted + logged) and the group shrinks."""

    def __init__(self, budget: int, what: str = "runner",
                 respawn_note: str = ""):
        self.respawns_left = budget
        self.dropped = 0
        self.what = what
        self.respawn_note = respawn_note

    def replace(self, survivors: List[Any], n_dead: int,
                spawn: Callable[[], Any]) -> List[Any]:
        for _ in range(n_dead):
            if self.respawns_left > 0:
                self.respawns_left -= 1
                survivors.append(spawn())
                logger.warning(
                    "respawned dead %s (%d respawns left)%s",
                    self.what, self.respawns_left, self.respawn_note)
            else:
                self.dropped += 1
                logger.error(
                    "respawn budget exhausted — dropping the %s "
                    "(%d dropped so far)", self.what, self.dropped)
        return survivors
