"""Failure and scaling policies for the train control loop: a copy of
``ray_tpu/train/policies.py``, whose elastic policy counts this node's
resources (``_private/accelerators.py``) in place of the cluster's.

Parity: Train-v2 ``FailurePolicy``
(``python/ray/train/v2/_internal/execution/failure_handling/failure_policy.py:14``)
and ``ScalingPolicy`` / ``ResizeDecision``
(``.../scaling_policy/scaling_policy.py:29``).  Decisions are made *between*
control-loop steps: a resize means re-forming the mesh, so
every recovery is checkpoint-restore + fresh worker group.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class FailureDecision(enum.Enum):
    RETRY = "RETRY"          # restart the worker group from latest checkpoint
    RAISE = "RAISE"          # surface the error to the driver
    NOOP = "NOOP"


@dataclasses.dataclass
class TrainRunContext:
    errors_seen: int = 0


class FailurePolicy:
    def make_decision(self, ctx: TrainRunContext, error: str) -> FailureDecision:
        raise NotImplementedError


class DefaultFailurePolicy(FailurePolicy):
    """Retry up to ``max_failures`` group restarts (-1 = unlimited)."""

    def __init__(self, max_failures: int = 0):
        self.max_failures = max_failures

    def make_decision(self, ctx: TrainRunContext, error: str) -> FailureDecision:
        if self.max_failures < 0:
            return FailureDecision.RETRY
        if ctx.errors_seen <= self.max_failures:
            return FailureDecision.RETRY
        return FailureDecision.RAISE


@dataclasses.dataclass
class ResizeDecision:
    num_workers: int


class NoopDecision:
    pass


class ScalingPolicy:
    """Consulted by the controller when (re)creating the worker group."""

    def make_decision_for_non_running_worker_group(self, scaling_config):
        raise NotImplementedError

    def make_decision_for_running_worker_group(self, scaling_config):
        return NoopDecision()


class FixedScalingPolicy(ScalingPolicy):
    def make_decision_for_non_running_worker_group(self, scaling_config):
        return ResizeDecision(num_workers=scaling_config.num_workers)


class ElasticScalingPolicy(ScalingPolicy):
    """Size the group to available cluster resources in [min, max] workers.

    Resizes only happen at restart boundaries (mesh re-formation); a
    running group is never resized in place.

    The decision samples ``available_resources`` over a short settle
    window (``settle_s``): at a restart boundary the dying group's leases
    are still being released and a just-dead node's resources still being
    dropped — a single instantaneous sample under-counts (or
    over-counts) the capacity the new group can actually use.  Sampling
    stops early once the max fits.
    """

    def __init__(self, min_workers: int, max_workers: int,
                 resources_per_worker: Optional[dict] = None,
                 settle_s: float = 3.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.resources_per_worker = resources_per_worker
        self.settle_s = settle_s

    def _fit_now(self, res) -> int:
        from ray_tpu_torch._private import accelerators

        avail = accelerators.default_resources()
        fit = self.max_workers
        for k, per in res.items():
            if per <= 0:
                continue
            have = avail.get(k, 0.0)
            fit = min(fit, int(have // per))
        return fit

    def make_decision_for_non_running_worker_group(self, scaling_config):
        import time

        res = self.resources_per_worker or scaling_config.worker_resources()
        deadline = time.monotonic() + self.settle_s
        fit = prev = self._fit_now(res)
        while time.monotonic() < deadline:
            # the LAST sample wins: it reflects both directions of flux
            # (a dead node dropping out of the view corrects an
            # over-count; a released lease corrects an under-count).
            # Early exit only when two consecutive samples agree at the
            # cap — nothing more can appear.
            if fit >= self.max_workers and prev >= self.max_workers:
                break
            time.sleep(0.25)
            prev, fit = fit, self._fit_now(res)
        n = max(self.min_workers, min(self.max_workers, fit))
        return ResizeDecision(num_workers=n)
