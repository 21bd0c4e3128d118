"""Retry with bounded backoff and the retryable-or-fatal classifier: a copy
of ``RetryPolicy``, ``retry_call`` and ``is_retryable`` from
``ray_tpu/_private/resilience.py`` (standard library only, as there).

The RLHF loop's publish and reward legs retry through :func:`retry_call`:
transport loss (``ConnectionError``, ``EOFError``, a plain ``OSError``)
and backend-outage text are retryable; application errors, and timeouts
(a timed-out call may have run), surface on the first throw.  The
reference's raylet-RPC branch and its degradation ladder (``run_staged``)
are not copied: the port has neither.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)


class RetryableTransportError(Exception):
    """A transient transport or backend failure, safe to retry."""


# matched case-insensitively: a backend outage surfaces as text
_RETRYABLE_MARKERS = (
    "unavailable",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "store unreachable",
    "unable to initialize backend",
)

# the config is too big for the backend: retrying the same one is futile
_DEGRADE_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "Out of memory",
    "OOM",
    "exceeds the memory",
    "compile",
    "Compilation",
)


def is_degradable(err: BaseException) -> bool:
    """True iff ``err`` says the configuration is too demanding (an
    out-of-memory or a compile rejection), not that the transport
    hiccupped."""
    msg = str(err)
    if "unable to initialize backend" in msg.lower():
        return False
    return any(m in msg for m in _DEGRADE_MARKERS)


def is_retryable(err: BaseException) -> bool:
    """True iff ``err`` is a transient transport or backend failure."""
    if isinstance(err, RetryableTransportError):
        return True
    if isinstance(err, TimeoutError):
        # an OSError, but a timed-out call may have run: re-issuing it can
        # apply it twice, so the caller owns the deadline
        return False
    if isinstance(err, (ConnectionError, EOFError, BrokenPipeError,
                        OSError)):
        return True
    msg = str(err).lower()
    if any(m in msg for m in _RETRYABLE_MARKERS):
        return not is_degradable(err)
    return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter: attempt ``n`` waits
    ``base * multiplier**(n-1)`` capped at ``max_delay_s``, plus up to
    ``jitter`` of that."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25

    def delay_s(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        d = min(self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
                self.max_delay_s)
        if self.jitter:
            d += d * self.jitter * (rng or _rng).random()
        return d


DEFAULT_POLICY = RetryPolicy()

_rng = random.Random()


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    policy: RetryPolicy = DEFAULT_POLICY,
    classify: Callable[[BaseException], bool] = is_retryable,
    site: str = "",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs: Any,
) -> Any:
    """Call ``fn`` with bounded backoff on retryable errors: a fatal error
    raises at once, a retryable one after ``policy.max_attempts`` tries.
    ``on_retry(attempt, err, delay)`` observes each retry."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classified below
            if not classify(e) or attempt >= policy.max_attempts:
                raise
            d = policy.delay_s(attempt)
            logger.warning("retryable failure at %s (attempt %d/%d, "
                           "retry in %.2fs): %r",
                           site or getattr(fn, "__name__", "?"), attempt,
                           policy.max_attempts, d, e)
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)
