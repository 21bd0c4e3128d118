"""Duration sinks: the part of ``ray_tpu/_private/tracing.py`` that
attributes wall time to a training step's buckets.

Work that waits (a supervised collective op) calls
:func:`note_duration`; a ``StepLedger`` inside a step registers a sink
and books the seconds to the named bucket, so the loop needs no changes
for its ``collective_wait`` time to show.  The reference's spans and
trace files are not ported.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_lock = threading.Lock()
_sinks: Dict[int, Callable[[str, float], None]] = {}
_token = 0


def register_duration_sink(fn: Callable[[str, float], None]) -> int:
    """Register ``fn(bucket, seconds)``; returns a token for
    :func:`unregister_duration_sink`."""
    global _token
    with _lock:
        _token += 1
        _sinks[_token] = fn
        return _token


def unregister_duration_sink(token: int) -> None:
    with _lock:
        _sinks.pop(token, None)


def note_duration(bucket: str, seconds: float) -> None:
    """Attribute ``seconds`` of wall time to ``bucket`` in every registered
    sink.  One dict check when nothing is registered."""
    if not _sinks:
        return
    with _lock:
        sinks = list(_sinks.values())
    for fn in sinks:
        try:
            fn(bucket, seconds)
        except Exception:  # noqa: BLE001 — attribution must never fail work
            pass
