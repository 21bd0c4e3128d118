"""Cross-thread queue handoff helpers: the bounded-blocking contract
(a copy of ``ray_tpu/_private/concurrency.py``).

Every producer/consumer pair in this repo that rendezvouses over a
``queue.Queue`` has the same two failure edges (raylint's
``bounded-blocking`` rule):

- the **consumer** must not block forever on a producer that died
  without delivering its sentinel (hard interpreter teardown, a bug in
  the producer's ``finally``);
- the **producer** must not block forever on a bounded queue whose
  consumer was abandoned (nobody will ever drain it).

These are the shared, race-checked implementations — sites should use
them instead of hand-rolling the loops (four near-identical copies
predated this module and each would have needed the same TOCTOU fix).
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Optional


class ProducerDiedError(RuntimeError):
    """The producer thread died without delivering its sentinel."""


def get_live(q: "_queue.Queue", producer: Optional[threading.Thread], *,
             timeout: float = 5.0, what: str = "producer"):
    """Blocking ``Queue.get`` with a producer-liveness backstop.

    Blocks as long as the producer is alive; once it is observed dead,
    drains one more item before declaring truncation — the producer may
    have delivered its sentinel and exited between the ``Empty`` timeout
    and the liveness read (the TOCTOU edge).
    """
    while True:
        try:
            return q.get(timeout=timeout)
        except _queue.Empty:
            if producer is None or producer.is_alive():
                continue
            try:
                return q.get_nowait()
            except _queue.Empty:
                raise ProducerDiedError(
                    f"{what} thread died without its sentinel; the "
                    f"stream was truncated") from None


def put_unless_stopped(q: "_queue.Queue", item,
                       stop: threading.Event, *,
                       poll_s: float = 0.1) -> bool:
    """Bounded ``Queue.put`` that gives up once ``stop`` is set.

    Returns True if the item was delivered, False if the handoff was
    abandoned.  The put is always *attempted* first — a settable queue
    slot beats the stop flag, so a consumer that raced its stop signal
    against the producer's last item (typically the sentinel) still
    receives it; only a full queue with ``stop`` set means the consumer
    is truly gone.  The poll keeps the producer within ``poll_s`` of
    its stop-check, so an abandoned consumer can never wedge it.
    """
    while True:
        try:
            q.put(item, timeout=poll_s)
            return True
        except _queue.Full:
            if stop.is_set():
                return False
