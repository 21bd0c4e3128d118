"""Small networking helpers shared by rendezvous paths (counterpart of
``ray_tpu/_private/net.py``).

The port reaches one node, so every rendezvous binds the loopback
address.  The reference's ``local_ip`` is not copied: it finds the
routable address by a route lookup towards an outside host, which a
single-node run never needs.
"""

from __future__ import annotations

import socket

LOOPBACK = "127.0.0.1"


def free_port() -> int:
    """A currently-free TCP port on the loopback address (best-effort:
    released before use, so another process may take it first)."""
    s = socket.socket()
    s.bind((LOOPBACK, 0))
    try:
        return s.getsockname()[1]
    finally:
        s.close()


def address_in_use(error) -> bool:
    """True when ``error`` (an exception or its text) says a bind found
    its port taken (``EADDRINUSE``)."""
    text = str(error).lower()
    return "eaddrinuse" in text or "address already in use" in text
