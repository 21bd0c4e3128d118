"""A forked child's entry (counterpart of ``ray_tpu/_private/worker_proc.py``).

A child the worker zygote forks runs ``enter`` first of all: it is
unpickled from the start's preparation data before
``multiprocessing.spawn.prepare`` carries the starter's working
directory, ``sys.path`` and ``__main__``, and before the target's module
is imported.  So before anything can read the environment or touch CUDA,
the child is what a spawned one would be: the starter's environment as
it was at ``start()`` (a forked child holds the zygote's), the default
SIGINT and SIGTERM handlers, a fresh seed for numpy's global generator
(a fork shares the zygote's; ``random`` reseeds itself after a fork),
and the zygote for its own starts.  The card is bound by the target,
after start, as each start site already does.
"""

from __future__ import annotations

import os
import signal
import sys
from typing import Dict, Optional


def enter(env: Dict[str, str], zygote: Optional[tuple]) -> None:
    os.environ.clear()
    os.environ.update(env)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    if "numpy.random" in sys.modules:
        sys.modules["numpy.random"].seed()
    if zygote is not None and zygote[0] is not None:
        from ray_tpu_torch._private import worker_zygote

        worker_zygote.inherit(zygote)
