"""Collective/compute overlap: the port's counterpart of
``ray_tpu/parallel/overlap.py``.

With FSDP/TP layouts every step issues weight all-gathers, gradient
reduce-scatters and all-reduces.  Whether NCCL's kernels can run beside
the compute they feed is decided by settings that CUDA and PyTorch's
NCCL process group read once, when the CUDA context and the process
group form; the reference arms XLA's async collectives and
latency-hiding scheduler through ``LIBTPU_INIT_ARGS`` the same way,
before backend init.

Mechanics and safety, as the reference's:

- arming is **opt-in** (``RAY_TPU_COLLECTIVE_OVERLAP=1``) and further
  gated on the process being headed for CUDA (a torch built for CUDA,
  with cards not hidden by ``CUDA_VISIBLE_DEVICES``);
- the flags are environment variables, set before the context and the
  process group form; a process whose CUDA context already exists still
  hands them to the processes it starts (each reads them at its own
  init), which is how ``chip_smoke.py``'s ``mesh4`` uses them;
- idempotent, and a flag the operator set explicitly (``0``/``false``
  included) is never overridden;
- the default stays inert: no measurement on the card has yet compared
  an armed four-card step with an unarmed one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

#: the overlap set: environment variable -> the value armed
OVERLAP_CUDA_FLAGS: Dict[str, str] = {
    # ProcessGroupNCCL creates its communication streams with high
    # priority, so the block scheduler dispatches NCCL's blocks ahead of
    # compute blocks already queued, and a collective starts as soon as
    # it is issued instead of after the compute queued before it
    # (``TORCH_NCCL_HIGH_PRIORITY``, read when the group forms)
    "TORCH_NCCL_HIGH_PRIORITY": "1",
    # the number of hardware work queues the CUDA driver maps a context's
    # streams onto (8 by default): with more, the NCCL stream and the
    # compute streams do not share a queue, whose in-order dispatch
    # would serialize kernels that have no dependency (read when the
    # context is created)
    "CUDA_DEVICE_MAX_CONNECTIONS": "32",
    # ProcessGroupNCCL keeps an async collective's tensors alive by
    # stashing them until its wait, not by ``recordStream`` on the
    # communication stream, so the caching allocator hands their blocks
    # back to the compute stream without waiting on the collective (read
    # when the group forms)
    "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
}

ENV_OPT_IN = "RAY_TPU_COLLECTIVE_OVERLAP"

_OFF = ("false", "0", "no", "")


def overlap_requested(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return env.get(ENV_OPT_IN, "").strip().lower() in ("1", "true", "yes")


def _expects_cuda(env) -> bool:
    """Conservative, as the reference's ``_expects_tpu``: a torch built
    for CUDA, and ``CUDA_VISIBLE_DEVICES`` not set to hide every card.
    Touches no CUDA API, so it creates no context."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        return False
    try:
        import torch

        return torch.version.cuda is not None
    except Exception:  # noqa: BLE001 — probe only
        return False


def _enabled(name: str, value: str) -> bool:
    value = value.strip().lower()
    if name == "CUDA_DEVICE_MAX_CONNECTIONS":  # a count, not a switch
        return value.isdigit() and int(value) >= int(
            OVERLAP_CUDA_FLAGS[name])
    return value not in _OFF


def _flag_states(env) -> dict:
    """The overlap flags set in ``env`` -> {name: enabled}: a boolean flag
    is enabled unless ``0``/``false``/``no``/empty, a count when it is at
    least the armed value."""
    return {name: _enabled(name, env[name]) for name in OVERLAP_CUDA_FLAGS
            if name in env}


def ensure_collective_overlap(env: Optional[dict] = None) -> bool:
    """Set the overlap flags in ``env`` (default ``os.environ``) when the
    operator opted in (``RAY_TPU_COLLECTIVE_OVERLAP=1``) and this process
    is headed for CUDA.

    Must run before the CUDA context and the NCCL group form in the
    processes that should overlap (this one, or the ones it starts
    after the call).  Idempotent: a flag already set is left as it is,
    whatever its value.  Returns True when the whole overlap set is in
    force in ``env`` after the call; ``chip_smoke.py`` records it."""
    env = os.environ if env is None else env
    if not overlap_requested(env):
        return overlap_active(env)
    if not _expects_cuda(env):
        return False
    for name, value in OVERLAP_CUDA_FLAGS.items():
        if name not in env:
            env[name] = value
    return overlap_active(env)


def overlap_active(env: Optional[dict] = None) -> bool:
    """True when every overlap flag is set AND enabled in ``env``
    (however it got there: this module, or the operator's own env)."""
    env = os.environ if env is None else env
    states = _flag_states(env)
    return all(states.get(name) for name in OVERLAP_CUDA_FLAGS)
