"""This node's resources, with its GPUs (counterpart of
``default_resources`` in ``ray_tpu/_private/node.py``; a worker's GPU
demand is ``ScalingConfig.worker_resources()``'s ``"GPU"``, as the
reference's ``num_gpus`` option maps to it).

The reference counts TPU chips from ``/dev/accel*`` (or through jax);
the port counts CUDA devices through ``torch.cuda.device_count()``,
which honours ``CUDA_VISIBLE_DEVICES``, and probes nothing else.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def detect_gpus() -> int:
    """CUDA devices visible to this process (0 without CUDA)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


def _detect_memory_bytes() -> int:
    """Half of the host's memory, as the reference advertises it."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) * 1024 // 2
    except (OSError, ValueError, IndexError):
        pass
    return 4 * 1024**3


def default_resources(num_cpus: Optional[float] = None,
                      num_gpus: Optional[float] = None) -> Dict[str, float]:
    """This node's resources: ``{"CPU", "GPU", "memory"}`` (``GPU`` left
    out when there is none, as the reference leaves out ``TPU``)."""
    if num_cpus is None:
        num_cpus = float(max(os.cpu_count() or 1, 4))
    resources = {"CPU": float(num_cpus)}
    if num_gpus is None:
        num_gpus = float(detect_gpus())
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    resources["memory"] = float(_detect_memory_bytes())
    return resources

