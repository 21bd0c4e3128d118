"""This node's resources, with its GPUs (counterpart of
``default_resources`` in ``ray_tpu/_private/node.py``; a worker's GPU
demand is ``ScalingConfig.worker_resources()``'s ``"GPU"``, as the
reference's ``num_gpus`` option maps to it).

The reference counts TPU chips from ``/dev/accel*`` (or through jax,
the probe of ``ray_tpu/_private/node.py``); the port counts CUDA devices
through ``torch.cuda.device_count()`` (``detect_gpus``), which honours
``CUDA_VISIBLE_DEVICES``.  The reference's ``detect_resources``,
``detect_labels`` and ``set_visible_chips``
(``ray_tpu/_private/accelerators.py:114``) have their counterparts here:
the card type as a resource and a label (``GPU-H100``, as the reference
gives ``TPU-v5litepod``), each card's peers (the cards it can reach as a
peer, over NVLink on an H100 board, from
``torch.cuda.can_device_access_peer``), and ``CUDA_VISIBLE_DEVICES`` for
a worker's set of cards.

Every port process on one machine is one node, so the unit the health
plane judges and a worker group places ranks on is smaller: the card a
worker is bound to, ``"cuda:<index>"``, or for host workers the worker
slot, ``"slot:<index>"``.  A worker finds its unit in
``RAY_TPU_TORCH_NODE_ID``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch


def detect_gpus() -> int:
    """CUDA devices visible to this process (0 without CUDA)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


#: the variable that narrows a process to a set of cards
ENV_VISIBLE = "CUDA_VISIBLE_DEVICES"


def accelerator_type() -> str:
    """The card type from card 0's name ("NVIDIA H100 80GB HBM3" ->
    "H100"), or "" without CUDA."""
    if not detect_gpus():
        return ""
    words = torch.cuda.get_device_name(0).split()
    if words and words[0].upper() == "NVIDIA":
        words = words[1:]
    return words[0] if words else ""


def detect_resources() -> Dict[str, float]:
    """This node's accelerator resources: ``{"GPU": n, "GPU-<type>": n}``
    (empty without a card)."""
    n = detect_gpus()
    if not n:
        return {}
    out = {"GPU": float(n)}
    kind = accelerator_type()
    if kind:
        out[f"GPU-{kind}"] = float(n)
    return out


def peer_cards(index: int, count: Optional[int] = None) -> List[int]:
    """The cards card ``index`` can access as a peer."""
    count = detect_gpus() if count is None else count
    return [j for j in range(count)
            if j != index and torch.cuda.can_device_access_peer(index, j)]


def detect_labels() -> Dict[str, str]:
    """This node's topology labels: the card type and count, and per card
    its peers (``gpu-peers-<i>``: a comma list, "" for none); empty
    without a card."""
    n = detect_gpus()
    if not n:
        return {}
    out = {"gpu-type": accelerator_type(), "gpu-count": str(n)}
    for i in range(n):
        out[f"gpu-peers-{i}"] = ",".join(str(j) for j in peer_cards(i, n))
    return out


def set_visible_chips(env: Dict[str, str], chip_ids: List[int]) -> None:
    """Narrow a worker to ``chip_ids`` (its environment's
    ``CUDA_VISIBLE_DEVICES``)."""
    env[ENV_VISIBLE] = ",".join(str(i) for i in chip_ids)


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



ENV_NODE_ID = "RAY_TPU_TORCH_NODE_ID"  # the unit this process is bound to


def node_id() -> str:
    """The unit this process is bound to (``"cuda:<index>"`` or
    ``"slot:<index>"``), or "" outside a worker or probe."""
    return os.environ.get(ENV_NODE_ID, "")


def node_units(use_gpu: bool, slots: int) -> List[str]:
    """The units a worker group can be placed on: this node's cards, or
    ``slots`` host worker slots."""
    if use_gpu:
        return [f"cuda:{i}" for i in range(detect_gpus())]
    return [f"slot:{i}" for i in range(slots)]


def unit_index(unit: str) -> int:
    """The index of a unit: the card's ordinal or the slot's number."""
    kind, _, index = unit.partition(":")
    if kind not in ("cuda", "slot") or not index.isdigit():
        raise ValueError(f"not a card or slot: {unit!r}")
    return int(index)
