"""The tiered checkpoint plane's knobs (the ``train_checkpoint_*`` and
``train_drain_memory_tier_floor_s`` entries of ``ray_tpu/_private/
config.py``), with the reference's values as defaults.

Each knob reads ``RAY_TPU_TORCH_<NAME>`` (upper case) from the
environment when it is set, e.g.
``RAY_TPU_TORCH_TRAIN_CHECKPOINT_REPLICA_RPC_TIMEOUT_S=5``; spawned
workers and replica servers inherit it.
"""

from __future__ import annotations

import os

DEFAULTS = {
    # a save() issued while the previous persist is still in flight waits
    # at most this long (it never drops the snapshot)
    "train_checkpoint_persist_wait_s": 120.0,
    # rank 0's bounded wait for every shard before the manifest commit;
    # past it the generation stays torn (.tmp) and is swept later
    "train_checkpoint_manifest_wait_s": 60.0,
    # one replica-plane call: a peer push, a fetch, a manifest
    "train_checkpoint_replica_rpc_timeout_s": 30.0,
    # drain windows shorter than this cannot fit the disk persist: the
    # controller asks for a memory-tier (peer-RAM) checkpoint instead
    "train_drain_memory_tier_floor_s": 5.0,
}


def knob(name: str) -> float:
    """Knob ``name``: the environment's ``RAY_TPU_TORCH_<NAME>``, else its
    default."""
    raw = os.environ.get(f"RAY_TPU_TORCH_{name.upper()}")
    return float(raw) if raw else float(DEFAULTS[name])
