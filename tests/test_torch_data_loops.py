"""Train loops of ``tests/test_torch_data_trainer.py``: the port's data
plane feeding ``TorchTrainer`` workers on the CPU.

This module imports no JAX and holds no tests.  A ``TorchTrainer`` ships
its loop to each spawned worker by reference (stdlib pickle), so every
loop is a module-level function here; each worker runs on one thread.
"""

from __future__ import annotations

import json
import os

import torch

from ray_tpu_torch import train


def split_loop(config):
    """Each rank reads its shard of the ``train`` dataset through
    ``iter_torch_batches`` (on the worker's device, the CPU here) and
    writes what it read to ``<out_dir>/<generation>_rank<r>.json``: the
    ids, the batches' devices and dtypes, and the segment its split
    channel used (first when it starts, then when it ends).  On the first attempt rank 0 writes after its first
    batch and raises, so the controller restarts the group."""
    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    generation = ctx.get_trial_name().rsplit("/", 1)[-1]
    shard = train.get_dataset_shard("train")
    marker = os.path.join(config["out_dir"], "failed_once")
    fail = rank == 0 and not os.path.exists(marker)
    rec = {"ids": [], "devices": set(), "dtypes": set(),
           "segment": shard._source.name}

    def dump():
        path = os.path.join(config["out_dir"], f"{generation}_rank{rank}.json")
        with open(path, "w") as f:
            json.dump({**rec, "devices": sorted(rec["devices"]),
                       "dtypes": sorted(rec["dtypes"])}, f)

    dump()  # the segment, before anything is read
    for batch in shard.iter_torch_batches(batch_size=config["batch_size"],
                                          prefetch_batches=2):
        rec["ids"].extend(batch["id"].tolist())
        rec["devices"].add(str(batch["id"].device))
        rec["dtypes"].add(str(batch["id"].dtype))
        if fail:
            dump()
            open(marker, "w").close()
            raise RuntimeError("injected failure after the first batch")
    dump()
    train.report({"rank": rank, "rows": len(rec["ids"])})
