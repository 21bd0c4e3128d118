"""Train loops of ``tests/test_torch_weight_sync.py``,
``tests/test_torch_checkpoint_tiers.py`` and ``tests/test_torch_rlhf.py``:
the port's weight sync and tiered checkpoint plane in worker processes on
the CPU.

This module imports no JAX and holds no tests.  A ``TorchTrainer`` ships
its loop to each spawned worker by reference (stdlib pickle), so every
loop is a module-level function here; each worker runs on one thread.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ray_tpu_torch import train


def _marker(side_dir, name, info):
    tmp = os.path.join(side_dir, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.rename(tmp, os.path.join(side_dir, name))


def weight_sync_restart_loop(config):
    """A learner that publishes twice and fails in its first attempt; the
    restarted attempt (a new worker process, a new publisher with
    ``resume=True``) publishes once more and reports what it committed,
    with every payload segment either attempt published."""
    from ray_tpu_torch.rl.weight_sync import (WeightPublisher,
                                              _read_latest_record)

    torch.set_num_threads(1)
    side = config["side_dir"]
    first = not os.path.exists(os.path.join(side, "failed"))
    pub = WeightPublisher(config["name"], resume=True)
    tree = {"w": torch.full((4, 4), 1.0), "b": torch.zeros(4)}
    published = []
    for _ in range(2 if first else 1):
        ver = pub.publish(tree)
        published.append(_read_latest_record(config["name"])["segment"])
        tree = {k: v + 1 for k, v in tree.items()}
    if first:
        _marker(side, "failed", {"segments": published,
                                 "version": ver.version})
        raise RuntimeError("injected failure after two publishes")
    train.report({"version": ver.version, "epoch": ver.epoch,
                  "segments": published,
                  "first_segments": json.load(open(os.path.join(
                      side, "failed")))["segments"]})


def tiered_loop(config):
    """The reference's deterministic tiered loop
    (``tests/test_checkpoint_tiers.py:_tiered_loop``): replicated state,
    a fixed update per step, every step saved through
    ``ctx.checkpointer()``; a restore writes its tier, and rank 0 each
    step's loss.  With ``kill_rank``/``kill_step`` that rank waits for its
    generation's peer-RAM ack and SIGKILLs itself once; a memory-tier
    drain request waits for the peer-RAM ack before the report."""
    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    side = config["side_dir"]
    state = {"w": np.arange(128, dtype=np.float64), "step": np.int64(-1)}
    start = 0
    res = ctx.restore_checkpoint()
    if res is not None:
        state = res.tree
        start = int(state["step"]) + 1
        _marker(side, f"restore-r{rank}-{start}", {
            "rank": rank, "start": start, "tier": res.tier,
            "disk_reads": res.disk_reads,
            "tier_by_rank": {str(k): v for k, v in
                             res.tier_by_rank.items()}})
    for step in range(start, config["steps"]):
        state["w"] = np.cos(state["w"]) * 1.000001
        state["step"] = np.int64(step)
        loss = float(np.sum(state["w"]))
        if rank == 0:
            _marker(side, f"loss-{step}", {"step": step, "loss": loss})
        h = ctx.checkpointer().save(state, {"step": step, "loss": loss})
        if config.get("kill_rank") == rank and \
                step == config.get("kill_step") and \
                not os.path.exists(os.path.join(side, "killed")):
            ctx.checkpointer().commit_ram(30.0)
            _marker(side, "killed", {"step": step})
            os.kill(os.getpid(), 9)
        if ctx.drain_requested() and \
                ctx.drain_checkpoint_tier() == "memory":
            ctx.checkpointer().commit_ram(30.0)
        train.report({"step": step, "loss": loss}, checkpoint=h)
    ctx.checkpointer().wait(60.0)


def fsdp_save_loop(config):
    """World 2 on an fsdp mesh: the tree's matrices as DTensors sharded
    along axis 0 (and one replicated), saved once through the tiered
    checkpointer; then waits for the disk tier."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ray_tpu_torch.parallel.mesh import compute_mesh

    torch.set_num_threads(1)
    ctx = train.get_context()
    mesh = compute_mesh(ctx.get_mesh())
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in
            np.load(config["tree"]).items()}
    tree = {"sharded": {k: distribute_tensor(v, mesh, [Shard(0)])
                        for k, v in full.items() if k != "rep"},
            "replicated": distribute_tensor(full["rep"], mesh,
                                            [Replicate()]),
            "step": 7}
    h = ctx.checkpointer().save(tree, {"step": 7}, wait_persist=True)
    train.report({"index": h.index, "tier": h.tier,
                  "world": ctx.get_world_size()}, checkpoint=h)


def restore_report_loop(config):
    """Restore through ``ctx.restore_checkpoint()`` and write the tree it
    got (numpy) and how it got it."""
    torch.set_num_threads(1)
    ctx = train.get_context()
    res = ctx.restore_checkpoint()
    tree = res.tree
    flat = {f"sharded.{k}": v.numpy() for k, v in tree["sharded"].items()}
    flat["rep"] = tree["replicated"].numpy()
    np.savez(config["out"], **flat)
    train.report({"index": res.index, "world": res.world,
                  "tier": res.tier, "disk_reads": res.disk_reads,
                  "step": tree["step"],
                  "tier_by_rank": {str(k): v for k, v in
                                   res.tier_by_rank.items()}})
