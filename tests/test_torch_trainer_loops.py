"""Train loops and rank bodies of ``tests/test_torch_trainer.py`` and
``tests/test_torch_collective.py``: the port's trainer and collective
front run in worker processes on the CPU.

This module imports no JAX and holds no tests.  A ``TorchTrainer`` ships
its loop to each spawned worker by reference (stdlib pickle), so every
loop is a module-level function here; each worker runs on one thread.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

from ray_tpu_torch import train
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch.util import collective as col

# the optimizer of the slice case (the parallel tests' OPT)
OPT = dict(lr=1e-3, warmup=1, decay_steps=10)
TRAIN_STEPS = 3


def report_loop(config):
    """Two workers share one run: rank and world, the config, the
    replicated dataset shard, an allreduce over the run's collective
    group inside a step of the step ledger (its ``collective_wait`` and
    the breakdown it publishes to the run's KV), the group's status
    records there, a profile written per rank, and three reports."""
    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    g = ctx.collective_group()
    x = np.full((4,), float(rank + 1), np.float32)
    ledger = ctx.step_ledger()
    with ledger.step():
        out = col.allreduce(x, group_name=g)
    buckets = ledger.last_breakdown()["buckets"]
    kv = kv_mod.client()
    published = kv.get(f"train/step_breakdown/{ctx.get_trial_name()}/"
                       f"{rank}") is not None
    logdir = os.path.join(config["profile_dir"], f"rank{rank}")
    with train.profile(logdir=logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    shard = train.get_dataset_shard("train")
    for step in range(3):
        train.report({
            "step": step, "rank": rank, "world": ctx.get_world_size(),
            "local_rank": ctx.get_local_rank(), "lr": config["lr"],
            "n": len(list(shard)), "sum0": float(out[0]),
            "group_state": col.get_group_state(g),
            "trial": ctx.get_trial_name(),
            "collective_wait_s": buckets.get("collective_wait", 0.0),
            "ledger_published": published,
            "status_records": kv.keys(f"collective/{g}/status/")})


def checkpoint_loop(config):
    """The reference's failure-retry loop (``tests/test_train.py:75``):
    one text checkpoint per step; the first attempt raises after step
    1's report."""
    torch.set_num_threads(1)
    ctx = train.get_context()
    start = 0
    ck = ctx.get_checkpoint()
    if ck is not None:
        with open(os.path.join(ck.path, "step.txt")) as f:
            start = int(f.read()) + 1
    for step in range(start, 4):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(step))
        train.report({"step": step}, checkpoint=train.Checkpoint(d))
        if step == 1 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected worker failure")


def always_fails():
    raise ValueError("always fails")


def _full(t):
    t = t.detach()
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def dp_llama_loop(config):
    """The slice on two workers: ``make_llama_trainer`` on the session's
    ``dp`` mesh from the converted weights placed by ``shard_params``,
    each rank feeding its half of the batch through ``shard_inputs``,
    ``TRAIN_STEPS`` steps; then a checkpoint of the params
    (``from_state_dict``) loaded onto a fresh ``fsdp`` mesh
    (``to_state_dict``)."""
    import copy

    from ray_tpu_torch.models.llama import LlamaConfig, llama_param_specs
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer,
                                               tree_leaves)
    from ray_tpu_torch.parallel import MeshConfig, create_mesh, shard_tree

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    cfg = LlamaConfig.tiny(attention_impl="flash")
    mesh = ctx.get_mesh()
    tr = make_llama_trainer(cfg, mesh, optimizer=default_optimizer(**OPT))
    state = tr.init_state(params=ctx.shard_params(
        copy.deepcopy(config["params"]), llama_param_specs(cfg)))
    tokens = config["tokens"]
    rows = tokens.shape[0] // world
    batch = ctx.shard_inputs(
        {"tokens": tokens[rank * rows:(rank + 1) * rows].astype(np.int64)})
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = tr.step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    params = {k: ({n: _full(t) for n, t in v.items()} if isinstance(v, dict)
                  else _full(v)) for k, v in state["params"].items()}
    ck = train.Checkpoint.from_state_dict(state["params"],
                                          path=config["ckpt_dir"])
    fresh = create_mesh(MeshConfig(dp=1, fsdp=world), device="cpu")
    target = shard_tree(params, llama_param_specs(cfg), fresh)
    back = ck.to_state_dict(target=target)
    got, want, placed = (tree_leaves(t) for t in (back, state["params"],
                                                   target))
    same = len(got) == len(want) == len(placed) and all(
        torch.equal(_full(a), _full(b)) and a.device_mesh == t.device_mesh
        and tuple(a.placements) == tuple(t.placements)
        for a, b, t in zip(got, want, placed))
    train.report({"rank": rank, "metrics": metrics,
                  "params": params if rank == 0 else None,
                  "mesh": str(mesh), "batch_rows": batch["tokens"].shape[0],
                  "roundtrip_bit_equal": same}, checkpoint=ck)


# ---------------------------------------------------------------------------
# the collective ranks (tests/test_torch_collective.py)
# ---------------------------------------------------------------------------

WATCHDOG_TIMEOUT_S = 4.0


def _ops(rank, world, inputs, group):
    """Every op of the group on this rank's inputs (numpy, as the
    reference's groups take them)."""
    out = {}
    for op in ("sum", "product", "min", "max"):
        out[f"allreduce_int_{op}"] = col.allreduce(
            inputs["ints"][rank], group, op=col.ReduceOp(op))
        out[f"allreduce_rand_{op}"] = col.allreduce(
            inputs["rand"][rank], group, op=col.ReduceOp(op))
    out["allreduce_torch"] = col.allreduce(
        torch.from_numpy(inputs["ints"][rank]), group)
    out["reduce"] = col.reduce(inputs["ints"][rank], 0, group)
    out["allgather"] = np.stack(col.allgather(inputs["rand"][rank], group))
    out["reducescatter_int"] = col.reducescatter(inputs["scatter_ints"][rank],
                                                 group)
    out["reducescatter_rand"] = col.reducescatter(
        inputs["scatter_rand"][rank], group)
    out["broadcast"] = col.broadcast(inputs["rand"][rank], 2, group)
    for name, perm in inputs["perms"].items():
        out[f"permute_{name}"] = col.permute(inputs["rand"][rank], perm,
                                             group)
    if rank == 0:
        col.send(inputs["rand"][0], 1, group, tag=5)
    elif rank == 1:
        out["recv"] = col.recv(inputs["rand"][0].shape, np.float32, 0,
                               group, tag=5)
    elif rank == 2:
        col.send(inputs["int64"], 3, group)
    else:
        out["recv_int64"] = col.recv(inputs["int64"].shape, np.int64, 2,
                                     group)
    if rank == 3:
        time.sleep(1.0)
    out["barrier_enter"] = time.time()
    col.barrier(group)
    out["barrier_exit"] = time.time()
    return out


def _watchdog(rank, world):
    """Ranks 0-2 allreduce; rank 3 skips it.  Each of the others records
    how its op ended, how long it took, the group's state and its flight
    recorder."""
    name = "watchdog"
    col.init_collective_group(world, rank, "tcp", name,
                              timeout_s=WATCHDOG_TIMEOUT_S)
    out = {"timeout_s": WATCHDOG_TIMEOUT_S}
    if rank < 3:
        t0 = time.monotonic()
        try:
            col.allreduce(np.ones(8, np.float32), name)
            out["error"] = None
        except Exception as e:  # noqa: BLE001 — recorded for the test
            out["error"] = (type(e).__name__, str(e),
                            getattr(e, "seq", None))
        out["elapsed_s"] = time.monotonic() - t0
        out["state"] = col.get_group_state(name)
        out["flight"] = col.flight_recorder_dump(name)
    else:
        time.sleep(WATCHDOG_TIMEOUT_S + 4)
    col.destroy_collective_group(name)
    return out


def collective_rank(rank, world, kv_addr, inputs_path, out_dir):
    """One rank of the collective test: joins ``"ops"`` over gloo through
    the run's store at ``kv_addr``, runs every op, then the watchdog
    case; writes its results (or its traceback) to
    ``out_dir/rank{rank}.pkl``."""
    from ray_tpu_torch._private import kv as kv_mod

    torch.set_num_threads(1)
    os.environ[kv_mod.ENV_KV] = kv_addr
    try:
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        col.init_collective_group(world, rank, "gloo", "ops", timeout_s=60)
        res = {"ops": _ops(rank, world, inputs, "ops"),
               "ops_state": col.get_group_state("ops")}
        col.destroy_collective_group("ops")
        res["watchdog"] = _watchdog(rank, world)
    except BaseException:  # noqa: BLE001 — reported to the test
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
