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


# ---------------------------------------------------------------------------
# the health plane (tests/test_torch_health.py)
# ---------------------------------------------------------------------------


def _marker(side_dir, name, info):
    """The marker ``name`` in ``side_dir``, written whole."""
    import json

    me = os.path.join(side_dir, name)
    with open(me + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(me + ".tmp", me)


def _checkpoint(config, name, step):
    """A checkpoint of ``step`` (a state file) named ``name`` beside
    ``config["side_dir"]``."""
    import json

    d = os.path.join(os.path.dirname(config["side_dir"]), "ckpt", name)
    os.makedirs(d)
    with open(os.path.join(d, "state.json"), "w") as f:
        json.dump({"step": step}, f)
    return train.Checkpoint(d)


def _resume_step(ctx):
    import json

    ck = ctx.get_checkpoint()
    if ck is None:
        return 0
    with open(os.path.join(ck.path, "state.json")) as f:
        return json.load(f)["step"] + 1


def drain_loop(config):
    """The deterministic drain: each step writes a marker (step, world,
    rank, unit).  At ``config["world"]`` workers the loop holds at step
    ``hold_at`` until the drain notice (the test quarantines a slot once
    it sees that step's markers), writes a marker of the sites armed in
    this process, reports that step with a checkpoint, and then waits to
    be torn down.  A resumed group starts after its checkpoint's
    step."""
    from ray_tpu_torch.util import fault_injection as fi

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    first = world == config["world"]
    start = _resume_step(ctx)
    for step in range(start, config["steps"]):
        _marker(config["side_dir"], f"s{step}-w{world}-r{rank}",
                {"node": ctx.get_node_id()})
        if first and step == config["hold_at"]:
            t0 = time.monotonic()
            while not ctx.drain_requested():
                if time.monotonic() - t0 > 120:
                    raise RuntimeError("no drain notice in 120 s")
                time.sleep(0.01)
            _marker(config["side_dir"], f"drained-r{rank}",
                    {"node": ctx.get_node_id(), "armed": sorted(fi._armed)})
        ckpt = None
        if ctx.drain_requested():
            ckpt = _checkpoint(config, f"r{rank}-s{step}", step)
        train.report({"step": step, "world": world, "start": start,
                      "node": ctx.get_node_id(),
                      "drain_checkpoint": ckpt is not None},
                     checkpoint=ckpt)
        if first and step >= config["hold_at"]:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 120:  # torn down before this
                time.sleep(0.05)
            raise RuntimeError("the drained group was not torn down")


def straggler_loop(config):
    """The reference's end-to-end loop (``tests/test_health.py:665``):
    each step runs ``step_s`` of compute behind the ``train.work`` fault
    site, then a file barrier over the world standing in for the
    collective, its wait booked to ``collective_wait``; the step ledger
    publishes every step, and every step reports a checkpoint."""
    from ray_tpu_torch.util.fault_injection import fault_point

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    ledger = ctx.step_ledger()
    ledger._PUBLISH_EVERY_S = 0.0  # publish at every step boundary
    for step in range(_resume_step(ctx), config["steps"]):
        with ledger.step():
            with ledger.bucket("compute"):
                fault_point("train.work")  # the degradable compute path
                time.sleep(config["step_s"])
            _marker(config["side_dir"], f"s{step}-w{world}-r{rank}",
                    {"step": step, "rank": rank, "world": world,
                     "node": ctx.get_node_id()})
            t0 = time.monotonic()
            want = {f"s{step}-w{world}-r{r}" for r in range(world)}
            while time.monotonic() - t0 < 60:
                if want <= set(os.listdir(config["side_dir"])):
                    break
                time.sleep(0.01)
            ledger.note("collective_wait", time.monotonic() - t0)
        train.report({"step": step, "world": world}, checkpoint=_checkpoint(
            config, f"w{world}-r{rank}-s{step}", step))


def armed_factor(site):
    """In a process bound to a unit: the ``slow`` factor armed at
    ``site`` there (None when nothing is)."""
    from ray_tpu_torch.util import fault_injection as fi

    arm = fi._armed.get(site)
    return None if arm is None else arm.factor
