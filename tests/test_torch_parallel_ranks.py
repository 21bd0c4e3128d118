"""Rank bodies of ``tests/test_torch_parallel.py``: the port's parallel
layer run in ``world`` gloo ranks on the CPU.

This module imports no JAX (each rank is a fresh interpreter) and holds
no tests.  ``python tests/test_torch_parallel_ranks.py WORLD RANK DIR``
joins a gloo group through a file store in ``DIR``, reads
``DIR/inputs.pt`` (weights converted from JAX's, tokens and attention
inputs from numpy seeds), runs every case of ``CASES`` on its own mesh,
and rank 0 writes ``DIR/results.pt``: for each case a dict of full
(global) tensors and numbers, or ``{"error": traceback}``.
"""

from __future__ import annotations

import copy
import os
import sys
import traceback

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import moe as tmoe  # noqa: E402
from ray_tpu_torch.models import training as ttraining  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tflash  # noqa: E402
from ray_tpu_torch.parallel import (ENV_LEGACY_SHARDING,  # noqa: E402
                                    MESH_PRESETS, MeshConfig, create_mesh,
                                    shard_tree)

# the optimizer of the trainer cases (JAX's default_optimizer, same args)
OPT = dict(lr=1e-3, warmup=1, decay_steps=10)
TRAIN_STEPS = 3
POLICIES = ("save_attn", "save_attn_mlp", "save_dots", "full")

_MESHES = {}


def mesh_for(config: MeshConfig):
    if config not in _MESHES:
        _MESHES[config] = create_mesh(config, device="cpu")
    return _MESHES[config]


def full(t):
    """The global value of a DTensor (or a plain tensor), detached."""
    t = t.detach()
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _llama_cfg(**kw):
    return tllama.LlamaConfig.tiny(**kw)


def _params(inputs, key, mesh, specs):
    params = shard_tree(copy.deepcopy(inputs[key]), specs, mesh)
    for t in ttraining.tree_leaves(params):
        t.requires_grad_(True)
    return params


def _grads(params):
    return {k: ({n: full(t.grad) for n, t in v.items()}
                if isinstance(v, dict) else full(v.grad))
            for k, v in params.items()}


def attention_case(inputs, config, impls):
    """Attention on ``config``'s mesh for each ``(name, impl, causal,
    window)`` of ``impls``: the output and the grads of sum(out * dout)
    with respect to q, k and v."""
    mesh = mesh_for(config)
    out = {}
    for name, impl, causal, window in impls:
        q, k, v = (inputs[n].clone().requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = tattn.dot_product_attention(q, k, v, causal=causal, impl=impl,
                                        mesh=mesh, window=window)
        placements = str(o.placements)
        o = o.full_tensor()
        (o * inputs["dout"]).sum().backward()
        out[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad,
                     "dv": v.grad, "placements": placements}
    return out


RING = [("causal", "ring", True, None), ("non_causal", "ring", False, None),
        ("window", "ring", True, 5)]
PER_SHARD = [("flash", "flash", True, None), ("ref", "ref", True, None),
             ("ref_window", "ref", True, 5)]


def llama_case(inputs, config, masked=True, rows=None, **cfg_kw):
    """``llama_apply`` logits and ``llama_loss`` with its grads on
    ``config``'s mesh, from the converted weights (the first ``rows``
    rows of the batch, None = all); also whether the params are
    DTensors."""
    cfg = _llama_cfg(**cfg_kw)
    mesh = mesh_for(config)
    params = _params(inputs, "llama", mesh, tllama.llama_param_specs(cfg))
    batch = {"tokens": inputs["tokens"][:rows]}
    if masked:
        batch["mask"] = inputs["mask"][:rows]
    with torch.no_grad():
        logits = tllama.llama_apply(params, batch["tokens"][:, :-1], cfg,
                                    mesh=mesh)
    loss = tllama.llama_loss(params, batch, cfg, mesh=mesh)
    loss.backward()
    return {"logits": full(logits), "logits_placements":
            str(logits.placements), "loss": full(loss), "grads":
            _grads(params), "params_are_dtensors": all(
                hasattr(t, "placements")
                for t in ttraining.tree_leaves(params))}


def legacy_llama_case(inputs, config, **cfg_kw):
    """``llama_case`` with ``ENV_LEGACY_SHARDING`` set: the embedding
    lookup without its operand pins, on a plain token batch."""
    os.environ[ENV_LEGACY_SHARDING] = "1"
    try:
        return llama_case(inputs, config, **cfg_kw)
    finally:
        del os.environ[ENV_LEGACY_SHARDING]


def trainer_case(inputs, config, accum_steps=1, masked=False):
    """``TRAIN_STEPS`` steps of ``make_llama_trainer`` on ``config``'s
    mesh from the converted weights: loss and grad norm per step and the
    params after.  With a mask, also ``shard_batch`` of each rank's local
    rows against the global batch."""
    cfg = _llama_cfg(attention_impl="flash")
    mesh = mesh_for(config)
    tr = ttraining.make_llama_trainer(
        cfg, mesh, optimizer=ttraining.default_optimizer(**OPT),
        accum_steps=accum_steps)
    state = tr.init_state(params=copy.deepcopy(inputs["llama"]))
    batch = {"tokens": inputs["tokens"]}
    if masked:
        batch["mask"] = inputs["mask"]
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = tr.step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out = {"metrics": metrics, "params": {
        k: ({n: full(t) for n, t in v.items()} if isinstance(v, dict)
            else full(v)) for k, v in state["params"].items()},
        "moments_are_dtensors": all(hasattr(t, "placements") for t in
                                    ttraining.tree_leaves(
                                        state["opt_state"]["mu"]))}
    global_rows = tr.shard_batch(batch)["tokens"]
    local = global_rows.to_local()
    out["local_rows_equal_global"] = bool(torch.equal(
        full(tr.shard_batch({"tokens": local}, local_rows=True)["tokens"]),
        full(global_rows)))
    return out


def flash_count_case(inputs, config):
    """Forward flash calls (K1's plain version on the CPU) per train step
    under each remat policy, on ``config``'s mesh and with no mesh."""
    calls = {"fwd": 0}
    plain = tflash.flash_attention_plain

    def counted(*a, **kw):
        calls["fwd"] += 1
        return plain(*a, **kw)

    tflash.flash_attention_plain = counted
    try:
        out = {}
        for policy in POLICIES:
            cfg = _llama_cfg(attention_impl="flash", remat_policy=policy)
            for where, mesh in (("mesh", mesh_for(config)), ("none", None)):
                tr = ttraining.make_llama_trainer(
                    cfg, mesh, optimizer=ttraining.default_optimizer(**OPT),
                    device="cpu")
                state = tr.init_state(params=copy.deepcopy(inputs["llama"]))
                calls["fwd"] = 0
                tr.step(state, {"tokens": inputs["tokens"]})
                out[f"{policy}_{where}"] = calls["fwd"]
        return out
    finally:
        tflash.flash_attention_plain = plain


def moe_case(inputs, config):
    """``moe_apply`` logits and aux, ``moe_loss`` and its grads on
    ``config``'s mesh, and ``make_moe_trainer``'s refusal of pp=2."""
    cfg = tmoe.MoEConfig.tiny_moe(dtype=torch.float32)
    mesh = mesh_for(config)
    params = _params(inputs, "moe", mesh, tmoe.moe_param_specs(cfg))
    with torch.no_grad():
        logits, aux = tmoe.moe_apply(params, inputs["tokens"][:, :-1], cfg,
                                     mesh=mesh)
    loss = tmoe.moe_loss(params, {"tokens": inputs["tokens"]}, cfg,
                         mesh=mesh)
    loss.backward()
    try:
        tmoe.make_moe_trainer(cfg, mesh_for(MeshConfig(dp=1, fsdp=2, pp=2)))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"logits": full(logits), "aux": full(aux), "loss": full(loss),
            "grads": _grads(params), "pp_refusal": refused}


CASES = {
    "ring_sp4": lambda i: attention_case(i, MeshConfig(dp=1, sp=4), RING),
    "ring_sp2_tp2": lambda i: attention_case(
        i, MeshConfig(dp=1, tp=2, sp=2), RING),
    "per_shard_fsdp_tp": lambda i: attention_case(
        i, MeshConfig(dp=1, fsdp=2, tp=2), PER_SHARD),
    "llama_dp": lambda i: llama_case(i, MESH_PRESETS["dp"]),
    "llama_fsdp": lambda i: llama_case(i, MESH_PRESETS["fsdp"],
                                       attention_impl="flash"),
    "llama_fsdp_tp": lambda i: llama_case(i, MESH_PRESETS["fsdp_tp"],
                                          attention_impl="flash"),
    "llama_fsdp_tp_legacy": lambda i: legacy_llama_case(
        i, MESH_PRESETS["fsdp_tp"], attention_impl="flash"),
    "llama_fsdp_sp": lambda i: llama_case(i, MeshConfig(dp=1, fsdp=2, sp=2)),
    "llama_pp": lambda i: llama_case(i, MeshConfig(dp=1, fsdp=2, pp=2),
                                     pp_microbatches=4),
    # 4 rows in the default 2 * pp = 4 microbatches: a microbatch's one
    # row does not split over fsdp=2
    "llama_pp_b4": lambda i: llama_case(i, MeshConfig(dp=1, fsdp=2, pp=2),
                                        rows=4),
    "train_fsdp": lambda i: trainer_case(i, MESH_PRESETS["fsdp"]),
    "train_fsdp_tp": lambda i: trainer_case(i, MESH_PRESETS["fsdp_tp"]),
    "train_fsdp_accum": lambda i: trainer_case(
        i, MESH_PRESETS["fsdp"], accum_steps=2, masked=True),
    "flash_counts": lambda i: flash_count_case(i, MESH_PRESETS["fsdp_tp"]),
    "moe_fsdp_tp": lambda i: moe_case(i, MeshConfig(dp=1, fsdp=2, tp=2)),
}


def main(world: int, rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    results = {}
    for name, case in CASES.items():
        try:
            results[name] = case(inputs)
        except Exception:  # reported per case by the test that reads it
            results[name] = {"error": traceback.format_exc()}
    dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
