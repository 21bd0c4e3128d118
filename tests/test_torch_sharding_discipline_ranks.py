"""Rank body of ``tests/test_torch_sharding_discipline.py``: the tiny
Llama train step on every ``MESH_PRESETS`` entry in ``world`` gloo ranks
on the CPU, its implicit DTensor redistributes counted
(``parallel/redistributes.py``) with the fixed constraint set and with
``RAY_TPU_LEGACY_SHARDING=1``.

This module imports no JAX and holds no tests.  ``python
tests/test_torch_sharding_discipline_ranks.py WORLD RANK DIR`` joins a
gloo group through a file store in ``DIR``; rank 0 writes
``DIR/results.pt``: for each case the count on every rank, the first
recorded lines, and the losses of ``STEPS`` steps, or ``{"error":
traceback}``.  It needs no inputs, so it runs as it is under another
torch (the card machine's 2.11).
"""

from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import training as ttraining  # noqa: E402
from ray_tpu_torch.parallel import (ENV_LEGACY_SHARDING,  # noqa: E402
                                    MESH_PRESETS, create_mesh,
                                    redistribute_capture)
from ray_tpu_torch.parallel.mesh import compute_mesh  # noqa: E402

STEPS = 3
#: the models of the cases: the reference test's (``tests/
#: test_sharding_discipline.py``: 4 heads, 4 kv heads, 2 layers) and the
#: path ``chip_smoke.py``'s ``mesh4`` runs (flash attention, the
#: ``save_attn`` policy, bf16 activations, GQA), with a loss mask
CONFIGS = {
    "reference": (dict(num_heads=4, num_kv_heads=4, num_layers=2), False),
    "flash_bf16": (dict(attention_impl="flash", remat_policy="save_attn",
                        dtype=torch.bfloat16), True),
}


def step_case(world, preset, config, legacy):
    """``STEPS`` trainer steps on ``preset``'s mesh: this rank's implicit
    redistributes and lines, and the losses."""
    kw, masked = CONFIGS[config]
    cfg = tllama.LlamaConfig.tiny(**kw)
    if legacy:
        os.environ[ENV_LEGACY_SHARDING] = "1"
    try:
        mesh = create_mesh(MESH_PRESETS[preset].clamp_to(world),
                           device="cpu")
        tr = ttraining.make_llama_trainer(
            cfg, mesh, optimizer=ttraining.default_optimizer(
                lr=1e-3, warmup=1, decay_steps=10), device="cpu")
        state = tr.init_state(params=tllama.llama_init(cfg, 0, "cpu"))
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 9),
                                         generator=gen)}
        if masked:
            batch["mask"] = (torch.rand((8, 9), generator=gen) > 0.3).to(
                torch.int32)
        losses = []
        with redistribute_capture() as cap:
            for _ in range(STEPS):
                state, m = tr.step(state, batch)
                losses.append(float(m["loss"]))
        return {"count": cap["count"], "lines": cap["lines"][:4],
                "losses": losses}
    finally:
        os.environ.pop(ENV_LEGACY_SHARDING, None)


def capture_units(world):
    """The capture on this mesh: an explicit ``redistribute`` counts
    nothing, an op DTensor must reshard for (``clamp_min`` of a
    ``Partial``, and ``mul`` of a replicated by a sharded operand, which
    reshards the replicated one) counts one each, and an enclosing
    capture sees what a nested one sees."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = compute_mesh(create_mesh(MESH_PRESETS["dp"].clamp_to(world),
                                    device="cpu"))
    x = torch.arange(8.0).reshape(4, 2)
    part = DTensor.from_local(x, mesh, [Partial()])
    with redistribute_capture() as explicit:
        part.redistribute(mesh, [Replicate()])
    with redistribute_capture() as outer:
        part.clamp_min(0.0)
        with redistribute_capture() as inner:
            (DTensor.from_local(x, mesh, [Shard(0)])
             * DTensor.from_local(torch.ones(4 * world, 2), mesh,
                                  [Replicate()]))
    return {"explicit": explicit["count"], "outer": outer["count"],
            "inner": inner["count"], "outer_ops": outer["ops"],
            "inner_lines": inner["lines"]}


def cases():
    return [(preset, config, legacy) for config in CONFIGS
            for preset in sorted(MESH_PRESETS) for legacy in (False, True)]


def case_name(preset, config, legacy):
    return f"{config}/{preset}" + ("/legacy" if legacy else "")


def main(world: int, rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    results = {"torch": str(torch.__version__)}
    for preset, config, legacy in cases():
        try:
            got = step_case(world, preset, config, legacy)
        except Exception:  # reported per case by the test that reads it
            got = {"error": traceback.format_exc()}
        every = [None] * world
        dist.all_gather_object(every, got.get("count"))
        results[case_name(preset, config, legacy)] = {
            **got, "count_by_rank": every}
    try:
        results["units"] = capture_units(world)
    except Exception:
        results["units"] = {"error": traceback.format_exc()}
    dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
