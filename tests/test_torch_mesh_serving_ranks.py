"""Rank bodies of ``tests/test_torch_mesh_serving.py``: the port's
``LLMEngine(mesh=...)`` run in ``world`` gloo ranks on the CPU.

This module imports no JAX (each rank is a fresh interpreter) and holds
no tests; the test module reads its case table.  ``python
tests/test_torch_mesh_serving_ranks.py WORLD RANK DIR [CASE,...]`` joins
a gloo group through a file store in ``DIR``, reads ``DIR/inputs.pt``
(the weights of each model, converted from JAX's) where a case needs
it, runs every case (or those named), and rank 0 writes
``DIR/results.pt``: per case a dict of tokens, stats, logits and
exports, or ``{"error": traceback}``; for ``bf16_rounding`` it also
prints ``bf16_summary`` as one JSON line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ray_tpu_torch.llm import engine as tengine  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import paged_generation as tpaged  # noqa: E402
from ray_tpu_torch.models.generation import SamplingParams  # noqa: E402
from ray_tpu_torch.parallel import MeshConfig, create_mesh  # noqa: E402
from ray_tpu_torch.parallel.local import tree_map  # noqa: E402

# the tiny fp32 models (LlamaConfig.tiny with these heads): MHA, GQA 4/2
# and 8/4 heads for tp=4
MODELS = {"mha": dict(num_heads=4, num_kv_heads=4),
          "gqa": dict(num_heads=4, num_kv_heads=2),
          "wide": dict(num_heads=8, num_kv_heads=4)}
# three slots and 13 blocks of 4 tokens for four requests of 13-23
# prompt tokens and 20 new tokens (up to 11 blocks each): the pool runs
# out mid-decode, so the youngest request is preempted (both packages,
# the same steps), with and without chunked prefill
ENGINE = dict(batch_slots=3, max_len=64, block_size=4, num_blocks=14,
              seed=0)
MAX_TOKENS = 20
# each case: the mesh, the model, the engine's options, and whether a
# prefill-only request's export is adopted by a single-rank engine
CASES = {
    "dp2_tp2_mha": dict(mesh=dict(dp=2, tp=2), model="mha",
                        engine=dict(spec_tokens=4)),
    "dp2_tp2_gqa": dict(mesh=dict(dp=2, tp=2), model="gqa",
                        engine=dict(kv_cache_dtype="int8")),
    "tp4": dict(mesh=dict(dp=1, tp=4), model="wide",
                engine=dict(spec_tokens=4)),
    "pp2_tp2": dict(mesh=dict(dp=1, pp=2, tp=2), model="gqa",
                    engine=dict(prefill_chunk=8, spec_tokens=4),
                    handoff=True),
}
# the reference's refusals: (model kwargs, mesh)
REFUSALS = [(dict(num_heads=4, num_kv_heads=2), dict(dp=1, tp=4)),
            (dict(num_heads=6, num_kv_heads=4), dict(dp=1, tp=4)),
            (dict(num_layers=3), dict(dp=1, pp=2, tp=2))]
# the case whose decode step's collectives are counted
COUNTED = "dp2_tp2_mha"
# bf16 rounding under sharding: a bf16 model with Llama-2-7B's head
# layout (as many kv heads as heads) served by one rank, by an fp32
# engine on the same weights, and on each mesh of BF16_MESHES; five
# prompts of 190-214 tokens, two sharing 64, and 32 greedy tokens each,
# as the card's ``serve`` phase sends.  At dp=2 x pp=2 (tp=1) each stage
# runs one rank's ops on its layers.
BF16_MODEL = dict(vocab_size=4096, hidden_size=256, num_layers=4,
                  num_heads=8, num_kv_heads=8, mlp_dim=688,
                  max_seq_len=1024)
BF16_MESHES = {"tp4": dict(dp=1, tp=4), "pp2_tp2": dict(dp=1, pp=2, tp=2),
               "dp2_pp2": dict(dp=2, pp=2)}
BF16_ENGINE = dict(batch_slots=4, max_len=1024, block_size=16, seed=0)
BF16_NEW_TOKENS = 32


def prompts():
    """Two prompts sharing two blocks (a prefix hit) and two whose
    repeats give the n-gram drafter something to propose."""
    shared = [17, 40, 93, 8, 150, 61, 77, 203]
    return [shared + [5, 11, 29, 31, 2, 9], shared + [250, 3, 99, 140, 12],
            [5, 9, 5, 9, 5, 9, 5, 9, 12, 40, 7, 5, 9],
            [3, 4, 3, 4, 3, 4, 8, 2, 8, 2, 8, 2, 8, 2, 8, 2, 1, 7, 200,
             180, 4, 3, 4]]


class TickClock:
    """Deterministic bandit clock: every read advances one tick, so the
    arms' tokens/s are a pure function of the workload on both sides."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1
        return self.t


_MESHES = {}


def mesh_for(kw):
    key = tuple(sorted(kw.items()))
    if key not in _MESHES:
        _MESHES[key] = create_mesh(MeshConfig(**kw), device="cpu")
    return _MESHES[key]


def _cfg(model, **kw):
    return tllama.LlamaConfig.tiny(**MODELS[model], **kw)


def _same_on_every_rank(value) -> bool:
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    return all(v == seen[0] for v in seen)


def _first_sample_logits():
    """Patch the engine's batch sampler to keep the logits of its first
    call (the first step's admissions); returns the list they land in
    and the restore function."""
    kept, plain = [], tengine.sample_token_batch

    def keep(logits, *a, **kw):
        if not kept:
            kept.append(logits.detach().clone())
        return plain(logits, *a, **kw)

    tengine.sample_token_batch = keep

    def restore():
        tengine.sample_token_batch = plain
    return kept, restore


def engine_case(inputs, name):
    """The case's engine on its mesh answers ``prompts()`` greedily:
    tokens, block, spec, chunk and hand-off stats, the first step's
    logits, whether every rank got the same, the local shapes, and with
    ``handoff`` a prefill-only request exported and adopted by a
    single-rank engine."""
    case = CASES[name]
    cfg = _cfg(case["model"])
    mesh = mesh_for(case["mesh"])
    kept, restore = _first_sample_logits()
    try:
        eng = tengine.LLMEngine(cfg, copy.deepcopy(inputs[case["model"]]),
                                mesh=mesh, device="cpu",
                                arm_clock=TickClock(), **ENGINE,
                                **case["engine"])
        outs = eng.generate(prompts(), SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS))
    finally:
        restore()
    eng.blocks.assert_integrity()
    stats = eng.stats()
    out = {"tokens": [o.token_ids for o in outs],
           "errors": [o.error for o in outs],
           "prefix_cache": stats["prefix_cache"], "spec": stats["spec"],
           "prefill_chunks": stats["prefill_chunks"],
           "first_logits": kept[0],
           "params_are_dtensors": all(
               hasattr(t, "placements") for t in
               [eng.params["embed"], *eng.params["layers"].values()]),
           "pool_global": {k: tuple(v.shape) for k, v in eng.pool.items()},
           "pool_local": {k: tuple(v.shape) for k, v in eng._lpool.items()},
           "wq_local": tuple(eng._lparams["layers"]["wq"].shape)}
    out["stats_same_on_every_rank"] = _same_on_every_rank(
        {k: v for k, v in stats.items()})
    out["tokens_same_on_every_rank"] = _same_on_every_rank(out["tokens"])
    if case.get("handoff"):
        out.update(handoff_round_trip(inputs[case["model"]], eng, cfg))
    return out


def handoff_round_trip(params, eng, cfg):
    """A prefill-only request of the first prompt on the mesh engine,
    its export (whole heads and layers) adopted by a single-rank engine
    with the whole weights, which decodes the rest."""
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    rid = eng.submit(prompts()[0], sp, prefill_only=True)
    while rid not in eng._exports:
        eng.step()
    handoff = eng.export_kv(rid)
    local = tengine.LLMEngine(
        cfg, copy.deepcopy(params), device="cpu", **ENGINE,
        kv_cache_dtype=eng.kv_cache_dtype)
    lid = local.adopt_prefilled(handoff)
    outs = {}
    while local.has_unfinished():
        outs.update({o.request_id: o for o in local.step()})
    local.blocks.assert_integrity()
    eng.blocks.assert_integrity()
    return {"export": {k: v.clone() for k, v in handoff["kv"].items()},
            "export_first_token": handoff["out_tokens"],
            "adopted_tokens": outs[lid].token_ids}


def bf16_prompts(vocab_size):
    """Five prompts of 190-214 tokens; the first two share 64 tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab_size, size=64).tolist()
    return [shared + rng.integers(3, vocab_size, size=n).tolist()
            for n in (136, 150)] + \
        [rng.integers(3, vocab_size, size=n).tolist()
         for n in (200, 214, 190)]


def bf16_rounding_case(_inputs):
    """``BF16_MODEL`` (weights from seed 0) served greedily by one rank,
    by an fp32 engine on the same weights, and on each mesh of
    ``BF16_MESHES``: tokens and the first admissions' logits of each."""
    cfg = tllama.LlamaConfig.tiny(**BF16_MODEL, dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
    params = tllama.llama_init(cfg, seed=0, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=BF16_NEW_TOKENS)

    def serve(cfg, params, mesh=None):
        kept, restore = _first_sample_logits()
        try:
            eng = tengine.LLMEngine(cfg, params, mesh=mesh, device="cpu",
                                    **BF16_ENGINE)
            outs = eng.generate(bf16_prompts(cfg.vocab_size), sp)
        finally:
            restore()
        return {"tokens": [o.token_ids for o in outs],
                "first_logits": kept[0].float()}

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    out = {"fp32": serve(cfg32, tree_map(lambda t: t.float(), params)),
           "single": serve(cfg, copy.deepcopy(params))}
    for name, kw in BF16_MESHES.items():
        out[name] = serve(cfg, copy.deepcopy(params), mesh_for(kw))
    return out


def bf16_summary(got):
    """``bf16_rounding_case``'s result in numbers: one rank's max-abs
    distance of its first logits from the fp32 engine's, and per mesh
    that distance, its distance from one rank's, and its greedy tokens
    equal to one rank's (first tokens and all)."""
    fp32, single = got["fp32"]["first_logits"], got["single"]
    out = {"single_vs_fp32": float((single["first_logits"] - fp32)
                                   .abs().max())}
    for name in BF16_MESHES:
        run = got[name]
        pairs = list(zip(run["tokens"], single["tokens"]))
        out[name] = {
            "first_logits_vs_fp32": float((run["first_logits"] - fp32)
                                          .abs().max()),
            "first_logits_vs_single": float(
                (run["first_logits"] - single["first_logits"]).abs().max()),
            "first_tokens_equal": sum(a[0] == b[0] for a, b in pairs),
            "tokens_equal": sum(x == y for a, b in pairs
                                for x, y in zip(a, b)),
            "tokens": sum(len(b) for _, b in pairs)}
    return out


class _DTensorOps(TorchDispatchMode):
    """Counts the ops dispatched with a DTensor among their arguments."""

    def __init__(self):
        super().__init__()
        self.dtensor_ops = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        self.ops += 1
        flat = tree_leaves((args, kwargs or {}))
        self.dtensor_ops += any(isinstance(a, DTensor) for a in flat)
        return func(*args, **(kwargs or {}))


def collectives_case(inputs):
    """One ``paged_decode_step`` of a mesh engine's local shards (three
    slots, one block each) under a count of the collectives the process
    group runs and of the ops dispatched on DTensors."""
    from torch.distributed.tensor.debug import CommDebugMode

    case = CASES[COUNTED]
    cfg = _cfg(case["model"])
    eng = tengine.LLMEngine(cfg, copy.deepcopy(inputs[case["model"]]),
                            mesh=mesh_for(case["mesh"]), device="cpu",
                            **ENGINE)
    tables = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    token = torch.tensor([5, 6, 7], dtype=torch.int32)
    cur = torch.tensor([0, 1, 2], dtype=torch.int32)
    counted = {}
    with CommDebugMode() as comm, _DTensorOps() as ops:
        tpaged.paged_decode_step(eng._lparams, token, cur, tables,
                                 eng._lpool, cfg, shard=eng._shard)
    for op, n in comm.get_comm_counts().items():
        counted[str(op)] = n
    return {"comm_counts": counted, "dtensor_ops": ops.dtensor_ops, "ops": ops.ops,
            "num_layers": cfg.num_layers}


def refusals_case(inputs):
    """The engine's refusals on each mesh of ``REFUSALS``."""
    out = []
    for model_kw, mesh_kw in REFUSALS:
        cfg = tllama.LlamaConfig.tiny(**model_kw)
        try:
            tengine.LLMEngine(cfg, mesh=mesh_for(mesh_kw), device="cpu",
                              batch_slots=2, max_len=32)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def main(world: int, rank: int, workdir: str, only=None) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    runs = {name: (lambda i, name=name: engine_case(i, name))
            for name in CASES}
    runs.update(collectives=collectives_case, refusals=refusals_case,
                bf16_rounding=bf16_rounding_case)
    if only:
        runs = {name: runs[name] for name in only}
    inputs = None
    if set(runs) != {"bf16_rounding"}:  # the only case with its own weights
        inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    results = {}
    for name, run in runs.items():
        try:
            results[name] = run(inputs)
        except Exception:  # reported per case by the test that reads it
            results[name] = {"error": traceback.format_exc()}
    dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
        got = results.get("bf16_rounding", {})
        if "error" not in got and got:
            print(json.dumps({"bf16_rounding": bf16_summary(got)}),
                  flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
         sys.argv[4].split(",") if len(sys.argv) > 4 else None)
