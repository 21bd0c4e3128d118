"""Port parity: tensor- and pipeline-parallel serving,
``LLMEngine(mesh=...)``, against JAX's engine on a CPU mesh of the same
shape.

The port's engines run in four gloo ranks
(``test_torch_mesh_serving_ranks.py``, spawned once for the module and
joined with a timeout that kills them; its case table is shared); JAX's
side runs here after them, on a mesh of four of the eight host devices.
Weights come from JAX's initialisers through ``models/convert.py``.  Each
case serves the same four greedy requests with prefix caching and a
forced preemption, among them speculation under a tick clock, the int8
pool, chunked prefill and a hand-off into a single-rank engine.  Float32
throughout; each tolerance states its reason.  The ``bf16_rounding`` case
holds a bf16 model on three meshes against one rank of the port and an
fp32 engine (no JAX side).
"""

import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh_serving_ranks as ranks
from ray_tpu.llm import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu.models.generation import SamplingParams as JSamplingParams
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "test_torch_mesh_serving_ranks.py")
WORLD = 4
# the ranks take ~10 s alone and a few times that beside a loaded suite;
# a hung collective must not hold the suite past this
SPAWN_TIMEOUT_S = 300
# fp32 sums over the tp shards in another order than XLA's all-reduces:
# the tolerances of the parallel layer's parity tests
ATOL, RTOL = 1e-5, 1e-4
CASE_NAMES = sorted(ranks.CASES)


def _jax_cfg(model, **kw):
    return jllama.LlamaConfig.tiny(**ranks.MODELS[model], **kw)


def _trees():
    return {m: jax.tree.map(np.asarray, jax.jit(
        jllama.llama_init, static_argnums=1)(jax.random.PRNGKey(0),
                                              _jax_cfg(m)))
            for m in ranks.MODELS}


def _mesh(kw):
    return jmesh.create_mesh(jmesh.MeshConfig(**kw),
                             devices=jax.devices()[:WORLD])


def _jax_case(trees, name):
    """JAX's engine on the case's mesh: the ranks' workload, the first
    sample's logits (its batched sampler wrapped) and, with
    ``handoff``, the export of a prefill-only request."""
    case = ranks.CASES[name]
    eng = jengine.LLMEngine(_jax_cfg(case["model"]), trees[case["model"]],
                            mesh=_mesh(case["mesh"]),
                            arm_clock=ranks.TickClock(), **ranks.ENGINE,
                            **case["engine"])
    kept, sample = [], eng._sample

    def keep(logits, *a):
        if not kept:
            kept.append(np.asarray(logits))
        return sample(logits, *a)

    eng._sample = keep
    sp = JSamplingParams(temperature=0.0, max_tokens=ranks.MAX_TOKENS)
    outs = eng.generate(ranks.prompts(), sp)
    eng.blocks.assert_integrity()
    stats = eng.stats()
    out = {"tokens": [o.token_ids for o in outs],
           "prefix_cache": stats["prefix_cache"], "spec": stats["spec"],
           "prefill_chunks": stats["prefill_chunks"],
           "first_logits": kept[0]}
    if case.get("handoff"):
        rid = eng.submit(ranks.prompts()[0], sp, prefill_only=True)
        while rid not in eng._exports:
            eng.step()
        handoff = eng.export_kv(rid)
        out["export"] = {k: np.asarray(v) for k, v in handoff["kv"].items()}
        out["n_blocks"] = handoff["n_blocks"]
        out["export_first_token"] = handoff["out_tokens"]
    return out


def _jax_refusals():
    out = []
    for model_kw, mesh_kw in ranks.REFUSALS:
        try:
            jengine.LLMEngine(jllama.LlamaConfig.tiny(**model_kw),
                              mesh=_mesh(mesh_kw), batch_slots=2, max_len=32)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _tail(path, n=3000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError as e:
        return str(e)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks, join them within ``SPAWN_TIMEOUT_S`` (killing
    them and failing past it), then compute JAX's side, and return
    ``(port results, JAX results)``."""
    work = tmp_path_factory.mktemp("mesh_serving_ranks")
    trees = _trees()
    torch.save({m: params_from_jax(trees[m], tllama.LlamaConfig.tiny(
        **ranks.MODELS[m]), device="cpu") for m in ranks.MODELS},
        work / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, RANKS, str(WORLD), str(r), str(work)], env=env,
        stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        for p in procs:
            remaining = SPAWN_TIMEOUT_S - (time.monotonic() - t0)
            try:
                p.wait(timeout=max(remaining, 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} "
                            f"s; rank 0's log:\n{_tail(work / 'rank0.log')}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"ranks {bad} exited non-zero; rank {bad[0]}'s log:\n"
                    + _tail(work / f"rank{bad[0]}.log"))
    # after the ranks, not beside them: the file then adds at most four
    # busy cores, or JAX's, to the suite's load at a time
    want = {name: _jax_case(trees, name) for name in CASE_NAMES}
    want["refusals"] = _jax_refusals()
    return torch.load(work / "results.pt"), want


def _case(runs, name):
    got = runs[0][name]
    if isinstance(got, dict) and "error" in got:
        pytest.fail(f"case {name} raised in the ranks:\n{got['error']}")
    return got, runs[1].get(name)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_mesh_engine_tokens_match_jax(runs, name):
    """Greedy tokens equal JAX's engine's on the same mesh, on every rank
    alike; the prefix hits, preemptions, speculation counters and prefill
    chunks equal JAX's, and each option the case turns on ran."""
    got, want = _case(runs, name)
    engine_kw = ranks.CASES[name]["engine"]
    assert got["tokens"] == want["tokens"]
    assert got["errors"] == [None] * len(want["tokens"])
    assert all(len(t) == ranks.MAX_TOKENS for t in got["tokens"])
    assert got["tokens_same_on_every_rank"]
    assert got["stats_same_on_every_rank"]
    assert got["prefix_cache"] == want["prefix_cache"]
    assert got["prefix_cache"]["prefix_hits"] >= 1
    assert got["prefix_cache"]["preemptions"] >= 1
    assert got["spec"] == want["spec"]
    if engine_kw.get("spec_tokens"):
        assert got["spec"]["verify_steps"] > 0
        assert got["spec"]["accepted"] > 0
    assert got["prefill_chunks"] == want["prefill_chunks"]
    if engine_kw.get("prefill_chunk"):
        assert got["prefill_chunks"] > 0


@pytest.mark.parametrize("name", CASE_NAMES)
def test_mesh_engine_first_step_logits_match_jax(runs, name):
    """The first step's admissions' last-position logits (the batch the
    engine samples first tokens from) against JAX's."""
    got, want = _case(runs, name)
    np.testing.assert_allclose(got["first_logits"].numpy(),
                               want["first_logits"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_mesh_engine_places_weights_and_pool(runs, name):
    """The params are DTensors and the steps run on local shards: this
    rank's ``wq`` holds ``num_heads / tp`` heads, its pool ``L / pp``
    layers and ``num_kv_heads / tp`` kv heads of the whole pool, which
    is the reference's ``[L, blocks, bs, KVH, hd]``."""
    got, _ = _case(runs, name)
    case = ranks.CASES[name]
    cfg = tllama.LlamaConfig.tiny(**ranks.MODELS[case["model"]])
    tp, pp = case["mesh"].get("tp", 1), case["mesh"].get("pp", 1)
    hd = cfg.resolved_head_dim
    assert got["params_are_dtensors"]
    assert got["wq_local"] == (cfg.num_layers // pp, cfg.hidden_size,
                               cfg.num_heads * hd // tp)
    whole = (cfg.num_layers, ranks.ENGINE["num_blocks"],
             ranks.ENGINE["block_size"], cfg.num_kv_heads, hd)
    local = (whole[0] // pp,) + whole[1:3] + (whole[3] // tp, hd)
    assert got["pool_global"]["k"] == whole
    assert got["pool_local"]["k"] == local
    if case["engine"].get("kv_cache_dtype") == "int8":
        assert got["pool_global"]["k_scale"] == whole[:4]
        assert got["pool_local"]["k_scale"] == local[:4]


def test_mesh_export_adopted_by_single_rank_engine(runs):
    """``export_kv`` on a pp=2 x tp=2 engine gives whole heads and
    layers, as gathering JAX's sharded export does: int8 codes within
    one step (rarely off) and bf16 scales within one ulp, as the
    hand-off's own parity tests hold them.  A single-rank engine adopts
    it and decodes JAX's colocated tokens."""
    name = next(n for n, c in ranks.CASES.items() if c.get("handoff"))
    got, want = _case(runs, name)
    n = want["n_blocks"]
    assert set(got["export"]) == set(want["export"])
    for key, w in want["export"].items():
        g, w = got["export"][key], w
        assert tuple(g.shape) == w.shape, key
        g, w = g[:, :n], w[:, :n]
        if g.dtype == torch.int8:
            d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (key, d.max())
        elif g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), rtol=2 ** -7,
                                       atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
    assert got["export_first_token"] == want["export_first_token"]
    assert got["adopted_tokens"] == want["tokens"][0]


def test_decode_step_runs_on_local_shards(runs):
    """One decode step at dp=2 x tp=2 over two layers: the lookup's sum,
    two sums per layer (after ``wo`` and ``w_down``) and the head's
    gather, counted by DTensor's ``CommDebugMode`` on the process group,
    and no op dispatched on a DTensor."""
    got, _ = _case(runs, "collectives")
    L = got["num_layers"]
    counts = {op.split(".")[-1] if "." in op else op: n
              for op, n in got["comm_counts"].items()}
    reduces = sum(n for op, n in counts.items() if "allreduce" in op
                  or "all_reduce" in op)
    gathers = sum(n for op, n in counts.items() if "allgather" in op
                  or "all_gather" in op)
    assert reduces == 1 + 2 * L, got["comm_counts"]
    assert gathers == 1, got["comm_counts"]
    assert sum(counts.values()) == reduces + gathers, got["comm_counts"]
    assert got["dtensor_ops"] == 0 and got["ops"] > 0


def test_mesh_engine_refuses_like_jax(runs):
    """Heads that do not divide by tp raise the reference's ``ValueError``
    word for word; layers that do not divide by pp raise its own message,
    where JAX's placement of the weights refuses first."""
    got, want = _case(runs, "refusals")
    assert got[:2] == want[:2]
    assert all(w is not None for w in want)
    assert got[2] == "num_layers=3 not divisible by pp=2"


def test_bf16_pp_handoff_changes_no_bit(runs):
    """In bf16 at dp=2 x pp=2 (tp=1) each stage runs one rank's ops on
    its layers, so the pp hand-off and the logits' broadcast must change
    nothing: the first admissions' logits equal one rank's bit for bit,
    and so does every greedy token."""
    got, _ = _case(runs, "bf16_rounding")
    assert torch.equal(got["dp2_pp2"]["first_logits"],
                       got["single"]["first_logits"])
    assert got["dp2_pp2"]["tokens"] == got["single"]["tokens"]


@pytest.mark.parametrize("mesh", sorted(ranks.BF16_MESHES))
def test_bf16_mesh_rounds_like_one_rank(runs, mesh):
    """In bf16 a tp mesh sums the row-parallel products in another order
    than one rank's GEMM, so its logits round differently.  They stay
    within twice one rank's max-abs distance from the fp32 engine (the
    bound the card's ``serve_mesh4`` sets), and every first token whose
    fp32 top-two margin exceeds that bound, which no rounding within it
    can flip, equals one rank's."""
    got, _ = _case(runs, "bf16_rounding")
    summary = ranks.bf16_summary(got)
    bound = 2 * summary["single_vs_fp32"]
    assert summary[mesh]["first_logits_vs_fp32"] <= bound, summary
    top = got["fp32"]["first_logits"].topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1] > bound).tolist()
    assert any(clear)
    for i, c in enumerate(clear):
        if c:
            assert got[mesh]["tokens"][i][0] == got["single"]["tokens"][i][0]
