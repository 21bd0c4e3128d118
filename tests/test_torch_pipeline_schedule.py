"""Port parity: the 1F1B schedule and ``PipelineRunner`` over process
actors (``ray_tpu_torch/dag/pipeline_schedule.py``).

Every case of ``tests/test_pipeline_schedule.py`` on the port's actors
(the reference's ``slow`` mark is not carried over: the port's cases run
in seconds), the schedule held equal to the reference's over a grid of
stage and microbatch counts (``ray_tpu.dag.pipeline_schedule`` imports no
JAX), the runner over both data planes, and a tiny Llama (2 + 2 layers,
fp32) trained through two stage processes (``chip_smoke.TrainStage``)
under the device tier's CPU emulation, whose accumulated gradients are
held against ``jax.grad`` of JAX's ``llama_loss`` summed over the same
microbatches.

One module-level set of CPU actors serves the cases (three linear stages,
reset per case, and the Llama's two stages); a watchdog kills them if the
module outlives ``WATCHDOG_S``.
"""

import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_dag_actors as A
from ray_tpu.dag import pipeline_schedule as ref_schedule
from ray_tpu.models import llama as jllama
from ray_tpu_torch import actor
from ray_tpu_torch.dag.pipeline_schedule import (B, F, PipelineRunner,
                                                 build_1f1b_schedule,
                                                 max_inflight)
from ray_tpu_torch.experimental.channel.transport import ENV_EMULATE_DEVICE
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax, params_to_jax

WATCHDOG_S = 240
LLAMA_MICROBATCHES = 4
# fp32 grads of four tiny layers summed over four microbatches, each
# framework summing its products in another order (test_torch_train's
# tolerance for two layers, the same reason)
ATOL_GRAD = 1e-5
RTOL_GRAD = 1e-4


def test_schedule_shape_and_order():
    S, M = 4, 8
    sched = build_1f1b_schedule(S, M)
    assert len(sched) == S
    for s, ops in enumerate(sched):
        assert len(ops) == 2 * M
        # every microbatch appears exactly once per direction
        assert sorted(mb for k, mb in ops if k == F) == list(range(M))
        assert sorted(mb for k, mb in ops if k == B) == list(range(M))
        # a microbatch's backward never precedes its forward
        seen_f = set()
        for k, mb in ops:
            if k == F:
                seen_f.add(mb)
            else:
                assert mb in seen_f
        # warmup + the first steady-state forward precede the first
        # backward: S-s forwards in flight when B(0) runs
        first_b = next(i for i, (k, _) in enumerate(ops) if k == B)
        assert first_b == min(S - s, M)


def test_schedule_memory_highwater():
    """1F1B's point: stage s keeps at most S-s in-flight microbatches
    (GPipe would keep all M)."""
    S, M = 4, 16
    sched = build_1f1b_schedule(S, M)
    for s in range(S):
        assert max_inflight(sched[s]) == min(S - s, M)


def test_last_stage_alternates_strictly():
    sched = build_1f1b_schedule(3, 4)
    last = sched[-1]
    assert last == [(F, 0), (B, 0), (F, 1), (B, 1),
                    (F, 2), (B, 2), (F, 3), (B, 3)]


def test_degenerate_single_stage():
    sched = build_1f1b_schedule(1, 3)
    assert sched == [[(F, 0), (B, 0), (F, 1), (B, 1), (F, 2), (B, 2)]]
    with pytest.raises(ValueError):
        build_1f1b_schedule(0, 1)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 7, 16])
def test_schedule_equals_reference(S, M):
    """The port's schedule and high-water marks are the reference's."""
    got = build_1f1b_schedule(S, M)
    want = ref_schedule.build_1f1b_schedule(S, M)
    assert got == want
    assert [max_inflight(ops) for ops in got] == [
        ref_schedule.max_inflight(ops) for ops in want]


@pytest.fixture(scope="module")
def stages():
    """Three linear stages and the tiny Llama's two training stages,
    started together on the CPU (the Llama's edges negotiate tier B under
    the emulation, set for the module)."""
    old = os.environ.get(ENV_EMULATE_DEVICE)
    os.environ[ENV_EMULATE_DEVICE] = "1"
    spawned = []

    def kill_all():
        for h in spawned:
            actor.kill(h)

    watchdog = threading.Timer(WATCHDOG_S, kill_all)
    watchdog.daemon = True
    watchdog.start()
    try:
        jcfg = jllama.LlamaConfig.tiny(num_layers=4)
        tcfg = tllama.LlamaConfig.tiny(num_layers=4)
        tree = jax.tree.map(np.asarray, jllama.llama_init(
            jax.random.PRNGKey(0), jcfg))
        params = params_from_jax(tree, tcfg, device="cpu")
        linear = [A.LinearStage.options(device="cpu").remote(np.eye(8))
                  for _ in range(3)]
        train = actor.ActorClass(chip_smoke.TrainStage).options(device="cpu")
        llama = [train.remote(tcfg, 0, 2, params=params),
                 train.remote(tcfg, 2, 4, params=params)]
        spawned += linear + llama
        actor.get([h._ready for h in spawned], timeout=180)
        yield types.SimpleNamespace(linear=linear, llama=llama, jcfg=jcfg,
                                    tcfg=tcfg, tree=tree, params=params)
    finally:
        watchdog.cancel()
        kill_all()
        if old is None:
            os.environ.pop(ENV_EMULATE_DEVICE, None)
        else:
            os.environ[ENV_EMULATE_DEVICE] = old


def _linear(stages, ws):
    hs = stages.linear[:len(ws)]
    actor.get([h.reset.remote(w) for h, w in zip(hs, ws)], timeout=30)
    return hs


@pytest.mark.parametrize("transport", ["objects", "channels"])
def test_pipeline_runner_matches_monolithic_grads(stages, transport):
    rng = np.random.default_rng(0)
    S, M = 3, 6
    ws = [rng.normal(size=(8, 8)) for _ in range(S)]
    hs = _linear(stages, ws)
    runner = PipelineRunner(hs, transport=transport)
    mbs = [rng.normal(size=(4, 8)) for _ in range(M)]
    try:
        res = runner.run(mbs, timeout=120)
    finally:
        runner.close()
    assert set(res.outputs) == set(range(M))
    assert set(res.input_grads) == set(range(M))

    # monolithic reference: loss = sum over all microbatches of sum(y)
    grads_ref = [np.zeros_like(w) for w in ws]
    for x in mbs:
        acts = [np.asarray(x, np.float64)]
        for w in ws:
            acts.append(acts[-1] @ w)
        g = np.ones_like(acts[-1])
        for s in reversed(range(S)):
            grads_ref[s] += acts[s].T @ g
            g = g @ ws[s].T
    got = actor.get([s.get_grad.remote() for s in hs])
    for a, b in zip(got, grads_ref):
        np.testing.assert_allclose(a, b, rtol=1e-10)

    # each stage executed its ops in 1F1B order
    sched = build_1f1b_schedule(S, M)
    orders = actor.get([s.get_order.remote() for s in hs])
    for s in range(S):
        assert [tuple(o) for o in orders[s]] == sched[s]


@pytest.mark.parametrize("transport", ["objects", "channels"])
def test_pipeline_runner_forward_only(stages, transport):
    hs = _linear(stages, [np.eye(4) * 2, np.eye(4) * 3])
    runner = PipelineRunner(hs, transport=transport)
    try:
        res = runner.run([np.ones((2, 4)), np.ones((2, 4)) * 2],
                         backward=False, timeout=60)
    finally:
        runner.close()
    np.testing.assert_allclose(res.outputs[0], np.ones((2, 4)) * 6)
    np.testing.assert_allclose(res.outputs[1], np.ones((2, 4)) * 12)
    assert res.input_grads == {}


def test_channel_runner_stats(stages):
    """A channel run's stats: the bubble against its analytic bound, the
    stage imbalance, and the channel wait by tier of both edges."""
    hs = _linear(stages, [np.eye(4), np.eye(4)])
    runner = PipelineRunner(hs, transport="channels")
    try:
        res = runner.run([np.ones((2, 4))] * 4, timeout=60)
        again = runner.run([np.ones((2, 4))] * 4, timeout=60)
    finally:
        runner.close()
    st = res.stats
    assert st["n_stages"] == 2 and st["n_microbatches"] == 4
    assert st["analytic_bubble"] == pytest.approx(1 / 5)
    assert 0.0 <= st["bubble_fraction"] <= 1.0
    assert st["stage_imbalance"] >= 0.0
    assert set(st["channel_transport"]) == {"fwd:0->1", "bwd:1->0"}
    assert set(st["channel_wait_s_by_tier"]) <= set(
        st["channel_transport"].values())
    assert [p["ops"] for p in st["per_stage"]] == [8, 8]
    # a second run on the attached channels resets the stage counters
    assert [p["ops"] for p in again.stats["per_stage"]] == [8, 8]


def test_llama_stages_grads_match_jax(stages):
    """The tiny Llama through ``PipelineRunner(transport="channels")``:
    each stage's gradient, accumulated over four microbatches in 1F1B
    order, against ``jax.grad`` of JAX's ``llama_loss`` summed over the
    same microbatches (to ``ATOL_GRAD``/``RTOL_GRAD``), and bit-equal to
    the port's one-process ``llama_loss`` backward accumulated in the same
    order; both edges on the device tier."""
    rng = np.random.default_rng(1)
    mbs = [rng.integers(0, stages.jcfg.vocab_size, size=(1, 17)).astype(
        np.int32) for _ in range(LLAMA_MICROBATCHES)]
    actor.get([s._remote_call.remote(chip_smoke.stage_zero_launches)
               for s in stages.llama], timeout=30)
    runner = PipelineRunner(stages.llama, transport="channels")
    try:
        res = runner.run([torch.from_numpy(m) for m in mbs], timeout=120)
    finally:
        runner.close()
    assert res.stats["channel_transport"] == {"fwd:0->1": "B-device",
                                              "bwd:1->0": "B-device"}
    halves = [s._remote_call.remote(chip_smoke.stage_grads).get(timeout=60)
              for s in stages.llama]
    orders = actor.get([s._remote_call.remote(chip_smoke.stage_order)
                        for s in stages.llama], timeout=30)
    assert [[tuple(o) for o in order] for order in orders] == \
        build_1f1b_schedule(2, LLAMA_MICROBATCHES)
    # the stages' grads as one tree: stacked layers joined in stage order
    got = {p: torch.cat([h[p] for h in halves])
           if p.startswith("layers/") else next(h[p] for h in halves
                                                if p in h)
           for p, _ in chip_smoke.tree_items(stages.params)}

    # the port in one process, the same microbatches in the same order
    one = params_from_jax(stages.tree, stages.tcfg, device="cpu")
    for _, t in chip_smoke.tree_items(one):
        t.requires_grad_(True)
    losses = []
    for m in mbs:
        loss = tllama.llama_loss(one, {"tokens": torch.from_numpy(m)},
                                 stages.tcfg)
        loss.backward()
        losses.append(float(loss.detach()))
    assert [res.outputs[i] for i in range(LLAMA_MICROBATCHES)] == losses
    for p, t in chip_smoke.tree_items(one):
        assert torch.equal(got[p], t.grad), p

    # JAX: the grad of the summed per-microbatch losses
    def total(tree):
        return sum(jllama.llama_loss(tree, {"tokens": jnp.asarray(m)},
                                     stages.jcfg) for m in mbs)

    jgrads = jax.grad(total)(jax.tree.map(jnp.asarray, stages.tree))
    mine = params_to_jax(_unflatten(got), stages.tcfg)
    for (path, want), have in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree.leaves(mine)):
        np.testing.assert_allclose(np.asarray(have), np.asarray(want),
                                   atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=str(path))


def _unflatten(flat):
    """A tree from ``{"a/b": leaf}`` paths."""
    out = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out
