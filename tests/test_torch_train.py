"""Port parity: the Llama loss, its grads, the remat policies and the
train step on the CPU.

JAX's ``llama_init`` makes the weights and ``params_from_jax`` carries
them into the port, so both packages start from the same numbers; tokens
come from numpy seeds.  Float32 throughout; each tolerance states its
reason.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu.models import training as jtraining
from ray_tpu.parallel import MeshConfig, create_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models.convert import params_from_jax, params_to_jax
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.ops.cuda import flash_attention as tflash

torch.set_num_threads(1)

# fp32 loss and grads through two tiny layers: products over <= 128 terms
# summed in another order by each framework
ATOL_GRAD = 1e-5
RTOL_GRAD = 1e-4


def _configs(**kw):
    return jllama.LlamaConfig.tiny(**kw), tllama.LlamaConfig.tiny(**kw)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jllama.llama_init(jax.random.PRNGKey(seed), jcfg))


def _batch(jcfg, b=2, s=33, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    size=(b, s)).astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((b, s)) < 0.7).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _loss_and_grads(tcfg, tree, batch):
    params = params_from_jax(tree, tcfg, device="cpu")
    for t in ttraining.tree_leaves(params):
        t.requires_grad_(True)
    loss = tllama.llama_loss(params, _torch_batch(batch), tcfg)
    loss.backward()
    return loss.detach(), params


@pytest.mark.parametrize("impl,masked", [("ref", False), ("ref", True),
                                         ("flash", False)])
def test_llama_loss_and_grads_match_jax(impl, masked):
    """``llama_loss`` and its grads against ``jax.value_and_grad`` of the
    JAX loss ('flash': the port's plain K1/K2/K3 against the Pallas
    kernels in interpret mode), from the same converted weights."""
    jcfg, tcfg = _configs(attention_impl=impl)
    tree = _jax_params(jcfg)
    batch = _batch(jcfg, masked=masked)
    jloss, jgrads = jax.value_and_grad(jllama.llama_loss)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, params = _loss_and_grads(tcfg, tree, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    grads = params_to_jax(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor), tcfg)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree.leaves(grads)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_GRAD,
                                   rtol=RTOL_GRAD, err_msg=str(path))


def _count_eqns(jaxpr, name):
    """Equations of primitive ``name`` in ``jaxpr`` and its sub-jaxprs."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for param in eqn.params.values():
            for sub in (param if isinstance(param, (list, tuple))
                        else [param]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _count_eqns(inner, name)
    return n


def _jax_grad_jaxpr(jcfg, tree, batch):
    """The jaxpr of JAX's Llama loss grad, its layers unrolled
    (``scan_layers=False``, a per-layer list of the stacked ``tree``), so
    that each layer's equations count."""
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    layers = [{k: v[i] for k, v in tree["layers"].items()}
              for i in range(jcfg.num_layers)]
    return jax.make_jaxpr(jax.grad(lambda p: jllama.llama_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)))(
        jax.tree.map(jnp.asarray, {**tree, "layers": layers})).jaxpr


@pytest.mark.parametrize("remat,policy,flash_fwd_calls", [
    (False, "save_attn", 1), ("full", "full", 2),
    ("save_attn", "save_attn", 1), ("save_attn_mlp", "save_attn_mlp", 1),
    ("save_dots", "save_dots", 2)])
def test_remat_policies_same_grads_and_flash_calls(monkeypatch, remat,
                                                   policy, flash_fwd_calls):
    """The same grads under each policy, and the flash forward runs once
    per layer per step under ``save_attn`` and ``save_attn_mlp`` (their
    saved out/lse stand in for a replay) and twice under ``full`` and
    ``save_dots`` (which saves products only), as many times as JAX's
    jaxpr of the same grad holds a forward ``pallas_call`` (counted
    through nested jaxprs; a backward is two, dq and dkv).  The port's
    recompute repeats the same CPU arithmetic, so the grads agree to the
    last bit."""
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = (tflash.flash_attention_plain,
                            tflash.flash_attention_bwd_plain)

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return plain_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return plain_bwd(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention_plain", fwd)
    monkeypatch.setattr(tflash, "flash_attention_bwd_plain", bwd)
    jcfg, base = _configs(attention_impl="flash", num_layers=3)
    tree, batch = _jax_params(jcfg), _batch(jcfg, seed=1)
    _, want = _loss_and_grads(dataclasses.replace(base, remat=False), tree,
                              batch)
    calls.update(fwd=0, bwd=0)
    tcfg = dataclasses.replace(base, remat=bool(remat), remat_policy=policy)
    _, got = _loss_and_grads(tcfg, tree, batch)
    L = tcfg.num_layers
    assert calls == {"fwd": flash_fwd_calls * L, "bwd": L}
    jcfg = dataclasses.replace(jcfg, remat=bool(remat), remat_policy=policy)
    assert _count_eqns(_jax_grad_jaxpr(jcfg, tree, batch), "pallas_call") \
        == (flash_fwd_calls + 2) * L
    for a, w in zip(ttraining.tree_leaves(got), ttraining.tree_leaves(want)):
        torch.testing.assert_close(a.grad, w.grad, atol=0, rtol=0)


class _CountOps(TorchDispatchMode):
    """Counts the ops that run below autograd, by overload."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _ops_by_pass(tcfg, tree, batch):
    """``{op: count}`` of the forward and of the backward of one loss."""
    params = params_from_jax(tree, tcfg, device="cpu")
    for t in ttraining.tree_leaves(params):
        t.requires_grad_(True)
    with _CountOps() as fwd:
        loss = tllama.llama_loss(params, _torch_batch(batch), tcfg)
    with _CountOps() as bwd:
        loss.backward()
    return fwd.counts, bwd.counts


def test_remat_policies_replay():
    """What each policy replays in the backward, counted by op: the swiglu
    op once per layer under ``full``, ``save_attn`` and ``save_dots`` and
    never under ``save_attn_mlp``, which keeps its output; the ``x @ W``
    products (``aten.mm``) never under ``save_dots``, which keeps them,
    and six per layer under the other three (q, k, v, o, gate and up; no
    backward needs the down product's output), as many as JAX's jaxpr of
    the same grad adds over ``remat=False`` under ``save_attn``.
    ``save_attn_mlp`` replays gate and up too, in JAX as in the port:
    swiglu's backward needs its inputs."""
    jcfg, base = _configs(attention_impl="flash", num_layers=3)
    tree, batch = _jax_params(jcfg), _batch(jcfg, seed=1)
    mm, swiglu = torch.ops.aten.mm.default, torch.ops.ray_tpu_torch.swiglu \
        .default
    _, plain_bwd = _ops_by_pass(dataclasses.replace(base, remat=False), tree,
                                batch)
    L, replayed = base.num_layers, {}
    for policy in ("full", "save_attn", "save_attn_mlp", "save_dots"):
        fwd, bwd = _ops_by_pass(dataclasses.replace(base,
                                                    remat_policy=policy),
                                tree, batch)
        assert fwd[swiglu] == L
        replayed[policy] = {"swiglu": bwd[swiglu],
                            "mm": bwd[mm] - plain_bwd[mm]}
    assert {p: r["swiglu"] for p, r in replayed.items()} == {
        "full": L, "save_attn": L, "save_attn_mlp": 0, "save_dots": L}
    assert {p: r["mm"] for p, r in replayed.items()} == {
        "full": 6 * L, "save_attn": 6 * L, "save_attn_mlp": 6 * L,
        "save_dots": 0}
    dots = {policy: _count_eqns(_jax_grad_jaxpr(dataclasses.replace(
        jcfg, remat=policy is not None, remat_policy=policy or "save_attn"),
        tree, batch), "dot_general")
        for policy in (None, "save_attn", "save_attn_mlp")}
    assert dots["save_attn"] - dots[None] == 6 * L
    assert dots["save_attn_mlp"] == dots["save_attn"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_op_bit_equal_to_swiglu(dtype):
    """The op ``ray_tpu_torch::swiglu`` against the function it wraps:
    the same output and, through autograd, the same grads, bit for bit
    (its backward repeats autograd's chain in the same order)."""
    rng = np.random.default_rng(5)
    gate, up, grad = (torch.from_numpy(rng.standard_normal((3, 7, 96))
                                       .astype(np.float32) * scale).to(dtype)
                      for scale in (4.0, 1.0, 1.0))
    outs = []
    for fn in (tlayers.swiglu, tlayers.swiglu_op):
        g, u = gate.clone().requires_grad_(), up.clone().requires_grad_()
        out = fn(g, u)
        out.backward(grad)
        outs.append((out.detach(), g.grad, u.grad))
    for a, b in zip(*outs):
        assert a.dtype == dtype and torch.equal(a, b)


def test_schedule_matches_optax():
    """optax evaluates the schedule in float32, the port in float64: they
    agree to float32 rounding of the peak (1e-6 of 1e-2), which bounds the
    cancellation in ``1 + cos`` near the end of the decay."""
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 11)
    for count in range(14):
        assert ttraining.warmup_cosine_decay(count, 1e-2, 3, 11) == \
            pytest.approx(float(sched(count)), rel=1e-6, abs=1e-8)
    assert ttraining.default_optimizer(warmup=5, decay_steps=2) \
        .decay_steps == 6


def test_adamw_matches_optax_on_the_same_grads():
    """The port's clip + AdamW + schedule against ``default_optimizer``
    applied by optax, fed the same grads for four steps: the first two
    inside the warmup (lr 0, then lr/2), grads scaled so that clipping
    triggers on steps 1 and 3 only; decay reaches every leaf.  Both sides
    do the same fp32 arithmetic in another order: params agree to 1e-8
    (a few ulps of updates of ~1e-2)."""
    rng = np.random.default_rng(4)
    shapes = {"embed": (6, 4), "layers": {"w": (2, 4, 3), "norm": (2, 4)}}
    params = jax.tree.map(lambda sh: (rng.standard_normal(sh) * 0.02)
                          .astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    jopt = jtraining.default_optimizer(lr=1e-2, warmup=2, decay_steps=5)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    topt = ttraining.default_optimizer(lr=1e-2, warmup=2, decay_steps=5)
    tparams = jax.tree.map(lambda p: torch.from_numpy(p.copy()), params)
    tstate = topt.init(tparams)
    for step, scale in enumerate((0.5, 0.02, 3.0, 0.1)):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                        * scale).astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = topt.update(
            [torch.from_numpy(g.copy()) for g in jax.tree.leaves(grads)],
            tstate,
            ttraining.tree_leaves(tparams))
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            grads)), rtol=1e-6)
        for a, w in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-8,
                                       err_msg=f"step {step}")
    assert tstate["count"] == 4


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_trainer_steps_match_jax(accum_steps):
    """Three steps of the port's trainer against ``make_llama_trainer`` on
    a one-device CPU mesh: loss, grad norm, params and Adam moments.
    ``warmup=2``: the first step runs at lr 0 and the second inside the
    warmup.  Adam divides each grad by its RMS plus eps = 1e-8, so an
    element whose grad is about eps (some are ~2e-8 here) moves by up to
    lr * dg / eps differently for a grad error dg: with the grads' fp32
    noise dg <= 1e-10 and lr <= 1e-2 that is 1e-4 on params, where a step
    moves them by ~1e-2.  The optimizer's own arithmetic is held tightly
    by ``test_adamw_matches_optax_on_the_same_grads``; the moments carry
    the grads' own 1e-6."""
    jcfg, tcfg = _configs()
    opt_args = dict(lr=1e-2, warmup=2, decay_steps=50)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtr = jtraining.make_llama_trainer(
        jcfg, mesh, optimizer=jtraining.default_optimizer(**opt_args),
        accum_steps=accum_steps)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate["params"])
    ttr = ttraining.make_llama_trainer(
        tcfg, optimizer=ttraining.default_optimizer(**opt_args),
        accum_steps=accum_steps, device="cpu")
    tstate = ttr.init_state(params=params_from_jax(tree, tcfg, device="cpu"))
    batch = _batch(jcfg, b=4, seed=3)
    jbatch = jtr.shard_batch(batch)
    for _ in range(3):
        jstate, jm = jtr.step(jstate, jbatch)
        tstate, tm = ttr.step(tstate, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert tstate["step"] == 3 and tstate["opt_state"]["count"] == 3
    got = params_to_jax(tstate["params"], tcfg)
    for (path, want), a in zip(
            jax.tree_util.tree_flatten_with_path(jstate["params"])[0],
            jax.tree.leaves(got)):
        np.testing.assert_allclose(a, np.asarray(want), atol=1e-4,
                                   err_msg=str(path))
    adam = jstate["opt_state"][1][0]
    mu = params_to_jax(tstate["opt_state"]["mu"], tcfg)
    for want, a in zip(jax.tree.leaves(adam.mu), jax.tree.leaves(mu)):
        np.testing.assert_allclose(a, np.asarray(want), atol=1e-6)


def test_trainer_device_none_needs_cuda(monkeypatch):
    """``device=None`` means the GPU: without CUDA the trainer raises
    rather than training on the host, and a mesh that is not a
    ``DeviceMesh`` is refused (the mesh path: test_torch_parallel.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttraining.Trainer(lambda seed, dev: {}, lambda p, b: 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttraining.make_llama_trainer(tcfg)
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        ttraining.make_llama_trainer(tcfg, mesh=object(), device="cpu")


def test_unknown_remat_policy_raises():
    """Every policy of the reference runs; another name raises with the
    reference's wording, from the trainer at once and from the loss."""
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg, remat_policy="nothing")
    with pytest.raises(ValueError, match="remat_policy must be 'full', "
                       "'save_attn', 'save_attn_mlp' or 'save_dots'"):
        ttraining.make_llama_trainer(cfg, device="cpu")
    params = tllama.llama_init(cfg, device="cpu")
    params["embed"].requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy must be"):
        tllama.llama_loss(params, {"tokens": torch.zeros(
            1, 5, dtype=torch.long)}, cfg)
