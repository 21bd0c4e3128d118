"""Port parity: the Mixtral-style MoE family on the CPU.

JAX's ``moe_init`` makes the weights and ``params_from_jax`` carries them
into the port, so both packages run the same numbers; inputs come from
numpy seeds.  ``MoEConfig.tiny_moe`` in float32 throughout; each
tolerance states its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtraining
from ray_tpu.parallel import MeshConfig, create_mesh
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models.convert import params_from_jax, params_to_jax
from ray_tpu_torch.ops.cuda import flash_attention as tflash

torch.set_num_threads(1)

# fp32 logits and aux: products over <= 128 terms summed in another order
# by each framework
ATOL, RTOL = 1e-5, 1e-5
# test_torch_train's limits on fp32 grads through two tiny layers
ATOL_GRAD, RTOL_GRAD = 1e-5, 1e-4


def _configs(**kw):
    return (jmoe.MoEConfig.tiny_moe(dtype=jnp.float32, **kw),
            tmoe.MoEConfig.tiny_moe(dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))


def _tokens(jcfg, b=2, s=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)


def _layer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


def _close(got, want, atol=ATOL, rtol=RTOL, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, **kw)


def test_presets_and_num_params_match_jax():
    for name in ("tiny_moe", "mixtral_8x7b"):
        j, t = getattr(jmoe.MoEConfig, name)(), \
            getattr(tmoe.MoEConfig, name)()
        for f in dataclasses.fields(t):
            if f.name in ("dtype", "param_dtype"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.dtype == torch.bfloat16 and t.param_dtype == torch.float32
        assert t.num_params() == j.num_params()
    # Mixtral-8x7B: 46.7 B parameters
    assert tmoe.MoEConfig.mixtral_8x7b().num_params() == 46_702_792_704


def test_moe_init_layout_and_scale():
    """The JAX pytree's layout (expert leaves [L, E, h, m], router
    [L, h, E]) in ``param_dtype``, Normal(0, 0.02) weights, unit norms."""
    jcfg, tcfg = _configs(param_dtype=torch.bfloat16)
    params = tmoe.moe_init(tcfg, seed=3, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), _jax_params(
        dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params,
                       is_leaf=torch.is_tensor)
    assert got == want
    w = params["layers"]["w_gate"].float()
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert bool((params["layers"]["mlp_norm"] == 1).all())
    again = tmoe.moe_init(tcfg, seed=3, device="cpu")
    assert torch.equal(again["layers"]["w_down"], params["layers"]["w_down"])


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_round_trip_moe(scan_layers):
    """MoE trees cross bit for bit both ways; JAX's ``moe_init`` stacks the
    layers whatever ``scan_layers`` says, and so does the way back."""
    jcfg, tcfg = _configs(scan_layers=scan_layers)
    tree = _jax_params(jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 128)
    back = params_to_jax(params, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_top_k_breaks_ties_as_jax():
    """Indices and values against ``jax.lax.top_k`` on values with many
    ties (a few levels), and on rows all equal, where JAX gives the lower
    index first."""
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 3, size=(64, 8)) / 4).astype(np.float32)
    x[:4] = 0.25
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tmoe.top_k(torch.from_numpy(x[:1]), 2)[1].tolist() == [[0, 1]]


@pytest.mark.parametrize("router", ["random", "zero"])
def test_moe_block_matches_jax(router):
    """``moe_block`` output, aux and chosen experts against JAX's on the
    same layer and input.  With an all-zero router every probability is
    1/E: JAX routes every token to experts 0 and 1, and so must the
    port."""
    jcfg, tcfg = _configs()
    lp = _layer(_jax_params(jcfg), 0)
    if router == "zero":
        lp["w_router"] = np.zeros_like(lp["w_router"])
    x = np.random.default_rng(2).standard_normal((2, 9, 64)) \
        .astype(np.float32)
    jout, jaux = jmoe.moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                                jcfg)
    tlp = {k: torch.from_numpy(v.copy()) for k, v in lp.items()}
    tout, taux = tmoe.moe_block(torch.from_numpy(x), tlp, tcfg)
    _close(tout, jout)
    _close(taux, jaux)
    probs = torch.softmax(torch.from_numpy(x) @ tlp["w_router"], dim=-1)
    idx = tmoe.top_k(probs, tcfg.experts_per_token)[1]
    jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(lp["w_router"]), axis=-1),
        jcfg.experts_per_token)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if router == "zero":
        assert bool((idx == torch.tensor([0, 1])).all())


@pytest.mark.parametrize("impl,scan_layers", [("ref", True), ("flash", True),
                                              ("ref", False)])
def test_moe_apply_matches_jax(impl, scan_layers):
    """Logits and the summed aux against JAX's ``moe_apply`` ('flash': the
    port's plain K1 against the Pallas kernel in interpret mode); a
    ``scan_layers=False`` config runs the same stacked tree alike."""
    jcfg, tcfg = _configs(attention_impl=impl, scan_layers=scan_layers)
    tree = _jax_params(jcfg)
    tokens = _tokens(jcfg)
    jlogits, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(tokens), jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        logits, aux = tmoe.moe_apply(params, torch.from_numpy(tokens), tcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 17, 256)
    _close(logits, jlogits)
    _close(aux, jaux)


def _loss_and_grads(tcfg, tree, tokens):
    params = params_from_jax(tree, tcfg, device="cpu")
    for t in ttraining.tree_leaves(params):
        t.requires_grad_(True)
    loss = tmoe.moe_loss(params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    loss.backward()
    return loss.detach(), params


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_moe_loss_and_grads_match_jax(impl):
    """``moe_loss`` (cross entropy plus the weighted aux) and its grads
    against ``jax.value_and_grad`` from the same converted weights."""
    jcfg, tcfg = _configs(attention_impl=impl)
    tree = _jax_params(jcfg)
    tokens = _tokens(jcfg, s=33, seed=1)
    jloss, jgrads = jax.value_and_grad(jmoe.moe_loss)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)},
        jcfg)
    loss, params = _loss_and_grads(tcfg, tree, tokens)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    grads = params_to_jax(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor), tcfg)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree.leaves(grads)):
        _close(got, want, atol=ATOL_GRAD, rtol=RTOL_GRAD, err_msg=str(path))


@pytest.mark.parametrize("policy", ["save_attn", "save_dots"])
def test_moe_remat_is_full_whatever_the_policy(monkeypatch, policy):
    """Under ``cfg.remat`` each layer is replayed whole (JAX's
    ``jax.checkpoint(layer_fn)`` has no policy): the flash forward runs
    twice per layer and the backward once, as in JAX's jaxpr (counted
    here through nested jaxprs), and the grads equal ``remat=False``'s to
    the last bit (the replay repeats the same CPU arithmetic)."""
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
    jcfg, base = _configs(attention_impl="flash", num_layers=3,
                          scan_layers=False)
    tree, tokens = _jax_params(jcfg), _tokens(jcfg, s=33, seed=2)
    _, want = _loss_and_grads(dataclasses.replace(base, remat=False), tree,
                              tokens)
    calls.update(fwd=0, bwd=0)
    _, got = _loss_and_grads(dataclasses.replace(base, remat_policy=policy),
                             tree, tokens)
    L = base.num_layers
    assert calls == {"fwd": 2 * L, "bwd": L}
    jaxpr = jax.make_jaxpr(jax.grad(lambda p: jmoe.moe_loss(
        p, {"tokens": jnp.asarray(tokens)},
        dataclasses.replace(jcfg, remat_policy=policy))))(
        jax.tree.map(jnp.asarray, tree))
    # one pallas_call per flash forward, two (dq, dkv) per backward
    assert _count_eqns(jaxpr.jaxpr, "pallas_call") == 2 * L + 2 * L
    for a, w in zip(ttraining.tree_leaves(got), ttraining.tree_leaves(want)):
        torch.testing.assert_close(a.grad, w.grad, atol=0, rtol=0)


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


def test_trainer_steps_match_jax():
    """Three steps of ``make_moe_trainer`` against JAX's on a one-device
    CPU mesh: loss, grad norm, params and Adam moments, with
    ``test_torch_train``'s limits and reasons (the first step at lr 0,
    the second inside the warmup; Adam turns a grad error of ~1e-10 on a
    grad of ~eps into up to 1e-4 on params)."""
    jcfg, tcfg = _configs()
    opt_args = dict(lr=1e-2, warmup=2, decay_steps=50)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtr = jmoe.make_moe_trainer(
        jcfg, mesh, optimizer=jtraining.default_optimizer(**opt_args))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate["params"])
    ttr = tmoe.make_moe_trainer(
        tcfg, optimizer=ttraining.default_optimizer(**opt_args),
        device="cpu")
    tstate = ttr.init_state(params=params_from_jax(tree, tcfg, device="cpu"))
    tokens = _tokens(jcfg, b=4, s=33, seed=3)
    jbatch = jtr.shard_batch({"tokens": tokens})
    for _ in range(3):
        jstate, jm = jtr.step(jstate, jbatch)
        tstate, tm = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)})
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


def test_mesh_and_device_rejections(monkeypatch):
    """A mesh that is not a ``DeviceMesh`` is refused (the mesh path is
    held against JAX in test_torch_parallel.py); ``device=None`` means
    the GPU, so without CUDA init and trainer raise rather than run on
    the host."""
    _, tcfg = _configs()
    params = tmoe.moe_init(tcfg, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tmoe.moe_apply(params, tokens, tcfg, mesh=object())
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tmoe.moe_loss(params, {"tokens": tokens}, tcfg, mesh=object())
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tmoe.make_moe_trainer(tcfg, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmoe.moe_init(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmoe.make_moe_trainer(tcfg)
