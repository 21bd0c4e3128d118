"""Port parity: the ViT family on the CPU.

JAX's ``vit_init`` makes the weights and ``vit_params_from_jax`` carries
them into the port, so both packages run the same numbers; images and
labels come from numpy seeds.  JAX's side runs as ``tests/test_models.py``
runs it (plain ``vit_apply`` and ``make_vit_trainer`` on the host; the
model pins 'ref' attention, so no Pallas kernel is reached).  Each
tolerance states its reason; the mesh paths are held in
``tests/test_torch_parallel.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import training as jtraining
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import MeshConfig, create_mesh
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import (vit_params_from_jax,
                                          vit_params_to_jax)
from ray_tpu_torch.parallel import pipeline as tpipeline

torch.set_num_threads(1)

# fp32 logits: products over <= 192 terms (patch_dim) summed in another
# order by each framework, through two layers
ATOL, RTOL = 1e-5, 1e-4
# fp32 loss and grads (test_torch_train's limits on two tiny layers)
ATOL_GRAD, RTOL_GRAD = 1e-5, 1e-4


def _configs(**kw):
    return jvit.ViTConfig.tiny(**kw), tvit.ViTConfig.tiny(**kw)


def _fp32(**kw):
    return _configs(dtype=jnp.float32, **kw)[0], \
        tvit.ViTConfig.tiny(dtype=torch.float32, **kw)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jvit.vit_init(jax.random.PRNGKey(seed),
                                                  jcfg))


def _batch(cfg, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, cfg.num_channels)).astype(
        np.float32),
        "labels": rng.integers(0, cfg.num_classes, (b,)).astype(np.int32)}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def _grads(params):
    return vit_params_to_jax({
        k: ({n: t.grad for n, t in v.items()} if isinstance(v, dict)
            else v.grad) for k, v in params.items()})


def _require_grad(params):
    for t in ttraining.tree_leaves(params):
        t.requires_grad_(True)
    return params


def _close_tree(got, want, atol, rtol):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=str(path))


def test_presets_and_num_params_match_jax():
    for name in ("tiny", "vit_b16"):
        j, t = getattr(jvit.ViTConfig, name)(), \
            getattr(tvit.ViTConfig, name)()
        for f in dataclasses.fields(t):
            if f.name in ("dtype", "param_dtype"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.dtype == torch.bfloat16 and t.param_dtype == torch.float32
        assert t.num_params() == j.num_params()
        assert (t.num_patches, t.patch_dim) == (j.num_patches, j.patch_dim)
    # ViT-B/16: 86.5 M parameters (no biases in the blocks, RMSNorm)
    assert tvit.ViTConfig.vit_b16().num_params() == 86_465_512


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_vit_init_layout_scale_and_count(param_dtype):
    """The JAX pytree's layout (layers stacked [L, ...]) in
    ``param_dtype``: Normal(0, 0.02) weights, unit norms, zero biases, and
    ``num_params()`` leaves in all."""
    jcfg, tcfg = _configs(param_dtype=jnp.dtype(str(param_dtype)[6:]),
                          num_layers=3)
    tcfg = dataclasses.replace(tcfg, param_dtype=param_dtype)
    params = tvit.vit_init(tcfg, seed=3, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                       params, is_leaf=torch.is_tensor)
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), _jax_params(jcfg))
    assert got == want
    assert sum(t.numel() for t in ttraining.tree_leaves(params)) == \
        tcfg.num_params()
    assert torch.equal(params["layers"]["attn_norm"],
                       torch.ones(3, 64, dtype=param_dtype))
    assert not params["patch_bias"].any() and not params["head_b"].any()
    w = params["layers"]["w_up"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3 and abs(float(w.mean())) < 1e-3
    # one generator per seed: the same seed draws the same params
    again = tvit.vit_init(tcfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttraining.tree_leaves(params), ttraining.tree_leaves(again)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patchify_bit_equal_to_jax(dtype):
    jcfg, tcfg = _configs()
    images = np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit._patchify(jnp.asarray(images).astype(dtype),
                                     jcfg)).astype(np.float32)
    got = tvit._patchify(torch.from_numpy(images).to(getattr(torch, dtype)),
                         tcfg).float().numpy()
    assert got.shape == (3, tcfg.num_patches, tcfg.patch_dim)
    np.testing.assert_array_equal(got, want)
    # the first patch is the top-left 8x8 block
    np.testing.assert_array_equal(
        tvit._patchify(torch.from_numpy(images), tcfg)[0, 0].reshape(
            8, 8, 3).numpy(), images[0, :8, :8, :])


def _logits_pair(jcfg, tcfg, tree=None, seed=0):
    tree = _jax_params(jcfg) if tree is None else tree
    batch = _batch(jcfg, seed=seed)
    want = np.asarray(jvit.vit_apply(tree, batch["images"], jcfg))
    with torch.no_grad():
        got = tvit.vit_apply(vit_params_from_jax(tree, tcfg, device="cpu"),
                             torch.from_numpy(batch["images"]), tcfg)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("scan_layers", [True, False])
def test_vit_apply_matches_jax_fp32(scan_layers):
    """fp32 logits from the converted weights; ``scan_layers`` changes
    nothing (JAX indexes the stacked layers, the port always stacks)."""
    jcfg, tcfg = _fp32(scan_layers=scan_layers)
    got, want = _logits_pair(jcfg, tcfg)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_vit_apply_matches_jax_bf16():
    """The presets' bf16 activations over fp32 master weights.  XLA may
    keep fp32 intermediates inside its fusions where torch rounds each op
    to bf16, a few bf16 ulps (2**-8 relative) per op; through two layers
    to logits of magnitude ~0.5 the difference stays under 1e-2 absolute
    (test_torch_llama's bf16 limit) and the predicted class agrees."""
    jcfg, tcfg = _configs()
    got, want = _logits_pair(jcfg, tcfg, seed=2)
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` is the tanh approximation, torch's default the erf
    form.  With the MLP's inputs scaled to O(1) (w_up x 10, where the two
    forms differ by up to ~1e-3) and its output to the residual's size
    (w_down x 50), the port matches JAX at the fp32 tolerance (1e-7 seen)
    and the same model with an erf GELU misses it (7e-5 seen)."""
    jcfg, tcfg = _fp32()
    tree = _jax_params(jcfg)
    tree["layers"]["w_up"] = tree["layers"]["w_up"] * np.float32(10.0)
    tree["layers"]["w_down"] = tree["layers"]["w_down"] * np.float32(50.0)
    got, want = _logits_pair(jcfg, tcfg, tree=tree)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    erf = types.SimpleNamespace(
        gelu=lambda x, approximate="none": torch.nn.functional.gelu(x))
    saved, tvit.F = tvit.F, erf
    try:
        wrong, _ = _logits_pair(jcfg, tcfg, tree=tree)
    finally:
        tvit.F = saved
    assert not np.allclose(wrong, want, atol=ATOL, rtol=RTOL)


def test_vit_loss_and_grads_match_jax():
    """The fp32 loss and every grad against ``jax.value_and_grad``."""
    jcfg, tcfg = _fp32()
    tree = _jax_params(jcfg)
    batch = _batch(jcfg, b=6, seed=4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jvit.vit_loss(p, batch, jcfg))(tree)
    params = _require_grad(vit_params_from_jax(tree, tcfg, device="cpu"))
    loss = tvit.vit_loss(params, _torch_batch(batch), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    _close_tree(_grads(params), jgrads, ATOL_GRAD, RTOL_GRAD)


def test_remat_on_and_off_give_equal_grads():
    """Remat replays each layer whole in the backward: the same ops on
    the same inputs, so the grads are bit-equal to a run that keeps every
    activation (and the layer is run twice: once more per layer)."""
    _, tcfg = _fp32()
    batch = _torch_batch(_batch(tcfg, seed=5))
    grads, calls = {}, {}
    layer = tvit._encoder_layer
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _require_grad(tvit.vit_init(cfg, seed=1, device="cpu"))
        calls[remat] = 0

        def counted(*a, **kw):
            calls[remat] += 1
            return layer(*a, **kw)

        tvit._encoder_layer = counted
        try:
            tvit.vit_loss(params, batch, cfg).backward()
        finally:
            tvit._encoder_layer = layer
        grads[remat] = [t.grad for t in ttraining.tree_leaves(params)]
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    assert calls == {True: 2 * tcfg.num_layers, False: tcfg.num_layers}


def test_trainer_steps_match_jax():
    """Three steps of ``make_vit_trainer`` against JAX's on a one-device
    CPU mesh: loss, grad norm, params and Adam moments, with
    ``test_torch_train``'s limits and reasons (the first step at lr 0,
    the second inside the warmup; Adam turns a grad error of ~1e-10 on a
    grad of ~eps into up to 1e-4 on params)."""
    jcfg, tcfg = _fp32()
    opt_args = dict(lr=1e-2, warmup=2, decay_steps=50)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtr = jvit.make_vit_trainer(
        jcfg, mesh, optimizer=jtraining.default_optimizer(**opt_args))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate["params"])
    ttr = tvit.make_vit_trainer(
        tcfg, optimizer=ttraining.default_optimizer(**opt_args),
        device="cpu")
    tstate = ttr.init_state(params=vit_params_from_jax(tree, tcfg,
                                                       device="cpu"))
    batch = _batch(jcfg, b=8, seed=3)
    jbatch = jtr.shard_batch(batch)
    for _ in range(3):
        jstate, jm = jtr.step(jstate, jbatch)
        tstate, tm = ttr.step(tstate, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert tstate["step"] == 3 and tstate["opt_state"]["count"] == 3
    _close_tree(vit_params_to_jax(tstate["params"]), jstate["params"],
                1e-4, 0)
    adam = jstate["opt_state"][1][0]
    _close_tree(vit_params_to_jax(tstate["opt_state"]["mu"]), adam.mu,
                1e-6, 0)


def test_pp_is_refused_as_jax(monkeypatch):
    """ViT has no pipeline path: a pp > 1 mesh raises with
    ``reject_pp``'s wording, as JAX's ``make_vit_trainer`` does (the port
    reads the stage count through ``pp_size``; JAX on a pp=2 CPU
    mesh)."""
    jcfg, tcfg = _configs()
    with pytest.raises(ValueError) as want:
        jvit.make_vit_trainer(jcfg, create_mesh(
            MeshConfig(dp=1, fsdp=2, pp=2), devices=jax.devices()[:4]))
    monkeypatch.setattr(tpipeline, "pp_size", lambda mesh, axis="pp": 2)
    with pytest.raises(ValueError) as got:
        tvit.make_vit_trainer(tcfg, device="cpu")
    assert str(got.value) == str(want.value)
    assert "ViT has no pipeline" in str(got.value)
    assert jpipeline.reject_pp(None, "ViT") is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_bit_exact(dtype):
    jcfg, tcfg = _configs(param_dtype=getattr(jnp, dtype))
    tree = _jax_params(jcfg, seed=2)
    params = vit_params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"]["wq"].dtype == getattr(torch, dtype)
    back = vit_params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    with pytest.raises(ValueError, match="layer count"):
        vit_params_from_jax(tree, dataclasses.replace(tcfg, num_layers=3),
                            device="cpu")


def test_device_none_needs_cuda(monkeypatch):
    """``device=None`` means the GPU: without CUDA init and trainer raise
    rather than run on the host."""
    _, tcfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvit.vit_init(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvit.make_vit_trainer(tcfg)
