"""Port parity: the Llama forward and the weight converter on the CPU.

JAX's ``llama_init`` makes the weights; ``params_from_jax`` carries them
into the port, so both packages run the same numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax, params_to_jax

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="float32", param_dtype="float32", **kw):
    jcfg = jllama.LlamaConfig.tiny(dtype=_DT[dtype][0],
                                   param_dtype=_DT[param_dtype][0], **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=_DT[dtype][1],
                                   param_dtype=_DT[param_dtype][1], **kw)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    tree = jllama.llama_init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("param_dtype,scan_layers", [
    ("float32", True), ("bfloat16", True), ("float32", False)])
def test_convert_round_trip_bit_exact(param_dtype, scan_layers):
    jcfg, tcfg = _configs(param_dtype=param_dtype, scan_layers=scan_layers)
    tree = _jax_params(jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"]["wq"].shape[0] == tcfg.num_layers
    assert params["embed"].dtype == _DT[param_dtype][1]
    back = params_to_jax(params, tcfg)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_llama_init_shapes_and_scale():
    """The random streams differ from JAX's, so init parity is by shape,
    dtype and scale."""
    jcfg, tcfg = _configs()
    tree = _jax_params(jcfg)
    params = tllama.llama_init(tcfg, seed=0, device="cpu")
    flat_t = params_to_jax(params, tcfg)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(flat_t)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "norm" in str(path):  # norms: ones
            np.testing.assert_array_equal(a, b)
        else:  # weights: std 0.02 within sampling noise
            assert abs(float(b.std()) - 0.02) < 0.002, path
    assert tcfg.num_params() == jcfg.num_params()


def _forward_pair(jcfg, tcfg, seq=40, seed=0):
    tree = _jax_params(jcfg, seed)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    want = np.asarray(jllama.llama_apply(tree, jnp.asarray(tokens), jcfg))
    got = tllama.llama_apply(params_from_jax(tree, tcfg, device="cpu"),
                             torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("impl", ["auto", "ref", "flash"])
def test_llama_apply_matches_jax_fp32(impl):
    """fp32 end to end, through each attention path ('flash' is K1's plain
    version here against the Pallas kernel in interpret mode).  1e-4:
    two layers of fp32 products summed in another order."""
    jcfg, tcfg = _configs(attention_impl=impl)
    got, want = _forward_pair(jcfg, tcfg)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_llama_apply_matches_jax_bf16():
    """bf16 activations over fp32 master weights.  XLA may keep fp32
    intermediates inside its fusions where torch rounds each op to bf16,
    so activations differ by a few bf16 ulps (2**-8 relative) per op;
    through two layers and the fp32 head that stays under 1e-2 absolute
    on logits of magnitude ~0.7 (about twice the largest difference seen
    over three seeds), and the argmax agrees almost everywhere."""
    jcfg, tcfg = _configs(dtype="bfloat16")
    got, want = _forward_pair(jcfg, tcfg)
    np.testing.assert_allclose(got, want, atol=1e-2)
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    assert agree >= 0.95, agree


def test_llama_apply_gqa_and_window_match_jax():
    jcfg, tcfg = _configs(sliding_window=7)
    got, want = _forward_pair(jcfg, tcfg, seq=24, seed=1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    jcfg, tcfg = _configs(tie_embeddings=True)
    got, want = _forward_pair(jcfg, tcfg, seq=16, seed=2)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_negative_and_out_of_range_ids_match_jax():
    """JAX's ``embed[tokens]`` wraps negative ids and clamps the rest (as
    traced under ``jit``, the way its engines run the model; eager JAX
    raises on a concrete out-of-range id): -1 reads row V-1, V+3 and ids
    below -V read the last and first rows.  1e-4 as the fp32 forward
    above."""
    jcfg, tcfg = _configs()
    tree = _jax_params(jcfg)
    V = jcfg.vocab_size
    tokens = np.array([[-1, 5, V + 3, 0, -V - 2, 7, -V, V - 1]],
                      dtype=np.int32)
    apply = jax.jit(lambda p, t: jllama.llama_apply(p, t, jcfg))
    want = np.asarray(apply(tree, jnp.asarray(tokens)))
    params = params_from_jax(tree, tcfg, device="cpu")
    got = tllama.llama_apply(params, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # -1 reads the last row, as JAX does: the same logits as id V-1 at
    # position 0
    last = tllama.llama_apply(params, torch.tensor([[V - 1]]), tcfg).numpy()
    np.testing.assert_allclose(got[0, 0], last[0, 0], atol=1e-5)


def test_llama_apply_refuses_mesh():
    _, tcfg = _configs()
    params = tllama.llama_init(tcfg, device="cpu")
    # the mesh path itself is held against JAX in test_torch_parallel.py
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tllama.llama_apply(params, torch.zeros(1, 4, dtype=torch.long), tcfg,
                           mesh=object())


def test_presets_match_jax():
    for name in ("llama2_7b", "llama2_13b", "llama3_8b"):
        j, t = getattr(jllama.LlamaConfig, name)(), \
            getattr(tllama.LlamaConfig, name)()
        for f in dataclasses.fields(t):
            if f.name in ("dtype", "param_dtype"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.dtype == torch.bfloat16 and t.param_dtype == torch.float32
        assert t.num_params() == j.num_params()
