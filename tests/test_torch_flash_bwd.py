"""Port parity: the flash-attention backward (K2, K3) on the CPU.

The port's differentiable flash op runs its plain forward and backward on
CPU tensors; the JAX side runs the Pallas kernels in interpret mode at
block 32.  Inputs are made with numpy from a seed and fed to both
packages, in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops.pallas import flash_attention as jflash
from ray_tpu_torch.ops.cuda import flash_attention as tflash

# the suite runs in several workers beside timing-sensitive cluster tests
torch.set_num_threads(1)

# fp32 attention and its grads: products over up to 96 terms, summed in
# another order by each framework
ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _inputs(seed, b, s, h, kvh, d=16):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, s, h, d), _rand(rng, b, s, kvh, d),
            _rand(rng, b, s, kvh, d), _rand(rng, b, s, h, d))


@pytest.mark.parametrize("causal,s,h,kvh", [
    (True, 96, 4, 2),    # GQA, three 32-blocks
    (False, 96, 4, 2),   # GQA, non-causal
    (True, 77, 2, 2),    # ragged: the Pallas side pads to 96
])
def test_flash_op_grads_match_jax_vjp(causal, s, h, kvh):
    """Output and dq, dk, dv of the port's flash op against ``jax.vjp`` of
    the Pallas flash attention."""
    q, k, v, g = _inputs(0, 1, s, h, kvh)
    jout, vjp = jax.vjp(
        lambda q_, k_, v_: jflash.flash_attention(
            q_, k_, v_, causal=causal, block_q=32, block_k=32),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tout = tflash.flash_attention(tq, tk, tv, causal=causal)
    tout.backward(_t(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"d{name}")


# bf16: both sides round dS (and P for dV) to bf16 at the same points and
# write bf16 outputs, so an element differs only where fp32 sums taken in
# another order flip its final rounding: one bf16 ulp (rtol 2^-7; atol for
# elements near zero), a few elements, so the whole output's relative L2
# error stays far below 1e-5.  A plain version that rounds P before dS K,
# or does not round dS, fails this case.
BF16_ATOL, BF16_RTOL, BF16_REL_L2 = 1e-5, 2 ** -7, 1e-5


@pytest.mark.parametrize("causal,s,dtype", [
    pytest.param(True, 96, "float32", id="True-96"),
    pytest.param(False, 96, "float32", id="False-96"),
    pytest.param(True, 80, "float32", id="True-80"),
    pytest.param(True, 80, "bfloat16", id="True-80-bfloat16"),
])
def test_bwd_plain_matches_pallas_bwd_interpret(causal, s, dtype):
    """``flash_attention_bwd_plain`` against ``_flash_bwd_impl`` (the
    launches of ``_dq_kernel`` and ``_dkv_kernel``) given the same
    residuals, GQA h=4 over kv_h=2; in bf16 (b=1, d=64) this holds the
    points where the plain version, and so the CUDA kernels held to it,
    round P and dS to the JAX package's."""
    b, d = (1, 64) if dtype == "bfloat16" else (2, 16)
    h, kvh = 4, 2
    q, k, v, g = _inputs(1, b, s, h, kvh, d)
    jq, jk, jv, jg = (jnp.asarray(x).astype(dtype) for x in (q, k, v, g))
    jout, jlse = jflash._flash_fwd_impl(jq, jk, jv, causal=causal,
                                        block_q=32, block_k=32,
                                        interpret=True)
    want = jflash._flash_bwd_impl((jq, jk, jv, jout, jlse), jg,
                                  causal=causal, block_q=32, block_k=32,
                                  interpret=True)
    # JAX keeps lse padded and head-folded: [b*h, 1, s_pad] -> [b, h, s]
    lse = np.asarray(jlse).reshape(b, h, -1)[:, :, :s]

    def same(x):  # a JAX array as a torch tensor of its dtype, bit-exact
        return _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))

    got = tflash.flash_attention_bwd_plain(
        same(jq), same(jk), same(jv), same(jout), _t(lse), same(jg),
        causal=causal)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and a.dtype == getattr(torch, dtype)
        a, w = a.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, w, atol=ATOL, err_msg=f"d{name}")
            continue
        np.testing.assert_allclose(a, w, atol=BF16_ATOL, rtol=BF16_RTOL,
                                   err_msg=f"d{name}")
        rel_l2 = np.linalg.norm(a - w) / np.linalg.norm(w)
        assert rel_l2 <= BF16_REL_L2, (f"d{name}", rel_l2)


def test_bwd_wrapper_runs_plain_on_cpu():
    """On CPU tensors ``flash_attention_bwd`` is its plain version, and the
    kernel launch counters do not move."""
    q, k, v, g = (_t(a) for a in _inputs(2, 1, 40, 4, 2))
    out, lse = tflash.flash_attention_fwd(q, k, v)
    before = (tflash.flash_attention_bwd.dq_launches,
              tflash.flash_attention_bwd.dkv_launches)
    got = tflash.flash_attention_bwd(q, k, v, out, lse, g)
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (tflash.flash_attention_bwd.dq_launches,
            tflash.flash_attention_bwd.dkv_launches) == before
