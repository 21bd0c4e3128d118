"""Port parity: ``ray_tpu_torch.ops`` against ``ray_tpu.ops`` on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  Float32
throughout unless a case says otherwise; each tolerance states its reason.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import layers as jlayers
from ray_tpu.ops.pallas import flash_attention as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as tflash

# the suite runs in several workers beside timing-sensitive cluster tests
torch.set_num_threads(1)

# fp32 elementwise and small reductions: both sides round the same
# operations; 1e-5 absorbs a last-ulp difference in exp/cos/pow between
# XLA's and torch's CPU kernels
ATOL_ELEM = 1e-5
# fp32 attention and products over up to a few hundred terms, summed in
# another order by each framework
ATOL_ATTN = 1e-4


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 2, 5, 32), _rand(rng, 32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))
    got = tlayers.rms_norm(_t(x), _t(s))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_ELEM)


def test_rope_frequencies():
    jc, js = jlayers.rope_frequencies(16, 64, 10000.0)
    tc, ts = tlayers.rope_frequencies(16, 64, 10000.0)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=ATOL_ELEM)
    np.testing.assert_allclose(_np(ts), _np(js), atol=ATOL_ELEM)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope(precise, with_positions):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 32, size=(2, 7)).astype(np.int32)
    jc, js = jlayers.rope_frequencies(16, 32)
    tc, ts = tlayers.rope_frequencies(16, 32)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js,
                              jnp.asarray(pos) if with_positions else None,
                              precise=precise)
    got = tlayers.apply_rope(_t(x), tc, ts,
                             _t(pos).long() if with_positions else None,
                             precise=precise)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_ELEM)


@pytest.mark.parametrize("precise", [False, True])
def test_apply_rope_bf16(precise):
    """bf16 input: the rotation runs in bf16 unless precise.  XLA may keep
    fp32 intermediates inside a fusion where torch rounds each op to bf16,
    so the bound is two bf16 ulps (2**-7 relative) of the |x| <= 4 range."""
    rng = np.random.default_rng(2)
    x = _rand(rng, 1, 9, 2, 16)
    jc, js = jlayers.rope_frequencies(16, 16)
    tc, ts = tlayers.rope_frequencies(16, 16)
    want = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16), jc, js,
                              precise=precise)
    got = tlayers.apply_rope(_t(x).bfloat16(), tc, ts, precise=precise)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=4 * 2 ** -7)


def test_swiglu():
    rng = np.random.default_rng(3)
    g, u = _rand(rng, 3, 40, scale=3.0), _rand(rng, 3, 40)
    want = jlayers.swiglu(jnp.asarray(g), jnp.asarray(u))
    got = tlayers.swiglu(_t(g), _t(u))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_ELEM)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_reference_attention_gqa(causal, window):
    rng = np.random.default_rng(4)
    q = _rand(rng, 2, 12, 4, 16)
    k, v = _rand(rng, 2, 12, 2, 16), _rand(rng, 2, 12, 2, 16)
    want = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window)
    got = tattn.reference_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_ATTN)


def test_sliding_window_mask_convention():
    qp, kp = np.arange(8)[:, None], np.arange(8)[None, :]
    want = np.asarray(jattn.sliding_window_mask(jnp.asarray(qp),
                                                jnp.asarray(kp), 3))
    got = tattn.sliding_window_mask(_t(qp), _t(kp), 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_dot_product_attention_dispatch(monkeypatch):
    """CPU inputs take the reference under 'auto' even at s >= 256; 'flash'
    goes through the flash entry (its plain version on the CPU); a window
    with 'flash' raises as in JAX; ring without a mesh raises, as JAX's
    asserts, and a mesh that is not a ``DeviceMesh`` is refused (the mesh
    paths are held against JAX in test_torch_parallel.py)."""
    rng = np.random.default_rng(5)
    q = _t(_rand(rng, 1, 256, 2, 16))
    k, v = _t(_rand(rng, 1, 256, 1, 16)), _t(_rand(rng, 1, 256, 1, 16))
    calls = []
    real = tflash.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention", spy)
    auto = tattn.dot_product_attention(q, k, v)
    assert not calls
    assert torch.equal(auto, tattn.reference_attention(q, k, v))
    flash = tattn.dot_product_attention(q, k, v, impl="flash")
    assert calls == [1]
    np.testing.assert_allclose(_np(flash), _np(auto), atol=ATOL_ATTN)
    with pytest.raises(ValueError, match="sliding windows"):
        tattn.dot_product_attention(q, k, v, impl="flash", window=8)
    with pytest.raises(ValueError, match="ring attention needs a mesh"):
        tattn.dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tattn.dot_product_attention(q, k, v, mesh=object())


def test_auto_flash_eligibility_predicate():
    """'auto' sends a CUDA input to the flash kernels only where they take
    it; head_dim 16, fp16, b * h = 65536, a non-unit stride on d and (for
    bf16, whose K1 and K3 load tiles by TMA) a base or stride off 16 bytes
    go to the reference (the JAX flash op computes any of them), as does
    any window.  The predicate and the wrappers' check are one function,
    so what it refuses the kernels raise on, with the same reason."""
    def takes(shape, dtype):
        q = torch.empty(shape, dtype=dtype, device="meta")
        return tattn.flash_takes(q, q, q)

    assert takes((1, 2048, 32, 128), torch.bfloat16)  # the main path
    assert takes((2, 512, 16, 64), torch.float32)
    assert takes((1, 256, 65535, 64), torch.bfloat16)
    assert not takes((1, 256, 4, 16), torch.float32)    # LlamaConfig.tiny
    assert not takes((1, 256, 32, 128), torch.float16)
    assert not takes((1, 256, 32, 128), torch.float64)
    assert not takes((2, 256, 32768, 64), torch.bfloat16)  # b * h = 65536
    assert not takes((1, 256, 65536, 128), torch.float32)
    # layouts, on real tensors: the predicate reads strides and addresses
    qkv = torch.zeros(1, 256, 12, 128, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert tattn.flash_takes(q, k, v)  # heads sliced out: unit d-stride
    d_strided = torch.zeros(1, 256, 4, 256, dtype=torch.bfloat16)[..., ::2]
    assert d_strided.shape[3] == 128 and d_strided.stride(3) == 2
    assert not tattn.flash_takes(d_strided, k[:, :, :1], v[:, :, :1])
    assert not tattn.flash_takes(q, d_strided, d_strided)
    flat = torch.zeros(256 * 4 * 128 + 1, dtype=torch.bfloat16)
    off_base = flat[1:].view(1, 256, 4, 128)  # base 2 bytes past 16
    assert not tattn.flash_takes(off_base, k, v)
    odd_rows = torch.zeros(1, 256, 4, 129, dtype=torch.bfloat16)[..., :128]
    assert odd_rows.stride()[:3] == (256 * 4 * 129, 4 * 129, 129)
    assert not tattn.flash_takes(odd_rows, k, v)  # 258-byte head stride
    # fp32 keeps the FMA kernels, which take any stride but d's
    odd32 = torch.zeros(1, 256, 4, 129)[..., :128]
    kf, vf = k.float(), v.float()
    assert tattn.flash_takes(odd32, kf, vf)
    assert tattn.flash_takes(torch.zeros(256 * 4 * 128 + 1)[1:]
                             .view(1, 256, 4, 128), kf, vf)
    assert not tattn.flash_takes(torch.zeros(1, 256, 4, 256)[..., ::2], kf,
                                 vf)
    for bad in (d_strided, off_base, odd_rows):
        reason = tflash.kernel_input_problem(bad, k, v)
        with pytest.raises(ValueError, match=reason.split("(")[0]):
            tflash._check_kernel_inputs("K1", bad, k, v)


def test_kernel_library_rebuilds_on_header_edit(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source, every
    ``csrc/*.cuh`` header and the flags: editing the shared Hopper header
    renames every library (so a stale build is never loaded), and editing
    one source renames only its own."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    shutil.copytree(csrc, tmp_path / "csrc")
    monkeypatch.setattr(_build, "_HERE", str(tmp_path))
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert before == {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(tmp_path / "csrc" / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    with open(tmp_path / "csrc" / _build.SOURCES["flash_fwd"], "a") as f:
        f.write("\n// edited\n")
    again = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if again[n] != after[n]] \
        == ["flash_fwd"]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(causal):
    """K1's plain version against the Pallas forward in interpret mode,
    at block 32 on s=96 with GQA (h=4 over kv_h=2): output and lse."""
    rng = np.random.default_rng(6)
    b, s, h, kvh, d = 1, 96, 4, 2, 16
    q, k, v = (_rand(rng, b, s, h, d), _rand(rng, b, s, kvh, d),
               _rand(rng, b, s, kvh, d))
    jout, jlse = jflash._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, interpret=True)
    tout, tlse = tflash.flash_attention_fwd(_t(q), _t(k), _t(v),
                                            causal=causal)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL_ATTN)
    jlse = np.asarray(jlse).reshape(b, h, -1)[:, :, :s]
    np.testing.assert_allclose(_np(tlse), jlse, atol=ATOL_ATTN)
    # and the public entries agree
    jpub = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=32, block_k=32)
    tpub = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(tpub), _np(jpub), atol=ATOL_ATTN)


def test_flash_plain_pad_rows_and_ragged_length():
    """sq not a multiple of any tile, and sk != sq (non-causal): matches
    the reference attention the kernel is defined against."""
    rng = np.random.default_rng(7)
    q = _rand(rng, 2, 37, 4, 16)
    k, v = _rand(rng, 2, 53, 4, 16), _rand(rng, 2, 53, 4, 16)
    out, lse = tflash.flash_attention_fwd(_t(q), _t(k), _t(v), causal=False)
    want = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False)
    np.testing.assert_allclose(_np(out), _np(want), atol=ATOL_ATTN)
    assert lse.shape == (2, 4, 37) and lse.dtype == torch.float32


def test_flash_wrapper_refuses_grad_and_bad_inputs():
    """The flash op takes inputs that require grad (the backward, K2/K3,
    is ported: on CPU tensors it runs their plain version) and grads reach
    q, k and v; malformed inputs still raise."""
    rng = np.random.default_rng(8)
    q = _t(_rand(rng, 1, 8, 2, 16))
    qg, kg, vg = (_t(_rand(rng, 1, 8, 2, 16)).requires_grad_()
                  for _ in range(3))
    tflash.flash_attention(qg, kg, vg).sum().backward()
    for t in (qg, kg, vg):
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all()) and bool(t.grad.abs().sum())
    with pytest.raises(ValueError, match="not a multiple"):
        tflash.flash_attention_fwd(_t(_rand(rng, 1, 8, 3, 16)), q, q)
    with pytest.raises(ValueError, match="dtypes differ"):
        tflash.flash_attention_fwd(q, q.double(), q.double())


def test_no_cpu_fallback_for_cuda(monkeypatch):
    """Without CUDA, asking for the card raises: the entry points never
    carry on silently on the host, and a missing nvcc is an error, not a
    warning."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: llama_init(cfg, 0, device="cuda"),
                 lambda: llama_init(cfg, 0),
                 lambda: LLMEngine(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_DEFAULTS", ())
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
