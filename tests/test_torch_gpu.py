"""The port's CUDA kernels on the card against their plain versions.

Marked ``gpu``: they skip without a CUDA device.  This file imports
neither JAX nor the JAX package, so on the card it runs without the
shared ``tests/conftest.py`` (which sets up JAX on the CPU):
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``.
"""

import pytest
import torch

from ray_tpu_torch.ops.cuda import flash_attention as flash

BWD_ATOL = (2e-3, 8e-3, 1.6e-2)  # dq, dk, dv


def assert_bwd_close(got, want, atol):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=2 ** -7)
    rel_l2 = torch.linalg.vector_norm(got - want) \
        / torch.linalg.vector_norm(want)
    assert rel_l2 <= 1e-3, rel_l2


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (bf16, GQA, ragged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 300, 8, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    before = flash.flash_attention_fwd.launches
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    pout, plse = flash.flash_attention_plain(q, k, v, causal=True)
    # bf16 output rounding and P cast to bf16 before PV
    torch.testing.assert_close(out.float(), pout.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_bwd_kernels_match_plain_on_card():
    """K2 and K3 on the card against their plain version (bf16, GQA,
    ragged), and the op's autograd launching K1, K2 and K3 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2/K3 have no CPU or interpret "
                    "mode")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, do = (randn(1, 300, 8, 128), randn(1, 300, 2, 128),
                   randn(1, 300, 2, 128), randn(1, 300, 8, 128))
    out, lse = flash.flash_attention_fwd(q, k, v)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do)
    # chip_smoke.py's BWD_TOL["bfloat16"]: both sides round P, dS and the
    # outputs to bf16, so a differing element is off by about one ulp
    # (rtol 2^-7); atol twice the largest H100 readings of dq, dk, dv; the
    # relative L2 error catches a systematic error (1% scale: 1e-2)
    for a, w, atol in zip(got, want, BWD_ATOL):
        assert_bwd_close(a, w, atol)
    counts = (flash.flash_attention_fwd.launches,
              flash.flash_attention_bwd.dq_launches,
              flash.flash_attention_bwd.dkv_launches)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    flash.flash_attention(qg, kg, vg).backward(do)
    torch.cuda.synchronize()
    assert (flash.flash_attention_fwd.launches,
            flash.flash_attention_bwd.dq_launches,
            flash.flash_attention_bwd.dkv_launches) == tuple(
                c + 1 for c in counts)
    assert_bwd_close(qg.grad, want[0], BWD_ATOL[0])
