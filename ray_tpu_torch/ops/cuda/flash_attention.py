"""K1: flash-attention forward as a hand-written CUDA kernel for Hopper.

Replaces ``ray_tpu/ops/pallas/flash_attention.py::_fwd_kernel`` (launched
by ``_flash_fwd_impl``).  The kernel is ``csrc/flash_fwd.cu`` (CUDA C++
for sm_90a), built on first use by ``_build.py`` and called through its
plain C interface with ``ctypes``.  The source note there says what bounds
the kernel on an H100 and how the TPU design changes.

``flash_attention_plain`` is the same function in plain PyTorch: the CPU
tests use it, and ``chip_smoke.py`` holds the kernel against it on the
card.  The wrapper takes it only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  ``flash_attention_fwd.launches`` counts
kernel launches.

Forward only: the backward kernels (K2, K3) come with the training slice,
so inputs that require grad are refused.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.attention import _NEG_INF, _repeat_kv

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: ``(out [b, sq, h, d], lse [b, h, sq])``.

    fp32 logits scaled by ``d**-0.5``, keys past the causal diagonal masked
    with -1e30, P cast to ``v.dtype`` before the PV product, fp32
    accumulation, ``lse = m + log(max(l, 1e-30))``.
    """
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kv_h)
    v = _repeat_kv(v, h // kv_h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * d ** -0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = pv / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q [b, sq, h, d] and "
                         "k, v [b, sk, kv_h, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "the flash-attention backward (K2/K3) comes with the training "
            "slice of the port; K1 is forward only")


def _lib() -> ctypes.CDLL:
    from ray_tpu_torch.ops.cuda import _build

    lib = _build.load("flash_fwd")
    if not lib.ray_tpu_flash_fwd.argtypes:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ray_tpu_flash_fwd.argtypes = (
            [ptr] * 5 + [i32] * 8 + [i64] * 9 + [ctypes.c_float, ptr])
        lib.ray_tpu_flash_fwd.restype = ctypes.c_int
        lib.ray_tpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"K1 takes head_dim in {_HEAD_DIMS}, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("K1 needs unit stride on the head dimension")
    if b * h > 65535:
        raise ValueError(f"b * h = {b * h} exceeds the grid's y limit")
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ray_tpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], b, sq, sk, h, kv_h, d,
            int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            d ** -0.5, stream)
    if err:
        raise RuntimeError("K1 flash_fwd launch failed: "
                           + lib.ray_tpu_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [b, sq, h, d], lse [b, h, sq] fp32)``.  CUDA tensors launch
    K1 (head_dim 64 or 128, float32 or bfloat16; anything else raises);
    CPU tensors run ``flash_attention_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, not {q.device}")
    return _launch(q, k, v, causal)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention output. q: [b, s, h, d]; k, v: [b, s, kv_h, d]."""
    return flash_attention_fwd(q, k, v, causal=causal)[0]
