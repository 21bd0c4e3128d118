"""Flash attention as hand-written CUDA kernels for Hopper: K1, K2, K3.

- K1, the forward, replaces ``ray_tpu/ops/pallas/flash_attention.py::
  _fwd_kernel`` (launched by ``_flash_fwd_impl``): ``csrc/flash_fwd.cu``.
- K2 (dQ) and K3 (dK, dV), the backward, replace ``_dq_kernel`` and
  ``_dkv_kernel`` (launched by ``_flash_bwd_impl``): ``csrc/flash_bwd.cu``.

Each source is CUDA C++ for sm_90a, built on first use by ``_build.py``
and called through its plain C interface with ``ctypes``; the note at the
top of each says what bounds the kernel on an H100 and how the TPU design
changes.  bfloat16 inputs (the main path) take K1, K2 and K3 on the
tensor cores (wgmma, with TMA tile loads; ``csrc/hopper.cuh``); float32
inputs take the first design, fp32 FMA on the CUDA cores.
``kernel_input_problem`` says which inputs the kernels take.

``flash_attention_plain`` and ``flash_attention_bwd_plain`` are the same
functions in plain PyTorch: the CPU tests use them, and ``chip_smoke.py``
holds the kernels against them on the card.  The wrappers take them only
for tensors on the CPU; for CUDA tensors they launch the kernels or
raise.  ``flash_attention_fwd.launches`` counts K1 launches,
``flash_attention_bwd.dq_launches`` K2's and
``flash_attention_bwd.dkv_launches`` K3's.

``flash_attention`` is the differentiable op, the counterpart of the JAX
``custom_vjp``: the custom op ``ray_tpu_torch::flash_attention`` returns
``(out, lse)``, saves ``(q, k, v, out, lse)`` and its backward runs
``flash_attention_bwd``.  Being one op to the dispatcher, it is what the
``save_attn`` remat policy keeps (``models/llama.py``), so the backward
does not replay K1.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import _NEG_INF, _repeat_kv

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# b * h: the fp32 kernels' grid y dimension (the bf16 kernels put b * h,
# or b * kv_h, on grid x); one limit for both types
_MAX_GRID_Y = 65535
_TMA_ALIGN = 16      # bytes: TMA's alignment of base addresses and strides
_K3_ROWS = 64        # q rows per tile of K3's bf16 kernel


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


def _bshd_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """Element strides of a [b, s, h, d] tensor on b, s and h as the
    kernels take them.  A dimension of size 1 is never stepped, so it gets
    the stride a contiguous tensor would have (torch may report any)."""
    _, s, h, d = t.shape
    sb, ss, sh = t.stride()[:3]
    if h == 1:
        sh = d
    if s == 1:
        ss = sh * h
    if t.shape[0] == 1:
        sb = ss * s
    return sb, ss, sh


def kernel_input_problem(*tensors: torch.Tensor) -> Optional[str]:
    """Why the CUDA flash kernels do not take these [b, s, h, d] tensors
    (q first, all of one dtype), or None if they do: float32 or bfloat16,
    head_dim 64 or 128, unit stride on the head dimension, b * h within
    the grid's y limit, and for bfloat16 (the TMA loads of K1-K3) a
    16-byte aligned base and b/s/h strides.  ``_check_kernel_inputs``
    raises with this reason; ``ops.attention.flash_takes`` sends what it
    names to the reference attention."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODE:
        return f"takes float32 or bfloat16, got {q.dtype}"
    if q.shape[3] not in _HEAD_DIMS:
        return f"takes head_dim in {_HEAD_DIMS}, got {q.shape[3]}"
    if any(t.stride(3) != 1 for t in tensors):
        return "needs unit stride on the head dimension"
    if q.shape[0] * q.shape[2] > _MAX_GRID_Y:
        return (f"b * h = {q.shape[0] * q.shape[2]} exceeds the grid's y "
                "limit")
    if q.dtype == torch.bfloat16:
        esize = q.element_size()
        for t in tensors:
            if t.data_ptr() % _TMA_ALIGN or any(
                    st * esize % _TMA_ALIGN for st in _bshd_strides(t)):
                return ("takes bfloat16 only with a 16-byte aligned base "
                        "and b/s/h strides (TMA loads)")
    return None


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    problem = kernel_input_problem(*tensors)
    if problem is not None:
        raise ValueError(f"{name} {problem}")


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
    _check_kernel_inputs("K1", q, k, v)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ray_tpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], b, sq, sk, h, kv_h, d,
            int(causal), *_bshd_strides(q), *_bshd_strides(k),
            *_bshd_strides(v), d ** -0.5, stream)
    if err:
        raise RuntimeError("K1 flash_fwd launch failed: "
                           + lib.ray_tpu_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [b, sq, h, d], lse [b, h, sq] fp32)``.  CUDA tensors launch
    K1 (what ``kernel_input_problem`` names raises); CPU tensors run
    ``flash_attention_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, not {q.device}")
    return _launch(q, k, v, causal)


flash_attention_fwd.launches = 0




def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of K2 and K3: ``(dq, dk, dv)``.

    ``P = exp(S * d**-0.5 - lse)`` with keys past the causal diagonal at
    -1e30, ``dS = P * (dO V^T - D)`` with ``D = rowsum(dO * O)`` in fp32;
    ``dq = scale * dS K`` and ``dk = scale * dS^T Q`` with dS cast to the
    input dtype first, ``dv = P^T dO`` with P cast to dO's dtype first;
    fp32 accumulation, grouped q-heads summed onto their kv head.
    """
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    scale = d ** -0.5
    kx = _repeat_kv(k, h // kv_h).float()
    vx = _repeat_kv(v, h // kv_h).float()
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # [b, h, sq]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kx) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vx)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kx) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dk = dk.reshape(b, sk, kv_h, h // kv_h, d).sum(3)
    dv = dv.reshape(b, sk, kv_h, h // kv_h, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib() -> ctypes.CDLL:
    from ray_tpu_torch.ops.cuda import _build

    lib = _build.load("flash_bwd")
    if not lib.ray_tpu_flash_bwd.argtypes:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ray_tpu_flash_bwd.argtypes = (
            [i32] + [ptr] * 10 + [i32] * 8 + [i64] * 12
            + [ctypes.c_float, ptr])
        lib.ray_tpu_flash_bwd.restype = ctypes.c_int
        lib.ray_tpu_flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ray_tpu_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ray_tpu_flash_bwd_error_string(err).decode())


def _launch_bwd(q, k, v, out, lse, do, causal):
    _check_kernel_inputs("K2/K3", q, k, v, do)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape \
            or do.dtype != q.dtype or lse.shape != (b, h, sq) \
            or lse.dtype != torch.float32:
        raise ValueError(
            f"K2/K3 take out and do shaped and typed as q {tuple(q.shape)} "
            f"{q.dtype} and fp32 lse [b, h, sq]; got out "
            f"{tuple(out.shape)}, do {tuple(do.shape)} {do.dtype}, lse "
            f"{tuple(lse.shape)} {lse.dtype}")
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        lse = lse.contiguous()
        # D = rowsum(dO * O), as JAX computes it outside the kernels
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        lsed = None
        if q.dtype == torch.bfloat16:
            # K3's tiles of lse and D rows: [b * h, 2, whole tiles], zero
            # past sq, so one bulk copy takes each row of a tile
            width = -(-sq // _K3_ROWS) * _K3_ROWS
            lsed = lse.new_zeros((b * h, 2, width))
            lsed[:, 0, :sq] = lse.reshape(b * h, sq)
            lsed[:, 1, :sq] = delta.reshape(b * h, sq)
        dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, sk, kv_h, d), dtype=k.dtype, device=q.device)
        dv = torch.empty((b, sk, kv_h, d), dtype=v.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                None if lsed is None else lsed.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, sq,
                sk, h, kv_h, d, int(causal), *_bshd_strides(q),
                *_bshd_strides(k), *_bshd_strides(v), *_bshd_strides(do),
                d ** -0.5, stream)
        _raise_on(lib, lib.ray_tpu_flash_bwd(0, *args), "K2 flash_bwd dq")
        flash_attention_bwd.dq_launches += 1
        _raise_on(lib, lib.ray_tpu_flash_bwd(1, *args), "K3 flash_bwd dkv")
        flash_attention_bwd.dkv_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention from the forward's residuals
    ``out`` and ``lse [b, h, sq] fp32`` and the output grad ``do``.  CUDA
    tensors launch K2 then K3 (what ``kernel_input_problem`` names
    raises); CPU tensors run ``flash_attention_bwd_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"K2/K3 run on CUDA or the CPU, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, do, causal)


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


@torch.library.custom_op("ray_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of ``flash_attention_fwd`` as one differentiable op."""
    return flash_attention_fwd(q, k, v, causal=causal)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, out, lse)


def _flash_backward(ctx, g_out, _g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out.contiguous(),
                                     causal=ctx.causal)
    return dq, dk, dv, None


flash_attention_op.register_autograd(_flash_backward,
                                     setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention output, differentiable (K1 forward, K2/K3 backward
    on CUDA).  q: [b, s, h, d]; k, v: [b, s, kv_h, d]."""
    return flash_attention_op(q, k, v, causal)[0]
