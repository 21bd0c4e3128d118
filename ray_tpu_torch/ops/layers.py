"""Elementwise/norm/rotary building blocks (plain PyTorch, no kernels).

Counterpart of ``ray_tpu/ops/layers.py``: computation in fp32 and cast
back, split-halves rotary, fp32 SwiGLU gate.  ``swiglu_op`` is
``swiglu`` as one op to the dispatcher (``ray_tpu_torch::swiglu``), so
that a remat policy can keep its output by name, as JAX's keeps
``mlp_act``; the serving paths, which record no graph, call ``swiglu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, output in x.dtype. scale has shape [dim]."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.reciprocal(torch.sqrt(var + eps))
    return (x * scale.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary cos/sin tables [max_seq_len, head_dim // 2] (fp32)."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               precise: bool = False) -> torch.Tensor:
    """Rotary position embedding, split halves (not interleaved).

    x: [batch, seq, heads, head_dim]; cos/sin: [max_seq, head_dim//2];
    positions: optional [batch, seq] integer positions (default arange).
    The rotation runs in x.dtype unless ``precise=True`` (fp32), as in the
    JAX reference.
    """
    s = x.shape[1]
    ct = torch.float32 if precise else x.dtype
    if positions is None:
        cos_g = cos[:s][None, :, None, :].to(ct)
        sin_g = sin[:s][None, :, None, :].to(ct)
    else:
        cos_g = cos[positions][:, :, None, :].to(ct)
        sin_g = sin[positions][:, :, None, :].to(ct)
    x1, x2 = torch.chunk(x.to(ct), 2, dim=-1)
    out = torch.cat([x1 * cos_g - x2 * sin_g, x2 * cos_g + x1 * sin_g],
                    dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU activation: silu(gate) * up, with an fp32 sigmoid gate."""
    g = gate.float()
    return (g * torch.reciprocal(1.0 + torch.exp(-g))).to(gate.dtype) * up


@torch.library.custom_op("ray_tpu_torch::swiglu", mutates_args=())
def swiglu_op(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``swiglu`` as one differentiable op, bit-equal to it forward and
    backward (the backward repeats autograd's chain through ``swiglu``
    step by step, in the same order)."""
    return swiglu(gate, up)


@swiglu_op.register_fake
def _swiglu_fake(gate, up):
    return torch.empty(torch.broadcast_shapes(gate.shape, up.shape),
                       dtype=torch.promote_types(gate.dtype, up.dtype),
                       device=gate.device)


def _swiglu_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _swiglu_backward(ctx, grad):
    gate, up = ctx.saved_tensors
    g = gate.float()
    e = torch.exp(-g)
    r = torch.reciprocal(1.0 + e)
    d_up = grad * (g * r).to(gate.dtype)
    d_act = (grad * up).float()
    # d/dg of g * r(g): r directly, plus g * r^2 * e through 1 / (1 + e)
    d_gate = d_act * r + d_act * g * (r * r) * e
    return d_gate.to(gate.dtype), d_up


swiglu_op.register_autograd(_swiglu_backward,
                            setup_context=_swiglu_setup_context)
