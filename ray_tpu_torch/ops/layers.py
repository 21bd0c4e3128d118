"""Elementwise/norm/rotary building blocks (plain PyTorch, no kernels).

Counterpart of ``ray_tpu/ops/layers.py``: computation in fp32 and cast
back, split-halves rotary, fp32 SwiGLU gate.
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
