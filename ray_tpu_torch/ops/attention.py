"""Attention: plain reference and the dispatch onto the CUDA flash kernels.

Counterpart of ``ray_tpu/ops/attention.py``.  Ring attention (the ``sp``
mesh axis) belongs to the parallel slice and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def sliding_window_mask(q_pos, k_pos, window):
    """Sliding-window visibility clause: query at ``q_pos`` sees keys in
    ``(q_pos - window, q_pos]``.  Args broadcast."""
    return q_pos - k_pos < window


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, d] -> [b, s, kv_heads * n_rep, d] (GQA expansion)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        positions_q: Optional[torch.Tensor] = None,
                        positions_k: Optional[torch.Tensor] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention, fp32 logits and accumulation.

    q: [b, sq, h, d]; k, v: [b, sk, kv_h, d] with h % kv_h == 0.
    ``window``: sliding window, query p attends keys in (p - window, p];
    requires causal.
    """
    b, sq, h, d = q.shape
    kv_h = k.shape[2]
    k = _repeat_kv(k, h // kv_h)
    v = _repeat_kv(v, h // kv_h)
    scale = d ** -0.5
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    # fp32 logits: upcasting bf16 operands is exact for the products
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        if positions_q is None:
            positions_q = torch.arange(sq, device=q.device)
        if positions_k is None:
            positions_k = torch.arange(k.shape[1], device=q.device)
        mask = positions_q[:, None] >= positions_k[None, :]
        if window is not None:
            mask &= sliding_window_mask(positions_q[:, None],
                                        positions_k[None, :], window)
        logits = torch.where(mask[None, None, :, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def flash_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the CUDA flash kernels take ``q [b, s, h, d]``, ``k`` and
    ``v``: the same conditions on which their wrappers raise
    (``kernel_input_problem``: dtype, head_dim, unit stride on d, b * h,
    and the alignment of the TMA loads).  'auto' sends everything else to
    ``reference_attention``, where the JAX flash op computes any shape and
    layout."""
    from ray_tpu_torch.ops.cuda.flash_attention import kernel_input_problem

    return kernel_input_problem(q, k, v) is None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, impl: str = "auto",
                          mesh=None, sp_axis: str = "sp",
                          window: Optional[int] = None) -> torch.Tensor:
    """Dispatching attention entry point used by the model layer.

    impl: 'auto' | 'ref' | 'flash'.  'auto' picks the hand-written CUDA
    flash kernels for CUDA inputs with ``seq >= 256``, no window and a
    shape, dtype and layout the kernels take (``flash_takes``), and the
    reference otherwise.  'flash' is the differentiable flash op (K1
    forward, K2/K3 backward); on CPU tensors it runs the kernels' plain
    PyTorch versions.  'ref' is plain autograd.  'ring' and a mesh belong
    to the parallel slice.
    """
    if impl == "ring" or mesh is not None:
        raise NotImplementedError(
            "ring attention and mesh-sharded attention come with the "
            "parallel slice of the port (ROADMAP Queue 1, item 7)")
    if impl == "auto":
        impl = ("flash" if q.is_cuda and q.shape[1] >= 256
                and window is None and flash_takes(q, k, v)
                else "ref")
    if impl == "flash":
        if window is not None:
            raise ValueError(
                "impl='flash' does not support sliding windows; use 'ref' "
                "or 'auto'")
        from ray_tpu_torch.ops.cuda.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if impl != "ref":
        raise ValueError(f"unknown attention impl {impl!r}")
    return reference_attention(q, k, v, causal=causal, window=window)
