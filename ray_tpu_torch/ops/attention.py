"""Attention: plain reference, the dispatch onto the CUDA flash kernels,
and ring attention over the ``sp`` mesh axis.

Counterpart of ``ray_tpu/ops/attention.py``.  Under a mesh the inputs are
DTensors (global view).  With the sequence whole on each rank (sp = 1)
attention runs per local shard under ``local_map``, batch over dp/fsdp
and heads over tp, as the reference runs it under ``shard_map``; the flash
kernels then see plain local tensors.  With sp > 1 ``ring_attention``
splits the sequence over ``sp`` and rotates K/V blocks around the ring
with point-to-point sends while each rank accumulates blockwise
online-softmax output for its local Q block.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_size, compute_mesh
from ray_tpu_torch.parallel.p2p import RingShift
from ray_tpu_torch.parallel.sharding import as_global, shard_layout

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


def _blockwise_step(q, k, v, m, l, o, *, qpos, kpos, scale, window=None):
    """One online-softmax accumulation step against a K/V block.

    q: [b, sq, h, d]; k, v: [b, sk, h, d] (kv already GQA-expanded);
    m, l: [b, h, sq] running max / normalizer; o: [b, sq, h, d] fp32.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= sliding_window_mask(qpos[:, None], kpos[None, :], window)
    logits = torch.where(mask[None, None, :, :], logits, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # exp of fully-masked rows underflows to 0: no NaNs, m_new is finite
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def _laid_out(mesh, layout, *tensors):
    """``tensors`` (DTensors, or plain tensors every rank holds whole) as
    DTensors placed as ``layout``."""
    tensors = [as_global(t, mesh) for t in tensors]
    return [t if list(t.placements) == layout
            else t.redistribute(mesh, layout) for t in tensors]


def _per_shard(fn, mesh, layout, *tensors):
    """``fn`` on each rank's local blocks of ``tensors`` laid out as
    ``layout`` (``_laid_out``); the output is a DTensor in the same
    layout."""
    from torch.distributed.tensor.experimental import local_map

    tensors = _laid_out(mesh, layout, *tensors)
    return local_map(fn, out_placements=layout,
                     in_placements=(layout,) * len(tensors),
                     device_mesh=mesh)(*tensors)


def _ring_local(q, k, v, *, idx, sp, group, causal, window):
    """Ring attention on this rank's blocks ``[b, s/sp, h, d]`` (K/V
    GQA-expanded): ``sp`` accumulation steps, the K/V block rotating one
    rank down the ring between them; the last rotation, whose blocks
    nobody reads, is skipped."""
    b, sq, h, d = q.shape
    scale = d ** -0.5
    ar = torch.arange(sq, device=q.device)
    nxt = dist.get_global_rank(group, (idx + 1) % sp)
    prv = dist.get_global_rank(group, (idx - 1) % sp)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for t in range(sp):
        if causal:
            qpos, kpos = idx * sq + ar, (idx - t) % sp * sq + ar
        else:
            qpos = kpos = torch.zeros_like(ar)
        m, l, o = _blockwise_step(q, k, v, m, l, o, qpos=qpos, kpos=kpos,
                                  scale=scale, window=window)
        if t < sp - 1:
            k = RingShift.apply(k, group, nxt, prv)
            v = RingShift.apply(v, group, nxt, prv)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, sp_axis: str = "sp", causal: bool = True,
                   batch_axes=("dp", "fsdp"), head_axis: Optional[str] = "tp",
                   window: Optional[int] = None) -> torch.Tensor:
    """Ring attention over the ``sp`` mesh axis (global-view inputs).

    q [b, S, h, d], k and v [b, S, kv_h, d] are DTensors (or plain tensors
    every rank holds whole); K/V are GQA-expanded, the sequence is split
    over ``sp``, batch over ``batch_axes`` and heads over ``head_axis``,
    and each rank runs ``_ring_local`` on its blocks.  Returns a DTensor
    in that layout.
    """
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    mesh = compute_mesh(mesh)
    sp = axis_size(mesh, sp_axis)
    if sp == 1:
        return _per_shard(functools.partial(reference_attention,
                                            causal=causal, window=window),
                          mesh, shard_layout(mesh, (batch_axes, (),
                                                    (head_axis,))), q, k, v)
    if q.shape[1] % sp:
        raise ValueError(f"ring attention splits the sequence into equal "
                         f"blocks: {q.shape[1]} does not divide by sp={sp}")
    h, kv_h = q.shape[2], k.shape[2]
    k = _repeat_kv(as_global(k, mesh), h // kv_h)
    v = _repeat_kv(as_global(v, mesh), h // kv_h)
    layout = shard_layout(mesh, (batch_axes, (sp_axis,), (head_axis,)))
    local = functools.partial(_ring_local, idx=mesh.get_local_rank(sp_axis),
                              sp=sp, group=mesh.get_group(sp_axis),
                              causal=causal, window=window)
    return _per_shard(local, mesh, layout, q, k, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, impl: str = "auto",
                          mesh=None, sp_axis: str = "sp",
                          window: Optional[int] = None) -> torch.Tensor:
    """Dispatching attention entry point used by the model layer.

    impl: 'auto' | 'ref' | 'flash' | 'ring'.  'auto' picks ring when the
    mesh shards sequence (sp > 1), else the hand-written CUDA flash kernels
    for CUDA inputs with ``seq >= 256``, no window and a shape, dtype and
    layout the kernels take (``flash_takes``, on the local blocks under a
    mesh), and the reference otherwise.  'flash' is the differentiable
    flash op (K1 forward, K2/K3 backward); on CPU tensors it runs the
    kernels' plain PyTorch versions.  'ref' is plain autograd.  Under a
    mesh 'flash' and 'ref' run per local shard (batch over dp/fsdp,
    heads over tp, the sequence whole) and return a DTensor.
    """
    mesh = compute_mesh(mesh)
    if impl == "auto" and axis_size(mesh, sp_axis) > 1:
        impl = "ring"
    if impl == "ring":
        if mesh is None:
            raise ValueError("ring attention needs a mesh")
        return ring_attention(q, k, v, mesh=mesh, sp_axis=sp_axis,
                              causal=causal, window=window)
    if impl not in ("auto", "flash", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "flash" and window is not None:
        raise ValueError(
            "impl='flash' does not support sliding windows; use 'ref', "
            "'ring' or 'auto'")
    layout = None
    if mesh is not None:
        layout = shard_layout(mesh, (("dp", "fsdp"), (), ("tp",)))
        q, k, v = _laid_out(mesh, layout, q, k, v)
    if impl == "auto":
        local = [t.to_local() if layout else t for t in (q, k, v)]
        impl = ("flash" if q.is_cuda and q.shape[1] >= 256
                and window is None and flash_takes(*local) else "ref")
    if impl == "flash":
        from ray_tpu_torch.ops.cuda.flash_attention import flash_attention

        fn = functools.partial(flash_attention, causal=causal)
    else:
        fn = functools.partial(reference_attention, causal=causal,
                               window=window)
    return fn(q, k, v) if layout is None else _per_shard(fn, mesh, layout,
                                                         q, k, v)
