"""Point-to-point steps with gradients: the ring shift of ring attention
(K/V blocks around ``sp``) and of the pipeline (activations from stage to
stage), the counterpart of the reference's collective-permutes
(``ppermute`` and the ``jnp.roll`` on a stage-sharded buffer)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sendrecv(x: torch.Tensor, send_to: int, recv_from: int,
              group) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and return what global rank
    ``recv_from`` sends, as one batched pair of point-to-point ops."""
    x = x.contiguous()
    out = torch.empty_like(x)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, send_to, group),
            dist.P2POp(dist.irecv, out, recv_from, group)]):
        work.wait()
    return out


class RingShift(torch.autograd.Function):
    """One step of a ring: each rank sends its tensor to ``send_to`` and
    gets ``recv_from``'s.  The backward is the same step the other way
    round, so gradients follow the data back around the ring."""

    @staticmethod
    def forward(ctx, x, group, send_to, recv_from):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _sendrecv(x, send_to, recv_from, group)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, ctx.recv_from, ctx.send_to, ctx.group), \
            None, None, None


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to global rank ``dst`` (one hop of a chain: the next
    pipeline stage)."""
    dist.send(x.contiguous(), dst, group=group)


def recv(out: torch.Tensor, src: int, group) -> torch.Tensor:
    """``out``, filled with what global rank ``src`` sends."""
    dist.recv(out, src, group=group)
    return out
