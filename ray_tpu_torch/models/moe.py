"""Mixtral-style sparse-MoE decoder in PyTorch (single device).

Counterpart of ``ray_tpu/models/moe.py``: the Llama decoder with each
MLP replaced by ``num_experts`` SwiGLU experts under a top-k softmax
router, with the Switch load-balance auxiliary loss.  Parameters keep the
JAX pytree's layout (expert leaves ``[L, E, h, m]``, router ``[L, h, E]``)
so ``models/convert.py`` carries them one to one.

Dispatch is the reference's dense one: every expert computes every token
and the top-k combine weights select, so shapes stay static.  Gate and up
are one product each against the experts folded into ``[h, E * m]``; down
is E products.  These are plain matrix products (the JAX package leaves
them to XLA, outside any Pallas kernel), so they stay ``torch.matmul``;
attention dispatches through ``ops.attention`` as in the Llama model (K1
forward, K2/K3 backward on CUDA).

Under autograd with ``cfg.remat`` each layer runs under full
checkpointing whatever ``remat_policy`` says, as the reference calls
``jax.checkpoint`` with no policy.  Expert parallelism (the 'expert'
mesh axis and ``moe_param_specs``) comes with the parallel slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, attention_block,
                                        embed_tokens, lm_head, next_token_nll,
                                        records_grad, stacked_layers)
from ray_tpu_torch.models.training import AdamW, Trainer
from ray_tpu_torch.ops.layers import rms_norm, rope_frequencies, swiglu_op


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    router_aux_coef: float = 0.01

    @staticmethod
    def tiny_moe(**kw) -> "MoEConfig":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, mlp_dim=128, max_seq_len=128,
                    num_experts=4, experts_per_token=2)
        base.update(kw)
        return MoEConfig(**base)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, mlp_dim=14336, max_seq_len=32768,
            rope_theta=1e6, num_experts=8, experts_per_token=2)

    def num_params(self) -> int:
        hd = self.resolved_head_dim
        per_layer = (
            self.hidden_size * (self.num_heads * hd)           # wq
            + 2 * self.hidden_size * (self.num_kv_heads * hd)  # wk, wv
            + (self.num_heads * hd) * self.hidden_size         # wo
            + self.hidden_size * self.num_experts              # router
            + 3 * self.num_experts * self.hidden_size * self.mlp_dim
            + 2 * self.hidden_size)                            # norms
        head = 0 if self.tie_embeddings else \
            self.vocab_size * self.hidden_size
        return (self.vocab_size * self.hidden_size + head
                + self.num_layers * per_layer + self.hidden_size)


def moe_init(cfg: MoEConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (None = the GPU).

    Normal(0, 0.02) weights in ``cfg.param_dtype`` and unit norms, as the
    JAX ``moe_init``; the random streams differ, so parity with JAX goes
    through the converter.  Each leaf is drawn in place into its one
    allocation: at Mixtral width one expert leaf of 24 layers is 22.5 GB
    in bf16, and scaling a drawn copy would hold it twice.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.resolved_head_dim
    h, L, E, m = (cfg.hidden_size, cfg.num_layers, cfg.num_experts,
                  cfg.mlp_dim)
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.empty(shape, device=dev, dtype=cfg.param_dtype) \
            .normal_(0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    params = {
        "embed": normal(cfg.vocab_size, h),
        "layers": {
            "attn_norm": ones(L, h),
            "wq": normal(L, h, q_out),
            "wk": normal(L, h, kv_out),
            "wv": normal(L, h, kv_out),
            "wo": normal(L, q_out, h),
            "mlp_norm": ones(L, h),
            "w_router": normal(L, h, E),
            "w_gate": normal(L, E, h, m),
            "w_up": normal(L, E, h, m),
            "w_down": normal(L, E, m, h),
        },
        "final_norm": ones(h),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(h, cfg.vocab_size)
    return params


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest values along the last dim and
    their indices, equal values in index order (lower index first).
    ``torch.topk`` promises no order among equal values, so this takes the
    head of a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse-MoE FFN on ``x [b, s, h]``: ``(output [b, s, h] in
    cfg.dtype, router aux loss fp32)``.  The router runs in fp32; the
    top-k combine weights are renormalised (``+1e-9``); every expert
    computes every token and the combine is summed over experts in
    ``cfg.dtype``."""
    dt = cfg.dtype
    b, s, h = x.shape
    E, k, m = cfg.num_experts, cfg.experts_per_token, cfg.mlp_dim
    probs = torch.softmax(x.float() @ lp["w_router"].float(), dim=-1)
    topk_vals, topk_idx = top_k(probs, k)
    onehot = F.one_hot(topk_idx, E).to(probs.dtype)  # [b, s, k, E]
    combine = (onehot * topk_vals[..., None]).sum(dim=2)  # [b, s, E]
    combine = combine / (combine.sum(-1, keepdim=True) + 1e-9)

    def fold(w):  # [E, h, m] -> [h, E * m]
        return w.to(dt).transpose(0, 1).reshape(h, E * m)

    act = swiglu_op(x @ fold(lp["w_gate"]), x @ fold(lp["w_up"])) \
        .reshape(b, s, E, m)
    per_expert = torch.stack([act[:, :, e] @ lp["w_down"][e].to(dt)
                              for e in range(E)], dim=1)  # [b, E, s, h]
    out = (per_expert
           * combine.to(dt).transpose(1, 2)[..., None]).sum(dim=1)
    # Switch load-balance loss: E * sum_e f_e * P_e, f_e the share of
    # tokens whose top-1 expert is e, P_e the mean router probability
    f = F.one_hot(topk_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f * probs.mean(dim=(0, 1)))
    return out, aux


def _moe_layer(x, lp, *, cfg: MoEConfig, cos, sin):
    # no sliding window: the reference's MoE layer passes none
    x = attention_block(x, lp, cfg, cos, sin)
    moe_out, aux = moe_block(rms_norm(x, lp["mlp_norm"]), lp, cfg)
    return x + moe_out, aux


def moe_apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
              *, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: tokens [b, s] -> (logits [b, s, V] fp32, the router aux
    summed over layers), on the device the params and tokens live on."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded moe_apply (expert parallelism) comes with the "
            "parallel slice of the port (ROADMAP Queue 1, item 7)")
    s = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    layer = functools.partial(_moe_layer, cfg=cfg, cos=cos, sin=sin)
    if cfg.remat and records_grad(params):
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, lp in stacked_layers(params):
        x, aux = layer(x, lp)
        total_aux = total_aux + aux
    return lm_head(params, cfg, x), total_aux


def moe_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: MoEConfig, *, mesh=None) -> torch.Tensor:
    """Next-token cross entropy in fp32 plus ``router_aux_coef`` times the
    router load-balance aux; batch has 'tokens' [b, s]."""
    tokens = batch["tokens"]
    logits, aux = moe_apply(params, tokens[:, :-1], cfg, mesh=mesh)
    return next_token_nll(logits, tokens).mean() + cfg.router_aux_coef * aux


def make_moe_trainer(cfg: MoEConfig, mesh=None, *,
                     optimizer: Optional[AdamW] = None, accum_steps: int = 1,
                     device=None) -> Trainer:
    """A ``Trainer`` (``models/training.py``) for the MoE family."""
    return Trainer(lambda seed, dev: moe_init(cfg, seed, device=dev),
                   functools.partial(moe_loss, cfg=cfg),
                   optimizer=optimizer, accum_steps=accum_steps,
                   device=device, mesh=mesh)
