"""Mixtral-style sparse-MoE decoder in PyTorch.

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
``jax.checkpoint`` with no policy.

Under a mesh the params are DTensors placed by ``moe_param_specs``; the
rule table's "expert" axis (tp by default) is expert parallelism: each
rank runs the experts it holds on its tokens under ``local_map`` and the
combine is summed over the expert shards, as XLA psums the reference's
combine einsum.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, _constrain, _weight,
                                        attention_block, embed_tokens,
                                        lm_head, next_token_nll, records_grad,
                                        rope_tables, stacked_layers)
from ray_tpu_torch.models.training import AdamW, Trainer
from ray_tpu_torch.ops.layers import rms_norm, swiglu_op


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


def moe_param_specs(cfg: MoEConfig) -> Dict[str, Any]:
    """Logical-axis spec tree matching ``moe_init``'s structure."""
    layer = {
        "attn_norm": ("norm",),
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
        "mlp_norm": ("norm",),
        "w_router": ("embed", "norm"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }
    specs = {
        "embed": ("vocab", "embed"),
        "layers": {k: ("layers",) + v for k, v in layer.items()},
        "final_norm": ("norm",),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


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
    out, top1, psum = _experts_local(
        x, lp["w_router"], *(lp[k].to(dt) for k in ("w_gate", "w_up",
                                                     "w_down")),
        cfg=cfg, first=0, emit_router=True)
    return out, _router_aux(top1, psum, x.shape[0] * x.shape[1], cfg)


def _router_aux(top1, psum, n_tokens: int, cfg: MoEConfig):
    """The Switch load-balance loss ``E * sum_e f_e * P_e`` from the
    router's sums over ``n_tokens`` tokens: ``f_e`` the share of tokens
    whose top-1 expert is e, ``P_e`` the mean router probability."""
    return cfg.num_experts * torch.sum((top1 / n_tokens)
                                       * (psum / n_tokens))


def _experts_local(x, w_router, w_gate, w_up, w_down, *, cfg: MoEConfig,
                   first: int, emit_router: bool):
    """The experts ``first`` to ``first + n`` (the ``n`` that the weights,
    already in ``cfg.dtype``, hold) on the tokens ``x [b, s, h]``: their
    part of the combine (the whole when they are all E experts, a
    partial sum over the expert shards under a mesh), and the router's
    sums over the tokens, the top-1 counts and the probabilities ``[E]``
    (zeros unless ``emit_router``, so that their sum over the expert
    shards counts the router once)."""
    dt = cfg.dtype
    b, s, h = x.shape
    E, k, m = cfg.num_experts, cfg.experts_per_token, cfg.mlp_dim
    n = w_gate.shape[0]
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    topk_vals, topk_idx = top_k(probs, k)
    onehot = F.one_hot(topk_idx, E).to(probs.dtype)  # [b, s, k, E]
    combine = (onehot * topk_vals[..., None]).sum(dim=2)  # [b, s, E]
    combine = combine / (combine.sum(-1, keepdim=True) + 1e-9)
    combine = combine[..., first:first + n]

    def fold(w):  # [n, h, m] -> [h, n * m]
        return w.transpose(0, 1).reshape(h, n * m)

    act = swiglu_op(x @ fold(w_gate), x @ fold(w_up)).reshape(b, s, n, m)
    per_expert = torch.stack([act[:, :, e] @ w_down[e] for e in range(n)],
                             dim=1)  # [b, n, s, h]
    out = (per_expert
           * combine.to(dt).transpose(1, 2)[..., None]).sum(dim=1)
    top1 = F.one_hot(topk_idx[..., 0], E).float().sum(dim=(0, 1))
    psum = probs.sum(dim=(0, 1))
    if not emit_router:
        top1, psum = 0 * top1, 0 * psum
    return out, top1, psum


def _moe_block_mesh(x, lp, cfg: MoEConfig, mesh):
    """``moe_block`` under a mesh: experts over the mesh axes that shard
    their leading dim (the rule table's "expert" axis), tokens as ``x``
    lies; each rank runs ``_experts_local`` on its blocks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dt = cfg.dtype
    E = cfg.num_experts
    experts = [_weight(lp[k], dt, mesh) for k in ("w_gate", "w_up",
                                                  "w_down")]
    # the router runs in fp32 from the param's own dtype, as moe_block's
    router = lp["w_router"].redistribute(mesh, [Replicate()] * mesh.ndim)
    ep = [i for i, p in enumerate(experts[0].placements)
          if isinstance(p, Shard) and p.dim == 0]
    if E % math.prod(mesh.shape[i] for i in ep):
        raise ValueError(f"{E} experts do not split evenly over the mesh "
                         f"axes {[mesh.mesh_dim_names[i] for i in ep]}")
    x_layout = [Replicate() if i in ep else p
                for i, p in enumerate(x.placements)]
    if x_layout != list(x.placements):
        x = x.redistribute(mesh, x_layout)
    data = [i for i, p in enumerate(x_layout) if isinstance(p, Shard)]
    n_shards = E // experts[0].to_local().shape[0]
    shard = 0
    for i in ep:
        shard = shard * mesh.shape[i] + mesh.get_local_rank(i)

    def part(layout, dims):
        return [Partial() if i in dims else p for i, p in enumerate(layout)]

    sums = part([Replicate()] * mesh.ndim, data + ep)
    local = functools.partial(_experts_local, cfg=cfg,
                              first=shard * (E // n_shards),
                              emit_router=shard == 0)
    out, top1, psum = local_map(
        local, out_placements=(part(x_layout, ep), sums, sums),
        in_placements=(x_layout, router.placements,
                       *(w.placements for w in experts)),
        in_grad_placements=(part(x_layout, ep), sums,
                            *(part(w.placements, data) for w in experts)),
        device_mesh=mesh)(x, router, *experts)
    replicated = [Replicate()] * mesh.ndim
    return out, _router_aux(top1.redistribute(mesh, replicated),
                            psum.redistribute(mesh, replicated),
                            x.shape[0] * x.shape[1], cfg)


def _moe_layer(x, lp, *, cfg: MoEConfig, cos, sin, mesh=None, rules=None):
    # no sliding window: the reference's MoE layer passes none
    x = attention_block(x, lp, cfg, cos, sin, mesh=mesh, rules=rules)
    y = rms_norm(x, lp["mlp_norm"])
    moe_out, aux = (moe_block(y, lp, cfg) if mesh is None
                    else _moe_block_mesh(y, lp, cfg, mesh))
    return _constrain(x + moe_out, mesh, "batch", "seq", None,
                      rules=rules), aux


def moe_apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
              *, mesh=None, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: tokens [b, s] -> (logits [b, s, V] fp32, the router aux
    summed over layers), on the device the params and tokens live on;
    under a mesh both are DTensors (global view)."""
    from ray_tpu_torch.parallel.mesh import compute_mesh

    mesh = compute_mesh(mesh)
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, mesh=mesh, rules=rules)
    cos, sin = rope_tables(cfg, s, x.device, mesh)
    layer = functools.partial(_moe_layer, cfg=cfg, cos=cos, sin=sin,
                              mesh=mesh, rules=rules)
    if cfg.remat and records_grad(params):
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    total_aux = _constrain(torch.zeros((), dtype=torch.float32,
                                       device=x.device), mesh)
    for _, lp in stacked_layers(params):
        x, aux = layer(x, lp)
        total_aux = total_aux + aux
    return lm_head(params, cfg, x, mesh=mesh, rules=rules), total_aux


def moe_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: MoEConfig, *, mesh=None, rules=None) -> torch.Tensor:
    """Next-token cross entropy in fp32 plus ``router_aux_coef`` times the
    router load-balance aux; batch has 'tokens' [b, s]."""
    tokens = _constrain(batch["tokens"], mesh, "batch", rules=rules)
    logits, aux = moe_apply(params, tokens[:, :-1], cfg, mesh=mesh,
                            rules=rules)
    loss = next_token_nll(logits, tokens).mean() + cfg.router_aux_coef * aux
    return _constrain(loss, mesh, rules=rules)


def make_moe_trainer(cfg: MoEConfig, mesh=None, *,
                     optimizer: Optional[AdamW] = None, rules=None,
                     accum_steps: int = 1, device=None) -> Trainer:
    """A ``Trainer`` (``models/training.py``) for the MoE family, on
    ``mesh`` when given (expert parallelism by the 'expert' rule).  The
    family has no pipeline path: ``reject_pp`` raises for pp > 1 and,
    with no rule table given, replicates the stacked layers over pp."""
    from ray_tpu_torch.parallel.pipeline import reject_pp

    rules = reject_pp(mesh, "MoE", rules)
    return Trainer(lambda seed, dev: moe_init(cfg, seed, device=dev),
                   functools.partial(moe_loss, cfg=cfg, mesh=mesh,
                                     rules=rules),
                   optimizer=optimizer, accum_steps=accum_steps,
                   device=device, mesh=mesh,
                   param_specs=moe_param_specs(cfg), rules=rules)
