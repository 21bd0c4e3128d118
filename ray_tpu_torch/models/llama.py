"""Llama-family decoder-only transformer in PyTorch (single device).

Counterpart of ``ray_tpu/models/llama.py``.  Parameters are a plain dict
in the JAX pytree's layout (``x @ W`` weights, layers stacked ``[L, ...]``)
so weights convert one to one (``models/convert.py``) and the tests
compare like with like.  Each weight is cast to ``cfg.dtype`` per matmul;
logits are fp32.  Attention dispatches through ``ops.attention``: the
hand-written CUDA flash kernel (K1) for CUDA inputs with ``seq >= 256``.

Forward only: the backward, remat policies and the trainer come with the
training slice; the mesh and pipeline paths with the parallel slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    mlp_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # the JAX pytree's layer layout: stacked [L, ...] (True) or a list of
    # per-layer dicts (False).  Only the converter reads it: the port
    # always holds stacked layers.
    scan_layers: bool = True
    attention_impl: str = "auto"
    # sliding-window causal attention: query p attends keys in
    # (p - sliding_window, p].  None = full causal.
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # --- presets -----------------------------------------------------------
    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120, num_layers=40, num_heads=40, num_kv_heads=40,
            mlp_dim=13824,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, mlp_dim=14336, max_seq_len=8192,
            rope_theta=500000.0,
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale model."""
        defaults = dict(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, mlp_dim=128, max_seq_len=128,
            dtype=torch.float32, param_dtype=torch.float32,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def num_params(self) -> int:
        hd = self.resolved_head_dim
        per_layer = (
            self.hidden_size * (self.num_heads * hd)          # wq
            + 2 * self.hidden_size * (self.num_kv_heads * hd)  # wk, wv
            + (self.num_heads * hd) * self.hidden_size         # wo
            + 3 * self.hidden_size * self.mlp_dim              # gate/up/down
            + 2 * self.hidden_size                             # norms
        )
        embed = self.vocab_size * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * per_layer + self.hidden_size


def llama_init(cfg: LlamaConfig, seed: int = 0,
               device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (None = the GPU).

    Normal(0, 0.02) weights in ``cfg.param_dtype`` and unit norms, as the
    JAX ``llama_init``; the random streams differ, so parity with JAX is
    by shape and scale only.  Layers are stacked ``[L, ...]``.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.resolved_head_dim
    h, L = cfg.hidden_size, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=cfg.param_dtype) * 0.02

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
            "w_gate": normal(L, h, cfg.mlp_dim),
            "w_up": normal(L, h, cfg.mlp_dim),
            "w_down": normal(L, cfg.mlp_dim, h),
        },
        "final_norm": ones(h),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(h, cfg.vocab_size)
    return params


def stacked_layers(params) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Iterate stacked layer params ``[L, ...]`` as per-layer views."""
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    for i in range(L):
        yield i, {k: v[i] for k, v in layers.items()}


def embed_tokens(params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Embedding gather in ``cfg.dtype``.  JAX clamps out-of-range gather
    indices where torch raises (CPU) or asserts on the device (CUDA), so
    ids are clamped into the table explicitly, as the JAX engine relies
    on."""
    ids = tokens.clamp(0, params["embed"].shape[0] - 1)
    return params["embed"][ids].to(cfg.dtype)


def lm_head(params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection, logits in fp32 (both
    operands upcast: exact for bf16 products, fp32 accumulation)."""
    x = rms_norm(x, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x.float() @ head.float()


def _decoder_layer(x, lp, *, cfg: LlamaConfig, cos, sin):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    # Attention block.
    y = rms_norm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, cfg.num_heads, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = dot_product_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl,
                                 window=cfg.sliding_window)
    x = x + attn.reshape(b, s, cfg.num_heads * hd) @ lp["wo"].to(dt)
    # MLP block.
    y = rms_norm(x, lp["mlp_norm"])
    act = swiglu(y @ lp["w_gate"].to(dt), y @ lp["w_up"].to(dt))
    return x + act @ lp["w_down"].to(dt)


@torch.no_grad()
def llama_apply(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: LlamaConfig, *, mesh=None) -> torch.Tensor:
    """Forward pass: tokens [b, s] int → logits [b, s, vocab] (fp32), on
    the device the params and tokens live on."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded llama_apply comes with the parallel slice of the "
            "port (ROADMAP Queue 1, item 7)")
    s = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    for _, lp in stacked_layers(params):
        x = _decoder_layer(x, lp, cfg=cfg, cos=cos, sin=sin)
    return lm_head(params, cfg, x)
