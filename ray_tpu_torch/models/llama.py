"""Llama-family decoder-only transformer in PyTorch (single device).

Counterpart of ``ray_tpu/models/llama.py``.  Parameters are a plain dict
in the JAX pytree's layout (``x @ W`` weights, layers stacked ``[L, ...]``)
so weights convert one to one (``models/convert.py``) and the tests
compare like with like.  Each weight is cast to ``cfg.dtype`` per matmul;
logits are fp32.  Attention dispatches through ``ops.attention``: the
hand-written CUDA flash kernels (K1 forward, K2/K3 backward) for CUDA
inputs with ``seq >= 256``.

``llama_apply`` is differentiable, as the JAX function is.  When autograd
records (grad mode on and params that require grad) each decoder layer
runs under the config's remat policy; serving, with frozen params or
under ``torch.no_grad()``, builds no graph.  ``llama_loss`` is the
training loss.
The mesh and pipeline paths come with the parallel slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import dot_product_attention
# registers the op ray_tpu_torch::flash_attention that save_attn keeps
from ray_tpu_torch.ops.cuda import flash_attention as _flash  # noqa: F401
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu_op)


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
    # under autograd: False (autograd keeps every activation), or a policy.
    # "full": each layer keeps only its input and is replayed in the
    # backward; "save_attn": also keeps the flash op's outputs (out, lse),
    # so the backward replays the layer without K1; "save_attn_mlp": also
    # keeps the swiglu output; "save_dots": keeps the outputs of the
    # products without batch dims (x @ W) and replays the rest, K1 too.
    remat: bool = True
    remat_policy: str = "save_attn"
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
    """Iterate stacked layer params ``[L, ...]`` as per-layer views.  One
    ``unbind`` per leaf: under autograd its backward is one ``stack``,
    where L ``select``s would each write a full ``[L, ...]`` grad."""
    views = {k: v.unbind(0) for k, v in params["layers"].items()}
    L = len(next(iter(views.values())))
    for i in range(L):
        yield i, {k: v[i] for k, v in views.items()}


def embed_tokens(params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Embedding gather in ``cfg.dtype``.  JAX's ``embed[tokens]`` wraps
    negative ids (``ids + V``) and clamps what is still out of range,
    where torch raises (CPU) or asserts on the device (CUDA), so both
    steps are explicit here: -1 reads row V-1, and ids below -V or at V
    and above read the first or last row."""
    vocab = params["embed"].shape[0]
    ids = torch.where(tokens < 0, tokens + vocab, tokens).clamp(0, vocab - 1)
    return params["embed"][ids].to(cfg.dtype)


def lm_head(params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection, logits in fp32 (both
    operands upcast: exact for bf16 products, fp32 accumulation)."""
    x = rms_norm(x, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x.float() @ head.float()


def attention_block(x, lp, cfg: LlamaConfig, cos, sin, window=None):
    """The attention half of a decoder layer: ``x`` plus causal attention
    of ``rms_norm(x)`` (keys in ``window``, None = all) through ``wo``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    y = rms_norm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, cfg.num_heads, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = dot_product_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl, window=window)
    return x + attn.reshape(b, s, cfg.num_heads * hd) @ lp["wo"].to(dt)


def _decoder_layer(x, lp, *, cfg: LlamaConfig, cos, sin):
    x = attention_block(x, lp, cfg, cos, sin, cfg.sliding_window)
    dt = cfg.dtype
    y = rms_norm(x, lp["mlp_norm"])
    act = swiglu_op(y @ lp["w_gate"].to(dt), y @ lp["w_up"].to(dt))
    return x + act @ lp["w_down"].to(dt)


# The ops whose outputs each selective policy keeps; autograd replays the
# rest of the layer.  JAX names them: "save_attn" keeps the flash op's
# (out, lse) (``attn_out``/``flash_out``/``flash_lse``), "save_attn_mlp"
# also the swiglu output (``mlp_act``), and "save_dots" is
# ``dots_with_no_batch_dims_saveable``: the ``x @ W`` products, which
# dispatch as ``aten.mm``, and not the batched ``aten.bmm`` of the
# reference attention nor the flash op.
_SAVED_OPS = {
    "save_attn": [torch.ops.ray_tpu_torch.flash_attention.default],
    "save_attn_mlp": [torch.ops.ray_tpu_torch.flash_attention.default,
                      torch.ops.ray_tpu_torch.swiglu.default],
    "save_dots": [torch.ops.aten.mm.default],
}


def layer_remat(cfg: LlamaConfig) -> Optional[Callable]:
    """How a decoder layer runs under autograd: ``None`` when remat is off,
    else ``remat(layer_fn, x, lp)`` under the config's policy (JAX's
    ``jax.checkpoint`` policies in ``llama_apply``)."""
    if not cfg.remat:
        return None
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, use_reentrant=False)
    if cfg.remat_policy in _SAVED_OPS:
        return functools.partial(
            checkpoint, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _SAVED_OPS[cfg.remat_policy]))
    raise ValueError(
        f"remat_policy must be 'full', 'save_attn', 'save_attn_mlp' or "
        f"'save_dots', got {cfg.remat_policy!r}")


def records_grad(params) -> bool:
    """Whether autograd records a forward of ``params``: grad mode on and
    params that require grad (a train step, not serving)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in [params["embed"],
                                  *params["layers"].values()])


def llama_apply(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: LlamaConfig, *, mesh=None) -> torch.Tensor:
    """Forward pass: tokens [b, s] int → logits [b, s, vocab] (fp32), on
    the device the params and tokens live on.  When autograd is on and the
    params require grad, each decoder layer runs under ``layer_remat``."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded llama_apply comes with the parallel slice of the "
            "port (ROADMAP Queue 1, item 7)")
    s = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    layer = functools.partial(_decoder_layer, cfg=cfg, cos=cos, sin=sin)
    remat = layer_remat(cfg) if records_grad(params) else None
    for _, lp in stacked_layers(params):
        x = layer(x, lp) if remat is None else remat(layer, x, lp)
    return lm_head(params, cfg, x)


def next_token_nll(logits: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy [b, s - 1] in fp32 of ``logits`` (of
    ``tokens[:, :-1]``) against the next tokens ``tokens[:, 1:]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]


def llama_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig, *, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy in fp32; batch has 'tokens' [b, s] and an
    optional 'mask' [b, s] (1 = contribute to the loss)."""
    tokens = batch["tokens"]
    logits = llama_apply(params, tokens[:, :-1], cfg, mesh=mesh)
    nll = next_token_nll(logits, tokens)
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
