"""Vision Transformer classifier in PyTorch.

Counterpart of ``ray_tpu/models/vit.py``: the patch embedding as one
reshaped product (no convolution), a class token and learned positions,
pre-norm encoder blocks (RMSNorm, non-causal attention, a tanh-GELU MLP)
and a linear head on the class token.  Parameters keep the JAX pytree's
layout (``x @ W`` weights, layers stacked ``[L, ...]``), so
``models/convert.py`` carries them one to one.

Attention is pinned to the plain reference (``impl="ref"``), as the
reference pins it: no flash kernel runs here.  GELU is the tanh
approximation in fp32, ``jax.nn.gelu``'s default (torch's default is the
erf form).  Under autograd with ``cfg.remat`` each layer is replayed
whole in the backward, as ``jax.checkpoint`` without a policy.

Under a mesh the params are DTensors placed by ``vit_param_specs``; the
activations keep the batch over the data axes and the sequence whole,
each weight is gathered over the data axes for its product and the
attention runs per local shard (``ops.attention``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import _constrain, _weight, stacked_layers
from ray_tpu_torch.models.training import AdamW, Trainer, tree_leaves
from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.layers import rms_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # the JAX pytree is stacked either way: nothing here reads it
    scan_layers: bool = True
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.num_channels

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(image_size=32, patch_size=8, hidden_size=64,
                    num_layers=2, num_heads=4, mlp_dim=128, num_classes=10)
        base.update(kw)
        return ViTConfig(**base)

    @staticmethod
    def vit_b16() -> "ViTConfig":
        return ViTConfig()

    def num_params(self) -> int:
        h, m = self.hidden_size, self.mlp_dim
        per_layer = 4 * h * h + 2 * h * m + 2 * h  # qkv+o, mlp, norms
        return (self.patch_dim * h + h              # patch embed + bias
                + (self.num_patches + 1) * h        # pos embed (incl cls)
                + h                                  # cls token
                + self.num_layers * per_layer
                + h                                  # final norm
                + h * self.num_classes + self.num_classes)


def vit_init(cfg: ViTConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (None = the GPU),
    drawn from one ``torch.Generator``: Normal(0, 0.02) weights in
    ``cfg.param_dtype``, unit norms and zero biases, as the JAX
    ``vit_init``; the random streams differ, so parity with JAX goes
    through the converter."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, L, m = cfg.hidden_size, cfg.num_layers, cfg.mlp_dim

    def normal(*shape):
        return torch.empty(shape, device=dev, dtype=cfg.param_dtype) \
            .normal_(0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=cfg.param_dtype)

    return {
        "patch_embed": normal(cfg.patch_dim, h),
        "patch_bias": zeros(h),
        "pos_embed": normal(cfg.num_patches + 1, h),
        "cls_token": normal(h),
        "layers": {
            "attn_norm": ones(L, h),
            "wq": normal(L, h, h),
            "wk": normal(L, h, h),
            "wv": normal(L, h, h),
            "wo": normal(L, h, h),
            "mlp_norm": ones(L, h),
            "w_up": normal(L, h, m),
            "w_down": normal(L, m, h),
        },
        "final_norm": ones(h),
        "head_w": normal(h, cfg.num_classes),
        "head_b": zeros(cfg.num_classes),
    }


def vit_param_specs(cfg: ViTConfig) -> Dict[str, Any]:
    """Logical-axis spec tree matching ``vit_init``'s structure."""
    layer = {
        "attn_norm": ("norm",),
        "wq": ("embed", "heads"),
        "wk": ("embed", "heads"),
        "wv": ("embed", "heads"),
        "wo": ("heads", "embed"),
        "mlp_norm": ("norm",),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    return {
        "patch_embed": (None, "embed"),
        "patch_bias": ("norm",),
        "pos_embed": (None, "embed"),
        "cls_token": ("norm",),
        "layers": {k: ("layers",) + v for k, v in layer.items()},
        "final_norm": ("norm",),
        "head_w": ("embed", "vocab"),
        "head_b": ("norm",),
    }


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] -> [b, num_patches, patch_dim] (pure reshape and
    transpose)."""
    b, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(b, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (H // p) * (W // p), p * p * C)


def _tokens(x, mesh, rules):
    """An activation ``[b, s, h]``: under a mesh with its rows over the
    data axes and the sequence and width whole."""
    return _constrain(x, mesh, "batch", None, None, rules=rules)


def _encoder_layer(x, lp, *, cfg: ViTConfig, mesh=None, rules=None):
    b, s, h = x.shape
    dt = cfg.dtype
    hd = h // cfg.num_heads
    y = _tokens(rms_norm(x, lp["attn_norm"]), mesh, rules)
    q = (y @ _weight(lp["wq"], dt, mesh)).reshape(b, s, cfg.num_heads, hd)
    k = (y @ _weight(lp["wk"], dt, mesh)).reshape(b, s, cfg.num_heads, hd)
    v = (y @ _weight(lp["wv"], dt, mesh)).reshape(b, s, cfg.num_heads, hd)
    attn = dot_product_attention(q, k, v, causal=False, impl="ref",
                                 mesh=mesh)
    attn = _constrain(attn.reshape(b, s, h), mesh, "batch", None, "heads",
                      rules=rules)
    x = x + _tokens(attn @ _weight(lp["wo"], dt, mesh), mesh, rules)
    y = _tokens(rms_norm(x, lp["mlp_norm"]), mesh, rules)
    up = (y @ _weight(lp["w_up"], dt, mesh)).float()
    act = F.gelu(up, approximate="tanh")
    x = x + _tokens(act.to(dt) @ _weight(lp["w_down"], dt, mesh), mesh,
                    rules)
    return _tokens(x, mesh, rules)


def _records_grad(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def vit_apply(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
              *, mesh=None, rules=None) -> torch.Tensor:
    """images [b, H, W, C] float -> logits [b, num_classes] (fp32), on the
    device the params and images live on; under a mesh both are DTensors
    (global view) or the images the global batch every rank holds."""
    from ray_tpu_torch.parallel.mesh import compute_mesh

    mesh = compute_mesh(mesh)
    dt = cfg.dtype
    images = _constrain(images, mesh, "batch", None, None, None,
                        rules=rules)
    x = _patchify(images.to(dt), cfg)
    x = x @ _weight(params["patch_embed"], dt, mesh) \
        + _weight(params["patch_bias"], dt, mesh)
    cls = _weight(params["cls_token"], dt, mesh).expand(x.shape[0], 1,
                                                        cfg.hidden_size)
    x = torch.cat([_tokens(cls, mesh, rules), _tokens(x, mesh, rules)],
                  dim=1)
    x = _tokens(x + _weight(params["pos_embed"], dt, mesh)[None], mesh,
                rules)
    layer = functools.partial(_encoder_layer, cfg=cfg, mesh=mesh,
                              rules=rules)
    if cfg.remat and _records_grad(params):
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    for _, lp in stacked_layers(params):
        x = layer(x, lp)
    x = rms_norm(x, params["final_norm"])
    cls_out = x[:, 0]
    logits = (cls_out @ _weight(params["head_w"], dt, mesh)
              + _weight(params["head_b"], dt, mesh)).float()
    return _constrain(logits, mesh, "batch", None, rules=rules)


def vit_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: ViTConfig, *, mesh=None, rules=None) -> torch.Tensor:
    """Mean cross entropy in fp32 of the logits of ``batch["images"]``
    against ``batch["labels"]`` [b]; under a mesh a replicated scalar
    DTensor."""
    logits = vit_apply(params, batch["images"], cfg, mesh=mesh, rules=rules)
    labels = _constrain(batch["labels"], mesh, "batch", rules=rules)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None]).mean()
    return _constrain(loss, mesh, rules=rules)


def make_vit_trainer(cfg: ViTConfig, mesh=None, *,
                     optimizer: Optional[AdamW] = None, rules=None,
                     accum_steps: int = 1, device=None) -> Trainer:
    """A ``Trainer`` (``models/training.py``) for the ViT family, on
    ``mesh`` when given.  The family has no pipeline path: ``reject_pp``
    raises for pp > 1 and, with no rule table given, replicates the
    stacked layers over pp."""
    from ray_tpu_torch.parallel.pipeline import reject_pp

    rules = reject_pp(mesh, "ViT", rules)
    return Trainer(lambda seed, dev: vit_init(cfg, seed, device=dev),
                   functools.partial(vit_loss, cfg=cfg, mesh=mesh,
                                     rules=rules),
                   optimizer=optimizer, accum_steps=accum_steps,
                   device=device, mesh=mesh,
                   param_specs=vit_param_specs(cfg), rules=rules)
