"""Generation pieces the paged serving engine needs.

Counterpart of ``ray_tpu/models/generation.py``, ported only as far as
serving uses it: ``SamplingParams``, the GQA attend over a merged KV
cache, the cache-enabled decoder layer (dense 2-tuple merge) and the
stacked-layer iterator.  The dense-cache ``generate``, ``verify_step``
and n-gram speculation come with the speculative-decoding slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ray_tpu_torch.models.llama import (  # noqa: F401
    stacked_layers as _stacked_layers)
from ray_tpu_torch.ops.attention import sliding_window_mask  # noqa: F401
from ray_tpu_torch.ops.layers import apply_rope, rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    max_tokens: int = 64
    stop_token_id: Optional[int] = None


def _gqa_attend(q, k, v, mask):
    """q [b,sq,H,hd], k/v [b,sk,KVH,hd], mask [b,sq,sk] -> [b,sq,H,hd].

    fp32 logits divided by sqrt(hd) AFTER the product (unlike
    ``reference_attention``, which multiplies by ``d**-0.5``; each keeps
    its reference's arithmetic), -1e30 mask, softmax cast to ``v.dtype``
    before the PV product with fp32 accumulation."""
    b, sq, H, hd = q.shape
    kvh = k.shape[2]
    group = H // kvh
    qg = q.reshape(b, sq, kvh, group, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.reshape(b, sq, H, hd).to(q.dtype)


def _layer_with_cache(x, lp, layer_kv, *, cfg, cos, sin, mask,
                      positions=None):
    """One decoder layer reading/returning its kv (cache-enabled twin of
    ``llama._decoder_layer``; same weights, ragged-mask attention).

    ``layer_kv(k, v)`` merges with the cache and returns ``(k_all, v_all)``
    (the dense merge; the int8 4-tuple comes with the int8 KV slice)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    y = rms_norm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, cfg.num_heads, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    k_all, v_all = layer_kv(k, v)  # merge with cache; full keys/vals
    attn = _gqa_attend(q, k_all, v_all, mask)
    x = x + (attn.reshape(b, s, -1) @ lp["wo"].to(dt))
    y = rms_norm(x, lp["mlp_norm"])
    act = swiglu(y @ lp["w_gate"].to(dt), y @ lp["w_up"].to(dt))
    return x + act @ lp["w_down"].to(dt), (k, v)
