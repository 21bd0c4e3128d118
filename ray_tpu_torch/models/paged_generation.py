"""Paged KV cache ops: block-table attention for the LLM engine.

Counterpart of ``ray_tpu/models/paged_generation.py`` (dense pools only;
the int8 pool and ``paged_verify_step`` come with later slices).

* The KV cache is a global block pool ``[L, num_blocks, block_size, KVH,
  hd]``; a sequence's cache is a block table of int32 pool indices.
* Decode gathers each sequence's blocks (``[b, MB*bs]`` keys) and masks by
  ``cur_len``; block 0 is the reserved scratch block that table padding
  and masked scatter lanes land on.
* Prefix-cached prefill runs per request (b=1): the cached prefix KV is
  gathered from the pool, only the suffix runs through the layers.

The JAX programs donate the pool buffer to XLA; here the pool is updated
in place (``index_put_``), which is what the donation buys there: no
second copy of the pool per call.  Functions still return the pool so the
call sites read as in the reference.

JAX clamps out-of-range gather indices and torch does not (it raises on
the CPU and trips a device-side assert on CUDA), so the indices JAX lets
clamp are clamped explicitly; each place says so.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.generation import (_layer_with_cache,
                                             _stacked_layers,
                                             sliding_window_mask)
from ray_tpu_torch.models.llama import LlamaConfig, embed_tokens
from ray_tpu_torch.models.llama import lm_head as _lm_head
from ray_tpu_torch.ops.layers import rope_frequencies

Pool = Dict[str, torch.Tensor]


def init_kv_pool(cfg: LlamaConfig, num_blocks: int, block_size: int,
                 kv_dtype=None, device=None) -> Pool:
    """Block pool; block 0 is the reserved scratch block.

    Zero-filled on purpose: the scratch block and table-padding slots are
    gathered and then masked with -1e30, and a NaN or inf left there by an
    uninitialised allocation would turn ``0 * garbage`` into a NaN.
    """
    if kv_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV pool comes with a later slice of the port "
            "(ROADMAP Queue 1, item 9)")
    if kv_dtype not in (None, "auto"):
        raise ValueError(f"kv_dtype must be None/'auto'/'int8', got "
                         f"{kv_dtype!r}")
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _store_kv(pool: Pool, i: int, blk, off, k, v) -> Pool:
    """Scatter one layer's new KV at (blk, off), in place.
    k/v: [n, KVH, hd] (n = batch or suffix length)."""
    pool["k"][i].index_put_((blk, off), k)
    pool["v"][i].index_put_((blk, off), v)
    return pool


def _gather_kv(pool: Pool, i: int, block_tables):
    """One layer's ``(k, v)`` for ``[b, MB]`` block tables:
    ``[b, MB, bs, KVH, hd]`` each, in the pool's dtype."""
    return pool["k"][i][block_tables], pool["v"][i][block_tables]


@torch.no_grad()
def paged_decode_step(params, token, cur_len, block_tables, pool: Pool,
                      cfg: LlamaConfig):
    """One token for every slot against block-table caches.

    token ``[b]``; cur_len ``[b]`` write positions; block_tables ``[b, MB]``
    int32 pool indices (pad with 0 = scratch).  Returns ``(logits [b,
    vocab], pool)`` with each sequence's new KV written at
    ``block_tables[i, cur_len // bs][cur_len % bs]``.
    """
    b = token.shape[0]
    MB = block_tables.shape[1]
    bs = pool["k"].shape[2]
    dev = token.device
    cos, sin = rope_frequencies(cfg.resolved_head_dim, MB * bs,
                                cfg.rope_theta, device=dev)
    positions = cur_len[:, None]
    x = embed_tokens(params, token[:, None], cfg)
    # logical position j visible iff j <= cur_len (own slot included)
    idx = torch.arange(MB * bs, device=dev)
    mask = idx[None, None, :] <= cur_len[:, None, None]
    if cfg.sliding_window is not None:
        mask &= sliding_window_mask(cur_len[:, None, None],
                                    idx[None, None, :], cfg.sliding_window)
    rows = torch.arange(b, device=dev)
    # JAX clamps this gather's block index; clamp it here too
    blk = block_tables[rows, torch.clamp(cur_len // bs, max=MB - 1)]
    off = cur_len % bs

    for i, lp in _stacked_layers(params):
        def merge(k, v, i=i):
            # write new kv first so the token attends to itself
            _store_kv(pool, i, blk, off, k[:, 0], v[:, 0])
            g = _gather_kv(pool, i, block_tables)
            return tuple(a.reshape(b, MB * bs, *a.shape[3:]) for a in g)

        x, _ = _layer_with_cache(x, lp, merge, cfg=cfg, cos=cos, sin=sin,
                                 mask=mask, positions=positions)
    return _lm_head(params, cfg, x)[:, 0], pool


@torch.no_grad()
def prefill_suffix(params, tokens, length, start_pos, prefix_k, prefix_v,
                   prefix_len, dst_blocks, dst_offsets, pool: Pool,
                   cfg: LlamaConfig):
    """b=1 prefill of a prompt *suffix* against a cached prefix.

    tokens ``[1, S]`` right-padded suffix; length: true suffix length;
    start_pos: absolute position of tokens[0] (== true prefix length);
    prefix_k/v ``[L, P, KVH, hd]`` gathered prefix (P a bucket,
    ``prefix_len`` true length, 0 for no prefix); dst_blocks/dst_offsets
    ``[S]`` pool coordinates for each suffix position (pad lanes -> the
    scratch block).  The scalars are Python ints.  Returns
    ``(logits_at_last [1, vocab], pool)``.
    """
    _, S = tokens.shape
    P = prefix_k.shape[1]
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.resolved_head_dim, P + S, cfg.rope_theta,
                                device=dev)
    positions = start_pos + torch.arange(S, device=dev)[None, :]
    x = embed_tokens(params, tokens, cfg)
    sfx = torch.arange(S, device=dev)
    # keys = [prefix (P) | suffix (S)]; query i sees prefix j < prefix_len
    # and suffix j' <= i (within true suffix length)
    pmask = torch.arange(P, device=dev)[None, None, :] < prefix_len
    smask = (sfx[None, None, :] <= sfx[None, :, None]) & (
        sfx[None, None, :] < length)
    if cfg.sliding_window is not None:
        W = cfg.sliding_window
        pmask = pmask & sliding_window_mask(
            positions[:, :, None], torch.arange(P, device=dev)[None, None, :],
            W)
        smask = smask & sliding_window_mask(
            sfx[None, :, None], sfx[None, None, :], W)
    mask = torch.cat([pmask.expand(1, S, P), smask], dim=-1)

    for i, lp in _stacked_layers(params):
        def merge(k, v, i=i):
            # scatter suffix kv into its blocks (pad lanes hit scratch)
            _store_kv(pool, i, dst_blocks, dst_offsets, k[0], v[0])
            k_all = torch.cat([prefix_k[i][None].to(k.dtype), k], dim=1)
            v_all = torch.cat([prefix_v[i][None].to(v.dtype), v], dim=1)
            return k_all, v_all

        x, _ = _layer_with_cache(x, lp, merge, cfg=cfg, cos=cos, sin=sin,
                                 mask=mask, positions=positions)
    logits = _lm_head(params, cfg, x)
    return logits[:, length - 1], pool


@torch.no_grad()
def paged_decode_sample(params, token, cur_len, block_tables, pool: Pool,
                        generator: torch.Generator, temps,
                        cfg: LlamaConfig):
    """One decode step with on-device sampling, shaped for host-free
    chaining: the next token and position stay device tensors, so the
    engine dispatches K steps back to back and fetches the sampled tokens
    once per window.  ``generator`` is the device ``torch.Generator`` that
    stands in for the JAX PRNG key; it advances in place.

    Greedy for temp<=0, else categorical at the slot's temperature.
    Finished slots clamp their writes to the last position (the host
    discards their tokens).  Returns ``(next_token, cur_len + 1, pool)``.
    """
    ML = block_tables.shape[1] * pool["k"].shape[2]
    safe_cur = torch.clamp(cur_len, max=ML - 1)
    logits, pool = paged_decode_step(params, token, safe_cur, block_tables,
                                     pool, cfg=cfg)
    nxt = sample_token_batch(logits, generator, temps)
    return nxt, cur_len + 1, pool


def sample_token_batch(logits, generator: torch.Generator, temps):
    """Per-slot temperature sampling: greedy for temp<=0, categorical
    otherwise (Gumbel-max over ``logits / t``, as ``jax.random.
    categorical``; the random streams differ from JAX's, so sampled
    tokens compare by distribution only).  The one sampler for both the
    decode window and batched admission first-tokens."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp_min(temps, 1e-6)[:, None]
    noise = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=generator)
    sampled = torch.argmax(logits / t - torch.log(noise),
                           dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def gather_prefix(pool: Pool, blocks):
    """Gather ``[L, P*bs, KVH, hd]`` prefix KV for a block list ``[P]``."""
    L, _, bs = pool["k"].shape[:3]
    P = blocks.shape[0]
    k = pool["k"][:, blocks].reshape(L, P * bs, *pool["k"].shape[3:])
    v = pool["v"][:, blocks].reshape(L, P * bs, *pool["v"].shape[3:])
    return k, v
