"""Paged KV cache ops: block-table attention for the LLM engine.

Counterpart of ``ray_tpu/models/paged_generation.py``.

* The KV cache is a global block pool ``[L, num_blocks, block_size, KVH,
  hd]``; a sequence's cache is a block table of int32 pool indices.
* Decode gathers each sequence's blocks (``[b, MB*bs]`` keys) and masks by
  ``cur_len``; block 0 is the reserved scratch block that table padding
  and masked scatter lanes land on.
* Prefix-cached prefill runs per request (b=1): the cached prefix KV is
  gathered from the pool, only the suffix runs through the layers.
* ``paged_verify_step`` feeds S tokens per slot in one forward for the
  engine's speculative decoding.
* ``kv_dtype="int8"`` stores KV as symmetric per-(token, kv-head) int8
  codes with bf16 scales, about half the bytes of a bf16 pool.

The JAX programs donate the pool buffer to XLA; here the pool is updated
in place (``index_put_``), which is what the donation buys there: no
second copy of the pool per call.  Functions still return the pool so the
call sites read as in the reference.

JAX clamps out-of-range gather indices and torch does not (it raises on
the CPU and trips a device-side assert on CUDA), so the indices JAX lets
clamp are clamped explicitly; each place says so.

Under a mesh (the engine's ``mesh=``) every function runs whole on one
rank's local tensors, given its ``shard`` (``parallel.local.LocalShard``):
the params are the rank's tp shards, the pool its slice
``[L / pp, blocks, bs, KVH / tp, hd]``, and the collectives are the
shard's (sums over tp in the lookup and after ``wo`` and ``w_down``, the
head's gather over tp, the activation handed from stage to stage and the
last stage's logits sent to every stage).  With no shard nothing changes.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.generation import (_layer_with_cache,
                                             _stacked_layers, gumbel_argmax,
                                             sliding_window_mask)
from ray_tpu_torch.models.llama import LlamaConfig, embed_tokens
from ray_tpu_torch.models.llama import lm_head as _lm_head
from ray_tpu_torch.ops.layers import rope_frequencies

Pool = Dict[str, torch.Tensor]


def init_kv_pool(cfg: LlamaConfig, num_blocks: int, block_size: int,
                 kv_dtype=None, device=None, shard=None) -> Pool:
    """Block pool; block 0 is the reserved scratch block.

    ``kv_dtype="int8"`` stores KV as symmetric per-(token, kv-head) int8
    with bf16 scales: (hd + 2) bytes per token and head instead of 2·hd,
    so about twice the sequences fit next to the weights.

    Zero-filled on purpose: the scratch block and table-padding slots are
    gathered and then masked with -1e30, and a NaN or inf left there by an
    uninitialised allocation would turn ``0 * garbage`` into a NaN.

    With ``shard`` the pool is that rank's slice: ``L / pp`` layers and
    ``KVH / tp`` kv heads.
    """
    if kv_dtype not in (None, "auto", "int8"):
        raise ValueError(f"kv_dtype must be None/'auto'/'int8', got "
                         f"{kv_dtype!r}")
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    L, kvh = cfg.num_layers, cfg.num_kv_heads
    if shard is not None:
        L, kvh = L // shard.pp_size, kvh // shard.tp_size
    shape = (L, num_blocks, block_size, kvh, hd)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _quantize_kv(x):
    """[..., hd] -> (int8 codes, bf16 per-vector scale).

    As the reference computes it, in x's own dtype: the scale is
    ``max|x| / 127`` clamped at 1e-8; the codes are ``x / scale`` with
    that unrounded scale, rounded half to even; only then is the scale
    rounded to bf16 (codes from the bf16 scale would differ).  In bf16 a
    quotient can round up to 128: XLA's conversion saturates it to 127,
    torch's wraps it, so the clamp is explicit."""
    scale = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.round(x / scale[..., None]).clamp(-128, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _store_kv(pool: Pool, i: int, blk, off, k, v) -> Pool:
    """Scatter one layer's new KV at (blk, off), in place, quantizing if
    the pool is int8.  k/v: [n, KVH, hd] (n = batch or suffix length) or
    [b, S, KVH, hd] with blk/off [b, S]."""
    if "k_scale" in pool:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        pool["k_scale"][i].index_put_((blk, off), ks)
        pool["v_scale"][i].index_put_((blk, off), vs)
        k, v = kq, vq
    pool["k"][i].index_put_((blk, off), k)
    pool["v"][i].index_put_((blk, off), v)
    return pool


# Block-table CAPACITY (MB*bs, the engine's max_len in tokens) from which
# the int8 decode path keeps KV quantized through attention (the
# scale-folded attend) instead of dequantizing in the gather.  Capacity,
# not the sequences' true lengths, is the knob: a decode step always
# gathers the full table width, so the cost of dequantizing grows with
# capacity.  The value is the reference's, so that both packages take
# the same path at the same capacity; the H100's own crossover is
# measured by chip_smoke.py (PERF.md).
INT8_FOLD_MIN_CONTEXT = 384


def _gather_kv(pool: Pool, i: int, block_tables, dt):
    """Gather one layer's KV for ``[b, MB]`` block tables.

    Dense pool -> ``(k, v)`` in dt.  Int8 pool -> dequantized ``(k, v)``
    in dt below ``INT8_FOLD_MIN_CONTEXT`` tokens of table capacity,
    still-quantized ``(k_q, ks, v_q, vs)`` from it on (consumed by the
    scale-folded attend).  Values ``[b, MB, bs, KVH, hd]``, scales
    ``[b, MB, bs, KVH]``."""
    k = pool["k"][i][block_tables]
    v = pool["v"][i][block_tables]
    if "k_scale" in pool:
        ks = pool["k_scale"][i][block_tables]
        vs = pool["v_scale"][i][block_tables]
        MB, bs = k.shape[1], k.shape[2]
        if MB * bs >= INT8_FOLD_MIN_CONTEXT:
            return k, ks, v, vs
        k = k.to(dt) * ks.to(dt)[..., None]
        v = v.to(dt) * vs.to(dt)[..., None]
    return k, v


def _stage_input(params, tokens, cfg: LlamaConfig, shard):
    """The activation entering this rank's layers: the embedded tokens,
    or under pp past the first stage what the stage before sends."""
    if shard is None:
        return embed_tokens(params, tokens, cfg)
    return shard.stage_input(
        lambda: embed_tokens(params, tokens, cfg, shard=shard),
        (*tokens.shape, cfg.hidden_size), cfg.dtype, tokens.device)


def _final_logits(params, cfg: LlamaConfig, x, shard, pick=None):
    """``pick(lm_head(x))`` (the rows a function returns; all by
    default).  Under pp each stage first sends its activation on, the
    last stage computes the logits and they reach every stage."""
    pick = pick or (lambda lg: lg)
    if shard is None:
        return pick(_lm_head(params, cfg, x))
    shard.stage_output(x)
    if shard.last_stage:
        y = pick(_lm_head(params, cfg, x, shard=shard))
    else:  # a buffer shaped as the picked logits
        y = torch.empty(pick(torch.empty((*x.shape[:-1], cfg.vocab_size),
                                         device="meta")).shape,
                        device=x.device)
    return shard.from_last_stage(y)


@torch.no_grad()
def paged_decode_step(params, token, cur_len, block_tables, pool: Pool,
                      cfg: LlamaConfig, shard=None):
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
    x = _stage_input(params, token[:, None], cfg, shard)
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
            # gather this sequence's blocks in logical order; 2-tuple =
            # dense/dequantized, 4-tuple = int8 codes + scales (folded
            # attend): _layer_with_cache dispatches on the arity
            g = _gather_kv(pool, i, block_tables, cfg.dtype)
            return tuple(a.reshape(b, MB * bs, *a.shape[3:]) for a in g)

        x, _ = _layer_with_cache(x, lp, merge, cfg=cfg, cos=cos, sin=sin,
                                 mask=mask, positions=positions, shard=shard)
    return _final_logits(params, cfg, x, shard, lambda lg: lg[:, 0]), pool


@torch.no_grad()
def prefill_suffix(params, tokens, length, start_pos, prefix_k, prefix_v,
                   prefix_len, dst_blocks, dst_offsets, pool: Pool,
                   cfg: LlamaConfig, shard=None):
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
    x = _stage_input(params, tokens, cfg, shard)
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
                                 mask=mask, positions=positions, shard=shard)
    return _final_logits(params, cfg, x, shard,
                         lambda lg: lg[:, length - 1]), pool


@torch.no_grad()
def paged_verify_step(params, tokens, cur_len, block_tables, pool: Pool,
                      cfg: LlamaConfig, shard=None):
    """Speculative-decoding verify against block-table caches: feed S
    tokens per slot in ONE forward (``tokens[:, 0]`` is the pending
    last-accepted token, ``1..S-1`` the draft proposals).

    ``logits[:, j]`` predicts the token at position ``cur_len+j+1``, so
    greedy acceptance compares ``argmax(logits[:, j])`` with draft token
    ``j+1``: the paged counterpart of the dense ``verify_step``.  KV for
    all S positions is written at ``cur_len..cur_len+S-1`` through the
    block tables (pad / overflow lanes clamp to the table's last
    position); slots past the accepted prefix hold draft-conditioned KV
    but stay invisible (masks are ``<= position``) and are overwritten
    when those positions are genuinely reached.  Returns ``(logits [b, S,
    vocab], pool)``.
    """
    b, S = tokens.shape
    MB = block_tables.shape[1]
    bs = pool["k"].shape[2]
    ML = MB * bs
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.resolved_head_dim, ML, cfg.rope_theta,
                                device=dev)
    positions = cur_len[:, None] + torch.arange(S, device=dev)[None, :]
    safe_pos = torch.clamp(positions, max=ML - 1)
    x = _stage_input(params, tokens, cfg, shard)
    idx = torch.arange(ML, device=dev)
    # query at global position p sees pool slots <= p (its own included);
    # earlier same-chunk tokens are visible because each layer stores the
    # whole chunk's KV before gathering
    mask = idx[None, None, :] <= safe_pos[:, :, None]
    if cfg.sliding_window is not None:
        mask &= sliding_window_mask(safe_pos[:, :, None],
                                    idx[None, None, :], cfg.sliding_window)
    rows = torch.arange(b, device=dev)[:, None]
    blk = block_tables[rows, safe_pos // bs]  # [b, S]
    off = safe_pos % bs

    for i, lp in _stacked_layers(params):
        def merge(k, v, i=i):
            _store_kv(pool, i, blk, off, k, v)  # k/v [b, S, KVH, hd]
            g = _gather_kv(pool, i, block_tables, cfg.dtype)
            return tuple(a.reshape(b, ML, *a.shape[3:]) for a in g)

        x, _ = _layer_with_cache(x, lp, merge, cfg=cfg, cos=cos, sin=sin,
                                 mask=mask, positions=safe_pos, shard=shard)
    return _final_logits(params, cfg, x, shard), pool


@torch.no_grad()
def paged_decode_sample(params, token, cur_len, block_tables, pool: Pool,
                        generator: torch.Generator, temps,
                        cfg: LlamaConfig, shard=None):
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
                                     pool, cfg=cfg, shard=shard)
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
    sampled = gumbel_argmax(logits / t, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


def gather_prefix(pool: Pool, blocks):
    """Gather ``[L, P*bs, KVH, hd]`` prefix KV for a block list ``[P]``,
    dequantized to bf16 when the pool is int8 (bf16 whatever
    ``cfg.dtype`` is, as in the reference)."""
    L, _, bs = pool["k"].shape[:3]
    P = blocks.shape[0]
    k = pool["k"][:, blocks]
    v = pool["v"][:, blocks]
    if "k_scale" in pool:
        k = k.to(torch.bfloat16) * pool["k_scale"][:, blocks].to(
            torch.bfloat16)[..., None]
        v = v.to(torch.bfloat16) * pool["v_scale"][:, blocks].to(
            torch.bfloat16)[..., None]
    k = k.reshape(L, P * bs, *pool["k"].shape[3:])
    v = v.reshape(L, P * bs, *pool["v"].shape[3:])
    return k, v
