"""Autoregressive generation for the Llama family: KV cache + sampling.

Counterpart of ``ray_tpu/models/generation.py``:

- the dense cache is ``[L, b, max_len, kvh, hd]``; per-sequence lengths
  are data (a ``cur_len`` vector), so a ragged right-padded batch shares
  one path;
- decode writes each sequence's new KV at its own slot and attends over
  the whole cache under a length mask; ``verify_step`` does the same for
  K+1 tokens per sequence (prompt-lookup speculative decoding);
- ``sample_token``: greedy, or temperature with top-k and top-p.  The JAX
  PRNG key becomes an explicit ``torch.Generator``; the random streams
  differ, so sampled tokens compare by distribution only.

The paged engine (``paged_generation.py``) shares the attends and the
cache-enabled decoder layer.  The JAX functions return a new cache; here
it is updated in place (what donation buys there) and still returned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, embed_tokens, lm_head
from ray_tpu_torch.models.llama import (  # noqa: F401
    stacked_layers as _stacked_layers)
from ray_tpu_torch.ops.attention import sliding_window_mask  # noqa: F401
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    max_tokens: int = 64
    stop_token_id: Optional[int] = None


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None):
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _gqa_attend(q, k, v, mask):
    """q [b,sq,H,hd], k/v [b,sk,KVH,hd], mask [b,sq,sk] -> [b,sq,H,hd].

    fp32 logits divided by sqrt(hd) AFTER the product (unlike
    ``reference_attention``, which multiplies by ``d**-0.5``; each keeps
    its reference's arithmetic), -1e30 mask, softmax cast to ``v.dtype``
    before the PV product with fp32 accumulation."""
    b, sq, H, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, H // kvh, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.reshape(b, sq, H, hd).to(q.dtype)


def _gqa_attend_quant(q, k_q, ks, v_q, vs, mask):
    """Int8-KV attention with the scales folded around the products.

    The int8 codes enter the products as they are (exact in any float
    type: |code| <= 127) and the per-(token, kv-head) scales multiply the
    ``[.., sq, sk]`` scores and probabilities instead: exact, because a
    scale is constant along the contracted ``hd`` axis,
    ``q·(k_q·s) == (q·k_q)·s`` and ``(p·s)·v_q == p·(v_q·s)``.  No
    dequantized ``[b, sk, KVH, hd]`` tensor in ``q.dtype`` is made.

    q [b,sq,H,hd]; k_q/v_q [b,sk,KVH,hd] int8; ks/vs [b,sk,KVH];
    mask [b,sq,sk].
    """
    b, sq, H, hd = q.shape
    kvh = k_q.shape[2]
    qg = q.reshape(b, sq, kvh, H // kvh, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k_q.float())
    scale_k = ks.transpose(1, 2)[:, :, None, None, :]  # [b,kvh,1,1,sk]
    logits = logits * scale_k.float()
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    scale_v = vs.transpose(1, 2)[:, :, None, None, :]
    probs = (probs * scale_v.float()).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v_q.float())
    return out.reshape(b, sq, H, hd).to(q.dtype)


def _layer_with_cache(x, lp, layer_kv, *, cfg, cos, sin, mask,
                      positions=None, shard=None):
    """One decoder layer reading/returning its kv (cache-enabled twin of
    ``llama._decoder_layer``; same weights, ragged-mask attention).

    ``layer_kv(k, v)`` merges with the cache and returns either
    ``(k_all, v_all)`` (dense) or ``(k_q, ks, v_q, vs)`` (int8 codes and
    per-token-head scales, routed through the scale-folded attend).

    The head counts come from the weights' shapes, so the body runs as
    well on one tp shard's local weights (``num_heads / tp`` and
    ``num_kv_heads / tp`` heads); ``shard`` (a ``LocalShard``) then sums
    the row-parallel products of ``wo`` and ``w_down`` over tp before
    each residual add (``LocalShard.row_parallel``), the all-reduces XLA
    inserts in the reference.  Without it the body is the single-device
    one."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    y = rms_norm(x, lp["attn_norm"])
    q = (y @ lp["wq"].to(dt)).reshape(b, s, -1, hd)
    k = (y @ lp["wk"].to(dt)).reshape(b, s, -1, hd)
    v = (y @ lp["wv"].to(dt)).reshape(b, s, -1, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    merged = layer_kv(k, v)  # merge with cache; full keys/vals
    if len(merged) == 4:
        attn = _gqa_attend_quant(q, *merged, mask)
    else:
        attn = _gqa_attend(q, merged[0], merged[1], mask)
    row = torch.matmul if shard is None else shard.row_parallel
    x = x + row(attn.reshape(b, s, -1), lp["wo"].to(dt))
    y = rms_norm(x, lp["mlp_norm"])
    act = swiglu(y @ lp["w_gate"].to(dt), y @ lp["w_up"].to(dt))
    return x + row(act, lp["w_down"].to(dt)), (k, v)


@torch.no_grad()
def prefill(params, tokens, lengths, cache, cfg: LlamaConfig):
    """Process right-padded prompts, filling ``cache[:, :, :S]``.

    tokens: [b, S] int; lengths: [b] true prompt lengths.
    Returns (logits_at_last [b, vocab], cache).
    """
    b, S = tokens.shape
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.resolved_head_dim, S, cfg.rope_theta,
                                device=dev)
    x = embed_tokens(params, tokens, cfg)
    # causal AND within true length: key j visible to query i iff j<=i and
    # j < len (padded keys never visible)
    idx = torch.arange(S, device=dev)
    mask = (idx[None, None, :] <= idx[None, :, None]) & (
        idx[None, None, :] < lengths[:, None, None])
    if cfg.sliding_window is not None:
        mask &= sliding_window_mask(idx[None, :, None], idx[None, None, :],
                                    cfg.sliding_window)
    for i, lp in _stacked_layers(params):
        x, (k, v) = _layer_with_cache(x, lp, lambda k, v: (k, v), cfg=cfg,
                                      cos=cos, sin=sin, mask=mask)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    logits = lm_head(params, cfg, x)
    last = logits[torch.arange(b, device=dev), lengths.long() - 1]
    return last, cache


def decode_step(params, token, cur_len, cache, cfg: LlamaConfig):
    """One token per sequence: token [b], cur_len [b] = positions to
    write.  Returns (logits [b, vocab], cache with slot cur_len filled):
    ``verify_step`` of one token, which is the same computation."""
    logits, cache = verify_step(params, token[:, None], cur_len, cache, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def verify_step(params, tokens, cur_len, cache, cfg: LlamaConfig):
    """Speculative-decoding verify: feed K+1 tokens per sequence in ONE
    forward (tokens[:, 0] is the last accepted token, 1..K the draft).

    logits[:, j] predicts the token at position cur_len+j+1, so greedy
    acceptance compares argmax(logits[:, j]) with draft token j+1.  Cache
    slots cur_len..cur_len+K are written; slots past the accepted prefix
    hold draft-conditioned K/V but stay invisible (masks are <= position)
    and are overwritten when those positions are genuinely reached.
    """
    b, n = tokens.shape
    max_len = cache["k"].shape[2]
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.resolved_head_dim, max_len,
                                cfg.rope_theta, device=dev)
    steps = torch.arange(n, device=dev)
    positions = cur_len[:, None] + steps[None]  # [b, K+1]
    x = embed_tokens(params, tokens, cfg)
    idx = torch.arange(max_len, device=dev)
    # query at global position p sees key slots <= p (its own included)
    mask = idx[None, None, :] <= positions[:, :, None]
    if cfg.sliding_window is not None:
        mask &= sliding_window_mask(positions[:, :, None],
                                    idx[None, None, :], cfg.sliding_window)
    # JAX clamps what lies past the cache, where torch would raise: its
    # dynamic_update_slice moves the start so all n slots fit, and its
    # RoPE gather reads the last row (only the lanes of finished
    # sequences in ``_generate_speculative`` get there)
    slots = torch.clamp(cur_len, 0, max_len - n)[:, None] + steps[None]
    rope_pos = torch.clamp(positions, max=max_len - 1)
    rows = torch.arange(b, device=dev)[:, None]

    for i, lp in _stacked_layers(params):
        def merge(k, v, i=i):
            cache["k"][i][rows, slots] = k
            cache["v"][i][rows, slots] = v
            return cache["k"][i], cache["v"][i]

        x, _ = _layer_with_cache(x, lp, merge, cfg=cfg, cos=cos, sin=sin,
                                 mask=mask, positions=rope_pos)
    return lm_head(params, cfg, x), cache


def _propose_ngram(history: List[int], k: int, ngram: int = 2) -> List[int]:
    """Prompt-lookup drafting (self-speculation, no draft model): find the
    most recent earlier occurrence of the trailing n-gram whose
    continuation is FULL-LENGTH and propose the k tokens that followed
    it; fall back to the longest partial continuation.  (A match
    adjacent to the tail, which every periodic sequence has, truncates
    its continuation at the sequence end; stopping at the first match
    would cap steady-loop workloads at ~1 proposed token.)"""
    n = len(history)
    if n < ngram + 1:
        return []
    tail = history[-ngram:]
    best: List[int] = []
    # search right-to-left, excluding the trailing occurrence itself
    for start in range(n - ngram - 1, -1, -1):
        if history[start:start + ngram] == tail:
            cont = history[start + ngram:start + ngram + k]
            if len(cont) == k:
                return cont
            if len(cont) > len(best):
                best = cont
    return best


def masked_logits(logits, sp: SamplingParams):
    """``logits [b, vocab] / temperature`` with everything outside the
    top-k and the top-p nucleus set to -inf (the logits ``sample_token``
    draws from).  top-p keeps the smallest set whose cumulative
    probability reaches ``top_p``."""
    logits = logits / sp.temperature
    if sp.top_k and sp.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -sp.top_k][:, None]
        logits = torch.where(logits < kth, -math.inf, logits)
    if sp.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # JAX's take_along_axis fills an index past the end (a cumulative
        # sum that rounds below top_p) with NaN, which masks nothing; the
        # last index masks nothing either, and torch's gather needs it
        cutoff_idx = torch.clamp((cum < sp.top_p).sum(-1),
                                 max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -math.inf, logits)
    return logits


def gumbel_argmax(logits, generator: torch.Generator):
    """One categorical draw per row of ``logits`` (Gumbel-max, as
    ``jax.random.categorical``), from ``generator``; int32."""
    noise = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=generator)
    return torch.argmax(logits - torch.log(noise), dim=-1).to(torch.int32)


def sample_token(logits, generator: torch.Generator, sp: SamplingParams):
    """Greedy when temperature==0, else temperature/top-k/top-p sampling."""
    if sp.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return gumbel_argmax(masked_logits(logits, sp), generator)


def _generate_speculative(params, cfg: LlamaConfig, prompts: List[List[int]],
                          sampling: SamplingParams, logits, cache, lengths,
                          max_len: int, K: int) -> List[List[int]]:
    """Greedy prompt-lookup speculative decoding loop.

    Per step: draft up to K tokens per sequence from its own history
    (``_propose_ngram``), verify pending-token + drafts in one
    ``verify_step`` forward, accept the longest greedy-matching draft
    prefix plus the bonus token.  Reproduces greedy ``generate`` output
    (the acceptance rule only keeps tokens argmax would have produced);
    steps where no sequence has a draft fall back to ``decode_step``.
    All acceptance/stop/budget bookkeeping is host-side.
    """
    b = len(prompts)
    dev = logits.device
    stop = sampling.stop_token_id
    # Greedy emits at most max(1, max_len - prompt_len) tokens before its
    # capacity stop (cur_len >= max_len - 1) fires: the prefill token is
    # always emitted BEFORE the stop is checked; mirror that exactly.
    budget = [min(sampling.max_tokens, max(1, max_len - len(p)))
              for p in prompts]
    histories = [list(p) for p in prompts]
    results: List[List[int]] = [[] for _ in range(b)]
    done = [budget[i] <= 0 for i in range(b)]
    # cur_np[i] = cache slot where sequence i's next token's K/V goes; the
    # last emitted ("pending") token has not been written yet.
    cur_np = lengths.tolist()
    pending = torch.argmax(logits, -1).tolist()

    def emit(i: int, tok: int) -> bool:
        """Record one accepted token; returns False once i is finished."""
        if stop is not None and tok == stop:
            done[i] = True
            return False
        results[i].append(tok)
        histories[i].append(tok)
        if len(results[i]) >= budget[i]:
            done[i] = True
            return False
        return True

    for i in range(b):
        if not done[i]:
            emit(i, pending[i])

    while not all(done):
        drafts, dlens = [], []
        for i in range(b):
            d = _propose_ngram(histories[i], K) if not done[i] else []
            d = d[:K]
            dlens.append(len(d))
            drafts.append(d + [0] * (K - len(d)))
        cur = torch.tensor(cur_np, dtype=torch.int32, device=dev)
        token_col = torch.tensor(pending, dtype=torch.int32, device=dev)
        if max(dlens) == 0:
            logits, cache = decode_step(params, token_col, cur, cache, cfg)
            preds = torch.argmax(logits, -1).tolist()  # [b]
            for i in range(b):
                if done[i]:
                    continue
                cur_np[i] += 1
                tok = preds[i]
                if emit(i, tok):
                    pending[i] = tok
            continue
        tokens = torch.cat([token_col[:, None],
                            torch.tensor(drafts, dtype=torch.int32,
                                         device=dev)], dim=1)
        logits, cache = verify_step(params, tokens, cur, cache, cfg)
        preds = torch.argmax(logits, -1).tolist()  # [b, K+1]
        for i in range(b):
            if done[i]:
                continue
            a = 0
            while a < dlens[i] and drafts[i][a] == preds[i][a]:
                a += 1
            # pending + a accepted drafts now hold valid cache slots
            cur_np[i] += 1 + a
            alive = True
            for tok in drafts[i][:a]:
                if not (alive := emit(i, tok)):
                    break
            if alive:
                bonus = preds[i][a]
                if emit(i, bonus):
                    pending[i] = bonus
    return results


def generate(params, cfg: LlamaConfig, prompts: List[List[int]],
             sampling: SamplingParams, *,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             speculative: int = 0) -> List[List[int]]:
    """Batched generation on the params' device; returns new token ids per
    prompt (no echo).  ``generator`` stands in for the JAX key (default:
    seeded with 0 on that device).

    ``speculative=K`` turns on prompt-lookup speculative decoding (greedy
    only): K draft tokens per step are proposed from each sequence's own
    history and verified in one forward: exact greedy outputs, fewer
    sequential steps when text repeats (code, structured output).
    """
    if speculative > 0 and sampling.temperature != 0.0:
        # fail before any device allocation happens
        raise ValueError("speculative decoding requires greedy "
                         "sampling (temperature=0)")
    dev = params["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    b = len(prompts)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=dev)
    S = max(len(p) for p in prompts)
    if max_len is None:
        max_len = min(cfg.max_seq_len, S + sampling.max_tokens)
    padded = torch.tensor([list(p) + [0] * (S - len(p)) for p in prompts],
                          dtype=torch.int32, device=dev)
    # Speculative verify writes K+1 slots per step; give the cache K+1 slots
    # of slack past the logical max_len so writes never clamp.  The logical
    # stopping rule (emit at most max_len - prompt_len tokens) is enforced
    # host-side in _generate_speculative.
    cache_len = max_len + (speculative + 1 if speculative > 0 else 0)
    cache = init_kv_cache(cfg, b, cache_len, device=dev)

    logits, cache = prefill(params, padded, lengths, cache, cfg)
    if speculative > 0:
        return _generate_speculative(params, cfg, prompts, sampling, logits,
                                     cache, lengths, max_len, speculative)
    stop = sampling.stop_token_id
    cur_len = lengths
    out_tokens = []
    was_done = []  # done state BEFORE each step's token (per sequence)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(sampling.max_tokens):
        was_done.append(done.tolist())
        token = sample_token(logits, generator, sampling)
        if stop is not None:
            done = done | (token == stop)
        out_tokens.append(token.tolist())
        # per-sequence capacity stop: one long sequence filling its cache
        # lane must not truncate the others
        done = done | (cur_len >= max_len - 1)
        if bool(done.all()):
            break
        logits, cache = decode_step(params, token, cur_len, cache, cfg)
        cur_len = torch.where(done, cur_len, cur_len + 1)

    results = []
    for i in range(b):
        seq = []
        for t in range(len(out_tokens)):
            if was_done[t][i]:
                break
            tok = out_tokens[t][i]
            if stop is not None and tok == stop:
                break
            seq.append(tok)
        results.append(seq)
    return results
