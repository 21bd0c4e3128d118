"""LLMEngine: continuous batching over a paged block-table KV cache.

Counterpart of ``ray_tpu/llm/engine.py`` with the same structure:

* **Paged KV**: one global block pool ``[L, num_blocks, bs, KVH, hd]``
  (``models/paged_generation.py``); each request holds a block table.
* **Prefix caching**: full prompt blocks are registered under a rolling
  hash chain ``key = (parent_key, block_tokens)``; a new request reuses
  every hit and prefills only the suffix (one b=1 prefill per admission).
  Refcount-0 blocks retire into an LRU that keeps their contents.
* **One batched first-token sample** for all admissions of a step, then a
  **decode window** of K device-chained steps with one host sync.
* **Preemption**: out of blocks mid-decode, the youngest request is rolled
  back to the queue and re-prefills later (recompute preemption).

PyTorch runs eagerly, so there is no jit; prefill lengths stay bucketed
(``_bucket``) so padding is identical to the reference.  The decode loop
is a Python loop of eager ops; CUDA graphs for it are a later PR.

Not in this slice (each raises ``NotImplementedError`` naming where it
comes): speculative decoding (``spec_tokens``), chunked prefill
(``prefill_chunk``), the int8 KV pool, mesh sharding, and the
disaggregated-serving handoff (``prefill_only``, ``export_kv``,
``adopt_prefilled``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.generation import SamplingParams
from ray_tpu_torch.models.llama import LlamaConfig, llama_init
from ray_tpu_torch.models.paged_generation import (gather_prefix,
                                                   init_kv_pool,
                                                   paged_decode_sample,
                                                   prefill_suffix,
                                                   sample_token_batch)


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {where} (ROADMAP.md, "
        f"Queue 1)")


class ByteTokenizer:
    """Dependency-free fallback tokenizer: UTF-8 bytes shifted by the
    special ids (0=pad, 1=bos, 2=eos, byte b -> 3+b)."""

    pad_id, bos_id, eos_id = 0, 1, 2
    vocab_size = 259

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + [3 + b for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(i - 3 for i in ids if i >= 3)
        return data.decode("utf-8", "replace")


def default_tokenizer(model_vocab_size: Optional[int] = None):
    """The in-repo BPE vocab when it fits the model's embedding table,
    byte fallback otherwise (ids past ``cfg.vocab_size`` would be clamped
    by the embedding gather: garbage generation, no error)."""
    from ray_tpu_torch.llm.bpe import BPETokenizer

    try:
        tok = BPETokenizer()
    except OSError:  # vocab artifact missing
        return ByteTokenizer()
    if model_vocab_size is None or tok.vocab_size <= model_vocab_size:
        return tok
    return ByteTokenizer()


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_tokens: List[int]
    sampling: SamplingParams
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    blocks: List[int] = dataclasses.field(default_factory=list)
    # cached prompt hash-chain keys (prompt_tokens are immutable while
    # queued; preemption rewrites them and must clear this)
    chain_keys: Optional[List[Any]] = None
    # preemption folds generated tokens into prompt_tokens for re-prefill;
    # n_prompt remembers the ORIGINAL prompt length so outputs and the
    # max_tokens budget survive any number of preemptions
    n_prompt: int = -1
    error: Optional[str] = None

    def __post_init__(self):
        if self.n_prompt < 0:
            self.n_prompt = len(self.prompt_tokens)

    @property
    def num_generated(self) -> int:
        return (len(self.prompt_tokens) - self.n_prompt
                + len(self.out_tokens))

    @property
    def all_out_tokens(self) -> List[int]:
        return self.prompt_tokens[self.n_prompt:] + self.out_tokens


@dataclasses.dataclass
class GenerationOutput:
    request_id: int
    prompt_tokens: List[int]
    token_ids: List[int]
    text: Optional[str] = None
    error: Optional[str] = None  # per-request failure (e.g. pool too small)


class _BlockManager:
    """Host-side pool bookkeeping: free list, refcounts, prefix hash chain
    with LRU retention of refcount-0 blocks (automatic prefix caching,
    evict-last)."""

    def __init__(self, num_blocks: int):
        # block 0 is the device-side scratch block (padding / masked writes)
        self.num_blocks = num_blocks
        self.free: collections.deque = collections.deque(
            range(1, num_blocks))
        self.refs: Dict[int, int] = {}
        self.key_of: Dict[int, Any] = {}
        self.by_key: Dict[Any, int] = {}
        self.lru: "collections.OrderedDict[Any, int]" = \
            collections.OrderedDict()
        self.stats = {"prefix_hits": 0, "prefix_blocks_reused": 0,
                      "evictions": 0, "preemptions": 0}

    def available(self) -> int:
        return len(self.free) + len(self.lru)

    def alloc(self) -> Optional[int]:
        if self.free:
            bid = self.free.popleft()
        elif self.lru:
            key, bid = self.lru.popitem(last=False)  # evict oldest cached
            self.by_key.pop(key, None)
            self.key_of.pop(bid, None)
            self.stats["evictions"] += 1
        else:
            return None
        self.refs[bid] = 1
        return bid

    def acquire_cached(self, key) -> Optional[int]:
        """Prefix hit: bump the block's refcount (reviving it from the
        LRU if it was retired)."""
        bid = self.by_key.get(key)
        if bid is None:
            return None
        if key in self.lru:
            del self.lru[key]
            self.refs[bid] = 0
        self.refs[bid] = self.refs.get(bid, 0) + 1
        self.stats["prefix_blocks_reused"] += 1
        return bid

    def register(self, bid: int, key) -> None:
        """Publish a freshly-filled full block under its chain key."""
        if key in self.by_key:
            return  # an identical prefill won the race; keep ours unpublished
        self.key_of[bid] = key
        self.by_key[key] = bid

    def release(self, bid: int) -> None:
        n = self.refs.get(bid, 0) - 1
        if n > 0:
            self.refs[bid] = n
            return
        self.refs.pop(bid, None)
        key = self.key_of.get(bid)
        if key is not None:
            self.lru[key] = bid  # retain contents for future prefix hits
        else:
            self.free.append(bid)

    def assert_integrity(self) -> None:
        """Audit invariant: every non-scratch block is in exactly one of
        {free, LRU-retained, refcounted}, and every refcount is positive
        — the abort/preemption paths must never leak or double-free a
        block."""
        free = set(self.free)
        lru = set(self.lru.values())
        refed = set(self.refs)
        assert all(n > 0 for n in self.refs.values()), \
            f"non-positive refcounts: {self.refs}"
        assert not (free & lru), f"blocks both free and cached: {free & lru}"
        assert not (free & refed), f"blocks both free and held: {free & refed}"
        assert not (lru & refed), f"blocks both cached and held: {lru & refed}"
        everything = free | lru | refed
        expect = set(range(1, self.num_blocks))
        assert everything == expect, \
            (f"block accounting leak: missing {expect - everything}, "
             f"phantom {everything - expect}")


class LLMEngine:
    def __init__(self, cfg: LlamaConfig, params=None, *,
                 tokenizer: Optional[Any] = None, batch_slots: int = 8,
                 max_len: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, decode_window: int = 16,
                 seed: int = 0, device=None, mesh=None,
                 kv_cache_dtype: Optional[str] = None,
                 spec_tokens: int = 0, prefill_chunk: int = 0):
        if spec_tokens > 0:
            raise _later("speculative decoding (spec_tokens > 0, "
                         "paged_verify_step and the arm bandit)",
                         "the speculative-decoding slice")
        if prefill_chunk > 0:
            raise _later("chunked prefill (prefill_chunk > 0)",
                         "a later serving slice")
        if kv_cache_dtype == "int8":
            raise _later("the int8 KV pool", "a later serving slice")
        if mesh is not None:
            raise _later("mesh (tensor-parallel) serving",
                         "the parallel slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer(cfg.vocab_size)
        self.B = batch_slots
        self.max_len = max_len or cfg.max_seq_len
        self.bs = block_size
        self.MB = -(-self.max_len // block_size)  # blocks per sequence
        # default pool = dense-equivalent capacity (callers can shrink it:
        # prefix sharing + short requests usually need far less)
        self.num_blocks = num_blocks or (self.B * self.MB + 1)
        if params is None:
            params = llama_init(cfg, seed, self.device)
        self.params = params
        # the JAX engine's PRNG key (seed + 1) becomes a device generator
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self.kv_cache_dtype = kv_cache_dtype
        self.pool = init_kv_pool(cfg, self.num_blocks, self.bs,
                                 kv_dtype=kv_cache_dtype, device=self.device)
        self.blocks = _BlockManager(self.num_blocks)
        # multi-step window: K device steps chained without a host sync
        # (token/position stay device tensors), sampled tokens fetched
        # ONCE per window
        self.K = max(1, decode_window)
        self._ids = itertools.count()
        self._queue: "collections.deque[Request]" = collections.deque()
        self._failed: List[Request] = []  # per-request admission failures
        self._slots: List[Optional[Request]] = [None] * self.B
        self._cur_len = np.zeros(self.B, np.int32)
        self._next_token = np.zeros(self.B, np.int32)
        self._tables = np.zeros((self.B, self.MB), np.int32)
        # device mirrors of the decode inputs, kept resident across
        # windows; any host-side slot mutation sets the dirty flag
        self._dev: Optional[Tuple[Any, Any]] = None  # (tok_d, cur_d)
        self._tables_d = None
        self._temps_d = None
        self._dev_dirty = True
        # host wall time between the engine's own sync points: admission
        # ends in the first-token fetch and a window in its token fetch,
        # so these are device-complete times
        self.timing = {"prefill_s": 0.0, "prefill_tokens": 0,
                       "decode_s": 0.0, "decode_tokens": 0}

    # -- request API --------------------------------------------------------

    def submit(self, prompt, sampling: Optional[SamplingParams] = None, *,
               prefill_only: bool = False) -> int:
        if prefill_only:
            raise _later("prefill-only requests (disaggregated serving)",
                         "the disaggregated-serving slice")
        if isinstance(prompt, str):
            prompt = self.tokenizer.encode(prompt)
        sampling = sampling or SamplingParams(
            stop_token_id=getattr(self.tokenizer, "eos_id", None))
        req = Request(next(self._ids), list(prompt), sampling)
        if len(req.prompt_tokens) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt_tokens)} tokens >= engine "
                f"max_len {self.max_len}")
        self._queue.append(req)
        return req.request_id

    def abort(self, request_id: int) -> bool:
        """Drop a request whose client stopped waiting.  A queued request
        is removed outright; an active one is marked ``done`` so the next
        ``step()`` retires it through the ordinary path (slot cleared,
        blocks released).  Returns ``True`` when the request was found."""
        for qi, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[qi]
                return True
        for req in self._slots:
            if req is not None and req.request_id == request_id:
                req.done = True
                return True
        return False

    def has_unfinished(self) -> bool:
        return (bool(self._queue) or bool(self._failed)
                or any(s is not None for s in self._slots))

    def export_kv(self, request_id: int):
        raise _later("export_kv (the KV handoff)",
                     "the disaggregated-serving slice")

    def adopt_prefilled(self, handoff, sampling=None):
        raise _later("adopt_prefilled (the KV handoff)",
                     "the disaggregated-serving slice")

    # -- continuous-batching step ------------------------------------------

    def step(self) -> List[GenerationOutput]:
        """Admit queued requests into free slots (prefix-cached prefill),
        run one decode window for all active slots, retire finished."""
        # 1. admit: prefills run back to back; the first tokens of ALL
        # admissions are sampled and fetched in ONE host sync
        t0 = time.perf_counter()
        admitted: List[Tuple[int, torch.Tensor]] = []
        prefilled = 0
        for i in range(self.B):
            if self._slots[i] is None and self._queue:
                res = self._admit(i)
                if res is None:
                    break  # out of blocks: stop admitting this step
                logits, n_suffix = res
                admitted.append((i, logits))
                prefilled += n_suffix
        if admitted:
            lg = torch.stack([d for _, d in admitted])[:, 0]
            temps = torch.tensor([self._slots[i].sampling.temperature
                                  for i, _ in admitted], dtype=torch.float32,
                                 device=self.device)
            first = sample_token_batch(lg, self._gen, temps).cpu().numpy()
            self.timing["prefill_s"] += time.perf_counter() - t0
            self.timing["prefill_tokens"] += prefilled
            for (i, _), tok in zip(admitted, first):
                self._record_token(i, self._slots[i], int(tok))

        active = [i for i in range(self.B) if self._slots[i] is not None
                  and not self._slots[i].done]
        if active:
            # ensure every active slot has blocks for the whole window;
            # preempt the youngest request if the pool is exhausted
            active = self._ensure_decode_blocks(active, horizon=self.K)
        if active:
            t0 = time.perf_counter()
            # adaptive window: never decode past what the longest-running
            # active request can still accept
            window_k = self._window_arity(active)
            self._refresh_device_mirrors()
            if self._dev is None:
                # copies (torch.tensor), never views of the host arrays
                tok_d = torch.tensor(self._next_token, device=self.device)
                cur_d = torch.tensor(self._cur_len, device=self.device)
            else:
                tok_d, cur_d = self._dev
            toks = []
            for _ in range(window_k):  # device-chained: no host sync inside
                tok_d, cur_d, self.pool = paged_decode_sample(
                    self.params, tok_d, cur_d, self._tables_d, self.pool,
                    self._gen, self._temps_d, cfg=self.cfg)
                toks.append(tok_d)
            self._dev = (tok_d, cur_d)
            # ONE host sync for the whole window_k * B window
            window = torch.stack(toks).cpu().numpy()
            recorded = 0
            for step in range(window_k):
                for i in active:
                    req = self._slots[i]
                    if req is None or req.done:
                        continue  # stopped mid-window: discard the tail
                    self._cur_len[i] += 1
                    self._record_token(i, req, int(window[step, i]))
                    recorded += 1
            self.timing["decode_s"] += time.perf_counter() - t0
            self.timing["decode_tokens"] += recorded

        # 2. retire
        out = []
        while self._failed:
            req = self._failed.pop()
            out.append(GenerationOutput(
                req.request_id, req.prompt_tokens[:req.n_prompt], [],
                text="", error=req.error))
        for i in range(self.B):
            req = self._slots[i]
            if req is not None and req.done:
                toks = req.all_out_tokens
                out.append(GenerationOutput(
                    req.request_id, req.prompt_tokens[:req.n_prompt], toks,
                    text=self.tokenizer.decode(toks)))
                for bid in req.blocks:
                    self.blocks.release(bid)
                req.blocks = []
                self._slots[i] = None
                self._tables[i] = 0
                self._dev_dirty = True
        return out

    def generate(self, prompts, sampling: Optional[SamplingParams] = None
                 ) -> List[GenerationOutput]:
        ids = [self.submit(p, sampling) for p in prompts]
        results: Dict[int, GenerationOutput] = {}
        while self.has_unfinished():
            for out in self.step():
                results[out.request_id] = out
        return [results[i] for i in ids]

    def stats(self) -> Dict[str, Any]:
        """Engine signals: queue depth, slot occupancy, block-pool
        pressure, prefix-cache counters and the prefill/decode timing.
        Host-side bookkeeping only — no device sync."""
        used = sum(1 for s in self._slots if s is not None)
        capacity = max(1, self.num_blocks - 1)  # excl. the scratch block
        available = self.blocks.available()
        return {
            "queued": len(self._queue),
            "slots_used": used,
            "slots_total": self.B,
            "slot_occupancy": round(used / self.B, 4),
            "blocks_total": capacity,
            "blocks_free": len(self.blocks.free),
            "blocks_cached": len(self.blocks.lru),
            "blocks_available": available,
            "block_pressure": round(1.0 - available / capacity, 4),
            "block_size": self.bs,
            "kv_cache_dtype": self.kv_cache_dtype or "native",
            "prefix_cache": dict(self.blocks.stats),
            "timing": dict(self.timing),
        }

    # -- admission / prefill ------------------------------------------------

    def _prompt_chain_keys(self, tokens: List[int]) -> List[Any]:
        keys = []
        parent = None
        for b in range(len(tokens) // self.bs):
            parent = (parent, tuple(tokens[b * self.bs:(b + 1) * self.bs]))
            keys.append(parent)
        return keys

    def _admit(self, i: int) -> Optional[Tuple[torch.Tensor, int]]:
        """Prefill the next queued request into slot i.

        Returns ``(last-position logits [1, vocab] on the device, tokens
        prefilled)`` when the request is admitted (the caller batch-samples
        all admissions with one sync), or None when the pool can't hold the
        suffix (queue left untouched).
        """
        req = self._queue[0]
        toks = req.prompt_tokens
        n = len(toks)
        # prefix walk: reuse every cached block (but always leave >=1
        # token to prefill — its logits seed sampling)
        if req.chain_keys is None:
            req.chain_keys = self._prompt_chain_keys(toks)
        keys = req.chain_keys
        hit_blocks: List[int] = []
        for key in keys:
            if len(hit_blocks) * self.bs >= n - 1:
                break
            bid = self.blocks.acquire_cached(key)
            if bid is None:
                break
            hit_blocks.append(bid)
        cached_len = len(hit_blocks) * self.bs
        if cached_len > n - 1:  # whole prompt cached: recompute last block
            self.blocks.release(hit_blocks.pop())
            cached_len = len(hit_blocks) * self.bs
        suffix = toks[cached_len:]
        need = -(-(n + 1) // self.bs) - len(hit_blocks)  # +1: first decode
        # worst-case footprint from the ORIGINAL prompt + full budget: after
        # a preemption, prompt_tokens already holds generated tokens and
        # the remaining budget shrinks accordingly
        worst = -(-min(req.n_prompt + req.sampling.max_tokens + 1,
                       self.max_len) // self.bs)
        if worst >= self.num_blocks:
            # even an empty pool could never hold this one sequence: fail
            # THIS request (an admit/preempt livelock otherwise), never
            # the whole batch
            self._queue.popleft()
            for bid in hit_blocks:
                self.blocks.release(bid)
            req.done = True
            req.error = (
                f"KV pool ({self.num_blocks} blocks of {self.bs}) cannot "
                f"hold one sequence of up to {worst} blocks; raise "
                f"num_blocks or lower max_tokens")
            self._failed.append(req)
            return self._admit(i) if self._queue else None
        if self.blocks.available() < need:
            for bid in hit_blocks:
                self.blocks.release(bid)
            return None
        if hit_blocks:
            self.blocks.stats["prefix_hits"] += 1

        new_blocks = [self.blocks.alloc() for _ in range(need)]
        req.blocks = hit_blocks + new_blocks
        self._queue.popleft()
        self._slots[i] = req

        logits = self._run_prefill(suffix, cached_len, req.blocks,
                                   hit_blocks)
        # register freshly-computed full blocks for future prefix hits
        for b in range(len(hit_blocks), n // self.bs):
            self.blocks.register(req.blocks[b], keys[b])
        self._cur_len[i] = n
        self._tables[i] = 0
        self._tables[i, :len(req.blocks)] = req.blocks
        self._dev_dirty = True
        return logits, len(suffix)

    def _run_prefill(self, suffix: List[int], cached_len: int,
                     blocks: List[int], hit_blocks: List[int]):
        """ONE bucketed b=1 ``prefill_suffix`` call: pads the suffix to its
        bucket, builds the scatter coordinates from ``blocks`` (position p
        -> ``blocks[p // bs]``), gathers the cached prefix, and returns the
        last-position logits as a device tensor."""
        dev = self.device
        S = _bucket(len(suffix), self.max_len)
        pad_tok = list(suffix) + [0] * (S - len(suffix))
        # pool coordinates for each padded suffix lane (pads -> scratch 0)
        dst_b = np.zeros(S, np.int32)
        dst_o = np.zeros(S, np.int32)
        for j in range(len(suffix)):
            p = cached_len + j
            dst_b[j] = blocks[p // self.bs]
            dst_o[j] = p % self.bs
        P = _bucket(len(hit_blocks), self.MB) if hit_blocks else 0
        prefix_ids = np.zeros(P, np.int32)
        prefix_ids[:len(hit_blocks)] = hit_blocks
        pk, pv = gather_prefix(self.pool, torch.as_tensor(prefix_ids,
                                                          device=dev))
        logits, self.pool = prefill_suffix(
            self.params, torch.tensor([pad_tok], dtype=torch.int32,
                                      device=dev),
            len(suffix), cached_len, pk, pv, cached_len,
            torch.as_tensor(dst_b, device=dev),
            torch.as_tensor(dst_o, device=dev), self.pool, cfg=self.cfg)
        return logits

    def _ensure_decode_blocks(self, active: List[int],
                              horizon: int = 1) -> List[int]:
        """Allocate blocks covering the next ``horizon`` write positions
        for each active slot, preempting the youngest request when the
        pool is exhausted (recompute preemption)."""
        for i in list(active):
            req = self._slots[i]
            if req is None or req.done:
                continue
            # cap at the request's remaining budget: tail tokens past
            # max_tokens are discarded (and clamp to scratch), so reserving
            # blocks for them could only cause needless preemption
            remaining = max(1, req.sampling.max_tokens - req.num_generated)
            last_pos = min(int(self._cur_len[i]) + min(horizon, remaining)
                           - 1, self.max_len - 1)
            blk_idx = last_pos // self.bs
            while blk_idx >= len(req.blocks):
                bid = self.blocks.alloc()
                if bid is None:
                    victim = self._preempt_youngest()
                    if victim is None or victim == i:
                        break  # self-preempted: slot is back in the queue
                    continue
                req.blocks.append(bid)
                self._tables[i, len(req.blocks) - 1] = bid
                self._dev_dirty = True
        return [i for i in active if self._slots[i] is not None
                and not self._slots[i].done]

    def _preempt_youngest(self) -> Optional[int]:
        cand = [i for i in range(self.B) if self._slots[i] is not None
                and not self._slots[i].done]
        if not cand:
            return None
        i = max(cand, key=lambda j: self._slots[j].request_id)
        req = self._slots[i]
        for bid in req.blocks:
            self.blocks.release(bid)
        req.blocks = []
        # roll generated tokens into the prompt: re-prefill resumes exactly
        # (n_prompt keeps outputs and the max_tokens budget intact)
        req.prompt_tokens = req.prompt_tokens + req.out_tokens
        req.out_tokens = []
        req.chain_keys = None  # prompt changed: recompute on re-admit
        self._queue.appendleft(req)
        self._slots[i] = None
        self._tables[i] = 0
        self._dev_dirty = True
        self.blocks.stats["preemptions"] += 1
        return i

    def _window_arity(self, active: List[int]) -> int:
        """The decode-window length for these slots: min(K, longest
        remaining budget)."""
        rem = 1
        for i in active:
            req = self._slots[i]
            r = min(req.sampling.max_tokens - req.num_generated,
                    self.max_len - 1 - len(req.prompt_tokens)
                    - len(req.out_tokens))
            rem = max(rem, r)
        return max(1, min(self.K, rem))

    # -- internals ----------------------------------------------------------

    def _record_token(self, i: int, req: Request, tok: int):
        sp = req.sampling
        if sp.stop_token_id is not None and tok == sp.stop_token_id:
            req.done = True
            return
        req.out_tokens.append(tok)
        self._next_token[i] = tok
        if (req.num_generated >= sp.max_tokens
                or len(req.prompt_tokens) + len(req.out_tokens)
                >= self.max_len - 1):
            req.done = True

    def _refresh_device_mirrors(self):
        """Re-upload the tables/temps device mirrors iff a host-side slot
        mutation (admit/retire/preempt/table growth) dirtied them.  Dirty
        also invalidates the tok/cur pair: the slot set changed."""
        if self._dev_dirty or self._tables_d is None:
            self._tables_d = torch.tensor(self._tables, device=self.device)
            self._temps_d = torch.tensor(self._temp_vec(), device=self.device)
            self._dev = None
            self._dev_dirty = False

    def _temp_vec(self) -> np.ndarray:
        temps = np.ones(self.B, np.float32)
        for i in range(self.B):
            if self._slots[i] is not None:
                temps[i] = self._slots[i].sampling.temperature
        return temps


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n (>=1), capped."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)
