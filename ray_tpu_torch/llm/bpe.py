"""Byte-level BPE: in-repo trainer + tokenizer (no network, no downloads).

The port's own copy of ``ray_tpu/llm/bpe.py`` and its ``bpe_vocab.json``
(the port imports nothing of ``ray_tpu``); keep the two in step.

Reference capability: ``ray.llm`` gets its tokenizer from HF transformers
(``python/ray/llm/_internal/serve/deployments/llm/vllm/vllm_models.py:123``
model+tokenizer load).  A hermetic TPU-native stack needs a *real* subword
tokenizer without fetching one, so this module implements byte-level BPE
(the GPT-2/Llama construction) end-to-end:

* ``train_bpe(corpus, vocab_size)`` — classic pair-merge training over a
  byte corpus; deterministic, pure Python, fast enough for a few thousand
  merges (the committed vocab is produced by ``scripts/train_tokenizer.py``
  from the repo's own documentation).
* ``BPETokenizer`` — greedy merge-rank encoding with an LRU word cache,
  byte-fallback (every byte is a base token, so NOTHING is ever OOV) and
  exact detokenization.

The serialized artifact (``bpe_vocab.json``) stores merges as token-id
pairs; base tokens 0..255 are the raw bytes, then specials, then merged
symbols in training order — load never needs the corpus.
"""

from __future__ import annotations

import collections
import functools
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

_DEFAULT_VOCAB = os.path.join(os.path.dirname(__file__), "bpe_vocab.json")


def train_bpe(corpus: str, vocab_size: int = 4096,
              specials: Tuple[str, ...] = ("<pad>", "<bos>", "<eos>")
              ) -> Dict:
    """Train byte-level BPE; returns the serializable vocab dict.

    Words are whitespace-split chunks (each keeps one leading space as a
    marker byte, the GPT-2 trick, so detokenization is exact); merging
    never crosses word boundaries, which keeps training O(words) per merge
    using a pair-index instead of a full rescan.
    """
    words = collections.Counter()
    for i, w in enumerate(_pretokenize(corpus)):
        words[tuple(w)] += 1
    # live state: word -> (symbol tuple, count)
    vocab: List[bytes] = [bytes([b]) for b in range(256)]
    n_base = 256 + len(specials)
    merges: List[Tuple[int, int]] = []
    seqs: Dict[int, List[int]] = {}
    counts: List[int] = []
    for idx, (w, c) in enumerate(words.items()):
        seqs[idx] = list(w)
        counts.append(c)

    def pair_stats():
        stats: collections.Counter = collections.Counter()
        where: Dict[Tuple[int, int], set] = collections.defaultdict(set)
        for idx, s in seqs.items():
            c = counts[idx]
            for a, b in zip(s, s[1:]):
                stats[(a, b)] += c
                where[(a, b)].add(idx)
        return stats, where

    stats, where = pair_stats()
    while len(vocab) + len(specials) < vocab_size and stats:
        # deterministic: highest count, ties broken by token ids
        pair = max(stats.items(), key=lambda kv: (kv[1], -kv[0][0],
                                                  -kv[0][1]))[0]
        if stats[pair] < 2:
            break
        a, b = pair
        new_id = n_base + len(merges)
        merges.append(pair)
        vocab.append(_sym_bytes(vocab, specials, a)
                     + _sym_bytes(vocab, specials, b))
        # apply the merge only to words containing the pair
        for idx in list(where.get(pair, ())):
            s = seqs[idx]
            c = counts[idx]
            out: List[int] = []
            i = 0
            changed = False
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(new_id)
                    i += 2
                    changed = True
                else:
                    out.append(s[i])
                    i += 1
            if not changed:
                continue
            # decrement old pair stats for this word, increment new
            for p in zip(s, s[1:]):
                stats[p] -= c
                if stats[p] <= 0:
                    stats.pop(p, None)
                where.get(p, set()).discard(idx)
            for p in zip(out, out[1:]):
                stats[p] += c
                where[p].add(idx)
            seqs[idx] = out
    return {
        "specials": list(specials),
        "merges": [[a, b] for a, b in merges],
        "version": 1,
    }


def _sym_bytes(vocab: List[bytes], specials, sym: int) -> bytes:
    """Byte expansion of a symbol id in TRAINING id space (bytes, then
    specials, then merges)."""
    if sym < 256:
        return vocab[sym]
    if sym < 256 + len(specials):
        return b""  # specials never occur inside words
    return vocab[sym - len(specials)]


def _pretokenize(text: str) -> Iterable[bytes]:
    """Split into byte words; a leading space is folded into the following
    word so ``decode(encode(x)) == x`` with plain concatenation."""
    out: List[bytes] = []
    word = bytearray()
    for ch in text.encode("utf-8"):
        if ch in (32, 10, 9, 13):  # space-ish: flush, start new word with it
            if word:
                out.append(bytes(word))
            word = bytearray([ch])
        else:
            word.append(ch)
    if word:
        out.append(bytes(word))
    return out


class BPETokenizer:
    """Byte-level BPE encoder/decoder over a trained merge list.

    ID layout: ``0..255`` raw bytes, then specials, then merges — matching
    the trainer.  ``pad_id``/``bos_id``/``eos_id`` follow the engine's
    tokenizer protocol (see ``llm/engine.py``).
    """

    def __init__(self, vocab: Optional[Dict] = None,
                 path: Optional[str] = None):
        if vocab is None:
            with open(path or _DEFAULT_VOCAB) as f:
                vocab = json.load(f)
        self.specials: List[str] = list(vocab["specials"])
        self.merges: List[Tuple[int, int]] = [tuple(m)
                                              for m in vocab["merges"]]
        self._rank = {m: i for i, m in enumerate(self.merges)}
        n_sp = len(self.specials)
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.vocab_size = 256 + n_sp + len(self.merges)
        # byte expansion per id (for decode)
        self._bytes: List[bytes] = [bytes([b]) for b in range(256)]
        self._bytes += [b"" for _ in self.specials]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])

    # -- encode -------------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        for word in _pretokenize(text):
            ids.extend(self._encode_word(word))
        return ids

    @functools.lru_cache(maxsize=65536)
    def _encode_word(self, word: bytes) -> Tuple[int, ...]:
        syms = list(word)
        while len(syms) > 1:
            best_rank = None
            best_i = -1
            for i, p in enumerate(zip(syms, syms[1:])):
                r = self._rank.get(p)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            syms[best_i:best_i + 2] = [256 + len(self.specials) + best_rank]
        return tuple(syms)

    # -- decode -------------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        data = b"".join(self._bytes[i] for i in ids
                        if 0 <= i < len(self._bytes))
        return data.decode("utf-8", "replace")
