"""Port parity: the engine's serving options and dense-cache generation.

The same converted weights go through ``ray_tpu`` and ``ray_tpu_torch``
on the CPU (tiny config, fp32): the paged verify step, int8 quantization
and the int8 decode step through both of its paths, the sampler's masked
logits, dense ``generate`` with and without speculation, and
``LLMEngine`` with ``spec_tokens``, ``prefill_chunk`` and
``kv_cache_dtype="int8"`` against JAX's engine and the port's plain one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as jengine
from ray_tpu.models import generation as jgen
from ray_tpu.models import llama as jllama
from ray_tpu.models import paged_generation as jpaged
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.models import generation as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import paged_generation as tpaged
from ray_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

# fp32 logits through two layers, products summed in another order
ATOL = 1e-4
# int8 KV: the same codes and scales on both sides, but the new token's KV
# is quantized from fp32 values that differ in the last bits
INT8_ATOL = 1e-3
BS = 4  # block size


class _TickClock:
    """Deterministic bandit clock (``tests/test_llm.py``'s): every read
    advances one tick, so per-arm tokens/s is a pure function of the
    workload on both sides."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1
        return self.t


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.llama_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _to_torch(a):
    """A JAX array as a torch tensor (bf16 through its bit pattern)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _int8_pool_close(tpool, jpool):
    """Codes within one step and scales within one bf16 ulp: the KV that
    enters the quantizer differs from JAX's in its last fp32 bits, which
    moves a value across a rounding midpoint only rarely."""
    for name in ("k", "v"):
        d = np.abs(tpool[name].numpy().astype(np.int32)
                   - np.asarray(jpool[name]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (name, d.max())
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(_np(tpool[name]),
                                   np.asarray(jpool[name], np.float32),
                                   rtol=2 ** -7, atol=0)


def _pools_close(tpool, jpool):
    if "k_scale" in jpool:
        _int8_pool_close(tpool, jpool)
        return
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=ATOL)


# -- model ops ---------------------------------------------------------------


def test_paged_verify_step_matches_jax(models):
    """Two slots, five tokens each (pending + four drafts), over a pool
    of random KV; the second slot's writes cross a block boundary."""
    jcfg, tcfg, tree, params = models
    rng = np.random.default_rng(0)
    shape = (jcfg.num_layers, 10, BS, jcfg.num_kv_heads,
             jcfg.resolved_head_dim)
    kv = {n: rng.standard_normal(shape).astype(np.float32) * 0.1
          for n in ("k", "v")}
    tables = np.asarray([[1, 2, 3, 0, 0, 0], [4, 5, 6, 7, 0, 0]], np.int32)
    cur = np.asarray([3, 10], np.int32)
    toks = rng.integers(3, 250, size=(2, 5)).astype(np.int32)
    jlog, jpool = jax.jit(functools.partial(jpaged.paged_verify_step,
                                            cfg=jcfg))(
        tree, jnp.asarray(toks), jnp.asarray(cur), jnp.asarray(tables),
        {n: jnp.asarray(a) for n, a in kv.items()})
    tlog, tpool = tpaged.paged_verify_step(
        params, torch.from_numpy(toks), torch.from_numpy(cur),
        torch.from_numpy(tables),
        {n: torch.from_numpy(a.copy()) for n, a in kv.items()}, tcfg)
    assert tuple(tlog.shape) == (2, 5, tcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _pools_close(tpool, jpool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    """Codes and bf16 scales bit-equal to JAX's, in the fp32 of the tests
    and the bf16 of the 7B model (where a quotient can round to 128 and
    must saturate), an all-zero vector (the 1e-8 clamp) included."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 4, 128)).astype(np.float32) * 0.3
    x[5, 1] = 0.0
    x[6] *= 1e4
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jax.jit(jpaged._quantize_kv)(jx)
    tq, ts = tpaged._quantize_kv(_to_torch(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


def _int8_pool_from_jax(jcfg, tree):
    """An int8 pool written by JAX's own decode steps: one slot, blocks 1
    and 2, positions 0..5."""
    jpool = jpaged.init_kv_pool(jcfg, 12, BS, kv_dtype="int8")
    tables = jnp.asarray([[1, 2] + [0] * 6], jnp.int32)
    step = jax.jit(functools.partial(jpaged.paged_decode_step, cfg=jcfg))
    for pos, tok in enumerate([5, 17, 99, 42, 7, 11]):
        _, jpool = step(tree, jnp.asarray([tok], jnp.int32),
                        jnp.asarray([pos], jnp.int32), tables, jpool)
    return jpool


@pytest.mark.parametrize("path,MB", [("eager", 8), ("folded", 96)])
def test_int8_decode_step_matches_jax(models, path, MB):
    """One decode step over the same int8 pool on both sides: a table of
    8 blocks (32 tokens) dequantizes in the gather, one of 96 blocks (384
    = INT8_FOLD_MIN_CONTEXT) keeps the codes through the folded attend."""
    jcfg, tcfg, tree, params = models
    assert (MB * BS >= tpaged.INT8_FOLD_MIN_CONTEXT) == (path == "folded")
    assert tpaged.INT8_FOLD_MIN_CONTEXT == jpaged.INT8_FOLD_MIN_CONTEXT
    jpool = _int8_pool_from_jax(jcfg, tree)
    tpool = {n: _to_torch(a) for n, a in jpool.items()}
    tables = np.zeros((1, MB), np.int32)
    tables[0, :2] = [1, 2]
    args = (np.asarray([23], np.int32), np.asarray([6], np.int32), tables)
    jlog, jpool = jax.jit(functools.partial(jpaged.paged_decode_step,
                                            cfg=jcfg))(
        tree, *map(jnp.asarray, args), jpool)
    tlog, tpool = tpaged.paged_decode_step(
        params, *map(torch.from_numpy, args), tpool, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=INT8_ATOL)
    _int8_pool_close(tpool, jpool)


def test_int8_folded_matches_eager(models, monkeypatch):
    """The port's two int8 paths on one table agree within the
    reference's own 2e-2 (``tests/test_llm.py``)."""
    jcfg, tcfg, tree, params = models
    jpool = _int8_pool_from_jax(jcfg, tree)
    tables = torch.tensor([[1, 2] + [0] * 6], dtype=torch.int32)
    logits = {}
    for path, threshold in (("eager", 10 ** 9), ("folded", 1)):
        monkeypatch.setattr(tpaged, "INT8_FOLD_MIN_CONTEXT", threshold)
        pool = {n: _to_torch(a) for n, a in jpool.items()}
        logits[path], _ = tpaged.paged_decode_step(
            params, torch.tensor([23], dtype=torch.int32),
            torch.tensor([6], dtype=torch.int32), tables, pool, tcfg)
    np.testing.assert_allclose(logits["folded"].numpy(),
                               logits["eager"].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_int8_gather_prefix_is_bf16_like_jax(models):
    """An int8 prefix dequantizes to bf16 even for an fp32 model, bit for
    bit as JAX's."""
    jcfg, tcfg, tree, params = models
    jpool = _int8_pool_from_jax(jcfg, tree)
    ids = np.asarray([2, 1], np.int32)
    jk, jv = jpaged.gather_prefix(jpool, jnp.asarray(ids))
    tk, tv = tpaged.gather_prefix({n: _to_torch(a) for n, a in jpool.items()},
                                  torch.from_numpy(ids))
    for t, j in ((tk, jk), (tv, jv)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


def test_int8_pool_layout_and_bytes(models):
    jcfg, tcfg, tree, params = models
    pool = tpaged.init_kv_pool(tcfg, 5, BS, kv_dtype="int8", device="cpu")
    jpool = jpaged.init_kv_pool(jcfg, 5, BS, kv_dtype="int8")
    for name, t in pool.items():
        assert tuple(t.shape) == jpool[name].shape
        assert str(t.dtype).split(".")[-1] == str(jpool[name].dtype)
    dense = tpaged.init_kv_pool(tcfg, 5, BS, device="cpu")

    def nbytes(p):
        return sum(t.numel() * t.element_size() for t in p.values())

    hd = tcfg.resolved_head_dim  # fp32 model: 4 bytes per dense value
    assert nbytes(pool) / nbytes(dense) == (hd + 2) / (4 * hd)
    with pytest.raises(ValueError, match="kv_dtype"):
        tpaged.init_kv_pool(tcfg, 5, BS, kv_dtype="fp8", device="cpu")


def test_dense_prefill_and_decode_match_jax(models):
    """Ragged right-padded prompts through ``prefill``, then two
    ``decode_step``s: logits and the whole cache within fp32
    tolerance."""
    jcfg, tcfg, tree, params = models
    rng = np.random.default_rng(2)
    toks = rng.integers(3, 250, size=(3, 7)).astype(np.int32)
    lengths = np.asarray([7, 3, 5], np.int32)
    jcache = jgen.init_kv_cache(jcfg, 3, 16)
    tcache = tgen.init_kv_cache(tcfg, 3, 16, device="cpu")
    jlog, jcache = jax.jit(functools.partial(jgen.prefill, cfg=jcfg))(
        tree, jnp.asarray(toks), jnp.asarray(lengths), jcache)
    tlog, tcache = tgen.prefill(params, torch.from_numpy(toks),
                                torch.from_numpy(lengths), tcache, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    cur = lengths.copy()
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
        jlog, jcache = jax.jit(functools.partial(jgen.decode_step,
                                                 cfg=jcfg))(
            tree, jnp.asarray(tok), jnp.asarray(cur), jcache)
        tlog, tcache = tgen.decode_step(params, torch.from_numpy(tok),
                                        torch.from_numpy(cur), tcache, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL)
        cur = cur + 1
    _pools_close(tcache, jcache)


# -- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6)])
def test_masked_logits_match_jax(monkeypatch, top_k, top_p):
    """The logits ``sample_token`` draws from equal the ones JAX's
    ``sample_token`` hands to ``jax.random.categorical`` (captured), and
    every sampled token lies in the kept set."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 256)).astype(np.float32) * 3
    sp = tgen.SamplingParams(temperature=0.7, top_k=top_k, top_p=top_p)
    captured = []
    categorical = jax.random.categorical

    def capture(key, lg, *a, **kw):
        captured.append(np.asarray(lg))
        return categorical(key, lg, *a, **kw)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jgen.SamplingParams(temperature=0.7, top_k=top_k,
                                          top_p=top_p))
    masked = tgen.masked_logits(torch.from_numpy(logits), sp)
    np.testing.assert_array_equal(masked.numpy(), captured[0])
    kept = np.isfinite(captured[0])
    assert 0 < kept.sum() < kept.size
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tgen.sample_token(torch.from_numpy(logits), gen, sp).numpy()
        assert kept[np.arange(4), tok].all()


def test_greedy_sample_token_is_argmax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 256)).astype(np.float32)
    sp = tgen.SamplingParams(temperature=0.0)
    got = tgen.sample_token(torch.from_numpy(logits),
                            torch.Generator(), sp)
    want = jgen.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                             jgen.SamplingParams(temperature=0.0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- dense generate ----------------------------------------------------------


@pytest.mark.parametrize("speculative", [0, 3])
def test_generate_greedy_matches_jax(models, speculative):
    """Greedy dense ``generate``, plain and prompt-lookup speculative,
    token-exact against JAX's plain greedy ``generate``; a stop token
    taken from the output truncates both alike."""
    jcfg, tcfg, tree, params = models
    prompts = [[5, 9, 5, 9, 5, 9], [7, 1, 2, 8, 4], [3, 4, 3, 4, 3]]
    ref = jgen.generate(tree, jcfg, prompts,
                        jgen.SamplingParams(temperature=0.0, max_tokens=10))
    got = tgen.generate(params, tcfg, prompts,
                        tgen.SamplingParams(temperature=0.0, max_tokens=10),
                        speculative=speculative)
    assert got == ref
    stop = ref[0][len(ref[0]) // 2]
    ref_stop = jgen.generate(tree, jcfg, prompts, jgen.SamplingParams(
        temperature=0.0, max_tokens=10, stop_token_id=stop))
    got_stop = tgen.generate(params, tcfg, prompts, tgen.SamplingParams(
        temperature=0.0, max_tokens=10, stop_token_id=stop),
        speculative=speculative)
    assert got_stop == ref_stop


def test_generate_speculative_requires_greedy(models):
    jcfg, tcfg, tree, params = models
    with pytest.raises(ValueError, match="greedy"):
        tgen.generate(params, tcfg, [[1, 2, 3]],
                      tgen.SamplingParams(temperature=0.5, max_tokens=4),
                      speculative=2)


def test_generate_sampling_is_seeded_and_in_vocab(models):
    jcfg, tcfg, tree, params = models
    sp = tgen.SamplingParams(temperature=0.9, top_k=5, top_p=0.9,
                             max_tokens=4)
    runs = [tgen.generate(params, tcfg, [[1, 2, 3]], sp,
                          generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0][0]) == 4
    assert all(0 <= t < tcfg.vocab_size for t in runs[0][0])


# -- engine: speculative decoding --------------------------------------------


def _engines(models, prompts, max_tokens, **kw):
    """The same greedy workload through JAX's engine and the port's."""
    jcfg, tcfg, tree, params = models
    jeng = jengine.LLMEngine(jcfg, tree, **kw)
    teng = tengine.LLMEngine(tcfg, params, device="cpu", **kw)
    jout = jeng.generate(prompts, jgen.SamplingParams(
        temperature=0.0, max_tokens=max_tokens))
    tout = teng.generate(prompts, tgen.SamplingParams(
        temperature=0.0, max_tokens=max_tokens))
    jeng.blocks.assert_integrity()
    teng.blocks.assert_integrity()
    assert [o.token_ids for o in tout] == [o.token_ids for o in jout]
    assert all(o.error is None for o in tout)
    return jeng, teng, tout


def _plain(models, prompts, max_tokens, **kw):
    jcfg, tcfg, tree, params = models
    eng = tengine.LLMEngine(tcfg, params, device="cpu", **kw)
    return [o.token_ids for o in eng.generate(prompts, tgen.SamplingParams(
        temperature=0.0, max_tokens=max_tokens))]


def test_spec_engine_steady_loop_matches_jax(models):
    """The reference's steady-loop recipe (``tests/test_llm.py``): a plain
    run drives the model into its greedy loop, and the whole trajectory
    is the speculative run's prompt.  Tokens, ``spec_stats`` and the arm
    EMAs equal JAX's under the same tick clock; tokens equal the port's
    plain engine's; drafts accept and the bandit keeps the verify arm."""
    warm = _engines(models, [[5, 6, 7, 8]], 400, batch_slots=1,
                    max_len=512)[2]
    tail = [5, 6, 7, 8] + warm[0].token_ids
    kw = dict(batch_slots=1, max_len=1024, spec_tokens=4, decode_window=1)
    jcfg, tcfg, tree, params = models
    jeng = jengine.LLMEngine(jcfg, tree, arm_clock=_TickClock(), **kw)
    teng = tengine.LLMEngine(tcfg, params, device="cpu",
                             arm_clock=_TickClock(), **kw)
    jout = jeng.generate([tail], jgen.SamplingParams(temperature=0.0,
                                                     max_tokens=300))
    tout = teng.generate([tail], tgen.SamplingParams(temperature=0.0,
                                                     max_tokens=300))
    assert tout[0].token_ids == jout[0].token_ids
    assert len(tout[0].token_ids) == 300
    assert teng.spec_stats == jeng.spec_stats
    assert teng._arm_tps.keys() == jeng._arm_tps.keys()
    for key, tps in jeng._arm_tps.items():
        assert teng._arm_tps[key] == pytest.approx(tps)
    st = teng.spec_stats
    assert st["verify_steps"] >= 40 and st["backoffs"] == 0, st
    assert st["accepted"] >= 0.8 * st["proposed"], st
    assert teng.stats()["spec"] == st
    assert teng._arm_tps["verify"] > teng._arm_tps[("window", 1)]
    teng.blocks.assert_integrity()
    assert tout[0].token_ids == _plain(models, [tail], 300, batch_slots=1,
                                       max_len=1024)[0]


def test_spec_engine_ordinary_prompts_match_jax(models):
    """Repetitive prompts make the drafter fire; a non-repetitive one
    rides the verify pass with an empty proposal.  Tokens equal JAX's
    and the plain engine's, ``spec_stats`` equal JAX's."""
    prompts = [[5, 9, 5, 9, 5, 9], [7, 1, 2, 8, 4], [3, 4, 3, 4, 3, 4]]
    kw = dict(batch_slots=4, max_len=96, decode_window=1)
    jcfg, tcfg, tree, params = models
    jeng = jengine.LLMEngine(jcfg, tree, spec_tokens=4,
                             arm_clock=_TickClock(), **kw)
    teng = tengine.LLMEngine(tcfg, params, device="cpu", spec_tokens=4,
                             arm_clock=_TickClock(), **kw)
    sp = dict(temperature=0.0, max_tokens=24)
    jout = jeng.generate(prompts, jgen.SamplingParams(**sp))
    tout = teng.generate(prompts, tgen.SamplingParams(**sp))
    assert [o.token_ids for o in tout] == [o.token_ids for o in jout]
    assert [o.token_ids for o in tout] == _plain(models, prompts, 24, **kw)
    assert teng.spec_stats == jeng.spec_stats
    assert teng.spec_stats["verify_steps"] > 0
    assert teng.spec_stats["proposed"] > 0
    teng.blocks.assert_integrity()


def test_spec_engine_sampled_batch_falls_back(models):
    """A batch with a sampling (temp > 0) slot skips speculation and
    still finishes."""
    jcfg, tcfg, tree, params = models
    eng = tengine.LLMEngine(tcfg, params, batch_slots=2, max_len=64,
                            spec_tokens=4, device="cpu")
    outs = eng.generate([[5, 9, 5, 9, 5, 9]],
                        tgen.SamplingParams(temperature=0.8, max_tokens=6))
    assert len(outs[0].token_ids) == 6
    assert eng.spec_stats["verify_steps"] == 0


def test_spec_engine_preempts_like_jax(models):
    """Speculation grows tables G + 1 positions ahead: in a pool too small
    for every slot, verify steps preempt exactly as JAX's do."""
    prompts = [[5, 9, 5, 9, 5, 9, 5], [3, 4, 3, 4, 3, 4], [8, 2, 8, 2, 8]]
    jeng, teng, tout = _engines(
        models, prompts, 20, batch_slots=3, max_len=64, block_size=BS,
        num_blocks=12, spec_tokens=4, decode_window=1,
        arm_clock=_TickClock())
    assert teng.blocks.stats["preemptions"] >= 1
    assert teng.blocks.stats == {k: v for k, v in jeng.blocks.stats.items()
                                 if k in teng.blocks.stats}
    assert teng.spec_stats == jeng.spec_stats
    assert all(len(o.token_ids) == 20 for o in tout)


# -- engine: chunked prefill -------------------------------------------------


def test_chunked_prefill_matches_jax_and_unchunked(models):
    """A 70-token prompt prefills in block-aligned chunks of 32: tokens
    equal JAX's chunked engine's and the unchunked engine's, and the
    chunk count equals JAX's."""
    long = [(7 * k + 3) % 250 for k in range(70)]
    prompts = [long, [5, 9, 2]]
    kw = dict(batch_slots=2, max_len=128)
    jeng, teng, tout = _engines(models, prompts, 6, prefill_chunk=32, **kw)
    assert teng.prefill_stats == jeng.prefill_stats
    assert teng.prefill_stats["chunks"] > 0
    assert teng.stats()["prefill_chunks"] == teng.prefill_stats["chunks"]
    assert [o.token_ids for o in tout] == _plain(models, prompts, 6, **kw)


def test_chunked_prefill_interleaves_decode(models):
    """While a long prompt chunk-prefills, the admitted slot keeps
    decoding; every step's outputs and chunk count equal JAX's."""
    jcfg, tcfg, tree, params = models
    kw = dict(batch_slots=2, max_len=128, prefill_chunk=16, decode_window=1)
    engines = (jengine.LLMEngine(jcfg, tree, **kw),
               tengine.LLMEngine(tcfg, params, device="cpu", **kw))
    long = [(11 * k + 1) % 250 for k in range(90)]
    trace = []
    for eng, SP in zip(engines, (jgen.SamplingParams, tgen.SamplingParams)):
        eng.submit([5, 9, 2], SP(temperature=0.0, max_tokens=12))
        eng.step()  # admit the short request first
        eng.submit(long, SP(temperature=0.0, max_tokens=4))
        steps, progress = [], 0
        for _ in range(600):  # bounded: a stall fails the test
            if not eng.has_unfinished():
                break
            before = (len(eng._slots[0].out_tokens)
                      if eng._slots[0] is not None else None)
            outs = eng.step()
            steps.append(([(o.request_id, o.token_ids) for o in outs],
                          eng.prefill_stats["chunks"]))
            if (before is not None and eng._slots[0] is not None
                    and any(s is None for s in eng._slots)
                    and eng.prefill_stats["chunks"] > 0
                    and len(eng._slots[0].out_tokens) > before):
                progress += 1
        trace.append((steps, progress))
        eng.blocks.assert_integrity()
    assert trace[1] == trace[0]
    steps, progress = trace[1]
    assert steps[-1][1] >= 2 and progress > 0
    done = dict(x for s, _ in steps for x in s)
    assert [len(done[0]), len(done[1])] == [12, 4]


def test_chunked_prefill_pool_pressure_matches_jax(models):
    """The reference's pool-pressure case: a preempted request re-queues
    ahead of a chunk-prefilling prompt, the chunk pins yield, everything
    completes, token-exact against JAX with the same chunk, preemption
    and eviction counts."""
    prompts = [[(3 * k + 1) % 250 for k in range(40)],
               [(11 * k + 5) % 250 for k in range(75)]]
    jcfg, tcfg, tree, params = models
    kw = dict(batch_slots=2, max_len=128, num_blocks=9, prefill_chunk=16,
              decode_window=1)
    outs = []
    engines = (jengine.LLMEngine(jcfg, tree, **kw),
               tengine.LLMEngine(tcfg, params, device="cpu", **kw))
    for eng, SP in zip(engines, (jgen.SamplingParams, tgen.SamplingParams)):
        ids = [eng.submit(prompts[0], SP(temperature=0.0, max_tokens=30)),
               eng.submit(prompts[1], SP(temperature=0.0, max_tokens=8))]
        results = {}
        for _ in range(600):  # bounded: a livelock fails the test
            for out in eng.step():
                results[out.request_id] = out
            if not eng.has_unfinished():
                break
        else:
            raise AssertionError(f"engine did not finish: "
                                 f"{eng.prefill_stats}")
        outs.append([(results[i].token_ids, results[i].error) for i in ids])
        eng.blocks.assert_integrity()
    assert outs[1] == outs[0]
    assert all(err is None and toks for toks, err in outs[1])
    jeng, teng = engines
    assert teng.prefill_stats == jeng.prefill_stats
    for key, n in teng.blocks.stats.items():
        assert n == jeng.blocks.stats[key], key


def test_abort_releases_chunk_pins(models):
    jcfg, tcfg, tree, params = models
    eng = tengine.LLMEngine(tcfg, params, batch_slots=1, max_len=128,
                            prefill_chunk=16, device="cpu")
    rid = eng.submit(list(range(3, 63)), tgen.SamplingParams(
        temperature=0.0, max_tokens=4))
    eng.step()
    assert eng._queue[0].chunk_blocks
    assert eng.abort(rid) and not eng.has_unfinished()
    eng.blocks.assert_integrity()
    assert not eng.blocks.refs


# -- engine: int8 KV pool ----------------------------------------------------


def test_int8_engine_matches_jax(models):
    """The reference's int8 engine flow (two rounds, then a shared
    24-token system prefix served from quantized cached blocks): tokens
    equal JAX's int8 engine's, pools match, blocks balance."""
    system = list(range(3, 27))
    prompts = [[3, 4, 5, 6, 7], [9, 8], system + [50, 51],
               system + [60, 61, 62]]
    jeng, teng, tout = _engines(models, prompts, 6, batch_slots=2,
                                max_len=64, block_size=BS,
                                kv_cache_dtype="int8")
    assert teng.pool["k"].dtype == torch.int8
    assert teng.pool["k_scale"].dtype == torch.bfloat16
    assert teng.blocks.stats["prefix_hits"] >= 1
    assert teng.stats()["kv_cache_dtype"] == "int8"
    assert all(len(o.token_ids) == 6 for o in tout)
    _pools_close(teng.pool, jeng.pool)


def test_int8_engine_folded_path_matches_jax(models):
    """A table capacity of 384 tokens puts the engine's decode on the
    folded attend on both sides."""
    prompts = [[3, 4, 5, 6, 7], [9, 8, 7]]
    jeng, teng, tout = _engines(models, prompts, 8, batch_slots=2,
                                max_len=384, block_size=16,
                                kv_cache_dtype="int8")
    assert teng.MB * teng.bs >= tpaged.INT8_FOLD_MIN_CONTEXT
    _pools_close(teng.pool, jeng.pool)


# -- engine: construction ----------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    ({"spec_tokens": 2, "spec_ngram": 0}, "spec_ngram"),
    ({"spec_tokens": 2, "spec_lookup_window": 0}, "spec_lookup_window"),
    ({"prefill_chunk": 8, "block_size": 16}, "prefill_chunk"),
    ({"kv_cache_dtype": "fp8"}, "kv_dtype")])
def test_engine_option_validation_matches_jax(models, kwargs, match):
    jcfg, tcfg, tree, params = models
    with pytest.raises(ValueError, match=match) as want:
        jengine.LLMEngine(jcfg, tree, batch_slots=1, max_len=32, **kwargs)
    with pytest.raises(ValueError, match=match) as got:
        tengine.LLMEngine(tcfg, params, batch_slots=1, max_len=32,
                          device="cpu", **kwargs)
    assert str(got.value) == str(want.value)
