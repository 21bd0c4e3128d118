"""Port parity: the paged cache ops and ``LLMEngine`` on the CPU.

The same converted weights go through ``ray_tpu`` and ``ray_tpu_torch``:
prefill and decode logits and the KV pool within fp32 tolerance, greedy
engine output token-exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu.models import paged_generation as jpaged
from ray_tpu.models.generation import SamplingParams as JSamplingParams
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import paged_generation as tpaged
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generation import SamplingParams

torch.set_num_threads(1)

# fp32 logits through two layers, products summed in another order
ATOL = 1e-4
BS = 4  # block size


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.llama_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _pool_close(tpool, jpool):
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=ATOL)


def _prefill_both(models, jpool, tpool, suffix, cached_len, blocks,
                  hit_blocks, S):
    """One ``prefill_suffix`` call on each side with identical padding and
    scatter coordinates (the engine's ``_run_prefill`` recipe)."""
    jcfg, tcfg, tree, params = models
    pad = list(suffix) + [0] * (S - len(suffix))
    dst_b = np.zeros(S, np.int32)
    dst_o = np.zeros(S, np.int32)
    for j in range(len(suffix)):
        p = cached_len + j
        dst_b[j], dst_o[j] = blocks[p // BS], p % BS
    ids = np.asarray(hit_blocks, np.int32)
    jpk, jpv = jpaged.gather_prefix(jpool, jnp.asarray(ids))
    jlog, jpool = jax.jit(functools.partial(jpaged.prefill_suffix,
                                            cfg=jcfg))(
        tree, jnp.asarray([pad], jnp.int32), jnp.int32(len(suffix)),
        jnp.int32(cached_len), jpk, jpv, jnp.int32(cached_len),
        jnp.asarray(dst_b), jnp.asarray(dst_o), jpool)
    tpk, tpv = tpaged.gather_prefix(tpool, torch.from_numpy(ids))
    tlog, tpool = tpaged.prefill_suffix(
        params, torch.tensor([pad], dtype=torch.int32), len(suffix),
        cached_len, tpk, tpv, cached_len, torch.from_numpy(dst_b),
        torch.from_numpy(dst_o), tpool, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _pool_close(tpool, jpool)
    return jpool, tpool


def test_prefill_and_decode_match_jax(models):
    """Prefill without a prefix, prefill of a suffix behind a cached
    two-block prefix, then one batched decode step over both tables."""
    jcfg, tcfg, tree, params = models
    num_blocks = 12
    jpool = jpaged.init_kv_pool(jcfg, num_blocks, BS)
    tpool = tpaged.init_kv_pool(tcfg, num_blocks, BS, device="cpu")
    assert all(torch.count_nonzero(t) == 0 for t in tpool.values())
    rng = np.random.default_rng(0)
    a = rng.integers(3, 250, size=10).tolist()
    jpool, tpool = _prefill_both(models, jpool, tpool, a, 0, [1, 2, 3], [],
                                 16)
    b_sfx = rng.integers(3, 250, size=5).tolist()  # behind a's 8-token prefix
    jpool, tpool = _prefill_both(models, jpool, tpool, b_sfx, 8,
                                 [1, 2, 4, 5], [1, 2], 8)

    MB = 6
    tables = np.zeros((2, MB), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :4] = [1, 2, 4, 5]
    cur = np.asarray([10, 13], np.int32)
    tok = np.asarray([17, 99], np.int32)
    jlog, jpool = jax.jit(functools.partial(jpaged.paged_decode_step,
                                            cfg=jcfg))(
        tree, jnp.asarray(tok), jnp.asarray(cur), jnp.asarray(tables),
        jpool)
    tlog, tpool = tpaged.paged_decode_step(
        params, torch.from_numpy(tok), torch.from_numpy(cur),
        torch.from_numpy(tables), tpool, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    _pool_close(tpool, jpool)


def test_decode_sample_clamps_finished_slots(models):
    """A slot past its table capacity writes to the last position instead
    of indexing out of range (JAX clamps; torch would raise), and greedy
    sampling is the argmax."""
    jcfg, tcfg, tree, params = models
    tpool = tpaged.init_kv_pool(tcfg, 4, BS, device="cpu")
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    cur = torch.tensor([2 * BS + 3, 1], dtype=torch.int32)  # first overflows
    gen = torch.Generator().manual_seed(0)
    nxt, cur2, tpool = tpaged.paged_decode_sample(
        params, torch.tensor([5, 6], dtype=torch.int32), cur, tables,
        tpool, gen, torch.zeros(2), tcfg)
    assert cur2.tolist() == [2 * BS + 4, 2]
    logits, _ = tpaged.paged_decode_step(
        params, torch.tensor([5, 6], dtype=torch.int32),
        torch.tensor([2 * BS - 1, 1], dtype=torch.int32), tables,
        tpaged.init_kv_pool(tcfg, 4, BS, device="cpu"), tcfg)
    assert nxt.tolist() == logits.argmax(-1).tolist()


def _run_engines(models, prompts, max_tokens, **kw):
    jcfg, tcfg, tree, params = models
    jeng = jengine.LLMEngine(jcfg, tree, **kw)
    teng = tengine.LLMEngine(tcfg, params, device="cpu", **kw)
    jout = jeng.generate(prompts, JSamplingParams(temperature=0.0,
                                                  max_tokens=max_tokens))
    tout = teng.generate(prompts, SamplingParams(temperature=0.0,
                                                 max_tokens=max_tokens))
    jeng.blocks.assert_integrity()
    teng.blocks.assert_integrity()
    return jeng, teng, jout, tout


def test_engine_greedy_token_exact_with_prefix_and_preemption(models):
    """Two slots, a shared 12-token prefix (three blocks), and a pool of 8
    usable blocks that cannot hold every admitted request: prefix hits and
    recompute preemptions happen on both sides, and every request's
    greedy tokens are identical."""
    pre = list(range(3, 15))
    prompts = [pre + [20, 21], pre + [30], [40, 41, 42, 43, 44], [50, 51]]
    jeng, teng, jout, tout = _run_engines(
        models, prompts, 10, batch_slots=2, max_len=64, block_size=BS,
        num_blocks=9)
    assert [o.token_ids for o in tout] == [o.token_ids for o in jout]
    assert all(len(o.token_ids) == 10 and o.error is None for o in tout)
    stats = teng.blocks.stats
    assert stats["prefix_hits"] >= 1 and stats["preemptions"] >= 1
    for key in stats:
        assert stats[key] == jeng.blocks.stats[key], key


def test_engine_greedy_token_exact_roomy_pool(models):
    """Default pool, ragged prompts (one of a single token) and a decode
    window shorter than the budget."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 250, size=n).tolist() for n in (1, 7, 19)]
    jeng, teng, jout, tout = _run_engines(
        models, prompts, 12, batch_slots=2, max_len=64, block_size=BS,
        decode_window=5)
    assert [o.token_ids for o in tout] == [o.token_ids for o in jout]
    assert teng.stats()["timing"]["decode_tokens"] > 0


def test_engine_oversized_request_fails_alone(models):
    jcfg, tcfg, tree, params = models
    eng = tengine.LLMEngine(tcfg, params, batch_slots=2, max_len=64,
                            block_size=BS, num_blocks=5, device="cpu")
    outs = eng.generate([[3, 4, 5], list(range(3, 40))],
                        SamplingParams(temperature=0.0, max_tokens=8))
    assert outs[0].error is None and len(outs[0].token_ids) == 8
    assert outs[1].error and outs[1].token_ids == []
    eng.blocks.assert_integrity()


def test_engine_abort_and_stop_token(models):
    jcfg, tcfg, tree, params = models
    eng = tengine.LLMEngine(tcfg, params, batch_slots=1, max_len=64,
                            block_size=BS, decode_window=4, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=12)
    active = eng.submit([3, 4, 5, 6], sp)
    queued = eng.submit([7, 8, 9], sp)
    eng.step()
    assert eng.abort(queued) and eng.abort(active)
    assert not eng.abort(12345)
    eng.step()
    assert not eng.has_unfinished()
    eng.blocks.assert_integrity()
    # a stop token ends the request without being emitted
    ref = eng.generate([[3, 4, 5, 6]], sp)[0].token_ids
    stop = eng.generate([[3, 4, 5, 6]], SamplingParams(
        temperature=0.0, max_tokens=12, stop_token_id=ref[2]))[0].token_ids
    assert stop == ref[:ref.index(ref[2])]


def test_engine_sampling_is_seeded(models):
    """Temperature sampling draws from the engine's own generator: the
    same seed gives the same tokens (the streams differ from JAX's, so
    sampled tokens are not compared across packages)."""
    jcfg, tcfg, tree, params = models
    sp = SamplingParams(temperature=1.0, max_tokens=8)
    runs = [tengine.LLMEngine(tcfg, params, batch_slots=2, max_len=64,
                              block_size=BS, seed=s, device="cpu")
            .generate([[3, 4, 5], [6, 7]], sp) for s in (1, 1, 2)]
    toks = [[o.token_ids for o in r] for r in runs]
    assert toks[0] == toks[1]
    assert toks[0] != toks[2]


@pytest.mark.parametrize("kwargs", [{"mesh": object()}])
def test_unported_engine_options_raise(models, kwargs):
    """Every engine option is ported: ``mesh=`` serves over a
    ``DeviceMesh`` (held against JAX's engine in
    ``test_torch_mesh_serving.py``), and anything else given as the mesh
    is refused by the parallel layer's ``TypeError``, never
    ``NotImplementedError``."""
    jcfg, tcfg, tree, params = models
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        tengine.LLMEngine(tcfg, params, device="cpu", **kwargs)


@pytest.mark.parametrize("call", ["prefill_only", "export_kv",
                                  "adopt_prefilled"])
def test_unported_handoff_raises(models, call):
    """The hand-off calls that raised ``NotImplementedError`` before the
    disaggregated-serving slice now behave as the reference's: a
    prefill-only request retires after its first token with its blocks
    held for export, and an unknown export id or a handoff without KV
    raises the reference's ``KeyError``, never ``NotImplementedError``
    (the full hand-off is held against JAX in ``test_torch_disagg.py``)."""
    jcfg, tcfg, tree, params = models
    engines = (jengine.LLMEngine(jcfg, tree, batch_slots=1, max_len=32),
               tengine.LLMEngine(tcfg, params, batch_slots=1, max_len=32,
                                 device="cpu"))
    outcomes = []
    for eng, SP in zip(engines, (JSamplingParams, SamplingParams)):
        if call == "prefill_only":
            rid = eng.submit([3, 4], SP(temperature=0.0, max_tokens=8),
                             prefill_only=True)
            outs = [(o.request_id, len(o.token_ids)) for o in eng.step()]
            outcomes.append((outs, sorted(eng._exports),
                             eng.has_unfinished()))
            assert outs == [(rid, 1)] and rid in eng._exports
        else:
            with pytest.raises(KeyError) as err:
                if call == "export_kv":
                    eng.export_kv(0)
                else:
                    eng.adopt_prefilled({})
            outcomes.append(str(err.value))
    assert outcomes[1] == outcomes[0]


def test_tokenizer_copy_matches_reference():
    from ray_tpu.llm.bpe import BPETokenizer as JBPE
    from ray_tpu_torch.llm.bpe import BPETokenizer as TBPE

    text = "The port serves Llama-2-7B on an H100: héllo, wörld!\n\tdone."
    j, t = JBPE(), TBPE()
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == text
    assert (t.vocab_size, t.eos_id) == (j.vocab_size, j.eos_id)
    cfg = tllama.LlamaConfig.tiny()
    assert isinstance(tengine.default_tokenizer(cfg.vocab_size),
                      tengine.ByteTokenizer)
    assert isinstance(tengine.default_tokenizer(32000), TBPE)
