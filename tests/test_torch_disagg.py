"""Port parity: the disaggregated prefill/decode hand-off.

The same converted weights go through ``ray_tpu`` and ``ray_tpu_torch``
on the CPU (tiny config, fp32): a prefill-only request on a prefill
engine, ``export_kv``, and ``adopt_prefilled`` on a decode engine are
token-exact with JAX's colocated engine and with JAX's own hand-off (the
fp32 pool and the int8 pool, with and without ``prefill_chunk``), and
the export equals JAX's.  Beside them: ``_BlockManager.adopt``, the
engine's rejections and abandonment paths, and the data plane of
``llm/kv_transfer.py`` (``KVBlockShipper`` / ``KVLandingStrip``) on the
port's channel plane, the reference's five shipper cases and one
prefill engine -> channel -> decode engine run.
"""

import dataclasses
import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as jengine
from ray_tpu.models import generation as jgen
from ray_tpu.models import llama as jllama
from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    COPY_STATS, reset_copy_stats)
from ray_tpu_torch.experimental.channel.transport import (
    ENV_EMULATE_DEVICE, TIER_DEVICE, TIER_HOST, attach_edge_transport,
    local_endpoint_info)
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm.kv_transfer import (KVBlockShipper, KVLandingStrip,
                                           KVShipError,
                                           handoff_channel_bytes)
from ray_tpu_torch.models import generation as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

# the exported KV through two fp32 layers, products summed in another order
ATOL = 1e-4
# the reference's engine-handoff configuration (tests/test_llm_disagg.py)
ENGINE_KW = dict(batch_slots=4, max_len=128, block_size=8)
# a prefill engine's default chunk budget in the reference's serving layer
PREFILL_CHUNK = 4 * ENGINE_KW["block_size"]
NEW_TOKENS = 24
# pre: the prefill engine's options, dec: the decode engine's
VARIANTS = {
    "plain": ({}, {}),
    "chunked": ({"prefill_chunk": PREFILL_CHUNK}, {}),
    "int8": ({"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "int8"}),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.llama_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _prompts():
    """``test_export_adopt_parity_with_colocated``'s prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(3, 200, size=n).tolist() for n in (37, 11, 64)]


def _drain(eng):
    out = {}
    for _ in range(1000):  # bounded: a stall fails the test
        if not eng.has_unfinished():
            return out
        for o in eng.step():
            out[o.request_id] = o
    raise AssertionError(f"engine did not finish: {eng.stats()}")


def _handoff(pre, dec, prompts, sp, adopt=None):
    """Prefill-only requests on ``pre``, their exports, and their adoption
    by ``dec`` (through ``adopt`` when given: a channel in between)."""
    rids = [pre.submit(p, sp, prefill_only=True) for p in prompts]
    firsts = _drain(pre)
    exports = [pre.export_kv(r) for r in rids]
    pre.blocks.assert_integrity()
    dids = [(adopt or dec.adopt_prefilled)(h) for h in exports]
    assert all(d is not None for d in dids)
    outs = _drain(dec)
    dec.blocks.assert_integrity()
    return {"first": [firsts[r].token_ids for r in rids],
            "tokens": [outs[d].token_ids for d in dids],
            "texts": [outs[d].text for d in dids],
            "exports": exports,
            "pre_handoff": dict(pre.handoff_stats),
            "dec_handoff": dict(dec.handoff_stats),
            "dec_blocks": dict(dec.blocks.stats),
            "pre_chunks": pre.prefill_stats["chunks"]}


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX's colocated engine (fp32 and int8 pools) and JAX's own hand-off
    for every variant, computed once for the module."""
    jcfg, _, tree, _ = models
    prompts = _prompts()
    sp = jgen.SamplingParams(temperature=0.0, max_tokens=NEW_TOKENS)
    colocated = {
        dtype: [o.token_ids for o in jengine.LLMEngine(
            jcfg, tree, kv_cache_dtype=dtype, **ENGINE_KW).generate(
                prompts, sp)]
        for dtype in (None, "int8")}
    handoffs = {}
    for name, (pre_kw, dec_kw) in VARIANTS.items():
        pre = jengine.LLMEngine(jcfg, tree, **ENGINE_KW, **pre_kw)
        dec = jengine.LLMEngine(jcfg, tree, **ENGINE_KW, **dec_kw)
        run = _handoff(pre, dec, prompts, sp)
        for h in run["exports"]:
            h["kv"] = {k: np.asarray(v) for k, v in h["kv"].items()}
        handoffs[name] = run
    return colocated, handoffs


def _torch_engines(models, pre_kw=None, dec_kw=None, **kw):
    _, tcfg, _, params = models
    kw = {**ENGINE_KW, "device": "cpu", **kw}
    return (tengine.LLMEngine(tcfg, params, **kw, **(pre_kw or {})),
            tengine.LLMEngine(tcfg, params, **kw, **(dec_kw or {})))


def _sp(max_tokens=NEW_TOKENS):
    return tgen.SamplingParams(temperature=0.0, max_tokens=max_tokens)


def _export_close(got, want):
    """The first ``n_blocks`` of each exported tensor: fp32 KV within
    ATOL; int8 codes within one step (rarely off) and bf16 scales within
    one ulp, as the int8 pools of ``test_torch_serving_options.py``."""
    n = want["n_blocks"]
    for name, w in want["kv"].items():
        g = got["kv"][name][:, :n]
        w = w[:, :n]
        if g.dtype == torch.int8:
            d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (name, d.max())
        elif g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


# -- the engine against JAX --------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_handoff_matches_jax(models, jax_runs, variant):
    """prefill-only -> ``export_kv`` -> ``adopt_prefilled``: tokens equal
    JAX's colocated engine's and JAX's own hand-off's; the first tokens,
    ``n_blocks``, the bucketed width, the counters and the exported KV
    equal JAX's."""
    colocated, handoffs = jax_runs
    want = handoffs[variant]
    pre_kw, dec_kw = VARIANTS[variant]
    pre, dec = _torch_engines(models, pre_kw, dec_kw)
    got = _handoff(pre, dec, _prompts(), _sp())
    assert got["tokens"] == colocated[dec_kw.get("kv_cache_dtype")]
    assert got["tokens"] == want["tokens"]
    assert got["texts"] == want["texts"]
    # a prefill-only request emits exactly its first sampled token
    assert got["first"] == want["first"]
    assert all(len(f) == 1 for f in got["first"])
    assert got["pre_handoff"] == want["pre_handoff"] == {
        "exported": 3, "adopted": 0, "adopt_failures": 0}
    assert got["dec_handoff"] == want["dec_handoff"]
    assert got["dec_blocks"] == want["dec_blocks"]
    assert got["pre_chunks"] == want["pre_chunks"]
    assert (got["pre_chunks"] > 0) == ("prefill_chunk" in pre_kw)
    for g, w in zip(got["exports"], want["exports"]):
        assert set(g["kv"]) == set(w["kv"])
        assert g["n_blocks"] == w["n_blocks"]
        assert g["kv"]["k"].shape == w["kv"]["k"].shape  # [L, P, bs, ...]
        assert (g["prompt_tokens"], g["n_prompt"], g["out_tokens"],
                g["kv_cache_dtype"], g["block_size"]) == (
            w["prompt_tokens"], w["n_prompt"], w["out_tokens"],
            w["kv_cache_dtype"], w["block_size"])
        _export_close(g, w)
    st = dec.stats()
    assert st["handoff"] == got["dec_handoff"]
    assert (st["adopt_queued"], st["exports_held"]) == (0, 0)
    assert dec.timing["prefill_tokens"] == 0  # no re-prefill


def test_handoff_into_speculative_decode_engine(models, jax_runs):
    """Adopted requests decode through ``spec_tokens``: greedy tokens
    equal JAX's colocated engine's."""
    colocated, _ = jax_runs
    pre, dec = _torch_engines(models, dec_kw={"spec_tokens": 4})
    got = _handoff(pre, dec, _prompts(), _sp())
    assert got["tokens"] == colocated[None]


def test_shipped_blocks_never_alias_either_pool(models, jax_runs):
    """Rewrite the prefill pool after the export (more traffic) and the
    shipped tensors after the adopt: the export keeps its values and the
    decode side's tokens do not change."""
    colocated, _ = jax_runs
    prompt = _prompts()[0]
    pre, dec = _torch_engines(models)
    rid = pre.submit(prompt, _sp(), prefill_only=True)
    _drain(pre)
    handoff = pre.export_kv(rid)
    kept = {k: v.clone() for k, v in handoff["kv"].items()}
    rng = np.random.default_rng(1)
    pre.generate([rng.integers(3, 200, size=40).tolist() for _ in range(4)],
                 _sp(30))
    for name, t in handoff["kv"].items():
        assert torch.equal(t, kept[name]), name
    did = dec.adopt_prefilled(handoff)
    for t in handoff["kv"].values():
        t.zero_()
    assert _drain(dec)[did].token_ids == colocated[None][0]


def test_adopt_pool_pressure_returns_none(models):
    pre, dec = _torch_engines(models, dec_kw={"num_blocks": 5},
                              batch_slots=2)
    rid = pre.submit(list(range(3, 70)), _sp(8), prefill_only=True)
    _drain(pre)
    h = pre.export_kv(rid)  # needs 9 blocks; 4 are usable
    assert h["n_blocks"] == 9
    assert dec.adopt_prefilled(h) is None
    assert dec.handoff_stats["adopt_failures"] == 1
    assert dec.blocks.stats["adopted_blocks"] == 0
    dec.blocks.assert_integrity()
    assert not dec.blocks.by_key  # nothing left published
    assert not dec.has_unfinished()


@pytest.mark.parametrize("case", ["kv_cache_dtype", "pool_dtype",
                                  "table"])
def test_adopt_rejects_incompatible_handoff(models, case):
    """A handoff this engine cannot take raises ``ValueError`` before any
    block is allocated (``assert_integrity`` holds, nothing queued): an
    int8 engine given an fp32-pool export, a bf16 pool given fp32 KV, and
    a decode table smaller than the shipped sequence."""
    _, tcfg, _, params = models
    pre = tengine.LLMEngine(tcfg, params, device="cpu",
                            **{**ENGINE_KW, "max_len": 256})
    rid = pre.submit(list(range(3, 123)), _sp(4), prefill_only=True)
    _drain(pre)
    h = pre.export_kv(rid)
    cfg, kw, match = {
        "kv_cache_dtype": (tcfg, {"kv_cache_dtype": "int8"},
                           "kv_cache_dtype"),
        "pool_dtype": (dataclasses.replace(tcfg, dtype=torch.bfloat16),
                       {"max_len": 256}, "layout"),
        "table": (tcfg, {"max_len": 64}, "exceeds"),
    }[case]
    dec = tengine.LLMEngine(cfg, params, device="cpu",
                            **{**ENGINE_KW, **kw})
    with pytest.raises(ValueError, match=match):
        dec.adopt_prefilled(h)
    dec.blocks.assert_integrity()
    assert not dec.blocks.refs and not dec.has_unfinished()
    assert dec.handoff_stats == {"exported": 0, "adopted": 0,
                                 "adopt_failures": 0}


def test_adopted_prefix_serves_local_prefix_hits(models):
    """Grafted chain keys make the SHIPPED prefix hit for later local
    prompts: the prefix cache composes across the handoff."""
    pre, dec = _torch_engines(models)
    rng = np.random.default_rng(3)
    base = rng.integers(3, 200, size=32).tolist()
    rid = pre.submit(base, _sp(8), prefill_only=True)
    _drain(pre)
    assert dec.adopt_prefilled(pre.export_kv(rid)) is not None
    _drain(dec)
    assert dec.blocks.stats["prefix_hits"] == 0
    dec.generate([base[:24] + rng.integers(3, 200, size=8).tolist()],
                 _sp(8))
    assert dec.blocks.stats["prefix_hits"] == 1
    assert dec.blocks.stats["prefix_blocks_reused"] >= 2
    dec.blocks.assert_integrity()


def test_abort_releases_export_and_adopt_queue(models):
    pre, dec = _torch_engines(models)
    rid = pre.submit(list(range(3, 40)), _sp(8), prefill_only=True)
    _drain(pre)
    assert rid in pre._exports and pre.stats()["exports_held"] == 1
    assert pre.abort(rid) is True  # abandoned before the ship
    pre.blocks.assert_integrity()
    assert pre._exports == {} and not pre.blocks.refs

    rid2 = pre.submit(list(range(3, 40)), _sp(8), prefill_only=True)
    _drain(pre)
    did = dec.adopt_prefilled(pre.export_kv(rid2))
    assert dec.has_unfinished() and dec.stats()["adopt_queued"] == 1
    assert dec.abort(did) is True  # abandoned before a slot opened
    dec.blocks.assert_integrity()
    assert not dec.has_unfinished() and not dec.blocks.refs


def test_adopt_while_decoding(models, jax_runs):
    """A handoff adopted while the decode engine is mid-decode on a local
    request takes a free slot at the next step (its table and first token
    reach the device mirrors): both requests' tokens equal JAX's
    colocated engine's."""
    colocated, _ = jax_runs
    prompts = _prompts()
    # one-step windows: no slot grows its table at the adopting step, so
    # only the placement itself can refresh the mirrors
    pre, dec = _torch_engines(models, dec_kw={"decode_window": 1})
    local = dec.submit(prompts[1], _sp())
    out = {o.request_id: o for o in dec.step()}
    assert not out and dec._slots[0].out_tokens  # decoding
    rid = pre.submit(prompts[0], _sp(), prefill_only=True)
    _drain(pre)
    did = dec.adopt_prefilled(pre.export_kv(rid))
    out.update(_drain(dec))
    assert out[local].token_ids == colocated[None][1]
    assert out[did].token_ids == colocated[None][0]
    dec.blocks.assert_integrity()


def test_adopt_finish_conditions_on_decode_side(models):
    """A handoff whose first token already spends ``max_tokens`` retires
    on its first decode step with just that token."""
    pre, dec = _torch_engines(models)
    rid = pre.submit(list(range(3, 20)), _sp(1), prefill_only=True)
    first = _drain(pre)[rid].token_ids
    did = dec.adopt_prefilled(pre.export_kv(rid))
    assert _drain(dec)[did].token_ids == first
    dec.blocks.assert_integrity()


# -- _BlockManager.adopt (the reference's TestBlockManagerAdopt) -------------


def test_block_manager_adopt_registers_keys_and_integrity():
    bm = tengine._BlockManager(8)
    bids = bm.adopt(["k0", "k1", None])
    assert bids is not None and len(bids) == 3
    assert bm.stats["adopted_blocks"] == 3
    bm.assert_integrity()
    # registered keys serve future prefix hits
    assert bm.acquire_cached("k0") == bids[0]
    bm.release(bids[0])  # the extra acquire
    for b in bids:
        bm.release(b)
    bm.assert_integrity()
    # registered blocks retired into the LRU, the unkeyed one freed
    assert set(bm.lru.values()) == {bids[0], bids[1]}


def test_block_manager_adopt_all_or_nothing_under_pressure():
    bm = tengine._BlockManager(4)  # 3 usable blocks
    held = [bm.alloc(), bm.alloc()]
    assert bm.adopt(["a", "b"]) is None  # needs 2, only 1 left
    bm.assert_integrity()
    assert bm.available() == 1  # the failed adopt leaked nothing
    # the rollback UNPUBLISHED its keys: a later lookup must miss
    assert bm.acquire_cached("a") is None
    assert bm.acquire_cached("b") is None
    for b in held:
        bm.release(b)
    assert bm.adopt(["a", "b"]) is not None
    bm.assert_integrity()


def test_block_manager_adopt_duplicate_key_keeps_local_registration():
    bm = tengine._BlockManager(8)
    local = bm.alloc()
    bm.register(local, "shared")
    bids = bm.adopt(["shared"])
    assert bids is not None
    # the local publication wins; the adopted copy stays unpublished
    assert bm.by_key["shared"] == local
    bm.release(local)
    for b in bids:
        bm.release(b)
    bm.assert_integrity()


# -- the data plane (the reference's TestShipperRoundTrip) -------------------


def _fake_handoff(hid, seed=0, blocks=3, dtype=None):
    rng = np.random.default_rng(seed)
    shape = (2, blocks, 4, 2, 8)  # [L, n, bs, KVH, hd]
    kv = {"k": torch.from_numpy(rng.standard_normal(shape, np.float32)),
          "v": torch.from_numpy(rng.standard_normal(shape, np.float32))}
    return {"handoff_id": hid, "prompt_tokens": list(range(3, 14)),
            "n_prompt": 11, "out_tokens": [7], "sampling": None,
            "kv_cache_dtype": dtype, "block_size": 4, "kv": kv}


def _pair(monkeypatch, emulate=True, channel_bytes=1 << 20, adopt=None):
    """A shipper + landing strip wired through one real shm channel, with
    the peer probed as another pid so negotiation runs the cross-process
    matrix; frames land on the CPU."""
    if emulate:
        monkeypatch.setenv(ENV_EMULATE_DEVICE, "1")
    else:
        monkeypatch.delenv(ENV_EMULATE_DEVICE, raising=False)
    landed = []
    lock = threading.Lock()

    def keep(h):
        with lock:
            landed.append(h)
        return True

    strip = KVLandingStrip(adopt or keep, poll_s=0.05)
    ship = KVBlockShipper("p0", channel_bytes=channel_bytes,
                          ship_timeout_s=10.0)
    peer = dataclasses.replace(local_endpoint_info(), pid=999999)
    readers = []

    def register(tr):
        readers.append(attach_edge_transport(tr, 0, device="cpu"))
        strip.attach(readers[-1], "p0")

    ship.connect("d0", peer, register)
    return ship, strip, landed, lock, readers[0]


def _wait_landed(landed, lock, n):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with lock:
            if len(landed) >= n:
                return list(landed)
        time.sleep(0.01)
    raise AssertionError(f"{len(landed)} of {n} handoffs landed")


def _close(ship, strip, reader):
    strip.stop()
    reader.channel.detach()
    ship.close()


def test_tier_b_round_trip_one_copy_into_segment(monkeypatch):
    ship, strip, landed, lock, rd = _pair(monkeypatch, emulate=True)
    try:
        assert ship.tier_of("d0") == TIER_DEVICE
        reset_copy_stats()
        src = _fake_handoff("h1", seed=1)
        res = ship.ship("d0", src, timeout=10)
        assert res["tier"] == TIER_DEVICE and res["bytes"] > 0
        got = _wait_landed(landed, lock, 1)[0]
        # the block bytes move into the segment exactly once
        ratio = COPY_STATS["bytes_copied"] / max(
            1, COPY_STATS["payload_bytes"])
        assert ratio < 1.05, COPY_STATS
        assert got["handoff_id"] == "h1"
        assert got["prompt_tokens"] == src["prompt_tokens"]
        assert torch.equal(got["kv"]["k"], src["kv"]["k"])
        # the landed tensors own their memory: a SECOND ship reusing the
        # segment must not change the first landing
        before = got["kv"]["k"].clone()
        ship.ship("d0", _fake_handoff("h2", seed=2), timeout=10)
        _wait_landed(landed, lock, 2)
        assert torch.equal(got["kv"]["k"], before)
        assert ship.stats()["d0"]["device_frames"] == 2
        assert ship.stats()["d0"]["degraded"] == rd.stats["degraded"] == 0
    finally:
        _close(ship, strip, rd)


def test_tier_c_without_emulation_still_delivers(monkeypatch):
    ship, strip, landed, lock, rd = _pair(monkeypatch, emulate=False)
    try:
        assert ship.tier_of("d0") == TIER_HOST
        ship.ship("d0", _fake_handoff("h1"), timeout=10)
        assert _wait_landed(landed, lock, 1)[0]["handoff_id"] == "h1"
    finally:
        _close(ship, strip, rd)


def test_dead_peer_raises_and_retires_channel(monkeypatch):
    ship, strip, landed, lock, rd = _pair(monkeypatch, emulate=True,
                                          channel_bytes=1 << 16)
    strip.stop()  # reader gone: the first write fills the segment,
    ship.ship("d0", _fake_handoff("h1", blocks=1), timeout=5)
    try:  # the second can never be acked within the deadline
        with pytest.raises(KVShipError):
            ship.ship("d0", _fake_handoff("h2", blocks=1), timeout=0.3)
        assert ship.tier_of("d0") is None  # peer retired
        with pytest.raises(KVShipError):
            ship.ship("d0", _fake_handoff("h3", blocks=1), timeout=0.3)
    finally:
        _close(ship, strip, rd)


def test_kv_ship_fault_site_fires(monkeypatch):
    from ray_tpu_torch.util import fault_injection as fi

    ship, strip, landed, lock, rd = _pair(monkeypatch, emulate=True)
    try:
        with fi.armed("llm.kv_ship", nth=1, exc=ConnectionError("chaos")):
            with pytest.raises(ConnectionError, match="chaos"):
                ship.ship("d0", _fake_handoff("h1"), timeout=5)
            assert fi.fired_count("llm.kv_ship") == 1
        # disarmed: the channel was never touched and still delivers
        ship.ship("d0", _fake_handoff("h2"), timeout=10)
        assert _wait_landed(landed, lock, 1)[0]["handoff_id"] == "h2"
    finally:
        _close(ship, strip, rd)


def test_oversized_handoff_fails_without_desync(monkeypatch):
    ship, strip, landed, lock, rd = _pair(monkeypatch, emulate=True,
                                          channel_bytes=1 << 12)
    try:
        with pytest.raises(ValueError):
            ship.ship("d0", _fake_handoff("big", blocks=8), timeout=5)
        # the channel survives an oversize rejection: a fitting handoff
        # still lands
        ship.ship("d0", _fake_handoff("h1", blocks=1), timeout=10)
        assert _wait_landed(landed, lock, 1)[0]["handoff_id"] == "h1"
    finally:
        _close(ship, strip, rd)


# -- end to end: prefill engine -> channel -> decode engine ------------------


def test_engines_over_channel_match_jax_colocated(models, jax_runs,
                                                  monkeypatch):
    """Exports ship over a tier-B edge (CPU emulation) sized by
    ``handoff_channel_bytes``; the landing thread only queues each
    handoff (the engine is not thread-safe) and this thread adopts it.
    Tokens equal JAX's colocated engine's; every landed tensor equals its
    export bit for bit; no frame degrades and nothing re-prefills."""
    colocated, _ = jax_runs
    pre, dec = _torch_engines(models, {"prefill_chunk": PREFILL_CHUNK})
    inbox = queue.Queue()
    ship, strip, _, _, rd = _pair(
        monkeypatch, emulate=True, channel_bytes=handoff_channel_bytes(pre),
        adopt=lambda h: inbox.put(h) is None)
    exports = []

    def over_channel(h):
        exports.append(h)
        assert ship.ship("d0", h, timeout=10)["tier"] == TIER_DEVICE
        landed = inbox.get(timeout=10)
        for name, t in h["kv"].items():
            assert torch.equal(landed["kv"][name], t), name
        return dec.adopt_prefilled(landed)

    try:
        got = _handoff(pre, dec, _prompts(), _sp(), adopt=over_channel)
        stats = ship.stats()["d0"]
    finally:
        _close(ship, strip, rd)
    assert got["tokens"] == colocated[None]
    assert stats["device_frames"] == 3 and stats["degraded"] == 0
    assert rd.stats["degraded"] == 0 and rd.stats["recvs"] == 3
    assert strip.stats()["landed"] == 3
    assert dec.timing["prefill_tokens"] == 0
    assert handoff_channel_bytes(pre) == (pre.MB + 1) * 2 * 2 * 8 * 2 * 16 \
        * 4 + (1 << 20)
