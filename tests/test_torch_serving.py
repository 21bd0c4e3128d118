"""Port parity: the LLM serving front (``ray_tpu_torch/llm/serving.py``,
``llm/batch.py``) against ``ray_tpu.llm`` on the same tiny weights.

The JAX weights are carried over by ``models/convert.py``; the port runs
with ``device="cpu"``.  Both sides' servers are used in-process through
``LLMServer._target`` (the undecorated class), as the reference's own
tests do (``tests/test_llm.py:333-386``, ``:740-800``,
``tests/test_llm_disagg.py:809-850``): texts and token counts must be
equal exactly, sequentially and from six threads, unary and streamed;
then the engine loop's coalescing and settle bound, deadlines and
abandonment, the decode server's fallbacks and fault site, a prefill and
a decode server joined by one channel edge, and batch inference.  JAX's
side is computed once, in a module fixture.
"""

import concurrent.futures
import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import batch as jbatch
from ray_tpu.llm import engine as jengine
from ray_tpu.llm import serving as jserving
from ray_tpu.models import llama as jllama
from ray_tpu.models.generation import SamplingParams as JSamplingParams
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import DeadlineExceededError
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import serving as tserving
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generation import SamplingParams
from ray_tpu_torch.util import fault_injection as fi

torch.set_num_threads(1)

# the reference's concurrent-server configuration (tests/test_llm.py:370)
ENGINE_KW = dict(batch_slots=4, max_len=64)
PROMPTS = [f"p{i}" for i in range(6)]
NEW_TOKENS = 6


def _body(prompt, max_tokens=NEW_TOKENS):
    return {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0}


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.llama_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _port_kw(models, **kw):
    _, tcfg, _, tparams = models
    return {"cfg": tcfg, "params": tparams, "device": "cpu", **ENGINE_KW,
            **kw}


def _threaded(srv, prompts):
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        return list(pool.map(lambda p: srv(_body(p)), prompts))


@pytest.fixture(scope="module")
def jax_side(models):
    """JAX's server answers (sequential, from six threads, streamed), its
    engine's hooks on a fixed schedule, and its predictor's batch."""
    jcfg, _, tree, _ = models
    srv = jserving.LLMServer._target(
        {"params": tree, "cfg": jcfg, **ENGINE_KW})
    try:
        out = {"sequential": [srv(_body(p)) for p in PROMPTS],
               "threaded": _threaded(srv, PROMPTS),
               "stream": list(srv.stream(_body(PROMPTS[0])))}
    finally:
        srv._stop = True
    eng = jengine.LLMEngine(jcfg, tree, batch_slots=2, max_len=64)
    out["hooks"] = _hook_schedule(eng, JSamplingParams)
    pred = jbatch.LLMPredictor(
        {"cfg": jcfg, "params": tree, **ENGINE_KW},
        sampling={"temperature": 0.0, "max_tokens": NEW_TOKENS})
    out["predictor"] = list(pred(_batch())["generated"])
    return out


def _batch():
    return {"prompt": np.array(PROMPTS[:4], dtype=object)}


def _hook_schedule(eng, sampling_cls):
    """Three requests into two slots: the slot and queue counts before
    and after each step, and every ``on_token`` call in order."""
    seen = []
    eng.on_token = lambda rid, tok: seen.append((rid, int(tok)))
    sp = sampling_cls(temperature=0.0, max_tokens=4,
                      stop_token_id=eng.tokenizer.eos_id)
    for p in ([5, 6, 7], [9, 8], [3, 4, 5, 6]):
        eng.submit(p, sp)
    counts = [(eng.free_slot_count(), eng.queued_count())]
    while eng.has_unfinished():
        eng.step()
        counts.append((eng.free_slot_count(), eng.queued_count()))
    return {"counts": counts, "tokens": seen}


@pytest.fixture(scope="module")
def port_server(models):
    srv = tserving.LLMServer._target(_port_kw(models))
    yield srv
    srv._stop = True


# ---------------------------------------------------------------------------
# the engine's members the servers read
# ---------------------------------------------------------------------------

def test_engine_counts_and_on_token_match_jax(models, jax_side):
    _, tcfg, _, tparams = models
    eng = tengine.LLMEngine(tcfg, tparams, batch_slots=2, max_len=64,
                            device="cpu")
    port = _hook_schedule(eng, SamplingParams)
    assert port == jax_side["hooks"]
    assert port["counts"][0] == (2, 3) and port["counts"][-1] == (2, 0)
    assert len(port["tokens"]) == 12


def test_build_engine_by_name_and_refusals(models):
    eng = tserving._build_engine({"model": "tiny", "device": "cpu",
                                  "batch_slots": 2}, 1)
    assert eng.cfg == tllama.LlamaConfig.tiny() and eng.B == 2
    assert eng.device == torch.device("cpu")
    # a replica is one process on one card: a tp replica waits for a gang
    with pytest.raises(NotImplementedError, match="gang of processes"):
        tserving._build_engine({"model": "tiny", "device": "cpu"}, 2)
    if not torch.cuda.is_available():
        # no device means the card, never a silent CPU engine
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserving._build_engine({"model": "tiny"}, 1)


# ---------------------------------------------------------------------------
# LLMServer: unary, threads, streaming
# ---------------------------------------------------------------------------

def test_server_sequential_matches_jax(port_server, jax_side):
    got = [port_server(_body(p)) for p in PROMPTS]
    assert got == jax_side["sequential"]
    assert all(r["num_generated_tokens"] == NEW_TOKENS for r in got)
    # the replica's per-request records: first token before the last
    recs = port_server.stats()["requests"][-len(PROMPTS):]
    assert [r["tokens"] for r in recs] == [NEW_TOKENS] * len(PROMPTS)
    assert all(0 < r["ttft_s"] <= r["e2e_s"] for r in recs)


def test_server_threads_match_jax(port_server, jax_side):
    got = _threaded(port_server, PROMPTS)
    assert got == jax_side["threaded"] == jax_side["sequential"]


def test_stream_matches_unary_and_jax(port_server, jax_side):
    chunks = list(port_server.stream(_body(PROMPTS[0])))
    assert chunks == jax_side["stream"]
    assert [c["index"] for c in chunks[:-1]] == list(range(len(chunks) - 1))
    done = chunks[-1]
    assert done["done"]
    assert "".join(c["text"] for c in chunks[:-1]) \
        == done["generated_text"] == jax_side["sequential"][0][
            "generated_text"]


# ---------------------------------------------------------------------------
# the engine loop (tests/test_llm.py:740-800)
# ---------------------------------------------------------------------------

def test_server_coalesces_concurrent_requests():
    """Concurrent requests coalesce into shared decode batches instead of
    the first arrival burning whole windows alone: 8 greedy requests
    submitted together finish in far fewer engine steps than 8 lone
    runs."""
    srv = tserving.LLMServer._target(
        {"model": "tiny", "batch_slots": 8, "max_len": 128, "device": "cpu"})
    try:
        body = {"prompt": "hello world test", "max_tokens": 24,
                "temperature": 0.0}
        counter = {"n": 0}
        orig_step = srv.engine.step

        def counted_step():
            counter["n"] += 1
            return orig_step()

        srv.engine.step = counted_step
        srv(body)
        lone = counter["n"]
        counter["n"] = 0
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            rs = list(pool.map(lambda _: srv(body), range(8)))
        assert all(r["num_generated_tokens"] == 24 for r in rs)
        assert counter["n"] < 4 * lone, (lone, counter["n"])
    finally:
        srv._stop = True


def test_server_settle_deferral_bounded():
    """A steady sub-settle trickle of submits must not starve running
    decodes: the loop forces a step once 2x ADMISSION_SETTLE_S passes
    without one."""
    srv = tserving.LLMServer._target(
        {"model": "tiny", "batch_slots": 8, "max_len": 128, "device": "cpu"})
    try:
        srv.ADMISSION_SETTLE_S = 0.05  # the trickle (every 10 ms) is under it
        stop = threading.Event()

        def trickle():
            while not stop.is_set():
                with srv._lock:
                    srv._last_submit = time.monotonic()
                time.sleep(0.01)

        t = threading.Thread(target=trickle, daemon=True)
        t.start()
        try:
            # no stop token: the port's tiny weights (drawn from another
            # random stream than JAX's) sample eos first on this prompt,
            # and the check needs all 8 decode steps to run
            sp = SamplingParams(temperature=0.0, max_tokens=8,
                                stop_token_id=None)
            slot = {"event": threading.Event(), "output": None}
            with srv._lock:
                rid = srv.engine.submit("hello world", sp)
                srv._waiters[rid] = slot
                srv._last_submit = time.monotonic()
            assert slot["event"].wait(timeout=60), \
                "a sub-settle submit trickle starved the decode loop"
            assert len(slot["output"].token_ids) == 8
        finally:
            stop.set()
            t.join(timeout=5)
    finally:
        srv._stop = True


# ---------------------------------------------------------------------------
# deadlines and abandonment
# ---------------------------------------------------------------------------

def _settled(srv, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with srv._lock:
            idle = (srv.engine.free_slot_count() == srv.engine.B
                    and srv.engine.queued_count() == 0
                    and not srv.engine.has_unfinished())
        if idle:
            return True
        time.sleep(0.01)
    return False


def test_born_expired_request_raises_and_frees(port_server):
    with serve.request_scope(timeout_s=0.0):
        with pytest.raises(DeadlineExceededError):
            port_server(_body(PROMPTS[0]))
    assert _settled(port_server)
    assert port_server._waiters == {}


def test_abandoned_stream_gives_back_its_slot(port_server, jax_side):
    stream = port_server.stream(_body(PROMPTS[1], max_tokens=40))
    first = next(stream)
    assert first["index"] == 0
    stream.close()  # the consumer walks away: GeneratorExit at the yield
    assert _settled(port_server)
    assert port_server._token_queues == {} and port_server._waiters == {}
    # the server still answers, unchanged
    assert port_server(_body(PROMPTS[2])) == jax_side["sequential"][2]


# ---------------------------------------------------------------------------
# the decode server's fallbacks (tests/test_llm_disagg.py:809-850)
# ---------------------------------------------------------------------------

@pytest.fixture
def decode_server(models):
    srv = tserving.LLMDecodeServer._target(_port_kw(models))
    yield srv
    srv.__del__()


def test_missing_handoff_falls_back_to_local_prefill(decode_server,
                                                     jax_side):
    srv = decode_server
    srv.HANDOFF_WAIT_S = 0.2
    body = _body(PROMPTS[3])
    out = srv.decode({"handoff_id": "never-shipped"}, body)
    assert out == jax_side["sequential"][3]
    assert srv._fallback_reprefills == 1
    assert srv.decode({"handoff_id": None}, body) == out
    chunks = list(srv.decode_stream({"handoff_id": None}, body))
    assert chunks[-1]["done"]
    assert chunks[-1]["generated_text"] == out["generated_text"]
    assert srv._fallback_reprefills == 3
    # a late landing of the abandoned id is dropped, not adopted
    assert srv._abandoned.keys() == {"never-shipped"}


def test_handoff_fault_site_delay_forces_fallback(decode_server, jax_side):
    srv = decode_server
    srv.HANDOFF_WAIT_S = 0.1
    with fi.armed("llm.handoff", nth=1, exc="delay:0.2"):
        out = srv.decode({"handoff_id": "late"}, _body(PROMPTS[4]))
        fired = fi.call_count("llm.handoff")
    assert out == jax_side["sequential"][4]
    assert srv._fallback_reprefills == 1
    assert fired == 1


# ---------------------------------------------------------------------------
# a prefill and a decode server joined by one edge
# ---------------------------------------------------------------------------

class _Done:
    def __init__(self, value):
        self.value = value

    def result(self, timeout=None):
        return self.value


class _LocalReplica:
    """A decode server reached as a replica handle reaches it: every
    argument crosses a pickle boundary, as over the serve wire (the
    channel's transport is re-attached by name on the far side)."""

    replica_id = "LLMDecode#local"

    def __init__(self, srv):
        self.srv = srv

    def handle_request(self, method, args=(), kwargs=None,
                       request_context=None):
        args = pickle.loads(pickle.dumps(tuple(args)))
        return _Done(getattr(self.srv, method)(*args))


def test_disaggregated_pair_matches_colocated_and_jax(models, port_server,
                                                      jax_side):
    pre = tserving.LLMPrefillServer._target(_port_kw(models))
    dec = tserving.LLMDecodeServer._target(_port_kw(models))
    replica = _LocalReplica(dec)
    try:
        for i, p in enumerate(PROMPTS):
            token = pre.prefill(_body(p), replica)
            assert token["handoff_id"] is not None, token
            if i % 2 == 0:
                out = dec.decode(token, _body(p))
            else:
                chunks = list(dec.decode_stream(token, _body(p)))
                assert "".join(c["text"] for c in chunks[:-1]) \
                    == chunks[-1]["generated_text"]
                out = {k: chunks[-1][k] for k in ("generated_text",
                                                  "num_generated_tokens")}
            assert out == jax_side["sequential"][i]
            assert out == port_server(_body(p))
        pst, dst = pre.stats(), dec.stats()
        assert pst["handoff"]["exported"] == len(PROMPTS)
        assert dst["handoff"]["adopted"] == len(PROMPTS)
        assert dst["fallback_reprefills"] == 0
        assert dst["timing"]["prefill_tokens"] == 0  # nothing re-prefilled
        assert dst["landing"]["landed"] == len(PROMPTS)
        # stage times read without a wait on the hot path; no kernel of
        # K1-K4 is on the serving path
        assert all(h["export_ms"] >= 0 for h in pst["handoffs"])
        assert all(h["adopt_ms"] >= 0 for h in dst["handoffs"])
        assert pst["kernel_launches"] == dst["kernel_launches"] == {
            "K1": 0, "K2": 0, "K3": 0, "K4": 0}
    finally:
        pre.__del__()
        dec.__del__()


# ---------------------------------------------------------------------------
# batch inference
# ---------------------------------------------------------------------------

def test_llm_predictor_matches_jax(models, jax_side):
    pred = tbatch.LLMPredictor(
        _port_kw(models), sampling={"temperature": 0.0,
                                    "max_tokens": NEW_TOKENS})
    out = pred(_batch())
    assert list(out["generated"]) == jax_side["predictor"]
    assert list(out["prompt"]) == PROMPTS[:4]


@pytest.mark.parametrize("num_gpus", [0, 1])
def test_build_llm_processor_matches_predictor(models, num_gpus):
    """``num_gpus`` reserves nothing: the engine's ``device`` decides."""
    import ray_tpu_torch.data as rd

    sampling = {"temperature": 0.0, "max_tokens": NEW_TOKENS}
    rows = tbatch.build_llm_processor(
        rd.from_items([{"prompt": p} for p in PROMPTS]),
        engine_kwargs=_port_kw(models), concurrency=1, batch_size=3,
        sampling=sampling, num_gpus=num_gpus).take_all()
    pred = tbatch.LLMPredictor(_port_kw(models), sampling=sampling)
    want = [t for b in (PROMPTS[:3], PROMPTS[3:]) for t in pred(
        {"prompt": np.array(b, dtype=object)})["generated"]]
    assert [r["prompt"] for r in rows] == PROMPTS
    assert [r["generated"] for r in rows] == want
