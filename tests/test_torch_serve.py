"""The port's serve plane on the CPU (``ray_tpu_torch.serve``): replicas as
spawned processes behind a controller thread, the router, the stdlib
HTTP proxy, and the two-stage dispatch; JAX-free.

The reference's serve tests (``tests/test_serve*.py``,
``tests/test_llm_disagg.py:256-402``, ``:772-806``) run on actors; here
the same cases run over replica processes.  One serve instance is shared
by the module: its deployments are defined at this module's top level,
where a replica imports them by name.  Each replica runs one thread of
torch; a watchdog kills every replica if the module outlives
``WATCHDOG_S``.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import (ActorDiedError, BackPressureError,
                                      DeadlineExceededError)
from ray_tpu_torch.serve.controller import get_controller
from ray_tpu_torch.serve.router import DeploymentHandle, TwoStageHandle

torch.set_num_threads(1)

WATCHDOG_S = 300.0
# the reference's fake decode pool: chunks per stream and the sleep before
# each (slow enough for a kill to land mid-stream)
FAKE_CHUNKS, FAKE_CHUNK_SLEEP_S = 6, 0.25
LLM_KW = {"model": "tiny", "batch_slots": 4, "max_len": 128,
          "device": "cpu"}


# ---------------------------------------------------------------------------
# deployments (top level: replicas import them by name)
# ---------------------------------------------------------------------------

@serve.deployment(num_replicas=2)
class Echo:
    def __init__(self, tag="echo"):
        torch.set_num_threads(1)
        self.tag = tag

    def __call__(self, body):
        if isinstance(body, dict) and "raise" in body:
            raise ValueError(body["raise"])
        return {"tag": self.tag, "body": body, "pid": os.getpid()}

    def slow(self, seconds):
        time.sleep(seconds)
        return os.getpid()

    def count(self, n):
        for i in range(int(n)):
            yield {"index": i}

    def boom(self, body):
        raise ValueError(f"boom {body}")

    def reconfigure(self, user_config):
        self.tag = user_config["tag"]

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
    def batched(self, items):
        return [{"item": x, "batch": len(items)} for x in items]


@serve.deployment(name="FakePrefill")
class FakePrefill:
    """Speaks the two-stage protocol without an engine: the token names
    the decode replica it was given."""

    def prefill(self, body, decode_replica):
        return {"handoff_id": f"h-{body['prompt']}",
                "decode_replica": decode_replica.replica_id}


@serve.deployment(name="FakeDecode", num_replicas=2)
class FakeDecode:
    def __init__(self, chunk_sleep_s=0.0, chunks=4):
        self.chunk_sleep_s = chunk_sleep_s
        self.chunks = chunks

    def decode(self, token, body):
        return {"generated_text": f"dec:{body['prompt']}",
                "num_generated_tokens": 3, "token": token, "pid": os.getpid(),
                "served_by": serve.get_replica_context().replica_id}

    def decode_stream(self, token, body):
        for i in range(self.chunks):
            time.sleep(self.chunk_sleep_s)
            yield {"index": i, "text": f"t{i}", "pid": os.getpid()}
        yield {"done": True, "num_generated_tokens": self.chunks,
               "generated_text": "".join(f"t{i}"
                                         for i in range(self.chunks))}


def _replicas(name):
    return get_controller(create=False).get_deployment_info(name)["replicas"]


def _wait_replicas(name, n, exclude=(), timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reps = _replicas(name)
        if len(reps) == n and not set(r.replica_id for r in reps) \
                & set(exclude):
            return reps
        time.sleep(0.1)
    raise AssertionError(f"{name}: {_replicas(name)} after {timeout} s")


@pytest.fixture(scope="module")
def serving():
    """One serve instance with its proxy on a free port, the shared
    deployments up; every replica is killed at teardown, or by the
    watchdog if the module outlives ``WATCHDOG_S``."""
    proxy = serve.start(http_options={"host": "127.0.0.1", "port": 0})

    def kill_all():
        ctrl = get_controller(create=False)
        if ctrl is None:
            return
        for n in list(ctrl.list_deployments()):
            for r in ctrl.get_deployment_info(n)["replicas"]:
                try:
                    os.kill(r.pid, signal.SIGKILL)
                except OSError:
                    pass

    watchdog = threading.Timer(WATCHDOG_S, kill_all)
    watchdog.daemon = True
    watchdog.start()
    apps = [(Echo.bind("hello"), "echo", "/echo"),
            (Echo.options(name="Tight", num_replicas=1,
                          max_ongoing_requests=1,
                          max_queued_requests=0).bind(), "tight", "/tight"),
            (FakePrefill.bind(), "fp", "/fp"),
            (FakeDecode.bind(FAKE_CHUNK_SLEEP_S, FAKE_CHUNKS), "fd", "/fd")]
    errors = []

    def deploy(app, name, prefix):
        try:
            serve.run(app, name=name, route_prefix=prefix)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=deploy, args=a) for a in apps]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    try:
        assert not errors, errors
        yield proxy
    finally:
        watchdog.cancel()
        serve.shutdown()


def _post(proxy, path, body, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{proxy.port}{path}", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse(raw: bytes):
    return [json.loads(line[len(b"data: "):])
            for line in raw.split(b"\n") if line.startswith(b"data: ")]


# ---------------------------------------------------------------------------
# deployments, admission, HTTP
# ---------------------------------------------------------------------------

def test_bind_and_options(serving):
    app = Echo.bind("x")
    assert app.deployment is Echo and app.args == ("x",)
    tight = Echo.options(name="T2", num_replicas=3, max_ongoing_requests=2)
    assert (tight.name, tight.config.num_replicas,
            tight.config.max_ongoing_requests) == ("T2", 3, 2)
    assert tight._target is Echo._target
    assert Echo.config.num_replicas == 2  # options() copies
    dep = serve.deployment(name="Plain")(lambda body: body)
    with pytest.raises(TypeError, match="top level"):
        serve.run(dep.bind())


def test_two_replicas_answer_handle_calls(serving):
    h = DeploymentHandle("Echo")
    outs = [h.remote({"i": i}).result(timeout=30) for i in range(20)]
    assert [o["body"] for o in outs] == [{"i": i} for i in range(20)]
    assert {o["tag"] for o in outs} == {"hello"}
    pids = {o["pid"] for o in outs}
    assert pids == {r.pid for r in _replicas("Echo")} and len(pids) == 2
    assert list(h.count.remote_streaming(3)) == [{"index": i}
                                                 for i in range(3)]
    with pytest.raises(ValueError, match="boom 7"):
        h.boom.remote(7).result(timeout=30)
    assert serve.get_app_handle("echo").deployment_name == "Echo"
    st = serve.status()
    assert st["Echo"]["num_replicas"] == st["Echo"]["goal"] == 2


def test_serve_batch_and_reconfigure(serving):
    """``@serve.batch`` groups concurrent calls on one replica into one
    list; ``reconfigure`` reaches the callable."""
    rep = _replicas("Echo")[0]
    calls = [rep.handle_request("batched", (i,)) for i in range(4)]
    outs = [c.result(timeout=30) for c in calls]
    assert [o["item"] for o in outs] == [0, 1, 2, 3]
    assert max(o["batch"] for o in outs) > 1
    try:
        assert rep.control("reconfigure", {"tag": "re"}) is True
        assert rep.handle_request("__call__", ({},)).result(
            timeout=30)["tag"] == "re"
    finally:
        rep.control("reconfigure", {"tag": "hello"})


def test_admission_sheds_with_backpressure(serving):
    h = DeploymentHandle("Tight")
    busy = h.slow.remote(2.0)  # the one slot
    with pytest.raises(BackPressureError) as e:
        h.remote({"x": 1}).result(timeout=30)
    assert e.value.limit == 0 and e.value.retry_after_s > 0
    assert busy.result(timeout=30) == _replicas("Tight")[0].pid
    # the slot came back: the next call is admitted
    assert h.remote({"x": 2}).result(timeout=30)["body"] == {"x": 2}
    router = h._get_router()
    assert router.overload_stats.snapshot()["shed"] == 1
    assert router.inflight_snapshot() == {}
    # the router published its counters into the serve store
    assert serve.status()["Tight"]["overload"]["shed"] == 1


def test_replica_admits_up_to_its_concurrency(serving):
    """A replica runs max(2, max_ongoing_requests) calls at once, as the
    reference's actor concurrency; the rest wait for a slot, and one
    whose deadline passes while it waits is dropped unrun."""
    rep = _replicas("Tight")[0]  # max_ongoing_requests=1: two slots
    busy = [rep.handle_request("slow", (1.5,)) for _ in range(2)]
    time.sleep(0.2)
    late = {"request_id": "late", "deadline_s": time.time() + 0.3}
    with pytest.raises(DeadlineExceededError, match="replica-queue"):
        rep.handle_request("__call__", ({},), request_context=late).result(
            timeout=30)
    t0 = time.monotonic()
    out = rep.handle_request("__call__", ({"after": 1},)).result(timeout=30)
    assert out["body"] == {"after": 1} and time.monotonic() - t0 > 0.5
    assert [b.result(timeout=30) for b in busy] == [rep.pid] * 2
    assert rep.control("stats")["expired"] == 1


def test_http_unary_stream_and_status_mapping(serving):
    proxy = serving
    out = json.loads(_post(proxy, "/echo", {"q": 1}).read())
    assert out["body"] == {"q": 1} and out["tag"] == "hello"
    # a GET passes its query parameters as the body
    out = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{proxy.port}/echo/sub?a=1", timeout=30).read())
    assert out["body"] == {"a": "1"}
    # SSE: one data event per item, in order
    raw = _post(proxy, "/echo?stream=1&method=count", 4).read()
    assert _sse(raw) == [{"index": i} for i in range(4)]
    # a budget spent at the door: 504
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(proxy, "/echo", {"q": 2}, {"X-Request-Timeout-S": "0"})
    assert e.value.code == 504
    assert "DeadlineExceededError" in json.loads(e.value.read())["error"]
    # an application error: 500
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(proxy, "/echo", {"raise": "bad body"})
    assert e.value.code == 500
    assert "bad body" in json.loads(e.value.read())["error"]
    # no route: 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{proxy.port}/nowhere",
                               timeout=30)
    assert e.value.code == 404
    # a shed: 503 with Retry-After
    busy = DeploymentHandle("Tight").slow.remote(2.0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(proxy, "/tight", {"q": 5})
    assert e.value.code == 503 and int(e.value.headers["Retry-After"]) >= 1
    busy.result(timeout=30)


def test_http_dropped_stream_cancels_the_producer(serving):
    """A client that drops an SSE stream releases the router's slot and
    stops the replica's producer."""
    import socket

    proxy = serving
    before = {r.replica_id: r.control("stats")["cancelled"]
              for r in _replicas("Echo")}
    body = json.dumps(10 ** 9).encode()
    s = socket.create_connection(("127.0.0.1", proxy.port), timeout=30)
    s.sendall(b"POST /echo?stream=1&method=count HTTP/1.1\r\n"
              b"Host: x\r\nContent-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
              + body)
    got = b""
    while b"data:" not in got:
        got += s.recv(4096)  # the headers, then the first events
    s.close()
    deadline = time.monotonic() + 30
    router = proxy.handle_for("Echo", "count")._get_router()
    while time.monotonic() < deadline:
        after = {r.replica_id: r.control("stats")["cancelled"]
                 for r in _replicas("Echo")}
        if sum(after.values()) > sum(before.values()) \
                and not router.inflight_snapshot():
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"producer not cancelled: {before} -> {after}, "
                             f"in flight {router.inflight_snapshot()}")


# ---------------------------------------------------------------------------
# replica death, and a replica that cannot start
# ---------------------------------------------------------------------------

def test_replica_without_cuda_fails_run(serving):
    """With no device an LLM replica runs on the card; without CUDA its
    start fails and ``serve.run`` raises with the replica's error (never
    a CPU replica), leaving nothing deployed."""
    from ray_tpu_torch.llm.serving import build_llm_deployment

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the replica would start")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(build_llm_deployment({"model": "tiny"}), name="nocuda",
                  route_prefix="/nocuda")
    assert "LLMServer" not in serve.status()


def test_replica_death_fails_pending_call_and_restarts(serving):
    h = DeploymentHandle("Echo")
    h.remote({"warm": 1}).result(timeout=30)
    resp = h.slow.remote(60.0)
    victim_id = resp.call._conn.label
    victim = next(r for r in _replicas("Echo") if r.replica_id == victim_id)
    time.sleep(0.2)  # the call is running in the replica
    t0 = time.monotonic()
    os.kill(victim.pid, signal.SIGKILL)
    with pytest.raises(ActorDiedError, match=victim_id):
        resp.result(timeout=30)
    assert time.monotonic() - t0 < 5.0
    # the controller prunes the dead replica and starts a replacement
    reps = _wait_replicas("Echo", 2, exclude=[victim_id])
    assert victim.pid not in {r.pid for r in reps}
    outs = [h.remote({"i": i}).result(timeout=30) for i in range(10)]
    assert all(o["pid"] != victim.pid for o in outs)


# ---------------------------------------------------------------------------
# two-stage dispatch on fake pools (tests/test_llm_disagg.py:256-402)
# ---------------------------------------------------------------------------

def _two_stage(max_reprefills=1):
    return TwoStageHandle(DeploymentHandle("FakePrefill"),
                          DeploymentHandle("FakeDecode"),
                          max_reprefills=max_reprefills)


def test_two_stage_unary_targets_reserved_replica(serving):
    two = _two_stage()
    for prompt in ("x", "y", "z"):
        out = two.call({"prompt": prompt}, timeout=60)
        assert out["generated_text"] == f"dec:{prompt}"
        # stage 2 ran on the replica stage 1 shipped to
        assert out["served_by"] == out["token"]["decode_replica"]
    assert two.stats == {"requests": 3, "reprefills": 0}
    assert DeploymentHandle("FakeDecode")._get_router() \
        .inflight_snapshot() == {}


def test_two_stage_stream_chunks_in_order(serving):
    chunks = list(_two_stage().stream({"prompt": "s"}))
    assert [c["index"] for c in chunks[:-1]] == list(range(FAKE_CHUNKS))
    assert chunks[-1]["done"]
    assert chunks[-1]["num_generated_tokens"] == FAKE_CHUNKS


def test_two_stage_overload_not_retried(serving):
    """A shed or expired verdict surfaces unchanged, never re-prefilled."""
    two = _two_stage()
    with serve.request_scope(timeout_s=0.0):  # born expired
        with pytest.raises(DeadlineExceededError):
            two.call({"prompt": "x"})
    assert two.stats["reprefills"] == 0


def test_two_stage_decode_death_reprefills_on_healthy_pair(serving):
    """Kill the decode replica mid-stream: the request re-prefills on a
    healthy pair (counted) and the stream completes with deduplicated
    indices, inside its deadline."""
    two = _two_stage(max_reprefills=3)
    got, killed = [], {}
    t0 = time.monotonic()
    with serve.request_scope(timeout_s=60.0):
        for chunk in two.stream({"prompt": "z", "temperature": 0.0}):
            got.append(chunk)
            if not killed and not chunk.get("done"):
                os.kill(chunk["pid"], signal.SIGKILL)
                killed["pid"] = chunk["pid"]
    assert time.monotonic() - t0 < 60.0
    assert two.stats["reprefills"] >= 1
    assert got[-1]["done"]
    assert got[-1]["num_generated_tokens"] == FAKE_CHUNKS
    idx = [c["index"] for c in got if not c.get("done")]
    assert idx == sorted(set(idx)) == list(range(FAKE_CHUNKS))
    finishing = {c["pid"] for c in got if not c.get("done")}
    assert len(finishing) >= 2 and killed["pid"] in finishing
    _wait_replicas("FakeDecode", 2)


# ---------------------------------------------------------------------------
# the LLM apps end to end over replica processes
# ---------------------------------------------------------------------------

def _bodies():
    return [{"prompt": p, "max_tokens": 8, "temperature": 0.0}
            for p in ("the quick brown fox", "hello", "a b c d e f g h")]


@pytest.fixture(scope="module")
def in_process_texts():
    from ray_tpu_torch.llm.serving import LLMServer

    srv = LLMServer._target(LLM_KW)
    try:
        return [srv(b) for b in _bodies()]
    finally:
        srv._stop = True


def test_llm_colocated_app_matches_in_process(serving, in_process_texts):
    from ray_tpu_torch.llm.serving import build_llm_deployment

    proxy = serving
    h = serve.run(build_llm_deployment(LLM_KW), name="colo",
                  route_prefix="/llm")
    try:
        assert [h.remote(b).result(timeout=60) for b in _bodies()] \
            == in_process_texts
        body = _bodies()[0]
        out = json.loads(_post(proxy, "/llm", body).read())
        assert out == in_process_texts[0]
        chunks = _sse(_post(proxy, "/llm?stream=1&method=stream",
                            body).read())
        assert chunks[-1]["done"]
        assert "".join(c["text"] for c in chunks[:-1]) \
            == in_process_texts[0]["generated_text"]
        stats = h.stats.remote().result(timeout=30)
        rid = _replicas("LLMServer")[0].replica_id
        assert stats["role"] == "colocated" and stats["replica"] == rid
        # the engine stats the replica publishes into the serve store
        from ray_tpu_torch.serve.controller import serve_store

        key = f"llm/engine/LLMServer/{rid}"
        deadline = time.monotonic() + 30
        while serve_store().get(key) is None:
            assert time.monotonic() < deadline, f"{key} never published"
            time.sleep(0.1)
        rec = json.loads(serve_store().get(key))
        assert (rec["role"], rec["deployment"]) == ("colocated", "LLMServer")
    finally:
        serve.delete("LLMServer")
    # its shutdown hook (__del__) dropped the record
    assert serve_store().get(key) is None


def test_llm_disaggregated_app_matches_in_process(serving, in_process_texts,
                                                  monkeypatch):
    """Prefill and decode replicas behind the ingress, the KV riding a
    device-tier channel between them (emulated on the CPU), equal to the
    in-process colocated server; no request re-prefills."""
    from ray_tpu_torch.experimental.channel.transport import (
        ENV_EMULATE_DEVICE, TIER_DEVICE)
    from ray_tpu_torch.llm.serving import (build_disaggregated_llm_deployment,
                                           disaggregated_handle)

    monkeypatch.setenv(ENV_EMULATE_DEVICE, "1")  # inherited by the replicas
    proxy = serving
    ingress = serve.run(build_disaggregated_llm_deployment(LLM_KW),
                        name="llm", route_prefix="/dis")
    try:
        assert [ingress.remote(b).result(timeout=60) for b in _bodies()] \
            == in_process_texts
        two = disaggregated_handle()
        body = _bodies()[1]
        assert two.call(body, timeout=60) == in_process_texts[1]
        chunks = list(two.stream(body))
        assert chunks[-1]["done"]
        assert "".join(c["text"] for c in chunks[:-1]) \
            == in_process_texts[1]["generated_text"]
        out = json.loads(_post(proxy, "/dis", _bodies()[2]).read())
        assert out == in_process_texts[2]
        pre = DeploymentHandle("LLMPrefill").stats.remote().result(timeout=30)
        dec = DeploymentHandle("LLMDecode").stats.remote().result(timeout=30)
        assert pre["handoff"]["exported"] == dec["handoff"]["adopted"] == 6
        assert {s["tier"] for s in pre["shipper"].values()} == {TIER_DEVICE}
        assert dec["fallback_reprefills"] == 0
    finally:
        for name in ("LLMIngress", "LLMPrefill", "LLMDecode"):
            serve.delete(name)
