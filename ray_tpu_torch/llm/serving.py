"""LLM serving: engine-per-replica deployments over ``ray_tpu_torch.serve``
(counterpart of ``ray_tpu/llm/serving.py``).

Two deployment topologies:

- **Colocated** (:class:`LLMServer`): every replica runs prefill and
  decode on its card.
- **Disaggregated** (:class:`LLMPrefillServer` + :class:`LLMDecodeServer`
  behind :class:`LLMDisaggIngress` /
  :class:`~ray_tpu_torch.serve.router.TwoStageHandle`): prefill replicas
  run chunked prefill only and ship the finished KV blocks to the decode
  replica reserved for the request over a negotiated channel
  (:mod:`ray_tpu_torch.llm.kv_transfer`: device frames between CUDA
  processes of one node); decode replicas graft the blocks without
  re-prefill and serve the decode loop.

Each replica publishes its engine stats every
:data:`STATS_PUBLISH_INTERVAL_S` into the serve store under
``llm/engine/<deployment>/<replica>`` (the reference's GCS KV namespace
``"llm"``).  A replica is one process on one card: the reference's
``tensor_parallel_size > 1`` (a mesh inside the replica) is a gang of
processes in the port and waits (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import queue as queue_mod
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import DeadlineExceededError

# engine-stats publish cadence into the serve store
STATS_PUBLISH_INTERVAL_S = 2.0
KV_PREFIX = "llm/engine/"
# recent requests' and hand-offs' timing records a replica keeps (stats)
RECORDS = 64


class _StageClock:
    """Times one hand-off stage without waiting for the card: CUDA events
    on the current stream around it on a card, resolved by ``ms()`` once
    the card is past the stage; the host clock on the CPU."""

    def __init__(self, device):
        self._events = None
        if device.type == "cuda":
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(device))
        self._device = device
        self._t0 = time.perf_counter()
        self._ms: Optional[float] = None

    def stop(self) -> "_StageClock":
        if self._events is None:
            self._ms = 1e3 * (time.perf_counter() - self._t0)
        else:
            import torch

            self._events[1].record(torch.cuda.current_stream(self._device))
        return self

    def ms(self) -> Optional[float]:
        """The stage's ms, or None while the card has not finished it."""
        if self._ms is None and self._events is not None \
                and self._events[1].query():
            self._ms = self._events[0].elapsed_time(self._events[1])
        return self._ms


def _resolved(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A hand-off record with its stage clocks read as ``<stage>_ms``."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, _StageClock):
            k, v = f"{k}_ms", v.ms()
        out[k] = v
    return out


def _kernel_launches() -> List[int]:
    """This process's K1-K4 wrapper counts: flash attention's forward,
    its dq and dkv backward, and the remote copy."""
    from ray_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy

    return [flash_attention_fwd.launches, flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches, remote_copy.launches]


def _build_engine(engine_kwargs: Optional[Dict[str, Any]],
                  tensor_parallel_size: int):
    """Shared engine construction.  ``engine_kwargs`` takes the
    reference's by-name config (``model="llama2_7b"``: bf16 weights from
    the seed; ``"tiny"``: the tiny config) or ``cfg`` (and ``params``),
    plus ``device``: none means the card, whose index is fixed here so
    the engine's threads all use it."""
    import torch

    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig

    if tensor_parallel_size > 1:
        raise NotImplementedError(
            f"tensor_parallel_size={tensor_parallel_size}: a tensor-parallel "
            "replica is a gang of processes in the port, not yet built "
            "(ROADMAP Queue 1, item 9's leftovers); serve one card per "
            "replica")
    kw = dict(engine_kwargs or {})
    cfg = kw.pop("cfg", None)
    model = kw.pop("model", None)
    if cfg is None:
        if model:
            cfg = getattr(LlamaConfig, model)()
            if model != "tiny":
                cfg = dataclasses.replace(
                    cfg, param_dtype=torch.bfloat16,
                    max_seq_len=kw.get("max_len", cfg.max_seq_len))
        else:
            cfg = LlamaConfig.tiny()
    device = resolve_device(kw.pop("device", None))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return LLMEngine(cfg, device=device, **kw)


class _EngineHost:
    """Shared replica plumbing for every engine-hosting deployment.

    Request threads only submit into the engine (under a lock) and wait
    on per-request events; one background thread drives
    ``engine.step()``, so concurrent requests share decode batches.  The
    loop also publishes ``engine.stats()`` into the serve store.
    """

    # Admission settle: when free slots remain and a submit landed within
    # this window, hold the next step briefly so concurrent requests
    # (arriving one call at a time) coalesce into one batch instead of
    # the first burning a whole decode window at batch arity 1.  A lone
    # request pays at most ~settle ms of extra latency.
    ADMISSION_SETTLE_S = 0.004

    # fallback generation budget when the request carries no deadline
    DEFAULT_BUDGET_S = 600.0

    role = "colocated"

    def _init_engine_host(self, engine_kwargs, tensor_parallel_size):
        self.engine = _build_engine(engine_kwargs, tensor_parallel_size)
        self._launches_at_build = _kernel_launches()
        self._lock = threading.Lock()
        self._waiters: Dict[int, Any] = {}  # request_id -> {event, output}
        self._token_queues: Dict[int, Any] = {}  # request_id -> Queue
        self.engine.on_token = self._on_token
        self._stop = False
        self._last_submit = 0.0  # monotonic; admission-settle signal
        self._last_step = 0.0    # monotonic; bounds settle deferral
        self._last_publish = 0.0
        self._steps = 0  # engine steps taken by the loop
        # recent requests' time to first token and end to end, and recent
        # hand-offs' stage times (prefill and decode roles)
        self._requests: collections.deque = collections.deque(
            maxlen=RECORDS)
        self._handoffs: collections.deque = collections.deque(
            maxlen=RECORDS)
        self._host_id = uuid.uuid4().hex[:10]
        rc = serve.get_replica_context()
        self._deployment = rc.deployment if rc else self.role
        self._replica_id = rc.replica_id if rc else self._host_id
        self._loop = threading.Thread(target=self._engine_loop, daemon=True,
                                      name="llm-engine-loop")
        self._loop.start()

    def _on_token(self, request_id: int, tok: int):
        # engine thread, lock held: the first token's time for the record
        slot = self._waiters.get(request_id)
        if slot is not None:
            slot.setdefault("t_first", time.monotonic())
        q = self._token_queues.get(request_id)
        if q is not None:
            q.put_nowait(tok)

    def _engine_loop(self):
        while not self._stop:
            with self._lock:
                busy = self.engine.has_unfinished()
                settle = False
                outs = []
                now = time.monotonic()
                if not busy:
                    # idle: keep the deferral clock fresh so the bound
                    # measures time without a step only while decodes wait
                    self._last_step = now
                else:
                    settle = (
                        self.engine.free_slot_count()
                        > self.engine.queued_count()
                        and now - self._last_submit < self.ADMISSION_SETTLE_S
                        # deferral is bounded: a steady sub-settle trickle
                        # of submits must not starve running decodes
                        and now - self._last_step
                        <= 2 * self.ADMISSION_SETTLE_S)
                    if not settle:
                        outs = self.engine.step()
                        self._steps += 1
                        self._last_step = time.monotonic()
                for out in outs:
                    slot = self._waiters.pop(out.request_id, None)
                    if slot is not None:
                        slot["output"] = out
                        slot["event"].set()
                        if "t" in slot:
                            self._note_request(slot, out)
            self._maybe_publish_stats()
            if settle:
                time.sleep(0.001)
            elif not busy:
                time.sleep(0.005)

    def _note_request(self, slot: Dict[str, Any], out) -> None:
        """Lock held: one finished request's time to first token (None
        when its first token was a stop token) and end to end, from its
        submission."""
        now = time.monotonic()
        first = slot.get("t_first")
        self._requests.append({
            "ttft_s": None if first is None else first - slot["t"],
            "e2e_s": now - slot["t"], "tokens": len(out.token_ids)})

    def _maybe_publish_stats(self):
        now = time.monotonic()
        if now - self._last_publish < STATS_PUBLISH_INTERVAL_S:
            return
        self._last_publish = now
        if serve.get_replica_context() is None:
            return  # in-process use: no serve store to publish into
        try:
            from ray_tpu_torch.serve.controller import serve_store

            rec = {"ts": time.time(), **self.stats()}
            serve_store().put(
                f"{KV_PREFIX}{self._deployment}/{self._replica_id}",
                json.dumps(rec).encode())
        except Exception:  # noqa: BLE001 — visibility never kills the loop
            pass

    def _extra_stats(self) -> Dict[str, Any]:
        return {}

    def stats(self) -> Dict[str, Any]:
        """Engine + role stats over the handle (tests, debugging)."""
        with self._lock:
            out = {"role": self.role, "deployment": self._deployment,
                   "replica": self._replica_id, "engine_steps": self._steps,
                   "requests": list(self._requests),
                   "handoffs": [_resolved(h) for h in self._handoffs],
                   # K1-K4 launched in this process since the engine's build
                   "kernel_launches": dict(zip(
                       ("K1", "K2", "K3", "K4"),
                       (n - n0 for n, n0 in zip(_kernel_launches(),
                                                self._launches_at_build))))}
            out.update(self.engine.stats())
        out.update(self._extra_stats())
        return out

    def _budget_s(self) -> float:
        """The request's remaining deadline budget (from the proxy or a
        nesting handle through ``serve.context``), or
        ``DEFAULT_BUDGET_S`` without one."""
        ctx = serve.context.current_context()
        if ctx is None:
            return self.DEFAULT_BUDGET_S
        remaining = ctx.remaining_s()
        return self.DEFAULT_BUDGET_S if remaining is None \
            else max(0.0, remaining)

    def _abort_abandoned(self, rid: int) -> None:
        """Lock held.  Drop an abandoned request from the engine: the
        client stopped waiting, so free the slot instead of decoding an
        answer nobody reads."""
        self._waiters.pop(rid, None)
        self.engine.abort(rid)

    def _sampling_from_body(self, body: Dict[str, Any]):
        from ray_tpu_torch.models.generation import SamplingParams

        return SamplingParams(
            temperature=float(body.get("temperature", 0.7)),
            # clamp to what the engine can ever hold: an unclamped client
            # value must fail this request at most, not others
            max_tokens=min(int(body.get("max_tokens", 64)),
                           self.engine.max_len - 1),
            stop_token_id=self.engine.tokenizer.eos_id)

    # -- shared unary / streaming request paths -----------------------------

    def _generate(self, body: Dict[str, Any],
                  budget: Optional[float] = None) -> Dict[str, Any]:
        budget = self._budget_s() if budget is None else budget
        sp = self._sampling_from_body(body)
        slot = {"event": threading.Event(), "output": None,
                "t": time.monotonic()}
        with self._lock:
            rid = self.engine.submit(body["prompt"], sp)
            self._waiters[rid] = slot
            self._last_submit = time.monotonic()
        if not slot["event"].wait(timeout=budget):
            with self._lock:
                self._abort_abandoned(rid)
            raise DeadlineExceededError(
                deployment=self._deployment, stage="generation",
                overrun_s=0.0)
        out = slot["output"]
        if out.error:
            raise RuntimeError(out.error)
        return {"generated_text": out.text,
                "num_generated_tokens": len(out.token_ids)}

    def _stream_tokens(self, slot: Dict[str, Any], tq, deadline: float,
                       seed_tokens: List[int]):
        """Yield one ``{"token_id", "text", "index"}`` chunk per decoded
        token and a final ``{"done": True, ...}`` summary.  Each chunk is
        the delta of the cumulative decode, holding back a trailing
        replacement char (an incomplete multi-byte sequence) until the
        bytes completing it arrive.  ``seed_tokens`` were produced before
        this consumer attached (the hand-off's prefill-sampled first
        token)."""
        index = 0
        all_ids: List[int] = []
        emitted = ""  # stable decoded prefix already streamed
        pending = list(seed_tokens)
        while True:
            if pending:
                tok = pending.pop(0)
            else:
                if slot["event"].is_set() and tq.empty():
                    break
                if time.time() > deadline:
                    raise DeadlineExceededError(
                        deployment=self._deployment,
                        stage="generation-stream",
                        overrun_s=time.time() - deadline)
                if not self._loop.is_alive():
                    raise RuntimeError("engine loop died mid-generation")
                try:
                    tok = tq.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
            all_ids.append(int(tok))
            full = self.engine.tokenizer.decode(all_ids)
            stable = full.rstrip("�")
            delta = stable[len(emitted):]
            if delta:
                yield {"token_id": int(tok), "text": delta, "index": index}
                index += 1
            emitted = stable
        out = slot["output"]
        if out.error:
            raise RuntimeError(out.error)
        tail = out.text[len(emitted):]
        if tail:  # flush any held-back suffix so chunks sum to text
            yield {"token_id": -1, "text": tail, "index": index}
        yield {"done": True, "generated_text": out.text,
               "num_generated_tokens": len(out.token_ids)}

    def _stream(self, body: Dict[str, Any], budget: Optional[float] = None):
        budget = self._budget_s() if budget is None else budget
        sp = self._sampling_from_body(body)
        slot = {"event": threading.Event(), "output": None,
                "t": time.monotonic()}
        tq: queue_mod.Queue = queue_mod.Queue()
        with self._lock:
            rid = self.engine.submit(body["prompt"], sp)
            self._waiters[rid] = slot
            self._token_queues[rid] = tq
            self._last_submit = time.monotonic()
        try:
            yield from self._stream_tokens(slot, tq, time.time() + budget, [])
        finally:
            with self._lock:
                self._token_queues.pop(rid, None)
                if not slot["event"].is_set():
                    # unfinished and the consumer is gone: deadline
                    # expiry, engine error, or a dropped stream
                    self._abort_abandoned(rid)

    def check_health(self) -> bool:
        if not self._loop.is_alive():
            raise RuntimeError("engine loop died")
        return True

    def _teardown_engine_host(self):
        self._stop = True
        if serve.get_replica_context() is None:
            return
        try:
            # drop this replica's engine-stats record
            from ray_tpu_torch.serve.controller import serve_store

            serve_store().delete(
                f"{KV_PREFIX}{self._deployment}/{self._replica_id}")
        except Exception:  # noqa: BLE001 — the store may be gone already
            pass

    def __del__(self):
        self._teardown_engine_host()


@serve.deployment(name="LLMServer", max_ongoing_requests=32,
                  max_queued_requests=64)
class LLMServer(_EngineHost):
    """Colocated HTTP/handle API: ``{"prompt": str or token ids,
    "max_tokens"?, "temperature"?} -> {"generated_text",
    "num_generated_tokens"}``."""

    role = "colocated"

    def __init__(self, engine_kwargs: Optional[Dict[str, Any]] = None,
                 tensor_parallel_size: int = 1):
        self._init_engine_host(engine_kwargs, tensor_parallel_size)

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._generate(body)

    def stream(self, body: Dict[str, Any]):
        """Token-streaming twin of ``__call__``; served over SSE by the
        proxy (``?stream=1&method=stream``) and through
        ``handle.stream.remote_streaming(body)``."""
        yield from self._stream(body)


@serve.deployment(name="LLMPrefill", max_ongoing_requests=8,
                  max_queued_requests=128)
class LLMPrefillServer(_EngineHost):
    """Prefill pool replica: runs chunked prefill only (prefill-only
    requests retire after their first sampled token), exports the KV
    blocks, and ships them to the decode replica reserved for the
    request over a negotiated channel
    (:class:`~ray_tpu_torch.llm.kv_transfer.KVBlockShipper`)."""

    role = "prefill"

    # bounded calls for channel setup: a dying decode replica must fail
    # the hand-off (-> re-prefill fallback), not wedge the prefill
    CONNECT_TIMEOUT_S = 15.0

    def __init__(self, engine_kwargs: Optional[Dict[str, Any]] = None,
                 tensor_parallel_size: int = 1,
                 ship_timeout_s: float = 60.0):
        from ray_tpu_torch.llm.kv_transfer import (KVBlockShipper,
                                                   handoff_channel_bytes)

        kw = dict(engine_kwargs or {})
        if not kw.get("prefill_chunk"):
            # chunked prefill is the pool's whole job: several long
            # prompts interleave block-aligned chunks
            kw["prefill_chunk"] = 4 * int(kw.get("block_size", 16))
        self._init_engine_host(kw, tensor_parallel_size)
        self._shipper = KVBlockShipper(
            self._host_id, channel_bytes=handoff_channel_bytes(self.engine),
            ship_timeout_s=ship_timeout_s)

    def _extra_stats(self) -> Dict[str, Any]:
        return {"shipper": self._shipper.stats()}

    def _ensure_channel(self, peer_key: str, decode_replica) -> None:
        if self._shipper.tier_of(peer_key) is not None:
            return
        info = decode_replica.handle_request("endpoint_info").result(
            timeout=self.CONNECT_TIMEOUT_S)

        def register(tr):
            decode_replica.handle_request(
                "open_kv_channel", (tr, self._host_id)).result(
                    timeout=self.CONNECT_TIMEOUT_S)

        self._shipper.connect(peer_key, info, register)

    def prefill(self, body: Dict[str, Any], decode_replica
                ) -> Dict[str, Any]:
        """Stage 1 of the two-stage dispatch: prefill ``body["prompt"]``,
        ship the KV blocks to ``decode_replica`` (a replica handle), and
        return the hand-off token stage 2 presents there.  A failed ship
        returns a tokenless hand-off (``handoff_id=None``): the decode
        stage falls back to a local re-prefill."""
        budget = self._budget_s()
        t_submit = time.monotonic()
        deadline = t_submit + budget
        sp = self._sampling_from_body(body)
        slot = {"event": threading.Event(), "output": None}
        with self._lock:
            rid = self.engine.submit(body["prompt"], sp, prefill_only=True)
            self._waiters[rid] = slot
            self._last_submit = time.monotonic()
        if not slot["event"].wait(timeout=budget):
            with self._lock:
                self._abort_abandoned(rid)
            raise DeadlineExceededError(
                deployment=self._deployment, stage="prefill", overrun_s=0.0)
        out = slot["output"]
        if out.error:
            raise RuntimeError(out.error)
        hid = f"{self._host_id}:{rid}"
        rec = {"handoff_id": hid, "prefill_s": time.monotonic() - t_submit}
        with self._lock:
            clock = _StageClock(self.engine.device)
            handoff = self.engine.export_kv(rid)
            rec["export"] = clock.stop()
        handoff["handoff_id"] = hid
        try:
            self._ensure_channel(decode_replica.replica_id, decode_replica)
            t0 = time.perf_counter()
            res = self._shipper.ship(
                decode_replica.replica_id, handoff,
                timeout=max(0.5, min(self._shipper.ship_timeout_s,
                                     deadline - time.monotonic())))
        except Exception as e:  # noqa: BLE001 — degrade to re-prefill
            return {"handoff_id": None, "reason": f"{type(e).__name__}: {e}",
                    "first_tokens": list(handoff["out_tokens"])}
        rec.update(ship_ms=1e3 * (time.perf_counter() - t0),
                   bytes=res["bytes"], tier=res["tier"])
        with self._lock:  # stats() lists the records under it
            self._handoffs.append(rec)
        return {"handoff_id": hid, "tier": res["tier"],
                "bytes": res["bytes"],
                "first_tokens": list(handoff["out_tokens"])}

    def __del__(self):
        self._teardown_engine_host()
        try:
            self._shipper.close()  # destroys the channel segments
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


@serve.deployment(name="LLMDecode", max_ongoing_requests=32,
                  max_queued_requests=64)
class LLMDecodeServer(_EngineHost):
    """Decode pool replica: lands shipped KV blocks straight into its own
    pool (``adopt_prefilled`` grafts blocks and prefix-cache keys, no
    re-prefill) and serves the decode loop.  A hand-off that never lands
    falls back to an ordinary local generation: correctness never
    depends on the fast path."""

    role = "decode"

    # how long stage 2 waits for its hand-off to land before falling back
    # to a local re-prefill (always also bounded by the request budget)
    HANDOFF_WAIT_S = 10.0

    # an unclaimed landed hand-off (its stage-2 caller gave up, or a
    # retry presents a new id) is reaped after this long
    LANDED_TTL_S = 60.0

    def __init__(self, engine_kwargs: Optional[Dict[str, Any]] = None,
                 tensor_parallel_size: int = 1):
        from ray_tpu_torch.llm.kv_transfer import KVLandingStrip

        self._init_engine_host(engine_kwargs, tensor_parallel_size)
        # handoff_id -> {"request_id", "slot", "queue", "first_tokens", "t"}
        self._landed: Dict[str, Dict[str, Any]] = {}
        # hand-off ids whose waiter already fell back to a local
        # re-prefill: a late landing must not adopt a duplicate request
        self._abandoned: Dict[str, float] = {}
        self._landed_cond = threading.Condition()
        self._fallback_reprefills = 0
        self._late_handoffs = 0
        self._strip = KVLandingStrip(self._adopt)

    def _extra_stats(self) -> Dict[str, Any]:
        self._reap_stale()  # rides the stats cadence (engine loop)
        with self._landed_cond:
            pending = len(self._landed)
            fallbacks = self._fallback_reprefills
            late = self._late_handoffs
        return {"landing": self._strip.stats(),
                "handoffs_pending": pending,
                "fallback_reprefills": fallbacks,
                "late_handoffs": late}

    # -- channel plumbing (called by the prefill side) ----------------------

    def endpoint_info(self):
        from ray_tpu_torch.experimental.channel.transport import \
            local_endpoint_info

        return local_endpoint_info()

    def open_kv_channel(self, transport, peer_id: str) -> bool:
        """Attach the reader end of a prefill replica's channel (its
        transport arrives pickled) landing on this engine's device."""
        from ray_tpu_torch.experimental.channel.transport import \
            attach_edge_transport

        self._strip.attach(attach_edge_transport(
            transport, 0, device=self.engine.device), peer_id)
        return True

    def _adopt(self, handoff: Dict[str, Any]) -> bool:
        """Landing-thread callback: graft one shipped prefill into the
        engine and publish it under its hand-off id.  A hand-off whose
        waiter already gave up is dropped instead of adopted."""
        hid = str(handoff.get("handoff_id") or handoff.get("request_id"))
        with self._landed_cond:
            if self._abandoned.pop(hid, None) is not None:
                self._late_handoffs += 1
                return False
        entry: Dict[str, Any] = {"request_id": None, "first_tokens":
                                 list(handoff.get("out_tokens", [])),
                                 "t": time.monotonic()}
        with self._lock:
            clock = _StageClock(self.engine.device)
            try:
                rid = self.engine.adopt_prefilled(handoff)
            except Exception:  # noqa: BLE001 — incompatible hand-off
                # still publish the failed entry so the stage-2 waiter
                # falls back at once instead of waiting out the hand-off
                rid = None
            self._handoffs.append({
                "handoff_id": hid,
                "land_ms": 1e3 * handoff.get("land_s", 0.0),
                "adopt": clock.stop()})
            if rid is not None:
                slot = {"event": threading.Event(), "output": None}
                tq: queue_mod.Queue = queue_mod.Queue()
                self._waiters[rid] = slot
                self._token_queues[rid] = tq
                self._last_submit = time.monotonic()
                entry.update(request_id=rid, slot=slot, queue=tq)
        with self._landed_cond:
            # re-check at publish time: the waiter may have given up
            # during the graft
            went_late = self._abandoned.pop(hid, None) is not None
            if went_late:
                self._late_handoffs += 1
            else:
                self._landed[hid] = entry
                self._landed_cond.notify_all()
        if went_late:
            rid = entry.get("request_id")
            if rid is not None:
                with self._lock:
                    self._abort_abandoned(rid)
                    self._token_queues.pop(rid, None)
            return False
        return entry["request_id"] is not None

    def _reap_stale(self) -> None:
        """Abort adopted requests whose hand-off was never claimed and age
        out abandoned-id markers: neither may grow forever."""
        now = time.monotonic()
        with self._landed_cond:
            stale = [hid for hid, e in self._landed.items()
                     if now - e.get("t", now) > self.LANDED_TTL_S]
            entries = [self._landed.pop(hid) for hid in stale]
            for hid in [h for h, t in self._abandoned.items()
                        if now - t > self.LANDED_TTL_S]:
                del self._abandoned[hid]
        for e in entries:
            rid = e.get("request_id")
            if rid is not None:
                with self._lock:
                    self._abort_abandoned(rid)
                    self._token_queues.pop(rid, None)

    def _wait_handoff(self, token: Optional[Dict[str, Any]],
                      budget: float) -> Optional[Dict[str, Any]]:
        """Bounded wait for this request's hand-off to land; None means
        the caller must re-prefill locally.  The ``llm.handoff`` fault
        site rides this edge (delay -> fallback)."""
        from ray_tpu_torch.util.fault_injection import fault_point

        fault_point("llm.handoff")
        hid = (token or {}).get("handoff_id")
        if hid is None:
            return None
        deadline = time.monotonic() + min(self.HANDOFF_WAIT_S, budget)
        with self._landed_cond:
            while hid not in self._landed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._landed_cond.wait(timeout=min(0.05, remaining))
            entry = self._landed.pop(hid, None)
            if entry is None:
                # giving up: a late landing must drop this hand-off, not
                # adopt a duplicate of the re-prefill we fall back to
                self._abandoned[str(hid)] = time.monotonic()
        if entry is None or entry["request_id"] is None:
            return None
        return entry

    # -- stage-2 request paths ----------------------------------------------

    def decode(self, token: Optional[Dict[str, Any]],
               body: Dict[str, Any]) -> Dict[str, Any]:
        budget = self._budget_s()
        deadline = time.monotonic() + budget
        entry = self._wait_handoff(token, budget)
        if entry is None:
            with self._landed_cond:
                self._fallback_reprefills += 1
            return self._generate(
                body, budget=max(0.0, deadline - time.monotonic()))
        rid, slot = entry["request_id"], entry["slot"]
        with self._lock:
            self._token_queues.pop(rid, None)  # unary: nobody drains it
        if not slot["event"].wait(
                timeout=max(0.0, deadline - time.monotonic())):
            with self._lock:
                self._abort_abandoned(rid)
            raise DeadlineExceededError(
                deployment=self._deployment, stage="decode", overrun_s=0.0)
        out = slot["output"]
        if out.error:
            raise RuntimeError(out.error)
        return {"generated_text": out.text,
                "num_generated_tokens": len(out.token_ids)}

    def decode_stream(self, token: Optional[Dict[str, Any]],
                      body: Dict[str, Any]):
        budget = self._budget_s()
        deadline = time.time() + budget
        entry = self._wait_handoff(token, budget)
        if entry is None:
            with self._landed_cond:
                self._fallback_reprefills += 1
            yield from self._stream(
                body, budget=max(0.0, deadline - time.time()))
            return
        rid, slot, tq = entry["request_id"], entry["slot"], entry["queue"]
        try:
            yield from self._stream_tokens(slot, tq, deadline,
                                           entry["first_tokens"])
        finally:
            with self._lock:
                self._token_queues.pop(rid, None)
                if not slot["event"].is_set():
                    self._abort_abandoned(rid)

    def __del__(self):
        self._teardown_engine_host()
        try:
            self._strip.stop(join_timeout_s=0.5)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


@serve.deployment(name="LLMIngress", max_ongoing_requests=64,
                  max_queued_requests=128)
class LLMDisaggIngress:
    """HTTP-facing ingress for the disaggregated topology: relays
    :class:`LLMServer`'s client API (unary ``__call__`` + SSE
    ``stream``) through the router's two-stage dispatch."""

    def __init__(self, prefill_handle, decode_handle,
                 max_reprefills: int = 1):
        from ray_tpu_torch.serve.router import TwoStageHandle

        self._two = TwoStageHandle(prefill_handle, decode_handle,
                                   max_reprefills=max_reprefills)

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._two.call(body)

    def stream(self, body: Dict[str, Any]):
        yield from self._two.stream(body)

    def stats(self) -> Dict[str, Any]:
        return dict(self._two.stats)


def build_llm_deployment(engine_kwargs: Optional[Dict[str, Any]] = None,
                         *, num_replicas: int = 1,
                         tensor_parallel_size: int = 1,
                         num_gpus_per_replica: float = 0):
    """Configured colocated LLM deployment.  ``num_gpus_per_replica > 0``
    binds each replica to a card of its own; with 0 a replica still runs
    on the card (``cuda:0``) unless ``engine_kwargs`` names a device."""
    opts: Dict[str, Any] = {"num_replicas": num_replicas}
    if num_gpus_per_replica:
        opts["ray_actor_options"] = {"num_gpus": num_gpus_per_replica}
    return LLMServer.options(**opts).bind(engine_kwargs, tensor_parallel_size)


def build_disaggregated_llm_deployment(
        engine_kwargs: Optional[Dict[str, Any]] = None, *,
        prefill_replicas: int = 1, decode_replicas: int = 1,
        tensor_parallel_size: int = 1, num_gpus_per_replica: float = 0,
        max_reprefills: int = 1):
    """The disaggregated topology as one application graph: ingress ->
    (prefill pool, decode pool).  ``serve.run`` deploys the pools with
    the ingress and hands the ingress their handles."""
    actor_opts = {"num_gpus": num_gpus_per_replica} \
        if num_gpus_per_replica else None
    p_opts: Dict[str, Any] = {"num_replicas": prefill_replicas}
    d_opts: Dict[str, Any] = {"num_replicas": decode_replicas}
    if actor_opts:
        p_opts["ray_actor_options"] = dict(actor_opts)
        d_opts["ray_actor_options"] = dict(actor_opts)
    prefill = LLMPrefillServer.options(**p_opts).bind(
        engine_kwargs, tensor_parallel_size)
    decode = LLMDecodeServer.options(**d_opts).bind(
        engine_kwargs, tensor_parallel_size)
    return LLMDisaggIngress.options(name="LLMIngress").bind(
        prefill, decode, max_reprefills=max_reprefills)


def disaggregated_handle(prefill_name: str = "LLMPrefill",
                         decode_name: str = "LLMDecode", *,
                         max_reprefills: int = 1):
    """Driver-side :class:`~ray_tpu_torch.serve.router.TwoStageHandle`
    over an already-deployed disaggregated pair: skips the ingress hop."""
    from ray_tpu_torch.serve.router import DeploymentHandle, TwoStageHandle

    return TwoStageHandle(DeploymentHandle(prefill_name),
                          DeploymentHandle(decode_name),
                          max_reprefills=max_reprefills)
