"""DeploymentHandle + power-of-two-choices replica routing (counterpart of
``ray_tpu/serve/router.py``).

Sample two replicas, probe their queue lengths (with a short-lived
cache), send to the shorter queue.  The router is the serving path's
admission valve: it tracks its own dispatched-but-unfinished count per
replica and never sends a replica more than ``max_ongoing_requests``;
excess requests wait in a bounded router-side queue
(``max_queued_requests``), and once that is full new arrivals fail fast
with ``BackPressureError``.  A request whose deadline is spent is
rejected before dispatch.

The port's router reads the replica set from the serve store
(``serve/controller.py``), so a router in any process works alike: the
driver, the proxy, a replica holding nested handles.  A dispatched
call's slot is released by the call's own completion callback (its
result, its error, or its replica's death), so no watcher thread is
needed.  Multiplexed model routing waits (ROADMAP).
"""

from __future__ import annotations

import collections
import contextlib
import json
import pickle
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.exceptions import (ActorDiedError, BackPressureError,
                                      DeadlineExceededError)
from ray_tpu_torch.serve.context import (OverloadStats, RequestContext,
                                         current_context, scope)
from ray_tpu_torch.util.fault_injection import fault_point


def _assign_retryable(err: BaseException) -> bool:
    """Dispatch-time failures worth a refresh and a retry: a replica that
    is gone (the controller repopulates the set) and the empty-replica
    window of a restart.  Overload verdicts are never retried here: a
    shed means the queue is full, a spent deadline only gets more
    spent."""
    if isinstance(err, (BackPressureError, DeadlineExceededError)):
        return False
    return isinstance(err, ActorDiedError) or "has no replicas" in str(err)


class DeploymentResponse:
    """Future-like result of ``handle.remote()``."""

    def __init__(self, call):
        self._call = call

    def result(self, timeout: Optional[float] = None):
        return self._call.result(timeout=timeout)

    def cancel(self) -> None:
        """Ask the replica to drop the call if it has not started."""
        self._call.cancel()

    @property
    def call(self):
        return self._call


class Router:
    """Pow-2 replica chooser with a queue-length cache and a bounded
    admission queue."""

    QUEUE_LEN_CACHE_S = 2.0
    # replica-set reads ride the request path: capped so the hot path is
    # not one store round trip per request
    VERSION_CHECK_INTERVAL_S = 0.5
    QUEUE_POLL_S = 0.05
    ASSIGN_ATTEMPTS = 3
    ASSIGN_BACKOFF_S = 0.05

    def __init__(self, deployment_name: str, store):
        self._deployment = deployment_name
        self._store = store
        self._replicas: List[Any] = []
        self._max_ongoing: Optional[int] = None
        self._max_queued: int = -1
        self._version = -1
        self._qlen_cache: Dict[str, tuple] = {}  # replica id -> (len, expiry)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight: Dict[str, int] = {}
        self._queued = 0
        # slot releases from _SlotReleasingStream.__del__: a GC finalizer
        # must not take the router lock (it could fire while this thread
        # holds it), so it appends here and the next assign drains it
        self._orphan_releases: collections.deque = collections.deque()
        self._overload = OverloadStats()
        self._reporter_id = uuid.uuid4().hex[:12]
        self._last_reported: Optional[Dict[str, int]] = None
        self._rng = random.Random()
        self._last_version_check = 0.0
        self.refresh()

    @property
    def overload_stats(self) -> OverloadStats:
        return self._overload

    def refresh(self) -> None:
        from ray_tpu_torch.serve.controller import deployment_key

        raw = self._store.get(deployment_key(self._deployment))
        if raw is None:
            raise KeyError(f"no deployment {self._deployment!r}")
        info = pickle.loads(raw)
        with self._lock:
            if info["version"] != self._version:
                self._replicas = info["replicas"]
                self._qlen_cache.clear()
            self._max_ongoing = info["max_ongoing_requests"]
            self._max_queued = info.get("max_queued_requests", -1)
            self._version = info["version"]
            self._cond.notify_all()  # new replicas may mean new capacity

    def _maybe_refresh(self) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_version_check < self.VERSION_CHECK_INTERVAL_S:
                return
            self._last_version_check = now
        try:
            self.refresh()
        except (KeyError, RuntimeError, OSError):
            return  # opportunistic: the next interval retries
        self._report_overload()

    def _report_overload(self) -> None:
        """Publish this router's counters into the serve store when they
        changed (``serve.status()`` sums the reporters)."""
        from ray_tpu_torch.serve.controller import overload_prefix

        snap = self._overload.snapshot()
        if snap == self._last_reported:
            return
        self._last_reported = snap
        try:
            self._store.put(overload_prefix(self._deployment)
                            + self._reporter_id, json.dumps(snap).encode())
        except (RuntimeError, OSError):
            pass  # visibility never fails a request

    def _probe(self, replica) -> int:
        key = replica.replica_id
        now = time.monotonic()
        with self._lock:
            hit = self._qlen_cache.get(key)
            if hit and hit[1] > now:
                return hit[0]
        try:
            # short: the probe rides the dispatch path, so an unreachable
            # replica costs one bounded stall per cache window
            qlen = replica.control("get_queue_len", timeout=1.5)
        except Exception:  # noqa: BLE001 — unreachable: never prefer it
            qlen = 1 << 30
        with self._lock:
            self._qlen_cache[key] = (qlen, now + self.QUEUE_LEN_CACHE_S)
        return qlen

    # ------------------------------------------------------------- admission

    def _replicas_snapshot(self) -> List[Any]:
        with self._lock:
            reps = list(self._replicas)
        if not reps:
            self._maybe_refresh()
            with self._lock:
                reps = list(self._replicas)
            if not reps:
                raise RuntimeError(
                    f"deployment {self._deployment!r} has no replicas")
        return reps

    def _acquire_replica(self, ctx):
        """Admission valve: pick a replica with spare capacity and reserve
        one slot on it.  When every replica is saturated the caller waits
        in the bounded router queue; a full queue sheds the request with
        ``BackPressureError`` and a spent deadline drops it with
        ``DeadlineExceededError``, both before any replica sees it."""
        queued = False
        try:
            while True:
                self._drain_orphans()
                reps = self._replicas_snapshot()
                with self._lock:
                    limit = self._max_ongoing or 1
                    candidates = [r for r in reps if self._inflight.get(
                        r.replica_id, 0) < limit]
                if candidates:
                    pick = self._pow2(candidates)
                    with self._lock:
                        key = pick.replica_id
                        if self._inflight.get(key, 0) < (self._max_ongoing
                                                         or 1):
                            self._inflight[key] = \
                                self._inflight.get(key, 0) + 1
                            return pick
                    continue  # lost the reservation race: re-pick
                with self._cond:
                    if not queued:
                        if 0 <= self._max_queued <= self._queued:
                            self._overload.note_shed()
                            raise BackPressureError(
                                deployment=self._deployment,
                                queued=self._queued,
                                limit=self._max_queued, retry_after_s=1.0)
                        self._queued += 1
                        self._overload.note_queued(+1)
                        queued = True
                    if ctx is not None and ctx.expired():
                        self._overload.note_expired()
                        raise DeadlineExceededError(
                            request_id=ctx.request_id,
                            deployment=self._deployment,
                            stage="router-queue", overrun_s=ctx.overrun_s())
                    wait_s = self.QUEUE_POLL_S
                    if ctx is not None:
                        remaining = ctx.remaining_s()
                        if remaining is not None:
                            wait_s = max(0.0, min(wait_s, remaining))
                    self._cond.wait(timeout=wait_s)
                self._maybe_refresh()  # a restart may have added capacity
        finally:
            if queued:
                with self._cond:
                    self._queued -= 1
                    self._overload.note_queued(-1)

    def _release(self, key: str) -> None:
        with self._cond:
            n = self._inflight.get(key, 0)
            if n <= 1:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n - 1
            self._cond.notify_all()

    def _drain_orphans(self) -> None:
        while True:
            try:
                key = self._orphan_releases.popleft()
            except IndexError:
                return
            self._release(key)

    def inflight_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    def _pow2(self, reps: List[Any]):
        if len(reps) == 1:
            return reps[0]
        i, j = self._rng.sample(range(len(reps)), 2)
        return reps[i] if self._probe(reps[i]) <= self._probe(reps[j]) \
            else reps[j]

    def _note_dispatch(self, replica) -> None:
        """Bump the cached queue length so back-to-back requests spread."""
        with self._lock:
            hit = self._qlen_cache.get(replica.replica_id)
            if hit:
                self._qlen_cache[replica.replica_id] = (hit[0] + 1, hit[1])

    def note_cancelled(self) -> None:
        self._overload.note_cancelled()

    def note_shed(self) -> None:
        self._overload.note_shed()

    def note_expired(self) -> None:
        self._overload.note_expired()

    # ------------------------------------------------------------- dispatch

    def _assign_with_retry(self, dispatch):
        """Shared harness for unary and streaming dispatch: a gone replica
        refreshes the set and retries with backoff; other errors
        (overload verdicts included) surface at once.  Returns ``(call,
        replica key)``."""
        for attempt in range(self.ASSIGN_ATTEMPTS):
            ctx = current_context()
            if ctx is not None and ctx.expired():
                self._overload.note_expired()
                raise DeadlineExceededError(
                    request_id=ctx.request_id, deployment=self._deployment,
                    stage="router", overrun_s=ctx.overrun_s())
            try:
                fault_point("serve.router.assign")
                self._maybe_refresh()
                replica = self._acquire_replica(ctx)
                key = replica.replica_id
                try:
                    call = dispatch(replica,
                                    None if ctx is None else ctx.to_dict())
                except BaseException:
                    self._release(key)
                    raise
                self._note_dispatch(replica)
                return call, key
            except Exception as e:  # noqa: BLE001 — classified
                if attempt + 1 >= self.ASSIGN_ATTEMPTS \
                        or not _assign_retryable(e):
                    raise
                time.sleep(self.ASSIGN_BACKOFF_S * 2 ** attempt)
                with contextlib.suppress(KeyError, RuntimeError, OSError):
                    self.refresh()

    def assign(self, method: str, args: tuple, kwargs: dict):
        call, key = self._assign_with_retry(
            lambda replica, ctx_d: replica.handle_request(
                method, args, kwargs, request_context=ctx_d))
        call.add_done_callback(lambda: self._release(key))
        return call

    def assign_streaming(self, method: str, args: tuple, kwargs: dict):
        """Route one streaming request; the stream gives its slot back
        when it ends, errors, is closed or is dropped."""
        call, key = self._assign_with_retry(
            lambda replica, ctx_d: replica.handle_request_streaming(
                method, args, kwargs, request_context=ctx_d))
        return _SlotReleasingStream(call, self, key)

    # ------------------------------------------------- targeted dispatch
    #
    # Two-stage (disaggregated) serving needs the replica choice and the
    # dispatch apart: the decode replica is reserved before prefill
    # starts, because the prefill stage ships KV blocks to that replica's
    # channel.  Same slot accounting, queueing and shed as assign().

    def acquire_replica(self, ctx=None):
        """Reserve one admission slot on a chosen replica; returns
        ``(replica, key)``.  The caller must end the reservation by
        ``dispatch_to`` or ``release_replica``."""
        self._maybe_refresh()
        replica = self._acquire_replica(ctx)
        return replica, replica.replica_id

    def release_replica(self, key: str) -> None:
        self._release(key)

    def dispatch_to(self, replica, key: str, method: str, args: tuple,
                    kwargs: dict, *, streaming: bool = False):
        """Dispatch to an already-reserved replica: a call (its slot
        released on completion) or a ``_SlotReleasingStream``."""
        ctx = current_context()
        ctx_d = None if ctx is None else ctx.to_dict()
        try:
            if streaming:
                out = replica.handle_request_streaming(
                    method, args, kwargs, request_context=ctx_d)
            else:
                out = replica.handle_request(method, args, kwargs,
                                             request_context=ctx_d)
        except BaseException:
            self._release(key)
            raise
        self._note_dispatch(replica)
        if streaming:
            return _SlotReleasingStream(out, self, key)
        out.add_done_callback(lambda: self._release(key))
        return out


class _SlotReleasingStream:
    """Iterator proxy over a streaming call that gives the replica's
    admission slot back exactly once: on exhaustion, error, explicit
    close, or garbage collection."""

    def __init__(self, stream, router: Router, key: str):
        self._stream = stream
        self._router = router
        self._key = key
        self._released = False

    def _release(self):
        if not self._released:
            self._released = True
            self._router._release(self._key)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._stream)
        except BaseException:
            self._release()
            raise

    def close(self):
        """Stop the stream: cancels the replica's producer."""
        try:
            self._stream.close()
        finally:
            self._release()

    def __del__(self):
        # GC context: must not take the router lock
        if not self._released:
            self._released = True
            self._router._orphan_releases.append(self._key)


class DeploymentHandle:
    """Client-side handle; composition-safe (picklable into replicas)."""

    # one router per (process, deployment), shared by handle copies
    _routers: Dict[str, Router] = {}
    _routers_lock = threading.Lock()

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self._deployment = deployment_name
        self._method = method_name

    def __reduce__(self):
        return (DeploymentHandle, (self._deployment, self._method))

    @property
    def deployment_name(self) -> str:
        return self._deployment

    def options(self, method_name: Optional[str] = None
                ) -> "DeploymentHandle":
        return DeploymentHandle(self._deployment,
                                method_name if method_name is not None
                                else self._method)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._deployment, name)

    def _get_router(self) -> Router:
        with DeploymentHandle._routers_lock:
            router = DeploymentHandle._routers.get(self._deployment)
            if router is None:
                from ray_tpu_torch.serve.controller import serve_store

                router = Router(self._deployment, serve_store())
                DeploymentHandle._routers[self._deployment] = router
            return router

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return DeploymentResponse(
            self._get_router().assign(self._method, args, kwargs))

    def remote_streaming(self, *args, **kwargs
                         ) -> "DeploymentStreamingResponse":
        """Call a generator method of the deployment; iterate the result
        to receive items as the replica yields them."""
        return DeploymentStreamingResponse(
            self._get_router().assign_streaming(self._method, args, kwargs))


class DeploymentStreamingResponse:
    """Iterator over a streaming deployment call's yielded values."""

    def __init__(self, stream):
        self._stream = stream

    def __iter__(self):
        return iter(self._stream)

    def close(self) -> None:
        self._stream.close()


class TwoStageHandle:
    """Disaggregated two-stage dispatch: prefill -> handoff token -> decode.

    Stage 1 goes through the prefill deployment's ordinary router.  The
    decode replica is reserved first (the prefill stage ships KV blocks
    into that replica's landing channel), then stage 2 dispatches the
    handoff token to the reserved replica, unary or streaming, so the
    token fan-out the client sees is the colocated path's.

    A decode replica that dies mid-request (or mid-stream) triggers a
    bounded re-prefill: the whole flow re-runs on a healthy pair within
    the request's remaining deadline, counted in ``reprefills``;
    already-delivered stream chunks are deduplicated by index.  Overload
    verdicts from either stage surface unchanged.
    """

    # stage-1 bound for deadline-less direct use: a wedged prefill
    # replica must surface as an error, not a permanent hang
    DEFAULT_STAGE_TIMEOUT_S = 300.0

    def __init__(self, prefill: DeploymentHandle, decode: DeploymentHandle,
                 *, prefill_method: str = "prefill",
                 decode_method: str = "decode",
                 decode_stream_method: str = "decode_stream",
                 max_reprefills: int = 1):
        self._prefill = prefill
        self._decode = decode
        self._m1 = prefill_method
        self._m2 = decode_method
        self._m2s = decode_stream_method
        self._max_reprefills = max_reprefills
        self.stats = {"requests": 0, "reprefills": 0}

    def _remaining(self, ctx, deadline: Optional[float] = None) -> float:
        """Remaining budget: the tighter of the request context's deadline
        and the caller's explicit bound (monotonic)."""
        rem = self.DEFAULT_STAGE_TIMEOUT_S
        if ctx is not None:
            ctx_rem = ctx.remaining_s()
            if ctx_rem is not None:
                rem = max(0.0, ctx_rem)
        if deadline is not None:
            rem = min(rem, max(0.0, deadline - time.monotonic()))
        return rem

    def _dispatch(self, body, *, streaming: bool,
                  deadline: Optional[float] = None):
        """One full two-stage attempt; returns the stage-2 call/stream."""
        ctx = current_context()
        r2 = self._decode._get_router()
        replica, key = r2.acquire_replica(ctx)
        try:
            token = self._prefill.options(method_name=self._m1).remote(
                body, replica).result(timeout=self._remaining(ctx, deadline))
        except BaseException:
            r2.release_replica(key)
            raise
        return r2.dispatch_to(
            replica, key, self._m2s if streaming else self._m2,
            (token, body), {}, streaming=streaming)

    def _retryable(self, err: BaseException, ctx,
                   deadline: Optional[float] = None) -> bool:
        """A mid-flight replica death is worth a re-prefill on a healthy
        pair; overload verdicts, spent budgets and non-``Exception``
        BaseExceptions (a client disconnect's ``GeneratorExit``) are
        not."""
        if not isinstance(err, Exception):
            return False
        if isinstance(err, (BackPressureError, DeadlineExceededError)):
            return False
        if ctx is not None and ctx.expired():
            return False
        if deadline is not None and time.monotonic() >= deadline:
            return False
        return True

    def _pre_retry(self) -> None:
        """Refresh the decode replica set (the controller prunes a dead
        replica within a tick) and back off briefly."""
        with contextlib.suppress(KeyError, RuntimeError, OSError):
            self._decode._get_router().refresh()
        time.sleep(0.25)

    def call(self, body, timeout: Optional[float] = None):
        """Blocking unary request through both stages.  ``timeout`` bounds
        the whole call including re-prefills; with no surrounding request
        scope a deadline-carrying context is minted from it, so both
        pools' router-queue waits honour the bound too."""
        self.stats["requests"] += 1
        ctx = current_context()
        deadline = None if timeout is None else time.monotonic() + timeout
        minted = contextlib.nullcontext()
        if ctx is None and timeout is not None:
            ctx = RequestContext(uuid.uuid4().hex,
                                 deadline_s=time.time() + timeout)
            minted = scope(ctx)
        attempts = self._max_reprefills + 1
        with minted:
            for attempt in range(attempts):
                try:
                    call = self._dispatch(body, streaming=False,
                                          deadline=deadline)
                    return call.result(timeout=self._remaining(ctx,
                                                               deadline))
                except BaseException as e:  # noqa: BLE001 — classified
                    if attempt + 1 >= attempts \
                            or not self._retryable(e, ctx, deadline):
                        raise
                    self.stats["reprefills"] += 1
                    self._pre_retry()

    @staticmethod
    def _stream_resumable(body) -> bool:
        """Resuming after a mid-stream death splices chunks from two
        generations: coherent only for greedy decoding (temperature 0;
        an absent field is the engine's default 0.7, sampled)."""
        if not isinstance(body, dict):
            return False
        try:
            return float(body.get("temperature", 0.7) or 0.0) == 0.0
        except (TypeError, ValueError):
            return False

    def stream(self, body):
        """Streaming request: yields the decode replica's chunks (each
        carries ``index``; the last carries ``done``).  A decode death
        mid-stream re-prefills and resumes from the first undelivered
        index, for greedy streams; a sampled stream that already
        delivered chunks surfaces the error."""
        self.stats["requests"] += 1
        ctx = current_context()
        attempts = self._max_reprefills + 1
        delivered = 0
        for attempt in range(attempts):
            stream = None
            try:
                stream = self._dispatch(body, streaming=True)
                for chunk in stream:
                    if chunk.get("done"):
                        yield chunk
                        return
                    idx = chunk.get("index", delivered)
                    if idx < delivered:
                        continue  # replayed after a re-prefill: dedup
                    delivered = idx + 1
                    yield chunk
                return  # ended without a done marker: complete
            except BaseException as e:  # noqa: BLE001 — classified below
                if attempt + 1 >= attempts or not self._retryable(e, ctx) \
                        or (delivered > 0
                            and not self._stream_resumable(body)):
                    raise
                self.stats["reprefills"] += 1
                self._pre_retry()
            finally:
                if stream is not None:
                    stream.close()  # its slot back, its producer stopped
