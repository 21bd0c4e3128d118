"""HTTP proxy: routes requests to deployments (counterpart of
``ray_tpu/serve/proxy.py``).

The reference's proxy is an actor running an aiohttp server; the port's
is a thread of the driver running the standard library's
``http.server.ThreadingHTTPServer`` (one thread per request), so it
needs no package the card's machine lacks.

Request contract: ``GET/POST {route_prefix}[/suffix]``: the deployment's
``__call__`` receives the JSON body (POST) or the query-parameter dict
(GET); the JSON of its return value is the response body.  With
``Accept: text/event-stream`` or ``?stream=1`` (and an optional
``?method=`` naming a generator method) the items of a streaming call
come back as Server-Sent Events, one ``data:`` event per item.

Every route mints a :class:`RequestContext` (the ``serve.proxy.admit``
fault site rides that edge) whose deadline comes from the client's
``X-Request-Timeout-S`` header capped by the proxy's
``request_timeout_s``.  A shed maps to 503 + ``Retry-After``, a spent
budget to 504, any other error to 500.  A client that drops a stream
releases the router's slot and cancels the replica's producer
(:class:`AbandonTracker`); one that drops a unary request cancels it if
it has not started.
"""

from __future__ import annotations

import json
import select
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl, urlsplit

from ray_tpu_torch.serve.context import new_request_context, scope
from ray_tpu_torch.util.fault_injection import fault_point


def classify_request_error(e: BaseException) -> str:
    """Map a serving-path exception to a degradation kind: ``"shed"``
    (admission rejected: retryable by the client later), ``"expired"``
    (deadline spent), ``"cancelled"``, or ``"error"``."""
    from ray_tpu_torch.exceptions import (BackPressureError,
                                          DeadlineExceededError,
                                          GetTimeoutError,
                                          TaskCancelledError)

    if isinstance(e, BackPressureError):
        return "shed"
    if isinstance(e, (DeadlineExceededError, GetTimeoutError)):
        return "expired"
    if isinstance(e, TaskCancelledError):
        return "cancelled"
    return "error"


class AbandonTracker:
    """Cancellation rendezvous between a route handler and its dispatch:
    whichever of ``bind()`` (the dispatch bound a response) and
    ``abandon()`` (the client went away) happens second performs the
    cancel, so an abandon always reaches the call however long admission
    took."""

    def __init__(self, note_cancelled, cancel_fn):
        self._lock = threading.Lock()
        self._note = note_cancelled
        self._cancel_fn = cancel_fn
        self._resp = None
        self._abandoned = False
        self._cancelled = False

    @property
    def resp(self):
        return self._resp

    def bind(self, resp) -> None:
        with self._lock:
            self._resp = resp
            do = self._abandoned and not self._cancelled
            if do:
                self._cancelled = True
        if do:
            self._cancel()

    def abandon(self) -> None:
        with self._lock:
            self._abandoned = True
            do = self._resp is not None and not self._cancelled
            if do:
                self._cancelled = True
        if do:
            self._cancel()

    def _cancel(self) -> None:
        try:
            self._cancel_fn(self._resp)
        except Exception:  # noqa: BLE001 — already finished
            pass
        try:
            self._note()
        except Exception:  # noqa: BLE001 — visibility never masks teardown
            pass


class HTTPProxy:
    """The proxy's server and route table (read from the serve store)."""

    ROUTES_REFRESH_S = 2.0
    # how often a unary handler waiting on its result checks whether the
    # client is still connected
    ABANDON_POLL_S = 0.1

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 request_timeout_s: float = 120.0,
                 max_concurrent_requests: int = 256):
        self.request_timeout_s = request_timeout_s
        self.max_concurrent = max_concurrent_requests
        self._active = 0
        self._lock = threading.Lock()
        self._routes: Dict[str, str] = {}
        self._routes_at = 0.0
        self._handles: Dict[Any, Any] = {}
        proxy = self

        class _Handler(_RouteHandler):
            pass

        _Handler.proxy = proxy
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="serve-proxy")
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    # -- routing -------------------------------------------------------------

    def _refresh_routes(self, force: bool = False) -> None:
        import time

        from ray_tpu_torch.serve.controller import ROUTES_KEY, serve_store

        now = time.monotonic()
        if not force and now - self._routes_at < self.ROUTES_REFRESH_S:
            return
        try:
            raw = serve_store().get(ROUTES_KEY)
            self._routes = json.loads(raw) if raw else {}
        except (RuntimeError, OSError, ValueError):
            pass  # keep serving the stale table
        self._routes_at = now

    def resolve(self, path: str) -> Optional[str]:
        """The deployment of the longest route prefix matching ``path``."""
        for force in (False, True):
            self._refresh_routes(force)
            best = None
            for prefix, dep in self._routes.items():
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, dep)
            if best is not None:
                return best[1]
        return None

    def handle_for(self, deployment: str, method: str = "__call__"):
        """A handle cached per (deployment, method), so the router's
        queue-length cache survives across requests."""
        key = (deployment, method)
        h = self._handles.get(key)
        if h is None:
            from ray_tpu_torch.serve.router import DeploymentHandle

            h = self._handles[key] = DeploymentHandle(deployment, method)
        return h

    def note_degradation(self, deployment: str, kind: str) -> None:
        """Count a shed/expiry/cancel the proxy saw against the
        deployment's router (which owns the counters)."""
        try:
            router = self.handle_for(deployment)._get_router()
        except Exception:  # noqa: BLE001 — visibility never masks the error
            return
        if kind == "cancelled":
            router.note_cancelled()
        elif kind == "expired":
            router.note_expired()
        elif kind == "shed":
            router.note_shed()

    def _mint_context(self, headers):
        """One RequestContext per route invocation: the client may
        shorten the budget with ``X-Request-Timeout-S``, never extend it
        past ``request_timeout_s``."""
        fault_point("serve.proxy.admit")
        timeout_s = self.request_timeout_s
        hdr = headers.get("X-Request-Timeout-S", "")
        if hdr:
            try:
                timeout_s = max(0.0, min(float(hdr), timeout_s))
            except ValueError:
                pass
        return new_request_context(
            timeout_s=timeout_s,
            request_id=headers.get("X-Request-Id") or None)

    def admit(self) -> bool:
        with self._lock:
            if self._active >= self.max_concurrent:
                return False
            self._active += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._active -= 1


class _RouteHandler(BaseHTTPRequestHandler):
    proxy: HTTPProxy
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: one line per request is noise
        pass

    def do_GET(self):
        self.handler()

    def do_POST(self):
        self.handler()

    # -- responses -----------------------------------------------------------

    def _json(self, status: int, obj: Any,
              headers: Optional[Dict[str, str]] = None) -> None:
        try:
            data = json.dumps(obj).encode()
            ctype = "application/json"
        except TypeError:
            data, ctype = str(obj).encode(), "text/plain; charset=utf-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error_response(self, e: BaseException, deployment: str) -> None:
        kind = classify_request_error(e)
        if kind == "shed":
            retry_after = getattr(e, "retry_after_s", 1.0)
            self._json(503, {"error": repr(e), "retry_after_s": retry_after},
                       {"Retry-After": str(max(1, int(retry_after)))})
        elif kind == "expired":
            from ray_tpu_torch.exceptions import DeadlineExceededError

            # a DeadlineExceededError was counted where it was raised;
            # only count expiries the proxy itself observed
            if not isinstance(e, DeadlineExceededError):
                self.proxy.note_degradation(deployment, "expired")
            self._json(504, {"error": repr(e)})
        else:
            self._json(500, {"error": repr(e)})

    def _client_gone(self) -> bool:
        """True when the client closed its end (readable with no data)."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            import socket

            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    # -- the route -----------------------------------------------------------

    def handler(self) -> None:
        url = urlsplit(self.path)
        if url.path == "/-/healthz":
            self._json(200, {"status": "ok"})
            return
        proxy = self.proxy
        dep = proxy.resolve(url.path)
        if dep is None:
            self._json(404, {"error": f"no deployment for {url.path}"})
            return
        if not proxy.admit():
            proxy.note_degradation(dep, "shed")
            self._json(503, {"error": "proxy at max_concurrent_requests "
                             f"({proxy.max_concurrent})",
                             "retry_after_s": 1.0}, {"Retry-After": "1"})
            return
        try:
            self._routed(url, dep)
        finally:
            proxy.release()

    def _routed(self, url, dep: str) -> None:
        proxy = self.proxy
        query = dict(parse_qsl(url.query))
        if self.command == "POST":
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                body = json.loads(raw or b"null")
            except ValueError:
                body = raw.decode("utf-8", "replace")
        else:
            body = query
        # the request's end-to-end budget + id, minted once per route and
        # carried through router -> replica -> nested handles
        ctx = proxy._mint_context(self.headers)
        wants_stream = ("text/event-stream" in self.headers.get("Accept", "")
                        or query.get("stream") in ("1", "true"))
        method = query.get("method")
        if wants_stream:
            handle = proxy.handle_for(
                dep, method if method and not method.startswith("_")
                else "__call__")
            self._stream_sse(handle, body, ctx, dep)
            return
        handle = proxy.handle_for(dep)
        tracker = AbandonTracker(
            lambda: proxy.note_degradation(dep, "cancelled"),
            lambda resp: resp.cancel())
        try:
            with scope(ctx):
                resp = handle.remote(body)
            tracker.bind(resp)
            out = self._wait(resp, ctx, tracker)
        except Exception as e:  # noqa: BLE001 — mapped to a status
            if classify_request_error(e) == "expired" \
                    and tracker.resp is not None:
                tracker.resp.cancel()
            self._error_response(e, dep)
            return
        if out is not None:
            self._json(200, out[0])

    def _wait(self, resp, ctx, tracker):
        """The result within the request's budget, checking every
        ``ABANDON_POLL_S`` that the client still waits; None (after
        cancelling) when it left."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        while True:
            remaining = ctx.remaining_s()
            step = self.proxy.ABANDON_POLL_S if remaining is None \
                else max(0.0, min(self.proxy.ABANDON_POLL_S, remaining))
            try:
                return (resp.result(timeout=step),)
            except GetTimeoutError:
                if remaining is not None and remaining <= step:
                    raise
            if self._client_gone():
                tracker.abandon()
                return None

    def _stream_sse(self, handle, body, ctx, dep: str) -> None:
        """Proxy a streaming deployment call as Server-Sent Events."""
        proxy = self.proxy
        tracker = AbandonTracker(
            lambda: proxy.note_degradation(dep, "cancelled"),
            lambda resp: resp.close())
        try:
            with scope(ctx):
                resp = handle.remote_streaming(body)
            tracker.bind(resp)
            stream = iter(resp)
        except Exception as e:  # noqa: BLE001 — mapped to a status
            self._error_response(e, dep)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for item in stream:
                try:
                    frame = json.dumps(item)
                except TypeError:
                    frame = json.dumps({"text": str(item)})
                self.wfile.write(f"data: {frame}\n\n".encode())
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the client dropped the stream mid-write: stop the producer
            tracker.abandon()
            return
        except Exception as e:  # noqa: BLE001 — reported in-band
            try:
                self.wfile.write(
                    f"event: error\ndata: {json.dumps(repr(e))}\n\n".encode())
            except OSError:
                pass
        finally:
            resp.close()
