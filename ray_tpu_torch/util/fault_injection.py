"""Process-wide deterministic fault-injection registry.

Counterpart of ``ray_tpu/util/fault_injection.py``, copied whole (it is
standard library only) so the port arms its own sites without importing
the reference.  Control paths declare named **sites** by calling
:func:`fault_point("<site>")` on their hot edge (right before the
fallible I/O).  Tests arm a site to fail on its Nth call, through the
API::

    from ray_tpu_torch.util import fault_injection as fi
    with fi.armed("llm.kv_ship", nth=1, exc=ConnectionError("boom")):
        ...  # the 1st KV hand-off write in this process raises

or, for subprocesses, through the environment (the port's own variable,
so arming one package never arms the other)::

    RAY_TPU_TORCH_FAULT_INJECT="llm.kv_ship:1:2:connection"
    #                            site       :nth:count:kind[:arg]

Spec grammar: ``site:nth[:count[:kind[:arg...]]][@start+duration]``:
calls ``nth .. nth+count-1`` to the site trigger the ``kind`` (see
``_KINDS``); ``delay`` takes an ``arg`` (seconds) and ``slow`` takes
``factor[:duration_s]``.  Multiple specs join with ``;``.  Arming is
deterministic: a site fires on exact call indices, never randomly, so
chaos tests reproduce bit for bit.

The optional ``@start+duration`` suffix is **windowed (scheduled)
arming**: the site is armed ``start`` seconds after the spec is loaded
and disarms itself ``duration`` seconds later.  Calls outside the window
neither count nor fire, so the ``nth``/``count`` indices are
window-relative.  Through the API use :func:`arm_window`.

Sites wired in the port:

==========================  =================================================
site                        guards
==========================  =================================================
``llm.kv_ship``             every KV-handoff write on the prefill side
                            (``llm/kv_transfer.py``)
``collective.op``           every supervised collective op, before dispatch
                            (``util/collective/supervision.py``)
``collective.rendezvous``   the epoch/leader KV legs of group rendezvous
                            (``collective_group/torch_group.py``)
``train.checkpoint.commit`` between checkpoint staging and rename-commit
                            (``train/checkpoint_manager.py``)
``health.probe``            each iteration of the health probe's timed
                            matmul loop, and the monitor's dispatch of a
                            probe (``_private/health_plane.py``)
``llm.handoff``             the decode server's wait for a landed KV
                            hand-off, before it falls back to a local
                            re-prefill (``llm/serving.py``)
``serve.replica.call``      a replica's admission of each call, before
                            the user callable runs (``serve/replica.py``)
``serve.router.assign``     each dispatch attempt of the router
                            (``serve/router.py``)
``serve.proxy.admit``       the HTTP proxy's mint of each request's
                            context (``serve/proxy.py``)
==========================  =================================================

A spec armed on a card or slot (``_private/node_faults.py``) reaches
every process bound to it: its workers and the probes run there.

Three kinds are special:

- ``sigkill``: instead of raising, the armed call SIGKILLs the current
  process: a real mid-operation crash.  Use it through the environment
  in a subprocess, never in-process in a test runner.
- ``delay:<seconds>``: instead of raising, the armed call SLEEPS,
  injecting a hang rather than an error, so timeout paths are testable
  deterministically.  In the env spec the seconds ride the 5th field
  (``llm.kv_ship:1:1:delay:30``); through the API pass ``exc="delay:30"``.
- ``slow:<factor>[:<duration_s>]``: a *relative* hang: each armed call
  sleeps ``(factor - 1) x`` the site's **measured baseline** inter-call
  interval (an EWMA over the site's own cadence, net of the sleeps
  injected, so the slowdown never compounds on itself).  The optional
  ``duration_s`` auto-expires the effect that many seconds after the
  first firing call.  Through the API pass ``exc="slow:3"`` or
  ``exc="slow:3:20"``.  The first counted call only seeds the baseline
  and passes clean.

When nothing is armed, :func:`fault_point` is a single dict lookup,
cheap enough to leave in production paths.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, Optional, Union

ENV_VAR = "RAY_TPU_TORCH_FAULT_INJECT"


def _unavailable(site: str) -> Exception:
    # mirrors how a backend outage surfaces (status text inside a
    # RuntimeError)
    return RuntimeError(
        f"UNAVAILABLE: fault injected at {site} "
        "(simulated backend outage)")


def _sigkill(site: str) -> Exception:
    # a REAL crash, not an exception: the process dies mid-operation,
    # exactly like a preempted host — never returns
    import signal

    os.kill(os.getpid(), signal.SIGKILL)
    return RuntimeError(f"unreachable: sigkill at {site}")  # pragma: no cover


_KINDS = {
    "oserror": lambda site: OSError(f"fault injected at {site}"),
    "connection": lambda site: ConnectionError(f"fault injected at {site}"),
    "eof": lambda site: EOFError(f"fault injected at {site}"),
    "runtime": lambda site: RuntimeError(f"fault injected at {site}"),
    "unavailable": _unavailable,
    "sigkill": _sigkill,
}


class _Arm:
    __slots__ = ("nth", "count", "make", "delay", "calls", "fired",
                 "start", "until", "factor", "slow_dur", "baseline",
                 "last_call", "last_injected")

    def __init__(self, nth: int, count: int, make, delay=None,
                 start=None, until=None, factor=None, slow_dur=None):
        self.nth = nth      # 1-based call index of the first failure
        self.count = count  # how many consecutive calls fail
        self.make = make    # site -> Exception (None for delay kind)
        self.delay = delay  # seconds to sleep instead of raising
        self.calls = 0      # total fault_point() hits at this site
        self.fired = 0      # how many times the fault actually fired
        # windowed arming (monotonic deadlines): calls before `start`
        # are invisible (not counted); past `until` the arm is spent
        self.start = start
        self.until = until
        # slow kind: sleep (factor-1) x the site's measured baseline
        # inter-call interval; slow_dur auto-expires it after first fire
        self.factor = factor
        self.slow_dur = slow_dur
        self.baseline = None       # EWMA of natural inter-call seconds
        self.last_call = None      # monotonic ts of the previous call
        self.last_injected = 0.0   # sleep we added on the previous call

    def in_window(self, now: float) -> bool:
        if self.start is not None and now < self.start:
            return False
        if self.until is not None and now >= self.until:
            return False
        return True


_lock = threading.Lock()
_armed: Dict[str, _Arm] = {}


def _parse_window(part: str):
    """Split the optional ``@start+duration`` suffix off one spec part.
    Returns ``(spec_without_suffix, start_s, duration_s)`` where the
    times are None when no window rides the spec."""
    if "@" not in part:
        return part, None, None
    body, _, win = part.rpartition("@")
    start_s, plus, dur = win.partition("+")
    if not plus:
        raise ValueError(
            f"{ENV_VAR}: bad window {win!r} (want @start+duration)")
    return body, float(start_s), float(dur)


def _monotonic() -> float:
    import time

    return time.monotonic()


def _load_env() -> None:
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return
    now = _monotonic()
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        part, win_start, win_dur = _parse_window(part)
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"{ENV_VAR}: bad spec {part!r} (want site:nth[:count[:kind]])")
        site = fields[0]
        nth = int(fields[1])
        count = int(fields[2]) if len(fields) > 2 else 1
        kind = fields[3] if len(fields) > 3 else "connection"
        start = until = None
        if win_start is not None:
            start = now + win_start
            until = start + win_dur
        if kind == "delay":
            seconds = float(fields[4]) if len(fields) > 4 else 30.0
            _armed[site] = _Arm(nth, count, None, delay=seconds,
                                start=start, until=until)
            continue
        if kind == "slow":
            factor = float(fields[4]) if len(fields) > 4 else 3.0
            slow_dur = float(fields[5]) if len(fields) > 5 else None
            _armed[site] = _Arm(nth, count, None, factor=factor,
                                slow_dur=slow_dur, start=start, until=until)
            continue
        if kind not in _KINDS:
            raise ValueError(
                f"{ENV_VAR}: unknown kind {kind!r} "
                f"(expected 'delay', 'slow' or one of {sorted(_KINDS)})")
        _armed[site] = _Arm(nth, count, _KINDS[kind], start=start,
                            until=until)


_load_env()


def _resolve_exc(exc: Union[BaseException, type, str, None]):
    """``exc`` vocabulary -> ``(make, delay, factor, slow_dur)`` for an
    ``_Arm``."""
    if isinstance(exc, str) and (exc == "delay"
                                 or exc.startswith("delay:")):
        _, _, arg = exc.partition(":")
        return None, (float(arg) if arg else 30.0), None, None
    if isinstance(exc, str) and (exc == "slow" or exc.startswith("slow:")):
        _, _, arg = exc.partition(":")
        factor_s, _, dur_s = arg.partition(":")
        factor = float(factor_s) if factor_s else 3.0
        slow_dur = float(dur_s) if dur_s else None
        return None, None, factor, slow_dur
    if exc is None:
        return _KINDS["connection"], None, None, None
    if isinstance(exc, str):
        return _KINDS[exc], None, None, None
    if isinstance(exc, BaseException):
        return (lambda site, _e=exc: _e), None, None, None
    return (lambda site, _c=exc: _c(f"fault injected at {site}")), \
        None, None, None


def arm(site: str, *, nth: int = 1, count: int = 1,
        exc: Union[BaseException, type, str, None] = None) -> None:
    """Arm ``site`` so calls ``nth .. nth+count-1`` raise.

    ``exc`` may be an exception instance (raised as-is, repeatedly), an
    exception class (instantiated with a site message), a kind string
    from the env-var vocabulary (incl. ``"delay:<seconds>"`` — the armed
    calls SLEEP instead of raising, injecting a hang), or None
    (ConnectionError).
    """
    make, delay, factor, slow_dur = _resolve_exc(exc)
    with _lock:
        _armed[site] = _Arm(nth, count, make, delay=delay, factor=factor,
                            slow_dur=slow_dur)


def arm_window(site: str, start_s: float, duration_s: float, *,
               nth: int = 1, count: int = 1 << 30,
               exc: Union[BaseException, type, str, None] = None) -> None:
    """Windowed (scheduled) arming: ``site`` arms ``start_s`` seconds
    from now and disarms itself ``duration_s`` later.  Within the window
    the usual ``nth``/``count`` indices apply, counted from the window's
    first call (default: every in-window call fires): a scheduled fault
    with no babysitting disarm thread."""
    if duration_s <= 0:
        raise ValueError(f"arm_window: duration must be > 0, "
                         f"got {duration_s}")
    # the _Arm is built with its window in ONE publication: a two-step
    # arm-then-attach-window would leave the site live (windowless) for
    # a racing fault_point between the two lock acquisitions
    make, delay, factor, slow_dur = _resolve_exc(exc)
    start = _monotonic() + start_s
    with _lock:
        _armed[site] = _Arm(nth, count, make, delay=delay, factor=factor,
                            slow_dur=slow_dur, start=start,
                            until=start + duration_s)


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site (or all, when ``site`` is None)."""
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


@contextlib.contextmanager
def armed(site: str, *, nth: int = 1, count: int = 1,
          exc: Union[BaseException, type, str, None] = None) -> Iterator[None]:
    """Context-managed :func:`arm` — always disarms on exit."""
    arm(site, nth=nth, count=count, exc=exc)
    try:
        yield
    finally:
        disarm(site)


def call_count(site: str) -> int:
    """How many times ``fault_point(site)`` ran while the site was armed
    (0 for never-armed sites) — lets tests assert a site was exercised."""
    with _lock:
        a = _armed.get(site)
        return a.calls if a is not None else 0


def fired_count(site: str) -> int:
    """How many times the armed fault actually raised at ``site``."""
    with _lock:
        a = _armed.get(site)
        return a.fired if a is not None else 0


def fault_point(site: str) -> None:
    """Declare an injection site.  No-op unless ``site`` is armed; armed
    sites raise — or, for the ``delay`` kind, sleep — on their configured
    call indices (deterministic)."""
    if not _armed:  # fast path: nothing armed anywhere in the process
        return
    with _lock:
        a = _armed.get(site)
        if a is None:
            return
        now = None
        if a.start is not None or a.until is not None \
                or a.factor is not None:
            now = _monotonic()
        if a.start is not None or a.until is not None:
            if not a.in_window(now):
                return  # outside the window: invisible, not counted
        a.calls += 1
        if a.factor is not None:
            # track the site's natural cadence, net of our own injected
            # sleeps, so the baseline never compounds on the slowdown
            if a.last_call is not None:
                dt = max(0.0, now - a.last_call - a.last_injected)
                a.baseline = dt if a.baseline is None \
                    else 0.7 * a.baseline + 0.3 * dt
            a.last_call = now
            a.last_injected = 0.0
            if not (a.nth <= a.calls < a.nth + a.count):
                return
            if a.baseline is None or a.baseline <= 0.0:
                return  # first counted call only seeds the baseline
            a.fired += 1
            injected = (a.factor - 1.0) * a.baseline
            a.last_injected = injected
            if a.slow_dur is not None and a.until is None:
                # the effect auto-expires slow_dur after its first fire
                a.until = now + a.slow_dur
            delay, err = injected, None
        elif a.nth <= a.calls < a.nth + a.count:
            a.fired += 1
            if a.delay is not None:
                delay, err = a.delay, None
            else:
                err = a.make(site)
        else:
            return
    if err is None:
        import time

        time.sleep(delay)  # an injected hang, outside the lock
        return
    raise err
