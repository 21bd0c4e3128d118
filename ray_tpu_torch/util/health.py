"""Health-plane primitives: robust outlier math, verdict records, and
the passive signal extractors the straggler detector scores.

Counterpart of ``ray_tpu/util/health.py``, copied whole where it is pure
math: the median/MAD outlier test and its hysteresis, the step-record
scorer, pending ages, the edge-latency EWMA, the SDC canary (an int64
numpy chain, bit-exact on every host) and the verdict records.  The
driving loop is ``ray_tpu_torch._private.health_plane.HealthMonitor``.

Two functions differ from the reference:

- :func:`device_memory_stats` reads ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info`` for this process's cards, and returns
  ``[]`` when the process has not initialised CUDA;
- :func:`publish_health_verdict` writes into the run's key-value store
  (``_private/kv.py``) under ``health/verdict/<kind>/<subject>``, where
  the reference writes the GCS's KV.

Verdict ladder: ``HEALTHY -> SUSPECT -> QUARANTINED``.  Passive scoring
alone only reaches SUSPECT; QUARANTINED requires active confirmation
(probe or SDC canary) by the monitor.  The unit on the ladder is the
card a worker is bound to (``"cuda:<index>"``), or a host worker's slot
(``"slot:<index>"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

# verdict records older than this are swept from listings — the same
# observability window the SLO / collective records use
STALE_S = 600.0

_KV_PREFIX = "health/verdict/"

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
QUARANTINED = "QUARANTINED"

# |x - median| / (1.4826 * MAD) is ~ a z-score under normality; 1.4826
# is the consistency constant making MAD estimate sigma
_MAD_SIGMA = 1.4826
# MAD collapses to 0 on near-identical samples (every clean synthetic
# trace); below this scale we fall back to a noise floor of 5% of the
# median so a clean cluster scores ~0 instead of dividing by zero
_NOISE_FLOOR_FRAC = 0.05


# ---------------------------------------------------------------------------
# robust statistics
# ---------------------------------------------------------------------------


def median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty sequence")
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def mad(values: Sequence[float], med: Optional[float] = None) -> float:
    """Median absolute deviation — the robust spread estimator: up to
    half the samples can be arbitrarily bad without moving it, which is
    exactly the property a straggler detector needs (the straggler must
    not inflate the yardstick it is measured against)."""
    if med is None:
        med = median(values)
    return median([abs(v - med) for v in values])


def robust_z(values: Sequence[float]) -> List[float]:
    """Signed robust z-score per sample: ``(x - median) / (1.4826 *
    MAD)``, with a 5%-of-median noise floor on the scale so identical
    samples score 0.0 rather than dividing by zero."""
    if not values:
        return []
    med = median(values)
    scale = _MAD_SIGMA * mad(values, med)
    floor = _NOISE_FLOOR_FRAC * abs(med)
    scale = max(scale, floor, 1e-12)
    return [(v - med) / scale for v in values]


def mad_outliers(values: Sequence[float], threshold: float = 3.5,
                 *, one_sided: bool = True) -> List[int]:
    """Indices of outlier samples by the robust-z test.  ``one_sided``
    (the default) flags only the *slow* side — a rank that is unusually
    fast is not a health problem."""
    zs = robust_z(values)
    if one_sided:
        return [i for i, z in enumerate(zs) if z > threshold]
    return [i for i, z in enumerate(zs) if abs(z) > threshold]


class HysteresisTracker:
    """Promotion gate: a key must be an outlier in ``windows``
    *consecutive* observations before :meth:`observe` reports it.  Any
    clean window resets the streak — transient noise (GC pause, one
    slow host op) can never accumulate into a verdict.  Thread-safe;
    one instance per signal stream."""

    def __init__(self, windows: int):
        if windows < 1:
            raise ValueError(f"hysteresis windows must be >= 1, "
                             f"got {windows}")
        self.windows = int(windows)
        self._lock = threading.Lock()
        self._streaks: Dict[Any, int] = {}

    def observe(self, outliers: Sequence[Any],
                population: Sequence[Any]) -> List[Any]:
        """Record one observation window.  ``outliers`` are the keys
        flagged this window, ``population`` every key observed (keys in
        the population but not flagged have their streak reset; keys
        absent from the population keep their streak — a rank that
        published no record is unknown, not clean).  Returns the keys
        whose streak just reached the promotion threshold."""
        flagged = set(outliers)
        promoted = []
        with self._lock:
            for key in population:
                if key in flagged:
                    self._streaks[key] = self._streaks.get(key, 0) + 1
                    if self._streaks[key] == self.windows:
                        promoted.append(key)
                else:
                    self._streaks.pop(key, None)
        return promoted

    def streak(self, key: Any) -> int:
        with self._lock:
            return self._streaks.get(key, 0)

    def reset(self, key: Any = None) -> None:
        with self._lock:
            if key is None:
                self._streaks.clear()
            else:
                self._streaks.pop(key, None)


# ---------------------------------------------------------------------------
# passive signal extractors
# ---------------------------------------------------------------------------


def score_step_records(records: Sequence[Dict[str, Any]],
                       *, mad_threshold: float = 3.5) -> Dict[str, Any]:
    """Score one collective group's per-rank StepLedger records for a
    straggler.

    The signature of a degraded rank in a synchronous mesh is an
    *asymmetry*: every healthy rank finishes its shard early and parks
    in the collective (``collective_wait`` grows), while the straggler
    arrives last and sails straight through (near-zero wait).  So the
    scored statistic is **own time** — step wall minus collective wait —
    and a suspect must be a slow-side own-time outlier whose collective
    wait is *below* the group median (the corroboration that everyone
    is waiting for *it*).

    Returns ``{"ranks": {rank: {own_s, wall_s, collective_wait_s, z}},
    "suspects": [rank, ...]}``.  Fewer than 3 ranks cannot support a
    median/MAD verdict and yield no suspects.
    """
    per_rank: Dict[int, Dict[str, float]] = {}
    for rec in records:
        try:
            rank = int(rec["rank"])
            # prefer the recent-window breakdown (fresh signal) over
            # the run-lifetime mean; fall back when the window is empty
            recent = rec.get("recent") or {}
            src = recent if recent.get("steps") else rec
            # the recent window publishes "wall_s_per_step"; the
            # lifetime breakdown block publishes "step_wall_s"
            wall = float(src["wall_s_per_step"]
                         if "wall_s_per_step" in src
                         else src["step_wall_s"])
            buckets = src.get("buckets_s") or {}
            coll = float(buckets.get("collective_wait", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        per_rank[rank] = {
            "wall_s": wall,
            "collective_wait_s": coll,
            "own_s": max(0.0, wall - coll),
        }
    ranks = sorted(per_rank)
    out: Dict[str, Any] = {"ranks": per_rank, "suspects": []}
    if len(ranks) < 3:
        return out
    own = [per_rank[r]["own_s"] for r in ranks]
    waits = [per_rank[r]["collective_wait_s"] for r in ranks]
    zs = robust_z(own)
    wait_med = median(waits)
    for i, r in enumerate(ranks):
        per_rank[r]["z"] = round(zs[i], 3)
        if zs[i] > mad_threshold and \
                per_rank[r]["collective_wait_s"] <= wait_med:
            out["suspects"].append(r)
    return out


def pending_age_lags(status_records: Sequence[Dict[str, Any]],
                     *, now: Optional[float] = None) -> Dict[int, float]:
    """Per-rank in-flight collective-op age, from the supervision status
    records (flight-recorder face): rank -> seconds its current op has
    been pending.  A rank whose peers all completed seq N while it still
    shows N in flight is the lagging rank the watchdog would eventually
    name — the health plane reads the same signal pre-timeout."""
    now = time.time() if now is None else now
    ages: Dict[int, float] = {}
    for rec in status_records:
        inflight = rec.get("inflight") or {}
        t0 = inflight.get("t_start")
        if t0 is None:
            continue
        try:
            ages[int(rec["rank"])] = max(0.0, now - float(t0))
        except (KeyError, TypeError, ValueError):
            continue
    return ages


# ---------------------------------------------------------------------------
# per-edge channel latency (process-local tracker)
# ---------------------------------------------------------------------------

_edge_lock = threading.Lock()
_edge_stats: Dict[str, Dict[str, float]] = {}
_EDGE_EWMA_ALPHA = 0.3


def note_edge_latency(edge: str, seconds: float) -> None:
    """Record one channel transfer on ``edge`` (an ``a->b`` transport
    identity).  Called by the channel plane next to its ``channel_wait``
    tracing note; EWMA + count per edge, cheap enough for every read."""
    with _edge_lock:
        st = _edge_stats.get(edge)
        if st is None:
            _edge_stats[edge] = {"ewma_s": seconds, "last_s": seconds,
                                 "count": 1}
        else:
            st["ewma_s"] += _EDGE_EWMA_ALPHA * (seconds - st["ewma_s"])
            st["last_s"] = seconds
            st["count"] += 1


def edge_latency_snapshot() -> Dict[str, Dict[str, float]]:
    """Copy of the per-edge latency table — shipped inside StepLedger
    records so the monitor can MAD-test edges cluster-wide."""
    with _edge_lock:
        return {e: dict(st) for e, st in _edge_stats.items()}


def reset_edge_latency() -> None:
    with _edge_lock:
        _edge_stats.clear()


# ---------------------------------------------------------------------------
# SDC canary
# ---------------------------------------------------------------------------


def sdc_digest(seed: int = 0, n: int = 32, iters: int = 4) -> str:
    """Deterministic reference-step digest: a fixed-seed matmul chain
    whose output bytes are hashed.  Integer arithmetic end to end —
    float matmuls reduce in backend-dependent orders, so a float canary
    would flag *reduction order* as corruption; int64 modular arithmetic
    is bit-exact on every backend.  Two honest executions of this
    function agree everywhere, forever; a mismatch means the executing
    hardware corrupted data (SDC), which is final — a corrupting chip is
    not quarantined pending review, it is reported as failed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = rng.integers(0, 97, size=(n, n), dtype=np.int64)
    x = rng.integers(0, 97, size=(n, n), dtype=np.int64)
    for _ in range(iters):
        x = (m @ x) % 1_000_003
    return hashlib.sha256(x.tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# device memory (HBM occupancy)
# ---------------------------------------------------------------------------


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory occupancy for this process's cards.

    Reads ``torch.cuda.memory_stats(i)`` (the caching allocator's
    ``allocated_bytes.all.current``, as ``bytes_in_use``) and
    ``torch.cuda.mem_get_info(i)`` (the card's total, as
    ``bytes_limit``).  Only consulted when this process has *already*
    initialised CUDA: a host-only worker must never pay (or trigger) a
    CUDA context just to report stats.  Returns ``[]`` when there is
    nothing to report, and rows shaped ``{"device", "kind",
    "bytes_in_use", "bytes_limit", "occupancy"}`` otherwise."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        count = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — no CUDA runtime / a lost context
        return []
    out: List[Dict[str, Any]] = []
    for i in range(count):
        row: Dict[str, Any] = {"device": f"cuda:{i}", "kind": "gpu"}
        try:
            in_use = torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current", 0)
            _free, limit = torch.cuda.mem_get_info(i)
        except Exception:  # noqa: BLE001 — a card this process cannot use
            out.append(row)
            continue
        row["bytes_in_use"] = int(in_use)
        row["bytes_limit"] = int(limit)
        if limit:
            row["occupancy"] = round(in_use / limit, 4)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# verdict records: publish / aggregate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HealthVerdict:
    """One subject's position on the health ladder.

    ``kind`` is ``"node"`` or ``"rank"``; ``subject`` is the node id (a
    card, ``"cuda:<index>"``, or a host slot, ``"slot:<index>"``) or
    ``<group>/<rank>``.  ``signals`` carries the evidence (robust z,
    collective-wait asymmetry, probe timings, canary digests) so a
    quarantine record is *readable* — the operator sees why, not just
    what.  ``hw_confirmed`` marks SDC/probe-proven hardware faults, kept
    on the node ladder beside the quarantine."""

    kind: str
    subject: str
    health: str                        # HEALTHY | SUSPECT | QUARANTINED
    reason: str = ""
    node_id: str = ""
    group: str = ""
    rank: Optional[int] = None
    signals: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hw_confirmed: bool = False
    suspect_ts: Optional[float] = None
    quarantine_ts: Optional[float] = None
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def publish_health_verdict(verdict: HealthVerdict, kv=None) -> bool:
    """Write one verdict record into the run's key-value store (``kv``, a
    ``_private.kv.RunKV``; None = this process's run, from
    ``RAY_TPU_TORCH_KV``) under ``health/verdict/<kind>/<subject>``.
    Best-effort: health *surfacing* must never fail the monitor that
    produced the verdict; actuation (quarantine) goes through the node
    ladder, not this record."""
    try:
        if kv is None:
            from ray_tpu_torch._private import kv as kv_mod

            if kv_mod.address() is None:
                return False
            kv = kv_mod.client()
        key = f"{_KV_PREFIX}{verdict.kind}/{verdict.subject}"
        kv.put(key, json.dumps(verdict.to_dict()).encode())
        return True
    except Exception:  # noqa: BLE001 — visibility stays best-effort
        return False


def aggregate_health_records(records: List[Dict[str, Any]],
                             *, now: Optional[float] = None
                             ) -> List[Dict[str, Any]]:
    """Order raw health verdict records for display and sweep stale ones
    (older than :data:`STALE_S`): a monitor that died mid-run must not
    pin its last verdict in every listing forever.  Worst health first
    (QUARANTINED > SUSPECT > HEALTHY), then by subject — the same
    aggregate-records pattern the collective and SLO panels use."""
    now = time.time() if now is None else now
    rank_of = {QUARANTINED: 0, SUSPECT: 1, HEALTHY: 2}
    out = []
    for rec in records:
        ts = rec.get("ts")
        if ts is not None and now - ts > STALE_S:
            continue
        out.append(rec)
    out.sort(key=lambda r: (rank_of.get(r.get("health"), 3),
                            r.get("kind", ""), str(r.get("subject", ""))))
    return out
