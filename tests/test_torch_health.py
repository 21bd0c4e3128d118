"""Port parity: the hardware health plane on the CPU.

The pure half (``util/health.py``) runs the reference's own tests
(``tests/test_health.py:28-296``) against the port's copy, and its
scorer and canary are held equal to the reference's on the same inputs.
The monitor's confirm, acquit, SDC, timeout, no-reference and sweep
legs (``:325-460``) read and write a real run key-value store on
loopback through the ``probe_fn`` hook.  The node-health ladder, the
faults armed on a unit, the probe process bound to a unit, and the
controller's drain (a quarantined slot, a no-charge restart off it) run
for real; the drain is made deterministic by the test writing the
quarantine itself.  The timing-driven end-to-end copy of the reference's
straggler test carries ``slow`` and ``chaos`` as the reference's does
(``chip_smoke.py health`` runs it on the card machine).
"""

import json
import os
import random
import threading
import time

import pytest
import torch

import test_torch_trainer_loops as loops
from ray_tpu.util import health as RH
from ray_tpu_torch import train
from ray_tpu_torch._private import health_plane as HP
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch._private import node_faults
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.util import fault_injection as fi
from ray_tpu_torch.util import health as H

# ---------------------------------------------------------------------------
# robust statistics
# ---------------------------------------------------------------------------


def test_median_and_mad_basics():
    assert H.median([3.0, 1.0, 2.0]) == 2.0
    assert H.median([1.0, 2.0, 3.0, 4.0]) == 2.5
    assert H.mad([1.0, 1.0, 1.0]) == 0.0
    assert H.mad([1.0, 2.0, 3.0, 100.0]) == 1.0  # outlier cannot inflate
    with pytest.raises(ValueError):
        H.median([])


def test_robust_z_identical_samples_score_zero():
    zs = H.robust_z([0.1] * 8)
    assert zs == [0.0] * 8  # noise floor, not division by zero


def test_robust_z_flags_the_slow_sample():
    values = [0.10, 0.11, 0.10, 0.09, 0.10, 0.30]
    zs = H.robust_z(values)
    assert zs[-1] > 3.5
    assert all(abs(z) < 3.5 for z in zs[:-1])


def test_mad_outliers_one_sided_ignores_fast_ranks():
    # one unusually FAST sample is not a health problem
    values = [0.10, 0.10, 0.11, 0.10, 0.01]
    assert H.mad_outliers(values, 3.5) == []
    assert 4 in H.mad_outliers(values, 3.5, one_sided=False)


def test_hysteresis_requires_consecutive_windows():
    t = H.HysteresisTracker(3)
    assert t.observe(["a"], ["a", "b"]) == []
    assert t.observe(["a"], ["a", "b"]) == []
    assert t.observe(["a"], ["a", "b"]) == ["a"]      # exactly at N
    assert t.observe(["a"], ["a", "b"]) == []         # promoted once
    # a clean window resets the streak
    t2 = H.HysteresisTracker(2)
    t2.observe(["a"], ["a"])
    t2.observe([], ["a"])                              # clean: reset
    assert t2.streak("a") == 0
    assert t2.observe(["a"], ["a"]) == []
    assert t2.observe(["a"], ["a"]) == ["a"]


def test_hysteresis_absent_from_population_keeps_streak():
    # a rank that published no record this window is unknown, not clean
    t = H.HysteresisTracker(2)
    t.observe(["a"], ["a", "b"])
    t.observe([], ["b"])                               # "a" absent
    assert t.streak("a") == 1
    assert t.observe(["a"], ["a", "b"]) == ["a"]


def test_hysteresis_rejects_zero_windows():
    with pytest.raises(ValueError):
        H.HysteresisTracker(0)


# ---------------------------------------------------------------------------
# step-record scoring: the collective-wait asymmetry attribution
# ---------------------------------------------------------------------------


def _rec(rank, wall, coll, node="", steps=8):
    return {"group": "g", "rank": rank, "node_id": node,
            "recent": {"steps": steps, "wall_s_per_step": wall,
                       "buckets_s": {"compute": max(0.0, wall - coll),
                                     "collective_wait": coll}}}


def _degraded_recent():
    return {"group": "g", "rank": 2, "node_id": "",
            "steps": 500, "step_wall_s": 0.11,
            "buckets_s": {"compute": 0.10, "collective_wait": 0.01},
            "recent": {"steps": 8, "wall_s_per_step": 0.30,
                       "buckets_s": {"compute": 0.30,
                                     "collective_wait": 0.0}}}


# (records, mad_threshold, suspects): the reference's scoring cases
SCORING = {
    # synchronous mesh: every rank's WALL is identical; the straggler is
    # the one with high OWN time and near-zero collective wait
    "attributes_the_straggler": (
        [_rec(0, 0.30, 0.20), _rec(1, 0.30, 0.21), _rec(2, 0.30, 0.00),
         _rec(3, 0.30, 0.19)], 3.5, [2]),
    # an own-time outlier that ALSO waits above the median is blocked on
    # someone else: not the rank everyone waits for
    "high_wait_outlier_is_not_a_straggler": (
        [_rec(0, 0.12, 0.02), _rec(1, 0.12, 0.02), _rec(2, 0.42, 0.10),
         _rec(3, 0.12, 0.02)], 3.5, []),
    "needs_three_ranks": (
        [_rec(0, 0.1, 0.05), _rec(1, 0.4, 0.0)], 3.5, []),
    # lifetime means say healthy; the recent window says degraded — the
    # fresh signal must win
    "prefers_recent_window": (
        [_rec(0, 0.30, 0.20), _rec(1, 0.30, 0.20), _rec(3, 0.30, 0.20),
         _degraded_recent()], 3.5, [2]),
    # no recent window: score the lifetime breakdown's step_wall_s
    "falls_back_to_lifetime_breakdown": (
        [_rec(0, 0.30, 0.20), _rec(1, 0.30, 0.20),
         {"group": "g", "rank": 2, "steps": 40, "step_wall_s": 0.30,
          "buckets_s": {"compute": 0.30, "collective_wait": 0.0}},
         _rec(3, 0.30, 0.20)], 3.5, [2]),
    # a record mid-write (no wall) is skipped, not fatal
    "skips_malformed_records": (
        [_rec(0, 0.30, 0.20), _rec(1, 0.30, 0.21), _rec(2, 0.30, 0.00),
         _rec(3, 0.30, 0.19), {"group": "g", "rank": 4}], 3.5, [2]),
}


@pytest.mark.parametrize("case", list(SCORING))
def test_score_step_records_cases_and_reference_equality(case):
    """The reference's scoring cases, and the port's whole score equal to
    the reference's ``score_step_records`` on the same records."""
    records, threshold, suspects = SCORING[case]
    score = H.score_step_records(records, mad_threshold=threshold)
    assert score["suspects"] == suspects
    assert score == RH.score_step_records(records, mad_threshold=threshold)
    if case == "attributes_the_straggler":
        assert score["ranks"][2]["own_s"] == pytest.approx(0.30)
        assert score["ranks"][0]["own_s"] == pytest.approx(0.10)
        assert score["ranks"][2]["z"] > 3.5


def _jittered_records(rng, straggler):
    """One window of 8 ranks' records: jittered healthy ranks, and (when
    ``straggler``) rank 5 3x slow with its peers parked waiting for
    it."""
    records = []
    for rank in range(8):
        if not straggler:
            wall = 0.30 * rng.uniform(0.9, 1.1)
            coll = 0.18 * rng.uniform(0.7, 1.3)
            records.append(_rec(rank, wall, min(coll, wall)))
        elif rank == 5:
            records.append(_rec(rank, 0.30 * rng.uniform(0.95, 1.05) * 3.0
                                + 0.002, 0.002))
        else:
            own = 0.10 * rng.uniform(0.95, 1.05)
            records.append(_rec(rank, 0.92, 0.92 - own))
    return records


@pytest.mark.parametrize("straggler", [False, True],
                         ids=["noisy_healthy_never_promotes",
                              "3x_straggler_promotes_at_k"])
def test_hysteresis_over_jittered_windows(straggler):
    """Acceptance gate both ways: realistic jitter over 60 windows never
    reaches a verdict, and a genuine 3x-slow rank is promoted after
    exactly the hysteresis window count, jitter and all; the reference
    scores every window the same."""
    rng = random.Random(11 if straggler else 7)
    windows = 3
    tracker = H.HysteresisTracker(windows)
    promoted_at = None
    for w in range(1, 10 if straggler else 61):
        records = _jittered_records(rng, straggler)
        score = H.score_step_records(records, mad_threshold=3.5)
        assert score == RH.score_step_records(records, mad_threshold=3.5)
        promoted = tracker.observe(score["suspects"], list(score["ranks"]))
        if promoted:
            assert straggler and promoted == [5]
            promoted_at = w
            break
    assert promoted_at == (windows if straggler else None)


# ---------------------------------------------------------------------------
# pending ages, edge latency, SDC canary, device memory
# ---------------------------------------------------------------------------


def test_pending_age_lags():
    now = 1000.0
    members = [{"rank": 0, "inflight": {"op": "allreduce",
                                        "t_start": 998.0}},
               {"rank": 1, "inflight": None},
               {"rank": 2, "inflight": {"op": "allreduce",
                                        "t_start": 999.5}}]
    ages = H.pending_age_lags(members, now=now)
    assert ages == {0: 2.0, 2: 0.5}
    assert ages == RH.pending_age_lags(members, now=now)


def test_edge_latency_tracker_ewma_and_reset():
    H.reset_edge_latency()
    try:
        H.note_edge_latency("a->b", 0.1)
        H.note_edge_latency("a->b", 0.2)
        snap = H.edge_latency_snapshot()
        assert snap["a->b"]["count"] == 2
        assert snap["a->b"]["last_s"] == pytest.approx(0.2)
        assert 0.1 < snap["a->b"]["ewma_s"] < 0.2
        # snapshot is a copy: mutating it must not leak back
        snap["a->b"]["count"] = 999
        assert H.edge_latency_snapshot()["a->b"]["count"] == 2
    finally:
        H.reset_edge_latency()
    assert H.edge_latency_snapshot() == {}


@pytest.mark.parametrize("kw", [dict(seed=7), dict(seed=8),
                                dict(seed=0, n=16, iters=2)], ids=str)
def test_sdc_digest_deterministic_and_equal_to_reference(kw):
    a = H.sdc_digest(**kw)
    assert a == H.sdc_digest(**kw)                # bit-exact, always
    assert a == RH.sdc_digest(**kw)               # the reference's chain
    assert len(a) == 64                            # sha256 hex
    assert a != H.sdc_digest(**{**kw, "seed": kw["seed"] + 1})


def test_device_memory_stats_shape(monkeypatch):
    """Nothing before this process initialises CUDA (never the host's
    case here); with a context, one row per card from the allocator's
    stats and the card's total."""
    assert H.device_memory_stats() == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": (i + 1) << 30})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (1 << 30, 80 << 30))
    rows = H.device_memory_stats()
    assert [r["device"] for r in rows] == ["cuda:0", "cuda:1"]
    assert rows[1]["bytes_in_use"] == 2 << 30
    assert rows[1]["bytes_limit"] == 80 << 30
    assert rows[1]["occupancy"] == round(2 / 80, 4)
    assert all(r["kind"] == "gpu" for r in rows)


# ---------------------------------------------------------------------------
# verdict records: aggregation, stale sweep, publication
# ---------------------------------------------------------------------------


def test_aggregate_health_records_orders_and_sweeps():
    now = time.time()
    records = [
        {"kind": "rank", "subject": "g/1", "health": "SUSPECT",
         "ts": now - 5},
        {"kind": "node", "subject": "nodeZ", "health": "HEALTHY",
         "ts": now - 5},
        {"kind": "node", "subject": "nodeA", "health": "QUARANTINED",
         "ts": now - 5},
        # stale: a monitor that died must not pin its verdict forever
        {"kind": "node", "subject": "ghost", "health": "QUARANTINED",
         "ts": now - H.STALE_S - 1},
    ]
    out = H.aggregate_health_records(records, now=now)
    assert [r["subject"] for r in out] == ["nodeA", "g/1", "nodeZ"]
    assert out == RH.aggregate_health_records(records, now=now)


def test_health_verdict_roundtrip_and_publication():
    v = H.HealthVerdict(kind="node", subject="cuda:1", health=H.QUARANTINED,
                        reason="probe 3.1x slower than reference",
                        node_id="cuda:1", signals={"probe_ratio": 3.1},
                        hw_confirmed=False, suspect_ts=1.0,
                        quarantine_ts=2.0)
    d = json.loads(json.dumps(v.to_dict()))
    assert d["health"] == "QUARANTINED"
    assert d["signals"]["probe_ratio"] == 3.1
    assert d["quarantine_ts"] == 2.0
    # into the run's store, under health/verdict/<kind>/<subject>
    kv = kv_mod.host()
    rank = H.HealthVerdict(kind="rank", subject="tg/3", health=H.SUSPECT,
                           reason="own-time outlier", group="tg", rank=3,
                           signals={"own_time_z": 5.2})
    assert H.publish_health_verdict(rank, kv=kv)
    got = json.loads(kv.get("health/verdict/rank/tg/3"))
    assert got["signals"]["own_time_z"] == 5.2 and got["rank"] == 3
    # no run in this process: nothing to publish to, and no raise
    assert not H.publish_health_verdict(rank)


# ---------------------------------------------------------------------------
# the node-health ladder and faults armed on a unit
# ---------------------------------------------------------------------------


def test_ladder_escalates_and_quarantine_is_sticky():
    """The GCS ladder's verbs on the run's store: SUSPECT is advisory,
    QUARANTINED opens a drain deadline and is sticky, unknown states are
    refused."""
    kv = kv_mod.host()
    assert HP.node_health(kv) == {}
    ack = HP.set_node_health(kv, "cuda:1", "SUSPECT", "own-time outlier")
    assert ack["accepted"] and ack["previous"] == "HEALTHY"
    t0 = time.time()
    ack = HP.set_node_health(kv, "cuda:1", "QUARANTINED", "probe 3x slower",
                             hw_confirmed=True)
    assert ack["accepted"] and ack["previous"] == "SUSPECT"
    rec = HP.node_health(kv)["cuda:1"]
    assert rec["health"] == "QUARANTINED" and rec["hw_confirmed"]
    deadline = HP.DEFAULTS["health_quarantine_drain_deadline_s"]
    assert t0 + deadline - 1 <= rec["drain_deadline"] <= time.time() + \
        deadline
    ack = HP.set_node_health(kv, "cuda:1", "HEALTHY", "oops")
    assert not ack["accepted"] and "sticky" in ack["rejection_reason"]
    assert HP.node_health(kv)["cuda:1"]["health"] == "QUARANTINED"
    assert not HP.set_node_health(kv, "cuda:2", "WEIRD")["accepted"]
    assert set(HP.node_health(kv)) == {"cuda:1"}


def test_knobs_are_the_reference_defaults():
    from ray_tpu._private.config import config

    for name, value in HP.DEFAULTS.items():
        assert value == getattr(config, name), name
    mon = HP.HealthMonitor()
    assert (mon.interval_s, mon.mad_threshold, mon.suspect_windows,
            mon.probe_factor, mon.probe_timeout_s) == (2.0, 3.5, 3, 2.0,
                                                       30.0)


def test_arm_node_fault_reaches_the_processes_of_the_unit(tmp_path):
    """``arm_node_fault`` writes the spec into the run's store: a process
    bound to the unit arms it (here a probe process, through
    ``run_bound``) and acknowledges; a unit with no process acknowledges
    nothing; the window left is what is armed."""
    kv = kv_mod.host()
    site = "health.test_arm"
    ack = node_faults.arm_node_fault(kv, "slot:7", site, duration_s=30.0,
                                     exc="slow:3", timeout=0.2)
    assert ack == {"armed": 0, "node_id": "slot:7"}
    factor = HP.run_bound("slot:7", loops.armed_factor, site, timeout=120,
                          kv_addr=kv.addr)
    assert factor == 3.0
    assert len(kv.keys("faults/ack/")) == 1
    # in this process, as a worker's watcher does
    try:
        seen = set()
        assert node_faults.arm_pending(kv, "slot:7", seen) == 1
        assert fi._armed[site].factor == 3.0
        assert node_faults.arm_pending(kv, "slot:7", seen) == 0
    finally:
        fi.disarm(site)


def test_run_bound_times_out_and_probe_payload_runs_bound():
    """The probe: in a process bound to the unit, the canary digest of
    the host's chain and no ping without cards; a silent process is
    killed at the timeout and answers None."""
    res = HP.run_bound("slot:0", HP._probe_payload, timeout=120)
    assert res["node_id"] == "slot:0"
    assert res["digest"] == H.sdc_digest(seed=7)
    assert res["elapsed_s"] > 0 and "ppermute_s" not in res
    t0 = time.monotonic()
    assert HP.run_bound("slot:0", time.sleep, 60, timeout=3) is None
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# HealthMonitor: confirm / acquit / SDC / timeout / no-reference / sweep
# ---------------------------------------------------------------------------


def _make_monitor(step_records, nodes, probe_fn, **kw):
    """A monitor over a real run store on loopback holding the step
    records and the run's units; the ladder is read back from it."""
    kw.setdefault("interval_s", 0.05)
    kw.setdefault("suspect_windows", 2)
    kw.setdefault("probe_factor", 2.0)
    kv = kv_mod.host()
    for r in step_records:
        kv.put(f"train/step_breakdown/g/{r['rank']}", json.dumps(r).encode())
    HP.publish_units(kv, nodes)
    mon = HP.HealthMonitor(kv=kv, probe_fn=probe_fn, **kw)
    return mon, kv


def _ladder(kv, health="QUARANTINED"):
    return {n for n, r in HP.node_health(kv).items() if r["health"] == health}


_STRAGGLER_RECORDS = [_rec(0, 0.30, 0.20, node="nodeA"),
                      _rec(1, 0.30, 0.21, node="nodeB"),
                      _rec(2, 0.30, 0.00, node="nodeC"),
                      _rec(3, 0.30, 0.19, node="nodeD")]
_NODES = ["nodeA", "nodeB", "nodeC", "nodeD"]


def _probe(slow=(), bad=(), silent=()):
    good = H.sdc_digest(seed=7)

    def probe(node_id):
        if node_id in silent:
            return None
        return {"node_id": node_id,
                "digest": "deadbeef" * 8 if node_id in bad else good,
                "elapsed_s": 0.35 if node_id in slow else 0.10}

    return probe


def _quarantine_event(mon):
    return [e for e in mon.summary()["events"]
            if e["event"] == "quarantine"][0]


def test_monitor_probe_ratio_confirms_and_quarantines():
    mon, kv = _make_monitor(_STRAGGLER_RECORDS, _NODES, _probe(slow={"nodeC"}))
    mon.tick()                     # window 1: streak building
    assert mon.summary()["quarantined"] == []
    assert _ladder(kv) == set()
    mon.tick()                     # window 2: promoted -> probe -> confirm
    s = mon.summary()
    assert s["quarantined"] == ["nodeC"]
    assert "detection_to_quarantine_s" in s
    kinds = [e["event"] for e in s["events"]]
    assert kinds.count("suspect") >= 1 and kinds.count("quarantine") == 1
    assert _ladder(kv) == {"nodeC"}
    assert not HP.node_health(kv)["nodeC"]["hw_confirmed"]
    assert "slower than reference" in _quarantine_event(mon)["reason"]
    assert s["counts"] == {"ticks": 2, "suspects": 1, "quarantines": 1,
                           "probes": 2}
    assert s["probe_s"] == {"nodeA": 0.10, "nodeC": 0.35}
    verdict = json.loads(kv.get("health/verdict/node/nodeC"))
    assert verdict["signals"]["probe_ratio"] == 3.5


def test_monitor_probe_acquittal_resets_the_streak():
    mon, kv = _make_monitor(_STRAGGLER_RECORDS, _NODES, _probe())
    for _ in range(4):
        mon.tick()
    assert mon.summary()["quarantined"] == []     # probe cleared it
    assert _ladder(kv) == set() and _ladder(kv, "SUSPECT") == {"nodeC"}
    # acquittal reset the streak: the passive signal alone keeps it
    # SUSPECT-bound, never quarantined
    assert mon._rank_hyst.streak(("g", 2)) < 2


@pytest.mark.parametrize("leg", ["sdc", "timeout"])
def test_monitor_confirms_by_canary_or_silence(leg):
    """A canary digest mismatch means the card corrupts data: the
    quarantine is hardware-confirmed on the ladder.  A suspect that never
    answers while the reference does is confirmed by silence."""
    probe = _probe(bad={"nodeC"}) if leg == "sdc" else \
        _probe(silent={"nodeC"})
    mon, kv = _make_monitor(_STRAGGLER_RECORDS, _NODES, probe)
    mon.tick()
    mon.tick()
    assert mon.summary()["quarantined"] == ["nodeC"]
    q = _quarantine_event(mon)
    assert _ladder(kv) == {"nodeC"}
    if leg == "sdc":
        assert q["hw_confirmed"] is True and "SDC" in q["reason"]
        assert HP.node_health(kv)["nodeC"]["hw_confirmed"]
    else:
        assert "timed out" in q["reason"]


def test_monitor_no_reference_leaves_suspect_unconfirmed():
    # no healthy yardstick answers: must NOT quarantine on passive
    # evidence alone
    mon, kv = _make_monitor(_STRAGGLER_RECORDS, [], _probe(silent=_NODES))
    for _ in range(4):
        mon.tick()
    assert mon.summary()["quarantined"] == []
    assert _ladder(kv) == set()


@pytest.mark.parametrize("nodes,want", [
    (["n1", "n2", "n3", "n4"], ["n3"]),
    (["n1", "n3"], []),
], ids=["catches_degraded_unit_without_groups", "needs_three_units"])
def test_monitor_probe_sweep(nodes, want):
    """The unit-sweep leg: detection with no train group at all, after
    the hysteresis windows; fewer than three units give no verdict."""
    mon, kv = _make_monitor([], nodes, _probe(slow={"n3"}),
                            probe_sweep=True, probe_sweep_every=1)
    mon.tick()
    assert mon.summary()["quarantined"] == []     # hysteresis holding
    for _ in range(3):
        mon.tick()
    s = mon.summary()
    assert s["quarantined"] == want
    assert _ladder(kv) == set(want)
    assert ("detection_to_quarantine_s" in s) == bool(want)


def test_monitor_waits_for_the_trainers_run():
    """Started before ``fit()`` hosts the run's store, the monitor reads
    nothing and raises nothing; it finds the store of the run that is
    going through the trainer."""
    class _Trainer:
        controller = None

    trainer = _Trainer()
    mon = HP.HealthMonitor(trainer=trainer, interval_s=0.05,
                           probe_fn=_probe())
    mon.tick()
    assert mon._alive_nodes() == [] and mon.summary()["ticks"] == 1
    kv = kv_mod.host()
    HP.publish_units(kv, ["slot:0", "slot:1"])
    trainer.controller = type("C", (), {"kv": kv})()
    assert [n["node_id"] for n in mon._alive_nodes()] == ["slot:0",
                                                          "slot:1"]
    second = HP.HealthMonitor(trainer=_Trainer(), probe_fn=_probe())
    assert second._alive_nodes() == []   # nothing shared across runs


# ---------------------------------------------------------------------------
# placement and the controller's drain
# ---------------------------------------------------------------------------


def test_placement_refuses_too_few_free_units():
    sc = train.ScalingConfig(num_workers=2, use_gpu=False)
    with pytest.raises(RuntimeError, match="cannot be placed: 2 workers, 1 "
                       r"slots free \(\['slot:0'\]\)"):
        WorkerGroup(sc, "g", ["slot:0"]).start()


@pytest.mark.parametrize("units_left,want", [(None, 3), (3, 3), (2, 2),
                                             (1, 2)])
def test_elastic_policy_counts_the_units_left(units_left, want):
    """The elastic policy fits one worker per card or slot that is not
    quarantined, within [min, max]."""
    pol = train.ElasticScalingPolicy(2, 3, {"CPU": 1.0}, settle_s=0.0)
    dec = pol.make_decision_for_non_running_worker_group(
        train.ScalingConfig(num_workers=3), units_left=units_left)
    assert dec.num_workers == want


@pytest.fixture(scope="module")
def drain_run(tmp_path_factory):
    """Three host workers under ``ElasticScalingPolicy(2, 3)`` and
    ``max_failures=0``; a fault armed on slot 1 after step 0, and slot 1
    quarantined on the ladder once every rank holds at step 2."""
    tmp = tmp_path_factory.mktemp("drain")
    side = tmp / "side"
    side.mkdir()
    cfg = {"side_dir": str(side), "steps": 6, "hold_at": 2, "world": 3}
    trainer = train.TorchTrainer(
        loops.drain_loop, train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=3, use_gpu=False),
        run_config=train.RunConfig(
            name="drain-run", storage_path=str(tmp),
            failure_config=train.FailureConfig(max_failures=0)),
        scaling_policy=train.ElasticScalingPolicy(2, 3, settle_s=0.2))
    seen = {}

    def saboteur():
        deadline = time.time() + 240
        while time.time() < deadline:
            ctl = trainer.controller
            names = set(os.listdir(side))
            if "armed" not in seen and ctl is not None and \
                    {f"s0-w3-r{r}" for r in range(3)} <= names:
                seen["armed"] = node_faults.arm_node_fault(
                    ctl.kv, "slot:1", "health.test_arm", exc="slow:1",
                    timeout=30)
            if {f"s2-w3-r{r}" for r in range(3)} <= names:
                seen["ack"] = HP.set_node_health(
                    ctl.kv, "slot:1", "QUARANTINED", "test: slot 1 sick")
                return
            time.sleep(0.02)

    t = threading.Thread(target=saboteur, daemon=True)
    t.start()
    result = trainer.fit()
    t.join(timeout=10)
    markers = {}
    for name in os.listdir(side):
        if not name.endswith(".tmp"):
            with open(side / name) as f:
                markers[name] = json.load(f)
    return trainer, result, seen, markers


def test_drain_restarts_off_the_quarantined_slot_without_charge(drain_run):
    """The run finishes every step with ``max_failures=0``: the quarantine
    drain is a planned migration.  The pre-drain checkpoint (step 2) is
    the one resumed from, and the re-meshed group runs at world 2 off
    slot 1, which stays QUARANTINED on the ladder."""
    trainer, result, seen, _ = drain_run
    assert result.error is None, result.error
    assert seen["ack"]["accepted"]
    ctl = trainer.controller
    assert ctl.drain_restarts == 1 and ctl._ctx.errors_seen == 0
    history = result.metrics_history
    assert [m["step"] for m in history] == list(range(6))
    assert [m["world"] for m in history] == [3, 3, 3, 2, 2, 2]
    assert [m["drain_checkpoint"] for m in history] == \
        [False, False, True, False, False, False]
    assert all(m["start"] == 3 for m in history[3:])
    assert HP.node_health(ctl.kv)["slot:1"]["health"] == "QUARANTINED"
    assert ctl.status()["drain_restarts"] == 1


def test_drained_group_is_placed_off_the_slot(drain_run):
    """Every rank of the world-2 group ran on slots 0 and 2; before the
    drain the three ranks held slots 0, 1, 2.  The fault armed on slot 1
    reached its worker (one acknowledgement) and only it."""
    _, _, seen, markers = drain_run
    before = {m["node"] for n, m in markers.items() if "-w3-" in n}
    after = {m["node"] for n, m in markers.items() if "-w2-" in n}
    assert before == {"slot:0", "slot:1", "slot:2"}
    assert after == {"slot:0", "slot:2"}
    assert seen["armed"] == {"armed": 1, "node_id": "slot:1"}
    armed = {n: "health.test_arm" in m["armed"] for n, m in markers.items()
             if n.startswith("drained-")}
    assert armed == {"drained-r0": False, "drained-r1": True,
                     "drained-r2": False}


# ---------------------------------------------------------------------------
# end to end: straggler -> detect -> probe -> quarantine -> drain -> re-mesh
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow
def test_straggler_detected_quarantined_and_remeshed(tmp_path):
    """The reference's loop on three host workers: degrade one slot 3x
    (``slow`` on its compute path AND on ``health.probe``, so the
    confirming probe sees the sick unit), let the monitor attribute the
    straggler from the step records, confirm it by probe, quarantine it
    on the ladder, and see the elastic run re-mesh off it and finish with
    a ZERO failure budget."""
    side = tmp_path / "side"
    side.mkdir()
    trainer = train.TorchTrainer(
        loops.straggler_loop,
        train_loop_config={"side_dir": str(side), "steps": 25,
                           "step_s": 0.2},
        scaling_config=train.ScalingConfig(num_workers=3, use_gpu=False),
        run_config=train.RunConfig(
            name="health-run", storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=0)),
        scaling_policy=train.ElasticScalingPolicy(2, 3))
    armed = {}

    def saboteur():
        deadline = time.time() + 120
        while time.time() < deadline:
            marker = side / "s2-w3-r1"
            if marker.exists() and trainer.controller is not None:
                node = json.loads(marker.read_text())["node"]
                for site in ("train.work", "health.probe"):
                    ack = node_faults.arm_node_fault(
                        trainer.controller.kv, node, site,
                        duration_s=120.0, exc="slow:3", timeout=10)
                    assert ack["armed"] >= 1, ack
                armed.update(node=node, t=time.time())
                return
            time.sleep(0.2)

    mon = HP.HealthMonitor(trainer=trainer, interval_s=0.5,
                           suspect_windows=2, probe_factor=1.5,
                           probe_timeout_s=30.0)
    mon.start()
    t = threading.Thread(target=saboteur, daemon=True)
    t.start()
    try:
        result = trainer.fit()
    finally:
        mon.stop()
    t.join(timeout=5)
    assert "node" in armed, "saboteur never armed the degradation"
    assert result.error is None, result.error
    assert result.metrics_history[-1]["step"] == 24
    s = mon.summary()
    assert armed["node"] in s["quarantined"], s
    assert s["detection_to_quarantine_s"] >= 0.0
    post = {json.loads((side / n).read_text())["node"]
            for n in os.listdir(side) if "-w2-" in n and
            not n.endswith(".tmp")}
    assert post and armed["node"] not in post, post
