"""Port parity: the pure logic of the train and collective tiers.

Each case runs one body against ``ray_tpu.train`` and
``ray_tpu_torch.train`` (parametrised over the package): the failure and
elastic scaling policies on the same inputs, the checkpoint manager on
the same report sequence (``tests/test_train.py:158-200``), and the
scaling config's mesh presets.  The rest holds the port's runtime pieces
(resources, the run's KV, collective types, the abort error, the flight
recorder) to the reference's where it has them.
"""

import dataclasses
import os
import pickle
import tempfile

import pytest

import ray_tpu
import ray_tpu.train as jtrain
import ray_tpu_torch.train as ttrain
from ray_tpu.exceptions import CollectiveAbortError as JAbort
from ray_tpu.train import checkpoint_manager as jckm
from ray_tpu.train import policies as jpolicies
from ray_tpu.util.collective import supervision as jsup
from ray_tpu.util.collective import types as jtypes
from ray_tpu_torch._private import accelerators, kv as kv_mod, net
from ray_tpu_torch.exceptions import CollectiveAbortError as TAbort
from ray_tpu_torch.train import checkpoint_manager as tckm
from ray_tpu_torch.train import policies as tpolicies
from ray_tpu_torch.util.collective import supervision as tsup
from ray_tpu_torch.util.collective import types as ttypes

PKGS = {"ray_tpu": (jtrain, jpolicies, jckm),
        "ray_tpu_torch": (ttrain, tpolicies, tckm)}
pkg_param = pytest.mark.parametrize("pkg", sorted(PKGS))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

@pkg_param
@pytest.mark.parametrize("max_failures", [-1, 0, 1, 2])
def test_default_failure_policy(pkg, max_failures):
    train, policies, _ = PKGS[pkg]
    pol = train.DefaultFailurePolicy(max_failures=max_failures)
    got = [pol.make_decision(policies.TrainRunContext(errors_seen=n),
                             "e").value for n in range(5)]
    want = ["RETRY" if max_failures < 0 or n <= max_failures else "RAISE"
            for n in range(5)]
    assert got == want


def _patch_resources(monkeypatch, pkg, avail):
    if pkg == "ray_tpu":
        monkeypatch.setattr(ray_tpu, "available_resources",
                            lambda: dict(avail))
    else:
        monkeypatch.setattr(accelerators, "default_resources",
                            lambda *a, **k: dict(avail))


ELASTIC = [
    # (available, per worker, min, max, expected workers)
    ({"CPU": 16.0}, {"CPU": 1.0}, 1, 64, 16),
    ({"CPU": 16.0, "GPU": 4.0}, {"CPU": 1.0, "GPU": 1.0}, 1, 8, 4),
    ({"CPU": 16.0, "GPU": 3.0}, {"CPU": 2.0, "GPU": 1.0}, 1, 8, 3),
    ({"CPU": 16.0, "GPU": 1.0}, {"CPU": 1.0, "GPU": 2.0}, 2, 4, 2),
    ({"CPU": 2.0}, {"CPU": 1.0, "GPU": 0.0}, 1, 4, 2),
    ({"CPU": 64.0, "GPU": 8.0}, {"GPU": 1.0}, 1, 4, 4),
]


@pkg_param
@pytest.mark.parametrize("case", ELASTIC, ids=str)
def test_elastic_scaling_decision(pkg, case, monkeypatch):
    """The same resource view gives the same group size in [min, max]."""
    avail, per, lo, hi, want = case
    train, _, _ = PKGS[pkg]
    _patch_resources(monkeypatch, pkg, avail)
    pol = train.ElasticScalingPolicy(min_workers=lo, max_workers=hi,
                                     resources_per_worker=per, settle_s=0.0)
    dec = pol.make_decision_for_non_running_worker_group(
        train.ScalingConfig(num_workers=hi))
    assert isinstance(dec, train.ResizeDecision)
    assert dec.num_workers == want


@pkg_param
def test_elastic_policy_settles_on_the_last_sample(pkg, monkeypatch):
    """Over its settle window the policy keeps sampling, and the last
    sample wins (a released lease corrects an under-count)."""
    train, _, _ = PKGS[pkg]
    views = iter([{"CPU": 2.0}, {"CPU": 6.0}])
    last = {"CPU": 6.0}

    def view(*a, **k):
        return dict(next(views, last))

    if pkg == "ray_tpu":
        monkeypatch.setattr(ray_tpu, "available_resources", view)
    else:
        monkeypatch.setattr(accelerators, "default_resources", view)
    pol = train.ElasticScalingPolicy(1, 8, {"CPU": 1.0}, settle_s=0.6)
    dec = pol.make_decision_for_non_running_worker_group(
        train.ScalingConfig(num_workers=8))
    assert dec.num_workers == 6


@pkg_param
def test_elastic_policy_bounds(pkg):
    train, _, _ = PKGS[pkg]
    with pytest.raises(ValueError, match="min_workers"):
        train.ElasticScalingPolicy(min_workers=3, max_workers=2)


@pkg_param
def test_fixed_scaling_policy(pkg):
    train, _, _ = PKGS[pkg]
    dec = train.FixedScalingPolicy() \
        .make_decision_for_non_running_worker_group(
            train.ScalingConfig(num_workers=3))
    assert dec.num_workers == 3


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _report_sequence(ckm, train, store, num_to_keep, order="max"):
    mgr = ckm.CheckpointManager(storage_dir=store, num_to_keep=num_to_keep,
                                score_attribute="acc", score_order=order)
    kept = []
    for i, acc in enumerate([0.1, 0.9, 0.5, 0.2, 0.3]):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "v"), "w") as f:
            f.write(str(i))
        kept.append(mgr.register(train.Checkpoint(d), {"acc": acc}))
    return mgr, kept


def _read(ck):
    with open(os.path.join(ck.path, "v")) as f:
        return f.read()


@pkg_param
@pytest.mark.parametrize("order", ["max", "min"])
def test_checkpoint_manager_topk_eviction(pkg, order, tmp_path):
    """Top-2 by score: the best and the latest survive, the rest are
    deleted from storage, under both score orders."""
    train, _, ckm = PKGS[pkg]
    mgr, kept = _report_sequence(ckm, train, str(tmp_path / "store"), 2,
                                 order)
    live = [_read(c) for c in kept if os.path.exists(c.path)]
    assert live == (["1", "4"] if order == "max" else ["0", "4"])
    assert _read(mgr.best) == ("1" if order == "max" else "0")
    assert _read(mgr.latest) == "4"
    assert [os.path.basename(c.path) for c in kept] == [
        f"checkpoint_{i:06d}" for i in range(1, 6)]


@pkg_param
def test_latest_committed_checkpoint_and_torn_staging(pkg, tmp_path):
    """A ``.tmp`` staging dir (a writer killed mid-commit) is never
    loaded, and a new manager sweeps it and numbers past the commits."""
    train, _, ckm = PKGS[pkg]
    store = str(tmp_path / "store")
    _report_sequence(ckm, train, store, None)
    os.makedirs(os.path.join(store, "checkpoint_000009.tmp"))
    latest = ckm.latest_committed_checkpoint(store)
    assert os.path.basename(latest.path) == "checkpoint_000005"
    mgr = ckm.CheckpointManager(storage_dir=store, num_to_keep=None,
                                score_attribute=None)
    assert not os.path.exists(os.path.join(store, "checkpoint_000009.tmp"))
    d = tempfile.mkdtemp()
    ck = mgr.register(train.Checkpoint(d), {})
    assert os.path.basename(ck.path) == "checkpoint_000006"
    assert ckm.latest_committed_checkpoint(str(tmp_path / "none")) is None


@pkg_param
def test_checkpoint_to_directory(pkg, tmp_path):
    train, _, _ = PKGS[pkg]
    src = tmp_path / "src"
    src.mkdir()
    (src / "f").write_text("x")
    out = train.Checkpoint.from_directory(str(src)).to_directory(
        str(tmp_path / "dst"))
    assert open(os.path.join(out, "f")).read() == "x"
    assert not os.path.exists(str(tmp_path / "dst.tmp"))


# ---------------------------------------------------------------------------
# scaling config
# ---------------------------------------------------------------------------

@pkg_param
@pytest.mark.parametrize("mesh", ["dp", "fsdp", "fsdp_tp", None])
def test_scaling_config_mesh_presets(pkg, mesh):
    train, _, _ = PKGS[pkg]
    got = train.ScalingConfig(mesh=mesh).mesh_config()
    want = {"dp": (-1, 1, 1, 1, 1), "fsdp": (1, -1, 1, 1, 1),
            "fsdp_tp": (1, -1, 1, 2, 1), None: None}[mesh]
    assert (dataclasses.astuple(got) if got else None) == want


def test_scaling_config_refuses_a_bad_preset_as_the_reference():
    msgs = []
    for train in (jtrain, ttrain):
        with pytest.raises(ValueError) as e:
            train.ScalingConfig(mesh="fsdq").mesh_config()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw,want", [
    (dict(), {"CPU": 1.0}),
    (dict(use_gpu=True), {"CPU": 1.0, "GPU": 1.0}),
    (dict(use_gpu=True, gpus_per_worker=2, resources_per_worker={"x": 1}),
     {"x": 1, "CPU": 1.0, "GPU": 2.0}),
    (dict(use_gpu=False, gpus_per_worker=2), {"CPU": 1.0}),
])
def test_worker_resources(kw, want):
    assert ttrain.ScalingConfig(**kw).worker_resources() == want


# ---------------------------------------------------------------------------
# runtime pieces
# ---------------------------------------------------------------------------

def test_default_resources_count_gpus(monkeypatch):
    res = accelerators.default_resources()
    assert set(res) == {"CPU", "memory"}  # no CUDA here
    monkeypatch.setattr(accelerators, "detect_gpus", lambda: 4)
    assert accelerators.default_resources()["GPU"] == 4.0
    assert accelerators.default_resources(num_cpus=3, num_gpus=0) == {
        "CPU": 3.0, "memory": res["memory"]}


def test_free_port_and_address_in_use():
    assert 0 < net.free_port() < 65536
    assert net.address_in_use(RuntimeError(
        "port: 1, code: -98, name: EADDRINUSE, message: address already "
        "in use"))
    assert not net.address_in_use(RuntimeError("connection refused"))


def test_run_kv_put_get_delete_keys(monkeypatch):
    kv = kv_mod.host()
    kv.put("train/a", b"1")
    kv.put("collective/g/status/0", b"x")
    kv.put("collective/g/status/1", b"y")
    kv.put("collective/g/status/1", b"z")
    assert kv.get("train/a") == b"1" and kv.get("missing") is None
    assert kv.keys("collective/g/status/") == ["collective/g/status/0",
                                               "collective/g/status/1"]
    assert kv.delete("collective/g/status/0")
    assert kv.keys("collective/") == ["collective/g/status/1"]
    monkeypatch.setenv(kv_mod.ENV_KV, kv.addr)
    other = kv_mod.client()
    assert other is kv_mod.client()
    assert other.get("collective/g/status/1") == b"z"
    monkeypatch.delenv(kv_mod.ENV_KV)
    with pytest.raises(RuntimeError, match="RAY_TPU_TORCH_KV"):
        kv_mod.client()


def test_collective_types_match_the_reference():
    assert [(o.name, o.value) for o in ttypes.ReduceOp] == \
        [(o.name, o.value) for o in jtypes.ReduceOp]
    assert [(s.name, s.value) for s in ttypes.GroupState] == \
        [(s.name, s.value) for s in jtypes.GroupState]
    assert ttypes.unset_timeout_ms == jtypes.unset_timeout_ms
    for name in ("tcp", "gloo", "cpu", "TCP"):
        assert ttypes.Backend.parse(name) is ttypes.Backend.TCP
    for name in ("nccl", "cuda", "gpu"):
        assert ttypes.Backend.parse(name) is ttypes.Backend.NCCL
    for name in ("xla", "ici", "tpu"):
        with pytest.raises(ValueError, match="nccl"):
            ttypes.Backend.parse(name)
    # the single-process group: the reference's "xla_mesh"
    for name in ("mesh", "xla_mesh", "MESH"):
        assert ttypes.Backend.parse(name) is ttypes.Backend.MESH
        assert jtypes.Backend.parse(name) is jtypes.Backend.XLA_MESH
    with pytest.raises(ValueError, match="unknown"):
        ttypes.Backend.parse("mpi")


@pytest.mark.parametrize("kw", [
    dict(), dict(group_name="g", rank=2, seq=7, reason="op timed out",
                 diagnosis="flight recorder ..."),
    dict(group_name="g", reason="transport failure"),
])
def test_collective_abort_error_matches_the_reference(kw):
    got, want = TAbort(**kw), JAbort(**kw)
    assert str(got) == str(want)
    back = pickle.loads(pickle.dumps(got))
    assert (back.group_name, back.rank, back.seq, back.reason, str(back)) \
        == (got.group_name, got.rank, got.seq, got.reason, str(got))


def test_flight_recorder_matches_the_reference():
    for mod in (tsup, jsup):
        rec = mod.FlightRecorder(2)
        for seq in (1, 2, 3):
            e = rec.start("g", 0, "allreduce", seq, (2,), "float32")
            rec.finish(e, "done")
        assert [e["seq"] for e in rec.dump("g")] == [2, 3]
        rec.drop("g")
        assert rec.dump() == []
    assert tsup.resolve_timeout(3) == jsup.resolve_timeout(3) == 3.0
