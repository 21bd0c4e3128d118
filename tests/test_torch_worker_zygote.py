"""The worker zygote (``ray_tpu_torch/_private/worker_zygote.py``) on the
CPU: every process the port starts forks from one preloaded process.

Held here: the process identity against the reference's
``proc_starttime``; a child's environment, working directory and
``sys.path`` as its starter's at that start; the zygote's fork safety (no
CUDA, one thread); each of the port's seven start sites giving a child
of the zygote, and a cold child of the starter under
``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0``; a nested start reaching the same
zygote; a killed child still ``WorkerDied`` or ``ActorDiedError``; a
killed zygote replaced at the next start (counted) while its live child
is still known by its identity; a daemonic child dying with its starter;
and a ``TorchTrainer`` run's first loss bit-equal under both start
methods.  Targets live in the JAX-free
``tests/test_torch_zygote_targets.py``.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import chip_smoke
import test_torch_zygote_targets as targets
from ray_tpu._private import worker_zygote as ref_zygote
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch._private import worker_zygote as wz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB = "RAY_TPU_TORCH_USE_WORKER_ZYGOTE"


def parent_pid(pid):
    """``pid``'s parent, from /proc/<pid>/stat."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        return int(f.read().rsplit(b")", 1)[1].split()[1])


@pytest.fixture
def kv(monkeypatch):
    """A run store hosted here, reached through ``RAY_TPU_TORCH_KV``."""
    store = kv_mod.host()
    monkeypatch.setenv(kv_mod.ENV_KV, store.addr)
    yield store


def _start_report():
    """One ``report_start`` child of ``get_context()``: its report."""
    ctx = wz.get_context()
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=targets.report_start, args=(child,),
                       daemon=True)
    proc.start()
    child.close()
    try:
        assert parent.poll(120), "the child did not answer"
        return parent.recv()
    finally:
        proc.join(30)
        assert proc.exitcode == 0


def test_proc_starttime_matches_the_reference():
    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])
    try:
        for pid in (os.getpid(), live.pid):
            got = wz.proc_starttime(pid)
            assert got is not None and got == ref_zygote.proc_starttime(pid)
        assert wz.alive(live.pid, wz.proc_starttime(live.pid))
        assert not wz.alive(live.pid, wz.proc_starttime(live.pid) + 1)
    finally:
        live.kill()
        live.wait()
    # reaped: gone for both
    assert wz.proc_starttime(live.pid) is None
    assert ref_zygote.proc_starttime(live.pid) is None
    assert not wz.alive(live.pid, 1)


def test_child_gets_its_starters_environment_at_start(tmp_path, monkeypatch):
    """A key set and a key removed after the zygote started, the working
    directory and ``sys.path``, as the starter has them at the start."""
    monkeypatch.setenv("RTZ_GONE", "old")
    wz.stop()
    first = _start_report()  # this zygote starts with RTZ_GONE set
    zpid = wz.stats()["zygote_pid"]
    assert first["ppid"] == zpid and first["env"]["RTZ_GONE"] == "old"
    with open(f"/proc/{zpid}/environ", "rb") as f:
        assert b"RTZ_GONE=old" in f.read().split(b"\0")
    monkeypatch.delenv("RTZ_GONE")
    monkeypatch.setenv("RTZ_NEW", "new")
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path / "extra"))
    got = _start_report()
    assert got["ppid"] == zpid
    assert "RTZ_GONE" not in got["env"] and got["env"]["RTZ_NEW"] == "new"
    assert got["env"] == dict(os.environ)
    assert got["cwd"] == str(tmp_path)
    assert got["sys_path"] == sys.path
    assert got["sigint"] and got["sigterm"]


def test_zygote_forks_without_cuda_or_threads():
    got = _start_report()
    zpid = wz.stats()["zygote_pid"]
    report = got["zygote"]
    assert report["pid"] == zpid == got["ppid"]
    assert report["threads"] == 1 and report["cuda_initialized"] is False
    assert {"torch", "ray_tpu_torch"} <= set(report["loaded"])
    assert not report["failed"], report["failed"]
    assert not got["cuda_initialized"]
    assert len(os.listdir(f"/proc/{zpid}/task")) == 1
    # the preload imports neither JAX nor the reference package
    with open(f"/proc/{zpid}/maps") as f:
        assert "jaxlib" not in f.read()


# ---------------------------------------------------------------------------
# the seven start sites: (pid, parent) of one child each, read while it runs
# ---------------------------------------------------------------------------


def _site_train_worker(kv):
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    wg = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=False),
                     "zygote-site", ["slot:0"])
    wg.start()
    try:
        pid = wg.workers[0][0].pid
        return pid, parent_pid(pid)
    finally:
        wg.shutdown()


def _site_actor(kv):
    from ray_tpu_torch.actor import get, kill

    h = targets.Starter.options(device="cpu").remote()
    try:
        pid = get(h.pid.remote(), timeout=120)
        return pid, parent_pid(pid)
    finally:
        kill(h)


def _site_serve_replica(kv):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.controller import get_controller

    serve.run(targets.PidReplica.bind(), name="zygote-site",
              route_prefix="/zygote-site")
    try:
        pid = get_controller(create=False).get_deployment_info(
            "PidReplica")["replicas"][0].pid
        return pid, parent_pid(pid)
    finally:
        serve.shutdown()


def _site_env_runner(kv):
    from ray_tpu_torch.rl import EnvRunnerGroup
    from ray_tpu_torch.rl import env as t_env

    name = "HostCartPoleZygote-v1"
    t_env.register_env(name, chip_smoke.HostCartPole)
    group = EnvRunnerGroup(name, 1, 2, {"obs_dim": 4, "num_actions": 2,
                                        "hidden": (8,), "gamma": 0.99},
                           timeout_s=120)
    try:
        pid = group.pids()[0]
        return pid, parent_pid(pid)
    finally:
        group.stop()
        del t_env._ENVS[name]


def _site_rollout(kv):
    from ray_tpu_torch.rl import RLHFConfig, TrajectoryLedger
    from ray_tpu_torch.rl.rlhf import RolloutGroup

    group = RolloutGroup(RLHFConfig(num_rollout_actors=1,
                                    name="zygote-site", device="cpu"),
                         None, TrajectoryLedger())
    try:
        pid = group.actors[0].pid
        return pid, parent_pid(pid)
    finally:
        group.stop()


def _site_checkpoint_replica(kv):
    from ray_tpu_torch.util import checkpoint_replica as cr

    plane = cr.ReplicaPlane("zygote-site", kv=kv)
    try:
        plane.ensure_for_nodes(["slot:0"])
        pid = plane.pid("slot:0")
        return pid, parent_pid(pid)
    finally:
        plane.shutdown()


def _site_health_probe(kv):
    from ray_tpu_torch._private import health_plane

    return health_plane.run_bound("slot:0", targets.parent_and_pid,
                                  timeout=120)


SITES = {"train_worker": _site_train_worker, "actor": _site_actor,
         "serve_replica": _site_serve_replica,
         "env_runner": _site_env_runner, "rlhf_rollout": _site_rollout,
         "checkpoint_replica": _site_checkpoint_replica,
         "health_probe": _site_health_probe}


@pytest.mark.parametrize("site", sorted(SITES))
def test_site_child_forks_from_the_zygote(site, kv):
    before = wz.stats()
    pid, ppid = SITES[site](kv)
    after = wz.stats()
    assert pid != os.getpid()
    assert ppid == after["zygote_pid"], (site, ppid, after)
    assert after["children"] > before["children"]
    assert after["fallbacks"] == before["fallbacks"]
    assert after["cold"] == before["cold"]


def test_sites_start_cold_without_the_zygote(kv, monkeypatch):
    """``use_worker_zygote=0``: the same seven children, started at once,
    are this process's own."""
    monkeypatch.setenv(KNOB, "0")
    before = wz.stats()
    got, errors = {}, {}

    def run(name):
        try:
            got[name] = SITES[name](kv)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors[name] = e

    threads = [threading.Thread(target=run, args=(n,)) for n in SITES]
    [t.start() for t in threads]
    [t.join(240) for t in threads]
    assert not errors, errors
    assert set(got) == set(SITES)
    for name, (pid, ppid) in got.items():
        assert ppid == os.getpid(), (name, pid, ppid)
    after = wz.stats()
    assert after["cold"] - before["cold"] >= len(SITES)
    assert after["children"] == before["children"]


def test_nested_start_reaches_the_same_zygote():
    """An actor's own child forks from the zygote that forked the actor."""
    from ray_tpu_torch.actor import get, kill

    h = targets.Starter.options(device="cpu").remote()
    try:
        got = get(h.start_child.remote(), timeout=120)
    finally:
        kill(h)
    stats = got["stats"]
    assert got["exitcode"] == 0
    assert got["child_ppid"] == wz.stats()["zygote_pid"]
    assert stats["zygote_inherited"] and stats["zygote_starts"] == 0
    assert stats["children"] == 1 and stats["fallbacks"] == 0


# ---------------------------------------------------------------------------
# deaths
# ---------------------------------------------------------------------------


def test_killed_worker_is_worker_died():
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerDied, WorkerGroup

    wg = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=False),
                     "zygote-kill", ["slot:0"])
    wg.start()
    try:
        proc = wg.workers[0][0]
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(30)
        assert not proc.is_alive() and proc.exitcode == -signal.SIGKILL
        with pytest.raises(WorkerDied):
            wg.call(0, "get_metadata", timeout=30)
    finally:
        wg.shutdown()


def test_killed_actor_is_actor_died():
    from ray_tpu_torch.actor import get
    from ray_tpu_torch.exceptions import ActorDiedError

    h = targets.Starter.options(device="cpu").remote()
    pid = get(h.pid.remote(), timeout=120)
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(ActorDiedError):
        get(h.pid.remote(), timeout=60)


def test_killed_zygote_is_replaced_and_counted():
    """SIGKILL the zygote under a live worker: the worker still answers
    and is known alive by its identity, then dead once killed; the next
    start forks from a new zygote, counted as a restart."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    wg = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=False),
                     "zygote-death", ["slot:0"])
    wg.start()
    try:
        old = wz.stats()
        os.kill(old["zygote_pid"], signal.SIGKILL)
        deadline = time.monotonic() + 30
        while wz.alive(old["zygote_pid"],
                       wz.proc_starttime(old["zygote_pid"])):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proc = wg.workers[0][0]
        assert wg.call(0, "get_metadata", timeout=30)
        assert proc.is_alive() and proc.exitcode is None
        proc.kill()
        proc.join(30)
        assert not proc.is_alive() and proc.exitcode is not None
        got = _start_report()
        new = wz.stats()
        assert new["zygote_pid"] != old["zygote_pid"]
        assert got["ppid"] == new["zygote_pid"]
        assert new["restarts"] == old["restarts"] + 1
        assert new["fallbacks"] == old["fallbacks"]
    finally:
        wg.shutdown()


def test_stuck_zygote_start_falls_back_and_is_counted(monkeypatch):
    """A zygote that forks no child within ``zygote_spawn_timeout_s``
    (here: still importing its preload) is killed and that start goes
    through ``spawn``, counted as a fallback."""
    wz.stop()
    monkeypatch.setenv("RAY_TPU_TORCH_ZYGOTE_SPAWN_TIMEOUT_S", "0.01")
    before = wz.stats()
    got = _start_report()
    after = wz.stats()
    assert got["ppid"] == os.getpid()
    assert after["fallbacks"] == before["fallbacks"] + 1
    assert after["zygote_pid"] is None


def test_daemonic_child_dies_with_its_starter(tmp_path):
    """A starter that exits normally takes its daemonic child down, and
    the zygote goes once nothing holds it."""
    script = tmp_path / "starter.py"
    script.write_text(
        "import sys, time\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]\n"
        "from ray_tpu_torch._private import worker_zygote as wz\n"
        "def sleeper():\n"
        "    time.sleep(120)\n"
        "if __name__ == '__main__':\n"
        "    ctx = wz.get_context()\n"
        "    p = ctx.Process(target=sleeper, daemon=True)\n"
        "    p.start()\n"
        "    z = wz.stats()['zygote_pid']\n"
        "    print(p.pid, p._popen.starttime, z, wz.proc_starttime(z),\n"
        "          flush=True)\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ),
                         check=True).stdout
    child, child_start, zygote, zygote_start = (int(x) for x in out.split())
    deadline = time.monotonic() + 30
    while wz.alive(child, child_start) or wz.alive(zygote, zygote_start):
        assert time.monotonic() < deadline, "the child or zygote outlived " \
                                            "its starter"
        time.sleep(0.1)


def test_trainer_first_loss_is_equal_under_both_start_methods(monkeypatch):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def fit():
        result = TorchTrainer(targets.tiny_train_loop,
                              scaling_config=ScalingConfig(
                                  num_workers=1, use_gpu=False)).fit()
        assert result.error is None, result.error
        return result.metrics

    forked = fit()
    assert forked["ppid"] == wz.stats()["zygote_pid"]
    monkeypatch.setenv(KNOB, "0")
    cold = fit()
    assert cold["ppid"] == os.getpid()
    assert forked["loss"] == cold["loss"]
