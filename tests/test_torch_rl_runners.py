"""Port parity: ``ray_tpu_torch.rl``'s runner processes (``EnvRunner``
served in a spawned process per runner, ``EnvRunnerGroup``) against the
reference's runner semantics (``ray_tpu/rl/env_runner.py``,
``tests/test_rl.py:95-108``) on the CPU.

Process rules as ``tests/test_torch_trainer.py``'s: one module-level
fixture starts the runners once (a PPO over two gymnasium CartPole
runners, and a group of three runners of a registered host env), and a
watchdog kills every runner it spawned if the module outlives
``WATCHDOG_S``.  Each runner's sampled log-probs and values are held to
the JAX module's on the same weights and observations at atol 1e-5.
"""

import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ray_tpu.rl import models as j_models
from ray_tpu_torch.rl import PPO, AlgorithmConfig, EnvRunnerGroup
from ray_tpu_torch.rl import env as t_env

WATCHDOG_S = 240
SPEC = {"obs_dim": 4, "num_actions": 2, "hidden": (64, 64), "gamma": 0.99}
HOST_ENV = "HostCartPoleTest-v1"


@pytest.fixture(scope="module")
def runs():
    """The PPO over two gym runners (the reference's runner test), and a
    group of three runners of ``HOST_ENV``, registered here only (its
    factory, ``chip_smoke.HostCartPole``, travels to the runners), with
    one respawn in its budget."""
    t_env.register_env(HOST_ENV, chip_smoke.HostCartPole)
    spawned = []

    def kill_all():
        for pid in spawned:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass

    watchdog = threading.Timer(WATCHDOG_S, kill_all)
    watchdog.daemon = True
    watchdog.start()
    algo = group = None
    try:
        algo = (AlgorithmConfig(PPO, device="cpu")
                .environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=64)
                .seed_(1).build())
        spawned += algo.runner_group.pids()
        group = EnvRunnerGroup(HOST_ENV, 3, 8, SPEC, seed=3,
                               respawn_budget=1, timeout_s=60)
        spawned += group.pids()
        yield algo, group, spawned
    finally:
        watchdog.cancel()
        for owner in (algo, group):
            if owner is not None:
                owner.stop()
        del t_env._ENVS[HOST_ENV]


def _jax_logp_value(weights, obs, actions):
    """The JAX module's log-probs of ``actions`` and values at ``obs`` on
    the runner's weights."""
    m = j_models.ActorCriticModule(4, 2)
    params = jax.tree.map(jnp.asarray, weights)
    logits, values = m.forward(params, jnp.asarray(obs))
    logp = jax.nn.log_softmax(logits)
    return (np.take_along_axis(np.asarray(logp), actions[..., None],
                               -1)[..., 0], np.asarray(values))


def test_ppo_env_runner_processes(runs):
    """The reference's runner test: two iterations of 2 runners x 4 envs x
    64 steps, the learner on the host here."""
    algo, _, _ = runs
    m1 = algo.train()
    assert m1["env_steps_this_iter"] == 2 * 4 * 64
    m2 = algo.train()
    assert m2["training_iteration"] == 2
    assert np.isfinite(m2["pi_loss"])
    ran = algo.runner_group.env_names()
    assert ran == ["GymVectorEnv(CartPole-v1)"] * 2


def test_gym_sample_matches_jax_module(runs):
    """A sample from the gymnasium runners: shapes, dones, and each step's
    log-prob and value equal to the JAX module's on the synced weights."""
    algo, _, _ = runs
    weights = algo.learner.get_weights()
    algo.runner_group.sync_weights(weights)
    trajs = algo.runner_group.sample(16)
    assert len(trajs) == 2
    for t in trajs:
        assert t["obs"].shape == (16, 4, 4) and t["actions"].shape == (16, 4)
        assert t["dones"].dtype == bool and t["last_value"].shape == (4,)
        logp, values = _jax_logp_value(weights, t["obs"], t["actions"])
        np.testing.assert_allclose(t["logp_old"], logp, atol=1e-5)
        np.testing.assert_allclose(t["values"], values, atol=1e-5)


def test_registered_env_resolves_in_the_runner(runs):
    """``HOST_ENV`` is registered in this process only: the group carries
    its factory, and each runner steps it."""
    _, group, _ = runs
    assert group._spawn_args[3] is chip_smoke.HostCartPole
    ran = group.env_names()
    assert ran == ["HostCartPole(HostCartPole-v1)"] * 3
    weights = jax.device_get(j_models.ActorCriticModule(4, 2).init(
        jax.random.PRNGKey(0)))
    group.sync_weights(weights)
    trajs = group.sample(8)
    assert [t["obs"].shape for t in trajs] == [(8, 8, 4)] * 3
    logp, values = _jax_logp_value(weights, trajs[0]["obs"],
                                   trajs[0]["actions"])
    np.testing.assert_allclose(trajs[0]["logp_old"], logp, atol=1e-5)
    np.testing.assert_allclose(trajs[0]["values"], values, atol=1e-5)


def test_unregistered_name_fails_in_the_runner():
    """Without a registration (and not a gymnasium name) the runner's
    constructor fails, and the group raises its traceback."""
    with pytest.raises(RuntimeError, match="NoSuchEnv"):
        EnvRunnerGroup("NoSuchEnv-v0", 1, 2, SPEC, timeout_s=60)


def test_killed_runner_is_respawned_then_dropped(runs):
    """A killed runner's round contributes nothing, the runner is
    respawned (synced to the last weights: its samples' log-probs are
    the JAX module's on them) while the budget lasts, and past it the
    next dead one is dropped with its count."""
    _, group, spawned = runs
    weights = jax.device_get(j_models.ActorCriticModule(4, 2).init(
        jax.random.PRNGKey(2)))
    group.sync_weights(weights)
    victim = group.pids()[0]
    os.kill(victim, signal.SIGKILL)
    trajs = group.sample(4)
    assert len(trajs) == 2
    assert group.respawns_left == 0 and group.dropped_runners == 0
    assert len(group.runners) == 3 and victim not in group.pids()
    spawned += group.pids()
    trajs = group.sample(4)
    assert len(trajs) == 3
    logp, _ = _jax_logp_value(weights, trajs[-1]["obs"],
                              trajs[-1]["actions"])
    np.testing.assert_allclose(trajs[-1]["logp_old"], logp, atol=1e-5)
    os.kill(group.pids()[1], signal.SIGKILL)
    assert len(group.episode_stats()) >= 0
    assert group.dropped_runners == 1 and len(group.runners) == 2
    assert len(group.sample(4)) == 2


def test_runner_deadline_raises_timeout(runs):
    """A runner that does not answer within the group's deadline raises
    ``TimeoutError`` (a hang is not eaten), and its late reply is skipped
    by the next call."""
    _, group, _ = runs
    deadline = group.timeout_s
    group.timeout_s = 0.05
    try:
        with pytest.raises(TimeoutError, match="group deadline"):
            group.sample(20000)
    finally:
        group.timeout_s = deadline
    trajs = group.sample(2)
    assert all(t["obs"].shape[0] == 2 for t in trajs)
