"""Port parity: ``ray_tpu_torch.rl``'s other families (``impala``,
``dqn``, ``sac``, ``bc``, ``cql``, ``multi_agent_env``,
``multi_agent_ppo``, ``dreamer``) against ``ray_tpu.rl`` on the CPU.

Each update check starts the JAX instance and the port's from the same
weights (``rl/convert.py``) and fresh optimizer state, feeds both the
same numpy batch, and holds the port's parameters after one update to
JAX's at atol 1e-5 (one Adam step of lr <= 1e-3 moves a parameter by
about lr; fp32 grads that agree to ~1e-6 relative move it by far less).
V-trace is held at atol 1e-5.  Dreamer's world-model loss runs with the
latent samples JAX draws: the test replays JAX's key schedule
(``k, ks_, kp = split(k, 3)`` per step) and hands the port each step's
Gumbel noise.  The reference's closures are reached through the jitted
functions' ``__wrapped__`` and their cells.  The reference's behaviour
tests run at their sizes, except Dreamer's whole-learning test (``slow``
in the reference).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import bc as j_bc
from ray_tpu.rl import cql as j_cql
from ray_tpu.rl import dqn as j_dqn
from ray_tpu.rl import dreamer as j_dreamer
from ray_tpu.rl import impala as j_impala
from ray_tpu.rl import models as j_models
from ray_tpu.rl import multi_agent_env as j_mae
from ray_tpu.rl import multi_agent_ppo as j_mappo
from ray_tpu.rl import sac as j_sac
from ray_tpu_torch import data as tdata
from ray_tpu_torch.rl import (APPO, BC, CQL, IMPALA, MARWIL,
                              ActorCriticModule, AlgorithmConfig, CQLParams,
                              DQNConfig, DreamerParams, DreamerV3,
                              ImpalaLearner, ImpalaParams, MultiAgentPPO,
                              PPOConfig, PursuitTagEnv, ReplayBuffer,
                              SACConfig, vtrace)
from ray_tpu_torch.rl import dreamer as t_dreamer
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl.convert import load_jax_weights

UPDATE_ATOL = 1e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(got, want, atol, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), (set(got), set(want))
        for k in want:
            _assert_tree_close(got[k], want[k], atol, rtol)
        return
    np.testing.assert_allclose(
        got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _closure(fn, name):
    """The reference's closure ``name`` of the (jitted) function ``fn``."""
    fn = getattr(fn, "__wrapped__", fn)
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells[name]


def _replay_batch(n=64, obs_dim=4, num_actions=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, n).astype(np.int32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "terminals": (rng.random(n) < 0.2).astype(np.float32)}


# ------------------------------------------------------------ impala

def _vtrace_inputs(T=32, B=8, seed=0):
    rng = np.random.default_rng(seed)
    return (np.log(rng.uniform(0.1, 0.9, (T, B))).astype(np.float32),
            np.log(rng.uniform(0.1, 0.9, (T, B))).astype(np.float32),
            rng.normal(size=(T, B)).astype(np.float32),
            rng.normal(size=(T, B)).astype(np.float32),
            rng.random((T, B)) < 0.1,
            rng.normal(size=(B,)).astype(np.float32))


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(clips):
    inputs = _vtrace_inputs()
    jvs, jpg = j_impala.vtrace(*map(jnp.asarray, inputs), 0.99, *clips)
    tvs, tpg = vtrace(*map(_t, inputs), 0.99, *clips)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=1e-5)
    np.testing.assert_allclose(tpg.numpy(), np.asarray(jpg), atol=1e-5)
    assert not tvs.requires_grad and not tpg.requires_grad


def test_vtrace_on_policy_reduces_to_discounted_returns():
    """The reference's test: behaviour == target and zero values give the
    discounted return bootstrapped from last_value."""
    T, B, gamma = 5, 3, 0.9
    rng = np.random.default_rng(0)
    rewards = torch.as_tensor(rng.normal(size=(T, B)), dtype=torch.float32)
    logp = torch.zeros((T, B))
    last = torch.as_tensor(rng.normal(size=(B,)), dtype=torch.float32)
    vs, pg = vtrace(logp, logp, rewards, torch.zeros((T, B)),
                    torch.zeros((T, B)), last, gamma)
    expected, acc = np.zeros((T, B), np.float32), last.numpy()
    for t in reversed(range(T)):
        acc = rewards[t].numpy() + gamma * acc
        expected[t] = acc
    np.testing.assert_allclose(vs.numpy(), expected, rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), expected, rtol=1e-5)


def _impala_batch(T=16, B=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "behaviour_logp": np.log(rng.uniform(0.2, 0.8, (T, B))
                                     ).astype(np.float32),
            "rewards": rng.normal(size=(T, B)).astype(np.float32),
            "dones": rng.random((T, B)) < 0.1,
            "last_value": rng.normal(size=(B,)).astype(np.float32)}


@pytest.mark.parametrize("clip_ratio", [None, 0.3], ids=["impala", "appo"])
def test_impala_learner_update_matches_jax(clip_ratio):
    cfg = ImpalaParams(clip_ratio=clip_ratio)
    jcfg = j_impala.ImpalaParams(clip_ratio=clip_ratio)
    jl = j_impala.ImpalaLearner(j_models.ActorCriticModule(4, 2), jcfg, 0)
    tl = ImpalaLearner(ActorCriticModule(4, 2), cfg, 0, device="cpu")
    load_jax_weights(tl, {"params": jax.device_get(jl.params)})
    batch = _impala_batch()
    jparams, _, jaux = jl._update(jl.params, jl.opt_state, _j(batch))
    aux = tl.update(batch)
    _assert_tree_close(tl.params, jax.device_get(jparams), UPDATE_ATOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k], float(v), rtol=1e-5, atol=1e-6)


def test_impala_learns_cartpole():
    """The reference's test: 26 iterations of 16 envs x 128 steps."""
    algo = (AlgorithmConfig(IMPALA, device="cpu")
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .seed_(0).build())
    rewards = [algo.train()["episode_reward_mean"]]
    for _ in range(25):
        rewards.append(algo.train()["episode_reward_mean"])
    early = np.nanmean(rewards[:3])
    late = np.nanmean(rewards[-3:])
    assert late > early * 1.5, f"no learning: early={early} late={late}"
    st = algo.save_checkpoint()
    algo2 = (AlgorithmConfig(IMPALA, device="cpu").environment("CartPole-v1")
             .env_runners(num_env_runners=0).build())
    algo2.load_checkpoint(st)
    assert algo2.iteration == algo.iteration
    _assert_tree_close(algo2.learner.params, st["learner"]["params"], 0)


def test_appo_clips_and_trains():
    algo = (AlgorithmConfig(APPO, device="cpu").environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .seed_(0).build())
    assert algo.params_cfg.clip_ratio == 0.3
    m = algo.train()
    assert np.isfinite(m["pi_loss"]) and m["training_iteration"] == 1
    assert m["env_steps_this_iter"] == 8 * 64


# ------------------------------------------------------------ dqn

def test_dqn_update_matches_jax():
    """Double-DQN target and Huber loss: one update from the same online
    and target weights."""
    jd = j_dqn.DQNConfig().environment("CartPole-v1").build()
    td = DQNConfig(device="cpu").environment("CartPole-v1").build()
    # a target unlike the online net, so the double-Q split is exercised
    target = jax.device_get(j_models.mlp_init(jax.random.PRNGKey(5),
                                              jd.sizes))
    load_jax_weights(td, {"q_params": jax.device_get(jd.q_params),
                          "target_params": target})
    batch = _replay_batch()
    batch["rewards"] *= 3  # some TD errors beyond Huber's delta
    jq, _, jloss = jd._update(jd.q_params, _j(target), jd.opt_state,
                              _j(batch))
    loss = td._update(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_tree_close(td.q_params, jax.device_get(jq), UPDATE_ATOL)
    _assert_tree_close(td.target_params, target, 0)


def test_dqn_learns_cartpole():
    algo = (DQNConfig(device="cpu").environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8)
            .training(learning_starts=300, epsilon_decay_steps=2500)
            .seed_(0).build())
    rewards = []
    for _ in range(12):
        rewards.append(algo.train(steps_per_iteration=512)[
            "episode_reward_mean"])
    early = np.nanmean(rewards[1:4])
    late = np.nanmean(rewards[-3:])
    assert late > early * 1.5, f"no learning: {rewards}"
    st = algo.save_checkpoint()
    algo2 = DQNConfig(device="cpu").environment("CartPole-v1").build()
    algo2.load_checkpoint(st)
    assert algo2.updates == algo.updates
    assert algo2.total_steps == algo.total_steps
    _assert_tree_close(algo2.target_params, st["target_params"], 0)
    # the update schedule resumes from the restored counters
    assert algo2._update_base == algo2.total_steps // 4 - algo2.updates


def test_replay_buffer_ring():
    buf = ReplayBuffer(capacity=10, obs_dim=2)
    for i in range(25):
        buf.add_batch(np.full((1, 2), i), [i % 3], [1.0],
                      np.full((1, 2), i + 1), [0.0])
    assert buf.size == 10 and buf.pos == 5
    sample = buf.sample(32, np.random.default_rng(0))
    assert sample["obs"].shape == (32, 2)
    assert sample["obs"].min() >= 15  # only the newest 10 remain
    jbuf = j_dqn.ReplayBuffer(capacity=10, obs_dim=2)
    for i in range(25):
        jbuf.add_batch(np.full((1, 2), i), [i % 3], [1.0],
                       np.full((1, 2), i + 1), [0.0])
    want = jbuf.sample(32, np.random.default_rng(0))
    for k, v in want.items():
        np.testing.assert_array_equal(sample[k], v)


# ------------------------------------------------------------ sac

def test_sac_update_matches_jax():
    """Twin Q against the soft target, the policy and temperature terms
    (``log_alpha`` a scalar leaf of Adam), then the Polyak target."""
    js = j_sac.SACConfig().environment("CartPole-v1").build()
    ts = SACConfig(device="cpu").environment("CartPole-v1").build()
    params = jax.device_get(js.params)
    params["log_alpha"] = np.float32(-0.7)
    target = jax.device_get(j_sac.SAC(
        j_sac.SACConfig().environment("CartPole-v1").seed_(3)).target)
    load_jax_weights(ts, {"params": params, "target": target})
    assert ts.params["log_alpha"].shape == ()
    batch = _replay_batch(seed=2)
    jp, jt, _, jaux = js._update(_j(params), _j(target), js.tx.init(
        _j(params)), _j(batch))
    aux = ts._update(batch)
    _assert_tree_close(ts.params, jax.device_get(jp), UPDATE_ATOL)
    _assert_tree_close(ts.target, jax.device_get(jt), 1e-6)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5)


def test_sac_learns_cartpole():
    algo = (SACConfig(device="cpu").environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8)
            .training(learning_starts=300)
            .seed_(0).build())
    rewards = []
    for _ in range(10):
        rewards.append(algo.train(steps_per_iteration=512)[
            "episode_reward_mean"])
    early = np.nanmean(rewards[1:4])
    late = np.nanmean(rewards[-3:])
    assert late > early * 1.2, f"no learning: {rewards}"
    st = algo.save_checkpoint()
    algo2 = SACConfig(device="cpu").environment("CartPole-v1").build()
    algo2.load_checkpoint(st)
    assert algo2.updates == algo.updates
    assert algo2.params["log_alpha"].requires_grad


# ------------------------------------------------------------ bc / marwil

@pytest.mark.parametrize("beta", [0.0, 1.0], ids=["bc", "marwil"])
def test_marwil_update_matches_jax(beta):
    """One update of BC (beta 0: the value tower untouched) and of MARWIL
    (the advantage weights over the batch std dividing by n)."""
    jcls, tcls = (j_bc.BC, BC) if beta == 0.0 else (j_bc.MARWIL, MARWIL)
    jm = jcls(4, 2, seed=1)
    tm = tcls(4, 2, seed=1, device="cpu")
    load_jax_weights(tm, {"params": jax.device_get(jm.params)})
    rng = np.random.default_rng(3)
    batch = {"obs": rng.normal(size=(128, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 128).astype(np.int32),
             "returns": (rng.normal(size=128) * 4).astype(np.float32)}
    jp, _, jaux = jm._update(jm.params, jm.opt_state, _j(batch))
    aux = tm._update(batch)
    _assert_tree_close(tm.params, jax.device_get(jp), UPDATE_ATOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5,
                                   atol=1e-7)


def test_bc_clones_scripted_policy():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2048, 4)).astype(np.float32)
    acts = (obs[:, 0] + obs[:, 2] > 0).astype(np.int32)
    bc = BC(4, 2, seed=0, device="cpu")
    for _ in range(10):
        bc.train_on({"obs": obs, "actions": acts}, batch_size=256)
    pred = bc.act_greedy(bc.params, obs).numpy()
    assert (pred == acts).mean() > 0.95


def test_marwil_requires_returns_and_trains():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    acts = (obs[:, 1] > 0).astype(np.int32)
    mw = MARWIL(4, 2, seed=0, device="cpu")
    with pytest.raises(ValueError):
        mw.train_on({"obs": obs, "actions": acts})
    rets = rng.normal(size=(512,)).astype(np.float32)
    m = mw.train_on({"obs": obs, "actions": acts, "returns": rets},
                    epochs=2)
    assert np.isfinite(m["pi_loss"]) and m["training_iteration"] == 1
    rows = [{"obs": o, "actions": int(a), "returns": float(r)}
            for o, a, r in zip(obs[:64], acts[:64], rets[:64])]
    assert np.isfinite(mw.train_on(rows, batch_size=32)["vf_loss"])
    st = mw.save_checkpoint()
    mw2 = MARWIL(4, 2, seed=5, device="cpu")
    mw2.load_checkpoint(st)
    _assert_tree_close(mw2.params, st["params"], 0)


# ------------------------------------------------------------ cql

def test_cql_update_matches_jax():
    jc = j_cql.CQL(4, 3, j_cql.CQLParams(cql_alpha=0.5), seed=2)
    tc = CQL(4, 3, CQLParams(cql_alpha=0.5), seed=2, device="cpu")
    target = jax.device_get(j_cql.CQL(4, 3, seed=9).params)
    load_jax_weights(tc, {"params": jax.device_get(jc.params),
                          "target": target})
    batch = _replay_batch(num_actions=3, seed=5)
    jp, jt, _, jaux = jc._update(jc.params, _j(target), jc.opt_state,
                                 _j(batch))
    aux = tc._update(batch)
    _assert_tree_close(tc.params, jax.device_get(jp), UPDATE_ATOL)
    _assert_tree_close(tc.target, jax.device_get(jt), 1e-6)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5)


def _cql_data(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    good = (obs[:, 0] > 0).astype(np.int32)
    actions = np.where(rng.random(n) < 0.9, good, 1 - good).astype(np.int32)
    return good, {
        "obs": obs, "actions": actions,
        "rewards": (actions == good).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "terminals": np.ones((n,), np.float32),
    }


def test_cql_offline_learns_greedy_policy():
    good, data = _cql_data()
    cql = CQL(4, 2, CQLParams(cql_alpha=1.0), seed=0, device="cpu")
    for _ in range(15):
        m = cql.train_on(data, batch_size=512)
    pred = cql.act_greedy(cql.params, data["obs"]).numpy()
    assert (pred == good).mean() > 0.9
    assert m["cql_penalty"] < 3.0
    with pytest.raises(ValueError, match="missing"):
        cql.train_on({"obs": data["obs"], "actions": data["actions"]})


def test_cql_reads_the_ports_dataset_and_rows():
    """``_iter_batches`` over a ``ray_tpu_torch.data.Dataset`` of rows
    (array-valued columns), over row dicts, and over a column dict gives
    the same batches."""
    _, data = _cql_data(n=96, seed=1)
    rows = [{k: data[k][i] for k in data} for i in range(96)]
    cql = CQL(4, 2, seed=0, device="cpu")
    by_dict = list(cql._iter_batches(data, 32))
    by_rows = list(cql._iter_batches(rows, 32))
    by_ds = list(cql._iter_batches(tdata.from_items(rows), 32))
    assert len(by_dict) == len(by_rows) == len(by_ds) == 3
    for a, b, c in zip(by_dict, by_rows, by_ds):
        for k in CQL.REQUIRED:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    assert np.isfinite(cql.train_on(tdata.from_items(rows),
                                    batch_size=32)["td_loss"])


# ------------------------------------------------------------ multi-agent

def test_pursuit_tag_step_matches_jax():
    rng = np.random.default_rng(0)
    B = 64
    pos = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    steps = rng.integers(120, 128, B).astype(np.int32)
    acts = {a: rng.integers(0, 3, B).astype(np.int32)
            for a in ("pursuer", "evader")}
    jenv, tenv = j_mae.PursuitTagEnv(), PursuitTagEnv()
    (jpos, jsteps), jobs, jrew, jterm, jtrunc, jfinal = jenv.step(
        (jnp.asarray(pos), jnp.asarray(steps)), _j(acts),
        jax.random.PRNGKey(0))
    (tpos, tsteps), tobs, trew, tterm, ttrunc, tfinal = tenv.step(
        (_t(pos), _t(steps)), {k: _t(v) for k, v in acts.items()},
        torch.Generator().manual_seed(0))
    jterm, jtrunc = np.asarray(jterm), np.asarray(jtrunc)
    np.testing.assert_array_equal(tterm.numpy(), jterm)
    np.testing.assert_array_equal(ttrunc.numpy(), jtrunc)
    assert jterm.any() and jtrunc.any()
    live = ~(jterm | jtrunc)
    for a in ("pursuer", "evader"):
        np.testing.assert_allclose(trew[a].numpy(), np.asarray(jrew[a]),
                                   atol=1e-6)
        np.testing.assert_allclose(tfinal[a].numpy(), np.asarray(jfinal[a]),
                                   atol=1e-6)
        np.testing.assert_allclose(tobs[a].numpy()[live],
                                   np.asarray(jobs[a])[live], atol=1e-6)
    np.testing.assert_array_equal(tsteps.numpy(), np.asarray(jsteps))
    assert np.all(np.abs(tpos.numpy()[~live]) <= 0.8)
    np.testing.assert_allclose(trew["pursuer"].numpy(),
                               -trew["evader"].numpy(), rtol=1e-6)
    _, obs0 = tenv.reset(torch.Generator().manual_seed(1), 8)
    assert set(obs0) == {"pursuer", "evader"}
    assert obs0["pursuer"].shape == (8, 4)


def test_independent_policies_receive_distinct_updates():
    """The reference's test: both learners start identical (same seed)
    and diverge on the zero-sum env."""
    ma = MultiAgentPPO(PursuitTagEnv(), num_envs=8, rollout_len=32,
                       config=PPOConfig(num_epochs=2, num_minibatches=2),
                       seed=0, device="cpu")
    assert set(ma.learners) == {"pursuer", "evader"}
    for a, b in zip(t_models.tree_leaves(ma.learners["pursuer"].params),
                    t_models.tree_leaves(ma.learners["evader"].params)):
        assert torch.equal(a, b)
    for _ in range(3):
        metrics = ma.train()
    rp = metrics["agent/pursuer/reward_per_step"]
    re = metrics["agent/evader/reward_per_step"]
    assert rp == pytest.approx(-re, rel=1e-5)
    assert "policy/pursuer" in metrics and "policy/evader" in metrics
    diverged = any(not torch.allclose(a, b) for a, b in zip(
        t_models.tree_leaves(ma.learners["pursuer"].params),
        t_models.tree_leaves(ma.learners["evader"].params)))
    assert diverged, "independent learners never diverged"


def test_shared_policy_trains_on_all_agents_data():
    ma = MultiAgentPPO(
        PursuitTagEnv(),
        policy_mapping={"pursuer": "shared", "evader": "shared"},
        num_envs=8, rollout_len=32,
        config=PPOConfig(num_epochs=1, num_minibatches=2), seed=0,
        device="cpu")
    assert set(ma.learners) == {"shared"}
    m = ma.train()
    assert m["agent_steps_this_iter"] == 2 * 8 * 32
    assert m["env_steps_this_iter"] == 8 * 32
    assert "policy/shared" in m


def test_multi_agent_checkpoint_roundtrip():
    kw = dict(num_envs=4, rollout_len=16, device="cpu",
              config=PPOConfig(num_epochs=1, num_minibatches=1))
    ma = MultiAgentPPO(PursuitTagEnv(), seed=0, **kw)
    ma.train()
    state = ma.save_checkpoint()
    ma2 = MultiAgentPPO(PursuitTagEnv(), seed=9, **kw)
    ma2.load_checkpoint(state)
    assert ma2.iteration == 1
    for pid in ma.learners:
        _assert_tree_close(ma2.learners[pid].params,
                           ma.get_policy_params(pid), 0)


def test_multi_agent_rollout_matches_single_agent_gae():
    """The joint rollout's per-agent targets are its own trajectory's:
    returns - advantages are the values of the batch's observations."""
    ma = MultiAgentPPO(PursuitTagEnv(), num_envs=4, rollout_len=16, seed=2,
                       device="cpu")
    params = {pid: ln.params for pid, ln in ma.learners.items()}
    _, _, batches, stats = ma._rollout(params, ma.env_state, ma.obs,
                                       ma.gen)
    for aid, b in batches.items():
        with torch.no_grad():
            v = ma.modules[aid].value(params[aid], b["obs"])
        np.testing.assert_allclose((b["returns"] - b["advantages"]).numpy(),
                                   v.numpy(), atol=1e-5)
    assert float(stats["pursuer"]["reward_per_step"]) == pytest.approx(
        -float(stats["evader"]["reward_per_step"]), rel=1e-5)


def test_pursuer_learns_to_close_distance():
    """The reference's learning smoke from the reference's initial
    weights (seed 1, converted): both roles start from one policy, so
    whether the pursuer starts by chasing or by fleeing is a property of
    the initial weights, and the pursuer's reward must improve from
    there."""
    cfg = dict(num_envs=32, rollout_len=64, seed=1)
    jma = j_mappo.MultiAgentPPO(j_mae.PursuitTagEnv(), **cfg)
    ma = MultiAgentPPO(PursuitTagEnv(), device="cpu",
                       config=PPOConfig(lr=5e-3, num_epochs=4,
                                        num_minibatches=4), **cfg)
    for pid, learner in ma.learners.items():
        load_jax_weights(learner, {"params": jax.device_get(
            jma.learners[pid].params)})
    rewards = [ma.train()["agent/pursuer/reward_per_step"]
               for _ in range(15)]
    early = float(np.mean(rewards[:3]))
    late = float(np.mean(rewards[-3:]))
    assert late > early, (
        f"pursuer did not improve: early={early:.3f} late={late:.3f} "
        f"({[round(r, 2) for r in rewards]})")


# ------------------------------------------------------------ dreamer

SMALL = DreamerParams(deter_dim=32, codes=4, classes=4, hidden=(32,),
                      bins=21, horizon=5, batch_size=4, batch_length=6)


@pytest.fixture(scope="module")
def dreamers():
    """The JAX learner and the port's, the port holding JAX's weights."""
    jp = j_dreamer.DreamerParams(**{f: getattr(SMALL, f) for f in
                                    SMALL.__dataclass_fields__})
    jd = j_dreamer.DreamerV3("CartPole-v1", jp, num_envs=4, seed=0)
    td = DreamerV3("CartPole-v1", SMALL, num_envs=4, seed=0, device="cpu")
    load_jax_weights(td, {k: jax.device_get(getattr(jd, k)) for k in
                          ("wm", "actor", "critic", "critic_ema")})
    return jd, td


def test_symlog_twohot_match_jax():
    x = np.concatenate([np.linspace(-30, 30, 97), [0.0, 1e-4, -20.0, 20.0,
                                                   19.99]]).astype(np.float32)
    np.testing.assert_allclose(t_dreamer.symlog(_t(x)).numpy(),
                               np.asarray(j_dreamer.symlog(x)), rtol=1e-6)
    y = np.linspace(-3, 3, 41).astype(np.float32)
    np.testing.assert_allclose(t_dreamer.symexp(_t(y)).numpy(),
                               np.asarray(j_dreamer.symexp(y)), rtol=1e-6)
    # the integers -20..20: torch's linspace hits them exactly, XLA's
    # fused start * (1 - t) + stop * t misses some by an ulp
    np.testing.assert_allclose(t_dreamer.bucket_edges(41).numpy(),
                               np.asarray(j_dreamer.bucket_edges(41)),
                               atol=2e-6)
    for bins in (41, 21):
        np.testing.assert_allclose(
            t_dreamer.twohot(_t(x), bins).numpy(),
            np.asarray(j_dreamer.twohot(jnp.asarray(x), bins)), atol=1e-6)


def test_dreamer_cells_match_jax(dreamers):
    """The GRU cell, the unimix latent distribution, the KL over codes,
    the two-hot head's mean and loss: the reference's closures against
    the port's functions on the same weights."""
    jd, td = dreamers
    p = SMALL
    wm_loss_fn = _closure(jd._wm_update, "wm_loss")
    gru, latent_dist, kl, dist_loss = (
        _closure(wm_loss_fn, n) for n in ("gru", "latent_dist", "kl",
                                          "dist_loss"))
    dist_mean = _closure(jd._ac_update, "dist_mean")
    rng = np.random.default_rng(0)
    N, Z = 6, p.codes * p.classes
    h = rng.normal(size=(N, p.deter_dim)).astype(np.float32)
    z = rng.normal(size=(N, Z)).astype(np.float32)
    a = np.eye(2, dtype=np.float32)[rng.integers(0, 2, N)]
    jwm = jax.device_get(jd.wm)
    np.testing.assert_allclose(
        t_dreamer.gru(td.wm, _t(h), _t(z), _t(a)).detach().numpy(),
        np.asarray(gru(jwm, h, z, a)), atol=1e-6)
    logits = (rng.normal(size=(N, Z)) * 3).astype(np.float32)
    la = t_dreamer.latent_dist(_t(logits), p)
    np.testing.assert_allclose(la.numpy(),
                               np.asarray(latent_dist(logits)), atol=1e-6)
    lb = t_dreamer.latent_dist(_t(logits[::-1].copy()), p)
    np.testing.assert_allclose(
        t_dreamer.kl(la, lb).numpy(),
        np.asarray(kl(latent_dist(logits),
                      latent_dist(logits[::-1].copy()))), atol=1e-5)
    heads = (rng.normal(size=(N, p.bins)) * 2).astype(np.float32)
    target = (rng.normal(size=N) * 10).astype(np.float32)
    np.testing.assert_allclose(t_dreamer.dist_mean(_t(heads), p).numpy(),
                               np.asarray(dist_mean(heads)), rtol=1e-5)
    np.testing.assert_allclose(
        t_dreamer.dist_loss(_t(heads), _t(target), p).numpy(),
        np.asarray(dist_loss(heads, target)), rtol=1e-5)


def test_dreamer_lambda_returns_match_reference():
    """``lambda_returns`` against the reference's reverse scan
    (``dreamer.py:329-335``, inside ``actor_loss``, transcribed here as a
    ``lax.scan`` since the closure is not reachable)."""
    rng = np.random.default_rng(1)
    H, N, lam = 12, 9, 0.95
    rew = rng.normal(size=(H, N)).astype(np.float32)
    disc = (0.99 * rng.uniform(0, 1, (H, N))).astype(np.float32)
    val = rng.normal(size=(H + 1, N)).astype(np.float32)

    rew_j, disc_j, val_j = map(jnp.asarray, (rew, disc, val))

    def lam_step(nxt, t):
        g = rew_j[t] + disc_j[t] * ((1 - lam) * val_j[t + 1] + lam * nxt)
        return g, g

    _, want = jax.lax.scan(lam_step, jnp.asarray(val[-1]), jnp.arange(H),
                           reverse=True)
    got = t_dreamer.lambda_returns(_t(rew), _t(disc), _t(val), lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _wm_batch(p, seed=0):
    rng = np.random.default_rng(seed)
    B, T = p.batch_size, p.batch_length
    first = (rng.random((B, T)) < 0.2).astype(np.float32)
    first[:, 0] = 1.0
    return {"obs": rng.normal(size=(B, T, 4)).astype(np.float32),
            "act": rng.integers(0, 2, (B, T)).astype(np.int32),
            "rew": (rng.normal(size=(B, T)) * 2).astype(np.float32),
            "cont": (rng.random((B, T)) > 0.1).astype(np.float32),
            "first": first}


def _jax_latent_noise(key, p):
    """The Gumbel draws JAX's ``wm_loss`` makes: per step ``k, ks_, kp =
    split(k, 3)`` and ``categorical(ks_, logp)`` =
    argmax(logp + gumbel(ks_, logp.shape))."""
    out, k = [], key
    for _ in range(p.batch_length):
        k, ks_, _ = jax.random.split(k, 3)
        out.append(np.asarray(jax.random.gumbel(
            ks_, (p.batch_size, p.codes, p.classes))))
    return torch.as_tensor(np.stack(out))


def test_dreamer_world_model_loss_and_update_match_jax(dreamers):
    """The world-model loss with JAX's latent samples (straight-through
    codes, KL balance with free bits, two-hot reward and the continue
    head), its aux, and one clipped-Adam update of the world model."""
    jd, td = dreamers
    p = SMALL
    batch = _wm_batch(p)
    key = jax.random.PRNGKey(4)
    noise = _jax_latent_noise(key, p)
    jwm_loss = _closure(jd._wm_update, "wm_loss")
    jtotal, jaux = jwm_loss(jd.wm, _j(batch), key)
    total, aux = t_dreamer.wm_loss(td.wm, t_models.as_tensors(batch, "cpu"),
                                   p, 2, noise=noise)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in ("recon", "reward_loss", "kl"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(aux["zs"].numpy(), np.asarray(jaux["zs"]),
                               atol=1e-5)
    np.testing.assert_allclose(aux["hs"].numpy(), np.asarray(jaux["hs"]),
                               atol=1e-5)
    jwm, _, _ = jd._wm_update(jd.wm, jd.wm_opt, _j(batch), key)
    td = copy.deepcopy(td)  # the module's learner keeps JAX's weights
    td._wm_update(t_models.as_tensors(batch, "cpu"), noise)
    _assert_tree_close(td.wm, jax.device_get(jwm), UPDATE_ATOL)


def test_dreamer_policy_step_with_no_previous_action(dreamers):
    """``policy_step`` with ``prev_a = -1`` (the episode start: a zero
    one-hot) against the reference's, fed JAX's two draws."""
    jd, td = dreamers
    p = SMALL
    rng = np.random.default_rng(2)
    N = 4
    obs = rng.normal(size=(N, 4)).astype(np.float32)
    h = rng.normal(size=(N, p.deter_dim)).astype(np.float32)
    z = np.zeros((N, p.codes * p.classes), np.float32)
    prev = np.array([-1, 0, 1, -1], np.int32)
    key = jax.random.PRNGKey(9)
    jh, jz, ja = jd._policy_step(jd.wm, jd.actor, h, z, obs, prev, key)
    ka, kz = jax.random.split(key)
    noise = (torch.as_tensor(np.asarray(jax.random.gumbel(
        kz, (N, p.codes, p.classes)))),
        torch.as_tensor(np.asarray(jax.random.gumbel(ka, (N, 2)))))
    th, tz, ta = t_dreamer.policy_step(td.wm, td.actor, _t(h), _t(z),
                                       _t(obs), _t(prev), p, 2, None,
                                       noise=noise)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_dreamer_actor_critic_update_runs(dreamers):
    """The imagination actor-critic step on the port's own draws: finite
    losses, the critic's EMA moved toward the critic, the world model
    untouched."""
    td = copy.deepcopy(dreamers[1])
    p = SMALL
    wm_before = t_models.copy_tree(td.wm)
    ema_before = t_models.copy_tree(td.critic_ema)
    aux = td._wm_update(t_models.as_tensors(_wm_batch(p, 1), "cpu"))
    wm_after = t_models.copy_tree(td.wm)
    out = td._ac_update(aux["hs"], aux["zs"])
    assert all(np.isfinite(float(v)) for v in out.values())
    _assert_tree_close(td.wm, t_models.to_host(wm_after), 0)
    assert not torch.allclose(wm_before["enc"]["w0"], wm_after["enc"]["w0"])
    moved = [not torch.equal(a, b) for a, b in zip(
        t_models.tree_leaves(ema_before),
        t_models.tree_leaves(td.critic_ema))]
    assert any(moved)


def test_dreamer_world_model_learns():
    """The reference's test: the world-model losses fall as the RSSM fits
    the env (8 iterations of 256 env steps, train_ratio 2); then the
    checkpoint round trip."""
    d = DreamerV3("CartPole-v1", DreamerParams(train_ratio=2), num_envs=8,
                  seed=0, device="cpu")
    firsts, lasts = None, None
    for _ in range(8):
        m = d.train(256)
        if "wm_total" in m and firsts is None:
            firsts = m["wm_total"]
        if "wm_total" in m:
            lasts = m["wm_total"]
    assert firsts is not None and lasts < firsts * 0.7, (firsts, lasts)
    st = d.save_checkpoint()
    d2 = DreamerV3("CartPole-v1", DreamerParams(), num_envs=8,
                   device="cpu")
    d2.load_checkpoint(st)
    assert d2.iteration == d.iteration
    _assert_tree_close(d2.wm, st["wm"], 0)
    assert d2.wm_opt["count"] == d.wm_opt["count"] > 0


def test_chip_smoke_rl_checks_run_on_the_cpu():
    """``chip_smoke.py``'s RL checks (the card's CPU-against-card
    comparisons, and its card tests') rehearsed on the CPU against
    itself: every family iterates with finite losses, and every
    comparison runs and reads 0."""
    import chip_smoke

    assert chip_smoke.rl_small_ppo_check("cpu")[
        "update_params_max_abs_err"] == 0.0
    out = chip_smoke.rl_families("cpu", small=True, iters=2)
    assert set(out) == {"dqn", "sac", "impala", "appo", "cql", "bc",
                        "marwil", "dreamer"}
    for name, f in out.items():
        assert f["finite"], name
        assert f["vs_cpu"]["update_params_max_abs_err"] == 0.0, name
