"""Port parity: ``ray_tpu_torch.rl``'s core (``_respawn``, ``env``,
``models``, ``ppo``, ``algorithm``) against ``ray_tpu.rl`` on the CPU.

Inputs come from a numpy seed; both sides start from the same weights,
the JAX module's initialisation carried over by ``rl/convert.py``.
Tolerances: the CartPole step at atol 1e-6 (fp32 physics, one step),
GAE at 1e-5 (a sum over T = 64 steps in fp32), the loss and its grads at
rtol 1e-5, and the whole PPO update (8 Adam steps) at atol 1e-4 on the
parameters.  The reference's behaviour tests (``tests/test_rl.py``) run
here at their sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import _respawn as j_respawn
from ray_tpu.rl import env as j_env
from ray_tpu.rl import models as j_models
from ray_tpu.rl import ppo as j_ppo
from ray_tpu_torch.rl import (PPO, ActorCriticModule, AlgorithmConfig,
                              CartPoleEnv, PPOConfig, PPOLearner,
                              compute_gae)
from ray_tpu_torch.rl import _respawn as t_respawn
from ray_tpu_torch.rl import algorithm as t_algorithm
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl.convert import load_jax_weights, params_from_jax


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _assert_tree_close(got, want, atol, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], atol, rtol)
        return
    np.testing.assert_allclose(
        got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ------------------------------------------------------------ _respawn

def test_respawn_budget_matches_reference():
    """Both budgets respawn while the budget lasts, then drop and
    count."""
    runs = []
    for mod in (j_respawn, t_respawn):
        b = mod.RespawnBudget(2, "runner")
        spawned = iter(range(100))
        members = b.replace(["a"], 3, lambda: next(spawned))
        members = b.replace(members, 1, lambda: next(spawned))
        runs.append((members, b.respawns_left, b.dropped))
    assert runs[0] == runs[1] == (["a", 0, 1], 0, 2)


# ------------------------------------------------------------ env

def _cartpole_inputs(seed=0, batch=64):
    """States spread over the thresholds (some rows terminate), step
    counters at the time limit (some rows truncate), random actions."""
    rng = np.random.default_rng(seed)
    state = rng.uniform(-1, 1, size=(batch, 4)).astype(np.float32) \
        * np.array([2.5, 2.0, 0.22, 2.0], np.float32)
    steps = rng.integers(490, 500, size=batch).astype(np.int32)
    action = rng.integers(0, 2, size=batch).astype(np.int32)
    return state, steps, action


def test_cartpole_step_matches_jax():
    """Rows that are not done, and reward, terminated, truncated and
    final_obs of every row; auto-reset rows are fresh draws in
    [-0.05, 0.05] with their counter at 0."""
    state, steps, action = _cartpole_inputs()
    jenv, tenv = j_env.CartPoleEnv(), CartPoleEnv()
    (js, jsteps), jobs, jrew, jterm, jtrunc, jfinal = jenv.step(
        (jnp.asarray(state), jnp.asarray(steps)), jnp.asarray(action),
        jax.random.PRNGKey(3))
    gen = torch.Generator().manual_seed(3)
    (ts, tsteps), tobs, trew, tterm, ttrunc, tfinal = tenv.step(
        (_t(state), _t(steps)), _t(action), gen)
    jterm, jtrunc = np.asarray(jterm), np.asarray(jtrunc)
    np.testing.assert_array_equal(tterm.numpy(), jterm)
    np.testing.assert_array_equal(ttrunc.numpy(), jtrunc)
    assert 0 < jterm.sum() < len(state) and jtrunc.sum() > 0
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-6)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal),
                               atol=1e-6)
    live = ~(jterm | jtrunc)
    np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live],
                               atol=1e-6)
    np.testing.assert_array_equal(tsteps.numpy(), np.asarray(jsteps))
    reset = tobs.numpy()[~live]
    assert np.all(np.abs(reset) <= 0.05)
    assert torch.equal(ts, tobs)


def test_cartpole_reset_and_reference_physics_smoke():
    """The reference's physics test: 10 random steps keep the shapes,
    reward 1 everywhere, and nothing truncates."""
    env = CartPoleEnv()
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 8)
    assert obs.shape == (8, 4) and obs.abs().max() <= 0.05
    assert state[1].dtype == torch.int32
    for _ in range(10):
        action = torch.randint(0, 2, (8,), generator=gen)
        state, obs, reward, term, trunc, final_obs = env.step(state, action,
                                                              gen)
    assert obs.shape == (8, 4) and final_obs.shape == (8, 4)
    np.testing.assert_array_equal(reward.numpy(), np.ones(8))
    assert not bool(trunc.any())


def test_registry_and_gym_fallback():
    from ray_tpu_torch.rl import env as t_env

    assert isinstance(t_env.make_env("CartPole-v1"), CartPoleEnv)
    assert t_env.env_factory("CartPole-v1") is CartPoleEnv
    assert t_env.env_factory("NoSuchEnv-v0") is None
    t_env.register_env("TestCartPole-v9", CartPoleEnv)
    try:
        assert isinstance(t_env.make_env("TestCartPole-v9"), CartPoleEnv)
    finally:
        del t_env._ENVS["TestCartPole-v9"]
    gym = t_env.make_env("Acrobot-v1")  # not registered: gymnasium's
    assert isinstance(gym, t_env.GymVectorEnv)
    assert gym.spec == t_env.EnvSpec(6, 3, 500)


# ------------------------------------------------------------ models

def _module_params(seed=0, obs_dim=4, num_actions=2, hidden=(64, 64)):
    jm = j_models.ActorCriticModule(obs_dim, num_actions, hidden)
    tm = ActorCriticModule(obs_dim, num_actions, hidden)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, jp, params_from_jax(jp)


def test_converted_module_forward_matches_jax():
    jm, tm, jp, tp = _module_params()
    assert set(tp["pi"]) == {"w0", "b0", "w1", "b1", "w2", "b2"}
    assert tp["pi"]["w0"].shape == (4, 64) and tp["vf"]["w2"].shape == (64, 1)
    assert all(t.requires_grad and t.is_leaf
               for t in t_models.tree_leaves(tp))
    obs = np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32)
    jl, jv = jm.forward(jp, jnp.asarray(obs))
    tl, tv = tm.forward(tp, _t(obs))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-6)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-6)
    _assert_tree_close(t_models.to_host(tp), jp, atol=0)


def test_sample_action_with_jax_gumbel_noise():
    """``jax.random.categorical`` is argmax(logits + Gumbel(key)): fed
    the same Gumbel draw, the port samples the same actions and log-probs;
    its own noise has the same law (uniform on [tiny, 1))."""
    jm, tm, jp, tp = _module_params(seed=2, num_actions=5)
    obs = np.random.default_rng(2).normal(size=(256, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ja, jlogp = jm.sample_action(jp, jnp.asarray(obs), key)
    noise = np.asarray(jax.random.gumbel(key, (256, 5)))
    ta, tlogp = tm.sample_action(tp, _t(obs), noise=_t(noise))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlogp.detach().numpy(), np.asarray(jlogp),
                               atol=1e-6)
    g = t_models.gumbel((200_000,), torch.Generator().manual_seed(0))
    assert abs(float(g.mean()) - 0.5772) < 0.01  # Euler-Mascheroni


def test_one_hot_of_minus_one_is_zeros():
    idx = torch.tensor([-1, 0, 2, -1])
    np.testing.assert_array_equal(
        t_models.one_hot(idx, 3).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray([-1, 0, 2, -1]), 3)))


@pytest.mark.parametrize("max_norm", [None, 0.5, 1e3])
def test_adam_matches_optax(max_norm):
    """The learners' optimizer against ``optax.chain(clip_by_global_norm,
    adam)`` over five steps, the norm above and below the clip; a scalar
    leaf is one parameter."""
    rng = np.random.default_rng(0)
    params = {"a": {"w0": rng.normal(size=(4, 3)).astype(np.float32)},
              "s": np.float32(0.3)}
    tx = optax.adam(1e-2) if max_norm is None else optax.chain(
        optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
    jparams, jstate = jax.tree.map(jnp.asarray, params), None
    jstate = tx.init(jparams)
    tp = params_from_jax(params)
    opt = t_models.Adam(1e-2, max_norm)
    ts = opt.init(tp)
    for step in range(5):
        grads = {"a": {"w0": rng.normal(size=(4, 3)).astype(np.float32)
                       * (step + 1)}, "s": np.float32(rng.normal())}
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(tp, [_t(grads["a"]["w0"]), _t(grads["s"])], ts)
    _assert_tree_close(tp, jax.device_get(jparams), atol=1e-6)
    assert ts["count"] == 5


# ------------------------------------------------------------ ppo

def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 64, 16
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.1
    last = rng.normal(size=(B,)).astype(np.float32)
    ja, jr = j_ppo.compute_gae(jnp.asarray(rewards), jnp.asarray(values),
                               jnp.asarray(dones), jnp.asarray(last),
                               0.99, 0.95)
    ta, tr = compute_gae(_t(rewards), _t(values), _t(dones), _t(last),
                         0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_gae_reference_values():
    """The reference's GAE test: gamma = lambda = 1 with zero values
    sums the future rewards, and an episode boundary cuts the tail."""
    T, B = 5, 3
    rewards, values = torch.ones((T, B)), torch.zeros((T, B))
    dones = torch.zeros((T, B))
    advs, _ = compute_gae(rewards, values, dones, torch.zeros(B), 1.0, 1.0)
    np.testing.assert_allclose(advs[:, 0].numpy(), [5, 4, 3, 2, 1])
    dones[2] = 1.0
    advs, _ = compute_gae(rewards, values, dones, torch.zeros(B), 1.0, 1.0)
    np.testing.assert_allclose(advs[:, 0].numpy(), [3, 2, 1, 2, 1])


def _ppo_batch(n=256, seed=0, obs_dim=4, num_actions=2):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.normal(size=(n,)).astype(np.float32) * 3 + 1,
        "returns": rng.normal(size=(n,)).astype(np.float32),
    }


def _learners(cfg, seed=0):
    jl = j_ppo.PPOLearner(j_models.ActorCriticModule(4, 2), cfg, seed=seed)
    tl = PPOLearner(ActorCriticModule(4, 2), cfg, seed=seed, device="cpu")
    load_jax_weights(tl, {"params": jax.device_get(jl.params)})
    return jl, tl


def test_ppo_loss_and_grads_match_jax():
    """The clipped surrogate, value and entropy terms, and the
    normalisation by the batch std dividing by n."""
    jl, tl = _learners(PPOConfig())
    batch = _ppo_batch()
    (jtotal, jaux), jgrads = jax.value_and_grad(jl._loss, has_aux=True)(
        jl.params, jax.tree.map(jnp.asarray, batch))
    total, aux = tl._loss(tl.params, t_models.as_tensors(batch, "cpu"))
    grads = torch.autograd.grad(total, t_models.tree_leaves(tl.params))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


def test_ppo_whole_update_matches_jax_with_its_permutations():
    """JAX's whole ``_update_impl`` (two epochs of four minibatches under
    clip + Adam) against ``_update_with_perms`` fed
    ``jax.random.permutation(k, n)`` for each ``k`` of
    ``jax.random.split(key, num_epochs)``."""
    cfg = PPOConfig(num_epochs=2, num_minibatches=4)
    jl, tl = _learners(cfg, seed=3)
    batch = _ppo_batch(n=512, seed=4)
    key = jax.random.PRNGKey(11)
    jparams, _, jstep, jmetrics = jl._update_impl(
        jl.params, jl.opt_state, jnp.asarray(0, jnp.int32),
        jax.tree.map(jnp.asarray, batch), key)
    perms = [np.asarray(jax.random.permutation(k, 512))
             for k in jax.random.split(key, cfg.num_epochs)]
    metrics = tl._update_with_perms(batch, perms)
    _assert_tree_close(tl.params, jax.device_get(jparams), atol=1e-4)
    assert tl.step_count == int(jstep) == 8
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-4,
                                   atol=1e-5)


def test_learner_update_changes_params():
    """The reference's learner test: the update moves the params, the
    metrics are finite, and the step count is epochs x minibatches."""
    tl = PPOLearner(ActorCriticModule(4, 2),
                    PPOConfig(num_epochs=2, num_minibatches=2), device="cpu")
    before = tl.params["pi"]["w0"].detach().clone()
    metrics = tl.update(_ppo_batch(64), torch.Generator().manual_seed(1))
    assert not torch.allclose(before, tl.params["pi"]["w0"])
    assert np.isfinite(metrics["pi_loss"])
    assert tl.step_count == 4


def test_learner_state_round_trip():
    tl = PPOLearner(ActorCriticModule(4, 2), PPOConfig(num_epochs=1),
                    device="cpu")
    tl.update(_ppo_batch(64), torch.Generator().manual_seed(0))
    st = tl.get_state()
    assert st["opt_state"]["count"] == 4 and st["step_count"] == 4
    t2 = PPOLearner(ActorCriticModule(4, 2), PPOConfig(num_epochs=1),
                    seed=5, device="cpu")
    t2.set_state(st)
    _assert_tree_close(t2.params, st["params"], atol=0)
    _assert_tree_close(t2.opt_state["nu"], st["opt_state"]["nu"], atol=0)
    assert t2.step_count == 4
    assert all(t.requires_grad for t in t_models.tree_leaves(t2.params))


# ------------------------------------------------------------ rollout

def test_rollout_reads_nothing_back_to_the_host(monkeypatch):
    """The vectorized rollout syncs the host at no env step: every way a
    tensor reaches a Python value raises inside it."""
    module = ActorCriticModule(4, 2)
    env = CartPoleEnv()
    gen = torch.Generator().manual_seed(0)
    params = module.init(gen)
    state, obs = env.reset(gen, 8)
    rollout = __import__("ray_tpu_torch.rl.ppo", fromlist=["x"]) \
        .make_rollout_fn(module, env, 16, PPOConfig())

    def refuse(*a, **k):
        raise AssertionError("host sync inside the rollout")

    for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    state, obs, flat, stats = rollout(params, state, obs, gen)
    monkeypatch.undo()
    assert flat["obs"].shape == (128, 4) and flat["advantages"].shape == (128,)
    assert float(stats["reward_per_step"]) == 1.0


def test_rollout_targets_are_consistent():
    """The rollout's log-probs and GAE targets are those of its own
    trajectory: recomputed from the batch they agree."""
    module = ActorCriticModule(4, 2)
    gen = torch.Generator().manual_seed(1)
    params = module.init(gen)
    env = CartPoleEnv()
    state, obs = env.reset(gen, 16)
    from ray_tpu_torch.rl.ppo import make_rollout_fn

    _, _, flat, stats = make_rollout_fn(module, env, 32, PPOConfig())(
        params, state, obs, gen)
    with torch.no_grad():
        logp = torch.log_softmax(module.logits(params, flat["obs"]), -1)
        values = module.value(params, flat["obs"])
    np.testing.assert_allclose(
        t_models.take(logp, flat["actions"]).numpy(),
        flat["logp_old"].numpy(), atol=1e-6)
    np.testing.assert_allclose((flat["returns"] - flat["advantages"]).numpy(),
                               values.numpy(), atol=1e-5)
    assert int(stats["episodes_done"]) >= 0


# ------------------------------------------------------------ algorithm

def test_algorithm_config_builder():
    cfg = (AlgorithmConfig(PPO, device="cpu").environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .training(lr=1e-3, num_epochs=1, num_minibatches=2,
                     hidden_sizes=[16])
           .seed_(7))
    assert cfg.ppo.lr == 1e-3 and cfg.ppo.num_minibatches == 2
    assert cfg.hidden_sizes == (16,) and cfg.seed == 7
    assert cfg.device_("cpu") is cfg and cfg.device == "cpu"
    algo = cfg.build()
    assert isinstance(algo, PPO) and algo.runner_group is None
    m = algo.train()
    assert m["env_steps_this_iter"] == 32 and m["training_iteration"] == 1
    assert algo.learner.params["pi"]["w0"].shape == (4, 16)


def test_episode_reward_carries_the_last_estimate():
    algo = type("A", (), {"_last_ep_reward": float("nan")})()
    stats = {"episodes_done": torch.tensor(4),
             "reward_per_step": torch.tensor(1.0)}
    assert t_algorithm.episode_reward(algo, 100, stats) == 25.0
    stats["episodes_done"] = torch.tensor(0)
    assert t_algorithm.episode_reward(algo, 100, stats) == 25.0


def test_device_none_means_the_card():
    """No path runs on the CPU unless asked: without CUDA the default
    device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlgorithmConfig(PPO).environment("CartPole-v1").build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPOLearner(ActorCriticModule(4, 2), PPOConfig())


def test_ppo_learns_cartpole_fast_path():
    """The reference's learning test at its size (16 envs x 256 steps, 4
    epochs x 4 minibatches, 13 iterations): late > 1.5 x early and late
    > 40; then the checkpoint round trip."""
    algo = (AlgorithmConfig(PPO, device="cpu")
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=256)
            .training(lr=3e-4, num_epochs=4, num_minibatches=4)
            .seed_(0)
            .build())
    first = algo.train()
    assert first["env_steps_this_iter"] == 16 * 256
    rewards = [first["episode_reward_mean"]]
    for _ in range(12):
        rewards.append(algo.train()["episode_reward_mean"])
    early = np.mean(rewards[:2])
    late = np.mean(rewards[-3:])
    assert late > early * 1.5, f"no learning: early={early:.1f} late={late:.1f}"
    assert late > 40, f"late reward too low: {rewards}"
    st = algo.save_checkpoint()
    algo2 = (AlgorithmConfig(PPO, device="cpu").environment("CartPole-v1")
             .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                          rollout_fragment_length=256).build())
    algo2.load_checkpoint(st)
    assert algo2.iteration == algo.iteration
    _assert_tree_close(algo2.learner.params, st["learner"]["params"], atol=0)
    assert algo2.learner.step_count == algo.learner.step_count
    algo2.load_checkpoint({"params": st["learner"]["params"],
                           "iteration": 3})  # params-only format
    assert algo2.iteration == 3


def test_assemble_matches_gae_per_fragment():
    """The runner path's batch: the fragments' GAE in one loop over their
    columns side by side equals the reference's per-fragment GAE, rows in
    its order."""
    rng = np.random.default_rng(5)
    trajs = []
    for b in (3, 5):
        trajs.append({
            "obs": rng.normal(size=(16, b, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (16, b)),
            "logp_old": rng.normal(size=(16, b)).astype(np.float32),
            "rewards": rng.normal(size=(16, b)).astype(np.float32),
            "values": rng.normal(size=(16, b)).astype(np.float32),
            "dones": rng.random((16, b)) < 0.2,
            "last_value": rng.normal(size=(b,)).astype(np.float32)})
    algo = type("A", (), {"device": torch.device("cpu"),
                          "config": AlgorithmConfig()})()
    got = PPO._assemble(algo, trajs)
    want = {k: [] for k in ("advantages", "returns")}
    for t in trajs:
        a, r = j_ppo.compute_gae(*(jnp.asarray(t[k]) for k in (
            "rewards", "values", "dones", "last_value")), 0.99, 0.95)
        want["advantages"].append(np.asarray(a).reshape(-1))
        want["returns"].append(np.asarray(r).reshape(-1))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.concatenate(v),
                                   atol=1e-5)
    np.testing.assert_array_equal(
        got["obs"].numpy(),
        np.concatenate([t["obs"].reshape(-1, 4) for t in trajs]))
    np.testing.assert_array_equal(
        got["actions"].numpy(),
        np.concatenate([t["actions"].reshape(-1) for t in trajs]))
