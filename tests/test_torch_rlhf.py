"""The port's RLHF loop (``ray_tpu_torch/rl/rlhf.py``) against the
reference's: the trajectory ledger's state and the scripted reward equal
the reference's, the REINFORCE update and the actions' log-probabilities
against the reference's jitted functions from the same converted
parameters and batch; the end-to-end chaos loop of
``tests/test_rlhf.py`` on host slots (``device="cpu"``); and a drain
mid-loop (a quarantine of the learner's slot) after which the loop
resumes from its tiered checkpoint in peer RAM with a bumped publisher
epoch and versions above the committed ones.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl import rlhf as jrlhf
from ray_tpu.rl.models import ActorCriticModule as JModule
from ray_tpu_torch import train
from ray_tpu_torch.rl import RLHFConfig, RLHFLoop, TrajectoryLedger
from ray_tpu_torch.rl import rlhf
from ray_tpu_torch.rl.convert import params_from_jax
from ray_tpu_torch.rl.models import ActorCriticModule, take


# ---------------------------------------------------------------------------
# the ledger and the reward against the reference
# ---------------------------------------------------------------------------


def test_admit_is_exactly_once():
    led = TrajectoryLedger()
    assert led.admit(7)
    assert not led.admit(7)
    assert led.consumed == 1
    assert led.duplicates_rejected == 1


def test_roundtrip_preserves_consumed_ids():
    led = TrajectoryLedger()
    led.record_produced(3)
    led.admit(1)
    led.admit(2)
    led.record_dropped(1, "actor died")
    led2 = TrajectoryLedger.from_state(led.state_dict())
    assert not led2.admit(2)
    assert led2.admit(3)
    assert led2.dropped == 1
    assert led2.drop_reasons == {"actor died": 1}


def test_uid_bases_unique_across_mints():
    bases = {rlhf._mint_uid_base() for _ in range(512)}
    assert len(bases) == 512
    assert all(0 < b < 2 ** 63 and b & 0xFFFF == 0 for b in bases)


def test_ledger_state_dict_equals_the_reference():
    """One admit / produce / drop sequence through both ledgers gives the
    same ``state_dict``, and each restores the other's."""
    rng = np.random.default_rng(0)
    ops = [("produced", int(rng.integers(1, 4))) for _ in range(5)]
    ops += [("admit", int(u)) for u in rng.integers(0, 20, 40)]
    ops += [("dropped", (2, "sample deadline exceeded")),
            ("dropped", (1, "rollout actor died mid-sample (ActorDiedError)")),
            ("dropped", (1, "sample deadline exceeded"))]
    port, ref = TrajectoryLedger(), jrlhf.TrajectoryLedger()
    for kind, arg in ops:
        for led in (port, ref):
            if kind == "produced":
                led.record_produced(arg)
            elif kind == "admit":
                led.admit(arg)
            else:
                led.record_dropped(*arg)
    assert port.state_dict() == ref.state_dict()
    assert port.counts() == ref.counts()
    assert TrajectoryLedger.from_state(ref.state_dict()).state_dict() == \
        ref.state_dict()
    assert jrlhf.TrajectoryLedger.from_state(
        port.state_dict()).state_dict() == port.state_dict()


@pytest.mark.parametrize("seed", [0, 3])
def test_scripted_reward_bit_equal(seed):
    cfg, jcfg = RLHFConfig(seed=seed), jrlhf.RLHFConfig(seed=seed)
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((256, cfg.obs_dim)).astype(np.float32)
    actions = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    got = rlhf.scripted_reward(obs, actions, cfg)
    want = jrlhf.scripted_reward(obs, actions, jcfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(rlhf._gold_matrix(cfg), jrlhf._gold_matrix(jcfg))


# ---------------------------------------------------------------------------
# the learner against the reference's jitted update
# ---------------------------------------------------------------------------


def _jax_params(seed=0, cfg=None):
    cfg = cfg or RLHFConfig()
    module = JModule(cfg.obs_dim, cfg.vocab_size, cfg.hidden)
    return module, jax.tree.map(np.asarray,
                                module.init(jax.random.PRNGKey(seed)))


def _batch(seed, n=64, cfg=None):
    cfg = cfg or RLHFConfig()
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, cfg.obs_dim)).astype(np.float32)
    actions = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    return {"obs": obs, "actions": actions,
            "rewards": rlhf.scripted_reward(obs, actions, cfg)}


def test_action_log_probabilities_against_the_reference():
    cfg = RLHFConfig()
    jmod, jparams = _jax_params(1)
    mod = ActorCriticModule(cfg.obs_dim, cfg.vocab_size, cfg.hidden)
    params = params_from_jax(jparams, requires_grad=False)
    b = _batch(5, n=128)
    want = np.asarray(jnp.take_along_axis(
        jax.nn.log_softmax(jmod.logits(jparams, b["obs"])),
        b["actions"][..., None], axis=-1)[..., 0])
    got = take(torch.log_softmax(mod.logits(params, torch.from_numpy(
        b["obs"])), -1), torch.from_numpy(b["actions"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 2])
def test_reinforce_update_against_the_reference(seed):
    """Three chained Adam steps of REINFORCE with a batch-mean baseline
    from the same converted parameters and batches: the parameters after
    the third step within 1e-4 of the reference's.  Each step's loss,
    from the reference's parameters of that step converted, within 1e-6
    (the chained runs' own parameters drift apart by ~5e-6 per step, and
    their losses with them)."""
    cfg = RLHFConfig(seed=seed)
    jmod, jparams = _jax_params(seed, cfg)
    tx, jupdate = jrlhf._make_update_fn(jmod, cfg.lr)
    jstate = tx.init(jparams)
    mod = ActorCriticModule(cfg.obs_dim, cfg.vocab_size, cfg.hidden)
    params = params_from_jax(jparams)
    ptx, update = rlhf._make_update_fn(mod, cfg.lr)
    pstate = ptx.init(params)
    for step in range(3):
        b = _batch(10 * seed + step, cfg=cfg)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        same = params_from_jax(jparams)
        _, _, same_loss = update(same, ptx.init(same), tb)
        jparams, jstate, jloss = jupdate(
            jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        params, pstate, _ = update(params, pstate, tb)
        np.testing.assert_allclose(float(same_loss), float(jloss), rtol=0,
                                   atol=1e-6)
    for tower in ("pi", "vf"):
        for k, v in jparams[tower].items():
            np.testing.assert_allclose(params[tower][k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the loop on host slots
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_loop_survives_rollout_kill_and_publish_fault():
    """The reference's acceptance e2e on host slots: four iterations
    under a rollout-process kill, a publish fault and a reward fault."""
    cfg = RLHFConfig(
        iterations=4, num_rollout_actors=2, rollout_batch=32,
        learner_batch_size=32, name="rlhf-e2e", mesh="dp",
        sample_timeout_s=60.0, verify_weights_on_read=True,
        chaos={"kill_rollout_at_iter": 2, "publish_fault_at": 2,
               "reward_fault_at": 3},
        device="cpu")
    result = RLHFLoop(cfg).run()
    assert result.error is None, result.error
    m = result.metrics
    assert m["training_iteration"] == 4
    assert m["publish_faults_fired"] >= 1
    assert m["reward_faults_fired"] >= 1
    assert m["respawns_used"] >= 1
    assert m["trajectories_dropped"] >= 1
    assert m["duplicates_rejected"] == 0
    assert m["trajectories_consumed"] <= m["trajectories_produced"]
    cv = m["consumed_versions"]
    assert len(cv) >= 3
    assert all(a <= b for a, b in zip(cv, cv[1:])), cv
    assert m["published_version"] == 5
    assert m["publisher_epoch"] == 0
    assert m["rows_consumed"] > 0
    assert np.isfinite(m["loss"])
    # no rollout process ever rejected a payload, and each served the
    # newest version the learner consumed (v5 lands at their next sample)
    assert m["subscriber_stats"] and all(
        s["rejected"] == 0 and s["version"] == cv[-1]
        for s in m["subscriber_stats"])


def test_drain_mid_loop_resumes_from_the_tiered_checkpoint(tmp_path):
    """Two learners (ranks on slots 0 and 1, their params mean-allreduced
    each iteration) and a quarantine of slot 0 mid-loop: the controller's
    drain takes the iteration's tiered checkpoint (rank 0 its sole
    writer) and restarts the loop at world 1 on slot 1 without charge;
    the new learner restores from peer RAM (its local tier died with the
    old process), its publisher resumes above the committed version at
    epoch 1, and the loop completes."""
    from ray_tpu_torch._private import health_plane as HP

    cfg = RLHFConfig(iterations=6, num_rollout_actors=1, rollout_batch=16,
                     learner_batch_size=16, name="rlhf-drain",
                     iteration_interval_s=0.4, num_workers=2,
                     device="cpu")
    # RLHFLoop.run's trainer, under an elastic policy that can re-place
    # the learners on the slots left
    trainer = train.TorchTrainer(
        rlhf._rlhf_train_loop,
        train_loop_config={"rlhf": dataclasses.asdict(cfg)},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False,
                                           mesh=cfg.mesh),
        run_config=train.RunConfig(
            name="rlhf-drain", storage_path=str(tmp_path),
            checkpoint_config=train.CheckpointConfig(mode="tiered"),
            failure_config=train.FailureConfig(max_failures=0)),
        scaling_policy=train.ElasticScalingPolicy(1, 2, settle_s=0.2))
    seen = {}

    def saboteur():
        deadline = time.time() + 120
        while time.time() < deadline:
            ctl = trainer.controller
            if ctl is not None and len(ctl.metrics_history) >= 2:
                seen["before"] = dict(ctl.metrics_history[-1])
                seen["ack"] = HP.set_node_health(
                    ctl.kv, "slot:0", "QUARANTINED", "test: slot 0 sick")
                return
            time.sleep(0.02)

    t = threading.Thread(target=saboteur, daemon=True)
    t.start()
    result = trainer.fit()
    t.join(timeout=10)
    assert seen["ack"]["accepted"]
    assert result.error is None, result.error
    ctl = trainer.controller
    assert ctl.drain_restarts == 1 and ctl._ctx.errors_seen == 0
    assert seen["before"]["world"] == 2
    m = result.metrics
    assert m["world"] == 1
    assert m["training_iteration"] == 6
    assert m["restore_tier"] == "memory"
    assert 2 <= m["start_iteration"] < 6
    assert m["publisher_epoch"] >= 1
    assert seen["before"]["publisher_epoch"] == 0
    # the restarted publisher continued above every committed version
    assert m["published_version"] > seen["before"]["published_version"] \
        + (6 - m["start_iteration"])
    assert m["published_version"] > 1 + cfg.iterations
    assert m["duplicates_rejected"] == 0
    restarted = [h for h in result.metrics_history
                 if h.get("publisher_epoch") == 1]
    assert restarted and min(min(h["consumed_versions"])
                             for h in restarted if h["consumed_versions"]) \
        > seen["before"]["published_version"] - 1
