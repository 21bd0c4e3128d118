"""Port parity: ``ray_tpu_torch.train`` (``TorchTrainer`` over spawned
worker processes, gloo on the CPU) against the reference's trainer tests
(``tests/test_train.py:21-160``) and, for the slice, against JAX's
single-process ``make_llama_trainer``.

The loops live in the JAX-free ``test_torch_trainer_loops.py``; every
worker runs one thread.  Several checks share one ``fit()`` where they
can (module fixtures).  JAX's side is computed after the workers.
"""

import os

import jax
import numpy as np
import pytest
import torch

import test_torch_trainer_loops as loops
from ray_tpu.models import llama as jllama
from ray_tpu.models import training as jtraining
from ray_tpu.parallel import MeshConfig, create_mesh
from ray_tpu_torch import train
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax

# fp32 sums over ranks in another order than JAX's (the dp cases of
# tests/test_torch_parallel.py)
ATOL, RTOL = 1e-5, 1e-4


def _cpu(num_workers=1, **kw):
    return train.ScalingConfig(num_workers=num_workers, use_gpu=False, **kw)


# ---------------------------------------------------------------------------
# one run of two workers: basic fit, ranks, config, datasets, allreduce,
# profile, run status
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report_run(tmp_path_factory):
    prof = tmp_path_factory.mktemp("profiles")
    trainer = train.TorchTrainer(
        loops.report_loop,
        train_loop_config={"lr": 0.1, "profile_dir": str(prof)},
        scaling_config=_cpu(2), datasets={"train": [1, 2, 3]},
        run_config=train.RunConfig(name="report-run"))
    return trainer, trainer.fit(), prof


def test_basic_fit(report_run):
    _, result, _ = report_run
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["rank"] == 0  # rank-0 metrics canonical
    assert result.metrics["lr"] == 0.1
    assert len(result.metrics_history) == 3
    assert [m["training_iteration"] for m in result.metrics_history] == \
        [1, 2, 3]


def test_world_size_and_rank(report_run):
    _, result, _ = report_run
    assert result.metrics["world"] == 2
    assert result.metrics["local_rank"] == 0
    assert result.metrics["trial"] == "report-run/g1"


def test_dataset_shard_plain_iterable(report_run):
    _, result, _ = report_run
    assert result.metrics["n"] == 3  # replicated


def test_collective_allreduce_in_loop(report_run):
    _, result, _ = report_run
    assert result.metrics["sum0"] == 3.0  # 1 + 2
    assert result.metrics["group_state"] == "READY"


def test_step_ledger_and_status_records_in_the_run_kv(report_run):
    """The supervised allreduce's wall time lands in the step ledger's
    ``collective_wait`` bucket, the ledger's breakdown and both members'
    status records are in the run's KV."""
    _, result, _ = report_run
    m = result.metrics
    assert m["collective_wait_s"] > 0 and m["ledger_published"]
    assert sorted(m["status_records"]) == [
        f"collective/train::report-run/g1/status/{r}" for r in (0, 1)]


def test_profile_writes_trace(report_run):
    _, _, prof = report_run
    for rank in (0, 1):
        path = prof / f"rank{rank}" / "trace.json"
        assert path.exists() and path.stat().st_size > 0


def test_run_status_in_kv(report_run):
    trainer, _, _ = report_run
    status = trainer.controller.status()
    assert status["status"] == "FINISHED"
    assert status["world_size"] == 2 and status["iteration"] == 3


# ---------------------------------------------------------------------------
# checkpoints and failures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def retry_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("retry")
    trainer = train.TorchTrainer(
        loops.checkpoint_loop,
        train_loop_config={"marker": str(tmp / "fail-once")},
        scaling_config=_cpu(1),
        run_config=train.RunConfig(
            name="ft-run", storage_path=str(tmp),
            failure_config=train.FailureConfig(max_failures=1)))
    return trainer.fit(), tmp


def test_failure_retry_resumes_from_checkpoint(retry_run):
    result, _ = retry_run
    assert result.error is None
    steps = [m["step"] for m in result.metrics_history]
    # steps 0, 1, then the injected failure; resumed at step 2
    assert steps == [0, 1, 2, 3]


def test_checkpoint_report_and_persist(retry_run):
    result, tmp = retry_run
    assert result.checkpoint is not None
    assert result.checkpoint.path.startswith(str(tmp / "ft-run"))
    with open(os.path.join(result.checkpoint.path, "step.txt")) as f:
        assert f.read() == "3"
    latest = train.latest_committed_checkpoint(str(tmp / "ft-run"))
    assert latest.path == result.checkpoint.path


def test_failure_exhausts_budget():
    result = train.TorchTrainer(
        loops.always_fails, scaling_config=_cpu(1),
        run_config=train.RunConfig(
            failure_config=train.FailureConfig(max_failures=1))).fit()
    assert result.error is not None
    assert "always fails" in str(result.error)
    assert "2 failure(s)" in str(result.error)


def test_use_gpu_without_cuda_raises(monkeypatch):
    """No fallback to the host: ``use_gpu=True`` without CUDA fails
    ``fit()`` before any worker starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = train.TorchTrainer(
        loops.always_fails,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.fit()


def test_loop_must_be_importable():
    def closure():
        return None

    with pytest.raises(TypeError, match="module-level function"):
        train.TorchTrainer(closure)
    with pytest.raises(TypeError, match="module-level function"):
        train.TorchTrainer(lambda: None)


def test_bad_mesh_preset_fails_at_construction():
    with pytest.raises(ValueError, match="unknown mesh preset"):
        train.TorchTrainer(loops.always_fails,
                           scaling_config=_cpu(1, mesh="fsdq"))


def test_tiered_checkpoints_are_refused():
    with pytest.raises(ValueError, match="mode='sync'"):
        train.CheckpointConfig(mode="tiered")


def test_session_api_outside_a_loop_raises():
    with pytest.raises(RuntimeError, match="No training session"):
        train.get_context().get_world_rank()


# ---------------------------------------------------------------------------
# the slice: two dp workers against JAX's single-process trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The port's two-worker dp run (the workers first), then JAX's
    single-process trainer on the full batch."""
    jcfg = jllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jax.jit(
        jllama.llama_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (8, 17)).astype(np.int32)
    result = train.TorchTrainer(
        loops.dp_llama_loop,
        train_loop_config={
            "params": params_from_jax(tree, tllama.LlamaConfig.tiny(),
                                      device="cpu"),
            "tokens": tokens,
            "ckpt_dir": str(tmp_path_factory.mktemp("dp_ckpt"))},
        scaling_config=_cpu(2, mesh="dp")).fit()
    tr = jtraining.make_llama_trainer(
        jcfg, create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]),
        optimizer=jtraining.default_optimizer(**loops.OPT))
    state = tr.init_state(jax.random.PRNGKey(0))
    batch = tr.shard_batch({"tokens": tokens})
    metrics = []
    for _ in range(loops.TRAIN_STEPS):
        state, m = tr.step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    want = {"metrics": metrics,
            "params": jax.tree.map(np.asarray, state["params"])}
    return result, want


def test_dp_trainer_matches_jax_full_batch(dp_run):
    """Three steps of ``make_llama_trainer`` on two dp workers, each
    feeding half the batch through ``shard_inputs``, against JAX's
    single-process trainer on the whole batch: loss and grad norm per
    step, and every param after step 3."""
    result, want = dp_run
    assert result.error is None, result.error
    got = result.metrics
    assert got["mesh"].startswith("DeviceMesh((dp=2")
    assert got["batch_rows"] == 8
    for (gl, gn), (wl, wn) in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(gl, wl, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(gn, wn, atol=ATOL, rtol=RTOL)
    _close_tree(got["params"], want["params"])


def _close_tree(got, want, what="params"):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what}/{k}")


def test_state_dict_checkpoint_round_trip(dp_run):
    """``from_state_dict`` on the dp mesh, then ``to_state_dict`` onto a
    fresh fsdp mesh: every tensor back bit for bit, on the target's mesh
    and placements; the checkpoint is the run's result."""
    result, _ = dp_run
    assert result.metrics["roundtrip_bit_equal"] is True
    assert os.path.exists(os.path.join(result.checkpoint.path, "state.pt"))
