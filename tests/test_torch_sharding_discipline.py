"""Layout discipline of the port: the sharded train step runs with ZERO
implicit DTensor redistributes on every mesh the trainer path can form
(counterpart of ``tests/test_sharding_discipline.py``'s golden-sharding
gate, whose XLA resharding warnings are DTensor's implicit redistributes
here: ``ray_tpu_torch/parallel/redistributes.py``).

One spawn of four gloo ranks (``tests/test_torch_sharding_discipline_
ranks.py``, a file store in pytest's tmp dir, one thread each, joined
with a timeout that kills them) runs three steps of the tiny Llama
trainer on each ``MESH_PRESETS`` entry, for two models (the reference
test's, and the path ``chip_smoke.py``'s ``mesh4`` runs: flash attention,
``save_attn``, bf16 activations, a loss mask), with the fixed constraint
set and with ``RAY_TPU_LEGACY_SHARDING=1``.  The legacy set, the port's
constraints before the discipline, must count implicit redistributes,
or the zeros prove nothing.  The discipline changes layouts, not the
model: the losses of both sets agree.  No JAX runs here: the reference
test has no JAX numbers to hold these to beyond its gate.

Then the capture's units: the counting helper on text, and (in the
ranks) an explicit redistribute counting nothing, two ops DTensor must
reshard for counting one each, nested captures; and the hook raising
where DTensor's dispatch has nothing to attach to.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from ray_tpu_torch.parallel import MESH_PRESETS, count_implicit_redistributes
from ray_tpu_torch.parallel import redistributes

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = os.path.join(HERE, "test_torch_sharding_discipline_ranks.py")
sys.path.insert(0, HERE)

import test_torch_sharding_discipline_ranks as R  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240


def _tail(path, n=3000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError as e:
        return str(e)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("discipline_ranks")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    env.pop("RAY_TPU_LEGACY_SHARDING", None)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, RANKS, str(WORLD), str(r), str(work)], env=env,
        stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        for p in procs:
            remaining = SPAWN_TIMEOUT_S - (time.monotonic() - t0)
            try:
                p.wait(timeout=max(remaining, 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} "
                            f"s; rank 0's log:\n{_tail(work / 'rank0.log')}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"ranks {bad} exited non-zero; rank {bad[0]}'s log:\n"
                    + _tail(work / f"rank{bad[0]}.log"))
    return torch.load(work / "results.pt")


def _case(results, preset, config, legacy):
    got = results[R.case_name(preset, config, legacy)]
    if "error" in got:
        pytest.fail(f"{R.case_name(preset, config, legacy)} raised in the "
                    f"ranks:\n{got['error']}")
    return got


def test_cases_cover_every_preset(results):
    names = {R.case_name(*c) for c in R.cases()}
    for preset in MESH_PRESETS:
        for config in R.CONFIGS:
            assert R.case_name(preset, config, False) in names
            assert R.case_name(preset, config, True) in names
    assert names <= set(results)


@pytest.mark.parametrize("config", sorted(R.CONFIGS))
@pytest.mark.parametrize("preset", sorted(MESH_PRESETS))
def test_every_preset_steps_with_no_implicit_redistribute(results, preset,
                                                          config):
    got = _case(results, preset, config, False)
    assert got["count_by_rank"] == [0] * WORLD, got["lines"]


@pytest.mark.parametrize("config", sorted(R.CONFIGS))
@pytest.mark.parametrize("preset", sorted(MESH_PRESETS))
def test_legacy_constraints_still_reshard(results, preset, config):
    """The count is not quiet by construction: the constraint set before
    the discipline reshards on every rank of every preset."""
    got = _case(results, preset, config, True)
    assert all(n >= 1 for n in got["count_by_rank"]), got
    assert count_implicit_redistributes(got["lines"]) == len(got["lines"])


@pytest.mark.parametrize("preset", sorted(MESH_PRESETS))
def test_fixed_and_legacy_losses_match(results, preset):
    """Layouts, never numerics: the reference test's fp32 model gives
    bit-equal losses at every step.  The bf16 model with a loss mask:
    the first loss to rtol 1e-6 (the fixed set divides the masked sum
    after its all-reduce, the legacy one each rank's partial sum before
    it), the later ones to rtol 1e-4 (their gradients are reduced in
    another order: bf16 activations carry that into the params)."""
    fixed = _case(results, preset, "reference", False)["losses"]
    legacy = _case(results, preset, "reference", True)["losses"]
    assert len(fixed) == R.STEPS and fixed == legacy
    assert fixed[-1] < fixed[0]  # the steps train
    fixed = _case(results, preset, "flash_bf16", False)["losses"]
    legacy = _case(results, preset, "flash_bf16", True)["losses"]
    assert fixed[0] == pytest.approx(legacy[0], rel=1e-6)
    assert fixed == pytest.approx(legacy, rel=1e-4)


def test_capture_units_in_the_ranks(results):
    got = results["units"]
    assert "error" not in got, got.get("error")
    assert got["explicit"] == 0
    assert got["inner"] == 1 and got["outer"] == 2
    assert got["outer_ops"] == ["aten.clamp_min.default", "aten.mul.Tensor"]
    assert got["inner_lines"] == [
        "implicit redistribute: aten.mul.Tensor (R) -> (S(0))"]


def test_counting_helper():
    text = ("implicit redistribute: aten.mm.default (R, S(1)) -> (R, R)\n"
            "some unrelated line\n"
            "implicit redistribute: aten.mul.Tensor (R) -> (S(0))\n"
            "  implicit redistribute: indented, not a record\n")
    assert count_implicit_redistributes(text) == 2
    assert count_implicit_redistributes(text.splitlines()) == 2
    assert count_implicit_redistributes("all clean") == 0
    assert count_implicit_redistributes([]) == 0


def test_capture_on_plain_tensors_counts_nothing():
    with redistributes.redistribute_capture() as cap:
        torch.ones(3).clamp_min(0.0) * torch.ones(3)
    assert cap["count"] == 0 and cap["ops"] == [] and cap["lines"] == []


def test_hook_raises_where_dispatch_has_nothing_to_attach(monkeypatch):
    from torch.distributed.tensor import _dispatch

    monkeypatch.setattr(redistributes, "_attached", False)
    monkeypatch.delattr(_dispatch, "redistribute_local_tensor")
    with pytest.raises(RuntimeError, match="would read 0 unheard"):
        with redistributes.redistribute_capture():
            pass


def test_legacy_env_gate_parsing(monkeypatch):
    from ray_tpu_torch.parallel.sharding import (ENV_LEGACY_SHARDING,
                                                 legacy_sharding_enabled)

    monkeypatch.delenv(ENV_LEGACY_SHARDING, raising=False)
    assert not legacy_sharding_enabled()
    for val, want in (("1", True), ("true", True), ("YES", True),
                      ("0", False), ("", False), ("no", False)):
        monkeypatch.setenv(ENV_LEGACY_SHARDING, val)
        assert legacy_sharding_enabled() is want, val
