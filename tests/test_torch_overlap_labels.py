"""Port parity: the TPU-only pieces by analogue.

- ``ray_tpu_torch/parallel/overlap.py`` against ``ray_tpu/parallel/
  overlap.py``: the same opt-in, the same gate on where the process is
  headed, idempotence, and an operator's explicit setting (``0``/
  ``false`` included) never overridden, held case by case on plain
  ``env`` dicts, the reference's flags in ``LIBTPU_INIT_ARGS`` and the
  port's as CUDA and NCCL environment variables.
- ``ray_tpu_torch/_private/accelerators.py``'s resources, labels and
  visible set against a stubbed card count and peer table (the
  reference's ``tests/test_workflow_and_shims.py::
  test_accelerator_detection_env`` holds its TPU labels to a stubbed
  environment the same way).
"""

import pytest
import torch

from ray_tpu.parallel import overlap as jov
from ray_tpu_torch._private import accelerators as acc
from ray_tpu_torch.parallel import overlap as tov

OPT_IN = {"RAY_TPU_COLLECTIVE_OVERLAP": "1"}


@pytest.fixture
def cuda_torch(monkeypatch):
    """This torch as a CUDA build (the gate reads ``torch.version.cuda``
    and nothing that touches a card)."""
    monkeypatch.setattr(torch.version, "cuda", "12.8")


def _headed(side):
    """An env headed for the side's accelerator."""
    return {"JAX_PLATFORMS": "tpu"} if side == "j" else {}


def _run(side, env):
    mod = jov if side == "j" else tov
    return mod.ensure_collective_overlap(env), mod.overlap_active(env)


def test_the_set_and_the_opt_in_name():
    assert tov.ENV_OPT_IN == jov.ENV_OPT_IN
    assert set(tov.OVERLAP_CUDA_FLAGS) == {
        "TORCH_NCCL_HIGH_PRIORITY", "CUDA_DEVICE_MAX_CONNECTIONS",
        "TORCH_NCCL_AVOID_RECORD_STREAMS"}
    for v in ("1", "true", "YES"):
        assert tov.overlap_requested({tov.ENV_OPT_IN: v}) == \
            jov.overlap_requested({jov.ENV_OPT_IN: v}) is True
    for v in ("", "0", "no", "off"):
        assert tov.overlap_requested({tov.ENV_OPT_IN: v}) == \
            jov.overlap_requested({jov.ENV_OPT_IN: v}) is False


def test_inert_by_default(cuda_torch):
    for side in "jt":
        env = _headed(side)
        assert _run(side, env) == (False, False)
        assert env == _headed(side)


def test_armed_when_opted_in_and_headed(cuda_torch):
    jenv, tenv = {**OPT_IN, **_headed("j")}, {**OPT_IN, **_headed("t")}
    assert _run("j", jenv) == _run("t", tenv) == (True, True)
    assert all(f in jenv["LIBTPU_INIT_ARGS"] for f in jov.OVERLAP_TPU_FLAGS)
    assert {k: tenv[k] for k in tov.OVERLAP_CUDA_FLAGS} == \
        tov.OVERLAP_CUDA_FLAGS


def test_idempotent(cuda_torch):
    jenv, tenv = {**OPT_IN, **_headed("j")}, {**OPT_IN, **_headed("t")}
    _run("j", jenv), _run("t", tenv)
    once = dict(jenv), dict(tenv)
    assert _run("j", jenv) == _run("t", tenv) == (True, True)
    assert (jenv, tenv) == once


def test_not_armed_where_the_process_is_not_headed(monkeypatch):
    jenv = {**OPT_IN, "JAX_PLATFORMS": "cpu"}
    tenv = {**OPT_IN, "CUDA_VISIBLE_DEVICES": ""}
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    assert _run("j", jenv) == _run("t", tenv) == (False, False)
    assert "LIBTPU_INIT_ARGS" not in jenv
    assert not set(tov.OVERLAP_CUDA_FLAGS) & set(tenv)
    # a torch built for the CPU is not headed for CUDA either
    monkeypatch.setattr(torch.version, "cuda", None)
    tenv = dict(OPT_IN)
    assert _run("t", tenv) == (False, False) and tenv == OPT_IN


@pytest.mark.parametrize("off", ["0", "false", "no"])
def test_an_explicit_setting_is_never_overridden(cuda_torch, off):
    """The operator's ``=false`` on one flag stays, the rest are added,
    and the set is then not active, on both sides."""
    jflag = jov.OVERLAP_TPU_FLAGS[0].split("=")[0]
    jenv = {**OPT_IN, **_headed("j"), "LIBTPU_INIT_ARGS": f"{jflag}={off}"}
    tenv = {**OPT_IN, "TORCH_NCCL_HIGH_PRIORITY": off}
    assert _run("j", jenv) == _run("t", tenv) == (False, False)
    assert jenv["LIBTPU_INIT_ARGS"].split()[0] == f"{jflag}={off}"
    assert tenv["TORCH_NCCL_HIGH_PRIORITY"] == off
    assert tenv["CUDA_DEVICE_MAX_CONNECTIONS"] == "32"
    assert tenv["TORCH_NCCL_AVOID_RECORD_STREAMS"] == "1"


def test_the_connection_count_is_a_count(cuda_torch):
    base = {k: v for k, v in tov.OVERLAP_CUDA_FLAGS.items()}
    for value, active in (("32", True), ("64", True), ("8", False),
                          ("1", False), ("many", False)):
        env = {**base, "CUDA_DEVICE_MAX_CONNECTIONS": value}
        assert tov.overlap_active(env) is active, value
        assert tov.ensure_collective_overlap({**OPT_IN, **env}) is active


def test_active_without_the_opt_in_when_the_operator_set_it():
    """However the set got there: both report it active without the
    opt-in, and add nothing."""
    jenv = {"LIBTPU_INIT_ARGS": " ".join(jov.OVERLAP_TPU_FLAGS)}
    tenv = dict(tov.OVERLAP_CUDA_FLAGS)
    assert _run("j", jenv) == _run("t", tenv) == (True, True)
    partial = {"TORCH_NCCL_HIGH_PRIORITY": "1"}
    assert tov.overlap_active(partial) is False


def test_flag_states_are_name_exact():
    """A prefix of a flag's name is another flag (the reference parses
    ``..._fusion`` apart from ``..._fusion_fuse_all_gather``)."""
    states = tov._flag_states({"TORCH_NCCL_HIGH_PRIORITY_X": "1",
                               "TORCH_NCCL_HIGH_PRIORITY": "0"})
    assert states == {"TORCH_NCCL_HIGH_PRIORITY": False}
    assert jov._flag_states("--a_fusion=true --a_fusion_x=false") == {
        "--a_fusion": True, "--a_fusion_x": False}


# -- accelerator resources and labels ---------------------------------------
@pytest.fixture
def four_cards(monkeypatch):
    """Four H100s in two NVLink pairs (0-1, 2-3), stubbed."""
    peers = {(0, 1), (1, 0), (2, 3), (3, 2)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda i, j: (i, j) in peers)


def test_resources_and_labels_of_four_cards(four_cards):
    assert acc.detect_gpus() == 4
    assert acc.accelerator_type() == "H100"
    assert acc.detect_resources() == {"GPU": 4.0, "GPU-H100": 4.0}
    assert acc.detect_labels() == {
        "gpu-type": "H100", "gpu-count": "4", "gpu-peers-0": "1",
        "gpu-peers-1": "0", "gpu-peers-2": "3", "gpu-peers-3": "2"}
    assert acc.peer_cards(2) == [3]


def test_no_card_no_resources_or_labels():
    assert not torch.cuda.is_available()
    assert acc.detect_resources() == {}
    assert acc.detect_labels() == {}
    assert acc.accelerator_type() == ""


def test_one_card_has_no_peers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 PCIe")
    assert acc.detect_labels() == {"gpu-type": "H100", "gpu-count": "1",
                                   "gpu-peers-0": ""}


def test_set_visible_chips():
    env = {}
    acc.set_visible_chips(env, [0, 2])
    assert env == {"CUDA_VISIBLE_DEVICES": "0,2"}
    assert acc.ENV_VISIBLE == "CUDA_VISIBLE_DEVICES"
