"""``TorchTrainer`` fed by ``ray_tpu_torch.data``: each rank gets a
``streaming_split`` shard of a ``Dataset`` (the reference's
``ray_tpu/train/controller.py:228-241``), a fresh one per attempt, and no
shared-memory segment outlives ``fit()``.

Two host workers over gloo; the loop (``test_torch_data_loops.py``)
writes what each rank read to a file per rank and generation.  On the
first attempt rank 0 fails after its first batch.
"""

import json
import os

import pytest

import test_torch_data_loops as loops
import ray_tpu_torch.data as td
from ray_tpu_torch import train

ROWS = 64


@pytest.fixture(scope="module")
def split_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("split_run")
    trainer = train.TorchTrainer(
        loops.split_loop,
        train_loop_config={"out_dir": str(out), "batch_size": 4},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        datasets={"train": td.range(ROWS, parallelism=8),
                  "plain": [1, 2, 3]},
        run_config=train.RunConfig(
            name="split-run",
            failure_config=train.FailureConfig(max_failures=1)))
    result = trainer.fit()
    reads = {}
    for name in os.listdir(out):
        if name.endswith(".json"):
            with open(out / name) as f:
                reads[name[:-len(".json")]] = json.load(f)
    return trainer, result, reads


def test_fit_restarts_once_and_finishes(split_run):
    _, result, reads = split_run
    assert result.error is None
    assert sorted(reads) == ["g1_rank0", "g1_rank1", "g2_rank0", "g2_rank1"]
    assert result.metrics == {"rank": 0, "rows": ROWS // 2,
                              "training_iteration": 1}


def test_ranks_get_disjoint_equal_shares(split_run):
    _, _, reads = split_run
    r0, r1 = reads["g2_rank0"]["ids"], reads["g2_rank1"]["ids"]
    assert len(r0) == len(r1) == ROWS // 2
    assert not set(r0) & set(r1)
    assert sorted(r0 + r1) == list(range(ROWS))


def test_batches_land_on_the_worker_device(split_run):
    _, _, reads = split_run
    for name in ("g1_rank0", "g2_rank0", "g2_rank1"):
        rec = reads[name]
        assert rec["devices"] == ["cpu"] and rec["dtypes"] == ["torch.int64"]


def test_restarted_attempt_gets_a_fresh_split(split_run):
    _, _, reads = split_run
    first = {reads["g1_rank0"]["segment"], reads["g1_rank1"]["segment"]}
    second = {reads["g2_rank0"]["segment"], reads["g2_rank1"]["segment"]}
    assert len(first) == len(second) == 2 and not first & second
    # the failed rank read one batch of its shard before it raised
    assert len(reads["g1_rank0"]["ids"]) == 4


def test_no_segment_outlives_fit(split_run):
    trainer, _, reads = split_run
    for rec in reads.values():
        assert not os.path.exists(f"/dev/shm/{rec['segment']}")
    assert trainer.controller._splits == []


def test_plain_values_are_replicated(split_run):
    trainer, _, _ = split_run
    shards = trainer.controller._split_datasets(3)
    try:
        assert [s["plain"] for s in shards] == [[1, 2, 3]] * 3
        assert all(isinstance(s["train"], td.DataIterator) for s in shards)
    finally:
        trainer.controller._shutdown_splits()
