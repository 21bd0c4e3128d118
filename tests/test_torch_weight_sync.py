"""The port's versioned weight sync (``ray_tpu_torch/rl/weight_sync.py``)
against the reference's contracts: the six ``TestWeightSync`` cases of
``tests/test_rlhf.py`` on a run store hosted by the test
(``_private/kv.host()``), payloads in shared-memory segments and the
commit channel on the port's channel plane; a bf16 tree through the
payload's round trip; and a ``resume=True`` publisher in the second
worker generation of a ``TorchTrainer`` run continuing above the record
the first committed.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch.rl import (WeightPublisher, WeightSubscriber,
                              WeightsStaleError)
from ray_tpu_torch.rl import weight_sync as ws
from ray_tpu_torch.train import checkpoint_async as ca
from ray_tpu_torch.util import fault_injection as fi

import test_torch_tiered_loops as loops


def _params(scale: float = 1.0):
    return {"w": np.full((4, 4), scale, np.float32),
            "b": np.zeros((4,), np.float32)}


@pytest.fixture(scope="module")
def kv():
    """A run store hosted here, reached through ``RAY_TPU_TORCH_KV`` as a
    worker reaches its run's."""
    store = kv_mod.host()
    old = os.environ.get(kv_mod.ENV_KV)
    os.environ[kv_mod.ENV_KV] = store.addr
    yield store
    if old is None:
        os.environ.pop(kv_mod.ENV_KV, None)
    else:
        os.environ[kv_mod.ENV_KV] = old


def _segment_exists(name: str) -> bool:
    from ray_tpu_torch._private.shm import open_shm

    try:
        open_shm(name=name).close()
        return True
    except FileNotFoundError:
        return False


def test_publish_subscribe_atomic_snapshot(kv):
    pub = WeightPublisher("ws-basic", resume=False)
    v1 = pub.publish(_params(1.0))
    assert (v1.version, v1.epoch) == (1, 0)
    sub = WeightSubscriber("ws-basic", verify_on_read=True, device="cpu")
    params, ver = sub.current()
    assert ver == v1
    np.testing.assert_array_equal(params["w"], _params(1.0)["w"])
    v2 = pub.publish(_params(2.0))
    assert v2.version == 2
    assert sub.poll(timeout_s=2.0)
    params, ver = sub.current()
    assert ver.version == 2 and float(params["w"][0, 0]) == 2.0
    pub.close()


def test_torn_publish_never_observed_and_retry_is_gapless(kv):
    pub = WeightPublisher("ws-torn", resume=False)
    pub.publish(_params(1.0))
    sub = WeightSubscriber("ws-torn", device="cpu")
    before = set(kv.keys("shm/"))
    with fi.armed("rl.weight_sync.publish", nth=1):
        with pytest.raises(ConnectionError):
            pub.publish(_params(9.0))
    # the payload was written but never committed: unobservable, and its
    # segment is gone with the failed leg
    assert set(kv.keys("shm/")) == before
    assert not sub.poll(timeout_s=0.2)
    _, ver = sub.current()
    assert ver.version == 1
    # the retry re-publishes the SAME version number: no gap, no rewind
    v2 = pub.publish(_params(2.0))
    assert v2.version == 2
    assert sub.poll(timeout_s=2.0)
    params, ver = sub.current()
    assert ver.version == 2 and float(params["w"][0, 0]) == 2.0
    assert pub.stats["publish_failures"] == 1
    pub.close()


def test_corrupt_payload_rejected_not_served(kv):
    pub = WeightPublisher("ws-corrupt", resume=False)
    pub.publish(_params(1.0))
    sub = WeightSubscriber("ws-corrupt", device="cpu")
    # forge a commit record whose payload cannot validate: v2's tree
    # bytes disagree with its digest
    pub.publish(_params(666.0))
    rec = ws._read_latest_record("ws-corrupt")
    kv.put(ws._latest_key("ws-corrupt"), pickle.dumps(
        {**rec, "digest": "0" * 64, "published_at": time.time()}))
    try:
        assert not sub.poll(timeout_s=0.2)
        params, ver = sub.current()
        assert ver.version == 1 and float(params["w"][0, 0]) == 1.0
        assert sub.stats["rejected"] == 1
    finally:
        pub.close()


def test_overtaken_slot_is_a_failed_fetch_not_a_rejection(kv):
    """A record whose slot a later publish reused (``keep=1``: a ring of
    two) reads as a failed fetch: the subscriber keeps what it has,
    rejects nothing, and adopts the newest version at its next poll."""
    sub = WeightSubscriber("ws-overtaken", device="cpu")
    pub = WeightPublisher("ws-overtaken", resume=False, keep=1)
    try:
        pub.publish(_params(1.0))
        stale = ws._read_latest_record("ws-overtaken")
        pub.publish(_params(2.0))
        pub.publish(_params(3.0))
        assert ws._read_latest_record("ws-overtaken")["segment"] == \
            stale["segment"]
        assert ws.read_payload(stale) is None
        assert not sub._commit(stale, from_channel=False)
        assert sub.version is None and sub.stats["rejected"] == 0
        assert sub.poll(timeout_s=2.0)
        params, ver = sub.current()
        assert ver.version == 3 and float(params["w"][0, 0]) == 3.0
        assert pub.last_publish["new_slot"] is False
    finally:
        pub.close()


def test_staleness_gate_backpressures_then_releases(kv):
    pub = WeightPublisher("ws-stale", resume=False)
    pub.publish(_params(1.0))
    sub = WeightSubscriber("ws-stale", staleness_bound=2, device="cpu")
    sub.gate(timeout_s=0.1)  # under the bound: no-op
    sub.note_sample()
    sub.note_sample()
    with pytest.raises(WeightsStaleError):
        sub.gate(timeout_s=0.3)
    pub.publish(_params(2.0))
    sub.gate(timeout_s=5.0)  # released by the fresh publish
    _, ver = sub.current()
    assert ver.version == 2
    pub.close()


def test_resume_continues_above_committed_version(kv):
    pub = WeightPublisher("ws-resume", resume=False)
    for s in (1.0, 2.0, 3.0):
        pub.publish(_params(s))
    pub.close()
    # a restarted learner continues ABOVE the durable version with a
    # bumped epoch, never rewinds
    pub2 = WeightPublisher("ws-resume", resume=True)
    v = pub2.publish(_params(4.0))
    assert (v.version, v.epoch) == (4, 1)
    sub = WeightSubscriber("ws-resume", device="cpu")
    _, ver = sub.current()
    assert (ver.version, ver.epoch) == (4, 1)
    pub2.close()


def test_channel_fast_path_and_dead_reader_fallback(kv):
    pub = WeightPublisher("ws-chan", resume=False,
                          channel_write_timeout_s=0.3)
    pub.publish(_params(1.0))
    info = pub.rotate_channel(1)
    assert info["tier"] == "B-device"
    sub = WeightSubscriber("ws-chan", device="cpu")
    sub.attach_channel(info, 0)
    pub.publish(_params(2.0))
    assert sub.poll(timeout_s=2.0)
    assert sub.stats["channel_updates"] >= 1
    # the reader stops draining (a dead consumer): the bounded channel
    # write times out, the channel is retired, and publication goes on on
    # the durable path
    sub.detach_channel()
    pub.publish(_params(3.0))  # fills the channel slot, no ack ever
    pub.publish(_params(4.0))  # the write times out: retired
    assert pub.stats["channel_retired"] == 1
    assert pub.latest_version.version == 4
    assert sub.poll(timeout_s=2.0)
    _, ver = sub.current()
    assert ver.version == 4
    pub.close()


def test_bf16_tree_survives_the_payload_round_trip(kv):
    """A bf16 tree (no numpy dtype) publishes and lands with every leaf
    bit-equal and the same digest on both sides; a clone digests alike,
    one flipped bit does not; the payloads live in a ring of ``keep + 1``
    segments, reused from the ``keep + 2``-th publish on."""
    g = torch.Generator().manual_seed(0)
    tree = {"layers": [{"w": torch.randn(16, 8, generator=g).to(
        torch.bfloat16)} for _ in range(2)],
        "norm": torch.randn(8, generator=g).to(torch.bfloat16),
        "count": torch.tensor(3, dtype=torch.int64)}
    pub = WeightPublisher("ws-bf16", resume=False, keep=2)
    segs = []
    for _ in range(4):
        ver = pub.publish(tree)
        segs.append(ws._read_latest_record("ws-bf16")["segment"])
    sub = WeightSubscriber("ws-bf16", verify_on_read=True, device="cpu")
    got, v = sub.current()
    assert v == ver
    _, got_paths, got_leaves = ca.leaf_paths(got)
    _, paths, leaves = ca.leaf_paths(tree)
    assert got_paths == paths
    for a, b in zip(got_leaves, leaves):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
    d = ws.params_digest(tree, v.version, v.epoch)
    assert ws.params_digest(got, v.version, v.epoch) == d
    clone = {"layers": [{"w": t["w"].clone()} for t in tree["layers"]],
             "norm": tree["norm"].clone(), "count": tree["count"].clone()}
    assert ws.params_digest(clone, v.version, v.epoch) == d
    clone["norm"].view(torch.int16)[0] ^= 1
    assert ws.params_digest(clone, v.version, v.epoch) != d
    assert ws.params_digest(tree, v.version, v.epoch + 1) != d
    assert len(set(segs[:3])) == 3 and segs[3] == segs[0]
    assert all(_segment_exists(s) for s in segs)
    pub.close()
    assert not any(_segment_exists(s) for s in segs)


def test_resume_in_a_second_worker_generation(tmp_path):
    """Through the restart path: the first worker publishes v1, v2 and
    dies; the restarted worker's ``resume=True`` publisher reads the
    record the store kept across the restart and publishes v3 at epoch
    1.  Every payload segment is gone after ``fit()``."""
    side = tmp_path / "side"
    side.mkdir()
    result = train.TorchTrainer(
        loops.weight_sync_restart_loop,
        train_loop_config={"side_dir": str(side), "name": "ws-gen"},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=train.RunConfig(
            name="ws-restart",
            failure_config=train.FailureConfig(max_failures=1))).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert (m["version"], m["epoch"]) == (3, 1)
    for seg in m["segments"] + m["first_segments"]:
        assert not _segment_exists(seg), seg
