"""The port's tiered checkpoint plane (``train/checkpoint_async.py``,
``util/checkpoint_replica.py``) against the reference's contracts: the 13
tier-1 cases of ``tests/test_checkpoint_tiers.py``, on a run store hosted
by the test (``_private/kv.host()``) where the replica plane needs one;
cross-package cases on one numpy tree (``_split_bounds``, the
``MANIFEST.json`` fields, and the reassembled tree against the
reference's own); bf16 leaves; a world-2 fsdp tree of DTensors restored at
world 1; a SIGKILLed worker restored from peer RAM with zero disk reads;
and (slow) a quarantine drain below the disk floor committing the memory
tier.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch._private import kv as kv_mod
from ray_tpu_torch.train import checkpoint_async as ca
from ray_tpu_torch.train.checkpoint_async import (
    AsyncCheckpointer,
    IncompleteCheckpointError,
    commit_manifest,
    reassemble,
    restore_tiered,
    snapshot_shards,
    write_shard,
)
from ray_tpu_torch.train.checkpoint_manager import committed_checkpoint_dirs
from ray_tpu_torch.util import checkpoint_replica as cr
from ray_tpu_torch.util import fault_injection as fi

import test_torch_tiered_loops as loops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed: int = 0, n: int = 4096):
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.standard_normal(n).astype("float32"),
        "bias": rng.standard_normal(64).astype("float32"),
        "step": np.int64(seed),
    }


def _trees_equal(a, b) -> bool:
    ka, kb = sorted(a), sorted(b)
    if ka != kb:
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in ka)


@pytest.fixture(autouse=True)
def _fresh_local_cache():
    ca._local_cache.clear()
    yield
    ca._local_cache.clear()
    fi.disarm()


@pytest.fixture(scope="module")
def kv():
    """A run store hosted here, reached through ``RAY_TPU_TORCH_KV``."""
    store = kv_mod.host()
    old = os.environ.get(kv_mod.ENV_KV)
    os.environ[kv_mod.ENV_KV] = store.addr
    yield store
    if old is None:
        os.environ.pop(kv_mod.ENV_KV, None)
    else:
        os.environ[kv_mod.ENV_KV] = old


# ---------------------------------------------------------------------------
# sharded WAL discipline
# ---------------------------------------------------------------------------


def test_shard_write_and_manifest_commit(tmp_path):
    """Each rank stages, fsyncs and renames its own shard; the rank-0
    MANIFEST commit makes the generation visible; restore reassembles the
    full tree bit-exact (same mesh)."""
    storage = str(tmp_path)
    tree = _tree(1)
    world = 2
    for rank in range(world):
        blob = snapshot_shards(tree, rank, world, run="r", index=1,
                               meta={"step": 1})
        write_shard(storage, 1, rank, blob)
    path = commit_manifest(storage, 1, world, {"step": 1}, wait_s=5.0)
    assert os.path.basename(path) == "checkpoint_000001"
    assert [d for d, _ in committed_checkpoint_dirs(storage)] == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(storage))

    ca._local_cache.clear()  # force the disk leg
    res = restore_tiered(storage, "r")
    assert res is not None and res.index == 1 and res.world == world
    assert res.tier == "disk" and res.disk_reads == world
    assert _trees_equal(res.tree, tree)
    assert res.meta["step"] == 1


def test_torn_generation_unobservable(tmp_path):
    """A generation missing shards never commits: ``commit_manifest``
    times out leaving only ``.tmp`` staging, and restore falls back to the
    older complete one."""
    storage = str(tmp_path)
    tree = _tree(2)
    blob = snapshot_shards(tree, 0, 1, run="r", index=1, meta={})
    write_shard(storage, 1, 0, blob)
    commit_manifest(storage, 1, 1, {}, wait_s=5.0)
    blob = snapshot_shards(_tree(3), 0, 2, run="r", index=2, meta={})
    write_shard(storage, 2, 0, blob)
    with pytest.raises(TimeoutError):
        commit_manifest(storage, 2, 2, {}, wait_s=0.3)
    assert [d for d, _ in committed_checkpoint_dirs(storage)] == [1]

    ca._local_cache.clear()
    res = restore_tiered(storage, "r")
    assert res is not None and res.index == 1
    assert _trees_equal(res.tree, tree)


def test_sigkill_mid_async_persist_ignored_on_restore(tmp_path):
    """``train.checkpoint.persist_async`` armed to SIGKILL the writer in
    its second background persist: gen 2 stays torn and staged-only; a
    restart restores gen 1 untouched."""
    storage = str(tmp_path)
    script = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from ray_tpu_torch.train.checkpoint_async import AsyncCheckpointer

tree = {{"w": np.arange(256, dtype=np.float32)}}
ck = AsyncCheckpointer({storage!r}, "r", 0, 1, publish_status=False)
ck.save(tree, {{"step": 1}}, wait_persist=True)   # gen 1 commits clean
ck.save(tree, {{"step": 2}})                      # gen 2: killed mid-persist
ck.wait(30.0)
"""
    env = dict(os.environ)
    env["RAY_TPU_TORCH_FAULT_INJECT"] = \
        "train.checkpoint.persist_async:2:1:sigkill"
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (
        proc.returncode, proc.stdout, proc.stderr)
    assert [d for d, _ in committed_checkpoint_dirs(storage)] == [1]

    res = restore_tiered(storage, "r")
    assert res is not None and res.index == 1
    assert np.array_equal(res.tree["w"], np.arange(256, dtype=np.float32))


def test_restore_fault_site_armed(tmp_path):
    """``train.checkpoint.restore`` guards the ladder's entry."""
    storage = str(tmp_path)
    blob = snapshot_shards(_tree(4), 0, 1, run="r", index=1, meta={})
    write_shard(storage, 1, 0, blob)
    commit_manifest(storage, 1, 1, {}, wait_s=5.0)
    with fi.armed("train.checkpoint.restore", exc=ConnectionError("boom")):
        with pytest.raises(ConnectionError):
            restore_tiered(storage, "r")
    assert restore_tiered(storage, "r") is not None


# ---------------------------------------------------------------------------
# resharding-aware reassembly (clamped mesh)
# ---------------------------------------------------------------------------


def test_clamped_mesh_restore_reassembles_foreign_shards(tmp_path):
    """A 4-way generation restored by a smaller world: every foreign shard
    is read and the tree reassembles bit-exact; the smaller world then
    writes its own generation."""
    storage = str(tmp_path)
    tree = {"emb": np.arange(4 * 512, dtype=np.float32).reshape(4 * 512),
            "table": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
            "scalar": np.float32(7.5)}
    world = 4
    for rank in range(world):
        blob = snapshot_shards(tree, rank, world, run="r", index=3,
                               meta={"step": 3})
        write_shard(storage, 3, rank, blob)
    commit_manifest(storage, 3, world, {"step": 3}, wait_s=5.0)

    ca._local_cache.clear()
    res = restore_tiered(storage, "r")
    assert res is not None and res.world == 4 and res.disk_reads == 4
    assert _trees_equal(res.tree, tree)
    ck = AsyncCheckpointer(storage, "r", 0, 1, publish_status=False)
    try:
        h = ck.save(res.tree, {"step": 4}, wait_persist=True)
        assert h.index == 4 and h.committed_path
    finally:
        ck.close()
    res2 = restore_tiered(storage, "r")
    assert res2.index == 4 and _trees_equal(res2.tree, tree)


def test_reassemble_rejects_partial_tiling():
    """Dropping one shard of an axis-0-split leaf is an
    IncompleteCheckpointError, never a silently wrong tree."""
    tree = {"w": np.arange(64, dtype=np.float32)}
    blobs = {r: snapshot_shards(tree, r, 2, run="r", index=1, meta={})
             for r in range(2)}
    full, _ = reassemble(blobs)
    assert np.array_equal(full["w"], tree["w"])
    with pytest.raises(IncompleteCheckpointError):
        reassemble({0: blobs[0]})


# ---------------------------------------------------------------------------
# async semantics: the step pays the snapshot; backpressure never drops
# ---------------------------------------------------------------------------


def test_save_returns_after_snapshot_and_backpressure_waits(tmp_path):
    """save() returns before the persist lands; a second save during an
    in-flight persist WAITS (bounded, charged to checkpoint_persist):
    both generations commit, nothing is dropped."""
    from ray_tpu_torch.train.session import StepLedger

    ledger = StepLedger(group_name="t", publish=False)
    ck = AsyncCheckpointer(str(tmp_path), "r", 0, 1, ledger=ledger,
                           publish_status=False)
    try:
        with fi.armed("train.checkpoint.persist_async", exc="delay:0.8"):
            t0 = time.perf_counter()
            h1 = ck.save(_tree(5), {"step": 1})
            snap_s = time.perf_counter() - t0
            assert not h1.done.is_set() or h1.committed_path is None \
                or snap_s < 0.8, "save() blocked on the persist"
            with ledger.step():
                t0 = time.perf_counter()
                h2 = ck.save(_tree(6), {"step": 2})
                waited = time.perf_counter() - t0
            assert waited >= 0.3, f"second save did not backpressure: " \
                                  f"{waited:.3f}s"
        assert ck.wait(30.0)
        assert h1.committed_path and h2.committed_path
        assert [d for d, _ in committed_checkpoint_dirs(str(tmp_path))] \
            == [1, 2]
        bd = ledger.breakdown()
        assert bd["buckets_s"].get("checkpoint_persist", 0.0) >= 0.3, bd
        assert bd["buckets_s"].get("checkpoint_snapshot", 0.0) > 0.0, bd
    finally:
        ck.close()


def test_backpressure_timeout_raises_never_drops(tmp_path):
    """When the wait bound expires the save RAISES rather than silently
    skipping the snapshot."""
    ck = AsyncCheckpointer(str(tmp_path), "r", 0, 1, publish_status=False)
    try:
        with fi.armed("train.checkpoint.persist_async", exc="delay:2.0"):
            ck.save(_tree(7), {"step": 1})
            with pytest.raises(TimeoutError):
                ck.save(_tree(8), {"step": 2}, persist_wait_s=0.1)
        assert ck.wait(30.0)
        assert [d for d, _ in committed_checkpoint_dirs(str(tmp_path))] \
            == [1]
    finally:
        ck.close()


def test_local_ram_tier_restores_with_zero_disk_reads(tmp_path):
    """A restart in place: this process's own snapshot is the ladder's
    first rung; restore reads no disk shard."""
    ck = AsyncCheckpointer(str(tmp_path), "r", 0, 1, publish_status=False)
    try:
        tree = _tree(9)
        ck.save(tree, {"step": 1}, wait_persist=True)
        res = ck.restore()
        assert res is not None and res.disk_reads == 0
        assert res.tier == "memory" and res.tier_by_rank == {0: "local"}
        assert _trees_equal(res.tree, tree)
    finally:
        ck.close()


# ---------------------------------------------------------------------------
# Checkpoint.to_directory commit discipline
# ---------------------------------------------------------------------------


def test_to_directory_commits_via_rename(tmp_path):
    from ray_tpu_torch.train.checkpoint import Checkpoint

    src = tmp_path / "src"
    src.mkdir()
    (src / "state.json").write_text('{"step": 3}')
    (src / "sub").mkdir()
    (src / "sub" / "blob.bin").write_bytes(b"\x00" * 128)

    dest = str(tmp_path / "dest")
    out = Checkpoint(str(src)).to_directory(dest)
    assert out == dest
    assert json.loads((tmp_path / "dest" / "state.json").read_text()) \
        == {"step": 3}
    assert (tmp_path / "dest" / "sub" / "blob.bin").read_bytes() \
        == b"\x00" * 128
    assert not os.path.exists(dest + ".tmp")
    extra = tmp_path / "dest2"
    extra.mkdir()
    (extra / "keep.txt").write_text("keep")
    Checkpoint(str(src)).to_directory(str(extra))
    assert (extra / "keep.txt").read_text() == "keep"
    assert (extra / "state.json").exists()
    assert not os.path.exists(str(extra) + ".tmp")


# ---------------------------------------------------------------------------
# replica plane: peer push/fetch, ring, death fall-through
# ---------------------------------------------------------------------------


def test_peer_ram_tier_and_peer_death_fall_through(kv, tmp_path):
    """The ladder's middle rung: with the local cache gone (a restarted
    worker) shards restore from the peer's replica server with ZERO disk
    reads; SIGKILL the server and the same restore falls through to the
    committed disk generation."""
    plane = cr.ReplicaPlane("peer-tier-test", kv=kv)
    try:
        plane.ensure_for_nodes(["slot:0"])
        servers = plane.server_names()
        assert servers == [cr.server_name("peer-tier-test", "slot:0")]

        tree = _tree(11)
        ck = AsyncCheckpointer(str(tmp_path), "peer-tier-test", 0, 1,
                               peer_name=servers[0], server_names=servers,
                               publish_status=False)
        try:
            h = ck.save(tree, {"step": 1}, wait_persist=True)
            assert h.ram_acked and h.committed_path
        finally:
            ck.close()

        ca._local_cache.clear()  # the writer is gone
        res = restore_tiered(str(tmp_path), "peer-tier-test",
                             server_names=servers)
        assert res is not None and res.disk_reads == 0
        assert res.tier == "memory" and res.tier_by_rank == {0: "peer"}
        assert _trees_equal(res.tree, tree)

        os.kill(plane.pid("slot:0"), signal.SIGKILL)
        time.sleep(0.5)
        res = restore_tiered(str(tmp_path), "peer-tier-test",
                             server_names=servers, rpc_timeout_s=5.0)
        assert res is not None and res.disk_reads == 1
        assert res.tier == "disk" and res.tier_by_rank == {0: "disk"}
        assert _trees_equal(res.tree, tree)
    finally:
        plane.shutdown()


def test_replica_ring_assignment_skips_own_node(kv):
    plane = cr.ReplicaPlane("ring-test", kv=kv)
    # one unit: the local server is the only (degenerate) choice, still
    # worth having, it outlives a worker's SIGKILL
    assert plane.peer_assignment(["cuda:0", "cuda:0"]) == \
        [cr.server_name("ring-test", "cuda:0")] * 2
    # two units, two ranks each: each rank's peer lives on the OTHER unit
    units = ["slot:0", "slot:1", "slot:0", "slot:1"]
    for nid, peer in zip(units, plane.peer_assignment(units)):
        assert peer == cr.server_name(
            "ring-test", "slot:1" if nid == "slot:0" else "slot:0")


def test_peer_push_fault_site_degrades_to_disk(kv, tmp_path):
    """``train.checkpoint.peer_push`` armed: the push fails, the save still
    lands the disk tier (ram_acked False, committed True)."""
    plane = cr.ReplicaPlane("push-fault-test", kv=kv)
    try:
        plane.ensure_for_nodes(["slot:0"])
        servers = plane.server_names()
        ck = AsyncCheckpointer(str(tmp_path), "push-fault-test", 0, 1,
                               peer_name=servers[0], server_names=servers,
                               publish_status=False)
        try:
            with fi.armed("train.checkpoint.peer_push",
                          exc=ConnectionError("peer gone")):
                h = ck.save(_tree(12), {"step": 1}, wait_persist=True)
            assert not h.ram_acked
            assert h.committed_path and h.tier == "disk"
        finally:
            ck.close()
    finally:
        plane.shutdown()


def test_fetch_in_flight_keeps_its_blob_through_two_pushes(kv):
    """A fetch still streaming a generation's blob while two pushes evict
    that generation and land another of the same size: the fetch ships
    the bytes that were pushed, never a buffer the second push reused."""
    import socket
    from multiprocessing.connection import Client

    size = 32 << 20  # well past what loopback's socket buffers hold
    plane = cr.ReplicaPlane("fetch-race-test", kv=kv)
    try:
        plane.ensure_for_nodes(["slot:0"])
        name = plane.server_names()[0]
        for index in (1, 2):
            assert cr.push_shard(name, index, 0,
                                 np.full(size, index, np.uint8),
                                 {"world": 1}, kv=kv)
        address, authkey = cr._lookup(name, kv)
        conn = Client(address, authkey=authkey)
        try:
            conn.send_bytes(cr.pickle.dumps(("get_shard", (1, 0))))
            status, (nbytes, _meta) = cr.pickle.loads(conn.recv_bytes())
            assert status == "ok" and nbytes == size
            out = np.empty(size, np.uint8)
            mv = memoryview(out)
            sock = socket.socket(fileno=os.dup(conn.fileno()))
            try:
                got = sock.recv_into(mv[:1 << 20], 1 << 20)
                # the server is now blocked mid-send: evict generation 1
                # and land generation 4 into a buffer of the same size
                for index in (3, 4):
                    assert cr.push_shard(name, index, 0,
                                         np.full(size, index, np.uint8),
                                         {"world": 1}, kv=kv)
                while got < size:
                    n = sock.recv_into(mv[got:], size - got)
                    assert n, "the server closed mid-fetch"
                    got += n
            finally:
                sock.close()
        finally:
            conn.close()
        assert np.count_nonzero(out != 1) == 0, \
            f"{np.count_nonzero(out != 1)} bytes of the fetch were torn"
        assert cr.ram_manifest_by_names([name], kv=kv) == {3: [0], 4: [0]}
        blob, _ = cr.fetch_shard([name], 4, 0, kv=kv)
        assert np.count_nonzero(blob != 4) == 0
    finally:
        plane.shutdown()


def test_peer_blob_not_matching_its_digest_falls_to_disk(kv, tmp_path):
    """A peer-RAM blob whose bytes no longer match the chunk digests its
    push carried is a missing shard: the ladder goes on to disk."""
    plane = cr.ReplicaPlane("digest-test", kv=kv)
    try:
        plane.ensure_for_nodes(["slot:0"])
        servers = plane.server_names()
        tree = _tree(13)
        ck = AsyncCheckpointer(str(tmp_path), "digest-test", 0, 1,
                               peer_name=servers[0], server_names=servers,
                               publish_status=False)
        try:
            h = ck.save(tree, {"step": 1}, wait_persist=True)
            assert h.ram_acked and h.committed_path
        finally:
            ck.close()
        blob, meta = cr.fetch_shard(servers, h.index, 0, kv=kv)
        assert meta["blob_sha256"] == ca.blob_digest(blob)
        torn = blob.copy()
        torn[-1] ^= 0xFF  # the last data byte; the header still matches
        assert cr.push_shard(servers[0], h.index, 0, torn, meta, kv=kv)
        ca._local_cache.clear()
        res = restore_tiered(str(tmp_path), "digest-test",
                             server_names=servers)
        assert res is not None and res.tier_by_rank == {0: "disk"}
        assert res.disk_reads == 1 and _trees_equal(res.tree, tree)
    finally:
        plane.shutdown()


def test_snapshot_buffers_reused_never_while_held(tmp_path):
    """An ``AsyncCheckpointer`` snapshots into ``_LOCAL_KEEP + 1`` kept
    buffers: the fourth save reuses the first's; a buffer the local tier
    or a reader (a push past its deadline) still holds is never reused;
    the generations held stay intact."""
    run = "buffers-test"
    ck = AsyncCheckpointer(str(tmp_path), run, 0, 1, publish_status=False)
    trees, blobs = [], []

    def save(step):
        trees.append({"w": torch.full((256, 64), float(step)),
                      "step": np.int64(step)})
        h = ck.save(trees[-1], {"step": step}, wait_persist=True)
        assert h.index == step + 1
        blobs.append(ca._local_get(run, h.index, 0))
        return blobs[-1].data_ptr()

    try:
        ptrs = [save(step) for step in range(4)]
        assert len(set(ptrs[:3])) == 3 and ptrs[3] == ptrs[0]
        # the local tier holds generations 3 and 4 (buffers 2 and 0); a
        # reader holds buffer 1: the fifth save takes a new buffer
        ck._hold(blobs[1], 1)
        assert save(4) not in ptrs[:3]
        ck._hold(blobs[1], -1)
        # generations 4 and 5 held: buffer 1 is free again
        assert save(5) == ptrs[1]
        for index in (5, 6):
            back, _ = reassemble({0: ca._local_get(run, index, 0)})
            assert torch.equal(back["w"], trees[index - 1]["w"])
            assert back["step"] == index - 1
    finally:
        ck.close()


# ---------------------------------------------------------------------------
# against the reference, on one numpy tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim0,world", [(0, 1), (7, 1), (7, 2), (8, 3),
                                        (5, 8), (4096, 4), (13, 5)])
def test_split_bounds_equal_the_reference(dim0, world):
    from ray_tpu.train import checkpoint_async as ref

    assert ca._split_bounds(dim0, world) == ref._split_bounds(dim0, world)


def _mixed_tree():
    rng = np.random.default_rng(5)
    return {"emb": rng.standard_normal((37, 8)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((6, 4)).astype(np.float16),
                        "n": np.arange(3, dtype=np.int32)}
                       for _ in range(2)],
            "scalar": np.float32(2.5), "step": np.int64(11)}


@pytest.mark.parametrize("world", [1, 3])
def test_manifest_and_reassembly_equal_the_reference(tmp_path, world):
    """The same tree written by both packages at the same world: the
    ``MANIFEST.json`` fields are equal, and the port's reassembly of its
    own shards gives the tree the reference's reassembly of its shards
    gives (keys, dtypes, shapes, values)."""
    import jax

    from ray_tpu.train import checkpoint_async as ref

    tree = _mixed_tree()
    meta = {"step": 11, "loss": 0.5}
    manifests, trees = {}, {}
    for name, mod in (("port", ca), ("ref", ref)):
        storage = str(tmp_path / name)
        blobs = {r: mod.snapshot_shards(tree, r, world, run="r", index=2,
                                        meta=meta) for r in range(world)}
        for r, b in blobs.items():
            mod.write_shard(storage, 2, r, b)
        path = mod.commit_manifest(storage, 2, world, meta, wait_s=5.0)
        manifests[name] = json.load(open(os.path.join(path,
                                                      "MANIFEST.json")))
        assert sorted(os.listdir(path)) == sorted(
            ["MANIFEST.json"] + [f"shard_r{r:02d}" for r in range(world)])
        trees[name], got_meta = mod.reassemble(
            mod.load_disk_shards(path))
        assert got_meta == meta
    assert manifests["port"] == manifests["ref"]
    ref_leaves = jax.tree_util.tree_flatten_with_path(trees["ref"])[0]
    port_leaves = jax.tree_util.tree_flatten_with_path(trees["port"])[0]
    assert [jax.tree_util.keystr(p) for p, _ in port_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in ref_leaves]
    for (_, a), (_, b) in zip(port_leaves, ref_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # and the skeleton's path strings are the reference's keystr
    _, paths, _ = ca.leaf_paths(tree)
    assert sorted(paths) == sorted(jax.tree_util.keystr(p) for p, _ in
                                   jax.tree_util.tree_flatten_with_path(
                                       tree)[0])
    # a dict comes back in its insertion order (the reference's in JAX's
    # sorted order)
    unsorted = {"b": np.ones(3), "a": np.zeros(2)}
    back, _ = reassemble({0: snapshot_shards(unsorted, 0, 1)})
    assert list(back) == ["b", "a"]


def test_bf16_tree_through_snapshot_and_reassemble():
    """bf16 has no numpy dtype: its pieces travel as bytes and come back
    bit-equal, at every world, with python values beside them."""
    g = torch.Generator().manual_seed(1)
    tree = {"w": torch.randn(9, 5, generator=g).to(torch.bfloat16),
            "b": torch.randn(5, generator=g).to(torch.bfloat16),
            "c": torch.tensor(1.5, dtype=torch.bfloat16),
            "iteration": 3, "ids": [4, 5]}
    for world in (1, 2, 4):
        blobs = {r: snapshot_shards(tree, r, world, run="r", index=1)
                 for r in range(world)}
        out, _ = reassemble(blobs)
        for k in ("w", "b", "c"):
            assert out[k].dtype == torch.bfloat16
            assert torch.equal(out[k].view(torch.int16),
                               tree[k].view(torch.int16))
        assert out["iteration"] == 3 and out["ids"] == [4, 5]


# ---------------------------------------------------------------------------
# through the trainer: world-2 fsdp restored at world 1; a SIGKILLed worker
# ---------------------------------------------------------------------------


def test_world2_fsdp_tree_restored_at_world1(tmp_path):
    """Two host workers on an fsdp mesh save a tree of DTensors (sharded
    along axis 0, one replicated) through the tiered plane: each rank
    writes only its local shards, the replicated leaf once.  A run of one
    worker against the same storage restores the whole tree bit-exact
    from disk."""
    rng = np.random.default_rng(3)
    full = {"a": rng.standard_normal((10, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "rep": rng.standard_normal((4, 2)).astype(np.float32)}
    np.savez(tmp_path / "tree.npz", **full)
    run = train.RunConfig(
        name="fsdp-tiered", storage_path=str(tmp_path),
        checkpoint_config=train.CheckpointConfig(mode="tiered"))
    saved = train.TorchTrainer(
        loops.fsdp_save_loop,
        train_loop_config={"tree": str(tmp_path / "tree.npz")},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False,
                                           mesh="fsdp"),
        run_config=run).fit()
    assert saved.error is None, saved.error
    assert saved.metrics["world"] == 2 and saved.metrics["tier"] == "disk"
    path = os.path.join(str(tmp_path), "fsdp-tiered",
                        f"checkpoint_{saved.metrics['index']:06d}")
    heads = [ca.read_header(b) for b in
             ca.load_disk_shards(path).values()]
    owned = sorted(p[0] for h in heads for p in h["pieces"])
    # a and b split over both ranks, the replicated leaf and the python
    # value written once
    assert owned == sorted(["['replicated']", "['sharded']['a']",
                            "['sharded']['a']", "['sharded']['b']",
                            "['sharded']['b']", "['step']"])
    out = str(tmp_path / "restored.npz")
    got = train.TorchTrainer(
        loops.restore_report_loop, train_loop_config={"out": out},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=run).fit()
    assert got.error is None, got.error
    m = got.metrics
    assert m["world"] == 2 and m["step"] == 7 and m["tier"] == "disk"
    restored = np.load(out)
    for k in ("a", "b"):
        np.testing.assert_array_equal(restored[f"sharded.{k}"], full[k])
    np.testing.assert_array_equal(restored["rep"], full["rep"])


def _losses(side: str):
    out = {}
    for name in os.listdir(side):
        if name.startswith("loss-") and not name.endswith(".tmp"):
            with open(os.path.join(side, name)) as f:
                rec = json.load(f)
            out[rec["step"]] = rec["loss"]
    return out


def _run_tiered(tmp_path, tag: str, steps: int, *, kill_step=None,
                max_failures=0):
    side = str(tmp_path / f"side-{tag}")
    os.makedirs(side, exist_ok=True)
    cfg = {"side_dir": side, "steps": steps}
    if kill_step is not None:
        cfg.update(kill_rank=1, kill_step=kill_step)
    result = train.TorchTrainer(
        loops.tiered_loop, train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=train.RunConfig(
            name=f"tiered-{tag}", storage_path=str(tmp_path),
            checkpoint_config=train.CheckpointConfig(mode="tiered"),
            failure_config=train.FailureConfig(max_failures=max_failures)),
    ).fit()
    return result, side


@pytest.mark.chaos
def test_sigkill_worker_restores_from_peer_ram_bit_exact(tmp_path):
    """The acceptance chaos scenario on two host slots: SIGKILL one worker
    mid-run; the restarted group restores every rank's shards from peer
    RAM with ZERO disk reads, and the loss curve is bit-exact against an
    unkilled run."""
    ref, _ = _run_tiered(tmp_path, "ref", steps=6)
    assert ref.error is None, ref.error
    ref_losses = _losses(str(tmp_path / "side-ref"))
    assert sorted(ref_losses) == list(range(6))

    res, side = _run_tiered(tmp_path, "kill", steps=6, kill_step=3,
                            max_failures=2)
    assert res.error is None, res.error
    assert os.path.exists(os.path.join(side, "killed"))
    restores = [n for n in os.listdir(side) if n.startswith("restore-")
                and not n.endswith(".tmp")]
    assert restores, "the restarted group never restored"
    for name in restores:
        with open(os.path.join(side, name)) as f:
            rec = json.load(f)
        assert rec["disk_reads"] == 0, rec
        assert rec["tier"] == "memory", rec
        assert set(rec["tier_by_rank"].values()) == {"peer"}, rec
        assert rec["start"] >= 1, rec
    kill_losses = _losses(side)
    assert sorted(kill_losses) == list(range(6))
    for step in range(6):
        assert kill_losses[step] == ref_losses[step], step


@pytest.mark.chaos
@pytest.mark.slow
def test_drain_below_disk_floor_commits_memory_tier(tmp_path, monkeypatch):
    """A quarantine drain whose window is below the disk floor: the
    controller asks for a ``memory``-tier checkpoint, the peer-RAM ack
    commits it inside the window, the elastic restart resumes from it off
    the quarantined slot, and the failure budget is never charged."""
    from ray_tpu_torch._private import health_plane as HP

    # every disk persist takes +6 s, and a 15 s quarantine window is
    # under the floor: only the peer-RAM ack can meet it
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_DRAIN_MEMORY_TIER_FLOOR_S",
                       "30")
    monkeypatch.setenv("RAY_TPU_TORCH_FAULT_INJECT",
                       "train.checkpoint.persist_async:1:9999:delay:6")
    side = tmp_path / "side"
    side.mkdir()
    trainer = train.TorchTrainer(
        loops.tiered_loop,
        train_loop_config={"side_dir": str(side), "steps": 6},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=train.RunConfig(
            name="drain-mem-tier", storage_path=str(tmp_path),
            checkpoint_config=train.CheckpointConfig(mode="tiered"),
            failure_config=train.FailureConfig(max_failures=0)),
        scaling_policy=train.ElasticScalingPolicy(1, 3, settle_s=0.2))
    seen = {}

    def drainer():
        deadline = time.time() + 120
        while time.time() < deadline:
            ctl = trainer.controller
            if ctl is not None and "loss-1" in os.listdir(side):
                seen["ack"] = HP.set_node_health(
                    ctl.kv, "slot:1", "QUARANTINED", "test: slot 1 sick")
                return
            time.sleep(0.05)

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    result = trainer.fit()
    t.join(timeout=5)
    assert seen.get("ack", {}).get("accepted"), seen
    assert result.error is None, result.error
    ctl = trainer.controller
    assert ctl.drain_restarts == 1 and ctl._ctx.errors_seen == 0
    restores = [json.load(open(side / n)) for n in os.listdir(side)
                if n.startswith("restore-") and not n.endswith(".tmp")]
    assert restores and all(r["disk_reads"] == 0 for r in restores)
