"""Versioned live weight sync: learner → generation processes, no cold
restart (counterpart of ``ray_tpu/rl/weight_sync.py``).

The RLHF loop (``rl/rlhf.py``) needs fresh learner weights on its rollout
processes every iteration while they keep sampling.  The contracts are
the reference's:

- **Monotonic versions.** Every publish carries a :class:`WeightVersion`
  ``(version, epoch)``: ``version`` is monotonic over the publisher's
  whole lifetime, elastic restarts included (a resumed publisher reads the
  durable record and continues above it, bumping ``epoch``).

- **Torn publishes are never observed.** A publish is three legs: the
  payload into a shared-memory slot that no reader may be reading, then
  the ``rl.weight_sync.publish`` fault site, then the *commit*: one write
  of the latest-record into the run's store (``rl_weights/<name>/latest``).
  The record is the only way to discover a version, so a publisher that
  dies or faults between payload and commit leaves an unreachable
  payload, never a half-published version.  The record carries a digest
  over every leaf, checked before the consumer's swap.

- **Atomic consumer swap.** :meth:`WeightSubscriber.current` returns
  ``(params, WeightVersion)`` taken under one lock; the swap installs the
  whole validated tree in one assignment.

- **Channel fast path, durable fallback.** The publisher can attach a
  shared-memory channel (``make_edge_transport(tier=TIER_DEVICE)``);
  commits ride it with a bounded write (small payloads inline, large ones
  as the commit record).  A dead or slow reader times the write out: the
  channel is retired and publication continues on the store and its
  slots.  A respawned subscriber rejoins at the current version from
  the durable record.

- **Bounded staleness backpressure.** Past ``staleness_bound`` samples at
  one version, :meth:`WeightSubscriber.gate` blocks (bounded) for a newer
  publish and raises :class:`WeightsStaleError` if none comes.

Where the port differs: the reference puts the payload in its object
store, which the port does not have.  A payload here is a checkpoint
blob of the whole tree (``train/checkpoint_async.snapshot_shards`` as its
one writer) in one of a ring of ``keep + 1`` segments named
``rtpu_ws_<hex>``, which the publisher keeps mapped and, for a card's
tree, page-locked: a publish after the first ``keep + 1`` touches no
fresh memory, and a card's leaves go by DMA straight into the segment.
A slot's first word is the version it holds, so a reader that a later
publish overtook sees the slot change under it and keeps its current
version, as a lost object does there.  Each segment is registered in the
run's store, so ``close()`` and the end of ``fit()`` sweep what a dead
publisher left.  The store is hosted by the train controller, so the
durable record survives worker-group restarts within one ``fit()``, as
the reference's GCS KV does.

The digest is the port's own canonical encoding (key paths in sorted
order, and per leaf its dtype, shape and bytes, hashed in 64 MiB chunks
on a pool of threads; ``checkpoint_async`` owns the path encoding and
the hashing): a CUDA tree digests as its host copy, and bf16 leaves hash
their raw bytes.  Digests do not equal the reference's.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
import struct
import threading
import time
import uuid
from dataclasses import dataclass
from functools import total_ordering
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._private import durations
from ray_tpu_torch.rl.models import tree_map
from ray_tpu_torch.train import checkpoint_async as ca
from ray_tpu_torch.util import fault_injection

logger = logging.getLogger(__name__)

_NAMESPACE = "rl_weights"
SEGMENT_PREFIX = "rtpu_ws_"
_STAMP = struct.Struct("<Q")  # a slot's first word: the version it holds
_SLOT_HEAD = 64  # a slot's blob starts here
_SLOT_SLACK = 1 << 20  # room for a later version's longer header


class WeightSyncError(RuntimeError):
    """Base for weight-sync failures."""


class WeightsStaleError(WeightSyncError):
    """The staleness gate timed out: the learner has not published within
    the bound while rollout kept sampling."""


class NoWeightsPublishedError(WeightSyncError):
    """A subscriber asked for weights before any publish committed."""


@total_ordering
@dataclass(frozen=True)
class WeightVersion:
    """Monotonic weight identity: ``version`` is never reused and survives
    publisher restarts; ``epoch`` counts publisher incarnations."""

    version: int
    epoch: int = 0

    def __lt__(self, other: "WeightVersion") -> bool:
        return self.version < other.version

    def __int__(self) -> int:
        return self.version


# -- the canonical tree encoding -------------------------------------------------


def _leaf_bytes(x: Any) -> Tuple[str, Tuple[int, ...], memoryview]:
    """A leaf's dtype, shape and raw host bytes, named as a checkpoint
    blob's header names them (a CUDA tensor is copied to the host; bf16
    has no numpy dtype, so tensors go through a uint8 view; any other
    value is its pickle)."""
    kind, dtype, shape = ca._kind(x)
    if kind == "torch":
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    elif kind == "numpy":
        raw = np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)
    else:
        raw = pickle.dumps(x)
    return dtype, shape, memoryview(raw).cast("B")


def _digest(leaves: List[Tuple[str, str, tuple, memoryview]],
            version: int, epoch: int) -> str:
    leaves = sorted(leaves, key=lambda leaf: leaf[0])
    h = hashlib.sha256(f"{version}:{epoch}".encode())
    for (path, dtype, shape, _), chunks in zip(
            leaves, ca.chunk_digests([leaf[3] for leaf in leaves])):
        h.update(f"{path}|{dtype}|{shape}|".encode())
        h.update(hashlib.sha256(b"".join(chunks)).digest())
    return h.hexdigest()


def params_digest(params: Any, version: int, epoch: int) -> str:
    """Digest over every leaf's bytes and the version identity.  A payload
    whose tree was torn, truncated or mixed across versions cannot
    reproduce it.  Leaves go in the order of their sorted key paths, and
    each hashes as the sha256 of its 64 MiB chunks' sha256s, the chunks
    on a pool of threads."""
    _, paths, leaves = ca.leaf_paths(params)
    return _digest([(p, *_leaf_bytes(x)) for p, x in zip(paths, leaves)],
                   version, epoch)


def _blob_digest(blob, version: int, epoch: int) -> str:
    """:func:`params_digest` of the tree a sole writer's blob holds, read
    in place."""
    return _digest([(path, dtype, shape, memoryview(pickle.dumps(data))
                     if kind == "object" else data)
                    for path, _b, kind, dtype, shape, data
                    in ca.blob_pieces(blob)], version, epoch)


# -- the durable record and the payload slots -----------------------------------


def _kv(kv=None):
    from ray_tpu_torch._private import kv as kv_mod

    return kv if kv is not None else kv_mod.client()


def _latest_key(name: str) -> str:
    return f"{_NAMESPACE}/{name}/latest"


def _read_latest_record(name: str, kv=None) -> Optional[Dict[str, Any]]:
    """The durable commit record, or None when nothing has been published
    under ``name``.  The only discovery path: a publish is visible iff
    this record points at it."""
    raw = _kv(kv).get(_latest_key(name))
    return None if raw is None else pickle.loads(raw)


class _Slot:
    """One payload segment of the publisher's ring: its first word is the
    version it holds (0 while a publish writes it), the blob follows at
    ``_SLOT_HEAD``."""

    def __init__(self, nbytes: int, kv, owner: str):
        from ray_tpu_torch._private.shm import open_shm, register_segment

        self.name = f"{SEGMENT_PREFIX}{uuid.uuid4().hex[:16]}"
        self.capacity = nbytes
        self.version = 0
        self._registered: Optional[int] = None
        self.seg = open_shm(name=self.name, create=True, size=nbytes)
        try:
            register_segment(kv, self.name, owner)
        except BaseException:
            self.seg.close()
            self.seg.unlink()
            raise

    def stamp(self, version: int) -> None:
        _STAMP.pack_into(self.seg.buf, 0, version)
        self.version = version

    def blob(self, nbytes: int, page_locked: bool) -> torch.Tensor:
        """A uint8 tensor over the slot's blob region; page-locked for
        CUDA (``cudaHostRegister``, once per slot) when asked, so that a
        snapshot of a card's tree is a DMA straight into the segment."""
        if page_locked and self._registered is None:
            import ctypes

            anchor = ctypes.c_char.from_buffer(self.seg.buf)
            addr = ctypes.addressof(anchor)
            del anchor
            portable = 1  # cudaHostRegisterPortable
            err = int(torch.cuda.cudart().cudaHostRegister(
                addr, self.capacity, portable))
            if err:
                raise RuntimeError(f"weight-sync slot {self.name}: "
                                   f"cudaHostRegister failed ({err})")
            self._registered = addr
        return torch.frombuffer(self.seg.buf, dtype=torch.uint8,
                                count=nbytes, offset=_SLOT_HEAD)

    def destroy(self, kv) -> None:
        from ray_tpu_torch._private.shm import unlink_segment

        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None
        try:
            self.seg.close()
        except BufferError:  # a view still alive: the mapping goes with it
            pass
        unlink_segment(self.name, kv)


def read_payload(record: Dict[str, Any]) -> Optional[Any]:
    """The host tree of the version ``record`` commits, copied out of its
    slot; None when the slot is gone (the publisher closed or died) or no
    longer holds that version (a later publish reused it)."""
    from ray_tpu_torch._private.shm import open_shm

    version = int(record["version"])
    try:
        seg = open_shm(name=record["segment"])
    except FileNotFoundError:
        return None
    try:
        if _STAMP.unpack_from(seg.buf, 0)[0] != version:
            return None
        view = seg.buf[_SLOT_HEAD:_SLOT_HEAD + int(record["nbytes"])]
        tree, _ = ca.reassemble({0: view})
        view.release()
        # the stamp again: a publish that reused the slot mid-copy shows
        if _STAMP.unpack_from(seg.buf, 0)[0] != version:
            return None
        return tree
    finally:
        try:
            seg.close()
        except BufferError:
            pass


class WeightPublisher:
    """Learner side: assign versions, publish payloads, commit atomically.

    Payloads live in a ring of ``keep + 1`` segments that the publisher
    keeps mapped (page-locked for CUDA once a card's tree is published):
    a version is written into the slot holding none of the last ``keep``
    committed versions, so an in-flight fetch of the previous version
    cannot lose it mid-swap.  The commit is one store write of the
    latest-record, which names the slot.  An attached channel is a
    latency optimisation only: every commit is durable in the store
    first."""

    def __init__(self, name: str, *, keep: int = 2,
                 channel_write_timeout_s: float = 2.0,
                 resume: bool = True, kv=None):
        self.name = name
        self.keep = max(1, keep)
        self.channel_write_timeout_s = channel_write_timeout_s
        self._kv = _kv(kv)
        self._owner = f"weights:{name}"
        self._slots: List[_Slot] = []
        self._channel = None
        self._channel_bytes = 0
        self._lock = threading.Lock()
        self.stats = {"publishes": 0, "publish_failures": 0,
                      "channel_commits": 0, "channel_retired": 0}
        # the last publish in parts, seconds (bytes: the payload's)
        self.last_publish: Dict[str, Any] = {}
        self._epoch = 0
        self._version = 0  # last committed version
        if resume:
            rec = _read_latest_record(name, self._kv)
            if rec is not None:
                self._version = int(rec["version"])
                self._epoch = int(rec["epoch"]) + 1

    # -- channel fast path -------------------------------------------------
    def rotate_channel(self, num_readers: int,
                       *, buffer_size: int = 1 << 20) -> Dict[str, Any]:
        """(Re)create the commit channel for ``num_readers`` subscribers
        and return its attach info ``{"name", "num_readers",
        "buffer_size", "tier"}``.  Called whenever the group's membership
        changes (a respawned process cannot inherit a dead reader's ack
        slot)."""
        from ray_tpu_torch.experimental.channel.transport import (
            TIER_DEVICE,
            make_edge_transport,
        )

        self.retire_channel()
        if num_readers <= 0:
            return {}
        tr = make_edge_transport(
            tier=TIER_DEVICE, edge=f"weights:{self.name}",
            buffer_size=buffer_size, num_readers=num_readers)
        with self._lock:
            self._channel = tr
            self._channel_bytes = buffer_size
        return {"name": tr.channel.name, "num_readers": num_readers,
                "buffer_size": buffer_size, "tier": tr.tier}

    def retire_channel(self) -> None:
        with self._lock:
            ch, self._channel = self._channel, None
        if ch is not None:
            try:
                ch.destroy()
            except Exception:  # noqa: BLE001 — already unlinked is fine
                pass

    # -- publish -----------------------------------------------------------
    @property
    def latest_version(self) -> Optional[WeightVersion]:
        if self._version <= 0:
            return None
        return WeightVersion(self._version, self._epoch)

    def _take_slot(self, nbytes: int) -> Tuple[_Slot, bool]:
        """The slot for the next version, stamped 0, and whether it is
        new: the oldest slot holding none of the last ``keep`` committed
        versions (made anew when it is too small), else a new one."""
        live = set(range(max(1, self._version - self.keep + 1),
                         self._version + 1))
        free = [s for s in self._slots if s.version not in live]
        slot = min(free, key=lambda s: s.version) if free else None
        if slot is not None and slot.capacity < _SLOT_HEAD + nbytes:
            self._slots.remove(slot)
            slot.destroy(self._kv)
            slot = None
        new = slot is None
        if new:
            size = (_SLOT_HEAD + nbytes + _SLOT_SLACK + (1 << 20) - 1) \
                >> 20 << 20
            slot = _Slot(size, self._kv, self._owner)
            self._slots.append(slot)
        slot.stamp(0)
        return slot, new

    def publish(self, params: Any, *, meta: Optional[Dict[str, Any]] = None
                ) -> WeightVersion:
        """Publish one version.  Raises without bumping the committed
        version if any leg fails: a retry re-publishes the SAME version
        number, so a fault between payload and commit never skips or
        tears a version."""
        t0 = time.perf_counter()
        version = self._version + 1
        epoch = self._epoch
        got: Dict[str, Any] = {}

        def alloc(nbytes: int, page_locked: bool) -> torch.Tensor:
            t = time.perf_counter()
            got["slot"], got["new"] = self._take_slot(nbytes)
            blob = got["slot"].blob(nbytes, page_locked)
            got["slot_s"] = time.perf_counter() - t
            return blob

        try:
            # the payload: the tree's snapshot straight into the slot (a
            # DMA from the card into the registered segment)
            blob = ca.snapshot_shards(params, 0, 1, run=self.name,
                                      index=version,
                                      meta={"epoch": epoch, **(meta or {})},
                                      alloc=alloc)
            slot = got["slot"]
            t1 = time.perf_counter()
            digest = _blob_digest(blob, version, epoch)
            t2 = time.perf_counter()
            nbytes = blob.numel()
            slot.stamp(version)
            record = {"version": version, "epoch": epoch, "digest": digest,
                      "segment": slot.name, "nbytes": nbytes,
                      "published_at": time.time()}
            # the torn-publish seam: the payload exists, the commit has
            # not happened; a fault here leaves the version unobservable
            fault_injection.fault_point("rl.weight_sync.publish")
            self._kv.put(_latest_key(self.name), pickle.dumps(record))
        except BaseException:
            self.stats["publish_failures"] += 1
            slot = got.get("slot")
            if slot is not None:
                slot.stamp(0)
                if got["new"]:  # a failed publish leaves no new segment
                    self._slots.remove(slot)
                    slot.destroy(self._kv)
            raise
        t3 = time.perf_counter()
        self._version = version
        self.stats["publishes"] += 1
        self._channel_notify(record, blob)
        del blob
        dt = time.perf_counter() - t0
        self.last_publish = {"slot_s": got["slot_s"],
                             "d2h_s": t1 - t0 - got["slot_s"],
                             "digest_s": t2 - t1, "commit_s": t3 - t2,
                             "total_s": dt, "bytes": nbytes,
                             "new_slot": got["new"]}
        # the step ledger's weight_publish bucket
        durations.note_duration("weight_publish", dt)
        return WeightVersion(version, epoch)

    def _channel_notify(self, record: Dict[str, Any], blob) -> None:
        """Best-effort fast-path broadcast of the commit: the record with
        the payload's bytes inline when they fit the channel (the
        transport raises ``ValueError`` on oversize), else the record
        alone (subscribers read its slot).  A write timeout means a
        reader died or wedged: retire the channel; the store commit
        already happened, nothing is lost."""
        with self._lock:
            ch, room = self._channel, self._channel_bytes
        if ch is None:
            return
        try:
            msg = dict(record)
            if record["nbytes"] < room:
                msg["blob"] = blob.numpy().copy()
            try:
                ch.write(msg, timeout=self.channel_write_timeout_s)
            except ValueError:  # larger than the segment: record only
                ch.write(dict(record), timeout=self.channel_write_timeout_s)
            self.stats["channel_commits"] += 1
        except Exception as e:  # noqa: BLE001 — timeout, closed, unlinked
            logger.warning(
                "weight-sync %s: commit channel lost (%s); continuing on "
                "the durable path", self.name, type(e).__name__)
            self.stats["channel_retired"] += 1
            self.retire_channel()

    def close(self) -> None:
        """Retire the channel and unlink every payload slot."""
        self.retire_channel()
        for slot in self._slots:
            slot.destroy(self._kv)
        self._slots = []


class WeightSubscriber:
    """Consumer side: poll or receive commits, validate, swap atomically.

    Construction performs the resubscribe leg: one poll of the durable
    record, so a respawned process rejoins at the current version before
    serving anything.  ``current()`` raises
    :class:`NoWeightsPublishedError` until a first version commits.
    Tensors land on ``device`` (``None``: the card).  The reference's
    ``fetch_timeout_s`` has no counterpart: a payload here is a read of a
    shared-memory segment, which never waits on another process."""

    def __init__(self, name: str, *, staleness_bound: Optional[int] = None,
                 poll_interval_s: float = 0.05,
                 verify_on_read: bool = False, device=None, kv=None):
        self.name = name
        self.staleness_bound = staleness_bound
        self.poll_interval_s = poll_interval_s
        self.verify_on_read = verify_on_read
        self.device = device
        self._kv = _kv(kv)
        self._lock = threading.Lock()
        self._params: Any = None
        self._version: Optional[WeightVersion] = None
        self._digest: Optional[str] = None
        self._samples_at_version = 0
        self._channel = None
        # digest of the last REJECTED commit: a poisoned record would
        # otherwise be refetched and revalidated on every poll
        self._rejected_digest: Optional[str] = None
        self.stats = {"updates": 0, "rejected": 0, "stale_waits": 0,
                      "channel_updates": 0}
        # the last adopted version's fetch and verify, seconds
        self.last_fetch: Dict[str, float] = {}
        self.poll(timeout_s=0.0)  # resubscribe: adopt the current version

    # -- channel fast path -------------------------------------------------
    def attach_channel(self, info: Dict[str, Any], slot: int) -> None:
        """Attach to the publisher's commit channel at reader ``slot``.  A
        failed attach leaves the subscriber on the durable poll path."""
        if not info:
            return
        from ray_tpu_torch.experimental.channel import Channel
        from ray_tpu_torch.experimental.channel.transport import (
            TIER_HOST,
            EdgeTransport,
        )

        try:
            ch = Channel(info["name"], buffer_size=info["buffer_size"],
                         num_readers=info["num_readers"], _create=False)
            ch.set_reader_slot(slot)
            tr = EdgeTransport(ch, info.get("tier", TIER_HOST),
                               f"weights:{self.name}", self.device)
        except Exception:  # noqa: BLE001 — fall back to the store poll
            logger.warning("weight-sync %s: channel attach failed; using "
                           "the durable path", self.name)
            return
        with self._lock:
            self._channel = tr

    def detach_channel(self) -> None:
        with self._lock:
            ch, self._channel = self._channel, None
        if ch is not None:
            # unmap this reader's view only: closing the channel would
            # close it for the publisher too
            try:
                ch.channel.detach()
            except Exception:  # noqa: BLE001
                pass

    # -- consume -----------------------------------------------------------
    @property
    def version(self) -> Optional[WeightVersion]:
        with self._lock:
            return self._version

    def current(self) -> Tuple[Any, WeightVersion]:
        """Atomic ``(params, version)``.  With ``verify_on_read`` the tree
        is hashed again against the digest committed with it: direct
        evidence the served tree is not mixed across versions."""
        with self._lock:
            params, ver, digest = self._params, self._version, self._digest
        if ver is None:
            raise NoWeightsPublishedError(
                f"weight-sync {self.name!r}: no version committed yet")
        if self.verify_on_read:
            actual = params_digest(params, ver.version, ver.epoch)
            if actual != digest:
                raise WeightSyncError(
                    f"weight-sync {self.name!r}: served tree digest "
                    f"mismatch at v{ver.version}: mixed or torn params")
        return params, ver

    def note_sample(self) -> None:
        """Count one rollout batch served at the current version (the
        staleness gate's input)."""
        with self._lock:
            self._samples_at_version += 1

    def poll(self, timeout_s: float = 0.0) -> bool:
        """Check for, and adopt, a newer committed version: the channel
        first (it may carry the payload inline), then the durable record.
        True when a newer version was installed.  Bounded by
        ``timeout_s``."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        updated = self._drain_channel()
        if self._poll_durable():
            updated = True
        while not updated and time.monotonic() < deadline:
            time.sleep(self.poll_interval_s)
            updated = self._drain_channel() or self._poll_durable()
        return updated

    def gate(self, timeout_s: float = 30.0) -> None:
        """Staleness backpressure: a no-op under the bound; past it, block
        (bounded) until a newer version commits, else raise
        :class:`WeightsStaleError`."""
        if self.staleness_bound is None:
            return
        with self._lock:
            behind = self._samples_at_version >= self.staleness_bound
        if not behind:
            return
        self.stats["stale_waits"] += 1
        if self.poll(timeout_s=timeout_s):
            return
        with self._lock:
            ver = self._version
        raise WeightsStaleError(
            f"weight-sync {self.name!r}: {self._samples_at_version} "
            f"batches sampled at v{ver.version if ver else '?'} "
            f"(bound {self.staleness_bound}) and no newer publish within "
            f"{timeout_s:.1f}s: the learner is behind or dead")

    # -- internals ---------------------------------------------------------
    def _drain_channel(self) -> bool:
        with self._lock:
            ch = self._channel
        if ch is None:
            return False
        updated = False
        while True:
            try:
                msg = ch.read(timeout=0.0)
            except Exception:  # noqa: BLE001 — empty (timeout) or torn down
                break
            got = self._commit(msg, from_channel=True)
            updated = updated or got
            if not got:
                break
        return updated

    def _poll_durable(self) -> bool:
        try:
            rec = _read_latest_record(self.name, self._kv)
        except Exception:  # noqa: BLE001 — a store hiccup: keep serving
            return False
        if rec is None:
            return False
        with self._lock:
            cur = self._version
            rejected = self._rejected_digest
        if cur is not None and int(rec["version"]) <= cur.version:
            return False
        if rejected is not None and rec.get("digest") == rejected:
            return False  # already validated and refused this commit
        return self._commit(rec, from_channel=False)

    def _payload(self, msg: Dict[str, Any]) -> Optional[Any]:
        """The host tree a commit message carries inline (its blob's
        bytes) or names (its slot); None when the slot is gone or was
        reused (the subscriber keeps its current version)."""
        if "blob" in msg:
            return ca.reassemble({0: msg["blob"]})[0]
        try:
            tree = read_payload(msg)
        except Exception:  # noqa: BLE001 — a torn or unreadable slot
            tree = None
        if tree is None:
            logger.warning(
                "weight-sync %s: payload fetch for v%s failed; keeping the "
                "current version", self.name, msg.get("version"))
        return tree

    def _on_device(self, tree: Any) -> Any:
        """``tree`` with its tensors on the subscriber's device (resolved
        at the first tensor, so a tree without tensors needs no card)."""
        if self.device is not None and \
                torch.device(self.device).type == "cpu":
            return tree
        dev = []

        def move(x):
            if not isinstance(x, torch.Tensor):
                return x
            if not dev:
                dev.append(resolve_device(self.device))
            return x.to(dev[0], non_blocking=True)

        out = tree_map(move, tree)
        if dev:
            torch.cuda.synchronize(dev[0])
        return out

    def _commit(self, msg: Dict[str, Any], *, from_channel: bool) -> bool:
        """Validate and atomically install one commit message (a record
        with the payload's bytes inline, or naming its slot)."""
        t0 = time.perf_counter()
        version = int(msg["version"])
        epoch = int(msg["epoch"])
        with self._lock:
            if self._version is not None and \
                    version <= self._version.version:
                return False
        tree = self._payload(msg)
        if tree is None:
            return False
        t1 = time.perf_counter()
        digest = params_digest(tree, version, epoch)
        if digest != msg["digest"]:
            self.stats["rejected"] += 1
            with self._lock:
                self._rejected_digest = msg["digest"]
            logger.error(
                "weight-sync %s: digest mismatch on v%d: torn payload "
                "REJECTED, still serving %s", self.name, version,
                self._version)
            return False
        t2 = time.perf_counter()
        tree = self._on_device(tree)
        with self._lock:
            if self._version is not None and \
                    version <= self._version.version:
                return False  # raced a newer commit; keep it
            # the atomic swap: params, version and digest change together
            self._params = tree
            self._version = WeightVersion(version, epoch)
            self._digest = digest
            self._samples_at_version = 0
        self.stats["updates"] += 1
        if from_channel:
            self.stats["channel_updates"] += 1
        self.last_fetch = {"fetch_s": t1 - t0 + time.perf_counter() - t2,
                           "verify_s": t2 - t1,
                           "from_channel": from_channel}
        return True
