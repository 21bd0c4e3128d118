"""Tiered asynchronous sharded checkpointing for ``TorchTrainer``
(counterpart of ``ray_tpu/train/checkpoint_async.py``).

A train step pays only the **snapshot** (a finished host copy of the
pieces this rank owns), while the write to disk runs on a background
thread and a copy of the shard goes to a peer's RAM
(``ray_tpu_torch.util.checkpoint_replica``).  Restore walks a preference
ladder per shard, local RAM -> peer RAM -> committed disk, so the common
failure (one dead worker) restores with zero disk reads.

On-disk layout (the reference's, the WAL discipline of
``checkpoint_manager``)::

    <storage>/checkpoint_000007.tmp/     # staging dir, any rank creates
        shard_r00          # each rank: write shard_rNN.tmp, fsync, rename
        shard_r01
        MANIFEST.json      # rank 0, after ALL shards landed (tmp+rename)
    <storage>/checkpoint_000007/         # one rank-0 os.rename commits

A writer killed anywhere before the final rename leaves only a ``*.tmp``
dir that ``committed_checkpoint_dirs`` ignores and the next
``CheckpointManager`` sweeps.

Shard blobs are self-describing, so restore reassembles the full tree
from any mix of RAM and disk shards written by any world size.  The port's
blob is not the reference's pickle: it is one host byte buffer, a small
pickled header (the skeleton, every leaf's shape and dtype, each piece's
bounds and offset) followed by the pieces' raw bytes, 64-byte aligned.
Reading a header never touches the data, and a piece is copied once on
each side (bf16 travels as bytes; numpy has no such dtype).

What a rank owns (``snapshot_shards``): a DTensor leaf contributes its
local shard, its bounds from the placements, replicated mesh dims kept
only on their coordinate-0 rank (the reference's ``replica_id == 0``);
any other array is split along axis 0 by :func:`_split_bounds` over the
writers, small and scalar leaves owned whole by ``leaf_i % world``.  The
union over ranks tiles every leaf exactly once, which reassembly checks.

In-place safety: the port's optimizers update parameters in place, so the
snapshot is a finished host copy before ``save()`` returns.  Tensors on a
card are copied into one page-locked buffer and the copy is synchronized
before ``save()`` returns.  An ``AsyncCheckpointer`` keeps up to
``_LOCAL_KEEP + 1`` such buffers and writes a snapshot into one that
neither the local tier nor a persist or push still holds, so a save pays
the page-locking of a fresh buffer only for its first three generations.

A peer push carries the sha256 of each 64 MiB chunk of its blob in its
meta, and a restore takes a blob fetched from peer RAM only when its
bytes still match them.

Where the persist differs: the peer push and the disk write start
together on the background thread (the push first), instead of one after
the other; ``ram_acked`` lands as soon as the peer acks.

Fault sites: ``train.checkpoint.persist_async`` (the background shard
write), ``train.checkpoint.peer_push`` (in ``checkpoint_replica``),
``train.checkpoint.restore`` (the ladder's entry).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import queue
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.config import knob
from ray_tpu_torch.train.checkpoint_manager import (
    _fsync_dir,
    committed_checkpoint_dirs,
)
from ray_tpu_torch.util import checkpoint_replica as replica
from ray_tpu_torch.util.fault_injection import fault_point

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"

#: process-local RAM tier: ``(run, index, rank) -> blob``, the ladder's
#: first rung (free for a restart that kept this process alive)
_LOCAL_KEEP = 2
_local_lock = threading.Lock()
_local_cache: Dict[Tuple[str, int, int], Any] = {}

_MAGIC = b"RTPUCKP1"
_HEAD = struct.Struct("<8sQ")  # magic, header length
_ALIGN = 64
# a kept snapshot buffer serves blobs up to this many bytes smaller (the
# header's pickled metrics vary in length between saves)
_SLACK = 4 << 20
# the push meta's key for the blob's chunk digests
_DIGEST_KEY = "blob_sha256"


def _local_put(run: str, index: int, rank: int, blob) -> None:
    with _local_lock:
        _local_cache[(run, index, rank)] = blob
        gens = sorted({k[1] for k in _local_cache if k[0] == run})
        for old in gens[:-_LOCAL_KEEP]:
            for k in [k for k in _local_cache
                      if k[0] == run and k[1] == old]:
                del _local_cache[k]


def _local_get(run: str, index: int, rank: int):
    with _local_lock:
        return _local_cache.get((run, index, rank))


def _local_ptrs(run: str) -> set:
    """Data pointers of the blobs the local tier holds for ``run``."""
    with _local_lock:
        return {b.data_ptr() for k, b in _local_cache.items()
                if k[0] == run and isinstance(b, torch.Tensor)}


# ---------------------------------------------------------------------------
# chunked sha256 on a pool of threads (hashlib releases the GIL)
# ---------------------------------------------------------------------------

_CHUNK = 64 << 20  # bytes per hashed chunk
_hash_pool: Optional[ThreadPoolExecutor] = None
_hash_pool_lock = threading.Lock()


def chunk_digests(views: Sequence[memoryview]) -> List[List[bytes]]:
    """For each byte view, the sha256 of each of its 64 MiB chunks (one
    empty chunk for an empty view), all chunks hashed on a pool of
    threads."""
    global _hash_pool
    with _hash_pool_lock:
        if _hash_pool is None:
            _hash_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="rtpu-digest")
    chunks = [(i, mv[o:o + _CHUNK]) for i, mv in enumerate(views)
              for o in range(0, max(len(mv), 1), _CHUNK)]
    digests = list(_hash_pool.map(lambda c: hashlib.sha256(c[1]).digest(),
                                  chunks))
    out: List[List[bytes]] = [[] for _ in views]
    for (i, _), d in zip(chunks, digests):
        out[i].append(d)
    return out


def blob_digest(blob) -> List[str]:
    """The sha256 of each 64 MiB chunk of a blob, hex: what a peer push
    carries in its meta and a restore checks a fetched blob against."""
    return [d.hex() for d in chunk_digests([_view(blob)])[0]]


def shard_name(rank: int) -> str:
    return f"shard_r{rank:02d}"


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _view(blob) -> memoryview:
    """A blob as a flat byte view (a uint8 tensor, a numpy array or any
    bytes-like)."""
    if isinstance(blob, torch.Tensor):
        blob = blob.numpy()
    return memoryview(blob).cast("B")


def blob_nbytes(blob) -> int:
    return len(_view(blob))


def read_header(blob) -> Dict[str, Any]:
    """A blob's header, without reading its data."""
    mv = _view(blob)
    magic, n = _HEAD.unpack_from(mv, 0)
    if magic != _MAGIC:
        raise ValueError("not a checkpoint shard blob")
    return pickle.loads(mv[_HEAD.size:_HEAD.size + n])


def blob_pieces(blob) -> List[Tuple[str, Any, str, str, tuple, Any]]:
    """A blob's pieces as ``(path, bounds, kind, dtype, shape, data)``:
    ``data`` is a byte view of the piece inside the blob, or an object
    leaf's value."""
    raw = _view(blob)
    start = _pad(_HEAD.size + _HEAD.unpack_from(raw, 0)[1])
    return [(path, bounds, kind, dtype, tuple(shape),
             loc if kind == "object" else
             raw[start + loc[0]:start + loc[0] + loc[1]])
            for path, bounds, kind, dtype, shape, loc
            in read_header(blob)["pieces"]]


# ---------------------------------------------------------------------------
# snapshot: a finished host copy of the pieces THIS rank owns
# ---------------------------------------------------------------------------


def leaf_paths(tree: Any) -> Tuple[Any, List[str], List[Any]]:
    """(skeleton, path strings, leaves): the skeleton is the tree with each
    leaf replaced by its path string (``jax.tree_util.keystr``'s form).
    Dicts keep their insertion order, so a restored tree lines up with
    state built beside it (an optimizer's moment lists follow the order
    of the params dict)."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(x, prefix):
        if isinstance(x, dict):
            return {k: walk(v, f"{prefix}[{k!r}]") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, f"{prefix}[{i}]") for i, v in enumerate(x))
        paths.append(prefix)
        leaves.append(x)
        return prefix

    skeleton = walk(tree, "")
    return skeleton, paths, leaves


def _split_bounds(dim0: int, world: int) -> List[Tuple[int, int]]:
    """Contiguous ``np.array_split``-compatible [lo, hi) bounds of a
    leading axis of size ``dim0`` over ``world`` writers."""
    base, extra = divmod(dim0, world)
    bounds, lo = [], 0
    for r in range(world):
        hi = lo + base + (1 if r < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _skeleton_map(fn, skeleton):
    if isinstance(skeleton, dict):
        return {k: _skeleton_map(fn, v) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_skeleton_map(fn, v) for v in skeleton)
    return fn(skeleton)


def _is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and hasattr(x, "placements") \
        and hasattr(x, "to_local")


def _dtensor_piece(x) -> Optional[Tuple[List[Tuple[int, int]], Any]]:
    """This rank's ``(bounds, local tensor)`` of DTensor ``x``, or None
    when a replicated mesh dim puts it on another coordinate."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    for i, p in enumerate(x.placements):
        if isinstance(p, Replicate) and coord[i] != 0:
            return None
        if not isinstance(p, (Replicate, Shard)):
            raise ValueError(f"cannot snapshot a DTensor placed {p}: "
                             "redistribute it to Shard or Replicate first")
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, x.placements)
    bounds = [(o, o + s) for o, s in zip(offset, shape)]
    return bounds, x.to_local()


def _kind(x) -> Tuple[str, str, Tuple[int, ...]]:
    """A leaf's (kind, dtype, shape): kind "torch", "numpy" or "object"."""
    if isinstance(x, torch.Tensor):
        return "torch", str(x.dtype).removeprefix("torch."), tuple(x.shape)
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        if arr.dtype != object:
            return "numpy", str(arr.dtype), tuple(arr.shape)
    return "object", "object", ()


def _nbytes(kind: str, dtype: str, shape) -> int:
    n = int(np.prod(shape)) if len(shape) else 1
    if kind == "torch":
        return n * torch.empty((), dtype=getattr(torch, dtype)).element_size()
    return n * np.dtype(dtype).itemsize


def snapshot_shards(tree: Any, rank: int, world: int,
                    run: str = "", index: int = 0,
                    meta: Optional[Dict[str, Any]] = None,
                    alloc: Optional[Callable[[int, bool], torch.Tensor]]
                    = None) -> torch.Tensor:
    """Snapshot the pieces ``rank`` owns as one self-describing blob: a
    uint8 CPU tensor, page-locked when the tree holds tensors on a card.
    Every piece is a finished host copy when this returns: the caller may
    update the tree in place at once.  ``alloc(nbytes, page_locked)``,
    when given, supplies the blob's memory (a reused buffer); else it is
    allocated here."""
    skeleton, paths, leaves = leaf_paths(tree)
    leaf_info: Dict[str, Tuple[List[int], str, str]] = {}
    # (path, bounds or None, kind, dtype, shape, source or value)
    owned: List[Tuple[str, Any, str, str, tuple, Any]] = []
    for i, (path, x) in enumerate(zip(paths, leaves)):
        kind, dtype, shape = _kind(x)
        leaf_info[path] = (list(shape), dtype, kind)
        if _is_dtensor(x):
            got = _dtensor_piece(x)
            if got is not None:
                bounds, local = got
                owned.append((path, bounds, kind, dtype,
                              tuple(local.shape), local.detach()))
            continue
        if kind == "object":
            if i % world == rank:
                owned.append((path, None, kind, dtype, shape, x))
            continue
        src = x.detach() if kind == "torch" else np.asarray(x)
        if len(shape) >= 1 and shape[0] >= world > 1:
            lo, hi = _split_bounds(shape[0], world)[rank]
            bounds = [(lo, hi)] + [(0, d) for d in shape[1:]]
            owned.append((path, bounds, kind, dtype,
                          (hi - lo,) + tuple(shape[1:]), src[lo:hi]))
        elif i % world == rank:
            owned.append((path, None, kind, dtype, shape, src))
    pieces, off = [], 0
    for path, bounds, kind, dtype, shape, src in owned:
        if kind == "object":
            pieces.append((path, bounds, kind, dtype, shape, src))
            continue
        n = _nbytes(kind, dtype, shape)
        pieces.append((path, bounds, kind, dtype, shape, (off, n)))
        off = _pad(off + n)
    header = pickle.dumps({
        "format": 1, "run": run, "index": index, "rank": rank,
        "world": world, "skeleton": skeleton, "leaves": leaf_info,
        "pieces": pieces, "meta": dict(meta or {})})
    start = _pad(_HEAD.size + len(header))
    on_card = {src.device for *_, src in owned
               if isinstance(src, torch.Tensor) and src.device.type == "cuda"}
    if alloc is not None:
        blob = alloc(start + off, bool(on_card))
    else:
        blob = torch.empty(start + off, dtype=torch.uint8,
                           pin_memory=bool(on_card))
    raw = blob.numpy()
    _HEAD.pack_into(raw, 0, _MAGIC, len(header))
    raw[_HEAD.size:_HEAD.size + len(header)] = np.frombuffer(header,
                                                             np.uint8)
    for (_, _, kind, dtype, shape, loc), (*_, src) in zip(pieces, owned):
        if kind == "object":
            continue
        o, n = loc
        if kind == "torch":
            dst = blob[start + o:start + o + n].view(
                getattr(torch, dtype)).view(shape)
            dst.copy_(src, non_blocking=True)
        else:
            dst = np.frombuffer(raw, np.dtype(dtype),
                                n // np.dtype(dtype).itemsize,
                                start + o).reshape(shape)
            dst[...] = src
    for dev in on_card:
        torch.cuda.current_stream(dev).synchronize()
    return blob


# ---------------------------------------------------------------------------
# disk tier: per-rank shard stage+fsync+rename, rank-0 manifest commit
# ---------------------------------------------------------------------------


def _staging_dir(storage_dir: str, index: int) -> str:
    return os.path.join(storage_dir, f"checkpoint_{index:06d}.tmp")


def _committed_dir(storage_dir: str, index: int) -> str:
    return os.path.join(storage_dir, f"checkpoint_{index:06d}")


def write_shard(storage_dir: str, index: int, rank: int, blob) -> str:
    """Persist one rank's shard into the generation's staging dir: write
    ``shard_rNN.tmp``, fsync, rename to ``shard_rNN``.  A crash mid-write
    leaves only ``*.tmp`` names the manifest commit ignores."""
    stage = _staging_dir(storage_dir, index)
    os.makedirs(stage, exist_ok=True)
    final = os.path.join(stage, shard_name(rank))
    tmp = final + ".tmp"
    fault_point("train.checkpoint.persist_async")
    with open(tmp, "wb") as f:
        f.write(_view(blob))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    _fsync_dir(stage)
    return final


def commit_manifest(storage_dir: str, index: int, world: int,
                    meta: Optional[Dict[str, Any]] = None,
                    wait_s: Optional[float] = None) -> str:
    """Rank 0's commit leg: wait (bounded) for all ``world`` shard files,
    write ``MANIFEST.json`` (tmp+fsync+rename), then publish the whole
    generation with one directory rename.  ``TimeoutError`` if a writer
    died mid-persist: the generation stays ``*.tmp``, unobservable."""
    if wait_s is None:
        wait_s = knob("train_checkpoint_manifest_wait_s")
    stage = _staging_dir(storage_dir, index)
    want = {shard_name(r) for r in range(world)}
    deadline = time.monotonic() + wait_s
    while True:
        try:
            have = set(os.listdir(stage))
        except OSError:
            have = set()
        if want <= have:
            break
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"checkpoint_{index:06d}: shards missing after {wait_s}s: "
                f"{sorted(want - have)} (a writer died mid-persist; the "
                "generation stays torn/.tmp)")
        time.sleep(0.05)
    manifest = {
        "index": index,
        "world_size": world,
        "sharded": True,
        "shards": sorted(want),
        "meta": dict(meta or {}),
    }
    mtmp = os.path.join(stage, MANIFEST_NAME + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.rename(mtmp, os.path.join(stage, MANIFEST_NAME))
    _fsync_dir(stage)
    dest = _committed_dir(storage_dir, index)
    # the commit point: a kill here leaves .tmp only
    fault_point("train.checkpoint.commit")
    os.rename(stage, dest)
    _fsync_dir(storage_dir)
    return dest


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The manifest of a committed sharded checkpoint dir (None for a
    whole-tree checkpoint, which has none)."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# reassembly (resharding-aware): the full tree from any world's shards
# ---------------------------------------------------------------------------


class IncompleteCheckpointError(RuntimeError):
    """A generation's shards do not tile every leaf exactly once."""


def reassemble(blobs: Dict[int, Any]) -> Tuple[Any, Dict[str, Any]]:
    """Rebuild the full host tree from one generation's shard blobs
    (``{writer_rank: blob}``), whichever world wrote them: tensors as CPU
    tensors, numpy arrays as numpy arrays, other values as they were.
    Checks exact tiling and raises :class:`IncompleteCheckpointError`
    otherwise."""
    if not blobs:
        raise IncompleteCheckpointError("no shard blobs to reassemble")
    heads = {r: read_header(b) for r, b in blobs.items()}
    ref = heads[min(heads)]
    world = ref["world"]
    if set(heads) != set(range(world)):
        raise IncompleteCheckpointError(
            f"have writer ranks {sorted(heads)}, need 0..{world - 1}")
    arrays: Dict[str, Any] = {}
    filled: Dict[str, int] = {}
    for path, (shape, dtype, kind) in ref["leaves"].items():
        if kind == "torch":
            arrays[path] = torch.empty(shape, dtype=getattr(torch, dtype))
        elif kind == "numpy":
            arrays[path] = np.empty(shape, dtype=np.dtype(dtype))
        else:
            arrays[path] = None
        filled[path] = 0
    for r in heads:
        for path, bounds, kind, dtype, shape, data in blob_pieces(blobs[r]):
            if kind == "object":
                arrays[path] = data
                filled[path] += 1
                continue
            count = int(np.prod(shape)) if len(shape) else 1
            idx = (Ellipsis,) if bounds is None else \
                tuple(slice(lo, hi) for lo, hi in bounds)
            if kind == "torch":
                # as bytes, the last axis widened by the item size: bf16
                # has no numpy dtype, and a read-only blob stays unwritten
                dst = arrays[path]
                isz = dst.element_size()
                dst = (dst if dst.dim() else dst.reshape(1)).view(
                    torch.uint8).numpy()
                pshape = tuple(shape) or (1,)
                piece = np.frombuffer(data, np.uint8).reshape(
                    pshape[:-1] + (pshape[-1] * isz,))
                if bounds is not None and bounds:
                    lo, hi = bounds[-1]
                    idx = idx[:-1] + (slice(lo * isz, hi * isz),)
                dst[idx] = piece
            else:
                arrays[path][idx] = np.frombuffer(
                    data, np.dtype(dtype), count).reshape(shape)
            filled[path] += count
    for path, (shape, _dtype, kind) in ref["leaves"].items():
        want = 1 if kind == "object" or not shape else int(np.prod(shape))
        if filled[path] != want:
            raise IncompleteCheckpointError(
                f"leaf {path}: {filled[path]} of {want} elements covered "
                "(overlapping or missing shard pieces)")
    tree = _skeleton_map(lambda p: arrays[p], ref["skeleton"])
    return tree, dict(ref["meta"])


def load_disk_shards(path: str,
                     ranks: Optional[Sequence[int]] = None
                     ) -> Dict[int, np.ndarray]:
    """Read shard blobs from a committed sharded checkpoint dir."""
    manifest = read_manifest(path)
    if manifest is None:
        return {}
    world = manifest["world_size"]
    want = range(world) if ranks is None else ranks
    out: Dict[int, np.ndarray] = {}
    for r in want:
        try:
            out[r] = np.fromfile(os.path.join(path, shard_name(r)),
                                 dtype=np.uint8)
        except OSError:
            continue
    return out


# ---------------------------------------------------------------------------
# restore ladder: local RAM -> peer RAM -> committed disk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RestoreResult:
    tree: Any
    meta: Dict[str, Any]
    index: int
    world: int                    # world size that WROTE the checkpoint
    tier_by_rank: Dict[int, str]  # writer rank -> "local"|"peer"|"disk"
    disk_reads: int
    path: Optional[str]           # committed dir (None for memory tier)
    # seconds spent per tier fetching this generation's shards, and on
    # reassembly
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def tier(self) -> str:
        """The slowest tier the ladder had to touch ("memory" when no
        shard needed disk)."""
        return "disk" if self.disk_reads else "memory"


def _blob_world(blob) -> int:
    return read_header(blob)["world"]


def _peer_blob(fetched, run: str, index: int, rank: int):
    """The blob of a peer fetch ``(blob, meta)`` when it is the shard
    asked for and its bytes match the chunk digests its push carried,
    else None (a missing shard)."""
    if fetched is None or not _blob_matches(fetched[0], run, index, rank):
        return None
    want = fetched[1].get(_DIGEST_KEY)
    if want is not None and blob_digest(fetched[0]) != want:
        logger.warning("restore %s: checkpoint_%06d rank %d from peer RAM "
                       "does not match its digest; treated as missing",
                       run, index, rank)
        return None
    return fetched[0]


def _blob_matches(blob, run: str, index: int, rank: int) -> bool:
    """A RAM or local blob is checked against the generation being
    restored: one whose embedded ``(run, index, rank)`` disagrees with the
    slot it came from is MISSING, never reassembled."""
    try:
        hdr = read_header(blob)
        return (hdr.get("run", run) == run and hdr.get("index") == index
                and hdr.get("rank") == rank)
    except Exception:  # noqa: BLE001 — a corrupt blob is a missing shard
        return False


def restore_tiered(storage_dir: Optional[str], run: str, *,
                   server_names: Sequence[str] = (),
                   rpc_timeout_s: Optional[float] = None
                   ) -> Optional[RestoreResult]:
    """Restore the newest complete generation of ``run``, preferring RAM
    over disk per shard.

    Candidates are the committed disk generations, the generations the
    replica plane holds in RAM and this process's local ones.  For each,
    newest first, every writer rank's shard comes through the ladder
    (local, then peer RAM, then the committed disk file), and the first
    generation that reassembles completely wins."""
    fault_point("train.checkpoint.restore")
    if rpc_timeout_s is None:
        rpc_timeout_s = knob("train_checkpoint_replica_rpc_timeout_s")
    disk: Dict[int, str] = {}
    if storage_dir:
        for index, path in committed_checkpoint_dirs(storage_dir):
            if read_manifest(path) is not None:
                disk[index] = path
    ram = replica.ram_manifest_by_names(server_names, timeout=rpc_timeout_s) \
        if server_names else {}
    with _local_lock:
        local_gens = sorted({k[1] for k in _local_cache if k[0] == run})
    candidates = sorted(set(disk) | set(ram) | set(local_gens), reverse=True)
    for index in candidates:
        got: Dict[int, Any] = {}
        tier_by_rank: Dict[int, str] = {}
        seconds = {"local": 0.0, "peer": 0.0, "disk": 0.0}
        disk_reads = 0
        world: Optional[int] = None
        path = disk.get(index)
        if path is not None:
            manifest = read_manifest(path)
            world = manifest["world_size"] if manifest else None
        with _local_lock:
            local_ranks = [k[2] for k in _local_cache
                           if k[0] == run and k[1] == index]
        probe_ranks = ram.get(index, []) or local_ranks
        if world is None and probe_ranks:
            pr = probe_ranks[0]
            lb = _local_get(run, index, pr)
            if lb is not None and _blob_matches(lb, run, index, pr):
                world, got[pr] = _blob_world(lb), lb
            elif server_names:
                t0 = time.perf_counter()
                fetched = _peer_blob(replica.fetch_shard(
                    server_names, index, pr, timeout=rpc_timeout_s),
                    run, index, pr)
                seconds["peer"] += time.perf_counter() - t0
                if fetched is not None:
                    world, got[pr] = _blob_world(fetched), fetched
        if world is None:
            continue
        ok = True
        for r in range(world):
            if r in got:
                lb = _local_get(run, index, r)
                tier_by_rank[r] = "local" if (
                    lb is not None and _blob_matches(lb, run, index, r)
                ) else "peer"
                continue
            blob = _local_get(run, index, r)
            if blob is not None and _blob_matches(blob, run, index, r):
                got[r] = blob
                tier_by_rank[r] = "local"
                continue
            if server_names:
                t0 = time.perf_counter()
                fetched = _peer_blob(replica.fetch_shard(
                    server_names, index, r, timeout=rpc_timeout_s),
                    run, index, r)
                seconds["peer"] += time.perf_counter() - t0
                if fetched is not None:
                    got[r] = fetched
                    tier_by_rank[r] = "peer"
                    continue
            if path is not None:
                t0 = time.perf_counter()
                from_disk = load_disk_shards(path, ranks=[r])
                seconds["disk"] += time.perf_counter() - t0
                if r in from_disk:
                    got[r] = from_disk[r]
                    tier_by_rank[r] = "disk"
                    disk_reads += 1
                    continue
            ok = False
            break
        if not ok:
            logger.warning(
                "restore %s: generation %d incomplete across all tiers; "
                "trying older", run, index)
            continue
        try:
            t0 = time.perf_counter()
            tree, meta = reassemble(got)
            seconds["reassemble"] = time.perf_counter() - t0
        except IncompleteCheckpointError as e:
            logger.warning("restore %s: generation %d: %s", run, index, e)
            continue
        return RestoreResult(tree=tree, meta=meta, index=index, world=world,
                             tier_by_rank=tier_by_rank,
                             disk_reads=disk_reads, path=path,
                             seconds=seconds)
    return None


# ---------------------------------------------------------------------------
# the async checkpointer: snapshot inline, persist+replicate in background
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TieredCheckpoint:
    """Handle for one tiered save: returned by ``AsyncCheckpointer.save``
    the moment the snapshot is in host RAM (``ram_acked`` and
    ``committed_path`` fill in as the background tiers land)."""

    run: str
    index: int
    rank: int
    world: int
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    ram_acked: bool = False
    committed_path: Optional[str] = None
    error: Optional[BaseException] = dataclasses.field(
        default=None, repr=False, compare=False)
    # seconds: the inline snapshot, the peer push, the whole persist
    snapshot_s: float = 0.0
    push_s: float = 0.0
    persist_s: float = 0.0
    nbytes: int = 0

    @property
    def tier(self) -> str:
        """Best durability tier reached so far: ``disk`` once the manifest
        committed, else ``memory`` once a peer acked, else ``local``."""
        if self.committed_path:
            return "disk"
        return "memory" if self.ram_acked else "local"

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class AsyncCheckpointer:
    """Per-rank tiered checkpoint writer with one-in-flight backpressure.

    ``save()`` snapshots (host copy + local cache) inline, the only cost
    the step pays, charged to the ``checkpoint_snapshot`` ledger bucket,
    then hands persist and replication to a daemon thread: the peer-RAM
    push (the emergency tier lands fastest) and the fsynced shard write
    and, on rank 0, the manifest commit.  A second ``save()`` while a
    persist is in flight waits (bounded by
    ``train_checkpoint_persist_wait_s``, charged to
    ``checkpoint_persist``), never silently drops a snapshot.  A
    ``preempt_ram`` hook (the session's memory-tier drain request)
    preempts that wait and commits the save at the peer-RAM tier inline.
    """

    def __init__(self, storage_dir: Optional[str], run: str, rank: int,
                 world: int, *, peer_name: Optional[str] = None,
                 server_names: Sequence[str] = (),
                 ledger: Any = None, publish_status: bool = True,
                 preempt_ram: Optional[Callable[[], bool]] = None,
                 drain_avoid: Optional[Callable[[], Any]] = None):
        self.storage_dir = storage_dir
        self.run = run
        self.rank = rank
        self.world = world
        self.peer_name = peer_name
        self.server_names = list(server_names)
        self._preempt_ram = preempt_ram
        self._drain_avoid = drain_avoid
        self._ledger = ledger
        self._publish_status = publish_status
        self._idle = threading.Event()
        self._idle.set()
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[TieredCheckpoint] = None
        self._next_index: Optional[int] = None
        self._lock = threading.Lock()
        self._closed = False
        self._snapshot_s = 0.0
        self._persist_s = 0.0
        # reused snapshot buffers, and per buffer (by data pointer) the
        # persists and pushes still reading it
        self._buffers: List[Tuple[torch.Tensor, bool]] = []
        self._readers: Dict[int, int] = {}

    # -- snapshot buffers ---------------------------------------------------

    def _alloc(self, nbytes: int, pinned: bool) -> torch.Tensor:
        """A buffer for a snapshot of ``nbytes``: a kept one of this size
        class that no local generation, persist or push holds, else a new
        one (kept while fewer than ``_LOCAL_KEEP + 1`` are)."""
        held = _local_ptrs(self.run)
        with self._lock:
            def busy(b):
                return b.data_ptr() in held or self._readers.get(b.data_ptr())

            def fits(b, p):
                return p == pinned and nbytes <= b.numel() <= nbytes + _SLACK

            for b, p in self._buffers:
                if fits(b, p) and not busy(b):
                    return b[:nbytes]
            # a buffer of another size class goes once nothing holds it
            self._buffers = [(b, p) for b, p in self._buffers
                             if fits(b, p) or busy(b)]
            keep = sum(fits(*bp) for bp in self._buffers) <= _LOCAL_KEEP
        cap = (nbytes + _SLACK // 2 + (1 << 20) - 1) >> 20 << 20
        b = torch.empty(cap, dtype=torch.uint8, pin_memory=pinned)
        if keep:
            with self._lock:
                self._buffers.append((b, pinned))
        return b[:nbytes]

    def _hold(self, blob, n: int) -> None:
        if not isinstance(blob, torch.Tensor):
            return
        ptr = blob.data_ptr()
        with self._lock:
            self._readers[ptr] = self._readers.get(ptr, 0) + n
            if self._readers[ptr] <= 0:
                del self._readers[ptr]

    # -- indexing -----------------------------------------------------------

    def _ensure_index(self) -> int:
        """First-save index discovery: one past the newest COMPLETE
        generation in any tier (committed disk dirs, RAM generations
        holding every writer's shard).  Complete generations are the only
        fixed points every rank observes alike, so lockstep saves agree
        on their indices."""
        if self._next_index is None:
            base = 0
            if self.storage_dir:
                dirs = committed_checkpoint_dirs(self.storage_dir)
                if dirs:
                    base = dirs[-1][0]
            if self.server_names:
                complete = replica.ram_complete_generations(
                    self.server_names)
                if complete:
                    base = max(base, complete[-1])
            self._next_index = base + 1
        return self._next_index

    def _emergency_peer(self, avoid: Any) -> Optional[str]:
        """Push target for a memory-tier emergency save: the ring peer
        unless the drain notice covers its unit, else the first server on
        a surviving unit (names end in ``::<unit>``)."""
        avoid = set(avoid or ())

        def _node(name: str) -> str:
            return name.rsplit("::", 1)[-1]

        if self.peer_name and _node(self.peer_name) not in avoid:
            return self.peer_name
        for name in self.server_names:
            if _node(name) not in avoid:
                return name
        return self.peer_name  # every unit doomed: best effort

    # -- background persist -------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._persist_loop,
                name=f"ckpt-persist-{self.run}-r{self.rank}", daemon=True)
            self._thread.start()

    def _persist_loop(self) -> None:
        while True:
            try:
                # bounded wake-ups: a wedged owner's daemon thread still
                # notices the close
                job = self._q.get(timeout=5.0)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if job is None:
                return
            handle, blob, meta = job
            t0 = time.perf_counter()
            try:
                self._persist_one(handle, blob, meta)
            except BaseException as e:  # noqa: BLE001 — surfaced on handle
                handle.error = e
                logger.warning(
                    "async persist of %s checkpoint_%06d rank %d failed: "
                    "%s (durable tiers: %s)", self.run, handle.index,
                    self.rank, e, handle.tier)
            finally:
                dur = time.perf_counter() - t0
                self._persist_s = handle.persist_s = dur
                if self._ledger is not None:
                    # off the step's critical path, but attributed
                    self._ledger.note("checkpoint_persist", dur)
                self._hold(blob, -1)
                handle.done.set()
                self._idle.set()
                self._publish_kv(handle)

    def _push(self, handle: TieredCheckpoint, target: str, blob,
              meta: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        self._hold(blob, 1)
        try:
            handle.ram_acked = replica.push_shard(
                target, handle.index, self.rank, blob,
                {"run": self.run, "world": self.world, **meta,
                 _DIGEST_KEY: blob_digest(blob)})
        except Exception as e:  # noqa: BLE001 — the peer may be dead
            handle.ram_acked = False
            logger.warning(
                "peer-RAM push of %s checkpoint_%06d rank %d to %s failed "
                "(%s); continuing with the disk tier", self.run,
                handle.index, self.rank, target, e)
        finally:
            self._hold(blob, -1)
        handle.push_s = time.perf_counter() - t0

    def _persist_one(self, handle: TieredCheckpoint, blob,
                     meta: Dict[str, Any]) -> None:
        # the emergency tier first: a short-deadline drain waits on the
        # peer ack, so it starts before the disk write and never waits
        # for it; a failed push degrades, it never aborts the disk tier
        pusher = None
        if self.peer_name:
            pusher = threading.Thread(
                target=self._push, args=(handle, self.peer_name, blob, meta),
                name=f"ckpt-push-{self.run}-r{self.rank}", daemon=True)
            pusher.start()
        try:
            if self.storage_dir:
                write_shard(self.storage_dir, handle.index, self.rank, blob)
                if self.rank == 0:
                    handle.committed_path = commit_manifest(
                        self.storage_dir, handle.index, self.world, meta)
                else:
                    # non-zero ranks see the commit too (bounded poll)
                    dest = _committed_dir(self.storage_dir, handle.index)
                    deadline = time.monotonic() + \
                        knob("train_checkpoint_manifest_wait_s")
                    while time.monotonic() < deadline:
                        if os.path.isdir(dest):
                            handle.committed_path = dest
                            break
                        time.sleep(0.05)
        finally:
            if pusher is not None:
                # the push is bounded by the replica RPC timeout
                pusher.join(knob("train_checkpoint_replica_rpc_timeout_s")
                            + 5.0)

    # -- the public face ----------------------------------------------------

    def save(self, tree: Any, metrics: Optional[Dict[str, Any]] = None, *,
             wait_persist: bool = False,
             persist_wait_s: Optional[float] = None) -> TieredCheckpoint:
        """Tiered save of this rank's shards of ``tree``.

        Returns as soon as the snapshot is in host RAM (and queued for
        persist and replication).  ``wait_persist=True`` blocks until the
        disk tier lands too."""
        if persist_wait_s is None:
            persist_wait_s = knob("train_checkpoint_persist_wait_s")
        # backpressure: at most one persist in flight; a memory-tier drain
        # request preempts the wait (the push below never queues on disk)
        ram_only = self._preempt_ram is not None and self._preempt_ram()
        if not ram_only and not self._idle.is_set():
            t0 = time.perf_counter()
            deadline = t0 + persist_wait_s
            while not self._idle.wait(0.05):
                if self._preempt_ram is not None and self._preempt_ram():
                    ram_only = True
                    break
                if time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"checkpoint persist backpressure: previous "
                        f"persist still in flight after {persist_wait_s}s")
            if self._ledger is not None:
                self._ledger.note("checkpoint_persist",
                                  time.perf_counter() - t0)
        t0 = time.perf_counter()
        index = self._ensure_index()
        self._next_index = index + 1
        meta = dict(metrics or {})
        blob = snapshot_shards(tree, self.rank, self.world,
                               run=self.run, index=index, meta=meta,
                               alloc=self._alloc)
        _local_put(self.run, index, self.rank, blob)
        snap_s = time.perf_counter() - t0
        self._snapshot_s = snap_s
        if self._ledger is not None:
            self._ledger.note("checkpoint_snapshot", snap_s)
        handle = TieredCheckpoint(run=self.run, index=index,
                                  rank=self.rank, world=self.world,
                                  snapshot_s=snap_s,
                                  nbytes=blob_nbytes(blob))
        with self._lock:
            self._last = handle
        if ram_only:
            # emergency memory-tier save: an inline peer push, no disk leg
            # for this generation; the in-flight persist keeps running
            t1 = time.perf_counter()
            target = self._emergency_peer(
                self._drain_avoid() if self._drain_avoid else ())
            if target:
                self._push(handle, target, blob, meta)
            handle.done.set()
            if self._ledger is not None:
                self._ledger.note("checkpoint_persist",
                                  time.perf_counter() - t1)
            self._publish_kv(handle)
            return handle
        self._idle.clear()
        self._ensure_thread()
        self._hold(blob, 1)
        self._q.put((handle, blob, meta))
        if wait_persist:
            handle.wait(persist_wait_s)
            if handle.error is not None:
                raise handle.error
        return handle

    @property
    def last(self) -> Optional[TieredCheckpoint]:
        with self._lock:
            return self._last

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain the persist queue (True when idle within ``timeout``)."""
        return self._idle.wait(timeout)

    def commit_ram(self, timeout: Optional[float] = None) -> bool:
        """Wait (bounded) for the LAST save's peer-RAM ack: the
        ``memory``-tier commit a short-deadline drain needs."""
        handle = self.last
        if handle is None:
            return False
        if timeout is None:
            timeout = knob("train_checkpoint_persist_wait_s")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if handle.ram_acked or handle.committed_path:
                return True
            if handle.done.is_set():
                return bool(handle.ram_acked or handle.committed_path)
            time.sleep(0.02)
        return bool(handle.ram_acked or handle.committed_path)

    def restore(self) -> Optional[RestoreResult]:
        """Walk the restore ladder with this checkpointer's wiring (see
        :func:`restore_tiered`); a restore pins this rank's next save
        index to ``restored + 1``, so every restarted rank numbers its
        saves alike."""
        res = restore_tiered(self.storage_dir, self.run,
                             server_names=self.server_names)
        if res is not None:
            self._next_index = res.index + 1
        return res

    def close(self, timeout: float = 5.0) -> None:
        self._idle.wait(timeout)
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout)

    # -- per-tier status in the run's store ---------------------------------

    def _publish_kv(self, handle: TieredCheckpoint) -> None:
        """The rank's tier status under ``ckpt_status/<run>/<rank>`` in the
        run's store, when there is one (best-effort)."""
        if not self._publish_status:
            return
        try:
            from ray_tpu_torch._private import kv as kv_mod

            if kv_mod.address() is None:
                return
            rec = {
                "ts": time.time(), "run": self.run, "rank": self.rank,
                "world": self.world, "index": handle.index,
                "tier": handle.tier, "ram_acked": handle.ram_acked,
                "committed_path": handle.committed_path,
                "snapshot_s": round(self._snapshot_s, 6),
                "persist_s": round(self._persist_s, 6),
                "error": repr(handle.error) if handle.error else None,
            }
            kv_mod.client().put(f"ckpt_status/{self.run}/{self.rank}",
                                json.dumps(rec).encode())
        except Exception:  # noqa: BLE001 — surfacing never fails a save
            pass
