"""Dataset: the lazy, streaming dataset API (counterpart of
``ray_tpu/data/dataset.py``).

Reference: ``python/ray/data/dataset.py`` — transforms build a
``LogicalPlan``; actions/iteration plan it (with operator fusion),
execute on the streaming executor, and stream ``RefBundle``s back.

Port notes: blocks are numpy column dicts held by this process;
``iter_torch_batches``/``to_tensors`` land them on the card through
page-locked staging (``iterator.py``); ``streaming_split`` feeds
``TorchTrainer`` workers over shared-memory channels.  Sort, groupby,
aggregate, join, the pandas/arrow conversions and the writes wait.
"""

from __future__ import annotations

import atexit
import queue
import threading
import traceback
import uuid
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data import transforms as T
from ray_tpu_torch.data.block import BlockAccessor, Schema, concat_blocks
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.operators import ActorPoolStrategy, RefBundle
from ray_tpu_torch.data.planner import plan as plan_physical
from ray_tpu_torch.data.streaming_executor import (
    StreamingExecutor,
    execute_streaming_split,
)
from ray_tpu_torch.experimental.channel.shared_memory_channel import (
    Channel,
    ChannelClosedError,
)


class Dataset:
    def __init__(self, plan: L.LogicalPlan):
        self._plan = plan

    # -- plan-building transforms (lazy) --------------------------------------

    def _with(self, op_cls, *args, **kwargs) -> "Dataset":
        return Dataset(L.LogicalPlan(op_cls(self._plan.dag, *args, **kwargs)))

    def map_batches(self, fn, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute: Optional[ActorPoolStrategy] = None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    concurrency: Optional[int] = None) -> "Dataset":
        if concurrency is not None and compute is None and isinstance(fn, type):
            compute = ActorPoolStrategy(size=concurrency)
        return self._with(L.MapBatches, fn, batch_size=batch_size,
                          batch_format=batch_format, compute=compute,
                          fn_args=fn_args, fn_kwargs=fn_kwargs)

    def map(self, fn, **kw) -> "Dataset":
        return self._with(L.MapRows, fn, **kw)

    def flat_map(self, fn, **kw) -> "Dataset":
        return self._with(L.FlatMap, fn, **kw)

    def filter(self, fn, **kw) -> "Dataset":
        return self._with(L.Filter, fn, **kw)

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda b: {c: b[c] for c in cols})

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)
        return self.map_batches(
            lambda b: {c: v for c, v in b.items() if c not in drop})

    def add_column(self, name: str, fn: Callable[[Dict[str, np.ndarray]], np.ndarray]
                   ) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch

        return self.map_batches(add)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(c, c): v for c, v in b.items()})

    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        return self._with(L.Repartition, num_blocks, shuffle)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomShuffle, seed, num_blocks)

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomizeBlocks, seed)

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit, n)

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(L.LogicalPlan(
            L.Union(self._plan.dag, *[o._plan.dag for o in others])))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(L.LogicalPlan(L.Zip(self._plan.dag, other._plan.dag)))

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        mat = ds.materialize()
        n = mat.count()
        n_test = int(n * test_size)
        return mat.split_at_indices([n - n_test])

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Keep each row independently with probability ``fraction``
        (reference ``Dataset.random_sample``).  With ``seed`` the draw is
        deterministic per block: a digest of the block's first column
        joins the seed, so blocks do not share one keep-mask."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        def sample(batch):
            import zlib

            n = len(next(iter(batch.values()))) if batch else 0
            if seed is None:
                rng = np.random.default_rng()
            else:
                first = np.ascontiguousarray(next(iter(batch.values()))) \
                    if batch else np.empty(0)
                rng = np.random.default_rng(
                    [seed, zlib.crc32(first.tobytes())])
            keep = rng.random(n) < fraction
            return {c: v[keep] for c, v in batch.items()}

        return self.map_batches(sample)

    def to_torch(self, **iter_kwargs):
        """Iterable torch dataset over this Dataset's batches (wraps
        ``iter_torch_batches``)."""
        import torch

        outer = self

        class _IterableDS(torch.utils.data.IterableDataset):
            def __iter__(self):
                return outer.iter_torch_batches(**iter_kwargs)

        return _IterableDS()

    # -- execution ------------------------------------------------------------

    def _execute(self) -> Iterator[RefBundle]:
        optimized = L.optimize(self._plan)
        sink = plan_physical(optimized.dag)
        return StreamingExecutor(sink).run()

    def explain(self) -> str:
        return L.optimize(self._plan).explain()

    def materialize(self) -> "MaterializedDataset":
        return MaterializedDataset(list(self._execute()))

    def iterator(self) -> DataIterator:
        return DataIterator(self._execute, owner=self)

    # -- consumption ----------------------------------------------------------

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_rows()

    def iter_torch_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_torch_batches(**kw)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        for batch in self.limit(batch_size).iter_batches(
                batch_size=batch_size, batch_format=batch_format):
            return batch
        return {}

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(bundle.num_rows() for bundle in self._execute())

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s) if s is not None else []

    def schema(self) -> Optional[Schema]:
        """``{column: (dtype, shape of one row)}`` of the first block."""
        for bundle in self.limit(1)._execute():
            for ref, meta in bundle.blocks:
                if meta.schema:
                    return meta.schema
                return BlockAccessor(_tasks.get(ref)).schema()
        return None

    def num_blocks(self) -> int:
        return sum(len(b.blocks) for b in self._execute())

    def size_bytes(self) -> int:
        return sum(b.size_bytes() for b in self._execute())

    # -- conversion -----------------------------------------------------------

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return BlockAccessor(concat_blocks(self._all_blocks())).to_numpy()

    def to_tensors(self, *, device=None) -> Dict[str, Any]:
        """The whole dataset as tensors on ``device`` (small datasets
        only; the counterpart of ``to_jax``).  ``device=None`` is the
        train worker's device inside a train loop, else the card; the
        columns land through page-locked staging as
        ``iter_torch_batches``'s do."""
        from ray_tpu_torch.data.iterator import (IngestStats, _H2DStager,
                                                 _landing_device)

        stager = _H2DStager(None, _landing_device(device), IngestStats())
        try:
            return stager.to_device(self.to_numpy()).handoff()
        finally:
            stager.close()

    def _all_blocks(self) -> List[Dict[str, np.ndarray]]:
        return [_tasks.get(ref) for bundle in self._execute()
                for ref, _ in bundle.blocks]

    # -- splits ---------------------------------------------------------------

    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        mat = self.materialize()
        blocks = [b for bundle in mat._bundles for b in bundle.blocks]
        if equal:
            total = sum(m.num_rows for _, m in blocks)
            per = total // n
            return self.split_at_indices([per * i for i in range(1, n)])
        groups: List[List] = [[] for _ in range(n)]
        rows = [0] * n
        for ref, meta in blocks:
            i = int(np.argmin(rows))
            groups[i].append((ref, meta))
            rows[i] += meta.num_rows
        return [MaterializedDataset([RefBundle(g)] if g else [])
                for g in groups]

    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        mat = self.materialize()
        blocks = [b for bundle in mat._bundles for b in bundle.blocks]
        bounds = list(indices) + [sum(m.num_rows for _, m in blocks)]
        out: List[MaterializedDataset] = []
        pos = 0
        bi = 0
        cur: List = []
        for ref, meta in blocks:
            off = 0
            while off < meta.num_rows:
                end = bounds[bi] if bi < len(bounds) else pos + (meta.num_rows - off)
                take = min(meta.num_rows - off, max(0, end - pos))
                if take == 0:
                    out.append(MaterializedDataset([RefBundle(cur)] if cur else []))
                    cur = []
                    bi += 1
                    continue
                if take == meta.num_rows and off == 0:
                    cur.append((ref, meta))
                else:
                    refs, metas = _tasks.get(
                        T.slice_block.remote(ref, off, off + take))
                    cur.append((refs[0], metas[0]))
                off += take
                pos += take
        out.append(MaterializedDataset([RefBundle(cur)] if cur else []))
        while len(out) < len(bounds):
            out.append(MaterializedDataset([]))
        return out

    def streaming_split(self, n: int, *, equal: bool = False
                        ) -> "StreamingSplit":
        """n single-pass iterators consuming one shared streaming
        execution (reference: ``Dataset.streaming_split`` feeding Train
        workers).

        The execution runs in a coordinator thread of this process (the
        reference runs it in an actor) and serves rank r through a
        shared-memory channel of its own: one writer, one reader, one
        frame per bundle, written while the rank batches the bundle
        before.  Each iterator pickles to its channel's name, so it
        crosses a ``spawn`` to a train worker without the dataset or the
        user's functions.  The terminal frame carries the splitter's
        counters; an execution error is sent to every rank and raised
        there.  A rank's segment is destroyed once it has read its
        terminal frame, and every segment by ``shutdown()`` on the
        returned list.
        """
        coord = _SplitCoordinator(self, n, equal)
        return StreamingSplit(
            [DataIterator(src, owner=coord) for src in coord.sources()],
            coord)

    def stats(self) -> str:
        return self.explain()

    def __repr__(self):
        return f"Dataset({self._plan.dag.name})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already materialized."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__(L.LogicalPlan(L.InputData(bundles)))
        self._bundles = bundles

    def _execute(self) -> Iterator[RefBundle]:
        if isinstance(self._plan.dag, L.InputData):
            return iter(self._bundles)
        return super()._execute()

    def materialize(self) -> "MaterializedDataset":
        return self

    def count(self) -> int:
        return sum(b.num_rows() for b in self._bundles)

    def num_blocks(self) -> int:
        return sum(len(b.blocks) for b in self._bundles)


# -- streaming_split over shared-memory channels ------------------------------

SEGMENT_PREFIX = "rtpu_data_"
# room for a frame's header and pickled core beside its largest block
_FRAME_SLACK = 1 << 20


class StreamingSplit(list):
    """The iterators of one ``streaming_split``; ``shutdown()`` stops its
    execution and destroys its segments."""

    def __init__(self, iterators: List[DataIterator],
                 coordinator: "_SplitCoordinator"):
        super().__init__(iterators)
        self.coordinator = coordinator

    def shutdown(self) -> None:
        self.coordinator.shutdown()


def _send(ch: Channel, msg) -> None:
    """Write ``msg`` as one frame, or, when it exceeds the channel, as a
    ``chunked`` frame and the serialized bytes in frames that fit."""
    from ray_tpu_torch._private import serialization

    core, bufs, total = serialization.serialize_parts(msg)
    if total <= ch.buffer_size:
        serialization.write_parts(ch.acquire_write_buffer(total), core, bufs)
        ch.commit_write(total)
        return
    data = bytearray(total)
    serialization.write_parts(data, core, bufs)
    ch.write_value(("chunked", total))
    view = memoryview(data)
    for off in range(0, total, ch.buffer_size):
        ch.write_bytes(view[off:off + ch.buffer_size])


def _recv(ch: Channel):
    from ray_tpu_torch._private import serialization

    kind, body = ch.read_value(device="cpu")
    if kind != "chunked":
        return kind, body
    data = bytearray(body)
    off = 0
    while off < body:
        view, version = ch.read_acquire()
        data[off:off + len(view)] = view
        off += len(view)
        ch.read_release(version)
    return serialization.deserialize(data, device="cpu")


class _SplitSource:
    """Rank r's end of a streaming_split: the bundles its channel carries.
    Pickles to the channel's name and size; attaches when iterated."""

    def __init__(self, name: str, buffer_size: int):
        self.name = name
        self.buffer_size = buffer_size
        self.final_split: Dict[str, Any] = {}

    def __call__(self) -> Iterator[RefBundle]:
        ch = Channel(self.name, buffer_size=self.buffer_size, _create=False)
        try:
            while True:
                kind, body = _recv(ch)
                if kind == "bundle":
                    yield RefBundle([(_tasks.put(b), m) for b, m in body])
                elif kind == "end":
                    self.final_split["split"] = body
                    return
                else:
                    raise body
        finally:
            ch.detach()


def _portable(error: BaseException) -> BaseException:
    """``error`` if it pickles, else a RuntimeError carrying its text."""
    import pickle

    try:
        pickle.dumps(error)
        return error
    except Exception:  # noqa: BLE001 — any pickling failure
        return RuntimeError("".join(traceback.format_exception(error)))


_live_splits: "weakref.WeakSet[_SplitCoordinator]" = weakref.WeakSet()
_atexit_registered = False


def _shutdown_live_splits() -> None:
    for coord in list(_live_splits):
        coord.shutdown()


class _SplitCoordinator:
    """Runs one streaming_split execution in this process and serves each
    rank's bundles through its channel, one thread per rank."""

    def __init__(self, ds: Dataset, n: int, equal: bool):
        global _atexit_registered
        from ray_tpu_torch.data.context import DataContext

        sink = plan_physical(L.optimize(ds._plan).dag)
        size = DataContext.get_current().target_max_block_size + _FRAME_SLACK
        self.channels: List[Channel] = []
        try:
            for _ in range(n):
                # the Python plane: bundles serialize into the segment
                self.channels.append(Channel(
                    f"{SEGMENT_PREFIX}{uuid.uuid4().hex[:16]}",
                    buffer_size=size, native=False))
        except BaseException:
            for ch in self.channels:
                ch.destroy()
            raise
        self._queues, self._splitter, self._executor = \
            execute_streaming_split(sink, n, equal)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._destroyed = [False] * n
        self._threads = [
            threading.Thread(target=self._serve, args=(r,), daemon=True,
                             name=f"rtpu-data-split-r{r}") for r in range(n)]
        for t in self._threads:
            t.start()
        _live_splits.add(self)
        if not _atexit_registered:
            atexit.register(_shutdown_live_splits)
            _atexit_registered = True

    def sources(self) -> List[_SplitSource]:
        return [_SplitSource(ch.name, ch.buffer_size) for ch in self.channels]

    def split_stats(self) -> Dict[str, Any]:
        return self._splitter.split_stats()

    def _next(self, r: int):
        while True:
            try:
                return self._queues[r].get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    raise ChannelClosedError("streaming_split shut down") \
                        from None

    def _serve(self, r: int) -> None:
        ch = self.channels[r]
        try:
            while True:
                item = self._next(r)
                if isinstance(item, RefBundle):
                    _send(ch, ("bundle", [(_tasks.get(ref), meta)
                                          for ref, meta in item.blocks]))
                    continue
                if isinstance(item, BaseException):
                    _send(ch, ("error", _portable(item)))
                else:
                    _send(ch, ("end", self.split_stats()))
                ch.wait_readers()  # the rank read it
                break
        except ChannelClosedError:
            pass  # shut down before the rank drained
        except Exception as e:  # noqa: BLE001 — a frame that failed: the rank raises
            try:
                _send(ch, ("error", _portable(e)))
                ch.wait_readers()
            except ChannelClosedError:
                pass
        self._destroy(r)

    def _destroy(self, r: int) -> None:
        with self._lock:
            if not self._destroyed[r]:
                self._destroyed[r] = True
                self.channels[r].destroy()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the execution, close every channel (a rank still reading
        raises), and destroy every segment."""
        self._stop.set()
        self._executor.shutdown()
        with self._lock:
            for r, ch in enumerate(self.channels):
                if not self._destroyed[r]:
                    ch.close()
        for t in self._threads:
            t.join(timeout)
        for r, t in enumerate(self._threads):
            if not t.is_alive():  # a live thread may still write its segment
                self._destroy(r)
        _live_splits.discard(self)
