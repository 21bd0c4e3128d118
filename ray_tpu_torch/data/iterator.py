"""DataIterator: pipelined batch iteration with prefetch and device landing
(counterpart of ``ray_tpu/data/iterator.py``).

Reference: ``python/ray/data/iterator.py`` (``iter_batches :109`` with
``prefetch_batches``, ``iter_torch_batches``) and
``air/_internal/torch_utils.py`` device transfer.  As in the reference:

* **Block-prefetch lookahead**: a source thread admits upcoming blocks
  into a byte-budgeted window (``DataContext.iterator_lookahead_bytes``)
  so that fetching blocks k+1..k+N overlaps batching of block k.  The
  port's blocks live in this process (or arrive over a streaming_split
  channel), so there is no remote pull to start.
* ``iter_torch_batches`` is the counterpart of ``iter_jax_batches``: host
  batches form on one thread and land on the device on another, behind
  a depth-N device-side buffer, so the copy of batch i+1 overlaps the
  consumer's compute on batch i.  On CUDA each column is cast into one of
  two page-locked staging buffers per key and copied on a dedicated copy
  stream (``_H2DStager``).
* Every iterator keeps an :class:`IngestStats` ledger (block-wait,
  batch-format, host cast, H2D, consumer-blocked time) surfaced by
  :meth:`DataIterator.stats`; ``data_wait`` and ``h2d`` also reach a
  train step's ``StepLedger`` through the duration sinks.

Not ported: ``sharding=`` placement on a ``DeviceMesh``, and the
``util.metrics`` gauges and KV records of the ingest stats (the port has
neither a metrics plane nor a dashboard).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private.concurrency import (
    ProducerDiedError,
    get_live,
    put_unless_stopped,
)
from ray_tpu_torch._private.durations import note_duration
from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks, num_rows
from ray_tpu_torch.data.context import DataContext

_SENTINEL = object()

_iter_ids = itertools.count()


class IngestStats:
    """Per-iterator ingest-pipeline timings.

    Updated from the pipeline threads and the consumer under one lock.
    With the pipeline on, ``consumer_blocked_s`` (time the consumer
    actually stalled) drops below ``block_fetch_total_s`` (source wait +
    block fetch, wherever it ran); serially they are the same number.
    ``h2d_s`` is the stager's host time per batch (the host cast and the
    copies' enqueue).  The copies' time on the device is not taken here:
    an event pair around the enqueue would also count the copy thread's
    waits for the interpreter between them; read it from a device trace.
    """

    def __init__(self):
        self.iterator_id = f"it-{os.getpid()}-{next(_iter_ids)}"
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()
        self._fields: Dict[str, float] = {
            "source_wait_s": 0.0,      # waiting on the bundle source
            "block_fetch_s": 0.0,      # waiting for block payloads (get)
            "batch_format_s": 0.0,     # slicing/concat/format conversion
            "h2d_s": 0.0,              # the stager's host time
            "host_cast_s": 0.0,        # of it: casting into staging buffers
            "h2d_batches": 0,          # batches copied to the card
            "h2d_bytes": 0,            # bytes those copies moved
            "pinned_bytes": 0,         # page-locked staging held now
            "consumer_blocked_s": 0.0,  # consumer stalled on the pipeline
            "blocks": 0,
            "batches": 0,
            "bytes_fetched": 0,
            "device_batches_in_flight": 0,
            "device_prefetch_depth": 0,   # high-water mark
            "device_buffer_capacity": 0,
        }
        # a streaming_split's terminal counters (rows per rank)
        self._split: Optional[Dict[str, Any]] = None

    def add(self, field: str, value: float) -> None:
        with self._lock:
            self._fields[field] += value
        # feed the step-time attribution ledger (train.StepLedger): a
        # consumer-facing stall is data-wait, device staging is H2D
        if field == "consumer_blocked_s":
            note_duration("data_wait", value)
        elif field == "h2d_s":
            note_duration("h2d", value)

    def set_max(self, field: str, value: float) -> None:
        with self._lock:
            if value > self._fields[field]:
                self._fields[field] = value

    def set(self, field: str, value: float) -> None:
        with self._lock:
            self._fields[field] = value

    def on_block(self, meta, *, fetch_s: float = 0.0) -> None:
        with self._lock:
            self._fields["blocks"] += 1
            self._fields["block_fetch_s"] += fetch_s
            self._fields["bytes_fetched"] += meta.size_bytes

    def merge_split_stats(self, split: Dict[str, Any]) -> None:
        # the coordinator's counters are cumulative totals: replace
        with self._lock:
            self._split = dict(split)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._fields)
            out["split"] = self._split
        out["wall_s"] = time.perf_counter() - self._t_start
        out["block_fetch_total_s"] = (
            out["source_wait_s"] + out["block_fetch_s"])
        out["iterator"] = self.iterator_id
        return out

    def report(self) -> str:
        d = self.to_dict()
        lines = [
            f"Ingest pipeline stats [{d['iterator']}]",
            f"  blocks: {d['blocks']}  batches: {d['batches']}  "
            f"bytes: {d['bytes_fetched']}",
            f"  source wait: {d['source_wait_s']:.3f}s  "
            f"block fetch: {d['block_fetch_s']:.3f}s  "
            f"(total fetch: {d['block_fetch_total_s']:.3f}s)",
            f"  batch format: {d['batch_format_s']:.3f}s  "
            f"h2d: {d['h2d_s']:.3f}s (host cast {d['host_cast_s']:.3f}s)",
            f"  consumer blocked: {d['consumer_blocked_s']:.3f}s  "
            f"of wall {d['wall_s']:.3f}s",
        ]
        if d["split"] is not None:
            lines.append(f"  split rows per rank: "
                         f"{d['split']['rows_per_output']}")
        if d["h2d_batches"]:
            lines.append(
                f"  device copies: {d['h2d_bytes']} bytes over "
                f"{d['h2d_batches']} batches; page-locked staging "
                f"{d['pinned_bytes']} bytes")
        if d["device_buffer_capacity"]:
            lines.append(
                f"  device buffer: depth {d['device_prefetch_depth']}"
                f"/{d['device_buffer_capacity']} "
                f"(in flight now: {d['device_batches_in_flight']})")
        return "\n".join(lines)


class _Batcher:
    """Slice a stream of blocks into fixed-size batches, carrying remainders."""

    def __init__(self, batch_size: Optional[int], batch_format: str):
        self._size = batch_size
        self._format = batch_format
        self._carry: List[Block] = []
        self._carry_rows = 0

    def add(self, block: Block) -> Iterator[Any]:
        if num_rows(block) == 0:
            return
        if self._size is None:
            yield BlockAccessor(block).to_batch(self._format)
            return
        self._carry.append(block)
        self._carry_rows += num_rows(block)
        if self._carry_rows < self._size:
            return
        merged = concat_blocks(self._carry)
        acc = BlockAccessor(merged)
        total = acc.num_rows()
        start = 0
        while total - start >= self._size:
            yield BlockAccessor(acc.slice(start, start + self._size)
                                ).to_batch(self._format)
            start += self._size
        rest = acc.slice(start, total)
        self._carry = [rest] if num_rows(rest) else []
        self._carry_rows = num_rows(rest)

    def flush(self, drop_last: bool) -> Iterator[Any]:
        if self._carry and not drop_last:
            merged = concat_blocks(self._carry)
            if num_rows(merged):
                yield BlockAccessor(merged).to_batch(self._format)
        self._carry, self._carry_rows = [], 0


class _ShuffleBuffer:
    """Local shuffle buffer applied upstream of batching
    (reference: ``iter_batches(local_shuffle_buffer_size=...)``).

    Samples ``chunk`` rows out whenever the buffer holds at least
    ``min_rows + chunk`` rows, keeping it topped up to ``min_rows`` like
    the reference's shuffling batcher; the buffer is permuted once per
    refill, and each chunk is a slice of the permuted rows.
    """

    def __init__(self, min_rows: int, seed: Optional[int],
                 chunk_rows: Optional[int] = None):
        self._min = min_rows
        self._chunk = max(1, chunk_rows or max(1, min_rows // 8))
        self._rng = np.random.default_rng(seed)
        self._pending: List[Block] = []
        self._permuted: Optional[Block] = None
        self._cursor = 0
        self._rows = 0

    def add(self, block: Block) -> Iterator[Block]:
        if num_rows(block):
            self._pending.append(block)
            self._rows += num_rows(block)
        while self._rows >= self._min + self._chunk:
            yield self._sample(self._chunk)

    def flush(self) -> Iterator[Block]:
        while self._rows:
            yield self._sample(min(self._chunk, self._rows))

    def _sample(self, k: int) -> Block:
        avail = 0 if self._permuted is None \
            else num_rows(self._permuted) - self._cursor
        if avail < k:
            parts = list(self._pending)
            if avail:
                parts.insert(0, BlockAccessor(self._permuted).slice(
                    self._cursor, num_rows(self._permuted)))
            self._pending = []
            merged = concat_blocks(parts)
            self._permuted = BlockAccessor(merged).take_rows(
                self._rng.permutation(num_rows(merged)))
            self._cursor = 0
        out = BlockAccessor(self._permuted).slice(self._cursor,
                                                  self._cursor + k)
        self._cursor += k
        self._rows -= k
        return out


class _BlockPrefetcher:
    """Sliding-window block lookahead (the lookahead stage).

    A source thread walks the bundle stream and admits upcoming block refs
    into a byte-budgeted window while block k is being batched.  Blocks
    surface strictly in stream order; a source error surfaces at its
    position; closing the returned generator stops the thread promptly
    and drops the window's refs.
    """

    def __init__(self, source: Callable[[], Iterator], stats: IngestStats,
                 window_bytes: int, max_blocks: int,
                 count_blocked: bool = True):
        self._source = source
        self._stats = stats
        # whether this stage faces the end consumer directly (no
        # downstream _prefetch buffer): only then do its waits count as
        # consumer-blocked time
        self._count_blocked = count_blocked
        self._window_bytes = max(1, window_bytes)
        self._max_blocks = max(2, max_blocks)
        # unbounded: admission is gated by the byte window below
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._admit = threading.Condition()
        self._inflight_bytes = 0
        self._inflight_blocks = 0

    def _room(self) -> bool:
        # always keep >= 2 admitted (the head + one ahead), otherwise
        # honor the byte budget and the block cap
        return (self._inflight_blocks < 2
                or (self._inflight_bytes < self._window_bytes
                    and self._inflight_blocks < self._max_blocks))

    def _run(self):
        src = self._source()
        try:
            while True:
                t0 = time.perf_counter()
                bundle = next(src, _SENTINEL)
                self._stats.add("source_wait_s",
                                time.perf_counter() - t0)
                if bundle is _SENTINEL or self._stop.is_set():
                    return
                for ref, meta in bundle.blocks:
                    with self._admit:
                        while not self._room() and not self._stop.is_set():
                            self._admit.wait(0.05)
                        if self._stop.is_set():
                            return
                        self._inflight_bytes += meta.size_bytes
                        self._inflight_blocks += 1
                    self._q.put((ref, meta))
        except BaseException as e:  # noqa: BLE001 — in-order propagation
            self._q.put(e)
        finally:
            try:
                close = getattr(src, "close", None)
                if close is not None:
                    close()  # this thread owns src: safe, runs finallys
            except BaseException:  # noqa: BLE001
                pass
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[Block]:
        producer = threading.Thread(target=self._run, daemon=True,
                                    name="rtpu-data-lookahead")
        producer.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = get_live(self._q, producer,
                                what="block-prefetch producer")
                if self._count_blocked:
                    self._stats.add("consumer_blocked_s",
                                    time.perf_counter() - t0)
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                ref, meta = item
                t1 = time.perf_counter()
                block = _tasks.get(ref)
                fetch_s = time.perf_counter() - t1
                if self._count_blocked:
                    self._stats.add("consumer_blocked_s", fetch_s)
                self._stats.on_block(meta, fetch_s=fetch_s)
                with self._admit:
                    self._inflight_bytes -= meta.size_bytes
                    self._inflight_blocks -= 1
                    self._admit.notify_all()
                yield block
        finally:
            self._stop.set()
            with self._admit:
                self._admit.notify_all()


def _rebuild_iterator(source, lookahead_bytes, lookahead_max_blocks,
                      default_batch_format, prefetch_batches):
    it = DataIterator.__new__(DataIterator)
    it._init(source, None, lookahead_bytes, lookahead_max_blocks,
             default_batch_format, prefetch_batches)
    return it


class DataIterator:
    """Iterates batches over a (re-runnable) stream of RefBundles.

    A ``streaming_split`` iterator pickles to its channel's name, so it
    crosses a ``spawn`` to a train worker without its dataset; the knobs
    of ``DataContext`` travel with it, snapshot where it was made."""

    def __init__(self, bundle_source: Callable[[], Iterator], owner=None):
        ctx = DataContext.get_current()
        self._init(bundle_source, owner, ctx.iterator_lookahead_bytes,
                   ctx.iterator_lookahead_max_blocks,
                   ctx.default_batch_format, ctx.prefetch_batches)

    def _init(self, bundle_source, owner, lookahead_bytes,
              lookahead_max_blocks, default_batch_format, prefetch_batches):
        self._source = bundle_source
        self._owner = owner  # keeps the Dataset (or split coordinator) alive
        # a streaming_split source carries a cell its terminal frame fills
        # with the splitter's final counters
        self._final_split = getattr(bundle_source, "final_split", None)
        self._stats = IngestStats()
        self._lookahead_bytes = lookahead_bytes
        self._lookahead_max_blocks = lookahead_max_blocks
        self._default_batch_format = default_batch_format
        self._prefetch_batches = prefetch_batches

    def __reduce__(self):
        return (_rebuild_iterator, (
            self._source, self._lookahead_bytes, self._lookahead_max_blocks,
            self._default_batch_format, self._prefetch_batches))

    @property
    def ingest_stats(self) -> IngestStats:
        return self._stats

    def stats(self) -> str:
        """Human-readable ingest pipeline report (block-wait, batch
        formation, host cast, H2D, consumer-blocked time)."""
        if not self._merge_terminal_split_stats():
            split_stats = getattr(self._owner, "split_stats", None)
            if split_stats is not None:
                self._stats.merge_split_stats(split_stats())
        return self._stats.report()

    def _merge_terminal_split_stats(self) -> bool:
        cell = self._final_split
        if cell is None or cell.get("split") is None:
            return False
        self._stats.merge_split_stats(cell["split"])
        return True

    def _iter_blocks(self, count_blocked: bool = True) -> Iterator[Block]:
        if self._lookahead_bytes and self._lookahead_bytes > 0:
            return iter(_BlockPrefetcher(
                self._source, self._stats,
                self._lookahead_bytes,
                self._lookahead_max_blocks,
                count_blocked=count_blocked))
        return self._iter_blocks_serial(count_blocked=count_blocked)

    def _iter_blocks_serial(self, count_blocked: bool = True
                            ) -> Iterator[Block]:
        """Forced-serial baseline (lookahead disabled): one blocking get
        per block."""
        src = self._source()
        while True:
            t0 = time.perf_counter()
            bundle = next(src, _SENTINEL)
            dt = time.perf_counter() - t0
            self._stats.add("source_wait_s", dt)
            if count_blocked:
                self._stats.add("consumer_blocked_s", dt)
            if bundle is _SENTINEL:
                return
            for ref, meta in bundle.blocks:
                t1 = time.perf_counter()
                block = _tasks.get(ref)
                fetch_s = time.perf_counter() - t1
                if count_blocked:
                    self._stats.add("consumer_blocked_s", fetch_s)
                self._stats.on_block(meta, fetch_s=fetch_s)
                yield block

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = None,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: Optional[int] = None,
        _count_blocked: Optional[bool] = None,
    ) -> Iterator[Any]:
        batch_format = batch_format or self._default_batch_format
        if prefetch_batches is None:
            prefetch_batches = self._prefetch_batches
        stats = self._stats
        # consumer-blocked time is only charged at the outermost
        # consumer-facing stage (the _prefetch buffer when present, else
        # the block stage): inner stages stalling would double-count
        outermost = not prefetch_batches or prefetch_batches <= 0
        if _count_blocked is not None:
            outermost = _count_blocked and outermost

        def producer() -> Iterator[Any]:
            batcher = _Batcher(batch_size, batch_format)
            shuffler = (_ShuffleBuffer(local_shuffle_buffer_size,
                                       local_shuffle_seed,
                                       chunk_rows=batch_size)
                        if local_shuffle_buffer_size else None)

            def form(block) -> List[Any]:
                t0 = time.perf_counter()
                if shuffler is not None:
                    out = [b for shuffled in shuffler.add(block)
                           for b in batcher.add(shuffled)]
                else:
                    out = list(batcher.add(block))
                stats.add("batch_format_s", time.perf_counter() - t0)
                return out

            try:
                for block in self._iter_blocks(count_blocked=outermost):
                    for b in form(block):
                        stats.add("batches", 1)
                        yield b
                t0 = time.perf_counter()
                tail: List[Any] = []
                if shuffler is not None:
                    for shuffled in shuffler.flush():
                        tail.extend(batcher.add(shuffled))
                tail.extend(batcher.flush(drop_last))
                stats.add("batch_format_s", time.perf_counter() - t0)
                for b in tail:
                    stats.add("batches", 1)
                    yield b
            finally:
                self._merge_terminal_split_stats()

        if prefetch_batches and prefetch_batches > 0:
            return _prefetch(producer(), prefetch_batches, stats=stats)
        return producer()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    # -- device paths ---------------------------------------------------------

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device=None,
        drop_last: bool = True,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: Optional[int] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield batches as torch tensors already on ``device``.

        ``device=None`` is this train worker's device
        (``train.get_context().get_device()``) inside a train loop, else
        the card; without CUDA it raises unless the caller passes
        ``device="cpu"``.  ``dtypes`` maps columns to the dtype they land
        in (the host casts them while staging).

        Two pipeline stages behind the consumer: host batch formation on
        one thread, the landing on another feeding a
        depth-``prefetch_batches`` device-side buffer, so the copy of
        batch i+1 overlaps consumer compute on batch i.  On CUDA every
        column goes through one of two page-locked staging buffers per
        key (reused; never a copy from pageable memory) and is copied on
        a dedicated stream; the consumer's stream waits on the copy's
        event before the batch is handed over.

        ``device="cpu", prefetch_batches=0`` is the reference's plain
        ``iter_torch_batches``: batches built and converted on the
        calling thread.  A CPU batch is a fresh buffer of its own, never
        reused for a later batch.
        """
        dev = _landing_device(device)
        n_prefetch = (self._prefetch_batches
                      if prefetch_batches is None else prefetch_batches)
        stats = self._stats
        stager = _H2DStager(dtypes, dev, stats)
        kw = dict(batch_size=batch_size, batch_format="numpy",
                  drop_last=drop_last,
                  local_shuffle_buffer_size=local_shuffle_buffer_size,
                  local_shuffle_seed=local_shuffle_seed, prefetch_batches=0)
        if n_prefetch <= 0:
            return _handed_over(_staged(self.iter_batches(**kw), stager))
        stats.set("device_buffer_capacity", n_prefetch)
        # stage 1: host batching decoupled from the landing, so slow batch
        # formation can't starve the copy thread of its lookahead
        staged_host = _prefetch(self.iter_batches(**kw, _count_blocked=False),
                                n_prefetch)
        # stage 2: the depth-n device-side buffer the consumer drains
        return _handed_over(_prefetch(_staged(staged_host, stager),
                                      n_prefetch, stats=stats,
                                      device_depth=True))


def _landing_device(device):
    """``device`` as a ``torch.device``: ``None`` is the train worker's
    device inside a train loop, else the card."""
    import torch

    from ray_tpu_torch._device import resolve_device

    if device is None:
        from ray_tpu_torch.train.session import worker_device

        device = worker_device()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _staged(host_batches: Iterator[Dict[str, np.ndarray]],
            stager: "_H2DStager") -> Iterator["_Landed"]:
    try:
        for batch in host_batches:
            yield stager.to_device(batch)
    finally:
        close = getattr(host_batches, "close", None)
        if close is not None:
            close()
        stager.close()


def _handed_over(landed: Iterator["_Landed"]) -> Iterator[Dict[str, Any]]:
    try:
        for item in landed:
            yield item.handoff()
    finally:
        landed.close()


def _torch_dtype(dtype):
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class _Landed:
    """One batch on its device, and the event its copies completed at."""

    __slots__ = ("batch", "event")

    def __init__(self, batch: Dict[str, Any], event=None):
        self.batch = batch
        self.event = event

    def handoff(self) -> Dict[str, Any]:
        """On the consumer's thread: make its current stream wait for the
        copies, and tie each tensor's memory to that stream, so that the
        caching allocator cannot hand it out while the consumer's work
        still reads it."""
        if self.event is not None:
            import torch

            for t in self.batch.values():
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(self.event)
                t.record_stream(stream)
        return self.batch


class _H2DStager:
    """Casts each host batch into staging buffers and lands it on the
    device (counterpart of the reference's ``_H2DStager``).

    On CUDA every column is written into one of two page-locked staging
    tensors per key (allocated once per shape and dtype) by the host
    cast, then copied with ``non_blocking=True`` on one dedicated copy
    stream, with an event recorded per slot.  Reusing a slot first waits
    for that slot's event, recorded two batches earlier (the counterpart
    of ``block_until_ready``), so the host never overwrites a buffer
    under a copy.

    On the CPU the tensor handed out is its staging buffer, with no copy,
    so every batch gets a fresh buffer: a batch, or any slice of it the
    consumer keeps, is never overwritten (the reference's alias guard,
    which never reuses a buffer on the CPU).
    """

    def __init__(self, dtypes: Optional[Dict[str, Any]], device,
                 stats: IngestStats):
        self._dtypes = {k: _torch_dtype(v) for k, v in (dtypes or {}).items()}
        self._device = device
        self._cuda = device.type == "cuda"
        self._stats = stats
        self._bufs: Dict[Tuple[str, int], Any] = {}  # CUDA: (key, slot) -> pinned
        self._events: List[Any] = [None, None]       # CUDA: per slot
        self._stream = None
        self._tick = 0

    def to_device(self, batch: Dict[str, np.ndarray]) -> _Landed:
        import torch

        t0 = time.perf_counter()
        if not self._cuda:
            out = {k: _fill(torch.empty(v.shape, dtype=self._target(k, v)),
                            v) for k, v in batch.items()}
            self._stats.add("host_cast_s", time.perf_counter() - t0)
            self._stats.add("h2d_s", time.perf_counter() - t0)
            return _Landed(out)
        slot = self._tick % 2
        self._tick += 1
        # the device scoped to this call: the caller's current device is
        # left as it was when the stager runs on the consumer's thread
        with torch.cuda.device(self._device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self._device)
            self._retire(slot)
            host = {k: _fill(self._slot_buffer(k, slot, v), v)
                    for k, v in batch.items()}
            self._stats.add("host_cast_s", time.perf_counter() - t0)
            with torch.cuda.stream(self._stream):
                out = {k: buf.to(self._device, non_blocking=True)
                       for k, buf in host.items()}
                done = torch.cuda.Event()
                done.record()
        self._events[slot] = done
        self._stats.add("h2d_batches", 1)
        self._stats.add("h2d_bytes", sum(b.nbytes for b in host.values()))
        self._stats.add("h2d_s", time.perf_counter() - t0)
        return _Landed(out, done)

    def _retire(self, slot: int) -> None:
        """Wait for the copies staged from ``slot`` two batches ago."""
        if self._events[slot] is not None:
            self._events[slot].synchronize()
            self._events[slot] = None

    def close(self) -> None:
        for slot in (0, 1):
            self._retire(slot)

    def _target(self, k: str, v: np.ndarray):
        if v.dtype == object:
            raise TypeError(
                f"column {k!r} holds Python objects; only numeric columns "
                "land as tensors")
        return self._dtypes.get(k) or _torch_dtype(v.dtype)

    def _slot_buffer(self, k: str, slot: int, v: np.ndarray):
        """The page-locked buffer of ``(k, slot)``, made anew only when the
        shape or dtype changes (``cudaHostAlloc`` is slow)."""
        import torch

        tgt = self._target(k, v)
        buf = self._bufs.get((k, slot))
        if buf is None or tuple(buf.shape) != v.shape or buf.dtype != tgt:
            if buf is not None:
                self._stats.add("pinned_bytes", -buf.nbytes)
            buf = torch.empty(v.shape, dtype=tgt, pin_memory=True)
            self._bufs[(k, slot)] = buf
            self._stats.add("pinned_bytes", buf.nbytes)
        return buf


def _fill(buf, v: np.ndarray):
    """Cast ``v`` into ``buf`` on the host, as ``np.copyto`` does in the
    reference; returns ``buf``."""
    import torch

    if buf.dtype == torch.bfloat16:  # no numpy counterpart: torch casts
        buf.copy_(torch.from_numpy(v if v.flags.writeable else v.copy()))
    else:
        np.copyto(buf.numpy(), v, casting="unsafe")
    return buf


def _prefetch(it: Iterator[Any], n: int, stats: Optional[IngestStats] = None,
              device_depth: bool = False) -> Iterator[Any]:
    """Run ``it`` on a background thread, buffering up to n items.

    Abandonment-safe: the consumer closing the returned generator
    (``break``, GC, a train failure) sets a stop event; the producer
    thread exits its bounded put within ~0.1s, closes the underlying
    iterator (releasing its lookahead window), and dies.  No producer
    thread ever outlives its consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, n))
    stop = threading.Event()
    err: List[BaseException] = []

    def put_checked(item) -> bool:
        if not put_unless_stopped(q, item, stop):
            return False
        if stats is not None and device_depth:
            stats.set_max("device_prefetch_depth", q.qsize())
        return True

    def work():
        try:
            for item in it:
                if not put_checked(item):
                    break
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            try:
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # drops inner stages/window refs on abandon
            except BaseException:  # noqa: BLE001
                pass
            put_checked(_SENTINEL)

    t = threading.Thread(target=work, daemon=True, name="rtpu-data-prefetch")
    t.start()

    def gen():
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = get_live(q, t, what="prefetch producer")
                except ProducerDiedError:
                    if err:
                        raise err[0]  # the producer's own failure wins
                    raise
                if stats is not None:
                    stats.add("consumer_blocked_s",
                              time.perf_counter() - t0)
                if item is _SENTINEL:
                    break
                if stats is not None and device_depth:
                    stats.set("device_batches_in_flight", q.qsize())
                yield item
        finally:
            stop.set()
        if err:
            raise err[0]

    return gen()
