"""Physical operators for the streaming executor (counterpart of
``ray_tpu/data/operators.py``).

Reference: ``python/ray/data/_internal/execution/operators/`` —
``TaskPoolMapOperator``, ``ActorPoolMapOperator``, ``AllToAllOperator``,
``LimitOperator``, ``UnionOperator``, ``ZipOperator``, ``OutputSplitter``.

An operator consumes/produces ``RefBundle``s (block refs + metadata, no data).
The executor drives it: ``add_input`` → (internal task submission) →
``notify_task_done`` on completed task refs → ``take_outputs``.

Port differences: task refs are the in-process futures of
``data/_tasks.py``; a failed map task surfaces at its position in the
stream (every earlier bundle is emitted first); the hash join and the
OutputSplitter's locality routing wait (``JoinOperator``; one node).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data import transforms as T
from ray_tpu_torch.data._tasks import ObjectRef
from ray_tpu_torch.data.block import BlockMetadata
from ray_tpu_torch.data.context import DataContext


@dataclass
class RefBundle:
    blocks: List[Tuple[ObjectRef, BlockMetadata]]
    # Sequence number for order preservation through map stages.
    seq: int = -1

    def num_rows(self) -> int:
        return sum(m.num_rows for _, m in self.blocks)

    def size_bytes(self) -> int:
        return sum(m.size_bytes for _, m in self.blocks)

    def refs(self) -> List[ObjectRef]:
        return [r for r, _ in self.blocks]


@dataclass
class ActorPoolStrategy:
    """compute= argument for map_batches (reference ``ray.data.ActorPoolStrategy``)."""

    size: int = 2
    max_tasks_in_flight_per_actor: int = 2


@dataclass
class _Failed:
    """A failed task's place in an operator's output: taking it raises."""

    error: BaseException


class PhysicalOperator:
    def __init__(self, name: str, input_ops: List["PhysicalOperator"]):
        self.name = name
        self.input_ops = input_ops
        self._inputs_done = False
        self._out: Deque[RefBundle] = collections.deque()
        self._out_bytes = 0
        self.rows_out = 0

    # -- executor-facing ------------------------------------------------------

    def start(self):
        pass

    def add_input(self, bundle: RefBundle) -> None:
        raise NotImplementedError

    def inputs_done(self) -> None:
        self._inputs_done = True

    def active_task_refs(self) -> List[ObjectRef]:
        return []

    def notify_task_done(self, ref: ObjectRef) -> None:
        pass

    def has_output(self) -> bool:
        return bool(self._out)

    def take_output(self) -> RefBundle:
        b = self._out.popleft()
        if isinstance(b, _Failed):
            raise b.error
        self._out_bytes -= b.size_bytes()
        return b

    def completed(self) -> bool:
        return self._inputs_done and not self._out and not self.active_task_refs()

    def shutdown(self):
        pass

    # -- backpressure signals -------------------------------------------------

    def num_active_tasks(self) -> int:
        return len(self.active_task_refs())

    def output_queue_bytes(self) -> int:
        return self._out_bytes

    def can_accept_input(self) -> bool:
        ctx = DataContext.get_current()
        return (self.num_active_tasks() < ctx.max_tasks_in_flight_per_op
                and self._out_bytes < ctx.max_op_output_queue_bytes)

    def _emit(self, bundle: RefBundle):
        self._out.append(bundle)
        self._out_bytes += bundle.size_bytes()
        self.rows_out += bundle.num_rows()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class InputDataBuffer(PhysicalOperator):
    """Source operator: a fixed list of bundles (read tasks are modeled as a
    MapOperator downstream of this, whose "blocks" are the ReadTask payloads)."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__("Input", [])
        for i, b in enumerate(bundles):
            b.seq = i
            self._emit(b)
        self._inputs_done = True

    def add_input(self, bundle: RefBundle):
        raise RuntimeError("InputDataBuffer has no upstream")


class _OrderedReleaser:
    """Reorders finished bundles back to input sequence when preserve_order;
    a failure is released at its own sequence number."""

    def __init__(self, preserve_order: bool, emit: Callable[[Any], None]):
        self._preserve = preserve_order
        self._emit = emit
        self._next = 0
        self._pending: Dict[int, RefBundle] = {}

    def release(self, seq: int, bundle: RefBundle):
        if not self._preserve:
            self._emit(bundle)
            return
        self._pending[seq] = bundle
        while self._next in self._pending:
            self._emit(self._pending.pop(self._next))
            self._next += 1

    def fail(self, seq: int, error: BaseException):
        """The task of ``seq`` failed: every earlier bundle goes out first."""
        self.release(seq, _Failed(error))


class MapOperator(PhysicalOperator):
    """Task-pool map: one task per input bundle applying a MapChain.

    Also runs Read stages: the bundle then carries ReadTask objects instead of
    block refs (``is_read=True``), handed to ``run_read_task``.
    """

    def __init__(self, name: str, input_op: PhysicalOperator, chain: T.MapChain,
                 is_read: bool = False, read_tasks: Optional[List] = None,
                 preserve_order: Optional[bool] = None):
        super().__init__(name, [input_op] if input_op else [])
        self._chain = chain
        self._is_read = is_read
        self._read_tasks = read_tasks or []
        self._queue: Deque[RefBundle] = collections.deque()
        self._active: Dict[ObjectRef, int] = {}  # result ref -> seq
        if preserve_order is None:
            preserve_order = DataContext.get_current().execution_options.preserve_order
        self._preserve_order = preserve_order
        self._releaser = _OrderedReleaser(preserve_order, self._emit_or_skip)
        self._seq_counter = 0
        # streaming reads (generator tasks): blocks surface incrementally
        # instead of after the whole ReadTask finishes.  Drainer threads
        # append to _out (GIL-atomic deque ops); counters/errors below are
        # their thread-safe handoff to the executor's control thread.
        self._streaming_active = 0
        self._streaming_lock = threading.Lock()
        self._stream_error: Optional[BaseException] = None

    def _emit_or_skip(self, bundle):
        if isinstance(bundle, _Failed):
            self._out.append(bundle)
        elif bundle.blocks:
            self._emit(bundle)

    def add_input(self, bundle: RefBundle):
        bundle.seq = self._seq_counter
        self._seq_counter += 1
        self._queue.append(bundle)

    def dispatch(self) -> bool:
        """Submit one queued task if under limits.  Returns True if submitted."""
        if not self._queue or not self.can_accept_input():
            return False
        bundle = self._queue.popleft()
        if self._is_read:
            read_task = self._read_tasks[bundle.blocks[0][0]]  # ref slot holds index
            if self._streaming_read_ok():
                gen = T.run_read_task_streaming.remote(read_task)
                with self._streaming_lock:
                    self._streaming_active += 1
                threading.Thread(
                    target=self._drain_stream, args=(gen, bundle.seq),
                    daemon=True,
                    name=f"data-stream-{self.name}-{bundle.seq}").start()
                return True
            ref = T.run_read_task.remote(read_task, self._chain)
        else:
            ref = T.run_map_task.remote(self._chain, *bundle.refs())
        self._active[ref] = bundle.seq
        return True

    def _streaming_read_ok(self) -> bool:
        """Streaming reads apply when per-block order across tasks doesn't
        have to be reconstructed and no fused chain forces whole-task
        materialization (reference: Data built on streaming generators)."""
        return (not self._preserve_order
                and not (self._chain and self._chain.steps))

    def _drain_stream(self, gen, seq: int):
        """Consume one streaming read task, emitting a single-block bundle
        per yielded item as it lands (runs on its own thread)."""
        try:
            for item_ref in gen:
                block_ref, meta = _tasks.get(item_ref)
                self._out.append(RefBundle([(block_ref, meta)], seq=seq))
        except BaseException as e:  # noqa: BLE001
            self._stream_error = e
        finally:
            with self._streaming_lock:
                self._streaming_active -= 1

    def active_task_refs(self) -> List[ObjectRef]:
        return list(self._active.keys())

    def notify_task_done(self, ref: ObjectRef):
        seq = self._active.pop(ref)
        try:
            block_refs, metas = _tasks.get(ref)
        except Exception as e:  # noqa: BLE001 — surfaces at its position
            self._releaser.fail(seq, e)
            return
        self._releaser.release(seq, RefBundle(list(zip(block_refs, metas)), seq=seq))

    def has_output(self) -> bool:
        if self._stream_error is not None:
            err, self._stream_error = self._stream_error, None
            raise err
        return bool(self._out)

    def num_active_tasks(self) -> int:
        return len(self._active) + self._streaming_active

    def completed(self) -> bool:
        return (self._inputs_done and not self._queue and not self._active
                and self._streaming_active == 0 and not self._out)


class ActorPoolMapOperator(MapOperator):
    """Map over a fixed pool of MapWorker actors (stateful callables), each
    on a thread of its own."""

    def __init__(self, name: str, input_op: PhysicalOperator, chain: T.MapChain,
                 strategy: ActorPoolStrategy,
                 preserve_order: Optional[bool] = None):
        super().__init__(name, input_op, chain, preserve_order=preserve_order)
        self._strategy = strategy
        self._actors: List[Any] = []
        self._actor_load: Dict[int, int] = {}
        self._active_actor: Dict[ObjectRef, int] = {}

    def start(self):
        for i in range(self._strategy.size):
            self._actors.append(T.MapWorker.remote())
            self._actor_load[i] = 0

    def dispatch(self) -> bool:
        if not self._queue:
            return False
        # least-loaded actor with spare in-flight budget
        idx = min(self._actor_load, key=self._actor_load.get)
        if self._actor_load[idx] >= self._strategy.max_tasks_in_flight_per_actor:
            return False
        if not self.can_accept_input():
            return False
        bundle = self._queue.popleft()
        ref = self._actors[idx].run.remote(self._chain, *bundle.refs())
        self._active[ref] = bundle.seq
        self._active_actor[ref] = idx
        self._actor_load[idx] += 1
        return True

    def notify_task_done(self, ref: ObjectRef):
        idx = self._active_actor.pop(ref)
        self._actor_load[idx] -= 1
        super().notify_task_done(ref)

    def shutdown(self):
        for a in self._actors:
            _tasks.kill(a)
        self._actors.clear()


class AllToAllOperator(PhysicalOperator):
    """Barrier op: buffers all input, then runs a two-phase shuffle plan.

    ``plan_fn(input_bundles) -> phase list``; each phase is a list of
    (submit_fn, downstream_slot) lambdas producing result refs.  Concretely we
    model the common pattern: phase 1 fans out per-input tasks, phase 2 merges
    per output partition.
    """

    def __init__(self, name: str, input_op: PhysicalOperator,
                 plan_fn: Callable[[List[RefBundle]], "ShufflePlan"]):
        super().__init__(name, [input_op])
        self._plan_fn = plan_fn
        self._buffer: List[RefBundle] = []
        self._phase_refs: Dict[ObjectRef, int] = {}
        self._phase_results: Dict[int, Any] = {}
        self._plan: Optional[ShufflePlan] = None
        self._started = False

    def add_input(self, bundle: RefBundle):
        self._buffer.append(bundle)

    def dispatch(self) -> bool:
        if not self._inputs_done or self._started:
            return False
        self._started = True
        self._plan = self._plan_fn(self._buffer)
        self._launch_current_phase()
        return True

    def _launch_current_phase(self):
        refs = self._plan.launch_phase(self._phase_results)
        if refs is None:
            # done: plan emitted final bundles
            for b in self._plan.final_bundles:
                self._emit(b)
            return
        self._phase_refs = {r: i for i, r in enumerate(refs)}
        self._phase_results = {}

    def active_task_refs(self) -> List[ObjectRef]:
        return list(self._phase_refs.keys())

    def notify_task_done(self, ref: ObjectRef):
        i = self._phase_refs.pop(ref)
        self._phase_results[i] = _tasks.get(ref)
        if not self._phase_refs:
            self._launch_current_phase()

    def completed(self) -> bool:
        return (self._inputs_done and self._started and not self._phase_refs
                and self._plan is not None and self._plan.done and not self._out)


class ShufflePlan:
    """State machine for a multi-phase shuffle inside AllToAllOperator."""

    def __init__(self, phases: List[Callable[[Dict[int, Any]], Optional[List[ObjectRef]]]],
                 finalize: Callable[[Dict[int, Any]], List[RefBundle]]):
        self._phases = list(phases)
        self._finalize = finalize
        self.final_bundles: List[RefBundle] = []
        self.done = False

    def launch_phase(self, prev_results: Dict[int, Any]) -> Optional[List[ObjectRef]]:
        if self._phases:
            phase = self._phases.pop(0)
            refs = phase(prev_results)
            if refs:
                return refs
            # phase produced nothing to wait on; fall through to next
            return self.launch_phase({})
        self.final_bundles = self._finalize(prev_results)
        self.done = True
        return None


class LimitOperator(PhysicalOperator):
    """Truncate the stream after N rows (slicing the boundary block)."""

    def __init__(self, input_op: PhysicalOperator, limit: int):
        super().__init__(f"Limit({limit})", [input_op])
        self._remaining = limit
        self._active: Dict[ObjectRef, None] = {}

    def add_input(self, bundle: RefBundle):
        if self._remaining <= 0:
            return
        rows = bundle.num_rows()
        if rows <= self._remaining:
            self._remaining -= rows
            self._emit(bundle)
            return
        # need to cut within this bundle
        keep: List[Tuple[ObjectRef, BlockMetadata]] = []
        for ref, meta in bundle.blocks:
            if self._remaining <= 0:
                break
            if meta.num_rows <= self._remaining:
                keep.append((ref, meta))
                self._remaining -= meta.num_rows
            else:
                r = T.slice_block.remote(ref, 0, self._remaining)
                self._active[r] = None
                self._remaining = 0
        if keep:
            self._emit(RefBundle(keep))

    def active_task_refs(self) -> List[ObjectRef]:
        return list(self._active.keys())

    def notify_task_done(self, ref: ObjectRef):
        self._active.pop(ref)
        block_refs, metas = _tasks.get(ref)
        self._emit(RefBundle(list(zip(block_refs, metas))))

    def reached_limit(self) -> bool:
        return self._remaining <= 0 and not self._active

    def completed(self) -> bool:
        return ((self._inputs_done or self.reached_limit())
                and not self._active and not self._out)


class UnionOperator(PhysicalOperator):
    def __init__(self, input_ops: List[PhysicalOperator]):
        super().__init__("Union", input_ops)

    def add_input(self, bundle: RefBundle):
        self._emit(bundle)


class ZipOperator(PhysicalOperator):
    """Materialize both sides, align row ranges, zip columns block-wise."""

    def __init__(self, left: PhysicalOperator, right: PhysicalOperator):
        super().__init__("Zip", [left, right])
        self._sides: Dict[int, List[RefBundle]] = {0: [], 1: []}
        self._done_sides = 0
        self._active: Dict[ObjectRef, None] = {}
        self._launched = False

    def add_input_from(self, side: int, bundle: RefBundle):
        self._sides[side].append(bundle)

    def add_input(self, bundle: RefBundle):  # pragma: no cover - executor uses _from
        raise RuntimeError("ZipOperator needs side-tagged input")

    def dispatch(self) -> bool:
        if not self._inputs_done or self._launched:
            return False
        self._launched = True
        left = [b for bun in self._sides[0] for b in bun.blocks]
        right = [b for bun in self._sides[1] for b in bun.blocks]
        lrows = sum(m.num_rows for _, m in left)
        rrows = sum(m.num_rows for _, m in right)
        if lrows != rrows:
            raise ValueError(f"zip: row counts differ ({lrows} vs {rrows})")
        # Repartition right to match left's block row boundaries.
        boundaries = np.cumsum([m.num_rows for _, m in left])
        right_realigned = _realign(right, boundaries)
        for (lref, _), rref in zip(left, right_realigned):
            self._active[T.zip_blocks.remote(lref, rref)] = None
        return True

    def active_task_refs(self) -> List[ObjectRef]:
        return list(self._active.keys())

    def notify_task_done(self, ref: ObjectRef):
        self._active.pop(ref)
        block_refs, metas = _tasks.get(ref)
        self._emit(RefBundle(list(zip(block_refs, metas))))

    def completed(self) -> bool:
        return self._inputs_done and self._launched and not self._active and not self._out


def _realign(blocks: List[Tuple[ObjectRef, BlockMetadata]],
             boundaries: np.ndarray) -> List[ObjectRef]:
    """Slice-and-merge right-side blocks to the given cumulative row bounds."""
    pieces_per_out: List[List[ObjectRef]] = [[] for _ in boundaries]
    pos = 0
    bi = 0
    for ref, meta in blocks:
        off = 0
        while off < meta.num_rows:
            while bi < len(boundaries) and pos >= boundaries[bi]:
                bi += 1
            take = int(min(meta.num_rows - off,
                           (boundaries[bi] if bi < len(boundaries) else pos + meta.num_rows) - pos))
            sub_refs, _ = _tasks.get(T.slice_block.remote(ref, off, off + take))
            pieces_per_out[bi].append(sub_refs[0])
            off += take
            pos += take
    out = []
    for pieces in pieces_per_out:
        if len(pieces) == 1:
            out.append(pieces[0])
        else:
            refs, _ = _tasks.get(T.merge_blocks.remote(*pieces))
            out.append(refs[0])
    return out


class OutputSplitter(PhysicalOperator):
    """Split the stream into n consumer sub-streams (streaming_split).

    Reference: ``execution/operators/output_splitter.py``.  Each bundle
    goes to the consumer with the fewest rows so far (the reference's
    locality-free equalization, also under ``equal=``).  The reference's
    locality routing waits: the port runs on one node, where every
    consumer is co-located.
    """

    def __init__(self, input_op: PhysicalOperator, n: int, equal: bool = False):
        super().__init__(f"OutputSplitter({n})", [input_op])
        self.n = n
        self._equal = equal
        self.queues: List[Deque[RefBundle]] = [collections.deque() for _ in range(n)]
        self._rows: List[int] = [0] * n

    def add_input(self, bundle: RefBundle):
        target = int(np.argmin(self._rows))
        self.queues[target].append(bundle)
        self._rows[target] += bundle.num_rows()
        self.rows_out += bundle.num_rows()

    def split_stats(self) -> Dict[str, Any]:
        return {"rows_per_output": list(self._rows)}

    def has_output(self) -> bool:
        return False

    def completed(self) -> bool:
        return self._inputs_done
