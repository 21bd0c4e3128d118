"""StreamingExecutor: pipelined execution of a physical operator DAG
(counterpart of ``ray_tpu/data/streaming_executor.py``, waiting on the
futures of ``data/_tasks.py``).

Reference: ``python/ray/data/_internal/execution/streaming_executor.py``
(control-thread loop at ``run :267``, per-step scheduling
``_scheduling_loop_step :321``) and ``streaming_executor_state.py``
(``select_operator_to_run``).  Here the loop:

1. moves operator outputs downstream (or to the consumer queue),
2. dispatches queued work on ops that are under their concurrency cap and
   whose output queue is under the byte budget (backpressure),
3. waits on all in-flight task refs with a short timeout and routes
   completions back to their operators.

It runs on a daemon thread; the consumer pulls ``RefBundle``s from a bounded
queue, so a slow consumer backpressures the whole pipeline.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator, List, Optional

from ray_tpu_torch._private.concurrency import (
    ProducerDiedError,
    get_live,
    put_unless_stopped,
)
from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.operators import (
    LimitOperator,
    OutputSplitter,
    PhysicalOperator,
    RefBundle,
)

logger = logging.getLogger(__name__)

_SENTINEL = object()


def topo_order(sink: PhysicalOperator) -> List[PhysicalOperator]:
    seen: Dict[int, PhysicalOperator] = {}
    order: List[PhysicalOperator] = []

    def walk(op: PhysicalOperator):
        if id(op) in seen:
            return
        seen[id(op)] = op
        for i in op.input_ops:
            walk(i)
        order.append(op)

    walk(sink)
    return order


class StreamingExecutor:
    def __init__(self, sink: PhysicalOperator, max_output_queue: int = 8):
        self._sink = sink
        self._ops = topo_order(sink)
        self._downstream: Dict[int, List[PhysicalOperator]] = {id(o): [] for o in self._ops}
        for op in self._ops:
            for parent in op.input_ops:
                self._downstream[id(parent)].append(op)
        self._outq: "queue.Queue" = queue.Queue(maxsize=max_output_queue)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- public ---------------------------------------------------------------

    def run(self) -> Iterator[RefBundle]:
        """Start the control loop; yield output bundles as they materialize."""
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-data-exec")
        self._thread.start()
        truncated = False
        try:
            while True:
                try:
                    # liveness-checked: a control loop that died without
                    # its sentinel must not hang the consumer (_error
                    # stays single-writer: only _loop assigns it)
                    item = get_live(self._outq, self._thread,
                                    what="streaming-executor control loop")
                except ProducerDiedError:
                    truncated = True
                    break
                if item is _SENTINEL:
                    break
                yield item
        finally:
            self.shutdown()
        if self._error is not None:
            raise self._error
        if truncated:
            raise RuntimeError("streaming-executor control loop died "
                               "without its sentinel; output truncated")

    def shutdown(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10)
        for op in self._ops:
            op.shutdown()

    # -- control loop ---------------------------------------------------------

    def _loop(self):
        try:
            for op in self._ops:
                op.start()
            while not self._stop.is_set():
                progressed = self._step()
                if self._all_done():
                    break
                if not progressed:
                    self._wait_for_completions(timeout=0.05)
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            # bounded: an abandoned consumer leaves the queue full and
            # never drains it — a blocking put would leak this thread
            put_unless_stopped(self._outq, _SENTINEL, self._stop)

    def _step(self) -> bool:
        progressed = False
        # 1. propagate inputs-done + move outputs downstream (reverse topo so
        #    the sink drains first, freeing backpressure budget)
        for op in reversed(self._ops):
            down = self._downstream[id(op)]
            while op.has_output():
                bundle = op.take_output()
                progressed = True
                if not down:
                    # blocks => consumer backpressure (poll so shutdown works)
                    while not self._stop.is_set():
                        try:
                            self._outq.put(bundle, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                else:
                    for d in down:
                        self._route(op, d, bundle)
            if op.completed():
                for d in down:
                    if all(p.completed() for p in d.input_ops):
                        if not d._inputs_done:
                            d.inputs_done()
                            progressed = True
        # 2. early stop: a downstream Limit reached its target
        self._propagate_limit_stop()
        # 3. dispatch work: ONE task per selection, priorities
        #    re-evaluated after each dispatch (reference
        #    streaming_executor_state.select_operator_to_run) — without
        #    this, a cheap upstream map dispatched to its cap floods the
        #    pipeline while an expensive actor-pool stage starves.
        if self._dispatch_round():
            progressed = True
        return progressed

    def _dispatch_round(self) -> bool:
        """Dispatch until no operator can make progress.  Selection
        policy: the runnable operator with the smallest output-queue
        footprint (then fewest in-flight tasks) goes first, equalizing
        memory across stages.  ``DataContext.select_operator_fn`` (if
        set) overrides the ranking — the reference's pluggable
        backpressure-policy seam."""
        ctx = DataContext.get_current()
        select = getattr(ctx, "select_operator_fn", None)
        progressed = False
        while True:
            candidates = [op for op in self._ops
                          if getattr(op, "dispatch", None) is not None]
            if select is not None:
                candidates = select(candidates)
            else:
                candidates = sorted(
                    candidates,
                    key=lambda o: (o.output_queue_bytes(),
                                   o.num_active_tasks()))
            for op in candidates:
                if op.dispatch():
                    progressed = True
                    break  # re-rank: this dispatch changed the picture
            else:
                return progressed

    def _route(self, parent: PhysicalOperator, child: PhysicalOperator,
               bundle: RefBundle):
        if hasattr(child, "add_input_from"):  # two-sided ops (Zip)
            side = child.input_ops.index(parent)
            child.add_input_from(side, bundle)
        else:
            child.add_input(bundle)

    def _propagate_limit_stop(self):
        """When a Limit is satisfied, mark all upstream ops done so the
        pipeline stops launching reads (streaming early-exit)."""
        for op in self._ops:
            if isinstance(op, LimitOperator) and op.reached_limit():
                for upstream in topo_order(op)[:-1]:
                    upstream._inputs_done = True
                    q = getattr(upstream, "_queue", None)
                    if q is not None:
                        q.clear()

    def _wait_for_completions(self, timeout: float):
        ref_to_op: Dict = {}
        for op in self._ops:
            for r in op.active_task_refs():
                ref_to_op[r] = op
        if not ref_to_op:
            # nothing in flight; consumer may be slow — yield briefly
            self._stop.wait(timeout)
            return
        ready, _ = _tasks.wait(list(ref_to_op.keys()), num_returns=1,
                               timeout=timeout)
        for r in ready:
            ref_to_op[r].notify_task_done(r)

    def _all_done(self) -> bool:
        return all(op.completed() for op in self._ops)


def execute_to_bundles(sink: PhysicalOperator) -> List[RefBundle]:
    """Run the pipeline to completion and return all output bundles."""
    return list(StreamingExecutor(sink).run())


def execute_streaming_split(sink: PhysicalOperator, n: int,
                            equal: bool = False):
    """Run with an OutputSplitter sink feeding n consumer queues.

    Returns the queues, the splitter (for its ``split_stats``) and the
    executor, whose ``shutdown`` stops the pump.  A failed execution puts
    its error in every queue before the end sentinel."""
    splitter = OutputSplitter(sink, n, equal)
    ex = StreamingExecutor(splitter)
    queues: List[queue.Queue] = [queue.Queue() for _ in range(n)]

    def pump():
        err: Optional[BaseException] = None
        try:
            for op in ex._ops:
                op.start()
            while not ex._stop.is_set():
                progressed = ex._step()
                for i in range(n):
                    while splitter.queues[i]:
                        queues[i].put(splitter.queues[i].popleft())
                        progressed = True
                if ex._all_done():
                    break
                if not progressed:
                    ex._wait_for_completions(timeout=0.05)
        except BaseException as e:
            ex._error = err = e
        finally:
            for op in ex._ops:
                op.shutdown()
            for i, q in enumerate(queues):
                # bundles the splitter released before the error precede
                # it: the step that raised may have routed them
                while splitter.queues[i]:
                    q.put(splitter.queues[i].popleft())
                # a failed execution must not look like clean end-of-stream:
                # consumers re-raise the error instead of ending iteration
                if err is not None:
                    q.put(err)
                q.put(_SENTINEL)

    ex._thread = threading.Thread(target=pump, daemon=True,
                                  name="rtpu-data-split")
    ex._thread.start()
    return queues, splitter, ex
