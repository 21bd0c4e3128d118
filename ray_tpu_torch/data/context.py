"""DataContext: per-process execution configuration for the data plane
(counterpart of ``ray_tpu/data/context.py``, with the fields of it that
the port reads, and their defaults).

Reference: ``python/ray/data/context.py`` (``DataContext.get_current``) and
``ExecutionOptions`` in
``python/ray/data/_internal/execution/interfaces/execution_options.py``.

Not ported, because nothing here would honour them yet: the resource
budget (``ExecutionResources`` through ``resource_limits``),
``verbose_progress``, ``target_min_block_size`` and the locality split's
``locality_split_max_skew_rows``.  One field is the port's own:
``task_pool_size``, the threads of the pool that runs the data tasks
(``data/_tasks.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class ExecutionOptions:
    # Unlike the reference (default False), block order is preserved by
    # default so take()/iteration are deterministic; disable for max overlap.
    preserve_order: bool = True


@dataclass
class DataContext:
    """Global knobs, mirroring the reference's DataContext defaults."""

    target_max_block_size: int = 128 * 1024 * 1024
    read_op_min_num_blocks: int = 8
    # Streaming executor backpressure: max in-flight task outputs queued per
    # operator before we stop dispatching new tasks for it.
    max_tasks_in_flight_per_op: int = 16
    # Per-op max queued output bytes before upstream dispatch pauses
    # (StreamingOutputBackpressurePolicy equivalent).
    max_op_output_queue_bytes: int = 512 * 1024 * 1024
    # Fuse compatible map operators into one task (operator fusion rule).
    enable_operator_fusion: bool = True
    execution_options: ExecutionOptions = field(default_factory=ExecutionOptions)
    # Optional operator-selection policy for the streaming executor's
    # dispatch loop: fn(candidate_ops) -> ops in dispatch-priority order.
    # None = default smallest-output-queue-first ranking (reference:
    # streaming_executor_state.select_operator_to_run + the pluggable
    # backpressure_policy/ seam).
    select_operator_fn: Optional[Callable] = None
    # iter_batches defaults
    default_batch_format: str = "numpy"
    prefetch_batches: int = 2
    # -- ingest pipeline (DataIterator) ---------------------------------------
    # Block-prefetch lookahead: the iterator keeps a sliding window of
    # upcoming blocks admitted ahead of batching, sized in bytes with a
    # block-count cap; 0 bytes disables the lookahead (forced-serial: one
    # blocking get per block).
    iterator_lookahead_bytes: int = 64 * 1024 * 1024
    iterator_lookahead_max_blocks: int = 16
    # Threads of the shared pool that runs the data tasks (None: the
    # host's CPU count), read when the pool is first made.
    task_pool_size: Optional[int] = None

    _current: "DataContext" = None  # class-level singleton
    _lock = threading.Lock()

    @staticmethod
    def get_current() -> "DataContext":
        with DataContext._lock:
            if DataContext._current is None:
                DataContext._current = DataContext()
            return DataContext._current
