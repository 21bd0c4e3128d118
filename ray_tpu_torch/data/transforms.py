"""Block transform functions run as data tasks (counterpart of
``ray_tpu/data/transforms.py``).

The unit handed to a task is a ``MapChain``: the (possibly fused)
sequence of row/batch transforms one task applies to one input block.
Output blocks are ``put()`` and only their refs + metadata travel back
(``data/_tasks.py``: here the refs are in-process futures).

Reference: ``python/ray/data/_internal/execution/operators/map_transformer.py``
(MapTransformer and its Row/Batch transform fns).  The sort, groupby and
join task fns (``transforms.py:202-311``) wait for their numpy ports.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockBuilder,
    BlockMetadata,
    concat_blocks,
    num_rows,
)


@dataclass
class MapStep:
    kind: str  # "batches" | "rows" | "flat" | "filter"
    fn: Any  # function, or a class to instantiate (stateful callable)
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    batch_size: Optional[int] = None
    batch_format: str = "numpy"


@dataclass
class MapChain:
    steps: List[MapStep]
    target_max_block_size: int = 128 * 1024 * 1024


def _resolve_fn(step: MapStep, cache: Optional[Dict[int, Any]] = None) -> Callable:
    """Instantiate callable classes (once per actor when a cache is given)."""
    fn = step.fn
    if isinstance(fn, type):
        key = id(fn)
        if cache is not None and key in cache:
            return cache[key]
        inst = fn(*step.fn_args, **step.fn_kwargs)
        if cache is not None:
            cache[key] = inst
        return inst
    return fn


def _iter_batches(block: Block, batch_size: Optional[int],
                  batch_format: str) -> Iterator[Any]:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if batch_size is None or batch_size >= n:
        if n:
            yield acc.to_batch(batch_format)
        return
    for start in range(0, n, batch_size):
        yield BlockAccessor(acc.slice(start, min(start + batch_size, n))
                            ).to_batch(batch_format)


def apply_chain(blocks: List[Block], chain: MapChain,
                fn_cache: Optional[Dict[int, Any]] = None) -> Iterator[Block]:
    """Apply every step to the input blocks, yielding output blocks split at
    the target block size."""
    tables = blocks
    for step in chain.steps:
        fn = _resolve_fn(step, fn_cache)
        out = BlockBuilder(chain.target_max_block_size)
        produced: List[Block] = []
        for block in tables:
            if step.kind == "batches":
                for batch in _iter_batches(block, step.batch_size, step.batch_format):
                    args, kwargs = ((), {}) if isinstance(step.fn, type) else (
                        step.fn_args, step.fn_kwargs)
                    res = fn(batch, *args, **kwargs)
                    if res is None:
                        continue
                    out.add_batch(res)
                    if out.should_flush():
                        produced.append(out.build())
            elif step.kind == "rows":
                for row in BlockAccessor(block).iter_rows():
                    out.add_row(fn(row))
            elif step.kind == "flat":
                for row in BlockAccessor(block).iter_rows():
                    for r in fn(row):
                        out.add_row(r)
            elif step.kind == "filter":
                for row in BlockAccessor(block).iter_rows():
                    if fn(row):
                        out.add_row(row)
            else:
                raise ValueError(f"unknown map kind {step.kind!r}")
        if out.num_rows() or not produced:
            produced.append(out.build())
        tables = produced
    yield from tables


def _finalize(blocks: Iterator[Block], t0: float,
              input_files: Optional[List[str]] = None):
    """Put output blocks, return ([ref...], [meta...]) — the small task reply."""
    refs, metas = [], []
    for b in blocks:
        refs.append(_tasks.put(b))
        metas.append(BlockMetadata.for_block(b, input_files=input_files,
                                             start_time=t0))
    return refs, metas


@_tasks.remote
def run_map_task(chain: MapChain, *blocks: Block):
    """Task-pool map: apply the chain to the input blocks."""
    t0 = time.perf_counter()
    return _finalize(apply_chain(list(blocks), chain), t0)


@_tasks.remote
def run_read_task(read_task, chain: Optional[MapChain]):
    """Execute a datasource ReadTask (+ optionally a fused downstream chain)."""
    t0 = time.perf_counter()
    blocks = list(read_task())
    if chain is not None and chain.steps:
        blocks = apply_chain(blocks, chain)
    return _finalize(blocks, t0, input_files=read_task.metadata.input_files)


@_tasks.remote(num_returns="streaming")
def run_read_task_streaming(read_task):
    """Streaming read: each produced block is announced to the consumer the
    moment it exists instead of after the whole ReadTask finishes.
    Yields ``(block_ref, metadata)`` per block."""
    t0 = time.perf_counter()
    for b in read_task():
        yield (_tasks.put(b),
               BlockMetadata.for_block(
                   b, input_files=read_task.metadata.input_files,
                   start_time=t0))


@_tasks.remote
class MapWorker:
    """Actor-pool map worker: caches stateful callables across calls.

    Reference: ``_MapWorker`` in
    ``python/ray/data/_internal/execution/operators/actor_pool_map_operator.py``.
    """

    def __init__(self):
        self._fn_cache: Dict[int, Any] = {}

    def run(self, chain: MapChain, *blocks: Block):
        t0 = time.perf_counter()
        return _finalize(apply_chain(list(blocks), chain, self._fn_cache), t0)


# -- shuffle-family task fns -------------------------------------------------


@_tasks.remote
def split_block(block: Block, num_splits: int, seed_or_none):
    """Map side of random_shuffle/repartition(shuffle=True): permute rows and
    deal them into ``num_splits`` parts."""
    t0 = time.perf_counter()
    acc = BlockAccessor(block)
    rng = np.random.default_rng(seed_or_none)
    parts = np.array_split(rng.permutation(acc.num_rows()), num_splits)
    return _finalize((acc.take_rows(p) for p in parts), t0)


@_tasks.remote
def merge_blocks(*blocks: Block):
    """Reduce side: concatenate parts into one output block."""
    t0 = time.perf_counter()
    return _finalize(iter([concat_blocks(list(blocks))]), t0)


@_tasks.remote
def slice_block(block: Block, start: int, end: int):
    t0 = time.perf_counter()
    return _finalize(iter([BlockAccessor(block).slice(start, end)]), t0)


@_tasks.remote
def zip_blocks(left: Block, right: Block):
    t0 = time.perf_counter()
    if num_rows(left) != num_rows(right):
        raise ValueError(f"zip: block row counts differ ({num_rows(left)} "
                         f"vs {num_rows(right)})")
    cols = dict(left)
    for name, col in right.items():
        cols[name if name not in cols else f"{name}_1"] = col
    return _finalize(iter([cols]), t0)
