"""Planner: logical plan → physical operator DAG + shuffle plans
(counterpart of ``ray_tpu/data/planner.py``; the sort, aggregate and join
plans wait with their logical nodes).

Reference: ``python/ray/data/_internal/planner/planner.py`` (plan_* functions
per logical op) and the shuffle implementations under
``_internal/planner/exchange/``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data import transforms as T
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.operators import (
    ActorPoolMapOperator,
    ActorPoolStrategy,
    AllToAllOperator,
    InputDataBuffer,
    LimitOperator,
    MapOperator,
    PhysicalOperator,
    RefBundle,
    ShufflePlan,
    UnionOperator,
    ZipOperator,
)


def _steps_for(op: L.AbstractMap) -> List[T.MapStep]:
    ops = op.chain if isinstance(op, L.FusedMap) else [op]
    return [T.MapStep(kind=o.kind, fn=o.fn, fn_args=o.fn_args,
                      fn_kwargs=o.fn_kwargs, batch_size=o.batch_size,
                      batch_format=o.batch_format) for o in ops]


def _chain_for(op: Optional[L.AbstractMap]) -> T.MapChain:
    ctx = DataContext.get_current()
    return T.MapChain(steps=_steps_for(op) if op else [],
                      target_max_block_size=ctx.target_max_block_size)


def plan(dag: L.LogicalOperator) -> PhysicalOperator:
    ctx = DataContext.get_current()

    if isinstance(dag, L.Read):
        parallelism = dag.parallelism
        if parallelism < 0:
            est = dag.datasource.estimate_inmemory_data_size() or 0
            parallelism = max(ctx.read_op_min_num_blocks,
                              math.ceil(est / ctx.target_max_block_size))
        read_tasks = dag.datasource.get_read_tasks(parallelism)
        bundles = [RefBundle([(i, rt.metadata)]) for i, rt in enumerate(read_tasks)]
        src = InputDataBuffer(bundles)
        op = MapOperator(dag.name, src, _chain_for(None), is_read=True,
                         read_tasks=read_tasks)
        op.input_ops = [src]
        return op

    if isinstance(dag, L.InputData):
        return InputDataBuffer(dag.ref_bundles)

    if isinstance(dag, L.AbstractMap):
        upstream = plan(dag.inputs[0])
        # Fuse a map chain directly into an upstream Read (read fusion).
        if (isinstance(upstream, MapOperator) and upstream._is_read
                and not isinstance(upstream, ActorPoolMapOperator)
                and upstream._chain.steps == [] and dag.compute is None):
            upstream._chain = _chain_for(dag)
            upstream.name = f"{upstream.name}->{dag.name}"
            return upstream
        if isinstance(dag.compute, ActorPoolStrategy):
            return ActorPoolMapOperator(dag.name, upstream, _chain_for(dag),
                                        dag.compute)
        return MapOperator(dag.name, upstream, _chain_for(dag))

    if isinstance(dag, L.Repartition):
        upstream = plan(dag.inputs[0])
        n = dag.num_outputs
        if dag.shuffle:
            return AllToAllOperator(dag.name, upstream,
                                    lambda bundles: _shuffle_plan(bundles, n, None))
        return AllToAllOperator(dag.name, upstream,
                                lambda bundles: _repartition_plan(bundles, n))

    if isinstance(dag, L.RandomShuffle):
        upstream = plan(dag.inputs[0])
        return AllToAllOperator(
            dag.name, upstream,
            lambda bundles: _shuffle_plan(
                bundles, dag.num_outputs or max(1, len(bundles)), dag.seed))

    if isinstance(dag, L.RandomizeBlocks):
        upstream = plan(dag.inputs[0])
        return AllToAllOperator(dag.name, upstream,
                                lambda bundles: _randomize_blocks_plan(bundles, dag.seed))

    if isinstance(dag, L.Limit):
        return LimitOperator(plan(dag.inputs[0]), dag.limit)

    if isinstance(dag, L.Union):
        return UnionOperator([plan(i) for i in dag.inputs])

    if isinstance(dag, L.Zip):
        return ZipOperator(plan(dag.inputs[0]), plan(dag.inputs[1]))

    raise NotImplementedError(f"no physical plan for {dag!r}")


# -- shuffle plans -----------------------------------------------------------


def _flatten(bundles: List[RefBundle]):
    return [b for bun in bundles for b in bun.blocks]


def _repartition_plan(bundles: List[RefBundle], n: int) -> ShufflePlan:
    """Split-then-merge repartition without a random shuffle (row-balanced)."""
    blocks = _flatten(bundles)
    total = sum(m.num_rows for _, m in blocks)
    target = [total // n + (1 if i < total % n else 0) for i in range(n)]

    def phase_split(_):
        # slice each input block at the output-partition boundaries
        refs = []
        self_assign = []
        pos = 0
        bounds = np.cumsum(target)
        for ref, meta in blocks:
            off = 0
            while off < meta.num_rows:
                out_idx = int(np.searchsorted(bounds, pos, side="right"))
                end_of_part = int(bounds[out_idx])
                take = min(meta.num_rows - off, end_of_part - pos)
                refs.append(T.slice_block.remote(ref, off, off + take))
                self_assign.append(out_idx)
                off += take
                pos += take
        plan.assign = self_assign  # stash on the fn object
        return refs

    def phase_merge(results: Dict[int, Tuple]):
        parts: List[List] = [[] for _ in range(n)]
        for i, (block_refs, _metas) in sorted(results.items()):
            parts[plan.assign[i]].extend(block_refs)
        return [T.merge_blocks.remote(*p) for p in parts if True]

    def finalize(results):
        out = []
        for i in sorted(results):
            block_refs, metas = results[i]
            out.append(RefBundle(list(zip(block_refs, metas)), seq=i))
        return out

    plan = ShufflePlan([phase_split, phase_merge], finalize)
    return plan


def _shuffle_plan(bundles: List[RefBundle], n: int, seed) -> ShufflePlan:
    """Random shuffle: permute-split map phase, concat reduce phase."""
    blocks = _flatten(bundles)
    if not blocks:
        return ShufflePlan([], lambda _: [])

    def phase_split(_):
        return [T.split_block.remote(ref, n, None if seed is None else seed + i)
                for i, (ref, _m) in enumerate(blocks)]

    def phase_merge(results: Dict[int, Tuple]):
        merges = []
        for p in range(n):
            parts = [results[i][0][p] for i in sorted(results)]
            merges.append(T.merge_blocks.remote(*parts))
        return merges

    def finalize(results):
        out = []
        for i in sorted(results):
            block_refs, metas = results[i]
            out.append(RefBundle(list(zip(block_refs, metas)), seq=i))
        return out

    return ShufflePlan([phase_split, phase_merge], finalize)


def _randomize_blocks_plan(bundles: List[RefBundle], seed) -> ShufflePlan:
    blocks = _flatten(bundles)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(blocks))

    def finalize(_):
        return [RefBundle([blocks[j]], seq=i) for i, j in enumerate(order)]

    return ShufflePlan([], finalize)
