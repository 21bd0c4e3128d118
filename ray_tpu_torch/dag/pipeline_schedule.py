"""1F1B pipeline schedule over stage actors (counterpart of
``ray_tpu/dag/pipeline_schedule.py``).

``build_1f1b_schedule`` emits the canonical one-forward-one-backward op
order per stage (warmup forwards, steady alternation, cooldown backwards
— peak activation memory is ``S - s`` microbatches at stage ``s``, not
``M``), and ``PipelineRunner`` drives it across stage actors
(``ray_tpu_torch.actor``: one process each).

Two cross-stage data planes:

- ``transport="objects"``: refs chained through the driver — every
  activation travels stage -> driver -> stage as a pickled value, with a
  call per op;
- ``transport="channels"``: per-edge :class:`EdgeTransport` channels,
  negotiated at attach time from each stage's endpoint info (tier B
  device frames between processes that hold cards on one node, tier C
  host shm otherwise).  Activations move writer -> reader through a
  reused shm segment, each stage's call order pins its op order, and the
  channels themselves enforce the cross-stage dependencies — 1F1B with
  one-slot p2p buffers.  Per-stage compute and channel wait are
  measured, so :class:`PipelineResult` carries the measured bubble
  fraction against the analytic ``(S-1)/(M+S-1)`` bound.

For pipeline parallelism inside one program over a mesh's ``pp`` axis see
``ray_tpu_torch/parallel/pipeline.py``; this module is the process-level
counterpart for heterogeneous or multi-process stages.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

F = "F"
B = "B"
Op = Tuple[str, int]  # ("F"|"B", microbatch index)


def build_1f1b_schedule(n_stages: int, n_microbatches: int
                        ) -> List[List[Op]]:
    """Per-stage op order for the non-interleaved 1F1B schedule.

    Stage ``s`` runs ``min(S-1-s, M)`` warmup forwards, then alternates
    1F1B for the remainder, then drains with cooldown backwards.
    """
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    S, M = n_stages, n_microbatches
    schedule: List[List[Op]] = []
    for s in range(S):
        warmup = min(S - 1 - s, M)
        ops: List[Op] = [(F, i) for i in range(warmup)]
        for i in range(M - warmup):
            ops.append((F, warmup + i))
            ops.append((B, i))
        for i in range(M - warmup, M):
            ops.append((B, i))
        schedule.append(ops)
    return schedule


def max_inflight(schedule_for_stage: Sequence[Op]) -> int:
    """Peak number of microbatches forwarded but not yet backwarded —
    the stage's activation-memory high-water mark."""
    live = peak = 0
    for kind, _ in schedule_for_stage:
        live += 1 if kind == F else -1
        peak = max(peak, live)
    return peak


@dataclasses.dataclass
class PipelineResult:
    outputs: Dict[int, Any]      # microbatch -> last-stage forward output
    input_grads: Dict[int, Any]  # microbatch -> first-stage backward output
    stats: Optional[Dict[str, Any]] = None  # channel mode: wall/bubble/waits


# ---------------------------------------------------------------------------
# Stage-side channel state (keyed per runner; module-level so the helper
# fns pickle by reference and run inside the stage actors' processes)
# ---------------------------------------------------------------------------

_PIPE_STATES: Dict[str, Dict[str, Any]] = {}


def _pipe_attach(instance, key: str, cfg: Dict[str, Any]) -> bool:
    """``_remote_call`` body: take this stage's transports."""
    _PIPE_STATES[key] = dict(cfg, busy_s=0.0, wait_fwd_s=0.0,
                             wait_bwd_s=0.0, ops=0)
    return True


def _pipe_reset(instance, key: str) -> bool:
    st = _PIPE_STATES[key]
    st.update(busy_s=0.0, wait_fwd_s=0.0, wait_bwd_s=0.0, ops=0)
    return True


def _pipe_stats(instance, key: str) -> Dict[str, Any]:
    st = _PIPE_STATES[key]
    return {k: st[k] for k in
            ("busy_s", "wait_fwd_s", "wait_bwd_s", "ops")}


def _pipe_detach(instance, key: str) -> bool:
    st = _PIPE_STATES.pop(key, None)
    if st:
        for k in ("fwd_in", "fwd_out", "bwd_in", "bwd_out"):
            tr = st.get(k)
            if tr is not None:
                try:
                    tr.close()
                except Exception:  # noqa: BLE001 — peer may be gone
                    pass
    return True


def _pipe_forward(instance, key: str, mb: int, x: Any):
    """One forward op on this stage: read the activation from the
    upstream channel (stage 0 takes it from the call args), compute,
    write downstream (the last stage returns to the driver)."""
    st = _PIPE_STATES[key]
    if st["fwd_in"] is not None:
        t0 = time.perf_counter()
        x = st["fwd_in"].read(timeout=st["timeout"])
        st["wait_fwd_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    y = instance.forward(mb, x)
    st["busy_s"] += time.perf_counter() - t0
    st["ops"] += 1
    if st["fwd_out"] is not None:
        st["fwd_out"].write(y, timeout=st["timeout"])
        return None
    return y


def _pipe_backward(instance, key: str, mb: int):
    """One backward op: read the output grad from downstream (the last
    stage seeds ``grad=None``), compute, write upstream (stage 0 returns
    the input grad to the driver)."""
    st = _PIPE_STATES[key]
    g = None
    if st["bwd_in"] is not None:
        t0 = time.perf_counter()
        g = st["bwd_in"].read(timeout=st["timeout"])
        st["wait_bwd_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    ig = instance.backward(mb, g)
    st["busy_s"] += time.perf_counter() - t0
    st["ops"] += 1
    if st["bwd_out"] is not None:
        st["bwd_out"].write(ig, timeout=st["timeout"])
        return None
    return ig


class PipelineRunner:
    """Drives stage actors through the 1F1B schedule.

    Each stage actor must expose ``forward(mb_index, x) -> y`` and
    ``backward(mb_index, grad) -> input_grad`` remote methods (the last
    stage's backward receives its own forward output's loss-grad seed as
    ``grad=None``).  Submission follows the per-stage 1F1B order; actor
    call ordering serializes ops on each stage.

    ``transport="objects"`` chains cross-stage data through refs;
    ``transport="channels"`` moves it through negotiated per-edge
    :class:`EdgeTransport` channels instead (see the module docstring) —
    after a channel run, ``result.stats`` carries wall time, per-stage
    busy/wait, the measured bubble fraction, the analytic bound, and the
    per-tier channel-wait breakdown.  Call :meth:`close` when done with a
    channel-mode runner to release the shm segments.
    """

    def __init__(self, stage_actors: Sequence[Any], *,
                 transport: str = "objects",
                 buffer_size: int = 1 << 22,
                 op_timeout_s: float = 120.0):
        if not stage_actors:
            raise ValueError("need at least one stage actor")
        if transport not in ("objects", "channels"):
            raise ValueError(f"unknown transport {transport!r}")
        self.stages = list(stage_actors)
        self.transport = transport
        self.buffer_size = buffer_size
        self.op_timeout_s = op_timeout_s
        self._key = f"pipe-{uuid.uuid4().hex[:12]}"
        self._edges: Dict[str, str] = {}   # edge label -> negotiated tier
        self._transports: List[Any] = []   # writer-side (driver-owned shm)
        self._driver_handles: List[Any] = []  # reader handles sent out
        self._attached = False

    # -- channel plumbing ---------------------------------------------------
    def _attach_channels(self, timeout: Optional[float]) -> None:
        from ray_tpu_torch import actor as actor_mod
        from ray_tpu_torch.experimental.channel import transport as transport_mod
        from ray_tpu_torch.experimental.channel.transport import (
            attach_edge_transport,
            make_edge_transport,
        )

        S = len(self.stages)
        infos = transport_mod.gather_endpoint_info(self.stages)
        ids = [a._actor_id for a in self.stages]
        cfgs: List[Dict[str, Any]] = [
            {"fwd_in": None, "fwd_out": None, "bwd_in": None,
             "bwd_out": None, "timeout": self.op_timeout_s}
            for _ in range(S)]
        for s in range(S - 1):
            fwd_tier = transport_mod.negotiate(
                infos.get(ids[s]), infos.get(ids[s + 1]))
            bwd_tier = transport_mod.negotiate(
                infos.get(ids[s + 1]), infos.get(ids[s]))
            self._edges[f"fwd:{s}->{s + 1}"] = fwd_tier
            self._edges[f"bwd:{s + 1}->{s}"] = bwd_tier
            fwd = make_edge_transport(
                tier=fwd_tier, edge=f"fwd:{s}->{s + 1}",
                buffer_size=self.buffer_size)
            bwd = make_edge_transport(
                tier=bwd_tier, edge=f"bwd:{s + 1}->{s}",
                buffer_size=self.buffer_size)
            self._transports += [fwd, bwd]
            # each reader lands tensors on its stage's device
            cfgs[s]["fwd_out"] = fwd
            cfgs[s + 1]["fwd_in"] = self._reader(
                attach_edge_transport, fwd, self.stages[s + 1])
            cfgs[s + 1]["bwd_out"] = bwd
            cfgs[s]["bwd_in"] = self._reader(
                attach_edge_transport, bwd, self.stages[s])
        actor_mod.get(
            [a._remote_call.remote(_pipe_attach, self._key, cfg)
             for a, cfg in zip(self.stages, cfgs)],
            timeout=timeout)
        for tr in self._driver_handles:
            tr.channel.detach()
        self._driver_handles = []
        self._attached = True

    def _reader(self, attach, transport, stage):
        tr = attach(transport, 0, device=stage._device)
        self._driver_handles.append(tr)
        return tr

    def close(self, *, timeout: float = 10.0) -> None:
        """Release channel-mode resources (shm segments, stage state)."""
        if not self._attached:
            return
        from ray_tpu_torch import actor as actor_mod

        self._attached = False
        for tr in self._transports:
            tr.close()
        try:
            actor_mod.get(
                [a._remote_call.remote(_pipe_detach, self._key)
                 for a in self.stages], timeout=timeout)
        except Exception:  # noqa: BLE001 — dead stages: segments unlink below
            pass
        for tr in self._transports:
            tr.destroy()
        self._transports = []

    # -- driving ------------------------------------------------------------
    def run(self, microbatches: Sequence[Any], *, backward: bool = True,
            timeout: Optional[float] = None) -> PipelineResult:
        if self.transport == "channels":
            return self._run_channels(microbatches, backward=backward,
                                      timeout=timeout)
        return self._run_objects(microbatches, backward=backward,
                                 timeout=timeout)

    def _run_channels(self, microbatches: Sequence[Any], *,
                      backward: bool, timeout: Optional[float]
                      ) -> PipelineResult:
        from ray_tpu_torch import actor as actor_mod

        S, M = len(self.stages), len(microbatches)
        if not self._attached:
            self._attach_channels(timeout)
        else:
            actor_mod.get(
                [a._remote_call.remote(_pipe_reset, self._key)
                 for a in self.stages], timeout=timeout)
        if backward:
            schedule = build_1f1b_schedule(S, M)
        else:
            schedule = [[(F, i) for i in range(M)] for _ in range(S)]
        fwd_refs: Dict[int, Any] = {}
        bwd_refs: Dict[int, Any] = {}
        t0 = time.perf_counter()
        # submit each stage's FULL schedule up front: actor call ordering
        # pins the intra-stage op order, the channels enforce cross-stage
        # dependencies — no ref chaining, no driver in the loop
        for s, actor in enumerate(self.stages):
            for kind, mb in schedule[s]:
                if kind == F:
                    x = microbatches[mb] if s == 0 else None
                    ref = actor._remote_call.remote(
                        _pipe_forward, self._key, mb, x)
                    if s == S - 1:
                        fwd_refs[mb] = ref
                else:
                    ref = actor._remote_call.remote(
                        _pipe_backward, self._key, mb)
                    if s == 0:
                        bwd_refs[mb] = ref
        outs = actor_mod.get(list(fwd_refs.values()), timeout=timeout)
        grads = (actor_mod.get(list(bwd_refs.values()), timeout=timeout)
                 if backward else [])
        wall = time.perf_counter() - t0
        stage_stats = actor_mod.get(
            [a._remote_call.remote(_pipe_stats, self._key)
             for a in self.stages], timeout=timeout)
        busy = [st["busy_s"] for st in stage_stats]
        # schedule bubble, Megatron's definition: idle vs the BOTTLENECK
        # stage's ideal time (the analytic (S-1)/(M+S-1) models uniform
        # stages, i.e. exactly the bottleneck-relative quantity);
        # heterogeneity is reported separately as stage_imbalance
        busy_max = max(busy) if busy else 0.0
        busy_mean = sum(busy) / max(S, 1)
        tier_wait: Dict[str, float] = {}
        for s, st in enumerate(stage_stats):
            for label, wait in ((f"fwd:{s - 1}->{s}", st["wait_fwd_s"]),
                                (f"bwd:{s + 1}->{s}", st["wait_bwd_s"])):
                tier = self._edges.get(label)
                if tier is not None and wait > 0:
                    tier_wait[tier] = tier_wait.get(tier, 0.0) + wait
        stats = {
            "wall_s": wall,
            "n_stages": S,
            "n_microbatches": M,
            "bubble_fraction": max(0.0, 1.0 - busy_max / wall)
            if wall > 0 else 0.0,
            "stage_imbalance": (busy_max / busy_mean - 1.0)
            if busy_mean > 0 else 0.0,
            "analytic_bubble": (S - 1) / (M + S - 1),
            "per_stage": stage_stats,
            "channel_wait_s_by_tier": tier_wait,
            "channel_transport": dict(self._edges),
        }
        return PipelineResult(
            dict(zip(fwd_refs.keys(), outs)),
            dict(zip(bwd_refs.keys(), grads)),
            stats=stats,
        )

    def _run_objects(self, microbatches: Sequence[Any], *,
                     backward: bool, timeout: Optional[float]
                     ) -> PipelineResult:
        from ray_tpu_torch import actor as actor_mod

        S, M = len(self.stages), len(microbatches)
        schedule = build_1f1b_schedule(S, M)
        fwd: List[Dict[int, Any]] = [dict() for _ in range(S)]
        bwd: List[Dict[int, Any]] = [dict() for _ in range(S)]
        if not backward:
            # forward-only (inference): plain GPipe fill-drain
            for s in range(S):
                for mb in range(M):
                    x = microbatches[mb] if s == 0 else fwd[s - 1][mb]
                    fwd[s][mb] = self.stages[s].forward.remote(mb, x)
            outs = actor_mod.get(list(fwd[-1].values()), timeout=timeout)
            return PipelineResult(dict(zip(fwd[-1].keys(), outs)), {})

        # Submit in dependency-driven rounds: an op is submittable once the
        # upstream ref it consumes exists (F needs stage s-1's F; B needs
        # stage s+1's B).  Per-stage submission still follows the schedule
        # order, which actor call ordering turns into execution order.
        idx = [0] * S
        remaining = sum(len(ops) for ops in schedule)
        while remaining:
            progress = False
            for s in range(S):
                while idx[s] < len(schedule[s]):
                    kind, mb = schedule[s][idx[s]]
                    if kind == F:
                        if s > 0 and mb not in fwd[s - 1]:
                            break
                        x = microbatches[mb] if s == 0 else fwd[s - 1][mb]
                        fwd[s][mb] = self.stages[s].forward.remote(mb, x)
                    else:
                        if s < S - 1 and mb not in bwd[s + 1]:
                            break
                        g = None if s == S - 1 else bwd[s + 1][mb]
                        bwd[s][mb] = self.stages[s].backward.remote(mb, g)
                    idx[s] += 1
                    remaining -= 1
                    progress = True
            if not progress:
                raise RuntimeError("1F1B schedule deadlocked; invalid "
                                   "schedule or stage count")
        outs = actor_mod.get(list(fwd[-1].values()), timeout=timeout)
        grads = actor_mod.get(list(bwd[0].values()), timeout=timeout)
        return PipelineResult(
            dict(zip(fwd[-1].keys(), outs)),
            dict(zip(bwd[0].keys(), grads)),
        )
