"""Compiled DAG: per-edge shm channels and a standing exec loop in each
actor process (counterpart of ``ray_tpu/dag/compiled_dag.py``).

After compile, an execution crosses no call path: the driver writes the
input channel, each actor's exec-loop thread reads its in-edges, runs its
methods, writes its out-edges, and the driver reads the output channels.

Same-actor edges short-circuit through a local cache (no channel).  Every
cross-process edge rides a tier-negotiated ``EdgeTransport``
(``experimental/channel/transport.py``): tier B device frames between
processes that hold cards on one node (the reader lands tensors on its
card with an H2D copy straight from the page-locked segment), tier C host
shm everywhere else.  Tiers are fixed once at compile time from each
actor's endpoint info (``gather_endpoint_info``), recorded in
``stats()["channel_transport"]``, and degrade to tier C on a failed
encode or decode.  The driver is an endpoint too: it reads outputs onto
its card when it has brought CUDA up, else onto the host.

Tier A, fused runs: a method bound with ``.options(jit=True)`` may be
fused with the adjacent jit-marked methods of its actor into ONE task
(``_fuse_jit_runs``, the reference's planning and error semantics
unchanged): the run's channel reads are hoisted before it, its methods run
back to back with their intermediates left where they are (tensors on the
device, never through a channel), and what leaves the run is written
after it.  Divergence by design: the reference compiles the run into one
``jax.jit`` program, whose bound methods see actor attributes as
constants frozen at trace time; here the run executes eagerly, so a fused
method does see actor state that other methods mutate.  Capturing a run
as one CUDA graph is not done yet.

Actors are processes (``ray_tpu_torch.actor``): an exec loop is a thread
of its actor's process, bound to the actor's card; liveness is the
process's own (``_check_actors_alive``).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.collective_node import CollectiveNode, run_collective
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.exceptions import ActorDiedError, TaskError
from ray_tpu_torch.experimental.channel import Channel, ChannelClosedError
from ray_tpu_torch.experimental.channel import transport as transport_mod
from ray_tpu_torch.experimental.channel.transport import (
    TIER_FUSED,
    EdgeTransport,
)

# node types that execute as tasks inside an actor's exec loop
_TASK_NODES = (ClassMethodNode, CollectiveNode)


class _Stop:
    """Teardown sentinel propagated through every channel."""

    def __reduce__(self):
        return (_Stop, ())


_STOP = _Stop()


class _StopSignal(BaseException):
    """Raised inside the exec loop when a channel delivers the _STOP
    sentinel (BaseException so user-level ``except Exception`` in resolve
    can't swallow it)."""


# --------------------------------------------------------------------------
# Actor-side exec loop (runs inside the actor process, in its own thread)
# --------------------------------------------------------------------------

_EXEC_LOOPS: Dict[str, Dict[str, Any]] = {}


def _start_exec_loop(instance, dag_id: str, spec: Dict[str, Any]) -> bool:
    """``_remote_call`` body: start this actor's exec loop for ``dag_id``
    on a thread bound to the actor's card."""
    from ray_tpu_torch.actor import bind_thread_device

    # prune finished loops so long-lived actors don't accumulate state
    for done_id in [k for k, st in _EXEC_LOOPS.items() if st.get("done")]:
        _EXEC_LOOPS.pop(done_id, None)
    state: Dict[str, Any] = {"error": None, "done": False, "spec": spec}
    _EXEC_LOOPS[dag_id] = state

    def _loop():
        try:
            bind_thread_device()
            _run_exec_loop(instance, spec)
        except ChannelClosedError:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced via status
            state["error"] = repr(e)
        finally:
            state["done"] = True

    t = threading.Thread(target=_loop, daemon=True,
                         name=f"dag-exec-{dag_id[:8]}")
    state["thread"] = t
    t.start()
    return True


def _exec_loop_status(instance, dag_id: str) -> Dict[str, Any]:
    st = _EXEC_LOOPS.get(dag_id)
    if st is None:
        return {"done": True, "error": None}
    return {"done": st["done"], "error": st["error"]}


def _exec_loop_channels(instance, dag_id: str) -> Dict[str, Dict[str, Any]]:
    """``_remote_call`` body: the stats of every transport this actor's
    exec loop reads or writes, by edge (``read_wait_s`` is the channel
    wait of a read edge)."""
    st = _EXEC_LOOPS.get(dag_id)
    if st is None:
        return {}
    spec = st["spec"]
    out: Dict[str, Dict[str, Any]] = {}
    for tr in spec["read_channels"].values():
        out[tr.edge] = {"side": "read", "tier": tr.tier, **tr.stats}
    for t in spec["tasks"]:
        emits = t["emit"] if t.get("fused") is not None else [
            (None, t["out_channel"])]
        for _idx, tr in emits:
            if tr is not None:
                out[tr.edge] = {"side": "write", "tier": tr.tier,
                                **tr.stats}
    return out


def _destroy_group(instance, group_name: str) -> bool:
    """``_remote_call`` body: leave a DAG's collective group."""
    from ray_tpu_torch.util.collective import collective as coll

    coll.destroy_collective_group(group_name)
    return True


class _Pending:
    """An in-flight overlapped collective; joined at first consumption."""

    __slots__ = ("fut",)

    def __init__(self, fut):
        self.fut = fut

    def join(self):
        try:
            return self.fut.result()
        except BaseException as e:  # noqa: BLE001 — propagated downstream
            return TaskError.from_exception(e)


def _fuse_jit_runs(tasks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Merge maximal runs of ADJACENT jit-marked tasks into fused tasks.

    Safety rule: fusing hoists the run's channel reads before its channel
    writes (externals resolve first, emits write last).  A candidate that
    reads a cross-actor channel therefore may not join a run that has
    already written an out-channel — an A→B→A shape would deadlock (A's
    read of B's output would precede the write B needs).  DAG-input reads
    are always safe to hoist: the driver writes the input before any task
    runs.
    """
    out: List[Dict[str, Any]] = []
    i = 0
    while i < len(tasks):
        t = tasks[i]
        if not t.get("jit"):
            out.append(t)
            i += 1
            continue
        run = [t]
        wrote = t["out_channel"] is not None
        j = i + 1
        while j < len(tasks) and tasks[j].get("jit"):
            cand = tasks[j]
            reads_chan = any(
                a[0] == "chan"
                for a in list(cand["args"]) + list(cand["kwargs"].values()))
            if wrote and reads_chan:
                break
            run.append(cand)
            wrote = wrote or cand["out_channel"] is not None
            j += 1
        out.append(_make_fused_task(run, tasks[j:]))
        i = j
    return out


def _make_fused_task(run: List[Dict[str, Any]],
                     later_tasks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Build the fused task dict: external argspecs in first-read order
    (preserving the unfused channel-read order), and the emit list — every
    sub-result consumed outside the run (out-channel or a later local)."""
    run_idx = {t["local_idx"] for t in run}
    later_refs = set()
    for lt in later_tasks:
        subs = lt["fused"] if lt.get("fused") is not None else [lt]
        for s in subs:
            for a in list(s["args"]) + list(s["kwargs"].values()):
                if a[0] == "local":
                    later_refs.add(a[1])
    ext: List[Tuple] = []
    seen = set()
    for t in run:
        for a in list(t["args"]) + list(t["kwargs"].values()):
            if a[0] == "const" or (a[0] == "local" and a[1] in run_idx):
                continue
            key = tuple(a)
            if key not in seen:
                seen.add(key)
                ext.append(a)
    emit = [(t["local_idx"], t["out_channel"]) for t in run
            if t["out_channel"] is not None or t["local_idx"] in later_refs]
    if not emit:  # nothing consumed outside: keep the tail result visible
        emit = [(run[-1]["local_idx"], None)]
    return {
        "fused": [{"method": t["method"], "args": t["args"],
                   "kwargs": t["kwargs"], "local_idx": t["local_idx"]}
                  for t in run],
        "ext": ext,
        "emit": emit,
        "out_channel": None,
        "local_idx": run[-1]["local_idx"],
    }


def _exec_fused(instance, t: Dict[str, Any], resolve, local) -> None:
    """Execute one fused task: resolve externals (lazy channel reads, in
    original task order), run the run's methods back to back, fan results
    out to the emitted locals/out-channels.

    Error semantics match unfused execution EXACTLY: an external that
    fails to resolve errors every emit; otherwise each subtask errors on
    its own (a raise, or an upstream TaskError among its arguments), and
    only its downstream consumers see the error — a fused sibling on a
    clean path still emits its value."""
    try:
        ext_vals = [resolve(a) for a in t["ext"]]  # may raise _StopSignal
    except (_StopSignal, ChannelClosedError):
        raise  # teardown, not a task's error
    except BaseException as e:  # noqa: BLE001 — bad input shape, closed chan
        # the fused task's top-level out_channel is always None, so the
        # generic per-task handler would write this error NOWHERE and
        # downstream consumers would hang — fan it out to every emit
        err = TaskError.from_exception(e)
        for idx, ch in t["emit"]:
            local[idx] = err
            if ch is not None:
                ch.write(err)
        return
    run_idx = {s["local_idx"] for s in t["fused"]}
    ext_slot = {tuple(a): k for k, a in enumerate(t["ext"])}
    loc: Dict[int, Any] = {}

    def res(a):
        if a[0] == "const":
            return a[1]
        if a[0] == "local" and a[1] in run_idx:
            return loc[a[1]]
        return ext_vals[ext_slot[tuple(a)]]

    for s in t["fused"]:
        try:
            args = [res(a) for a in s["args"]]
            kwargs = {k: res(v) for k, v in s["kwargs"].items()}
            up = next((v for v in list(args) + list(kwargs.values())
                       if isinstance(v, TaskError)), None)
            result = up if up is not None else getattr(
                instance, s["method"])(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — propagated downstream
            result = TaskError.from_exception(e)
        loc[s["local_idx"]] = result
    for idx, ch in t["emit"]:
        local[idx] = loc[idx]
        if ch is not None:
            ch.write(loc[idx])


def _run_exec_loop(instance, spec: Dict[str, Any]) -> None:
    """One iteration per execute(): read in-edges, run tasks, write out-edges.

    spec = {"read_channels": {name: Channel}, "tasks": [
        {"method": str, "args": [argspec], "kwargs": {k: argspec},
         "out_channel": Channel|None, "local_idx": int,
         "collective": None | {"kind", "group"}}]}
    argspec = ("const", v) | ("input",) | ("input_attr", key)
             | ("chan", name) | ("local", idx)

    Comm/compute overlap (reference ``dag_node_operation.py``): a
    collective whose result is consumed only LATER on this actor runs on a
    background thread; tasks between the collective and its first consumer
    execute concurrently with the communication.
    """
    read_channels: Dict[str, Channel] = spec["read_channels"]
    tasks = spec["tasks"]
    coll_pool = None
    if any(t.get("collective") for t in tasks):
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.actor import bind_thread_device

        coll_pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="dag-coll",
                                       initializer=bind_thread_device)
    try:
        _exec_iterations(instance, spec, read_channels, tasks, coll_pool)
    finally:
        if coll_pool is not None:
            coll_pool.shutdown(wait=False)


def _exec_iterations(instance, spec, read_channels, tasks, coll_pool):
    while True:
        # Channels are read LAZILY, at first use within the iteration: an
        # A->B->A shape needs A to run its first task (filling B's input)
        # before blocking on B's output — an eager read-all would deadlock.
        cache: Dict[str, Any] = {}

        def get_chan(name: str):
            if name not in cache:
                cache[name] = read_channels[name].read()
            if isinstance(cache[name], _Stop):
                # raise BEFORE any unpacking of the value (the input argspec
                # does `args, kwargs = get_chan(...)`)
                raise _StopSignal()
            return cache[name]

        local: Dict[int, Any] = {}

        def resolve(a):
            kind = a[0]
            if kind == "const":
                return a[1]
            if kind == "input":
                args, kwargs = get_chan(spec["input_channel"])
                if len(args) == 1 and not kwargs:
                    return args[0]
                raise TypeError(
                    "DAG input consumed whole but execute() got multiple "
                    "args; bind inp[i]/inp.key instead")
            if kind == "input_attr":
                args, kwargs = get_chan(spec["input_channel"])
                key = a[1]
                return kwargs[key] if isinstance(key, str) else args[key]
            if kind == "chan":
                return get_chan(a[1])
            if kind == "local":
                v = local[a[1]]
                if isinstance(v, _Pending):  # join an overlapped collective
                    v = local[a[1]] = v.join()
                return v
            raise ValueError(f"bad argspec {a!r}")

        stopping = False
        for t in tasks:
            try:
                if t.get("fused") is not None:
                    _exec_fused(instance, t, resolve, local)
                    continue
                args = [resolve(a) for a in t["args"]]
                kwargs = {k: resolve(v) for k, v in t["kwargs"].items()}
                vals = list(args) + list(kwargs.values())
                upstream_err = next(
                    (v for v in vals if isinstance(v, TaskError)), None)
                coll = t.get("collective")
                if upstream_err is not None:
                    # skip the op (a collective's peers fail the iteration
                    # via the group timeout instead of hanging forever)
                    result = upstream_err
                elif coll is not None:
                    if t["out_channel"] is None:
                        # result consumed later on this actor: overlap the
                        # communication with the compute in between
                        local[t["local_idx"]] = _Pending(coll_pool.submit(
                            run_collective, coll["kind"], args[0],
                            coll["group"]))
                        continue
                    result = run_collective(coll["kind"], args[0],
                                            coll["group"])
                else:
                    result = getattr(instance, t["method"])(*args, **kwargs)
            except _StopSignal:
                stopping = True
                break
            except ChannelClosedError:
                # teardown closed a channel under this iteration (a fused
                # run writes inside this try): end the loop, never spin
                raise
            except BaseException as e:  # noqa: BLE001 — propagated downstream
                result = TaskError.from_exception(e)
            local[t["local_idx"]] = result
            if t["out_channel"] is not None:
                t["out_channel"].write(result)
        if stopping:
            for t in tasks:
                if t.get("fused") is not None:
                    for idx, ch in t["emit"]:
                        if ch is not None and idx not in local:
                            ch.write(_STOP)
                    continue
                out = t["out_channel"]
                if out is not None and t["local_idx"] not in local:
                    out.write(_STOP)
            return


# --------------------------------------------------------------------------
# Driver side
# --------------------------------------------------------------------------

class CompiledDAGRef:
    """Result handle for one execute().  Results may be gotten out of
    submission order (earlier executions' values are buffered, capped by
    ``max_buffered_results``); each ref can be gotten once."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._result: Any = None
        self._has_result = False

    def get(self, timeout: Optional[float] = None):
        return self._dag._get_result(self, timeout)

    def __repr__(self):
        return f"CompiledDAGRef(idx={self._idx})"


class CompiledDAGFuture:
    """Awaitable result of ``execute_async()``.  Await resolves when this execution's outputs arrive; earlier
    executions' results are drained into the buffer, so futures may be
    awaited in any order and N>1 executions can be in flight."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._awaited = False

    def __await__(self):
        if self._awaited:
            raise ValueError(
                "a CompiledDAGFuture can only be awaited once")
        self._awaited = True
        return self._dag._await_result(self._idx).__await__()

    def __repr__(self):
        return f"CompiledDAGFuture(idx={self._idx})"


class CompiledDAG:
    def __init__(self, root: DAGNode, *, buffer_size_bytes: int = 1 << 20,
                 submit_timeout: float = 30.0,
                 max_buffered_results: int = 1000):
        self.root = root
        self.buffer_size = buffer_size_bytes
        self.submit_timeout = submit_timeout
        self.max_buffered_results = max_buffered_results
        self.dag_id = uuid.uuid4().hex
        self._input_channel: Optional[EdgeTransport] = None
        self._output_channels: List[EdgeTransport] = []
        self._all_channels: List[Channel] = []
        # edge label -> negotiated transport tier (fixed at compile time;
        # surfaced in stats())
        self._edge_tiers: Dict[str, str] = {}
        self._actors: List[Any] = []
        # reader handles this process opened to hand to the exec loops
        self._driver_handles: List[Channel] = []
        self._collective_groups: List[Any] = []
        self._next_exec_idx = 0
        self._next_get_idx = 0
        # values already drained from output channels for the execution
        # currently being gotten (lets a timed-out get() resume without
        # re-reading channels it already consumed)
        self._partial_values: List[Any] = []
        # out-of-order delivery: executions drained past a waiter's index
        # park here until their ref/future claims them
        self._buffered_results: Dict[int, List[Any]] = {}
        self._torn_down = False
        # a DAG actor observed DEAD mid-execution poisons the pipeline:
        # every pending/future result raises this instead of hanging on
        # channels no exec loop will ever write again
        self._dead_actor_error: Optional[BaseException] = None
        self._last_liveness_probe = 0.0
        # separate locks: a producer blocked in a backpressured execute()
        # must not prevent a consumer's get() from draining the pipeline
        self._submit_lock = threading.Lock()
        self._get_lock = threading.Lock()
        self._drain_task: Optional[Any] = None  # eager async drainer
        self._drain_error: Optional[BaseException] = None
        # (loop, Event) pairs pulsed (threadsafe) after each drained
        # execution so futures waiting on any event loop wake up
        self._result_waiters: List[Any] = []

    # -- compilation -------------------------------------------------------
    def _compile(self) -> None:
        try:
            self._compile_inner()
        except BaseException:
            # no shm leak on failed compile
            for ch in self._driver_handles:
                ch.detach()
            for ch in self._all_channels:
                ch.destroy()
            self._all_channels = []
            self._torn_down = True
            raise

    def _compile_inner(self) -> None:
        from ray_tpu_torch import actor as actor_mod

        nodes = self.root._collect()
        input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if any(isinstance(n, FunctionNode) for n in nodes):
            raise TypeError(
                "compiled graphs support actor methods only (reference "
                "semantics); FunctionNode requires interpreted execute()")
        if len(input_nodes) != 1:
            raise ValueError(
                f"a compiled DAG needs exactly one InputNode, found "
                f"{len(input_nodes)}")
        self._input_node = input_nodes[0]

        terminals: List[DAGNode]
        if isinstance(self.root, MultiOutputNode):
            terminals = self.root.outputs
        else:
            terminals = [self.root]
        for t in terminals:
            if not isinstance(t, _TASK_NODES):
                raise TypeError(
                    f"compiled DAG outputs must be actor-method nodes, got "
                    f"{type(t).__name__}")

        method_nodes = [n for n in nodes if isinstance(n, _TASK_NODES)]
        # collective groups: every rank's output node must be part of THIS
        # dag — an absent rank would deadlock the group at runtime
        group_members: Dict[int, List[CollectiveNode]] = {}
        self._collective_groups = []
        for n in method_nodes:
            if isinstance(n, CollectiveNode):
                members = group_members.setdefault(id(n.group), [])
                if not members:
                    self._collective_groups.append(n.group)
                members.append(n)
        for group in self._collective_groups:
            found = {m.index for m in group_members[id(group)]}
            if len(found) != group.world_size:
                raise ValueError(
                    f"collective group over {group.world_size} actors but "
                    f"only ranks {sorted(found)} are reachable in this DAG "
                    f"— bind ALL returned collective nodes")
        # every task must depend (transitively) on the input: the exec loop
        # paces iterations by channel reads, so a read-less task would spin
        depends: Dict[int, bool] = {}
        for n in nodes:
            if isinstance(n, (InputNode, InputAttributeNode)):
                depends[id(n)] = True
            else:
                depends[id(n)] = any(depends.get(id(u), False)
                                     for u in n._upstream())
        for n in method_nodes:
            if not depends[id(n)]:
                raise ValueError(
                    f"{n!r} does not depend on the DAG input; compiled "
                    f"tasks must be reachable from InputNode")
        node_idx = {id(n): i for i, n in enumerate(method_nodes)}
        actor_of = {id(n): n.actor._actor_id for n in method_nodes}
        handles: Dict[Any, Any] = {n.actor._actor_id: n.actor
                                   for n in method_nodes}
        self._actors = list(handles.values())

        # transport negotiation: one placement/device probe per actor,
        # once, at compile time — every edge's tier is fixed before the
        # first execute
        infos = transport_mod.gather_endpoint_info(
            self._actors, timeout=self.submit_timeout)
        driver_info = transport_mod.local_endpoint_info()
        # where each reader lands tensors: an actor on its device, the
        # driver on its card once it has brought CUDA up, else the host
        device_of = {aid: h._device for aid, h in handles.items()}
        self._device = _driver_device()

        def reader(ch: Channel, slot: int) -> Channel:
            rc = Channel(ch.name, buffer_size=ch.buffer_size,
                         num_readers=ch.num_readers, _create=False)
            rc.set_reader_slot(slot)
            self._driver_handles.append(rc)
            return rc

        def _label(n) -> str:
            return f"{n.method_name}@{actor_of[id(n)].hex()[:6]}"

        def _aid_label(aid) -> str:
            return f"@{aid.hex()[:6]}"

        # consumer sets
        consumes_input: Dict[Any, bool] = {aid: False for aid in handles}
        consumers: Dict[int, List[Any]] = {id(n): [] for n in method_nodes}
        for n in method_nodes:
            for dep in n._upstream():
                if isinstance(dep, (InputNode, InputAttributeNode)):
                    consumes_input[actor_of[id(n)]] = True
                elif isinstance(dep, _TASK_NODES):
                    if actor_of[id(dep)] != actor_of[id(n)]:
                        consumers[id(dep)].append(actor_of[id(n)])

        terminal_counts: Dict[int, int] = {}
        for t in terminals:
            terminal_counts[id(t)] = terminal_counts.get(id(t), 0) + 1
        terminal_ids = set(terminal_counts)

        # Tiered channels run the Python data plane (native=False): device
        # frames serialize straight into the segment and reads defer their
        # ack.  The buffer gets frame-header slack so the user-visible
        # payload capacity stays buffer_size_bytes.
        chan_capacity = self.buffer_size + 256

        # input channel: one writer (driver), one reader slot per actor
        # that consumes the input
        input_actors = [aid for aid, used in consumes_input.items() if used]
        input_ch = Channel(buffer_size=chan_capacity,
                           num_readers=max(1, len(input_actors)),
                           native=False)
        input_tier = transport_mod.negotiate_channel(
            driver_info, [infos.get(aid) for aid in input_actors])
        for aid in input_actors:
            # record the EFFECTIVE tier: one channel serves every reader
            # with one encoding, so a weakest-link downgrade applies to
            # all its edges (stats must not claim a device frame that
            # never ships)
            self._edge_tiers[f"input->{_aid_label(aid)}"] = input_tier
        self._input_channel = EdgeTransport(input_ch, input_tier, "input")
        self._all_channels.append(input_ch)
        input_slot = {aid: i for i, aid in enumerate(input_actors)}

        # per-node output channels (cross-actor consumers + driver)
        out_channel: Dict[int, Optional[Channel]] = {}
        out_tier: Dict[int, str] = {}
        out_slots: Dict[int, Dict[Any, int]] = {}
        for n in method_nodes:
            readers = sorted(set(consumers[id(n)]), key=repr)
            writer_info = infos.get(actor_of[id(n)])
            # a node listed k times in MultiOutputNode gets k driver slots
            # (each driver read consumes its own ack slot)
            n_driver = terminal_counts.get(id(n), 0)
            n_readers = len(readers) + n_driver
            if n_readers == 0:
                out_channel[id(n)] = None
                continue
            ch = Channel(buffer_size=chan_capacity, num_readers=n_readers,
                         native=False)
            self._all_channels.append(ch)
            out_channel[id(n)] = ch
            tier = transport_mod.negotiate_channel(
                writer_info,
                [infos.get(aid) for aid in readers]
                + [driver_info] * n_driver)
            out_tier[id(n)] = tier
            # record the EFFECTIVE channel tier per edge (weakest-link:
            # one encoding serves every reader — stats must not claim a
            # device frame a mixed reader set downgrades away)
            for aid in readers:
                self._edge_tiers[f"{_label(n)}->{_aid_label(aid)}"] = tier
            if n_driver:
                self._edge_tiers[f"{_label(n)}->driver"] = tier
            out_slots[id(n)] = {aid: i for i, aid in enumerate(readers)}

        # same-actor edges never leave the process: record them as tier A
        # (fused runs never leave the task; unfused locals pass by
        # reference) so DAG stats account for every edge
        for n in method_nodes:
            for dep in n._upstream():
                if isinstance(dep, _TASK_NODES) and \
                        actor_of[id(dep)] == actor_of[id(n)]:
                    self._edge_tiers[f"{_label(dep)}->{_label(n)}"] = \
                        TIER_FUSED

        # driver's output channels, in terminal order (driver slots follow
        # the actor-consumer slots)
        self._output_channels = []
        next_driver_slot = {nid: len(out_slots.get(nid, {}))
                            for nid in terminal_ids}
        for t in terminals:
            ch = out_channel[id(t)]
            rc = reader(ch, next_driver_slot[id(t)])
            next_driver_slot[id(t)] += 1
            self._output_channels.append(EdgeTransport(
                rc, out_tier[id(t)], f"{_label(t)}->driver", self._device))

        # per-actor exec specs
        specs: Dict[Any, Dict[str, Any]] = {}
        for aid, handle in handles.items():
            read_chs: Dict[str, EdgeTransport] = {}
            if consumes_input[aid]:
                read_chs[input_ch.name] = EdgeTransport(
                    reader(input_ch, input_slot[aid]), input_tier,
                    f"input->{_aid_label(aid)}", device_of[aid])
            specs[aid] = {
                "read_channels": read_chs,
                "input_channel": input_ch.name,
                "tasks": [],
            }

        for n in method_nodes:
            aid = actor_of[id(n)]
            spec = specs[aid]

            def argspec(v):
                if isinstance(v, InputNode):
                    return ("input",)
                if isinstance(v, InputAttributeNode):
                    return ("input_attr", v.key)
                if isinstance(v, _TASK_NODES):
                    if actor_of[id(v)] == aid:
                        return ("local", node_idx[id(v)])
                    ch = out_channel[id(v)]
                    if ch.name not in spec["read_channels"]:
                        spec["read_channels"][ch.name] = EdgeTransport(
                            reader(ch, out_slots[id(v)][aid]),
                            out_tier[id(v)],
                            f"{_label(v)}->{_aid_label(aid)}",
                            device_of[aid])
                    return ("chan", ch.name)
                if isinstance(v, DAGNode):
                    raise TypeError(f"unsupported DAG arg {type(v).__name__}")
                return ("const", v)

            ch = out_channel[id(n)]
            task = {
                "method": n.method_name,
                "args": [argspec(a) for a in n._bound_args],
                "kwargs": {k: argspec(v) for k, v in n._bound_kwargs.items()},
                "out_channel": None if ch is None else EdgeTransport(
                    ch, out_tier[id(n)], _label(n)),
                "local_idx": node_idx[id(n)],
            }
            if isinstance(n, CollectiveNode):
                task["collective"] = {"kind": n.group.op,
                                      "group": n.group.group_name}
            elif n.options.get("jit"):
                task["jit"] = True
            spec["tasks"].append(task)

        # tier A: adjacent jit-marked tasks per actor become one task
        # (intermediates stay in the process, one read and write phase)
        for spec in specs.values():
            spec["tasks"] = _fuse_jit_runs(spec["tasks"])

        self._exec_specs = specs  # introspection (tests, debugging)

        # join each collective group's actors (rank order = bind order)
        # BEFORE exec loops start: the first iteration may hit the op
        # immediately
        from ray_tpu_torch.util.collective import collective as _coll

        for group in self._collective_groups:
            _coll.create_collective_group(
                [inp.actor for inp in group.inputs], group.world_size,
                backend=group.backend, group_name=group.group_name,
                timeout_s=group.timeout_s, devices=group.devices)

        # start exec loops
        start_refs = [handle._remote_call.remote(
            _start_exec_loop, self.dag_id, specs[aid])
            for aid, handle in handles.items()]
        actor_mod.get(start_refs, timeout=self.submit_timeout)

    # -- liveness ----------------------------------------------------------
    def _check_actors_alive(self, min_interval_s: float = 0.5) -> None:
        """Raise ``ActorDiedError`` if any DAG actor's process is gone.

        Called from channel-read timeout slices: a killed actor leaves
        its output channels unwritten forever, so without this probe a
        deadline-less ``get()`` hangs and a deadlined one burns its
        whole budget to report a generic channel timeout.  Reads each
        actor process's liveness, throttled to ``min_interval_s``; the
        verdict is sticky — once a member is dead the whole pipeline is
        poisoned (exec-loop iterations cannot be resumed mid-execution)."""
        if self._dead_actor_error is not None:
            raise self._dead_actor_error
        import time as _time

        now = _time.monotonic()
        if now - self._last_liveness_probe < min_interval_s:
            return
        self._last_liveness_probe = now
        for handle in self._actors:
            death = handle._death()
            if death is not None:
                self._dead_actor_error = ActorDiedError(
                    handle._actor_id,
                    f"compiled DAG actor {handle._class_name} "
                    f"({handle._actor_id.hex()[:12]}) died mid-execution "
                    f"({death.msg}); the DAG cannot make progress — call "
                    f"teardown() and recompile on live actors")
                raise self._dead_actor_error

    # -- introspection -----------------------------------------------------
    def _tier_summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for tier in self._edge_tiers.values():
            out[tier] = out.get(tier, 0) + 1
        return out

    def stats(self) -> Dict[str, Any]:
        """Channel-plane introspection: the per-edge negotiated transport
        (``channel_transport``), the driver-side channel counters and,
        until teardown, each exec loop's transport counters by edge (one
        ``_remote_call`` round; a read edge's ``read_wait_s`` is its
        channel wait)."""
        chans: Dict[str, Dict[str, Any]] = {}
        for tr in [self._input_channel] + list(self._output_channels):
            if tr is not None:
                chans[tr.edge] = {"tier": tr.tier, **tr.stats}
        out = {
            "channel_transport": dict(self._edge_tiers),
            "tiers": self._tier_summary(),
            "driver_channels": chans,
        }
        if not self._torn_down:
            from ray_tpu_torch import actor as actor_mod

            refs = [h._remote_call.remote(_exec_loop_channels, self.dag_id)
                    for h in self._actors]
            out["actor_channels"] = {
                f"{h._class_name}@{h._actor_id.hex()[:6]}": st
                for h, st in zip(self._actors, actor_mod.get(
                    refs, timeout=self.submit_timeout))}
        return out

    # -- execution ---------------------------------------------------------
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")
        if self._dead_actor_error is not None:
            raise self._dead_actor_error
        with self._submit_lock:
            # the channel write is the (possibly backpressured) submit
            # hop; node execution runs in the actors' standing loops
            self._input_channel.write((args, kwargs),
                                      timeout=self.submit_timeout)
            ref = CompiledDAGRef(self, self._next_exec_idx)
            self._next_exec_idx += 1
            return ref

    async def execute_async(self, *args, **kwargs) -> CompiledDAGFuture:
        """Asyncio twin of ``execute()``: submits without blocking the
        event loop (the backpressured channel write runs on the default
        executor) and returns an awaitable ``CompiledDAGFuture``.
        Multiple executions may be in flight; an eager background drainer
        moves completed executions into the result buffer (so pipelined
        submits never deadlock on full output slots) and futures resolve
        out-of-order-safely."""
        import asyncio

        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")
        loop = asyncio.get_event_loop()
        # drain BEFORE blocking on the input write: submits past the
        # pipeline depth only proceed as earlier executions retire.
        # Cross-coroutine/-loop submit ordering comes from the threading
        # _submit_lock inside the executor call (an asyncio.Lock here
        # would bind to one loop and break multi-loop callers).
        self._ensure_drainer()

        def _submit():
            with self._submit_lock:
                self._input_channel.write((args, kwargs),
                                          timeout=self.submit_timeout)
                idx = self._next_exec_idx
                self._next_exec_idx += 1
                return idx

        idx = await loop.run_in_executor(None, _submit)
        self._ensure_drainer()
        return CompiledDAGFuture(self, idx)

    def _ensure_drainer(self) -> None:
        """Start (or restart) the eager drain task on the current event
        loop.  One drainer runs at a time; it exits when every submitted
        execution has been drained into the buffer."""
        import asyncio

        if self._drain_task is None or self._drain_task.done():
            self._drain_error = None  # fresh drainer, fresh slate
            self._drain_task = asyncio.ensure_future(self._drain_loop())

    async def _drain_loop(self) -> None:
        import asyncio
        import time

        loop = asyncio.get_event_loop()
        while not self._torn_down:
            with self._get_lock:
                drained_all = self._next_get_idx >= self._next_exec_idx
            if drained_all:
                break

            def _drain_one():
                # bounded budget per round: the drainer must not camp on
                # _get_lock in a deadline-less read, or a concurrent sync
                # ref.get(timeout=...) could never honor its timeout
                with self._get_lock:
                    if self._next_get_idx >= self._next_exec_idx:
                        return
                    self._read_next_execution(time.monotonic() + 0.25)

            try:
                await loop.run_in_executor(None, _drain_one)
            except TimeoutError:  # partial drain; resume next round
                continue
            except Exception as e:  # noqa: BLE001 — closed channel /
                # buffer-cap RuntimeError: record it so waiters RAISE
                # instead of hanging on a silently-dead drainer
                self._drain_error = e
                break
            finally:
                self._pulse_waiters()
        self._pulse_waiters()

    def _pulse_waiters(self) -> None:
        """Wake every future waiting on any event loop (threadsafe)."""
        for lp, ev in list(self._result_waiters):
            try:
                lp.call_soon_threadsafe(ev.set)
            except RuntimeError:  # that loop is closed; its waiter is gone
                try:
                    self._result_waiters.remove((lp, ev))
                except ValueError:
                    pass

    def _read_next_execution(self, deadline) -> None:
        """Read one full execution's outputs (in pipeline order) into the
        result buffer.  Caller holds ``_get_lock``.  A timeout mid-way
        leaves the partially-drained values in ``_partial_values`` so the
        next attempt resumes from the first unread channel (each read
        consumes its ack slot — re-reading would desync the pipeline)."""
        import time

        if len(self._buffered_results) >= self.max_buffered_results:
            raise RuntimeError(
                f"{len(self._buffered_results)} executions are buffered "
                f"and unclaimed (max_buffered_results="
                f"{self.max_buffered_results}); get()/await results to "
                f"drain the pipeline")
        from ray_tpu_torch.experimental.channel import ChannelTimeoutError

        while len(self._partial_values) < len(self._output_channels):
            ch = self._output_channels[len(self._partial_values)]
            # read in bounded slices with a liveness probe between them:
            # a killed exec-loop actor never writes its out-edge, and
            # without the probe a deadline-less get() waits forever (a
            # deadlined one burns the full budget on a generic channel
            # timeout instead of naming the dead actor)
            while True:
                budget = (None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
                slice_budget = 0.25 if budget is None else min(0.25, budget)
                try:
                    value = ch.read(slice_budget)
                    break
                except ChannelTimeoutError:
                    self._check_actors_alive()
                    if budget is not None and \
                            time.monotonic() >= deadline:
                        raise
            self._partial_values.append(value)
        self._buffered_results[self._next_get_idx] = self._partial_values
        self._partial_values = []
        self._next_get_idx += 1

    def _deliver(self, values: List[Any]):
        err = next((v for v in values if isinstance(v, TaskError)), None)
        if err is not None:
            raise err
        if isinstance(self.root, MultiOutputNode):
            return values
        return values[0]

    def _get_result(self, ref: CompiledDAGRef, timeout: Optional[float]):
        import time

        if ref._has_result:
            raise ValueError("a CompiledDAGRef can only be gotten once")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._get_lock:
            while ref._idx not in self._buffered_results:
                self._read_next_execution(deadline)
            ref._has_result = True
            values = self._buffered_results.pop(ref._idx)
        return self._deliver(values)

    async def _await_result(self, idx: int):
        """Resolve one execution's result for ``CompiledDAGFuture``: the
        eager drainer buffers executions as they retire; this waits for
        ``idx``'s values on an event pulsed after every drained
        execution (with a short timeout re-check as a safety net), so
        futures resolve in any order — including from different event
        loops."""
        import asyncio

        loop = asyncio.get_event_loop()
        ev = asyncio.Event()
        self._result_waiters.append((loop, ev))
        try:
            while True:
                with self._get_lock:
                    if idx in self._buffered_results:
                        values = self._buffered_results.pop(idx)
                        return self._deliver(values)
                if self._torn_down:
                    raise RuntimeError("compiled DAG has been torn down")
                if self._drain_error is not None:
                    raise self._drain_error
                self._ensure_drainer()
                ev.clear()
                try:
                    await asyncio.wait_for(ev.wait(), timeout=0.25)
                except asyncio.TimeoutError:
                    pass  # re-check the buffer (missed-pulse safety net)
        finally:
            try:
                self._result_waiters.remove((loop, ev))
            except ValueError:
                pass

    # -- teardown ----------------------------------------------------------
    def teardown(self, *, timeout: float = 10.0) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        import time

        from ray_tpu_torch import actor as actor_mod

        try:
            self._input_channel.write(_STOP, timeout=min(1.0, timeout))
        except Exception:  # noqa: BLE001 — a dead reader: closed below
            pass
        # Close everything FIRST: un-gotten results leave exec loops blocked
        # writing to output channels that the driver will never read — close
        # unblocks them (ChannelClosedError exits the loop).
        for ch in self._all_channels:
            ch.close()
        deadline = time.monotonic() + timeout
        for handle in self._actors:
            while time.monotonic() < deadline:
                try:
                    st = actor_mod.get(handle._remote_call.remote(
                        _exec_loop_status, self.dag_id), timeout=5)
                except Exception:  # noqa: BLE001 — a dead actor
                    break
                if st["done"]:
                    break
                time.sleep(0.05)
        for group in self._collective_groups:
            refs = [inp.actor._remote_call.remote(
                _destroy_group, group.group_name) for inp in group.inputs]
            for ref in refs:
                try:
                    ref.get(timeout=5)
                except Exception:  # noqa: BLE001 - actor may be gone
                    pass
        for ch in self._driver_handles:
            ch.detach()
        for ch in self._all_channels:
            ch.destroy()

    def __del__(self):
        try:
            if not self._torn_down:
                for ch in self._all_channels:
                    ch.destroy()  # close + unlink: no shm leak on GC
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def _driver_device() -> str:
    """Where the driver lands what it reads: its current card once it has
    brought CUDA up (as ``local_endpoint_info`` reports it), else the
    host."""
    import torch

    if torch.cuda.is_initialized():
        return f"cuda:{torch.cuda.current_device()}"
    return "cpu"
