"""Port parity: the compiled-graph DAG over process actors
(``ray_tpu_torch.dag``, ``ray_tpu_torch.actor``).

Every case of ``tests/test_dag.py`` on the port's actors, with the same
graphs and the same expected values.  ``TestXlaMeshDagCollective``'s
``xla_mesh`` cases run on the single-process multi-card group
(``backend="mesh"``, ``CudaMeshGroup``) over host ranks; its ``xla``
multi-actor cases are JAX's device plane, whose port is the ``nccl``
backend that only the card runs (``chip_smoke.py dag4``), and here a case
checks that ``xla`` is refused and points at ``nccl``.  Then the port's own: the actor's process
lifecycle, ``create_collective_group`` over gloo, the endpoint probe, and
a compiled-DAG forward of a tiny Llama in two stage processes
(``chip_smoke.ForwardStage``) against JAX's ``llama_apply``.

One module-level set of CPU actors (each process imports torch, ~3 s;
they start together) serves the cases, reset where a case reads their
state; the death cases kill actors of their own from the set.  The
device tier's CPU emulation (``RAY_TPU_TORCH_DEVICE_EMULATE=1``) is on
for the module, so edges between actors negotiate tier B and tensor
payloads travel as device frames.  A watchdog kills every actor if the
module outlives ``WATCHDOG_S``.
"""

import asyncio
import os
import threading
import time
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_dag_actors as A
from ray_tpu.models import llama as jllama
from ray_tpu_torch import actor
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce
from ray_tpu_torch.dag import compiled_dag
from ray_tpu_torch.exceptions import ActorDiedError, TaskError
from ray_tpu_torch.experimental.channel import (Channel, ChannelClosedError,
                                                CompositeChannel,
                                                gather_endpoint_info)
from ray_tpu_torch.experimental.channel.transport import ENV_EMULATE_DEVICE
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax

WATCHDOG_S = 300


def _cpu(cls):
    return cls.options(device="cpu")


@pytest.fixture(scope="module")
def pool():
    """The module's actors, started together: adders, data-parallel
    workers, fused-run workers, two communicator actors (their
    constructors join one gloo group), sleepers to kill, and the tiny
    Llama's two forward stages."""
    old = os.environ.get(ENV_EMULATE_DEVICE)
    os.environ[ENV_EMULATE_DEVICE] = "1"
    spawned = []

    def spawn(cls, *args, **kwargs):
        h = _cpu(cls).remote(*args, **kwargs)
        spawned.append(h)
        return h

    def kill_all():
        for h in spawned:
            actor.kill(h)

    watchdog = threading.Timer(WATCHDOG_S, kill_all)
    watchdog.daemon = True
    watchdog.start()
    try:
        jcfg = jllama.LlamaConfig.tiny(num_layers=4)
        tcfg = tllama.LlamaConfig.tiny(num_layers=4)
        tree = jax.tree.map(np.asarray, jllama.llama_init(
            jax.random.PRNGKey(0), jcfg))
        params = params_from_jax(tree, tcfg, device="cpu")
        comm_name = f"comm-{uuid.uuid4().hex[:8]}"
        stage = actor.ActorClass(chip_smoke.ForwardStage)
        p = types.SimpleNamespace(
            adders=[spawn(A.Adder, 0) for _ in range(3)],
            dp=[spawn(A.DPWorker, s) for s in range(2)],
            jit=[spawn(A.JitWorker) for _ in range(2)],
            comm=[spawn(A.CommActor, r, 2, comm_name) for r in range(2)],
            sleepers=[spawn(A.Sleeper) for _ in range(5)],
            mesh=spawn(A.MeshOwner),
            stages=[spawn(stage, tcfg, 0, 2, params=params),
                    spawn(stage, tcfg, 2, 4, params=params)],
            jcfg=jcfg, tcfg=tcfg, tree=tree, params=params)
        actor.get([h._ready for h in spawned], timeout=240)
        yield p
    finally:
        watchdog.cancel()
        kill_all()
        if old is None:
            os.environ.pop(ENV_EMULATE_DEVICE, None)
        else:
            os.environ[ENV_EMULATE_DEVICE] = old


def _adders(pool, *incs):
    """The pool's adders, reset to ``incs`` (a fresh instance's state)."""
    hs = pool.adders[:len(incs)]
    actor.get([h.reset.remote(i) for h, i in zip(hs, incs)], timeout=30)
    return hs


def _dp_workers(pool):
    actor.get([w.reset.remote(s) for s, w in enumerate(pool.dp)],
              timeout=30)
    return pool.dp


def _jit(pool, n=1):
    hs = pool.jit[:n]
    actor.get([h.set_w.remote(torch.arange(4, dtype=torch.float32))
               for h in hs], timeout=30)
    return hs


def _sleeper(pool):
    return pool.sleepers.pop()


class TestChannel:
    def test_roundtrip_and_versioning(self):
        ch = Channel(buffer_size=1 << 16, num_readers=1)
        reader = Channel(ch.name, buffer_size=1 << 16, num_readers=1,
                         _create=False).set_reader_slot(0)
        ch.write({"a": np.arange(4)})
        out = reader.read()
        assert list(out["a"]) == [0, 1, 2, 3]
        ch.write(2)
        assert reader.read() == 2
        ch.destroy()

    def test_write_blocks_until_consumed(self):
        ch = Channel(buffer_size=1 << 12, num_readers=1)
        ch.write(1)
        with pytest.raises(TimeoutError):
            ch.write(2, timeout=0.2)
        ch.destroy()

    def test_closed_channel_raises(self):
        ch = Channel(buffer_size=1 << 12, num_readers=1)
        ch.close()
        with pytest.raises(ChannelClosedError):
            ch.read(timeout=1)
        ch.destroy()

    def test_oversize_payload_rejected(self):
        ch = Channel(buffer_size=64, num_readers=1)
        with pytest.raises(ValueError):
            ch.write_bytes(b"x" * 100)
        ch.destroy()


@actor.remote
def double(x):
    return 2 * x


class TestInterpretedDag:
    def test_function_and_method_nodes(self, pool):
        (a,) = _adders(pool, 10)
        with InputNode() as inp:
            dag = double.bind(a.add.bind(inp))
        ref = dag.execute(5)
        assert actor.get(ref) == 30

    def test_multi_output(self, pool):
        a, b = _adders(pool, 1, 2)
        with InputNode() as inp:
            dag = MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
        refs = dag.execute(10)
        assert actor.get(refs) == [11, 12]


class TestCompiledDag:
    def test_linear_pipeline(self, pool):
        a, b = _adders(pool, 1, 10)
        with InputNode() as inp:
            dag = b.add.bind(a.add.bind(inp))
        compiled = dag.experimental_compile()
        try:
            for i in range(5):
                ref = compiled.execute(i)
                assert ref.get(timeout=10) == i + 11
        finally:
            compiled.teardown()

    def test_fan_out_fan_in(self, pool):
        a, b, c = _adders(pool, 1, 2, 0)
        with InputNode() as inp:
            dag = c.add2.bind(a.add.bind(inp), b.add.bind(inp))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(10).get(timeout=10) == 23
            assert compiled.execute(0).get(timeout=10) == 3
        finally:
            compiled.teardown()

    def test_multi_output_compiled(self, pool):
        a, b = _adders(pool, 5, 7)
        with InputNode() as inp:
            dag = MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
        compiled = dag.experimental_compile()
        try:
            out = compiled.execute(1).get(timeout=10)
            assert out == [6, 8]
        finally:
            compiled.teardown()

    def test_input_attributes(self, pool):
        (a,) = _adders(pool, 0)
        with InputNode() as inp:
            dag = a.add2.bind(inp[0], inp.y)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(3, y=4).get(timeout=10) == 7
        finally:
            compiled.teardown()

    def test_same_actor_chain_short_circuits(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(a.add.bind(a.add.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(0).get(timeout=10) == 3
            assert set(compiled.stats()[
                "channel_transport"].values()) >= {"A-fused"}
        finally:
            compiled.teardown()
        assert actor.get(a.get_calls.remote()) == 3

    def test_error_propagation(self, pool):
        a, b = _adders(pool, 1, 1)
        with InputNode() as inp:
            dag = b.add.bind(a.boom.bind(inp))
        compiled = dag.experimental_compile()
        try:
            ref = compiled.execute(1)
            with pytest.raises(Exception, match="kapow"):
                ref.get(timeout=10)
            # DAG still usable after an application error
            ref2 = compiled.execute(2)
            with pytest.raises(TaskError, match="kapow"):
                ref2.get(timeout=10)
        finally:
            compiled.teardown()

    def test_numpy_payload_throughput(self, pool):
        (a,) = _adders(pool, 0.0)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile(buffer_size_bytes=1 << 22)
        try:
            x = np.ones((256, 256), np.float32)
            out = compiled.execute(x).get(timeout=10)
            np.testing.assert_allclose(out, x)
        finally:
            compiled.teardown()

    def test_get_out_of_order_buffered(self, pool):
        """Out-of-order gets are served by buffering earlier executions'
        results; each ref is still single-get."""
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()
        try:
            r1 = compiled.execute(1)
            r2 = compiled.execute(2)
            assert r2.get(timeout=10) == 3  # drains r1 into the buffer
            assert r1.get(timeout=10) == 2
            with pytest.raises(ValueError, match="gotten once"):
                r1.get(timeout=5)
        finally:
            compiled.teardown()

    def test_actor_reusable_after_teardown(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.execute(1).get(timeout=10) == 2
        compiled.teardown()
        assert actor.get(a.add.remote(5)) == 6

    def test_actor_revisit_a_b_a(self, pool):
        """A -> B -> A: lazy channel reads must not deadlock."""
        a, b = _adders(pool, 1, 10)
        with InputNode() as inp:
            dag = a.add.bind(b.add.bind(a.add.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(0).get(timeout=15) == 12
            assert compiled.execute(5).get(timeout=15) == 17
        finally:
            compiled.teardown()

    def test_teardown_with_ungotten_result_is_fast(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()
        compiled.execute(1)  # never gotten
        t0 = time.monotonic()
        compiled.teardown(timeout=10)
        assert time.monotonic() - t0 < 5

    def test_compile_rejects_input_independent_task(self, pool):
        a, b = _adders(pool, 1, 1)
        with InputNode() as inp:
            free = a.get_calls.bind()
            dag = b.add2.bind(inp, free)
        with pytest.raises(ValueError, match="depend"):
            dag.experimental_compile()


class TestCommunicator:
    def test_composite_channel(self):
        a = Channel(buffer_size=1 << 12, num_readers=1)
        b = Channel(buffer_size=1 << 12, num_readers=1)
        ra = Channel(a.name, buffer_size=1 << 12, num_readers=1,
                     _create=False)
        rb = Channel(b.name, buffer_size=1 << 12, num_readers=1,
                     _create=False)
        a.write(1)
        b.write("two")
        comp = CompositeChannel([ra, rb])
        assert comp.read(timeout=5) == (1, "two")
        comp.close()
        with pytest.raises(ChannelClosedError):
            a.write(3, timeout=1)
        a.destroy()
        b.destroy()

    def test_close_is_sticky_under_concurrent_write(self):
        # a writer completing its version bump must not "reopen" a channel
        # that was closed mid-write
        ch = Channel(buffer_size=1 << 12, num_readers=1)
        ch.write(1)  # unconsumed: next write will block on the ack
        state = {}

        def write2():
            try:
                ch.write(2, timeout=5)
                state["wrote"] = True
            except ChannelClosedError:
                state["closed"] = True

        t = threading.Thread(target=write2)
        t.start()
        time.sleep(0.2)  # writer is now blocked waiting for the ack
        ch.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert state.get("closed") and not state.get("wrote")
        reader = Channel(ch.name, buffer_size=1 << 12, num_readers=1,
                         _create=False)
        with pytest.raises(ChannelClosedError):
            reader.read(timeout=1)
        ch.destroy()

    @pytest.mark.parametrize("kind", ["cpu", "cuda"])
    def test_cpu_communicator_send_recv_allreduce(self, pool, kind):
        """``CpuCommunicator``'s case, and the same through
        ``CudaCommunicator`` (landing on the CPU here: it stages through
        the host either way) on the same group."""
        actors = pool.comm
        res = actor.get([a.allreduce.remote(kind) for a in actors],
                        timeout=60)
        np.testing.assert_allclose(res[0], np.full((3,), 3.0))
        out = actor.get([a.exchange.remote(kind) for a in actors],
                        timeout=60)
        np.testing.assert_allclose(out[1], [7.0])
        assert actor.get(actors[0].world.remote()) == 2


class TestCollectiveDag:
    def test_allreduce_sum(self, pool):
        a, b = _adders(pool, 1, 2)
        with InputNode() as inp:
            ga = a.add.bind(inp)   # x+1
            gb = b.add.bind(inp)   # x+2
            ra, rb = allreduce.bind([ga, gb])
            dag = MultiOutputNode([ra, rb])
        compiled = dag.experimental_compile()
        try:
            for x in (0, 5):
                out = compiled.execute(np.float32(x)).get(timeout=30)
                assert out[0] == out[1] == 2 * x + 3
        finally:
            compiled.teardown()

    def test_dp_training_step_with_overlap(self, pool):
        """A multi-actor DP training step as ONE compiled DAG: local grads,
        in-graph gradient allreduce (overlapped with independent compute),
        local apply.  Replicas stay bit-identical across steps."""
        w0, w1 = _dp_workers(pool)
        with InputNode() as inp:
            g0 = w0.grad.bind(inp)
            g1 = w1.grad.bind(inp)
            r0, r1 = allreduce.bind([g0, g1])
            # independent tasks between the collective and its consumer:
            # executed while the allreduce is in flight (overlap path —
            # the collective result is consumed LOCALLY by apply)
            aux0 = w0.busy_work.bind(inp)
            aux1 = w1.busy_work.bind(inp)
            dag = MultiOutputNode([w0.apply.bind(r0, aux0),
                                   w1.apply.bind(r1, aux1)])
        compiled = dag.experimental_compile()
        try:
            for step in range(4):
                (wa, auxa), (wb, auxb) = compiled.execute(step).get(
                    timeout=30)
                assert np.allclose(wa, wb), (step, wa, wb)
                assert auxa == auxb == step * 2.0
            final = actor.get([w0.weights.remote(), w1.weights.remote()])
            assert np.allclose(final[0], final[1])
            assert np.abs(final[0]).sum() > 0  # training actually moved
        finally:
            compiled.teardown()

    def test_collective_needs_distinct_actors(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            ga = a.add.bind(inp)
            gb = a.add.bind(inp)
            with pytest.raises(ValueError, match="distinct actors"):
                allreduce.bind([ga, gb])

    def test_collective_requires_all_ranks_bound(self, pool):
        a, b = _adders(pool, 1, 2)
        with InputNode() as inp:
            ra, rb = allreduce.bind([a.add.bind(inp), b.add.bind(inp)])
            dag = ra  # rank 1's output dropped: would deadlock at runtime
        with pytest.raises(ValueError, match="bind ALL"):
            dag.experimental_compile()

    @pytest.mark.parametrize("backend", ["xla", "xla_mesh"])
    def test_jax_backends_refused_naming_nccl(self, pool, backend):
        """The reference's ``TestXlaMeshDagCollective`` backends over two
        actors: ``xla`` is JAX's rank-per-process device plane, refused at
        bind and pointing at ``nccl``; ``xla_mesh`` is the single-process
        group, refused over two actors at compile as
        ``test_xla_mesh_rejects_multi_actor`` expects."""
        a, b = _adders(pool, 1, 2)
        with InputNode() as inp:
            if backend == "xla":
                with pytest.raises(ValueError, match="nccl"):
                    allreduce.bind([a.add.bind(inp), b.add.bind(inp)],
                                   backend=backend)
                return
            r0, r1 = allreduce.bind([a.add.bind(inp), b.add.bind(inp)],
                                    backend=backend)
            dag = MultiOutputNode([a.add.bind(r0), b.add.bind(r1)])
        with pytest.raises(Exception, match="xla_mesh|world_size"):
            compiled = dag.experimental_compile()
            try:
                compiled.execute(0).get(timeout=30)
            finally:
                compiled.teardown()


class TestMeshDagCollective:
    """The reference's ``TestXlaMeshDagCollective`` mesh-owner case: one
    actor owns the group's ranks (eight host ranks here, as the
    reference's eight CPU devices); the collective node's op is the mesh
    group's allreduce, and the value reaches the next method in the
    actor's process without a pickle."""

    def test_in_process_mesh_allreduce_stays_in_process(self, pool):
        from ray_tpu.util.collective.collective_group.xla_group import (
            XlaMeshGroup)

        want = float(np.asarray(XlaMeshGroup(8).allreduce(
            np.arange(8, dtype=np.float32)[:, None]))[0])
        assert want == 28.0  # sum 0..7
        w = pool.mesh
        with InputNode() as inp:
            s = w.shards.bind(inp)
            (r,) = allreduce.bind([s], backend="xla_mesh",
                                  devices=["cpu"] * 8)
            dag = w.consume.bind(r)
        compiled = dag.experimental_compile()
        try:
            for i in range(2):  # two iterations: the group is reusable
                value, ranks, groups = compiled.execute(i).get(timeout=60)
                assert (value, ranks) == (want, 8)
                assert "CudaMeshGroup" in groups, groups
        finally:
            compiled.teardown()

    @pytest.mark.parametrize("op,want", [("max", 7.0), ("min", 0.0),
                                         ("prod", 0.0)])
    def test_mesh_allreduce_ops(self, pool, op, want):
        w = pool.mesh
        with InputNode() as inp:
            (r,) = allreduce.bind([w.shards.bind(inp)], op=op,
                                  backend="mesh", devices=["cpu"] * 8)
            dag = w.consume.bind(r)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(0).get(timeout=60)[:2] == (want, 8)
        finally:
            compiled.teardown()


def _single_spec(compiled):
    (spec,) = compiled._exec_specs.values()
    return spec


class TestJitFusion:
    def test_adjacent_jit_chain_fuses_into_one_task(self, pool):
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            b = w.scale.options(jit=True).bind(a)
            dag = w.addw.options(jit=True).bind(b)
        compiled = dag.experimental_compile()
        try:
            tasks = _single_spec(compiled)["tasks"]
            assert len(tasks) == 1
            assert len(tasks[0]["fused"]) == 3
            x = np.ones(4, np.float32)
            out = compiled.execute(x).get(timeout=90)
            np.testing.assert_allclose(
                np.asarray(out), x * 4.0 + np.arange(4, dtype=np.float32))
            out2 = compiled.execute(2 * x).get(timeout=90)
            np.testing.assert_allclose(
                np.asarray(out2), x * 8.0 + np.arange(4, dtype=np.float32))
        finally:
            compiled.teardown()

    def test_fused_teardown_is_fast(self, pool):
        """Teardown closes a fused run's channels under it: its exec loop
        must end at once (the reference's loop catches the closed
        channel's error inside the fused task and spins until teardown's
        timeout)."""
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            dag = w.addw.options(jit=True).bind(a)
        compiled = dag.experimental_compile()
        compiled.execute(np.ones(4, np.float32)).get(timeout=30)
        t0 = time.monotonic()
        compiled.teardown(timeout=10)
        assert time.monotonic() - t0 < 2.0
        status = w._remote_call.remote(
            compiled_dag._exec_loop_status, compiled.dag_id).get(timeout=30)
        assert status == {"done": True, "error": None}

    def test_fused_run_sees_mutated_actor_state(self, pool):
        """Divergence by design: the fused run executes eagerly, so a
        method reads the actor's state as it is now (the reference's
        ``jax.jit`` froze it at trace time)."""
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            dag = w.addw.options(jit=True).bind(a)
        compiled = dag.experimental_compile()
        try:
            x = np.zeros(4, np.float32)
            np.testing.assert_allclose(
                compiled.execute(x).get(timeout=30), np.arange(4))
            actor.get(w.set_w.remote(torch.ones(4)), timeout=30)
            np.testing.assert_allclose(
                compiled.execute(x).get(timeout=30), np.ones(4))
        finally:
            compiled.teardown()

    def test_mid_run_value_consumed_by_later_task(self, pool):
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            b = w.scale.options(jit=True).bind(a)
            dag = w.combine.bind(a, b)  # non-jit task consumes mid local
        compiled = dag.experimental_compile()
        try:
            tasks = _single_spec(compiled)["tasks"]
            assert len(tasks) == 2  # fused(a,b) + combine
            assert len(tasks[0]["fused"]) == 2
            assert len(tasks[0]["emit"]) == 2  # a and b both leave the run
            x = np.ones(4, np.float32)
            out = compiled.execute(x).get(timeout=90)
            np.testing.assert_allclose(np.asarray(out), x * 2.0 + x * 4.0)
        finally:
            compiled.teardown()

    def test_fused_error_propagates_and_dag_survives(self, pool):
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            dag = w.boom.options(jit=True).bind(a)
        compiled = dag.experimental_compile()
        try:
            with pytest.raises(Exception, match="kapow"):
                compiled.execute(np.ones(4, np.float32)).get(timeout=90)
            with pytest.raises(Exception, match="kapow"):
                compiled.execute(np.ones(4, np.float32)).get(timeout=90)
        finally:
            compiled.teardown()

    def test_read_after_write_guard_splits_aba_run(self, pool):
        # A's second jit task reads B's output, which depends on A's first
        # task's out-channel: fusing them would hoist the read before the
        # write and deadlock — the compiler must split the run.
        wa, wb = _jit(pool, 2)
        with InputNode() as inp:
            a1 = wa.scale.options(jit=True).bind(inp)
            b1 = wb.scale.bind(a1)
            dag = wa.combine.options(jit=True).bind(a1, b1)
        compiled = dag.experimental_compile()
        try:
            spec_a = compiled._exec_specs[wa._actor_id]
            assert len(spec_a["tasks"]) == 2  # NOT fused across the B read
            x = np.ones(4, np.float32)
            out = compiled.execute(x).get(timeout=90)
            np.testing.assert_allclose(np.asarray(out), x * 6.0)
        finally:
            compiled.teardown()

    def test_fused_terminals_multi_output(self, pool):
        (w,) = _jit(pool)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            b = w.addw.options(jit=True).bind(a)
            dag = MultiOutputNode([a, b])
        compiled = dag.experimental_compile()
        try:
            x = np.ones(4, np.float32)
            oa, ob = compiled.execute(x).get(timeout=90)
            np.testing.assert_allclose(np.asarray(oa), x * 2.0)
            np.testing.assert_allclose(
                np.asarray(ob), x * 2.0 + np.arange(4, dtype=np.float32))
        finally:
            compiled.teardown()

    def test_fused_sibling_survives_subtask_error(self, pool):
        # Unfused, only boom's output errors; fused must match: `a` still
        # delivers its VALUE downstream — observable because the Adder
        # consumer actually runs (an upstream TaskError would skip it).
        (w,) = _jit(pool)
        (consumer,) = _adders(pool, 1)
        with InputNode() as inp:
            a = w.scale.options(jit=True).bind(inp)
            b = w.boom.options(jit=True).bind(a)
            dag = MultiOutputNode([consumer.add.bind(a), b])
        compiled = dag.experimental_compile()
        try:
            spec_w = compiled._exec_specs[w._actor_id]
            assert len(spec_w["tasks"]) == 1
            assert len(spec_w["tasks"][0]["fused"]) == 2
            ref = compiled.execute(np.ones(4, np.float32))
            with pytest.raises(Exception, match="kapow"):
                ref.get(timeout=90)
        finally:
            compiled.teardown()
        # consumer.add ran on a's real value (not a poisoned TaskError)
        assert actor.get(consumer.get_calls.remote()) == 1

    def test_fused_bad_input_errors_instead_of_hanging(self, pool):
        # resolve() of the whole-input argspec raises TypeError when
        # execute() got multiple args; the error must reach the driver
        # through the emit channels
        (w,) = _jit(pool)
        with InputNode() as inp:
            dag = w.scale.options(jit=True).bind(inp)
        compiled = dag.experimental_compile()
        try:
            ref = compiled.execute(1, 2)
            with pytest.raises(Exception, match="multiple"):
                ref.get(timeout=90)
        finally:
            compiled.teardown()


class TestExecuteAsync:
    def test_execute_async_basic(self, pool):
        (a,) = _adders(pool, 10)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()

        async def main():
            fut = await compiled.execute_async(5)
            return await fut

        try:
            assert asyncio.run(main()) == 15
        finally:
            compiled.teardown()

    def test_execute_async_pipelined_out_of_order(self, pool):
        """N>1 in-flight executions; futures awaited out of submission
        order resolve correctly."""
        (a,) = _adders(pool, 100)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()

        async def main():
            futs = [await compiled.execute_async(i) for i in range(4)]
            # await in reverse order: earlier results must buffer
            out = []
            for f in reversed(futs):
                out.append(await f)
            return out

        try:
            assert asyncio.run(main()) == [103, 102, 101, 100]
        finally:
            compiled.teardown()

    def test_execute_async_concurrent_awaiters_overlap(self, pool):
        """Two concurrent tasks drive the same DAG without blocking the
        event loop — their iterations interleave."""
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()

        async def worker(base, n):
            out = []
            for k in range(n):
                fut = await compiled.execute_async(base + k)
                out.append(await fut)
            return out

        async def main():
            r1, r2 = await asyncio.gather(worker(0, 3), worker(1000, 3))
            return r1, r2

        try:
            r1, r2 = asyncio.run(main())
            assert r1 == [1, 2, 3]
            assert r2 == [1001, 1002, 1003]
        finally:
            compiled.teardown()

    def test_execute_async_error_propagates(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.boom.bind(inp)
        compiled = dag.experimental_compile()

        async def main():
            fut = await compiled.execute_async(1)
            return await fut

        try:
            with pytest.raises(Exception, match="kapow"):
                asyncio.run(main())
        finally:
            compiled.teardown()

    def test_future_single_await(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()

        async def main():
            fut = await compiled.execute_async(1)
            v = await fut
            try:
                await fut
            except ValueError as e:
                return v, str(e)
            return v, None

        try:
            v, err = asyncio.run(main())
            assert v == 2 and err and "awaited once" in err
        finally:
            compiled.teardown()


class TestMixedSyncAsync:
    def test_sync_get_out_of_order_with_buffer(self, pool):
        (a,) = _adders(pool, 1)
        with InputNode() as inp:
            dag = a.add.bind(inp)
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(3)]
            assert refs[2].get(timeout=10) == 3
            assert refs[0].get(timeout=10) == 1
            assert refs[1].get(timeout=10) == 2
        finally:
            compiled.teardown()


class TestActorDeathMidExecute:
    """A killed DAG actor must surface a clean error from
    ``CompiledDAGRef.get`` — including a deadline-less get — and leave
    ``teardown()`` able to complete promptly."""

    def _slow_dag(self, pool):
        a = _sleeper(pool)
        with InputNode() as inp:
            dag = a.slow.bind(inp)
        return a, dag.experimental_compile()

    def test_get_surfaces_clean_error_and_teardown_completes(self, pool):
        a, compiled = self._slow_dag(pool)
        try:
            ref = compiled.execute(1)
            time.sleep(0.3)
            actor.kill(a)
            t0 = time.monotonic()
            # deadline-less get: without liveness probing this hangs
            # forever on a channel no exec loop will ever write
            with pytest.raises(ActorDiedError, match="died mid-execution"):
                ref.get()
            assert time.monotonic() - t0 < 10.0
            # the pipeline is poisoned: further submits refuse fast
            # instead of wedging in the input-channel write
            with pytest.raises(ActorDiedError):
                compiled.execute(2)
        finally:
            t0 = time.monotonic()
            compiled.teardown(timeout=10)
            # teardown observed the dead exec loop and returned promptly
            assert time.monotonic() - t0 < 8.0

    def test_deadlined_get_names_the_dead_actor(self, pool):
        a, compiled = self._slow_dag(pool)
        try:
            ref = compiled.execute(1)
            time.sleep(0.3)
            actor.kill(a)
            t0 = time.monotonic()
            with pytest.raises(ActorDiedError, match="Sleeper"):
                ref.get(timeout=30)
            # the probe fires well before the 30s deadline
            assert time.monotonic() - t0 < 10.0
        finally:
            compiled.teardown(timeout=10)

    def test_async_future_surfaces_death(self, pool):
        a, compiled = self._slow_dag(pool)

        async def drive():
            fut = await compiled.execute_async(1)
            await asyncio.sleep(0.3)
            actor.kill(a)
            return await fut

        try:
            with pytest.raises(ActorDiedError):
                asyncio.run(asyncio.wait_for(drive(), timeout=30))
        finally:
            compiled.teardown(timeout=10)


class TestEdgeHooks:
    """Every channel read books its wait to the ``channel_wait`` bucket
    and to the health plane's edge-latency table, in the actor processes
    (exec loops) and in the driver (output reads), as the reference's
    transport does (``ray_tpu/experimental/channel/transport.py:372-448``).
    """

    EXECS = 5

    def test_channel_wait_and_edges_match_the_reference(self, pool,
                                                        ray_start):
        import ray_tpu
        from ray_tpu._private import tracing as jtracing
        from ray_tpu.dag import InputNode as JInputNode
        from ray_tpu.util import health as jhealth
        from ray_tpu_torch._private import durations
        from ray_tpu_torch.util import health as thealth

        @ray_tpu.remote
        class JAdder:
            def __init__(self, inc):
                self.inc = inc

            def add(self, x):
                return x + self.inc

        def j_arm(instance):
            from ray_tpu._private import tracing
            from ray_tpu.util import health

            notes = []
            instance._hook_notes = notes
            instance._hook_token = tracing.register_duration_sink(
                lambda bucket, dt: notes.append(dt)
                if bucket == "channel_wait" else None)
            health.reset_edge_latency()
            return True

        def j_read(instance):
            from ray_tpu._private import tracing
            from ray_tpu.util import health

            tracing.unregister_duration_sink(instance._hook_token)
            return {"channel_wait": len(instance._hook_notes),
                    "edges": health.edge_latency_snapshot()}

        def run(handles, input_node, arm, read, sink, health, get):
            """The two-actor chain, EXECS executions; the notes and edges
            of each actor and of the driver, actor ids named a and b."""
            a, b = handles
            names = {a._actor_id.hex()[:6]: "a", b._actor_id.hex()[:6]: "b"}
            with input_node() as inp:
                dag = b.add.bind(a.add.bind(inp))
            compiled = dag.experimental_compile()
            notes = []
            token = sink.register_duration_sink(
                lambda bucket, dt: notes.append(dt)
                if bucket == "channel_wait" else None)
            try:
                health.reset_edge_latency()
                get([h._remote_call.remote(arm) for h in handles])
                outs = [compiled.execute(i).get(timeout=30)
                        for i in range(self.EXECS)]
                got = dict(zip("ab", get(
                    [h._remote_call.remote(read) for h in handles])))
                got["driver"] = {"channel_wait": len(notes),
                                 "edges": health.edge_latency_snapshot()}
            finally:
                sink.unregister_duration_sink(token)
                compiled.teardown()

            def rename(edge):
                for hexid, name in names.items():
                    edge = edge.replace(hexid, name)
                return edge

            return outs, {who: {"channel_wait": g["channel_wait"],
                                "edges": {rename(e): st["count"]
                                          for e, st in g["edges"].items()}}
                          for who, g in got.items()}

        jhandles = [JAdder.remote(1), JAdder.remote(2)]
        ref = run(jhandles, JInputNode, j_arm, j_read, jtracing, jhealth,
                  lambda refs: ray_tpu.get(refs, timeout=60))
        port = run(_adders(pool, 1, 2), InputNode, A.arm_channel_hooks,
                   A.read_channel_hooks, durations, thealth,
                   lambda refs: actor.get(refs, timeout=60))
        for h in jhandles:
            ray_tpu.kill(h)
        assert port == ref
        n = self.EXECS
        assert port[0] == [i + 3 for i in range(n)]
        assert port[1] == {
            "a": {"channel_wait": n, "edges": {"input->@a": n}},
            "b": {"channel_wait": n, "edges": {"add@a->@b": n}},
            "driver": {"channel_wait": n, "edges": {"add@b->driver": n}}}


class TestProcessActors:
    """The port's actor: a process per instance, calls in order, death by
    name, ref arguments resolved before the call."""

    def test_calls_run_in_submission_order(self, pool):
        (a,) = _adders(pool, 1)
        refs = [a.add.remote(i) for i in range(50)]
        assert actor.get(refs, timeout=30) == [i + 1 for i in range(50)]
        assert actor.get(a.get_calls.remote(), timeout=30) == 50

    def test_ref_arguments_resolve_across_actors(self, pool):
        a, b = _adders(pool, 1, 10)
        assert actor.get(b.add.remote(a.add.remote(5)), timeout=30) == 16

    def test_error_is_task_error_and_fails_dependents(self, pool):
        a, b = _adders(pool, 1, 1)
        bad = a.boom.remote(1)
        with pytest.raises(TaskError, match="ValueError: kapow"):
            bad.get(timeout=30)
        with pytest.raises(TaskError, match="kapow"):
            b.add.remote(bad).get(timeout=30)
        assert actor.get(b.get_calls.remote(), timeout=30) == 0

    def test_remote_call_runs_in_the_actor_process(self, pool):
        (a,) = _adders(pool, 7)
        got = a._remote_call.remote(A.pid_and_inc).get(timeout=30)
        assert got == (a._pid, 7)
        assert a._pid != os.getpid()

    def test_killed_actor_fails_pending_and_later_calls(self, pool):
        s = _sleeper(pool)
        pending = s.slow.remote(1)
        time.sleep(0.3)
        actor.kill(s)
        with pytest.raises(ActorDiedError, match="Sleeper.*killed"):
            pending.get(timeout=10)
        with pytest.raises(ActorDiedError):
            s.slow.remote(2).get(timeout=10)

    def test_constructor_failure_is_actor_death(self):
        h = _cpu(A.Adder).remote()  # __init__ needs inc
        with pytest.raises(ActorDiedError, match="constructor raised"):
            h.add.remote(1).get(timeout=120)

    def test_local_class_and_unknown_method_refused(self, pool):
        class Local:
            pass

        with pytest.raises(TypeError, match="top level"):
            _cpu(actor.remote(Local)).remote()
        with pytest.raises(AttributeError, match="no method"):
            pool.adders[0].nope

    def test_card_actor_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA: a card actor would start")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            A.Adder.remote(1)

    def test_gather_endpoint_info_probes_each_actor(self, pool):
        a, b = _adders(pool, 0, 0)
        infos = gather_endpoint_info([a, b], timeout=30)
        assert {infos[a._actor_id].pid, infos[b._actor_id].pid} == {
            a._pid, b._pid}
        # the module runs the device tier's CPU emulation
        assert infos[a._actor_id].platform == "cpu"

    def test_unpicklable_result_is_an_error_not_a_death(self, pool):
        (a,) = _adders(pool, 1)
        with pytest.raises(TaskError, match="(?i)pickle"):
            a.unpicklable.remote().get(timeout=30)
        assert a.add.remote(1).get(timeout=30) == 2

    def test_create_collective_group_with_a_dead_member_fails(self, pool):
        """A member that died before it joined fails the call within the
        group's timeout, and the member that joined leaves again."""
        from ray_tpu_torch.util import collective as col

        (a,) = _adders(pool, 0)
        dead = _sleeper(pool)
        actor.kill(dead)
        name = f"g-{uuid.uuid4().hex[:8]}"
        t0 = time.monotonic()
        # the live member's rendezvous times out, or the dead one's join
        # fails first: either way the call raises
        with pytest.raises((ActorDiedError, TaskError)):
            col.create_collective_group([a, dead], 2, backend="tcp",
                                        group_name=name, timeout_s=3)
        assert time.monotonic() - t0 < 20
        assert a._remote_call.remote(A.in_group, name).get(
            timeout=30) is False

    def test_create_collective_group_over_gloo(self, pool):
        from ray_tpu_torch.util import collective as col

        a, b = _adders(pool, 0, 0)
        name = f"g-{uuid.uuid4().hex[:8]}"
        col.create_collective_group([a, b], 2, backend="tcp",
                                    group_name=name)
        refs = [h._remote_call.remote(A.allreduce_rank, name)
                for h in (a, b)]
        np.testing.assert_array_equal(actor.get(refs, timeout=60),
                                      [[1.0, 1.0], [1.0, 1.0]])
        actor.get([h._remote_call.remote(A.leave_group, name)
                   for h in (a, b)], timeout=60)


class TestLlamaStages:
    """A tiny Llama (4 layers, fp32) as two stage processes under the
    device tier's emulation, against JAX."""

    def test_stage_params_equal_llama_init_slices(self):
        cfg = tllama.LlamaConfig.tiny(num_layers=4)
        whole = tllama.llama_init(cfg, seed=3, device="cpu")
        for lo, hi in ((0, 2), (2, 4), (1, 3)):
            part = chip_smoke.stage_params(cfg, lo, hi, seed=3,
                                           device="cpu")
            want = chip_smoke.stage_slice(whole, lo, hi, 4)
            got = dict(chip_smoke.tree_items(part))
            assert got.keys() == want.keys()
            for p in want:
                assert torch.equal(got[p], want[p]), p

    def test_compiled_forward_matches_jax_llama_apply(self, pool):
        """``inp -> stage0.forward -> stage1.forward`` on the JAX weights:
        the last position's logits within fp32's 1e-5 of JAX's (four tiny
        layers, sums in another order), the argmax tokens equal, and each
        edge on the device tier."""
        s0, s1 = pool.stages
        with InputNode() as inp:
            dag = s1.forward.bind(s0.forward.bind(inp))
        compiled = dag.experimental_compile()
        try:
            rng = np.random.default_rng(0)
            for _ in range(2):
                tokens = rng.integers(0, 256, size=(1, 24)).astype(np.int32)
                out = compiled.execute(torch.from_numpy(tokens)).get(
                    timeout=60)
                want = np.asarray(jllama.llama_apply(
                    pool.tree, jnp.asarray(tokens), pool.jcfg))
                np.testing.assert_allclose(out["last_logits"].numpy(),
                                           want[:, -1], atol=1e-5,
                                           rtol=1e-5)
                np.testing.assert_array_equal(out["tokens"].numpy(),
                                              want.argmax(-1))
                one = tllama.llama_apply(pool.params,
                                         torch.from_numpy(tokens),
                                         pool.tcfg)
                assert torch.equal(out["last_logits"], one[:, -1])
            stats = compiled.stats()
            assert set(stats["channel_transport"].values()) == {"B-device"}
            edge = next(st for edges in stats["actor_channels"].values()
                        for e, st in edges.items()
                        if e.startswith("forward@") and st["side"] == "read")
            assert edge["recvs"] == 2
        finally:
            compiled.teardown()
