"""Port parity: the single-process multi-card group
(``ray_tpu_torch/util/collective/collective_group/mesh_group.py``,
``CudaMeshGroup``) against the reference's ``XlaMeshGroup``.

The same numpy inputs, made from a seed, go through ``XlaMeshGroup(4)``
on four of JAX's CPU devices (``tests/conftest.py`` forces eight) and
through ``CudaMeshGroup`` on four host ranks, which run the ops' plain
versions (``permute`` through K4's wrapper, whose plain version serves
host tensors).  JAX returns one array, replicated or sharded over the
ranks on dim 0; the port returns one tensor per rank, so a replicated
result is compared on every rank and a sharded one row by row.

Tolerances: exact on integer-valued fp32 inputs (every sum, product,
max and min of them is exact in fp32); rtol 1e-6 on random fp32, whose
sums XLA's reduction may add in another order than the plain version's
sum over the ranks.  The collective front (``init_collective_group``
with ``backend="mesh"``) runs through ``SupervisedGroup`` and is held to
the reference's front on eight ranks.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.util.collective import collective as jcoll
from ray_tpu.util.collective.collective_group.xla_group import XlaMeshGroup
from ray_tpu.util.collective.types import ReduceOp as JOp
from ray_tpu_torch.ops.cuda import remote_copy as k4
from ray_tpu_torch.util.collective import collective as tcoll
from ray_tpu_torch.util.collective.collective_group import mesh_group as mg
from ray_tpu_torch.util.collective.collective_group.mesh_group import (
    CudaMeshGroup,
)
from ray_tpu_torch.util.collective.supervision import SupervisedGroup
from ray_tpu_torch.util.collective.types import ReduceOp as TOp

N = 4
HOST = ["cpu"] * N
OPS = ["sum", "max", "min", "product"]


@pytest.fixture(scope="module")
def groups():
    return (XlaMeshGroup(N, devices=jax.devices()[:N]),
            CudaMeshGroup(N, devices=HOST))


def _ints(seed, shape):
    """Integer-valued fp32 in [-3, 3], zeros included."""
    return np.random.default_rng(seed).integers(
        -3, 4, size=shape).astype(np.float32)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_on_every_rank(got, want, rtol=0.0):
    assert isinstance(got, list) and len(got) == N
    for t in got:
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=rtol,
                                   atol=0)


def _rows(got, want, rtol=0.0):
    """A result sharded over the ranks: rank i's tensor is row i."""
    want = np.asarray(want)
    assert isinstance(got, list) and len(got) == N
    for i, t in enumerate(got):
        np.testing.assert_allclose(t.numpy(), want[i], rtol=rtol, atol=0)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_exact_on_integer_values(groups, op):
    jg, tg = groups
    x = _ints(1, (N, 3, 5))
    _same_on_every_rank(tg.allreduce(x, TOp(op)), jg.allreduce(x, JOp(op)))


@pytest.mark.parametrize("op", OPS)
def test_allreduce_random_fp32(groups, op):
    jg, tg = groups
    x = _rand(2, (N, 4, 6))
    _same_on_every_rank(tg.allreduce(x, TOp(op)), jg.allreduce(x, JOp(op)),
                        rtol=1e-6)


def test_allreduce_product_over_zeros_and_negatives(groups):
    """PRODUCT is a true product: a zero anywhere gives 0, the sign is the
    parity of the negatives (an exp-sum-log product would miss both)."""
    jg, tg = groups
    x = np.array([[0.0, -2.0, 3.0, -1.0], [5.0, -2.0, -3.0, -1.0],
                  [1.0, 2.0, -0.5, -1.0], [-4.0, 0.5, 2.0, -1.0]],
                 np.float32)
    want = np.asarray(jg.allreduce(x, JOp.PRODUCT))
    np.testing.assert_array_equal(want, [0.0, 4.0, 9.0, 1.0])
    _same_on_every_rank(tg.allreduce(x, TOp.PRODUCT), want)


def test_reduce_is_allreduce(groups):
    jg, tg = groups
    x = _ints(3, (N, 7))
    _same_on_every_rank(tg.reduce(x, dst_rank=2), jg.reduce(x, dst_rank=2))


@pytest.mark.parametrize("src", range(N))
def test_broadcast_from_each_source(groups, src):
    jg, tg = groups
    x = _rand(4, (N, 2, 3))
    _rows(tg.broadcast(x, src), jg.broadcast(x, src))


def test_allgather(groups):
    jg, tg = groups
    x = _rand(5, (N, 3))
    _same_on_every_rank(tg.allgather(x), jg.allgather(x))


def test_reducescatter(groups):
    jg, tg = groups
    x = _ints(6, (N, N, 5))
    _rows(tg.reducescatter(x), jg.reducescatter(x))


def test_reducescatter_random_fp32(groups):
    jg, tg = groups
    x = _rand(7, (N, N, 3))
    _rows(tg.reducescatter(x), jg.reducescatter(x), rtol=1e-6)


@pytest.mark.parametrize("perm", [
    [(i, (i + 1) % N) for i in range(N)],
    [(i, (i + 3) % N) for i in range(N)],
    [(0, 1), (2, 3)],
    [(3, 0)],
    [(1, 1)],
    [],
], ids=["ring1", "ring3", "partial", "one_pair", "self", "empty"])
def test_permute(groups, perm):
    """``ppermute``: rank dst gets src's row, ranks no pair sends to get
    zeros; each pair is one call of K4's wrapper (its plain version on
    host ranks)."""
    jg, tg = groups
    x = _rand(8, (N, 4, 4)) + 10.0  # no zero rows of its own
    calls = []
    plain = k4.remote_copy_plain

    def counted(src, dst):
        calls.append(1)
        plain(src, dst)

    k4.remote_copy_plain = counted
    try:
        got = tg.permute(x, perm)
    finally:
        k4.remote_copy_plain = plain
    assert len(calls) == len(perm)
    _rows(got, jg.permute(x, perm))
    receivers = {d for _, d in perm}
    for i in set(range(N)) - receivers:
        assert not got[i].any()
    np.testing.assert_array_equal(
        torch.stack(got).numpy(),
        torch.stack(mg.permute_plain(list(torch.from_numpy(x)), perm)).numpy())


def test_list_input_is_one_tensor_per_rank(groups):
    jg, tg = groups
    x = _ints(9, (N, 6))
    shards = [torch.from_numpy(r.copy()) for r in x]
    _same_on_every_rank(tg.allreduce(shards), jg.allreduce(x))
    _rows(tg.permute(shards, [(0, 2)]), jg.permute(x, [(0, 2)]))
    # the caller's tensors are inputs only
    np.testing.assert_array_equal(torch.stack(shards).numpy(), x)


def test_plain_versions(groups):
    jg, _ = groups
    x = _ints(10, (N, 3))
    shards = list(torch.from_numpy(x))
    for op in OPS:
        np.testing.assert_array_equal(
            mg.allreduce_plain(shards, TOp(op)).numpy(),
            np.asarray(jg.allreduce(x, JOp(op))))
    np.testing.assert_array_equal(mg.allgather_plain(shards).numpy(),
                                  np.asarray(jg.allgather(x)))
    np.testing.assert_array_equal(
        torch.stack(mg.broadcast_plain(shards, 1)).numpy(),
        np.asarray(jg.broadcast(x, 1)))
    y = _ints(11, (N, N, 2))
    np.testing.assert_array_equal(
        torch.stack(mg.reducescatter_plain(list(torch.from_numpy(y))))
        .numpy(), np.asarray(jg.reducescatter(y)))


def test_barrier(groups):
    jg, tg = groups
    jg.barrier()
    assert tg.barrier() is None


# -- error cases ---------------------------------------------------------------
def test_fewer_devices_than_world_size_raises():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        XlaMeshGroup(8, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        CudaMeshGroup(8, devices=HOST)


def test_reducescatter_only_sums(groups):
    jg, tg = groups
    x = _ints(12, (N, N, 2))
    for op in ("max", "min", "product"):
        with pytest.raises(NotImplementedError, match="SUM"):
            jg.reducescatter(x, JOp(op))
        with pytest.raises(NotImplementedError, match="SUM"):
            tg.reducescatter(x, TOp(op))


@pytest.mark.parametrize("which", ["send", "recv"])
def test_point_to_point_points_at_permute(groups, which):
    jg, tg = groups
    for g in (jg, tg):
        with pytest.raises(NotImplementedError, match="permute"):
            if which == "send":
                g.send(np.zeros(2, np.float32), 1)
            else:
                g.recv((2,), np.float32, 0)


@pytest.mark.parametrize("perm", [[(0, 1), (2, 1)], [(0, 1), (0, 2)]],
                         ids=["dst_twice", "src_twice"])
def test_permute_refuses_a_repeated_rank(groups, perm):
    jg, tg = groups
    x = _rand(13, (N, 2))
    with pytest.raises(ValueError, match="unique"):
        jg.permute(x, perm)
    with pytest.raises(ValueError, match="repeats"):
        tg.permute(x, perm)


def test_permute_refuses_a_rank_outside_the_group(groups):
    jg, tg = groups
    x = _rand(14, (N, 2))
    with pytest.raises(IndexError):
        jg.permute(x, [(0, N + 1)])
    with pytest.raises(ValueError, match="outside"):
        tg.permute(x, [(0, N + 1)])


def test_stacked_input_needs_a_row_per_rank(groups):
    jg, tg = groups
    x = _rand(15, (N - 1, 2))
    with pytest.raises(ValueError):
        jg.allreduce(x)
    with pytest.raises(ValueError, match="rows on dim 0"):
        tg.allreduce(x)


def test_a_card_named_twice_is_refused():
    """JAX's mesh over a doubled device fails at its first op; the port
    refuses the group itself."""
    jg = XlaMeshGroup(2, devices=[jax.devices()[0]] * 2)
    with pytest.raises(ValueError):
        jg.allreduce(np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="named twice"):
        mg._resolve_devices(2, ["cuda:0", "cuda:0"])


def test_no_cuda_and_no_devices_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaMeshGroup(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaMeshGroup(1, devices=["cuda:0"])


def test_cards_and_host_ranks_do_not_mix():
    with pytest.raises(ValueError, match="all cards or all host"):
        CudaMeshGroup(2, devices=["cpu", "cuda:0"])


def test_a_list_needs_one_tensor_per_rank():
    g = CudaMeshGroup(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 tensors for 2 ranks"):
        g.allreduce([torch.zeros(2)] * 3)


# -- the collective front -------------------------------------------------------
def test_front_mesh_group_through_supervision():
    """``init_collective_group(1, 0, backend="mesh")`` builds the mesh
    group under ``SupervisedGroup`` over the process's ranks, as the
    reference builds ``XlaMeshGroup`` over its eight devices; ops and
    ``permute`` pass through it."""
    jcoll.init_collective_group(1, 0, backend="xla_mesh", group_name="jm")
    tcoll.init_collective_group(1, 0, backend="mesh", group_name="tm",
                                devices=["cpu"] * 8)
    try:
        jg, tg = jcoll._group_mgr.get("jm"), tcoll._group_mgr.get("tm")
        assert isinstance(tg, SupervisedGroup)
        assert isinstance(tg._inner, CudaMeshGroup)
        assert tcoll.get_collective_group_size("tm") == \
            jcoll.get_collective_group_size("jm") == 8
        assert tcoll.get_rank("tm") == jcoll.get_rank("jm") == 0
        assert [str(d) for d in tg.devices] == ["cpu"] * 8
        x = _ints(16, (8, 3))
        got = tcoll.allreduce(x, group_name="tm")
        want = np.asarray(jcoll.allreduce(x, group_name="jm"))
        assert len(got) == 8
        for t in got:
            np.testing.assert_array_equal(t.numpy(), want)
        perm = [(i, (i + 1) % 8) for i in range(8)]
        got = tcoll.permute(x, perm, group_name="tm")
        want = np.asarray(jg.permute(x, perm))
        np.testing.assert_array_equal(torch.stack(got).numpy(), want)
        seqs = [e["op"] for e in tcoll.flight_recorder_dump("tm")]
        assert seqs == ["allreduce", "permute"]
    finally:
        jcoll.destroy_collective_group("jm")
        tcoll.destroy_collective_group("tm")


def test_front_refuses_a_multi_process_mesh():
    with pytest.raises(ValueError, match="world_size=2") as jerr:
        jcoll.init_collective_group(2, 0, backend="xla_mesh",
                                    group_name="j2")
    with pytest.raises(ValueError, match="world_size=2") as terr:
        tcoll.init_collective_group(2, 0, backend="mesh", group_name="t2",
                                    devices=["cpu"] * 2)
    assert "single" in str(jerr.value) and "single" in str(terr.value)
    assert not tcoll.is_group_initialized("t2")


def test_front_mesh_without_cuda_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcoll.init_collective_group(1, 0, backend="mesh", group_name="tc")
    assert not tcoll.is_group_initialized("tc")


def test_front_devices_only_name_mesh_ranks():
    with pytest.raises(ValueError, match="mesh group"):
        tcoll.init_collective_group(1, 0, backend="tcp", group_name="td",
                                    devices=["cpu"])


def test_create_collective_group_refuses_mesh_over_two_actors():
    with pytest.raises(ValueError, match="world_size=2"):
        tcoll.create_collective_group([object(), object()], 2,
                                      backend="mesh", group_name="tx")
