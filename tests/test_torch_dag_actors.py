"""Actor classes of the port's DAG tests (``tests/test_torch_dag.py``,
``tests/test_torch_pipeline_schedule.py``).  JAX-free: each actor process
imports this module by name, so it must not pull in JAX.  The classes
are the reference tests' (``tests/test_dag.py``,
``tests/test_pipeline_schedule.py``) with the same bodies, torch in place
of jax.numpy."""

import time

import numpy as np
import torch

from ray_tpu_torch.actor import remote
from ray_tpu_torch.dag.pipeline_schedule import B, F
from ray_tpu_torch.experimental.channel import (CpuCommunicator,
                                                CudaCommunicator)


@remote
class Adder:
    def __init__(self, inc):
        self.inc = inc
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def add2(self, x, y):
        return x + y

    def boom(self, x):
        raise ValueError("kapow")

    def get_calls(self):
        return self.calls

    def reset(self, inc):
        """Reuse between test cases: a fresh instance's state."""
        self.inc = inc
        self.calls = 0
        return True

    def unpicklable(self):
        return lambda: None


@remote
class MeshOwner:
    """The reference's ``TestXlaMeshDagCollective`` mesh owner: one value
    per rank of the group over its cards (host ranks in the tests),
    stacked ``[ranks, 1]``."""

    def shards(self, _x):
        return torch.arange(8, dtype=torch.float32)[:, None]

    def consume(self, reduced):
        """The reduced value arrives as live tensors, one per rank (the
        process's own objects, never pickled); returns rank 0's value and
        the group classes under the supervision wrappers."""
        from ray_tpu_torch.util.collective.collective import _group_mgr

        assert isinstance(reduced, list), type(reduced)
        assert all(isinstance(t, torch.Tensor) for t in reduced), reduced
        groups = [type(g._inner).__name__
                  for g in _group_mgr._groups.values()]
        return float(reduced[0][0]), len(reduced), groups


@remote
class CommActor:
    """The reference's communicator actor, with a ``CudaCommunicator``
    on the same group beside its ``CpuCommunicator`` (its tensors land
    on the CPU here)."""

    def __init__(self, rank, world, name):
        self.comms = {"cpu": CpuCommunicator(world, name),
                      "cuda": CudaCommunicator(world, name, device="cpu")}
        for comm in self.comms.values():
            comm.initialize(rank)
        self.rank = rank

    def allreduce(self, kind="cpu"):
        x = np.full((3,), float(self.rank + 1))
        return self.comms[kind].allreduce(
            x if kind == "cpu" else torch.from_numpy(x))

    def exchange(self, kind="cpu"):
        comm = self.comms[kind]
        if self.rank == 0:
            comm.send(np.array([7.0]) if kind == "cpu"
                      else torch.tensor([7.0], dtype=torch.float64), 1)
            return None
        return comm.recv((1,), np.float64 if kind == "cpu"
                         else torch.float64, 0)

    def world(self):
        return self.comms["cpu"].get_world_size()


@remote
class DPWorker:
    """Data-parallel rank for the collective-node tests: tiny linear model,
    local gradient, in-graph allreduce, local apply."""

    def __init__(self, seed):
        self.reset(seed)

    def reset(self, seed):
        self.w = np.zeros(4, np.float32)
        self.rng = np.random.default_rng(seed)
        self.lr = 0.1
        return True

    def grad(self, batch_id):
        # deterministic per (rank-seed, batch): ranks produce DIFFERENT grads
        return (self.rng.standard_normal(4).astype(np.float32)
                + np.float32(batch_id))

    def busy_work(self, batch_id):
        # independent compute that can overlap the in-flight allreduce
        return float(batch_id) * 2.0

    def apply(self, g, aux):
        self.w = self.w - self.lr * g
        return (self.w.copy(), aux)

    def weights(self):
        return self.w.copy()


@remote
class JitWorker:
    """Methods marked jit=True run as one fused task (tier A)."""

    def __init__(self):
        self.w = torch.arange(4, dtype=torch.float32)

    def scale(self, x):
        return torch.as_tensor(x) * 2.0

    def addw(self, x):
        return torch.as_tensor(x) + self.w

    def combine(self, x, y):
        return torch.as_tensor(x) + torch.as_tensor(y)

    def boom(self, x):
        raise ValueError("kapow")

    def set_w(self, w):
        self.w = torch.as_tensor(w)
        return True


@remote
class Sleeper:
    def slow(self, x):
        time.sleep(5.0)
        return x + 1


@remote
class LinearStage:
    """y = x @ w with manual vjp; activations stashed per microbatch."""

    def __init__(self, w):
        self.w = np.asarray(w, np.float64)
        self.acts = {}
        self.grad_w = np.zeros_like(self.w)
        self.order = []

    def forward(self, mb, x):
        self.order.append((F, mb))
        x = np.asarray(x, np.float64)
        self.acts[mb] = x
        return x @ self.w

    def backward(self, mb, g):
        self.order.append((B, mb))
        x = self.acts.pop(mb)
        if g is None:  # loss = sum(y): dL/dy = 1
            g = np.ones((x.shape[0], self.w.shape[1]))
        g = np.asarray(g, np.float64)
        self.grad_w += x.T @ g
        return g @ self.w.T

    def reset(self, w):
        """Reuse between test cases: a fresh instance's state."""
        self.__init__(w)
        return True

    def get_grad(self):
        return self.grad_w

    def get_order(self):
        return self.order


def pid_and_inc(instance):
    """``_remote_call`` body: the actor's pid and its instance's state."""
    import os

    return os.getpid(), instance.inc


def allreduce_rank(instance, name):
    """``_remote_call`` body: allreduce this rank's index over ``name``."""
    from ray_tpu_torch.util import collective as col

    return col.allreduce(np.full(2, float(col.get_rank(name))),
                         group_name=name).tolist()


def leave_group(instance, name):
    """``_remote_call`` body: leave the collective group ``name``."""
    from ray_tpu_torch.util import collective as col

    col.destroy_collective_group(name)
    return True


def in_group(instance, name):
    """``_remote_call`` body: whether this process is in group ``name``."""
    from ray_tpu_torch.util import collective as col

    return col.is_group_initialized(name)
