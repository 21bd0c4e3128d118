"""Targets of the worker zygote's tests (``tests/test_torch_worker_zygote.py``).
JAX-free: each child the tests start imports this module by name (a
deployment, an actor class, a loop or a process target), so it must not
pull in JAX."""

import os
import signal
import sys

import torch

from ray_tpu_torch import serve, train
from ray_tpu_torch._private import worker_zygote
from ray_tpu_torch.actor import remote


def report_start(conn):
    """A process target: what this child was given at its start."""
    conn.send({"pid": os.getpid(), "ppid": os.getppid(),
               "env": dict(os.environ), "cwd": os.getcwd(),
               "sys_path": list(sys.path),
               "sigint": signal.getsignal(signal.SIGINT)
               is signal.default_int_handler,
               "sigterm": signal.getsignal(signal.SIGTERM) == signal.SIG_DFL,
               "zygote": worker_zygote.preload_report(),
               "cuda_initialized": torch.cuda.is_initialized()})
    conn.close()


def parent_and_pid():
    """A bound call's body (``health_plane.run_bound``)."""
    return os.getpid(), os.getppid()


@serve.deployment(num_replicas=1)
class PidReplica:
    def __call__(self, body):
        return os.getpid()


@remote
class Starter:
    """An actor that starts a process of its own (a nested start)."""

    def pid(self):
        return os.getpid()

    def start_child(self):
        from ray_tpu_torch.train.worker_group import allow_children

        ctx = worker_zygote.get_context()
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=report_start, args=(child,), daemon=True)
        with allow_children():  # an actor is a daemonic process
            proc.start()
        child.close()
        got = parent.recv()
        proc.join(30)
        return {"child_ppid": got["ppid"], "stats": worker_zygote.stats(),
                "exitcode": proc.exitcode}


def tiny_train_loop(config):
    """One step of the tiny Llama from a seed on the host; reports the
    loss with this worker's parent."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny()
    tr = make_llama_trainer(cfg, optimizer=default_optimizer(
        lr=1e-3, warmup=1, decay_steps=10), device="cpu")
    state = tr.init_state(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    state, m = tr.step(state, {"tokens": tokens})
    train.report({"loss": float(m["loss"]), "ppid": os.getppid()})
