"""EnvRunner processes: distributed rollout collection for host (gym) envs.

Counterpart of ``ray_tpu/rl/env_runner.py`` (reference:
``rllib/env/single_agent_env_runner.py`` + ``env_runner_group.py``).  The
reference's runner is an actor; here each runner is an OS process forked
by the worker zygote (``_private/worker_zygote.py``), serving ``EnvRunner``'s
methods as commands over a pipe (``train/worker_group.serve_commands``,
as the train workers do).  The runner's policy runs on the host CPU: that
is the design (envs that step in Python), stated as ``device="cpu"``.
The torch-env fast path does not need runners (rollouts run on the
learner's device).

A name registered with ``register_env`` in the driver lives in the
driver's registry; a runner's registry starts empty, so the
group carries the registered factory (which must pickle: a module-level
function or class) to each runner, which registers it there.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

logger = logging.getLogger(__name__)


class EnvRunner:
    """Steps a gymnasium vector env with the current policy on the host
    CPU (the object each runner process serves)."""

    def __init__(self, env_name: str, num_envs: int, module_spec: dict,
                 seed: int = 0, env_factory: Optional[Callable] = None):
        from ray_tpu_torch.rl.env import (GymVectorEnv, make_env,
                                          register_env)
        from ray_tpu_torch.rl.models import ActorCriticModule

        if env_factory is not None:
            register_env(env_name, env_factory)
        # host stepping needs the gym incarnation even for names that also
        # have a torch fast-path registration (e.g. CartPole-v1); custom
        # register_env names fall through to the registry
        try:
            self.env = GymVectorEnv(env_name)
        except Exception:
            self.env = make_env(env_name)
            if not isinstance(self.env, GymVectorEnv):
                raise TypeError(
                    f"EnvRunner processes step host (gym) envs; {env_name!r} "
                    f"is a TorchVectorEnv — use num_env_runners=0 so "
                    f"rollouts run on the learner's device")
        self.obs = self.env.make_batch(num_envs, seed=seed)
        module_spec = dict(module_spec)
        self.gamma = float(module_spec.pop("gamma", 0.99))
        self.module = ActorCriticModule(**module_spec)
        self.params = None
        self.generator = torch.Generator(device="cpu").manual_seed(seed)
        self.episode_returns = np.zeros(num_envs)
        self.completed: List[float] = []

    def set_weights(self, params) -> bool:
        self.params = {k: {n: torch.as_tensor(np.asarray(a))
                           for n, a in v.items()} for k, v in params.items()}
        return True

    def _value(self, obs) -> np.ndarray:
        return self.module.value(self.params, torch.as_tensor(
            np.asarray(obs, np.float32))).numpy()

    @torch.no_grad()
    def sample(self, num_steps: int) -> Dict[str, Any]:
        traj = {k: [] for k in ("obs", "actions", "logp_old", "rewards",
                                "dones", "values")}
        for _ in range(num_steps):
            obs_t = torch.as_tensor(np.asarray(self.obs, np.float32))
            action, logp = self.module.sample_action(self.params, obs_t,
                                                     self.generator)
            value = self.module.value(self.params, obs_t).numpy()
            action = action.numpy().astype(np.int64)
            next_obs, reward, term, trunc, final_obs = self.env.step(action)
            done = term | trunc
            self.episode_returns += reward
            # time-limit bootstrap: fold V(final_obs) into the reward at
            # truncations (same trick as the on-device rollout)
            if trunc.any():
                reward = reward + self.gamma * self._value(final_obs) * trunc
            traj["obs"].append(np.asarray(self.obs, np.float32))
            traj["actions"].append(action)
            traj["logp_old"].append(logp.numpy())
            traj["rewards"].append(np.asarray(reward, np.float32))
            traj["dones"].append(done)
            traj["values"].append(value)
            for i in np.nonzero(done)[0]:
                self.completed.append(float(self.episode_returns[i]))
                self.episode_returns[i] = 0.0
            self.obs = next_obs
        out = {k: np.stack(v) for k, v in traj.items()}
        out["last_value"] = self._value(self.obs)
        return out

    def episode_stats(self, clear: bool = True) -> List[float]:
        out = list(self.completed)
        if clear:
            self.completed = []
        return out

    def env_name(self) -> str:
        """What this runner steps: the env's class and name."""
        return f"{type(self.env).__name__}({getattr(self.env, 'name', '')})"

    def shutdown(self) -> bool:
        return True


def _runner_main(conn, args) -> None:
    """A runner process: build the ``EnvRunner`` (its policy on one host
    core, no card), answer with its pid or the constructor's traceback,
    then serve its commands."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    from ray_tpu_torch.train.worker_group import serve_commands

    try:
        runner = EnvRunner(*args)
    except Exception:  # noqa: BLE001 — reported to the group
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        conn.close()
        return
    conn.send_bytes(pickle.dumps(("ok", os.getpid())))
    serve_commands(conn, runner)


class RunnerHandle:
    """One runner process and its end of the pipe.  Calls are answered in
    order; ``sent``/``received`` let a reply that arrives after its
    caller gave up be skipped by the next one."""

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.pid = proc.pid
        self.sent = 0
        self.received = 0

    def send(self, msg: bytes) -> None:
        try:
            self.conn.send_bytes(msg)
        except (OSError, ValueError) as e:
            raise ActorDiedError(self.pid, f"runner pid {self.pid} is gone "
                                 f"(exit code {self.proc.exitcode}): "
                                 f"{e!r}") from e
        self.sent += 1

    def recv(self, timeout: float):
        """The reply to the last call sent; ``GetTimeoutError`` past
        ``timeout`` s, ``ActorDiedError`` when the process is gone, and
        ``RuntimeError`` with its traceback when the call raised."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                ready = self.conn.poll(max(0.0, deadline - time.monotonic()))
                if ready:
                    status, value = pickle.loads(self.conn.recv_bytes())
            except (EOFError, OSError) as e:
                raise ActorDiedError(
                    self.pid, f"runner pid {self.pid} died (exit code "
                    f"{self.proc.exitcode}): {e!r}") from e
            if not ready:  # (a TimeoutError is an OSError: raised here)
                raise GetTimeoutError(
                    f"runner pid {self.pid}: no reply in {timeout:g} s")
            self.received += 1
            if self.received >= self.sent:
                break
        if status != "ok":
            raise RuntimeError(f"runner pid {self.pid} failed:\n{value}")
        return value

    def kill(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(10)
        self.conn.close()


def command(cmd: str, *args) -> bytes:
    return pickle.dumps((cmd, args))


class EnvRunnerGroup:
    """N EnvRunner processes + one host copy of the weights sent to each.

    Every blocking wait carries a deadline, and a runner whose process
    died is respawned (bounded by ``respawn_budget``, re-synced to the
    last broadcast weights) or — budget exhausted — dropped with a
    logged count, so one dead process degrades a collection round instead
    of failing the whole training iteration."""

    def __init__(self, env_name: str, num_runners: int, num_envs_per: int,
                 module_spec: dict, seed: int = 0, *,
                 timeout_s: float = 120.0, respawn_budget: int = 3):
        from ray_tpu_torch.rl._respawn import RespawnBudget
        from ray_tpu_torch.rl.env import env_factory

        self._spawn_args = (env_name, num_envs_per, dict(module_spec),
                            env_factory(env_name))
        self._seed = seed
        self._spawned = 0
        self.timeout_s = timeout_s
        self._budget = RespawnBudget(respawn_budget, "env runner")
        self._last_weights: Optional[bytes] = None
        started = [self._start() for _ in range(num_runners)]
        try:
            self.runners = [self._ready(r) for r in started]
        except BaseException:
            for r in started:
                r.kill()
            raise

    @property
    def respawns_left(self) -> int:
        return self._budget.respawns_left

    @property
    def dropped_runners(self) -> int:
        return self._budget.dropped

    def _start(self) -> RunnerHandle:
        from ray_tpu_torch._private import worker_zygote

        env_name, num_envs_per, module_spec, factory = self._spawn_args
        self._spawned += 1
        ctx = worker_zygote.get_context()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_runner_main,
            args=(child, (env_name, num_envs_per, dict(module_spec),
                          self._seed + self._spawned, factory)),
            name=f"env-runner-{self._spawned}", daemon=True)
        proc.start()
        child.close()
        handle = RunnerHandle(proc, parent)
        handle.sent = 1  # the constructor's answer
        return handle

    def _ready(self, handle: RunnerHandle) -> RunnerHandle:
        """Wait for a started runner's constructor; a failed one is killed
        and its traceback raised."""
        try:
            handle.recv(self.timeout_s)
        except BaseException:
            handle.kill()
            raise
        return handle

    def _spawn(self) -> RunnerHandle:
        return self._ready(self._start())

    def _settle(self, msg: bytes, op: str, default: Any = None) -> List[Any]:
        """Send every live runner the command ``msg`` and gather the
        replies under the group deadline.  A dead runner is replaced (or
        dropped past the budget) and contributes ``default``; a deadline
        overrun raises — a hang is the caller's failure to see, not
        something to eat silently."""
        deadline = time.monotonic() + self.timeout_s
        out: List[Any] = []
        replaced: List[int] = []
        sent: List[Optional[BaseException]] = []
        for r in self.runners:
            try:
                r.send(msg)
                sent.append(None)
            except ActorDiedError as e:
                sent.append(e)
        try:
            for i, r in enumerate(self.runners):
                budget = max(0.1, deadline - time.monotonic())
                try:
                    if sent[i] is not None:
                        raise sent[i]
                    out.append(r.recv(budget))
                except GetTimeoutError:
                    raise TimeoutError(
                        f"EnvRunnerGroup.{op}: runner {i} exceeded the "
                        f"{self.timeout_s:g} s group deadline")
                except (ActorDiedError, RuntimeError) as e:
                    logger.warning(
                        "EnvRunnerGroup.%s: runner %d died (%s)", op, i,
                        type(e).__name__)
                    replaced.append(i)
                    out.append(default)
        finally:
            # settle membership even when a deadline overrun aborts the
            # round — a dead runner detected before the raise must still
            # be respawned (or dropped with its count), not linger dead
            if replaced:
                self._replace(replaced)
        return [o for o in out if o is not None]

    def _spawn_synced(self) -> RunnerHandle:
        """A replacement runner, re-synced to the last broadcast weights
        so it contributes from its first round."""
        runner = self._spawn()
        if self._last_weights is not None:
            try:
                runner.send(self._last_weights)
                runner.recv(self.timeout_s)
            except Exception:  # noqa: BLE001 — next sync covers it
                logger.warning(
                    "EnvRunnerGroup: weight re-sync to respawned runner "
                    "failed; it syncs on the next broadcast")
        return runner

    def _replace(self, dead_indices: List[int]) -> None:
        dead = set(dead_indices)
        for i in dead:
            self.runners[i].kill()
        survivors = [r for i, r in enumerate(self.runners) if i not in dead]
        self.runners = self._budget.replace(
            survivors, len(dead_indices), self._spawn_synced)

    def sync_weights(self, params) -> None:
        """One host copy of ``params`` (numpy), serialized once and sent
        to every runner; kept for a runner respawned later."""
        msg = command("set_weights", params)
        self._last_weights = msg
        self._settle(msg, "sync_weights")

    def sample(self, num_steps: int) -> List[Dict[str, Any]]:
        return self._settle(command("sample", num_steps), "sample")

    def episode_stats(self) -> List[float]:
        out: List[float] = []
        for stats in self._settle(command("episode_stats"),
                                  "episode_stats"):
            out.extend(stats)
        return out

    def env_names(self) -> List[str]:
        """What each runner steps (``EnvRunner.env_name``)."""
        return self._settle(command("env_name"), "env_name")

    def pids(self) -> List[int]:
        return [r.pid for r in self.runners]

    def stop(self, timeout: float = 10.0):
        for r in self.runners:
            try:
                r.send(command("shutdown"))
            except ActorDiedError:
                pass
        deadline = time.monotonic() + timeout
        for r in self.runners:
            r.proc.join(max(0.0, deadline - time.monotonic()))
            r.kill()
        self.runners = []
