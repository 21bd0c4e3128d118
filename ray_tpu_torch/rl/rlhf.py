"""End-to-end RLHF loop: rollout → reward → update, with live weight sync
(counterpart of ``ray_tpu/rl/rlhf.py``).

- **rollout**: :class:`RolloutActor` processes host the generation policy
  and sample trajectory batches (``rl.rollout.sample`` fault site), each
  holding a :class:`~ray_tpu_torch.rl.weight_sync.WeightSubscriber`, so
  fresh learner weights arrive live (atomic swap, no cold restart);
- **reward**: trajectories are scored (``rl.reward.score`` fault site) by
  the built-in scripted reward or any picklable callable;
- **ingest**: scored trajectories become a ``ray_tpu_torch.data``
  dataset that streams through ``iter_torch_batches`` (prefetch, and on
  the card the page-locked H2D staging) into the learner;
- **update**: REINFORCE with a batch-mean baseline and Adam on the
  reference's ``ActorCriticModule``, inside a ``TorchTrainer`` worker, so
  a drain → checkpoint → elastic restart comes from the train controller.
  With ``num_workers > 1`` every rank runs its own rollout shard and
  updates its own copy, the params mean-allreduced through the supervised
  collective group, the only wait across ranks;
- **weight sync**: rank 0 publishes the updated params through
  :class:`~ray_tpu_torch.rl.weight_sync.WeightPublisher` back to every
  rollout process.

Robustness contracts (the reference's): a killed rollout process is
respawned (bounded budget) and its in-flight batch DROPPED WITH
ACCOUNTING in the :class:`TrajectoryLedger`, never double-counted; a
sample past its deadline is given up and counted, the iteration goes on
with the others; a publish fault retries the SAME version; a drained or
killed learner restarts from its checkpoint and publication resumes ABOVE
the last committed version (epoch bump), with fresh rollout processes
resubscribed at the durable record.

Where the port differs, by design:

- A rollout actor is a process started by the learner's worker (forked
  by the same worker zygote as the worker itself), serving ``RolloutActor``'s methods over a pipe
  (``train/worker_group.serve_commands``), as ``rl/env_runner.py``'s
  runners do.  It samples on the host CPU (``CUDA_VISIBLE_DEVICES=""``):
  the reference's actor asks for no accelerator either, and the learner
  holds the card.
  A process that dies counts as the reference's ``ActorError``; a sample
  past its deadline cannot be cancelled inside the process, so its late
  answer is dropped when it arrives (``RunnerHandle`` skips it), and the
  batch is counted dropped at the deadline.
- The learner's params are plain tensors on the worker's device (the
  card, or the CPU when ``RLHFConfig.device="cpu"``): a 32-wide MLP gains
  nothing from a mesh, so the batch is not sharded.
- The reference's tracing spans are gone (the port has no tracing
  plane); the publish's wall still reaches the step ledger's
  ``weight_publish`` bucket and the update's its ``compute`` bucket
  through ``_private/durations.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import durations
from ray_tpu_torch.util import fault_injection

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RLHFConfig:
    """Knobs for the loop.  Everything here must pickle (it ships into
    the train worker inside ``train_loop_config``)."""

    # task/model shape: the policy maps an obs ("prompt") to a
    # categorical over vocab_size ("response tokens")
    obs_dim: int = 8
    vocab_size: int = 8
    hidden: Tuple[int, ...] = (32, 32)
    # loop shape
    iterations: int = 5
    num_rollout_actors: int = 2      # per train rank
    rollout_batch: int = 64          # samples per actor per iteration
    learner_batch_size: int = 64     # ingest minibatch
    lr: float = 5e-2
    seed: int = 0
    # pad each iteration to at least this wall time (sleep the rest)
    iteration_interval_s: float = 0.0
    # weight sync
    name: str = "rlhf"
    staleness_bound: Optional[int] = 4
    stale_timeout_s: float = 30.0
    use_channel: bool = True         # the commit channel's fast path
    verify_weights_on_read: bool = False
    # robustness
    sample_timeout_s: float = 60.0
    publish_retries: int = 3
    respawn_budget: int = 3
    checkpoint_every: int = 1
    # trainer shape
    mesh: Optional[str] = "dp"
    num_workers: int = 1
    max_failures: int = 0
    storage_path: Optional[str] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    # reward: None = the built-in scripted linear-gold reward; else a
    # picklable callable (obs, actions, cfg) -> np.ndarray of rewards
    reward_fn: Optional[Callable] = None
    # deterministic chaos, applied inside the loop's own processes:
    #   kill_rollout_at_iter: int — SIGKILL one rollout process with its
    #       sample in flight at that iteration (1-based)
    #   publish_fault_at: int — arm rl.weight_sync.publish to fail on
    #       that publish call (1-based; a ConnectionError → retried)
    #   reward_fault_at: int — arm rl.reward.score the same way
    chaos: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the learner's device: None is the card (the workers get one each,
    # and without CUDA the loop raises); "cpu" runs it on host slots
    device: Optional[str] = None


# ---------------------------------------------------------------------------
# trajectory accounting
# ---------------------------------------------------------------------------


class TrajectoryLedger:
    """Produced / consumed / dropped accounting with duplicate rejection.

    One "trajectory" is one rollout batch (one ``sample()`` call on one
    actor), identified by a unique 62-bit uid minted at actor spawn.
    ``admit`` is the single consumption gate: a uid is consumed exactly
    once, ever."""

    def __init__(self) -> None:
        self.produced = 0
        self.consumed = 0
        self.dropped = 0
        self.duplicates_rejected = 0
        self.drop_reasons: Dict[str, int] = {}
        self._consumed_ids: set = set()

    def record_produced(self, n: int = 1) -> None:
        self.produced += n

    def record_dropped(self, n: int, reason: str) -> None:
        self.dropped += n
        self.drop_reasons[reason] = self.drop_reasons.get(reason, 0) + n
        logger.warning("rlhf ledger: dropped %d trajectory batch(es): %s",
                       n, reason)

    def admit(self, uid: int) -> bool:
        """True exactly once per uid; a second admit is a duplicate,
        rejected and counted."""
        if uid in self._consumed_ids:
            self.duplicates_rejected += 1
            return False
        self._consumed_ids.add(uid)
        self.consumed += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"produced": self.produced, "consumed": self.consumed,
                "dropped": self.dropped,
                "duplicates_rejected": self.duplicates_rejected,
                "drop_reasons": dict(self.drop_reasons),
                "consumed_ids": sorted(self._consumed_ids)}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "TrajectoryLedger":
        led = cls()
        led.produced = int(state["produced"])
        led.consumed = int(state["consumed"])
        led.dropped = int(state["dropped"])
        led.duplicates_rejected = int(state["duplicates_rejected"])
        led.drop_reasons = {str(k): int(v)
                            for k, v in dict(state["drop_reasons"]).items()}
        led._consumed_ids = set(int(i) for i in state["consumed_ids"])
        return led

    def counts(self) -> Dict[str, int]:
        return {"trajectories_produced": self.produced,
                "trajectories_consumed": self.consumed,
                "trajectories_dropped": self.dropped,
                "duplicates_rejected": self.duplicates_rejected}


def _mint_uid_base() -> int:
    # 62-bit random salt, the low 16 bits left for the per-actor sequence;
    # uniqueness must survive loop restarts, so it is entropy, not a count
    return (int.from_bytes(os.urandom(8), "big") >> 2) & ~0xFFFF


# ---------------------------------------------------------------------------
# rollout processes
# ---------------------------------------------------------------------------


class RolloutActor:
    """Generation actor: samples trajectory batches with the freshest
    synced weights, on the host CPU.  Each batch reports the exact weight
    version it was generated with (a digest-verified tree when
    ``verify_weights_on_read`` is armed)."""

    def __init__(self, cfg_dict: Dict[str, Any], uid_base: int, seed: int):
        from ray_tpu_torch.rl.models import ActorCriticModule
        from ray_tpu_torch.rl.weight_sync import WeightSubscriber

        self.cfg = RLHFConfig(**cfg_dict)
        self.module = ActorCriticModule(
            self.cfg.obs_dim, self.cfg.vocab_size, self.cfg.hidden)
        self.uid_base = uid_base
        self.seq = 0
        self.generator = torch.Generator().manual_seed(seed)
        self._rng = np.random.default_rng(seed)
        # resubscribe-on-restart: construction adopts the current durable
        # version before the first sample
        self.sub = WeightSubscriber(
            self.cfg.name, staleness_bound=self.cfg.staleness_bound,
            verify_on_read=self.cfg.verify_weights_on_read, device="cpu")

    def attach_channel(self, info: Dict[str, Any], slot: int) -> bool:
        self.sub.detach_channel()
        self.sub.attach_channel(info, slot)
        return True

    def ping(self) -> bool:
        return True

    @torch.no_grad()
    def sample(self, batch_size: int) -> Dict[str, Any]:
        fault_injection.fault_point("rl.rollout.sample")
        # backpressure: refuse to run ahead of a lagging learner
        self.sub.gate(timeout_s=self.cfg.stale_timeout_s)
        self.sub.poll(timeout_s=0.0)  # adopt the freshest committed version
        params, ver = self.sub.current()
        obs = self._rng.standard_normal(
            (batch_size, self.cfg.obs_dim)).astype(np.float32)
        actions, logp = self.module.sample_action(
            params, torch.from_numpy(obs), self.generator)
        self.sub.note_sample()
        self.seq += 1
        return {
            "uid": self.uid_base + self.seq,
            "weight_version": int(ver.version),
            "weight_epoch": int(ver.epoch),
            "obs": obs,
            "actions": actions.numpy().astype(np.int32),
            "logp": logp.numpy().astype(np.float32),
        }

    def sync_stats(self) -> Dict[str, Any]:
        ver = self.sub.version
        return {"version": None if ver is None else ver.version,
                **self.sub.stats, **self.sub.last_fetch}

    def shutdown(self) -> bool:
        self.sub.detach_channel()
        return True


def _rollout_main(conn, args) -> None:
    """A rollout process: build the ``RolloutActor`` (host CPU, one
    thread, no card), answer with its pid or the constructor's traceback,
    then serve its methods."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    from ray_tpu_torch.train.worker_group import serve_commands

    try:
        actor = RolloutActor(*args)
    except Exception:  # noqa: BLE001 — reported to the group
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        conn.close()
        return
    conn.send_bytes(pickle.dumps(("ok", os.getpid())))
    serve_commands(conn, actor)


def _command(cmd: str, *args) -> bytes:
    return pickle.dumps((cmd, args))


class RolloutGroup:
    """N rollout processes with deadlines, kill-respawn (bounded budget),
    given-up samples and drop accounting.

    ``publisher`` is the rank-0 :class:`WeightPublisher` when this group
    lives in the publishing rank (it owns the commit channel, rotated on
    every membership change), or None: the group's subscribers then ride
    the durable path only."""

    def __init__(self, cfg: RLHFConfig, publisher, ledger: TrajectoryLedger,
                 start_timeout_s: float = 180.0):
        from ray_tpu_torch.rl._respawn import RespawnBudget

        self.cfg = cfg
        self.publisher = publisher
        self.ledger = ledger
        self.start_timeout_s = start_timeout_s
        self.spawn_counter = 0
        self.startup_s: List[float] = []  # spawn to constructed, per process
        self._budget = RespawnBudget(
            cfg.respawn_budget, "rollout actor",
            respawn_note="; it resubscribed at the current published "
            "version")
        self.chaos_kill_pending = False
        started = [self._start() for _ in range(cfg.num_rollout_actors)]
        try:
            self.actors = [self._ready(*s) for s in started]
        except BaseException:
            for handle, _ in started:
                handle.kill()
            raise
        self._wire_channel()

    @property
    def respawns_left(self) -> int:
        return self._budget.respawns_left

    @property
    def dropped_runners(self) -> int:
        return self._budget.dropped

    def _start(self):
        from ray_tpu_torch._private import worker_zygote
        from ray_tpu_torch.rl.env_runner import RunnerHandle
        from ray_tpu_torch.train.worker_group import allow_children

        self.spawn_counter += 1
        ctx = worker_zygote.get_context()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_rollout_main,
            args=(child, (dataclasses.asdict(self.cfg), _mint_uid_base(),
                          self.cfg.seed + self.spawn_counter)),
            name=f"rollout-{self.spawn_counter}", daemon=True)
        t0 = time.perf_counter()
        with allow_children():
            proc.start()
        child.close()
        handle = RunnerHandle(proc, parent)
        handle.sent = 1  # the constructor's answer
        return handle, t0

    def _ready(self, handle, t0):
        try:
            handle.recv(self.start_timeout_s)
        except BaseException:
            handle.kill()
            raise
        self.startup_s.append(time.perf_counter() - t0)
        return handle

    def _spawn(self):
        return self._ready(*self._start())

    def _wire_channel(self) -> None:
        """(Re)build the commit channel over the CURRENT membership and
        attach every live process at its reader slot: a dead reader's ack
        slot would wedge the writer, so the channel follows the group."""
        if self.publisher is None or not self.cfg.use_channel \
                or not self.actors:
            return
        info = self.publisher.rotate_channel(len(self.actors))
        for slot, a in enumerate(self.actors):
            try:
                a.send(_command("attach_channel", info, slot))
            except Exception:  # noqa: BLE001 — it keeps the durable path
                continue
        for a in self.actors:
            try:
                a.recv(10.0)
            except Exception:  # noqa: BLE001 — it keeps the durable path
                pass

    def kill_one(self) -> None:
        """Deterministic chaos hook: SIGKILL the first process."""
        if self.actors and self.actors[0].proc.is_alive():
            self.actors[0].proc.kill()

    def sample_all(self, batch_size: int) -> List[Dict[str, Any]]:
        """One collection round.  Every in-flight expectation is settled:
        a returned batch is recorded produced; a dead process's batch is
        dropped and counted and the process respawned (budget permitting)
        or removed; a deadline miss is dropped and counted."""
        from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

        msg = _command("sample", batch_size)
        sent: List[Optional[BaseException]] = []
        for a in self.actors:
            try:
                a.send(msg)
                sent.append(None)
            except ActorDiedError as e:
                sent.append(e)
        if self.chaos_kill_pending:
            self.chaos_kill_pending = False
            self.kill_one()  # the in-flight sample dies with the process
        deadline = time.monotonic() + self.cfg.sample_timeout_s
        out: List[Dict[str, Any]] = []
        dead: List[int] = []
        for i, a in enumerate(self.actors):
            budget = max(0.1, deadline - time.monotonic())
            try:
                if sent[i] is not None:
                    raise sent[i]
                batch = a.recv(budget)
            except GetTimeoutError:
                self.ledger.record_dropped(1, "sample deadline exceeded")
                continue
            except (ActorDiedError, RuntimeError) as e:
                self.ledger.record_dropped(
                    1, f"rollout actor died mid-sample ({type(e).__name__})")
                dead.append(i)
                continue
            self.ledger.record_produced(1)
            out.append(batch)
        if dead:
            self._replace(dead)
        return out

    def _replace(self, dead_indices: List[int]) -> None:
        """Respawn dead processes within the budget; past it, drop the
        member (logged and counted) and go on with fewer."""
        dead = set(dead_indices)
        for i in dead:
            self.actors[i].kill()
        survivors = [a for i, a in enumerate(self.actors) if i not in dead]
        self.actors = self._budget.replace(survivors, len(dead), self._spawn)
        self._wire_channel()

    def sync_stats(self, timeout: float = 10.0) -> List[Dict[str, Any]]:
        """Each live process's subscriber stats (a silent one is
        skipped)."""
        out = []
        for a in self.actors:
            try:
                a.send(_command("sync_stats"))
                out.append(a.recv(timeout))
            except Exception:  # noqa: BLE001 — stats are best-effort
                continue
        return out

    def stop(self, timeout: float = 10.0) -> None:
        for a in self.actors:
            try:
                a.send(_command("shutdown"))
            except Exception:  # noqa: BLE001 — already gone
                pass
        deadline = time.monotonic() + timeout
        for a in self.actors:
            a.proc.join(max(0.0, deadline - time.monotonic()))
            a.kill()
        self.actors = []


# ---------------------------------------------------------------------------
# reward
# ---------------------------------------------------------------------------


def _gold_matrix(cfg: RLHFConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1000)
    return rng.standard_normal(
        (cfg.obs_dim, cfg.vocab_size)).astype(np.float32)


def scripted_reward(obs: np.ndarray, actions: np.ndarray,
                    cfg: RLHFConfig) -> np.ndarray:
    """Built-in reward model: 1.0 where the sampled token matches a fixed
    hidden linear scorer's argmax, a learnable signal with a known
    optimum."""
    gold = np.argmax(obs @ _gold_matrix(cfg), axis=-1)
    return (actions == gold).astype(np.float32)


def score_trajectories(batches: List[Dict[str, Any]], cfg: RLHFConfig
                       ) -> List[Dict[str, Any]]:
    """The reward leg.  ``rl.reward.score`` fires once per scoring round,
    before any batch is mutated, so a retry re-scores cleanly."""
    fault_injection.fault_point("rl.reward.score")
    fn = cfg.reward_fn or scripted_reward
    for b in batches:
        b["rewards"] = np.asarray(fn(b["obs"], b["actions"], cfg),
                                  np.float32)
    return batches


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------


def _make_update_fn(module, lr: float):
    """One policy-gradient step (REINFORCE with a batch-mean baseline) and
    ``optax.adam(lr)``, in place on the params' leaves.  Returns ``(tx,
    update)``; ``update(params, opt_state, batch)`` returns ``(params,
    opt_state, loss)``, the loss before the step."""
    from ray_tpu_torch.rl.models import Adam, grad_step, take

    tx = Adam(lr)

    def loss_fn(params, batch):
        logits = module.logits(params, batch["obs"])
        act_logp = take(torch.log_softmax(logits, -1), batch["actions"])
        adv = batch["rewards"] - torch.mean(batch["rewards"])
        return -torch.mean(adv * act_logp)

    def update(params, opt_state, batch):
        loss = loss_fn(params, batch)
        grad_step(loss, params, tx, opt_state)
        return params, opt_state, loss.detach()

    return tx, update


def _batches_to_dataset(batches: List[Dict[str, Any]],
                        ledger: TrajectoryLedger):
    """Admit each trajectory batch through the ledger (the one consumption
    gate: duplicates are rejected here) and build the dataset that
    streams through the ingest plane."""
    from ray_tpu_torch import data as rdata

    blocks = []
    for b in batches:
        if not ledger.admit(int(b["uid"])):
            continue
        n = len(b["actions"])
        blocks.append({
            "obs": b["obs"],
            "actions": b["actions"],
            "rewards": b["rewards"],
            "logp": b["logp"],
            "uid": np.full((n,), int(b["uid"]), np.int64),
            "weight_version": np.full(
                (n,), int(b["weight_version"]), np.int64),
        })
    if not blocks:
        return None
    return rdata.from_blocks(blocks)


# ---------------------------------------------------------------------------
# the train-worker loop
# ---------------------------------------------------------------------------


class _LoopRuntime:
    """Everything one rank needs for the loop; built inside the train
    worker, torn down in its ``finally``."""

    def __init__(self, cfg: RLHFConfig, ctx) -> None:
        from ray_tpu_torch.rl.models import ActorCriticModule, to_device
        from ray_tpu_torch.rl.weight_sync import WeightPublisher

        self.cfg = cfg
        self.ctx = ctx
        self.rank = ctx.get_world_rank()
        self.world = ctx.get_world_size()
        self.device = ctx.get_device()
        self.module = ActorCriticModule(
            cfg.obs_dim, cfg.vocab_size, cfg.hidden)

        # ---- restore (a drain or elastic restart resumes here) -----------
        # tiered runs walk the per-shard ladder (local RAM -> peer RAM ->
        # committed disk); sync runs load the controller's directory
        # checkpoint
        self.start_iter = 0
        self.ledger = TrajectoryLedger()
        self.restore_tier: Optional[str] = None
        restored = None
        res = ctx.restore_checkpoint()
        if res is not None:
            state = res.tree
            restored = state["params"]
            self.start_iter = int(state["iteration"])
            self.ledger = TrajectoryLedger.from_state(state["ledger"])
            self.restore_tier = res.tier
            logger.warning(
                "rlhf[r%d]: restored at iteration %d from the %s tier "
                "(published version %s)", self.rank, self.start_iter,
                res.tier, state.get("version"))
        if restored is not None:
            self.params = to_device(restored, self.device,
                                    requires_grad=True)
        else:
            self.params = self.module.init(
                torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.tx, self.update_fn = _make_update_fn(self.module, cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.consumed_versions: List[int] = []
        self.stale_minibatches = 0

        # ---- collective group (world > 1: the DP seam) ----------------------
        chaos = dict(cfg.chaos or {})
        self.chaos = chaos
        self.group_name = None
        if self.world > 1:
            self.group_name = ctx.collective_group(
                "nccl" if self.device.type == "cuda" else "tcp",
                timeout_s=cfg.sample_timeout_s + 30.0)
            if chaos.get("collective_fault_op") and self.rank == \
                    self.world - 1 and self.start_iter == 0:
                # one-shot: only the first incarnation injects the hang
                fault_injection.arm(
                    "collective.op",
                    nth=int(chaos["collective_fault_op"]), exc="delay:120")

        # ---- publisher and chaos arming (rank 0 only) ----------------------
        self.publisher = None
        self.rollout = None
        if self.rank == 0:
            # resume=True: a restarted publisher continues ABOVE the
            # durable committed version; the stream never rewinds
            self.publisher = WeightPublisher(cfg.name, resume=True)
            if chaos.get("publish_fault_at"):
                fault_injection.arm("rl.weight_sync.publish",
                                    nth=int(chaos["publish_fault_at"]))
            if chaos.get("reward_fault_at"):
                fault_injection.arm("rl.reward.score",
                                    nth=int(chaos["reward_fault_at"]))
            self.publish()
        if self.world > 1:
            # every rank sees a committed version before its rollout
            # processes start (they adopt it at construction)
            from ray_tpu_torch.util import collective as col

            col.barrier(self.group_name)
        self.rollout = RolloutGroup(cfg, self.publisher, self.ledger)

    # -- legs ---------------------------------------------------------------
    def publish(self):
        from ray_tpu_torch._private.resilience import RetryPolicy, retry_call

        policy = RetryPolicy(max_attempts=self.cfg.publish_retries,
                             base_delay_s=0.05, max_delay_s=0.5)
        return retry_call(lambda: self.publisher.publish(self.params),
                          policy=policy, site="rl.weight_sync.publish")

    def score(self, batches):
        from ray_tpu_torch._private.resilience import RetryPolicy, retry_call

        policy = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                             max_delay_s=0.5)
        return retry_call(lambda: score_trajectories(batches, self.cfg),
                          policy=policy, site="rl.reward.score")

    def consume(self, ds) -> Dict[str, Any]:
        """Stream the scored dataset through the ingest plane into update
        steps, enforcing the monotonic-version floor."""
        losses, rewards, n_rows = [], [], 0
        if ds is not None:
            floor = (self.consumed_versions[-1]
                     if self.consumed_versions else -1)
            for jb in ds.iterator().iter_torch_batches(
                    batch_size=self.cfg.learner_batch_size,
                    drop_last=False, prefetch_batches=2,
                    device=self.device):
                versions = jb["weight_version"]
                vmin, vmax = int(versions.min()), int(versions.max())
                if vmin < floor:
                    # never train on a version older than one already
                    # consumed (counted apart from the ledger: the rows'
                    # uids were admitted, only this update is skipped)
                    self.stale_minibatches += 1
                    logger.warning(
                        "rlhf: skipped a minibatch with stale "
                        "weight_version %d < floor %d", vmin, floor)
                    continue
                floor = max(floor, vmax)
                self.consumed_versions.append(vmax)
                batch = {"obs": jb["obs"], "actions": jb["actions"],
                         "rewards": jb["rewards"]}
                t_up = time.perf_counter()
                self.params, self.opt_state, loss = self.update_fn(
                    self.params, self.opt_state, batch)
                losses.append(float(loss))
                # the loss read synchronizes the device: the update (and
                # the sync) is the step ledger's compute
                durations.note_duration("compute",
                                        time.perf_counter() - t_up)
                rewards.append(float(jb["rewards"].float().mean()))
                n_rows += int(jb["actions"].shape[0])
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "mean_reward":
                float(np.mean(rewards)) if rewards else float("nan"),
            "rows_consumed": n_rows,
        }

    @torch.no_grad()
    def allreduce_params(self) -> None:
        """world > 1: average the per-rank updated params so every rank
        (and the published stream) holds the same tree."""
        from ray_tpu_torch.rl.models import tree_leaves
        from ray_tpu_torch.util import collective as col

        for p in tree_leaves(self.params):
            summed = col.allreduce(p.detach().clone(), self.group_name)
            p.copy_(summed / self.world)
        self.opt_state = self.tx.init(self.params)

    def host_params(self) -> Any:
        from ray_tpu_torch.rl.models import tree_map

        return tree_map(lambda t: t.detach().cpu().clone(), self.params)

    def close(self) -> None:
        if self.rollout is not None:
            self.rollout.stop()
        if self.publisher is not None:
            self.publisher.close()
        fault_injection.disarm("rl.weight_sync.publish")
        fault_injection.disarm("rl.reward.score")
        fault_injection.disarm("collective.op")


def _sync_checkpoint(state: Dict[str, Any]):
    """Rank 0's sync-mode checkpoint of ``state``: a directory of one
    ``torch.save`` (no barrier: the other ranks do not checkpoint)."""
    from ray_tpu_torch.train.checkpoint import STATE_FILE, Checkpoint

    path = tempfile.mkdtemp(prefix="rtpu-rlhf-ckpt-")
    torch.save(state, os.path.join(path, STATE_FILE))
    return Checkpoint(path)


def _rlhf_train_loop(config: Dict[str, Any]) -> None:
    """Runs inside every TorchTrainer worker."""
    from ray_tpu_torch import train

    t_loop = time.perf_counter()
    cfg = RLHFConfig(**config["rlhf"])
    ctx = train.get_context()
    rt = _LoopRuntime(cfg, ctx)
    setup_s = time.perf_counter() - t_loop
    ledger = ctx.step_ledger()
    iter_walls: List[float] = []
    try:
        for it in range(rt.start_iter, cfg.iterations):
            t_iter = time.perf_counter()
            if rt.chaos.get("kill_rollout_at_iter") == it + 1:
                rt.rollout.chaos_kill_pending = True
            split: Dict[str, float] = {}
            with ledger.step():
                t0 = time.perf_counter()
                batches = rt.rollout.sample_all(cfg.rollout_batch)
                t1 = time.perf_counter()
                batches = rt.score(batches)
                t2 = time.perf_counter()
                stats = rt.consume(_batches_to_dataset(batches, rt.ledger))
                t3 = time.perf_counter()
                split = {"rollout_s": t1 - t0, "reward_s": t2 - t1,
                         "update_s": t3 - t2}
                if rt.world > 1:
                    rt.allreduce_params()
                if cfg.iteration_interval_s > 0:
                    pad = cfg.iteration_interval_s - (
                        time.perf_counter() - t_iter)
                    if pad > 0:
                        time.sleep(pad)
                iter_walls.append(time.perf_counter() - t_iter)
                if rt.rank != 0:
                    train.report({"training_iteration": it + 1,
                                  "rank": rt.rank})
                    continue
                t4 = time.perf_counter()
                ver = rt.publish()
                split["publish_s"] = time.perf_counter() - t4
                metrics = {
                    "training_iteration": it + 1,
                    "iteration_walls_s": [round(w, 4) for w in iter_walls],
                    "iteration_split_s": split,
                    "published_version": int(ver.version),
                    "publisher_epoch": int(ver.epoch),
                    "consumed_versions": list(rt.consumed_versions),
                    "publish_faults_fired":
                        fault_injection.fired_count(
                            "rl.weight_sync.publish"),
                    "reward_faults_fired":
                        fault_injection.fired_count("rl.reward.score"),
                    "respawns_used":
                        cfg.respawn_budget - rt.rollout.respawns_left,
                    "dropped_runners": rt.rollout.dropped_runners,
                    "stale_minibatches": rt.stale_minibatches,
                    "world": rt.world,
                    "restore_tier": rt.restore_tier,
                    "start_iteration": rt.start_iter,
                    "setup_s": setup_s,
                    "rollout_startup_s": list(rt.rollout.startup_s),
                    "last_publish": dict(rt.publisher.last_publish),
                    **rt.ledger.counts(),
                    **{f"publisher_{k}": v
                       for k, v in rt.publisher.stats.items()},
                    **stats,
                }
                if it + 1 == cfg.iterations:
                    metrics["subscriber_stats"] = rt.rollout.sync_stats()
                want_ckpt = ((it + 1) % cfg.checkpoint_every == 0
                             or it + 1 == cfg.iterations
                             or ctx.drain_requested())
                checkpoint = None
                if want_ckpt:
                    state = {"params": rt.host_params(),
                             "iteration": it + 1,
                             "version": int(ver.version),
                             "ledger": rt.ledger.state_dict()}
                    if ctx.checkpoint_mode() == "tiered":
                        # the iteration pays only the snapshot; rank 0 is
                        # the sole writer (params are the same on every
                        # rank): writers=1, the whole tree
                        checkpoint = ctx.checkpointer(writers=1).save(
                            state, metrics)
                        if ctx.drain_requested() and \
                                ctx.drain_checkpoint_tier() == "memory":
                            # the deadline is below disk-write time: the
                            # peer-RAM ack is the commit
                            ctx.checkpointer().commit_ram()
                    else:
                        with ledger.bucket("checkpoint_persist"):
                            checkpoint = _sync_checkpoint(state)
                train.report(metrics, checkpoint=checkpoint)
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# the user-facing wrapper
# ---------------------------------------------------------------------------


class RLHFLoop:
    """Build-and-run handle: wires the config into a ``TorchTrainer``, so
    drain handling, checkpoint restore and elastic restart come from the
    train controller."""

    def __init__(self, config: RLHFConfig, *,
                 run_config: Optional[Any] = None):
        self.config = config
        self.run_config = run_config

    def run(self):
        from ray_tpu_torch import train
        from ray_tpu_torch._device import resolve_device

        cfg = self.config
        use_gpu = resolve_device(cfg.device).type == "cuda"
        run_config = self.run_config
        if run_config is None:
            run_config = train.RunConfig(
                name=f"rlhf-{cfg.name}",
                storage_path=cfg.storage_path,
                failure_config=train.FailureConfig(
                    max_failures=cfg.max_failures))
        trainer = train.TorchTrainer(
            _rlhf_train_loop,
            train_loop_config={"rlhf": dataclasses.asdict(cfg)},
            scaling_config=train.ScalingConfig(
                num_workers=cfg.num_workers, use_gpu=use_gpu,
                mesh=cfg.mesh,
                resources_per_worker=cfg.resources_per_worker),
            run_config=run_config,
        )
        return trainer.fit()
