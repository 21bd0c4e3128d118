"""DreamerV3: model-based RL — RSSM world model + imagination actor-critic.

Counterpart of ``ray_tpu/rl/dreamer.py`` (reference:
``rllib/algorithms/dreamerv3/``, Hafner et al. 2023).  Compact version for
vector observations and discrete actions, keeping the v3 signature
pieces:

- RSSM with discrete latents (categorical codes), GRU deterministic path;
- symlog squashing for observation/reward targets, two-hot distributional
  reward/value heads;
- KL balancing with free bits (beta_dyn/beta_rep);
- imagination rollouts from replayed posterior states; lambda-return
  critic with an EMA regularizer target; REINFORCE actor with
  percentile-normalized returns and entropy bonus.

The reference's closures of ``DreamerV3.__init__`` are module-level
functions here (``wm_loss``, ``imagine``, ``lambda_returns``,
``actor_loss``, ``critic_loss``, ``policy_step`` and their pieces), each
taking the ``DreamerParams`` and the action count, so that a test can
call them.  A latent or action sample takes its Gumbel noise from a
generator, or from the caller (``noise``).  World-model learning,
imagination and the actor/critic updates run on the learner's device;
the sequence replay buffer is host numpy (same host/device split as
dqn.py/sac.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import TorchVectorEnv, make_env
from ray_tpu_torch.rl.models import (Adam, categorical, copy_tree, detached,
                                     grad_step, mlp_apply, mlp_init, one_hot,
                                     take, to_device, to_host, tree_leaves)


@dataclasses.dataclass(frozen=True)
class DreamerParams:
    lr: float = 3e-4
    actor_lr: float = 1e-4
    critic_lr: float = 1e-4
    gamma: float = 0.99
    lam: float = 0.95
    horizon: int = 12           # imagination length
    deter_dim: int = 128        # GRU state
    codes: int = 8              # number of categorical latents
    classes: int = 8            # classes per latent
    hidden: Tuple[int, ...] = (128,)
    bins: int = 41              # two-hot buckets over symlog space
    beta_pred: float = 1.0
    beta_dyn: float = 0.5
    beta_rep: float = 0.1
    free_bits: float = 1.0
    entropy_coef: float = 3e-3
    critic_ema: float = 0.98
    batch_size: int = 16
    batch_length: int = 16
    buffer_size: int = 1024     # sequences (episode chunks)
    train_ratio: int = 2        # WM/AC updates per collected sequence-chunk


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def bucket_edges(bins, device=None):
    """The shared symlog-space bucket grid for all two-hot heads — encode
    (twohot) and decode (expected value) must use the same edges."""
    return torch.linspace(-20.0, 20.0, bins, device=device)


def twohot(x, bins):
    """Two-hot encode scalar x over `bins` symmetric symlog buckets."""
    edges = bucket_edges(bins, x.device)
    x = torch.clamp(x, edges[0], edges[-1])
    idx = torch.clamp(torch.searchsorted(edges, x.contiguous()) - 1, 0,
                      bins - 2)
    left, right = edges[idx], edges[idx + 1]
    w_right = (x - left) / (right - left)
    return (one_hot(idx, bins) * (1.0 - w_right)[..., None]
            + one_hot(idx + 1, bins) * w_right[..., None])


def _n_mlp(p: DreamerParams) -> int:
    return len(p.hidden) + 1


def linear_init(generator, din, dout):
    w = torch.randn((din, dout), generator=generator,
                    device=generator.device) * float(np.sqrt(1.0 / din))
    return {"w": w.requires_grad_(),
            "b": torch.zeros((dout,), device=generator.device,
                             requires_grad=True)}


def dreamer_init(p: DreamerParams, obs_dim: int, n_actions: int,
                 generator: torch.Generator):
    """-> (wm, actor, critic) as trees of leaf tensors on the generator's
    device, keyed as the reference's."""
    Z = p.codes * p.classes
    feat_dim = p.deter_dim + Z
    H = list(p.hidden)
    g = generator
    wm = {
        "enc": mlp_init(g, [obs_dim, *H, H[-1]]),
        # GRU over [z, a] with deterministic state h
        "gru_x": linear_init(g, Z + n_actions, 3 * p.deter_dim),
        "gru_h": linear_init(g, p.deter_dim, 3 * p.deter_dim),
        "prior": mlp_init(g, [p.deter_dim, *H, Z]),
        "post": mlp_init(g, [p.deter_dim + H[-1], *H, Z]),
        "dec": mlp_init(g, [feat_dim, *H, obs_dim]),
        "rew": mlp_init(g, [feat_dim, *H, p.bins]),
        "cont": mlp_init(g, [feat_dim, *H, 1]),
    }
    actor = mlp_init(g, [feat_dim, *H, n_actions])
    critic = mlp_init(g, [feat_dim, *H, p.bins])
    return wm, actor, critic


def enc(wm, obs, p: DreamerParams):
    return mlp_apply(wm["enc"], symlog(obs), _n_mlp(p))


def gru(wm, h, z, a_onehot):
    x = torch.cat([z, a_onehot], -1)
    gx = x @ wm["gru_x"]["w"] + wm["gru_x"]["b"]
    gh = h @ wm["gru_h"]["w"] + wm["gru_h"]["b"]
    xr, xu, xc = torch.chunk(gx, 3, -1)
    hr, hu, hc = torch.chunk(gh, 3, -1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    c = torch.tanh(xc + r * hc)
    return u * c + (1 - u) * h


def latent_dist(logits, p: DreamerParams):
    """[.., codes*classes] -> [.., codes, classes] log-probs with 1%
    uniform mixing (v3's unimix) for stable KL."""
    lg = logits.reshape(logits.shape[:-1] + (p.codes, p.classes))
    probs = 0.99 * torch.softmax(lg, -1) + 0.01 / p.classes
    return torch.log(probs)


def sample_latent(logp, p: DreamerParams, generator=None, noise=None):
    """A one-hot code per latent with straight-through gradients."""
    idx = categorical(logp, generator, noise)  # [.., codes]
    z = one_hot(idx, p.classes)
    probs = torch.exp(logp)
    z = z + probs - probs.detach()
    return z.reshape(z.shape[:-2] + (p.codes * p.classes,))


def heads(wm, h, z, p: DreamerParams):
    feat = torch.cat([h, z], -1)
    n = _n_mlp(p)
    recon = mlp_apply(wm["dec"], feat, n)
    rew_logits = mlp_apply(wm["rew"], feat, n)
    cont_logit = mlp_apply(wm["cont"], feat, n)[..., 0]
    return recon, rew_logits, cont_logit


def kl(logp_a, logp_b):
    """KL(a || b) over the codes' categoricals, summed."""
    pa = torch.exp(logp_a)
    return torch.sum(pa * (logp_a - logp_b), dim=(-1, -2))


def dist_mean(logits, p: DreamerParams):
    """Expected value of a two-hot head, decoded through symexp."""
    edges = bucket_edges(p.bins, logits.device)
    probs = torch.softmax(logits, -1)
    return symexp(torch.sum(probs * edges, -1))


def dist_loss(logits, target, p: DreamerParams):
    hot = twohot(symlog(target), p.bins)
    return -torch.sum(hot * torch.log_softmax(logits, -1), -1)


def wm_loss(wm, batch, p: DreamerParams, n_actions: int,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
    """The world model's loss over [B, T] sequences, and its aux
    (``hs``/``zs`` the posterior states, detached, for imagination).
    Each step's latent sample takes its Gumbel noise from ``generator``,
    or from ``noise[t]`` ([T, B, codes, classes]) when given."""
    B, T = batch["act"].shape
    n = _n_mlp(p)
    embed = enc(wm, batch["obs"], p)  # [B, T, E]
    # Rows are ARRIVAL-aligned (see _push_chunk): obs_t is the
    # observation action act_t landed in, and rew_t/cont_t are that
    # action's outcomes — so the GRU consumes the same-row action and
    # the reward/continue heads train at s_t directly, exactly how
    # imagination reads them.
    a_onehot = one_hot(batch["act"], n_actions)
    dev = a_onehot.device
    h = torch.zeros((B, p.deter_dim), device=dev)
    z = torch.zeros((B, p.codes * p.classes), device=dev)
    hs, zs, priors, posts = [], [], [], []
    for t in range(T):
        # episode boundary: reset the recurrent state and the previous
        # action (the v3 "is_first" mask) so the model never predicts
        # across a reset discontinuity
        first = batch["first"][:, t][:, None]
        h = h * (1.0 - first)
        z = z * (1.0 - first)
        h = gru(wm, h, z, a_onehot[:, t] * (1.0 - first))
        prior_logp = latent_dist(mlp_apply(wm["prior"], h, n), p)
        post_in = torch.cat([h, embed[:, t]], -1)
        post_logp = latent_dist(mlp_apply(wm["post"], post_in, n), p)
        z = sample_latent(post_logp, p, generator,
                          None if noise is None else noise[t])
        hs.append(h)
        zs.append(z)
        priors.append(prior_logp)
        posts.append(post_logp)
    # [B, T, ...]
    hs, zs, priors, posts = (torch.stack(x, 1)
                             for x in (hs, zs, priors, posts))
    recon, rew_logits, cont_logit = heads(wm, hs, zs, p)
    recon_l = torch.mean(torch.sum((recon - symlog(batch["obs"])) ** 2, -1))
    rew_l = torch.mean(dist_loss(rew_logits, batch["rew"], p))
    cont_l = torch.mean(F.binary_cross_entropy_with_logits(
        cont_logit, batch["cont"], reduction="none"))
    dyn = torch.clamp(kl(posts.detach(), priors), min=p.free_bits)
    rep = torch.clamp(kl(posts, priors.detach()), min=p.free_bits)
    total = (p.beta_pred * (recon_l + rew_l + cont_l)
             + p.beta_dyn * dyn.mean() + p.beta_rep * rep.mean())
    aux = {"recon": recon_l, "reward_loss": rew_l, "kl": dyn.mean(),
           "wm_total": total, "hs": hs.detach(), "zs": zs.detach()}
    return total, aux


def imagine(wm, actor, h, z, p: DreamerParams, n_actions: int,
            generator: torch.Generator):
    """``p.horizon`` imagined steps from (h, z) under the actor: ->
    (hs, zs, logps, ents), each [H, N, ...]; ``hs[t]``/``zs[t]`` the state
    arrived at after the action taken from state t."""
    n = _n_mlp(p)
    hs, zs, logps, ents = [], [], [], []
    for _ in range(p.horizon):
        feat = torch.cat([h, z], -1)
        logits = mlp_apply(actor, feat, n)
        a = categorical(logits.detach(), generator)
        logp_all = torch.log_softmax(logits, -1)
        logps.append(take(logp_all, a))
        ents.append(-torch.sum(torch.softmax(logits, -1) * logp_all, -1))
        h = gru(wm, h, z, one_hot(a, n_actions))
        prior_logp = latent_dist(mlp_apply(wm["prior"], h, n), p)
        z = sample_latent(prior_logp, p, generator)
        hs.append(h)
        zs.append(z)
    return (torch.stack(hs), torch.stack(zs), torch.stack(logps),
            torch.stack(ents))


def lambda_returns(rew, disc, val, lam: float):
    """G_t = r_{t+1} + gamma*c_{t+1} * ((1-lam) V(s_{t+1}) + lam G_{t+1}),
    bootstrapped from V(s_H); ``rew``/``disc`` index t is the arrival at
    state t+1 ([H, N]), ``val`` is [H+1, N].  A reverse loop over H."""
    horizon = rew.shape[0]
    nxt = val[-1]
    rets = [None] * horizon
    for t in range(horizon - 1, -1, -1):
        nxt = rew[t] + disc[t] * ((1 - lam) * val[t + 1] + lam * nxt)
        rets[t] = nxt
    return torch.stack(rets)


def actor_loss(wm, actor, critic, h0, z0, p: DreamerParams, n_actions: int,
               generator: torch.Generator):
    """REINFORCE on percentile-normalized lambda-returns of an imagined
    rollout, with the entropy bonus; -> (loss, (feats, rets, live,
    ent_bonus)) for the critic's step."""
    n = _n_mlp(p)
    # logps[t] is the action taken FROM state t; hs/zs[t] is the state
    # arrived at AFTER that action (t = 0..H-1, so state indices run 0..H
    # with 0 = the imagination start).
    hs, zs, logps, ents = imagine(wm, actor, h0, z0, p, n_actions,
                                  generator)
    feat0 = torch.cat([h0, z0], -1)[None]
    feat_arr = torch.cat([hs, zs], -1)
    feats = torch.cat([feat0, feat_arr], 0)  # [H+1, N, F]
    rew = dist_mean(mlp_apply(wm["rew"], feat_arr, n), p)
    cont = torch.sigmoid(mlp_apply(wm["cont"], feat_arr, n)[..., 0])
    val = dist_mean(mlp_apply(critic, feats, n), p)  # [H+1]
    rets = lambda_returns(rew, p.gamma * cont, val, p.lam)
    # continuation weighting: steps imagined past a predicted terminal
    # are fictional — downweight by the probability the trajectory is
    # still alive when the action is taken
    live = torch.cumprod(torch.cat([torch.ones_like(cont[:1]), cont[:-1]],
                                   0), 0).detach()
    # percentile return normalization (v3); jnp.percentile's linear
    # interpolation is torch.quantile's default
    flat = rets.detach().reshape(-1)
    lo = torch.quantile(flat, 0.05)
    hi = torch.quantile(flat, 0.95)
    scale = torch.clamp(hi - lo, min=1.0)
    # baseline: value of the state each action was taken from
    adv = ((rets - val[:-1]) / scale).detach()
    pg = -(live * logps * adv).mean()
    ent_bonus = (live * ents).mean()
    return pg - p.entropy_coef * ent_bonus, (feats, rets, live, ent_bonus)


def critic_loss(critic, critic_ema, feat, rets, live, p: DreamerParams):
    """The critic learns G_t at the state the action was taken from,
    regularized toward the EMA head (v3's "slow critic")."""
    n = _n_mlp(p)
    logits = mlp_apply(critic, feat, n)
    loss = (live * dist_loss(logits, rets, p)).mean()
    with torch.no_grad():
        ema_probs = torch.softmax(mlp_apply(critic_ema, feat, n), -1)
    reg = (live * -torch.sum(ema_probs * torch.log_softmax(logits, -1),
                             -1)).mean()
    return loss + 0.1 * reg


@torch.no_grad()
def policy_step(wm, actor, h, z, obs, prev_a, p: DreamerParams,
                n_actions: int, generator: Optional[torch.Generator],
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One step of acting in the real env: the posterior from ``obs``
    after ``prev_a`` (``-1``: no previous action, a zero one-hot), then an
    action sampled from the actor.  The two samples' Gumbel noise comes
    from ``generator``, or from ``noise`` (latent's, action's)."""
    n = _n_mlp(p)
    latent_noise, action_noise = noise if noise is not None else (None,
                                                                  None)
    h = gru(wm, h, z, one_hot(prev_a, n_actions))
    post_in = torch.cat([h, enc(wm, obs, p)], -1)
    post_logp = latent_dist(mlp_apply(wm["post"], post_in, n), p)
    z = sample_latent(post_logp, p, generator, latent_noise)
    logits = mlp_apply(actor, torch.cat([h, z], -1), n)
    a = categorical(logits, generator, action_noise)
    return h, z, a.int()


class DreamerV3:
    """Single-process learner+collector (vector obs, discrete actions);
    ``device`` None means the card."""

    STATE = ("wm", "actor", "critic", "critic_ema", "wm_opt", "actor_opt",
             "critic_opt")

    def __init__(self, env_name: str, params: Optional[DreamerParams] = None,
                 num_envs: int = 8, seed: int = 0, device=None):
        self.p = p = params or DreamerParams()
        env = make_env(env_name)
        if not isinstance(env, TorchVectorEnv):
            raise TypeError("DreamerV3 here drives torch envs")
        self.env = env
        spec = env.spec
        self.obs_dim, self.n_actions = spec.obs_dim, spec.num_actions
        self.num_envs = num_envs
        self.device = dev = resolve_device(device)
        Z = p.codes * p.classes
        self.wm, self.actor, self.critic = dreamer_init(
            p, self.obs_dim, self.n_actions,
            torch.Generator(device=dev).manual_seed(seed))
        self.critic_ema = copy_tree(self.critic)
        self.wm_tx = Adam(p.lr, 100.0)
        self.actor_tx = Adam(p.actor_lr, 100.0)
        self.critic_tx = Adam(p.critic_lr, 100.0)
        self.wm_opt = self.wm_tx.init(self.wm)
        self.actor_opt = self.actor_tx.init(self.actor)
        self.critic_opt = self.critic_tx.init(self.critic)

        # sequence replay: ring of [T, ...] chunks
        T = p.batch_length
        self.buf_obs = np.zeros((p.buffer_size, T, self.obs_dim), np.float32)
        self.buf_act = np.zeros((p.buffer_size, T), np.int32)
        self.buf_rew = np.zeros((p.buffer_size, T), np.float32)
        self.buf_cont = np.zeros((p.buffer_size, T), np.float32)
        self.buf_first = np.zeros((p.buffer_size, T), np.float32)
        self.buf_pos = 0
        self.buf_size = 0
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self.env_state, self.obs = env.reset(
            torch.Generator(device=dev).manual_seed(seed), num_envs)
        # per-env rolling chunk under construction
        self._chunk = {"obs": [], "act": [], "rew": [], "cont": [],
                       "first": []}
        self._was_done = np.ones((num_envs,), np.float32)  # step 0 is first
        self._h = torch.zeros((num_envs, p.deter_dim), device=dev)
        self._z = torch.zeros((num_envs, Z), device=dev)
        # one_hot(-1) is all zeros: no previous action
        self._prev_a = -torch.ones((num_envs,), dtype=torch.int32,
                                   device=dev)
        self.total_steps = 0
        self.iteration = 0
        self._ep_returns = np.zeros(num_envs)
        self._completed: List[float] = []

    # ---- the updates -------------------------------------------------------
    def _wm_update(self, batch, noise=None):
        total, aux = wm_loss(self.wm, batch, self.p, self.n_actions,
                             self.gen, noise)
        grad_step(total, self.wm, self.wm_tx, self.wm_opt)
        return aux

    def _ac_update(self, start_h, start_z) -> Dict[str, torch.Tensor]:
        p = self.p
        wm = detached(self.wm)
        # flatten replay states into imagination starts
        h0 = start_h.reshape(-1, p.deter_dim).detach()
        z0 = start_z.reshape(-1, p.codes * p.classes).detach()
        a_l, (feats, rets, live, ent) = actor_loss(
            wm, self.actor, detached(self.critic), h0, z0, p,
            self.n_actions, self.gen)
        grad_step(a_l, self.actor, self.actor_tx, self.actor_opt)
        c_l = critic_loss(self.critic, self.critic_ema,
                          feats[:-1].detach(), rets.detach(), live, p)
        grad_step(c_l, self.critic, self.critic_tx, self.critic_opt)
        with torch.no_grad():
            for e, c in zip(tree_leaves(self.critic_ema),
                            tree_leaves(self.critic)):
                e.mul_(p.critic_ema).add_(c, alpha=1 - p.critic_ema)
        return {"actor_loss": a_l.detach(), "critic_loss": c_l.detach(),
                "imag_return": rets.detach().mean(), "entropy": ent.detach()}

    # ---- replay helpers ----------------------------------------------------
    def _push_chunk(self, obs, act, rew, cont, first):
        T = self.p.batch_length
        c = self._chunk
        c["obs"].append(obs)
        c["act"].append(act)
        c["rew"].append(rew)
        c["cont"].append(cont)
        c["first"].append(first)
        if len(c["obs"]) == T:
            # each env contributes one [T] sequence
            obs_b = np.stack(c["obs"], 1)   # [N, T, obs]
            act_b = np.stack(c["act"], 1)
            rew_b = np.stack(c["rew"], 1)
            cont_b = np.stack(c["cont"], 1)
            first_b = np.stack(c["first"], 1)
            for i in range(obs_b.shape[0]):
                j = self.buf_pos
                self.buf_obs[j] = obs_b[i]
                self.buf_act[j] = act_b[i]
                self.buf_rew[j] = rew_b[i]
                self.buf_cont[j] = cont_b[i]
                self.buf_first[j] = first_b[i]
                self.buf_pos = (self.buf_pos + 1) % self.p.buffer_size
                self.buf_size = min(self.buf_size + 1, self.p.buffer_size)
            for k in c:
                c[k].clear()
            return True
        return False

    def _sample_batch(self):
        idx = self.rng.integers(0, self.buf_size, self.p.batch_size)
        dev = self.device
        return {
            "obs": torch.as_tensor(self.buf_obs[idx]).to(dev),
            "act": torch.as_tensor(self.buf_act[idx]).to(dev),
            "rew": torch.as_tensor(self.buf_rew[idx]).to(dev),
            "cont": torch.as_tensor(self.buf_cont[idx]).to(dev),
            "first": torch.as_tensor(self.buf_first[idx]).to(dev),
        }

    # ---- public API --------------------------------------------------------
    def train(self, steps_per_iteration: int = 256) -> Dict[str, Any]:
        p = self.p
        sums: List[Dict[str, torch.Tensor]] = []
        for _ in range(steps_per_iteration // self.num_envs):
            self._h, self._z, actions = policy_step(
                self.wm, self.actor, self._h, self._z, self.obs,
                self._prev_a, p, self.n_actions, self.gen)
            (self.env_state, next_obs, reward, terminated, truncated,
             final_obs) = self.env.step(self.env_state, actions, self.gen)
            host = to_host({"final_obs": final_obs, "actions": actions,
                            "reward": reward, "terminated": terminated,
                            "done": terminated | truncated})
            done = host["done"]
            # Arrival-aligned row: final_obs is the observation this
            # action landed in (pre-reset at terminals, so cont=0 rows
            # stay in the stream); first marks the start of an episode's
            # rows, where the wm loop resets its recurrent state.
            chunk_full = self._push_chunk(
                host["final_obs"], host["actions"], host["reward"],
                1.0 - host["terminated"].astype(np.float32),
                self._was_done.copy())
            self._was_done = done.astype(np.float32)
            self._ep_returns += host["reward"]
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self.obs = next_obs
            self._prev_a = actions
            if done.any():
                # reset recurrent state where an episode ended
                done_t = torch.as_tensor(done).to(self.device)
                mask = (~done_t).float()[:, None]
                self._h = self._h * mask
                self._z = self._z * mask
                # -1 one-hots to all-zeros: the same "no previous
                # action" input the world model was trained with at
                # episode starts
                self._prev_a = torch.where(done_t, -1, self._prev_a)
            self.total_steps += self.num_envs

            if chunk_full and self.buf_size >= p.batch_size:
                for _ in range(p.train_ratio):
                    aux = self._wm_update(self._sample_batch())
                    ac_aux = self._ac_update(aux["hs"], aux["zs"])
                    sums.append({**{k: aux[k].detach() for k in (
                        "recon", "reward_loss", "kl", "wm_total")},
                        **ac_aux})
        self.iteration += 1
        out: Dict[str, Any] = {}
        if sums:
            keys = list(sums[0])
            means = torch.stack([torch.stack([s[k].float() for k in keys])
                                 for s in sums]).mean(0).tolist()
            out = dict(zip(keys, means))
        recent = self._completed[-50:]
        out.update({
            "training_iteration": self.iteration,
            "total_env_steps": self.total_steps,
            "num_updates": len(sums),
            "episode_reward_mean": (float(np.mean(recent)) if recent
                                    else float("nan")),
        })
        return out

    # ---- checkpointing -----------------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {k: to_host(getattr(self, k)) for k in self.STATE} | {
            "total_steps": self.total_steps, "iteration": self.iteration}

    def load_checkpoint(self, state: Dict[str, Any]):
        for k in self.STATE:
            setattr(self, k, to_device(
                state[k], self.device,
                requires_grad=k in ("wm", "actor", "critic")))
        self.total_steps = state["total_steps"]
        self.iteration = state["iteration"]

    def stop(self):
        pass
