"""Port parity: the parallel layer (meshes, logical-axis rules as DTensor
placements, ring and per-shard attention, the pipeline schedule, the
Llama and MoE models and the Trainer on a mesh) against JAX's on a CPU
mesh.

The units run in this process.  The port's mesh paths run in four gloo
ranks (``test_torch_parallel_ranks.py``, spawned once for the module and
joined with a timeout that kills them); the JAX side runs here after
them, on a mesh of the same shape over four of the eight host devices.  Weights come from JAX's initialisers through ``models/convert.py``,
tokens and attention inputs from numpy seeds.  Float32 throughout; each
tolerance states its reason.
"""

import dataclasses
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.distributed.tensor import Shard

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtraining
from ray_tpu.ops import attention as jattn
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "test_torch_parallel_ranks.py")
WORLD = 4
# the ranks take ~15 s alone and a few times that beside a loaded suite;
# a hung collective must not hold the suite past this
SPAWN_TIMEOUT_S = 300
# fp32 sums over shards, rings and stages in another order than JAX's:
# the tolerances of the single-device parity tests (test_torch_train.py)
ATOL, RTOL = 1e-5, 1e-4
# the trainer's (test_torch_train.py): loss, grad norm, params after 3 steps
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup=1, decay_steps=10)


# ---------------------------------------------------------------------------
# units: MeshConfig, presets, rule tables, placements
# ---------------------------------------------------------------------------

CONFIGS = [dict(), dict(dp=2), dict(dp=-1, tp=2), dict(dp=1, fsdp=-1, tp=2),
           dict(dp=-1, tp=4), dict(dp=1, fsdp=2, pp=2, sp=2),
           dict(dp=-1, sp=3), dict(dp=0), dict(dp=-1, fsdp=-1),
           dict(dp=3, tp=2), dict(dp=1, fsdp=8, tp=2)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_mesh_config_resolve_and_clamp_match_jax(kw, n):
    """``resolve`` (shapes and axis-named errors word for word) and
    ``clamp_to`` on 1/2/4/8 devices as JAX's ``MeshConfig``."""
    want, got = jmesh.MeshConfig(**kw), tmesh.MeshConfig(**kw)
    assert _outcome(lambda: got.resolve(n)) == _outcome(
        lambda: want.resolve(n))
    assert _outcome(lambda: dataclasses.astuple(got.clamp_to(n))) == \
        _outcome(lambda: dataclasses.astuple(want.clamp_to(n)))
    assert _outcome(lambda: tmesh.mesh_shape_for(n, got)) == _outcome(
        lambda: jmesh.mesh_shape_for(n, want))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_presets_and_resolve_mesh_config_match_jax(n):
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert {k: dataclasses.astuple(v) for k, v in
            tmesh.MESH_PRESETS.items()} == {
        k: dataclasses.astuple(v) for k, v in jmesh.MESH_PRESETS.items()}
    for name, cfg in tmesh.MESH_PRESETS.items():
        assert cfg.clamp_to(n).resolve(n) == \
            jmesh.MESH_PRESETS[name].clamp_to(n).resolve(n)
    for req in ("fsdp", "nope", None, 3):
        got = _outcome(lambda: tmesh.resolve_mesh_config(req))
        want = _outcome(lambda: jmesh.resolve_mesh_config(req))
        if got[0] == "ok" and got[1] is not None:
            got = ("ok", dataclasses.astuple(got[1]))
            want = ("ok", dataclasses.astuple(want[1]))
        assert got == want


def test_rule_tables_match_jax():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert tsharding.TP_INFERENCE_RULES == jsharding.TP_INFERENCE_RULES
    assert tsharding.ENV_LEGACY_SHARDING == jsharding.ENV_LEGACY_SHARDING


def _spec_leaves(tree, path=()):
    if isinstance(tree, tuple):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _spec_leaves(v, path + (k,))]
    return [x for i, v in enumerate(tree) for x in _spec_leaves(v, path + (i,))]


def _spec_trees():
    jl, tl = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jm, tm = jmoe.MoEConfig.tiny_moe(), tmoe.MoEConfig.tiny_moe()
    return {"llama": (jllama.llama_param_specs(jl),
                      tllama.llama_param_specs(tl)),
            "llama_tied": (jllama.llama_param_specs(
                dataclasses.replace(jl, tie_embeddings=True)),
                tllama.llama_param_specs(
                dataclasses.replace(tl, tie_embeddings=True))),
            "moe": (jmoe.moe_param_specs(jm), tmoe.moe_param_specs(tm))}


def test_spec_trees_match_jax():
    for want, got in _spec_trees().values():
        assert got == want


def test_every_logical_axis_has_a_rule():
    """A logical axis with no rule would replicate silently: each one the
    port's spec trees (and the activation constraints) name has an entry
    in both rule tables."""
    used = {"batch", "seq"}
    for _, tree in _spec_trees().values():
        used |= {a for _, axes in _spec_leaves(tree) for a in axes
                 if a is not None}
    for rules in (tsharding.DEFAULT_RULES, tsharding.TP_INFERENCE_RULES):
        assert used <= set(rules), used - set(rules)


def _layout_of_pspec(pspec, ndim, sizes):
    """Per tensor dim, the mesh axes of size > 1 that shard it."""
    out = []
    for i in range(ndim):
        entry = pspec[i] if i < len(pspec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(tuple(a for a in axes if sizes[a] > 1))
    return out


def _layout_of_placements(placements, ndim, names):
    out = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            out[p.dim].append(name)
    return [tuple(x) for x in out]


MESHES = {
    # (axis names, shape): full five-axis meshes and partial ones
    "full_2x2x1x2x1": (jmesh.MESH_AXES, (2, 2, 1, 2, 1)),
    "full_1x2x2x1x2": (jmesh.MESH_AXES, (1, 2, 2, 1, 2)),
    "full_all_2": (jmesh.MESH_AXES, (2, 2, 2, 2, 2)),
    "partial_dp_tp": (("dp", "tp"), (2, 4)),
    "partial_fsdp_sp": (("fsdp", "sp"), (4, 2)),
    "partial_dp_fsdp_pp": (("dp", "fsdp", "pp"), (2, 2, 2)),
}


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "TP_INFERENCE_RULES"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("family", ["llama", "llama_tied", "moe"])
def test_placements_match_pspecs(family, mesh_name, rules):
    """``logical_to_placements`` lays out every leaf of the spec tree as
    ``logical_to_pspec`` does: the same mesh axes on each tensor dim, in
    the same order (axes of size 1 shard nothing on either side).  The
    32-device mesh is compared with JAX's spec on no mesh, which uses
    every axis as a mesh of them all would."""
    names, shape = MESHES[mesh_name]
    n = int(np.prod(shape))
    duck = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    sizes = dict(zip(names, shape))
    jmesh_ = (Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
              if n <= len(jax.devices()) else None)
    want_tree, tree = _spec_trees()[family]
    assert tree == want_tree
    for path, axes in _spec_leaves(tree):
        pspec = jsharding.logical_to_pspec(axes, getattr(jsharding, rules),
                                           mesh=jmesh_)
        got = tsharding.logical_to_placements(
            axes, getattr(tsharding, rules), mesh=duck)
        assert len(got) == len(names)
        assert _layout_of_placements(got, len(axes), names) == \
            _layout_of_pspec(pspec, len(axes), sizes), (path, axes, pspec)


def test_rule_out_of_mesh_order_is_refused():
    duck = types.SimpleNamespace(mesh_dim_names=jmesh.MESH_AXES,
                                 shape=(2, 2, 1, 1, 1))
    with pytest.raises(ValueError, match="in the mesh's order"):
        tsharding.logical_to_placements(
            ("batch",), {"batch": ("fsdp", "dp")}, mesh=duck)


# ---------------------------------------------------------------------------
# the ranks, and JAX's side computed meanwhile
# ---------------------------------------------------------------------------

def _jax_cfg(**kw):
    return jllama.LlamaConfig.tiny(**kw)


def _inputs():
    """The JAX trees and numpy arrays, and the port's inputs from them."""
    jcfg, mcfg = _jax_cfg(), jmoe.MoEConfig.tiny_moe(dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax.jit(
        jllama.llama_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    mtree = jax.tree.map(np.asarray, jax.jit(
        jmoe.moe_init, static_argnums=1)(jax.random.PRNGKey(1), mcfg))
    rng = np.random.default_rng(0)
    arrays = {
        "tokens": rng.integers(0, jcfg.vocab_size, (8, 17)).astype(np.int32),
        "mask": (rng.random((8, 17)) < 0.7).astype(np.int32),
        "q": rng.standard_normal((2, 16, 4, 16)).astype(np.float32),
        "k": rng.standard_normal((2, 16, 2, 16)).astype(np.float32),
        "v": rng.standard_normal((2, 16, 2, 16)).astype(np.float32),
        "dout": rng.standard_normal((2, 16, 4, 16)).astype(np.float32)}
    port = {"llama": params_from_jax(tree, tllama.LlamaConfig.tiny(),
                                     device="cpu"),
            "moe": params_from_jax(mtree, tmoe.MoEConfig.tiny_moe(
                dtype=torch.float32), device="cpu"),
            **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()}}
    port["tokens"] = port["tokens"].long()
    port["mask"] = port["mask"].long()
    return port, {"llama": tree, "moe": mtree, **arrays}


def _mesh(**kw):
    return jmesh.create_mesh(jmesh.MeshConfig(**kw),
                             devices=jax.devices()[:WORLD])


def _attention_refs(a, mesh, variants):
    out = {}
    for name, impl, causal, window in variants:
        def f(q, k, v):
            if impl == "ring":
                return jattn.ring_attention(q, k, v, mesh=mesh, causal=causal,
                                            window=window)
            return jattn.dot_product_attention(q, k, v, causal=causal,
                                               impl="ref", mesh=mesh,
                                               window=window)
        def out_and_grads(q, k, v, dout, f=f):
            o, vjp = jax.vjp(f, q, k, v)
            return (o,) + vjp(dout)

        o, dq, dk, dv = jax.jit(out_and_grads)(a["q"], a["k"], a["v"],
                                               a["dout"])
        out[name] = {"out": o, "dq": dq, "dk": dk, "dv": dv}
    return out


def _llama_refs(a, mesh, rows=None, **cfg_kw):
    cfg = _jax_cfg(**cfg_kw)
    batch = {"tokens": a["tokens"][:rows], "mask": a["mask"][:rows]}
    logits = jax.jit(lambda p, t: jllama.llama_apply(p, t, cfg, mesh=mesh))(
        a["llama"], batch["tokens"][:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jllama.llama_loss(p, b, cfg, mesh=mesh)))(
        a["llama"], batch)
    return {"logits": logits, "loss": loss, "grads": grads}


def _legacy_llama_refs(a, mesh, **cfg_kw):
    os.environ[jsharding.ENV_LEGACY_SHARDING] = "1"
    try:
        return _llama_refs(a, mesh, **cfg_kw)
    finally:
        del os.environ[jsharding.ENV_LEGACY_SHARDING]


def _trainer_refs(a, mesh, accum_steps=1, masked=False):
    tr = jtraining.make_llama_trainer(
        _jax_cfg(), mesh, optimizer=jtraining.default_optimizer(**OPT),
        accum_steps=accum_steps)
    state = tr.init_state(jax.random.PRNGKey(0))
    batch = {"tokens": a["tokens"]}
    if masked:
        batch["mask"] = a["mask"]
    batch = tr.shard_batch(batch)
    metrics = []
    for _ in range(3):
        state, m = tr.step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return {"metrics": metrics,
            "params": jax.tree.map(np.asarray, state["params"])}


def _moe_refs(a, mesh):
    cfg = jmoe.MoEConfig.tiny_moe(dtype=jnp.float32)
    logits, aux = jax.jit(lambda p, t: jmoe.moe_apply(p, t, cfg, mesh=mesh))(
        a["moe"], a["tokens"][:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmoe.moe_loss(p, b, cfg, mesh=mesh)))(
        a["moe"], {"tokens": a["tokens"]})
    try:
        jpipeline.reject_pp(_mesh(dp=1, fsdp=2, pp=2), "MoE")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"logits": logits, "aux": aux, "loss": loss, "grads": grads,
            "pp_refusal": refusal}


RING = [("causal", "ring", True, None), ("non_causal", "ring", False, None),
        ("window", "ring", True, 5)]
PER_SHARD = [("flash", "flash", True, None), ("ref", "ref", True, None),
             ("ref_window", "ref", True, 5)]


def _jax_refs(a):
    """JAX's results for every case of the ranks, on meshes of the same
    shapes over four host devices ('ref' attention where the port runs
    the flash kernels' plain versions)."""
    return {
        "ring_sp4": _attention_refs(a, _mesh(dp=1, sp=4), RING),
        "ring_sp2_tp2": _attention_refs(a, _mesh(dp=1, tp=2, sp=2), RING),
        "per_shard_fsdp_tp": _attention_refs(
            a, _mesh(dp=1, fsdp=2, tp=2), PER_SHARD),
        "llama_dp": _llama_refs(a, _mesh(dp=-1)),
        "llama_fsdp": _llama_refs(a, _mesh(dp=1, fsdp=-1)),
        "llama_fsdp_tp": _llama_refs(a, _mesh(dp=1, fsdp=-1, tp=2)),
        "llama_fsdp_tp_legacy": _legacy_llama_refs(
            a, _mesh(dp=1, fsdp=-1, tp=2)),
        "llama_fsdp_sp": _llama_refs(a, _mesh(dp=1, fsdp=2, sp=2)),
        "llama_pp": _llama_refs(a, _mesh(dp=1, fsdp=2, pp=2),
                                pp_microbatches=4),
        "llama_pp_b4": _llama_refs(a, _mesh(dp=1, fsdp=2, pp=2), rows=4),
        "train_fsdp": _trainer_refs(a, _mesh(dp=1, fsdp=-1)),
        "train_fsdp_tp": _trainer_refs(a, _mesh(dp=1, fsdp=-1, tp=2)),
        "train_fsdp_accum": _trainer_refs(a, _mesh(dp=1, fsdp=-1),
                                          accum_steps=2, masked=True),
        "moe_fsdp_tp": _moe_refs(a, _mesh(dp=1, fsdp=2, tp=2)),
    }


def _tail(path, n=3000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError as e:
        return str(e)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks, join them within ``SPAWN_TIMEOUT_S`` (killing
    them and failing past it), then compute JAX's side, and return
    ``(port results, JAX results)``."""
    work = tmp_path_factory.mktemp("parallel_ranks")
    port_inputs, arrays = _inputs()
    torch.save(port_inputs, work / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, RANKS, str(WORLD), str(r), str(work)], env=env,
        stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        for p in procs:
            remaining = SPAWN_TIMEOUT_S - (time.monotonic() - t0)
            try:
                p.wait(timeout=max(remaining, 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"ranks still running after {SPAWN_TIMEOUT_S} "
                            f"s; rank 0's log:\n{_tail(work / 'rank0.log')}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"ranks {bad} exited non-zero; rank {bad[0]}'s log:\n"
                    + _tail(work / f"rank{bad[0]}.log"))
    # after the ranks, not beside them: the file then adds at most four
    # busy cores, or JAX's, to the suite's load at a time
    return torch.load(work / "results.pt"), _jax_refs(arrays)


def _case(runs, name):
    got = runs[0][name]
    if "error" in got:
        pytest.fail(f"case {name} raised in the ranks:\n{got['error']}")
    return got, runs[1].get(name)


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _close_tree(got, want, atol=ATOL, rtol=RTOL, what=""):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], atol, rtol, f"{what}/{k}")
        else:
            _close(got[k], want[k], atol, rtol, f"{what}/{k}")


@pytest.mark.parametrize("variant", [v[0] for v in RING])
@pytest.mark.parametrize("case", ["ring_sp4", "ring_sp2_tp2"])
def test_ring_attention_matches_jax(runs, case, variant):
    """``ring_attention`` (GQA 4/2, K/V rotating by point-to-point sends
    with gradients) against JAX's ring on the same mesh: output and the
    grads of sum(out * dout), to 1e-5 (fp32 online softmax over the same
    blocks)."""
    got, want = _case(runs, case)
    for key in ("out", "dq", "dk", "dv"):
        _close(got[variant][key], want[variant][key], 1e-5, 1e-5,
               f"{case}/{variant}/{key}")
    assert "Shard(dim=1)" in got[variant]["placements"]


@pytest.mark.parametrize("variant", [v[0] for v in PER_SHARD])
def test_per_shard_attention_matches_jax(runs, variant):
    """``impl='flash'`` (K1/K2/K3's plain versions on each rank's batch
    and heads) and 'ref' per local shard under fsdp=2 x tp=2 against
    JAX's 'ref' on the same mesh."""
    got, want = _case(runs, "per_shard_fsdp_tp")
    for key in ("out", "dq", "dk", "dv"):
        _close(got[variant][key], want[variant][key], what=f"{variant}/"
               + key)
    assert "Shard(dim=0)" in got[variant]["placements"] and \
        "Shard(dim=2)" in got[variant]["placements"]


@pytest.mark.parametrize("case", ["llama_dp", "llama_fsdp", "llama_fsdp_tp",
                                  "llama_fsdp_tp_legacy", "llama_fsdp_sp",
                                  "llama_pp", "llama_pp_b4"])
def test_llama_on_mesh_matches_jax(runs, case):
    """``llama_apply`` logits and ``llama_loss`` (masked) with its grads on
    the presets dp, fsdp and fsdp_tp at world 4 ('flash' per shard under
    fsdp and fsdp_tp; fsdp_tp also with ``RAY_TPU_LEGACY_SHARDING=1`` on
    both sides), on fsdp=2 x sp=2 ('auto' takes the ring) and on
    fsdp=2 x pp=2 with 4 microbatches, at 8 rows and at 4 (the default
    M = 2 * pp: a microbatch's one row does not split over fsdp), against
    JAX on the same mesh."""
    got, want = _case(runs, case)
    assert got["params_are_dtensors"]
    _close(got["logits"], want["logits"], what="logits")
    _close(got["loss"], want["loss"], 0, LOSS_RTOL, "loss")
    _close_tree(got["grads"], jax.tree.map(np.asarray, want["grads"]),
                what="grads")


@pytest.mark.parametrize("case", ["train_fsdp", "train_fsdp_tp",
                                  "train_fsdp_accum"])
def test_trainer_on_mesh_matches_jax(runs, case):
    """Three steps of ``make_llama_trainer`` on fsdp and fsdp_tp at world
    4 (and fsdp with ``accum_steps=2`` on a masked batch, microbatches of
    the global rows as JAX's) from the converted weights, against JAX's
    trainer on the same mesh: loss, grad norm (clipped over all shards),
    and every param after; the AdamW moments are DTensors, and each
    rank's local rows make the same batch as the global one."""
    got, want = _case(runs, case)
    for (gl, gn), (wl, wn) in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
    _close_tree(got["params"], want["params"], PARAM_ATOL, 0, "params")
    assert got["moments_are_dtensors"] and got["local_rows_equal_global"]


@pytest.mark.parametrize("policy", ["save_attn", "save_attn_mlp",
                                    "save_dots", "full"])
def test_flash_forwards_per_step_same_on_mesh(runs, policy):
    """K1's forwards per train step (its plain version counted) are the
    same on a fsdp x tp mesh as without one: L, L, 2L and 2L under
    save_attn, save_attn_mlp, save_dots and full, JAX's jaxpr counts
    (test_torch_train.py)."""
    got, _ = _case(runs, "flash_counts")
    L = tllama.LlamaConfig.tiny().num_layers
    want = L * (2 if policy in ("save_dots", "full") else 1)
    assert got[f"{policy}_mesh"] == got[f"{policy}_none"] == want


def test_moe_on_mesh_matches_jax(runs):
    """``moe_apply`` (logits, router aux) and ``moe_loss`` with its grads
    under fsdp=2 x tp=2 (experts over tp) against JAX on the same
    mesh."""
    got, want = _case(runs, "moe_fsdp_tp")
    _close(got["logits"], want["logits"], what="logits")
    _close(got["aux"], want["aux"], 0, 1e-5, "aux")
    _close(got["loss"], want["loss"], 0, LOSS_RTOL, "loss")
    _close_tree(got["grads"], jax.tree.map(np.asarray, want["grads"]),
                what="grads")


def test_moe_trainer_refuses_pp_as_jax(runs):
    got, want = _case(runs, "moe_fsdp_tp")
    assert got["pp_refusal"] is not None
    assert got["pp_refusal"] == want["pp_refusal"]
