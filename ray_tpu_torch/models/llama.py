"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``ray_tpu/models/llama.py``.  Parameters are a plain dict
in the JAX pytree's layout (``x @ W`` weights, layers stacked ``[L, ...]``)
so weights convert one to one (``models/convert.py``) and the tests
compare like with like.  Each weight is cast to ``cfg.dtype`` per matmul;
logits are fp32.  Attention dispatches through ``ops.attention``: the
hand-written CUDA flash kernels (K1 forward, K2/K3 backward) for CUDA
inputs with ``seq >= 256``.

``llama_apply`` is differentiable, as the JAX function is.  When autograd
records (grad mode on and params that require grad) each decoder layer
runs under the config's remat policy; serving, with frozen params or
under ``torch.no_grad()``, builds no graph.  ``llama_loss`` is the
training loss.

Under a mesh (``parallel/``) the params are DTensors placed by
``llama_param_specs`` through a rule table, and the program is the same
global-view program: activations are constrained by logical axes
(``_constrain``, a ``redistribute``), each weight is gathered over the
data axes for its product (the FSDP all-gather, inside the remat region
so the backward replays it), attention runs per local shard or as ring
attention (``ops/attention.py``), and with ``pp > 1`` the layers run
pipelined over the stages (``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import dot_product_attention
# registers the op ray_tpu_torch::flash_attention that save_attn keeps
from ray_tpu_torch.ops.cuda import flash_attention as _flash  # noqa: F401
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu_op)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    mlp_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # under autograd: False (autograd keeps every activation), or a policy.
    # "full": each layer keeps only its input and is replayed in the
    # backward; "save_attn": also keeps the flash op's outputs (out, lse),
    # so the backward replays the layer without K1; "save_attn_mlp": also
    # keeps the swiglu output; "save_dots": keeps the outputs of the
    # products without batch dims (x @ W) and replays the rest, K1 too.
    remat: bool = True
    remat_policy: str = "save_attn"
    # the JAX pytree's layer layout: stacked [L, ...] (True) or a list of
    # per-layer dicts (False).  Only the converter reads it: the port
    # always holds stacked layers.
    scan_layers: bool = True
    attention_impl: str = "auto"
    # sliding-window causal attention: query p attends keys in
    # (p - sliding_window, p].  None = full causal.
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    # microbatches for pipeline parallelism (mesh "pp" axis); default 2*pp
    pp_microbatches: Optional[int] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # --- presets -----------------------------------------------------------
    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120, num_layers=40, num_heads=40, num_kv_heads=40,
            mlp_dim=13824,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, mlp_dim=14336, max_seq_len=8192,
            rope_theta=500000.0,
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale model."""
        defaults = dict(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, mlp_dim=128, max_seq_len=128,
            dtype=torch.float32, param_dtype=torch.float32,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def num_params(self) -> int:
        hd = self.resolved_head_dim
        per_layer = (
            self.hidden_size * (self.num_heads * hd)          # wq
            + 2 * self.hidden_size * (self.num_kv_heads * hd)  # wk, wv
            + (self.num_heads * hd) * self.hidden_size         # wo
            + 3 * self.hidden_size * self.mlp_dim              # gate/up/down
            + 2 * self.hidden_size                             # norms
        )
        embed = self.vocab_size * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * per_layer + self.hidden_size


def llama_init(cfg: LlamaConfig, seed: int = 0,
               device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (None = the GPU).

    Normal(0, 0.02) weights in ``cfg.param_dtype`` and unit norms, as the
    JAX ``llama_init``; the random streams differ, so parity with JAX is
    by shape and scale only.  Layers are stacked ``[L, ...]``.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.resolved_head_dim
    h, L = cfg.hidden_size, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=cfg.param_dtype) * 0.02

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    params = {
        "embed": normal(cfg.vocab_size, h),
        "layers": {
            "attn_norm": ones(L, h),
            "wq": normal(L, h, q_out),
            "wk": normal(L, h, kv_out),
            "wv": normal(L, h, kv_out),
            "wo": normal(L, q_out, h),
            "mlp_norm": ones(L, h),
            "w_gate": normal(L, h, cfg.mlp_dim),
            "w_up": normal(L, h, cfg.mlp_dim),
            "w_down": normal(L, cfg.mlp_dim, h),
        },
        "final_norm": ones(h),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(h, cfg.vocab_size)
    return params


def llama_param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical-axis spec tree matching ``llama_init``'s structure (layers
    stacked, as the port holds them)."""
    layer = {
        "attn_norm": ("norm",),
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
        "mlp_norm": ("norm",),
        "w_gate": ("embed", "mlp"),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    specs = {
        "embed": ("vocab", "embed"),
        "layers": {k: ("layers",) + v for k, v in layer.items()},
        "final_norm": ("norm",),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


def _constrain(x, mesh, *axes, rules=None):
    if mesh is None:
        return x
    from ray_tpu_torch.parallel.sharding import with_logical_constraint

    return with_logical_constraint(x, mesh, *axes, rules=rules)


def _weight(w: torch.Tensor, dt: torch.dtype, mesh) -> torch.Tensor:
    """A weight in the compute dtype; under a mesh also gathered over the
    data axes (dp, fsdp, sp: the FSDP all-gather), keeping its tp shard,
    so its product shards like the reference's Megatron layout.  Cast
    first, so the gather moves ``dt`` bytes."""
    w = w.to(dt)
    if mesh is None:
        return w
    from torch.distributed.tensor import Replicate

    placements = [Replicate() if n in ("dp", "fsdp", "sp") else p
                  for n, p in zip(mesh.mesh_dim_names, w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(mesh, placements)


def _seq_whole(y, mesh, rules, last=None):
    """An activation ``[b, s, last]`` that meets the weights, as the
    product's input or in the residual sum with its output: under a mesh
    with its sequence gathered over sp, as the product (and its
    backward, whose grad keeps the placements of the sum's operands)
    flattens ``[b, s]``, and DTensor cannot fold a sequence sharded
    there in every torch release (``seq`` comes back at the next
    constraint; the ring shards it again)."""
    return _constrain(y, mesh, "batch", None, last, rules=rules)


def stacked_layers(params) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Iterate stacked layer params ``[L, ...]`` as per-layer views.  One
    ``unbind`` per leaf: under autograd its backward is one ``stack``,
    where L ``select``s would each write a full ``[L, ...]`` grad."""
    views = {k: v.unbind(0) for k, v in params["layers"].items()}
    L = len(next(iter(views.values())))
    for i in range(L):
        yield i, {k: v[i] for k, v in views.items()}


def embed_tokens(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                 mesh=None, rules=None, shard=None):
    """Embedding gather in ``cfg.dtype``.  JAX's ``embed[tokens]`` wraps
    negative ids (``ids + V``) and clamps what is still out of range,
    where torch raises (CPU) or asserts on the device (CUDA), so both
    steps are explicit here: -1 reads row V-1, and ids below -V or at V
    and above read the first or last row.

    Under a mesh the gather's operands are pinned first, as the
    reference's ``_embed_lookup``: the table keeps its vocab shard and
    is gathered over the model dim, the ids carry the batch/seq layout,
    so the output is the activation layout (``RAY_TPU_LEGACY_SHARDING=1``
    drops the operand pins: the table keeps its param layout and the ids
    theirs, a plain batch replicated).  The gather itself runs per local
    shard (``_gather_rows``).

    ``shard`` (a ``parallel.local.LocalShard``): the params are this
    rank's local tp shards, the table a block of the vocab; each rank
    gathers its block's rows (``_vocab_rows``) and the rows are summed
    over tp."""
    from ray_tpu_torch.parallel.sharding import (as_global,
                                                 legacy_sharding_enabled)

    table = params["embed"]
    if shard is not None and shard.tp_size > 1:
        local = table.shape[0]
        vocab = local * shard.tp_size
        ids = torch.where(tokens < 0, tokens + vocab, tokens).clamp(
            0, vocab - 1)
        return shard.tp_sum(_vocab_rows(table, ids, shard.tp_rank * local)
                            .to(cfg.dtype))
    if mesh is not None and legacy_sharding_enabled():
        table, tokens = as_global(table, mesh), as_global(tokens, mesh)
    elif mesh is not None:
        table = _constrain(table, mesh, "vocab", None, rules=rules)
        tokens = _constrain(tokens, mesh, "batch", "seq", rules=rules)
    vocab = table.shape[0]
    ids = torch.where(tokens < 0, tokens + vocab, tokens).clamp(0, vocab - 1)
    rows = table[ids] if mesh is None else _gather_rows(table, ids, mesh)
    return _constrain(rows.to(cfg.dtype), mesh, "batch", "seq", None,
                      rules=rules)


def _gather_rows(table, ids, mesh):
    """``table[ids]`` of DTensors, per local shard (``local_map``): each
    rank gathers its ids' rows from its block of the vocab, zeros for ids
    outside it, and the output is their sum over the vocab shards
    (Megatron's vocab-parallel embedding).  DTensor's own rules for the
    gather's backward differ between torch releases (indexing's
    ``index_put`` and ``embedding``'s both fail on one or another), so
    none is used."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if any(isinstance(p, Shard) and p.dim != 0 for p in table.placements):
        table = table.redistribute(mesh, [
            p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)])
    if any(not isinstance(ids.placements[i], Replicate) for i in vocab):
        ids = ids.redistribute(mesh, [Replicate() if i in vocab else p
                                      for i, p in enumerate(ids.placements)])
    shards = math.prod(mesh.shape[i] for i in vocab)
    if table.shape[0] % shards:
        raise ValueError(f"vocab {table.shape[0]} does not split evenly "
                         f"over {shards} shards")
    first = 0
    for i in vocab:
        first = first * mesh.shape[i] + mesh.get_local_rank(i)
    first *= table.shape[0] // shards
    data = [i for i, p in enumerate(ids.placements) if isinstance(p, Shard)]

    def local(ids, table):
        return _vocab_rows(table, ids, first) if vocab else table[ids]

    return local_map(
        local, out_placements=[Partial() if i in vocab else p
                               for i, p in enumerate(ids.placements)],
        in_placements=(ids.placements, table.placements),
        in_grad_placements=(ids.placements, [
            Partial() if i in data else p
            for i, p in enumerate(table.placements)]),
        device_mesh=mesh)(ids, table)


def _vocab_rows(table, ids, first):
    """``table[ids]`` for a table that holds the vocab's rows ``first``
    on: the rows of the ids in it, zeros for the others (one shard of
    Megatron's vocab-parallel lookup, whose sum over the shards is the
    lookup)."""
    idx = ids - first
    hit = (idx >= 0) & (idx < table.shape[0])
    return table[idx.clamp(0, table.shape[0] - 1)] * hit[..., None].to(
        table.dtype)


def lm_head(params, cfg: LlamaConfig, x: torch.Tensor, *, mesh=None,
            rules=None, shard=None) -> torch.Tensor:
    """Final norm and the vocabulary projection, logits in fp32 (both
    operands upcast: exact for bf16 products, fp32 accumulation); under
    a mesh constrained to ("batch", "seq", None).  With ``shard`` (the
    params a rank's local tp shards) each rank projects onto its block
    of the vocab and the blocks are gathered over tp into whole
    logits."""
    x = _seq_whole(rms_norm(x, params["final_norm"]), mesh, rules)
    head = _weight(params["embed"].T if cfg.tie_embeddings
                   else params["lm_head"], cfg.dtype, mesh)
    logits = _constrain(x.float() @ head.float(), mesh, "batch", "seq",
                        None, rules=rules)
    return logits if shard is None else shard.tp_gather(logits)


def attention_block(x, lp, cfg: LlamaConfig, cos, sin, window=None, *,
                    mesh=None, rules=None):
    """The attention half of a decoder layer: ``x`` plus causal attention
    of ``rms_norm(x)`` (keys in ``window``, None = all) through ``wo``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    y = _seq_whole(rms_norm(x, lp["attn_norm"]), mesh, rules)
    q = (y @ _weight(lp["wq"], dt, mesh)).reshape(b, s, cfg.num_heads, hd)
    k = (y @ _weight(lp["wk"], dt, mesh)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (y @ _weight(lp["wv"], dt, mesh)).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = _constrain(q, mesh, "batch", "seq", "heads", None, rules=rules)
    attn = dot_product_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl, mesh=mesh,
                                 window=window)
    attn = _seq_whole(attn.reshape(b, s, cfg.num_heads * hd), mesh, rules,
                      "heads")
    x = _seq_whole(x, mesh, rules) + _seq_whole(
        attn @ _weight(lp["wo"], dt, mesh), mesh, rules)
    return _constrain(x, mesh, "batch", "seq", None, rules=rules)


def _swiglu(gate, up, mesh):
    """``swiglu_op``; under a mesh per local shard (``local_map``), where
    the op has no DTensor sharding rule of its own."""
    if mesh is None:
        return swiglu_op(gate, up)
    from torch.distributed.tensor.experimental import local_map

    layout = list(gate.placements)
    if list(up.placements) != layout:
        up = up.redistribute(mesh, layout)
    return local_map(swiglu_op, out_placements=layout,
                     in_placements=(layout, layout),
                     device_mesh=mesh)(gate, up)


def _decoder_layer(x, lp, *, cfg: LlamaConfig, cos, sin, mesh=None,
                   rules=None):
    x = attention_block(x, lp, cfg, cos, sin, cfg.sliding_window, mesh=mesh,
                        rules=rules)
    dt = cfg.dtype
    y = _seq_whole(rms_norm(x, lp["mlp_norm"]), mesh, rules)
    act = _swiglu(y @ _weight(lp["w_gate"], dt, mesh),
                  y @ _weight(lp["w_up"], dt, mesh), mesh)
    x = _seq_whole(x, mesh, rules) + _seq_whole(
        act @ _weight(lp["w_down"], dt, mesh), mesh, rules)
    return _constrain(x, mesh, "batch", "seq", None, rules=rules)


# The ops whose outputs each selective policy keeps; autograd replays the
# rest of the layer.  JAX names them: "save_attn" keeps the flash op's
# (out, lse) (``attn_out``/``flash_out``/``flash_lse``), "save_attn_mlp"
# also the swiglu output (``mlp_act``), and "save_dots" is
# ``dots_with_no_batch_dims_saveable``: the ``x @ W`` products, which
# dispatch as ``aten.mm``, and not the batched ``aten.bmm`` of the
# reference attention nor the flash op.
_SAVED_OPS = {
    "save_attn": [torch.ops.ray_tpu_torch.flash_attention.default],
    "save_attn_mlp": [torch.ops.ray_tpu_torch.flash_attention.default,
                      torch.ops.ray_tpu_torch.swiglu.default],
    "save_dots": [torch.ops.aten.mm.default],
}


def layer_remat(cfg: LlamaConfig) -> Optional[Callable]:
    """How a decoder layer runs under autograd: ``None`` when remat is off,
    else ``remat(layer_fn, x, lp)`` under the config's policy (JAX's
    ``jax.checkpoint`` policies in ``llama_apply``)."""
    if not cfg.remat:
        return None
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, use_reentrant=False)
    if cfg.remat_policy in _SAVED_OPS:
        return functools.partial(
            checkpoint, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _SAVED_OPS[cfg.remat_policy]))
    raise ValueError(
        f"remat_policy must be 'full', 'save_attn', 'save_attn_mlp' or "
        f"'save_dots', got {cfg.remat_policy!r}")


def records_grad(params) -> bool:
    """Whether autograd records a forward of ``params``: grad mode on and
    params that require grad (a train step, not serving)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in [params["embed"],
                                  *params["layers"].values()])


def rope_tables(cfg: LlamaConfig, s: int, device, mesh=None):
    """The rotary cos/sin tables for ``s`` positions; under a mesh as
    replicated DTensors, so the rotation of sharded q/k stays local."""
    cos, sin = rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                device=device)
    if mesh is None:
        return cos, sin
    from ray_tpu_torch.parallel.sharding import as_global

    return as_global(cos, mesh), as_global(sin, mesh)


def llama_apply(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: LlamaConfig, *, mesh=None, rules=None) -> torch.Tensor:
    """Forward pass: tokens [b, s] int → logits [b, s, vocab] (fp32), on
    the device the params and tokens live on.  When autograd is on and the
    params require grad, each decoder layer runs under ``layer_remat``.

    ``mesh``: params are DTensors (``shard_tree`` by
    ``llama_param_specs``) and ``tokens`` a DTensor or the global batch
    every rank holds; the logits are a DTensor (global view).  ``rules``
    is the rule table the params were sharded with (None =
    ``DEFAULT_RULES``): activations are constrained through the same
    table."""
    from ray_tpu_torch.parallel.mesh import compute_mesh
    from ray_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                 pipeline_microbatches,
                                                 pp_size)

    mesh = compute_mesh(mesh)
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, mesh=mesh, rules=rules)
    remat = layer_remat(cfg) if records_grad(params) else None
    if pp_size(mesh) > 1:
        # layers stage-sharded over "pp", run per local shard: the stage
        # body is the single-device layer with 'ref' attention, as the
        # reference's (it drops constraints under the pipeline's vmap)
        if not cfg.scan_layers:
            raise ValueError("pp>1 requires scan_layers=True (stacked params)")
        if cfg.attention_impl not in ("auto", "ref"):
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} is incompatible "
                "with pp>1: ring needs its own (nested) shard_map and "
                "pallas flash can't be auto-partitioned under the "
                "pipeline's vmapped stage dim; use 'auto' or 'ref'")
        cos, sin = rope_tables(cfg, s, x.device)
        stage = functools.partial(
            _decoder_layer, cfg=dataclasses.replace(cfg, attention_impl="ref"),
            cos=cos, sin=sin)
        x = pipeline_apply(
            stage, params["layers"], x, mesh=mesh, remat=remat,
            num_microbatches=pipeline_microbatches(cfg.pp_microbatches, mesh))
        x = _constrain(x, mesh, "batch", "seq", None, rules=rules)
    else:
        cos, sin = rope_tables(cfg, s, x.device, mesh)
        layer = functools.partial(_decoder_layer, cfg=cfg, cos=cos, sin=sin,
                                  mesh=mesh, rules=rules)
        for _, lp in stacked_layers(params):
            x = layer(x, lp) if remat is None else remat(layer, x, lp)
    return lm_head(params, cfg, x, mesh=mesh, rules=rules)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def next_token_nll(logits: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy [b, s - 1] in fp32 of ``logits`` (of
    ``tokens[:, :-1]``) against the next tokens ``tokens[:, 1:]``.

    DTensor logits go per local shard (``local_map``), the targets
    redistributed to the logits' batch and sequence layout and the
    logits' vocab gathered: the gather's backward would otherwise reshard
    its zero-filled gradient implicitly (``RAY_TPU_LEGACY_SHARDING=1``
    keeps the global gather)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import (as_global,
                                                 legacy_sharding_enabled)

    if not isinstance(logits, DTensor) or legacy_sharding_enabled():
        return _nll(logits, tokens[:, 1:])
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    layout = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
              for p in logits.placements]
    if list(logits.placements) != layout:
        logits = logits.redistribute(mesh, layout)
    targets = as_global(tokens, mesh)[:, 1:]
    if list(targets.placements) != layout:
        targets = targets.redistribute(mesh, layout)
    return local_map(_nll, out_placements=layout,
                     in_placements=(layout, layout),
                     device_mesh=mesh)(logits, targets)


def llama_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig, *, mesh=None, rules=None) -> torch.Tensor:
    """Next-token cross-entropy in fp32; batch has 'tokens' [b, s] and an
    optional 'mask' [b, s] (1 = contribute to the loss).  Under a mesh a
    replicated scalar DTensor."""
    tokens = _constrain(batch["tokens"], mesh, "batch", rules=rules)
    logits = llama_apply(params, tokens[:, :-1], cfg, mesh=mesh, rules=rules)
    nll = next_token_nll(logits, tokens)
    mask = batch.get("mask")
    if mask is not None:
        mask = _constrain(mask, mesh, "batch", rules=rules)[:, 1:].float()
        total, count = _masked_sums(nll, mask)
        loss = total / count.clamp_min(1.0)
    else:
        loss = nll.mean()
    return _constrain(loss, mesh, rules=rules)


def _masked_sums(nll: torch.Tensor, mask: torch.Tensor):
    """``sum(nll * mask)`` and ``sum(mask)``.  DTensors go per local shard
    (``local_map``: the mask redistributed to the nll's layout, partial
    sums over the sharded mesh dims), then replicated explicitly;
    DTensor's own sum and product would reshard the gradient of the
    product and the sum of the mask implicitly
    (``RAY_TPU_LEGACY_SHARDING=1`` keeps them)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import (as_global,
                                                 legacy_sharding_enabled)

    if not isinstance(nll, DTensor) or legacy_sharding_enabled():
        return (nll * mask).sum(), mask.sum()
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = nll.device_mesh
    layout = list(nll.placements)
    mask = as_global(mask, mesh)
    if list(mask.placements) != layout:
        mask = mask.redistribute(mesh, layout)
    sums = [Partial() if isinstance(p, Shard) else Replicate()
            for p in layout]
    total, count = local_map(
        lambda n, m: ((n * m).sum(), m.sum()), out_placements=(sums, sums),
        in_placements=(layout, layout), device_mesh=mesh)(nll, mask)
    whole = [Replicate()] * mesh.ndim
    return total.redistribute(mesh, whole), count.redistribute(mesh, whole)
