"""Weights carried across between the JAX Llama and MoE pytrees and the
port.

The JAX side is handed over as numpy arrays (``np.asarray`` of each leaf);
the port keeps the same layout (``x @ W`` weights, layers stacked
``[L, ...]``), so conversion is a bit-exact copy per leaf.

bf16: ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` rejects.  Both directions go through a
16-bit integer view of the same bits, so the round trip is bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.moe import MoEConfig


def _to_torch(a, device: torch.device) -> torch.Tensor:
    # a writable copy: JAX hands out read-only buffers, and the tensor
    # must not alias memory it does not own
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 dtype, the one JAX arrays use

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device=None) -> Dict[str, Any]:
    """The port's params from a JAX ``llama_init`` or ``moe_init`` pytree
    of numpy arrays.
    Per-layer lists (``scan_layers=False``) are stacked to ``[L, ...]``."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        layers = {k: np.stack([np.asarray(lp[k]) for lp in layers])
                  for k in layers[0]}
    if len(next(iter(layers.values()))) != cfg.num_layers:
        raise ValueError("layer count of the tree does not match cfg")
    out = {"embed": _to_torch(tree["embed"], dev),
           "layers": {k: _to_torch(v, dev) for k, v in layers.items()},
           "final_norm": _to_torch(tree["final_norm"], dev)}
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], dev)
    return out


def params_to_jax(params: Dict[str, Any], cfg: LlamaConfig
                  ) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: a pytree of numpy arrays in the
    JAX layout for ``cfg``: per-layer lists for a Llama tree with
    ``scan_layers=False``, else stacked (JAX's ``moe_init`` always
    stacks)."""
    layers = {k: _to_numpy(v) for k, v in params["layers"].items()}
    if not cfg.scan_layers and not isinstance(cfg, MoEConfig):
        layers = [{k: v[i] for k, v in layers.items()}
                  for i in range(cfg.num_layers)]
    out = {"embed": _to_numpy(params["embed"]), "layers": layers,
           "final_norm": _to_numpy(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = _to_numpy(params["lm_head"])
    return out
