"""JAX RL parameter trees into the port's tensors.

``ray_tpu.rl``'s parameters are nested dicts of arrays (``jax.device_get``
gives them as numpy), keyed exactly as the port's (``rl/models.py``):
``w{i}`` ``[din, dout]`` and ``b{i}`` per MLP, Dreamer's linear layers as
``{"w", "b"}``, SAC's temperature a scalar ``log_alpha``.  So the
conversion is key for key, with no transpose.  ``load_jax_weights`` sets
the trees of one of the port's RL objects by the reference's attribute
names, and resets the optimizer state to fresh (as a fresh reference
instance holds it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl.models import to_device

# the reference attributes that hold each family's trees: the trained
# ones (leaves that require grad), then the targets
TRAINED = {
    "PPOLearner": ("params",),
    "ImpalaLearner": ("params",),
    "DQN": ("q_params",),
    "SAC": ("params",),
    "CQL": ("params",),
    "MARWIL": ("params",),
    "BC": ("params",),
    "DreamerV3": ("wm", "actor", "critic"),
}
TARGETS = {
    "DQN": ("target_params",),
    "SAC": ("target",),
    "CQL": ("target",),
    "DreamerV3": ("critic_ema",),
}
# the optimizer state of each trained tree: (tree, state attr, optimizer)
OPTIMIZERS = {
    "DreamerV3": (("wm", "wm_opt", "wm_tx"), ("actor", "actor_opt",
                                              "actor_tx"),
                  ("critic", "critic_opt", "critic_tx")),
}


def params_from_jax(tree, device="cpu", requires_grad: bool = True):
    """A JAX RL tree (nested dicts of numpy or jax arrays) as fp32 leaf
    tensors on ``device``, key for key."""
    return to_device(_numpy(tree), torch.device(device),
                     requires_grad=requires_grad)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def load_jax_weights(obj, trees: Dict[str, Any]) -> None:
    """Set ``obj``'s trees (a ``PPOLearner``, ``ImpalaLearner``, ``DQN``,
    ``SAC``, ``CQL``, ``MARWIL``/``BC`` or ``DreamerV3``) from the JAX
    instance's, by the reference's attribute names (``trees``: name ->
    tree, e.g. ``{"q_params": ..., "target_params": ...}``), on ``obj``'s
    device, and give each trained tree a fresh optimizer state."""
    kind = next(c.__name__ for c in type(obj).__mro__
                if c.__name__ in TRAINED)
    dev = obj.device
    for name, tree in trees.items():
        if name in TRAINED[kind]:
            setattr(obj, name, params_from_jax(tree, dev))
        elif name in TARGETS.get(kind, ()):
            setattr(obj, name, params_from_jax(tree, dev,
                                               requires_grad=False))
        else:
            raise KeyError(f"{kind} has no tree {name!r}; its trees are "
                           f"{TRAINED[kind] + TARGETS.get(kind, ())}")
    for tree_name, state_name, tx_name in OPTIMIZERS.get(
            kind, ((TRAINED[kind][0], "opt_state", "tx"),)):
        setattr(obj, state_name,
                getattr(obj, tx_name).init(getattr(obj, tree_name)))
