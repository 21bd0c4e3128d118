"""Models: the Llama and Mixtral-style MoE families, the weight converter
and the paged cache ops."""

from ray_tpu_torch.models.llama import LlamaConfig, llama_apply, llama_init
from ray_tpu_torch.models.moe import (MoEConfig, make_moe_trainer, moe_apply,
                                      moe_init, moe_loss)

__all__ = ["LlamaConfig", "MoEConfig", "llama_apply", "llama_init",
           "make_moe_trainer", "moe_apply", "moe_init", "moe_loss"]
