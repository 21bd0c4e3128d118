"""Models: the Llama, Mixtral-style MoE and ViT families, the weight
converter and the paged cache ops."""

from ray_tpu_torch.models.llama import LlamaConfig, llama_apply, llama_init
from ray_tpu_torch.models.moe import (MoEConfig, make_moe_trainer, moe_apply,
                                      moe_init, moe_loss)
from ray_tpu_torch.models.vit import (ViTConfig, make_vit_trainer, vit_apply,
                                      vit_init, vit_loss)

__all__ = ["LlamaConfig", "MoEConfig", "ViTConfig", "llama_apply",
           "llama_init", "make_moe_trainer", "make_vit_trainer", "moe_apply",
           "moe_init", "moe_loss", "vit_apply", "vit_init", "vit_loss"]
