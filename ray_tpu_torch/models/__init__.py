"""Models: the Llama family, its weight converter and the paged cache ops."""

from ray_tpu_torch.models.llama import LlamaConfig, llama_apply, llama_init

__all__ = ["LlamaConfig", "llama_apply", "llama_init"]
