"""LLM serving: the paged continuous-batching engine and its tokenizer."""

from ray_tpu_torch.llm.engine import (ByteTokenizer, GenerationOutput,
                                      LLMEngine, Request, default_tokenizer)
from ray_tpu_torch.models.generation import SamplingParams

__all__ = ["ByteTokenizer", "GenerationOutput", "LLMEngine", "Request",
           "SamplingParams", "default_tokenizer"]
