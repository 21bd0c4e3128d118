"""LLM serving: the paged continuous-batching engine, its tokenizer and
the disaggregated prefill/decode KV hand-off."""

from ray_tpu_torch.llm.engine import (ByteTokenizer, GenerationOutput,
                                      LLMEngine, Request, default_tokenizer)
from ray_tpu_torch.llm.kv_transfer import (KVBlockShipper, KVLandingStrip,
                                           KVShipError)
from ray_tpu_torch.models.generation import SamplingParams

__all__ = ["ByteTokenizer", "GenerationOutput", "KVBlockShipper",
           "KVLandingStrip", "KVShipError", "LLMEngine", "Request",
           "SamplingParams", "default_tokenizer"]
