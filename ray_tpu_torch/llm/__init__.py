"""LLM serving and batch inference: the paged continuous-batching engine,
its tokenizer, the disaggregated prefill/decode KV hand-off, the serving
deployments over ``ray_tpu_torch.serve`` and batch inference over
``ray_tpu_torch.data`` actor pools."""

from ray_tpu_torch.llm.batch import LLMPredictor, build_llm_processor
from ray_tpu_torch.llm.engine import (ByteTokenizer, GenerationOutput,
                                      LLMEngine, Request, default_tokenizer)
from ray_tpu_torch.llm.kv_transfer import (KVBlockShipper, KVLandingStrip,
                                           KVShipError)
from ray_tpu_torch.llm.serving import (LLMDecodeServer, LLMDisaggIngress,
                                       LLMPrefillServer, LLMServer,
                                       build_disaggregated_llm_deployment,
                                       build_llm_deployment,
                                       disaggregated_handle)
from ray_tpu_torch.models.generation import SamplingParams

__all__ = ["ByteTokenizer", "GenerationOutput", "KVBlockShipper",
           "KVLandingStrip", "KVShipError", "LLMDecodeServer",
           "LLMDisaggIngress", "LLMEngine", "LLMPredictor",
           "LLMPrefillServer", "LLMServer", "Request", "SamplingParams",
           "build_disaggregated_llm_deployment", "build_llm_deployment",
           "build_llm_processor", "default_tokenizer",
           "disaggregated_handle"]
