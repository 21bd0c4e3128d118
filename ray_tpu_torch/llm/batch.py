"""Batch LLM inference over ``ray_tpu_torch.data`` Datasets (counterpart of
``ray_tpu/llm/batch.py``).

A stateful :class:`LLMPredictor` callable (one engine per actor, built
once) applied by ``map_batches(compute=ActorPoolStrategy)``.  The port's
map actors are threads of the calling process, so an engine built in one
may take the caller's weights through ``engine_kwargs["params"]`` and
shares the caller's card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class LLMPredictor:
    """Stateful map_batches callable: holds one LLMEngine per actor."""

    def __init__(self, engine_kwargs: Optional[Dict[str, Any]] = None,
                 prompt_column: str = "prompt",
                 output_column: str = "generated",
                 sampling: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.models.generation import SamplingParams
        from ray_tpu_torch.models.llama import LlamaConfig

        kw = dict(engine_kwargs or {})
        cfg = kw.pop("cfg", None) or LlamaConfig.tiny()
        self.engine = LLMEngine(cfg, **kw)
        self.prompt_column = prompt_column
        self.output_column = output_column
        sp = dict(sampling or {})
        sp.setdefault("stop_token_id", self.engine.tokenizer.eos_id)
        self.sampling = SamplingParams(**sp)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prompts = [str(p) for p in batch[self.prompt_column]]
        outs = self.engine.generate(prompts, self.sampling)
        batch[self.output_column] = np.array([o.text for o in outs],
                                             dtype=object)
        return batch


def build_llm_processor(dataset, *, engine_kwargs: Optional[Dict] = None,
                        concurrency: int = 1, batch_size: int = 16,
                        prompt_column: str = "prompt",
                        output_column: str = "generated",
                        sampling: Optional[Dict[str, Any]] = None,
                        num_gpus: float = 0):
    """dataset -> dataset with ``output_column`` of generations.  The
    engine runs where ``engine_kwargs["device"]`` says (none: the card,
    raising without CUDA).  ``num_gpus`` stands for the reference's
    ``num_tpus`` and reserves nothing: the map actors are threads of this
    process."""
    from ray_tpu_torch.data import ActorPoolStrategy

    return dataset.map_batches(
        LLMPredictor,
        fn_args=(engine_kwargs, prompt_column, output_column, sampling),
        batch_size=batch_size,
        compute=ActorPoolStrategy(size=concurrency,
                                  max_tasks_in_flight_per_actor=1))
