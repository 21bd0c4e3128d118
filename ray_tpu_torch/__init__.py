"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model and serving tier.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout (``ops``, ``models``, ``llm``) so every module has a named
counterpart, keeps the JAX public layouts (``q [b, s, h, d]``, KV pool
``[L, num_blocks, block_size, KVH, hd]``) and imports neither ``jax`` nor
anything of ``ray_tpu``.

Entry points (``llama_init``, ``LLMEngine``) run on the GPU unless the
caller passes ``device="cpu"``; without CUDA they raise rather than
carrying on silently on the host.

Numerics are fixed here for the whole package: float32 matrix products
and convolutions run in full float32, never TF32, and bf16 products
accumulate in float32 without reduced-precision split-K reductions, so a
float32 run on the card is comparable with the CPU reference.
"""

from __future__ import annotations

import torch

from ray_tpu_torch._device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["resolve_device"]
