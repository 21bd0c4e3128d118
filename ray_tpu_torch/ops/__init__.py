"""Ops: layers, attention dispatch and the CUDA kernels (``ops.cuda``)."""

from ray_tpu_torch.ops.attention import (dot_product_attention,
                                         reference_attention,
                                         sliding_window_mask)
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu, swiglu_op)

__all__ = ["apply_rope", "dot_product_attention", "reference_attention",
           "rms_norm", "rope_frequencies", "sliding_window_mask", "swiglu",
           "swiglu_op"]
