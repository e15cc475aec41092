"""Tensor ops of the port: norms, RoPE, sampling, attention and the Hopper
attention kernels (attention_kernels, built by cuda_build)."""

from tinygpt_tpu_torch.ops.attention import sdpa_with_cache
from tinygpt_tpu_torch.ops.norms import layer_norm, rms_norm
from tinygpt_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_gathered,
    compute_rope_freqs,
)

__all__ = [
    "rms_norm",
    "layer_norm",
    "apply_rope",
    "apply_rope_gathered",
    "compute_rope_freqs",
    "sdpa_with_cache",
]
