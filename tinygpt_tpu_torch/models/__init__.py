"""Model registry: model_type → namespace of the family's entry points.

Counterpart of tinygpt_tpu/models/__init__.py. llama / qwen2 / qwen3 /
mistral share the generic CausalLM (they differ only by config deltas);
gpt2 is its own module. Every namespace has load_params, init_params,
forward, forward_paged, decode_steps and decode_paged_steps, and
decode_paged_spec_steps where the family has it (not gpt2, as in the JAX
package). mixtral (ROADMAP.md queue 1, item 12) is not ported yet.
"""

from types import SimpleNamespace

import torch

from tinygpt_tpu_torch.models import causal_lm, gpt2

_FAMILY = {
    "llama": causal_lm,
    "qwen2": causal_lm,
    "qwen3": causal_lm,
    "mistral": causal_lm,
    "gpt2": gpt2,
}
_NOT_PORTED = {"mixtral": 12}


def get_model(model_type: str):
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not yet ported to tinygpt_tpu_torch "
            f"(ROADMAP.md queue 1, item {_NOT_PORTED[model_type]})")
    mod = _FAMILY.get(model_type)
    if mod is None:
        raise ValueError(f"unsupported model_type {model_type!r}")
    ns = SimpleNamespace(
        load_params=mod.load_params,
        init_params=mod.init_params,
        forward=mod.forward,
        forward_paged=mod.forward_paged,
        decode_steps=mod.decode_steps,
        decode_paged_steps=mod.decode_paged_steps,
    )
    # the batcher speculates only where the family has a speculative quantum
    if hasattr(mod, "decode_paged_spec_steps"):
        ns.decode_paged_spec_steps = mod.decode_paged_spec_steps
    return ns


def _token_embedding(params):
    """The token-embedding table of any family's params (`embed`, or
    GPT-2's `wte`). It stays in float when the layers are quantized, so
    its device and dtype are the params'."""
    return params["embed"] if "embed" in params else params["wte"]


def params_device(params) -> torch.device:
    return _token_embedding(params).device


def params_dtype(params) -> torch.dtype:
    """The params' compute dtype."""
    return _token_embedding(params).dtype


__all__ = ["get_model", "params_device", "params_dtype", "causal_lm", "gpt2"]
