"""Model registry: model_type → (load_params, init_params, forward,
decode_steps, decode_paged_steps, decode_paged_spec_steps).

Counterpart of tinygpt_tpu/models/__init__.py. llama / qwen2 / qwen3 /
mistral share the generic CausalLM (they differ only by config deltas).
gpt2 (ROADMAP.md queue 1 item 9) and mixtral (item 12) are not ported yet.
"""

from types import SimpleNamespace

from tinygpt_tpu_torch.models import causal_lm

_FAMILY = {
    "llama": causal_lm,
    "qwen2": causal_lm,
    "qwen3": causal_lm,
    "mistral": causal_lm,
}
_NOT_PORTED = {"gpt2": 9, "mixtral": 12}


def get_model(model_type: str):
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not yet ported to tinygpt_tpu_torch "
            f"(ROADMAP.md queue 1, item {_NOT_PORTED[model_type]})")
    mod = _FAMILY.get(model_type)
    if mod is None:
        raise ValueError(f"unsupported model_type {model_type!r}")
    return SimpleNamespace(
        load_params=mod.load_params,
        init_params=mod.init_params,
        forward=mod.forward,
        decode_steps=mod.decode_steps,
        decode_paged_steps=mod.decode_paged_steps,
        decode_paged_spec_steps=mod.decode_paged_spec_steps,
    )


__all__ = ["get_model", "causal_lm"]
