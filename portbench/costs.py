"""The benchmark's frozen arithmetic: the H100's published peaks, and the
operations and bytes that a model's work needs, computed from the
configuration alone. They count the same work whatever implements it, so a
later change to the program cannot move them.

Shapes follow the HF config keys of the llama family (Mistral, Mixtral):
fused q/k/v and gate/up matrices, GQA, and for a MoE model top-k of E
experts a token. Weights are int4 with fp32 scales per group along the
contraction dim (`quantization` in the configuration file).
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at the full 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def dims(cfg: dict) -> dict:
    """The sizes every count below needs, from a configuration dict."""
    H = cfg["hidden_size"]
    Nq = cfg["num_attention_heads"]
    Nk = cfg.get("num_key_value_heads") or Nq
    D = cfg.get("head_dim") or H // Nq
    E = cfg.get("num_local_experts") or 0
    return dict(H=H, Nq=Nq, Nk=Nk, D=D, I=cfg["intermediate_size"],
                L=cfg["num_hidden_layers"], V=cfg["vocab_size"], E=E,
                k=cfg.get("num_experts_per_tok") or 0)


def attn_params(cfg: dict) -> int:
    """Parameters of one layer's q/k/v and o projections."""
    d = dims(cfg)
    return d["H"] * (d["Nq"] + 2 * d["Nk"]) * d["D"] + d["Nq"] * d["D"] * d["H"]


def expert_params(cfg: dict) -> int:
    """Parameters of one SwiGLU MLP (gate, up, down): one expert's, or a
    dense layer's."""
    d = dims(cfg)
    return 3 * d["H"] * d["I"]


def layer_params(cfg: dict, active: bool) -> int:
    """Matmul parameters of one layer: every one (active False), or those a
    token touches (active True: k of E experts, and the router)."""
    d = dims(cfg)
    if not d["E"]:
        return attn_params(cfg) + expert_params(cfg)
    experts = d["k"] if active else d["E"]
    return attn_params(cfg) + d["H"] * d["E"] + experts * expert_params(cfg)


def head_params(cfg: dict) -> int:
    d = dims(cfg)
    return d["H"] * d["V"]


def int4_bytes(params: int, group: int) -> float:
    """Bytes of `params` int4 weights: half a byte each, and one fp32 scale
    per group of `group` along the contraction dim."""
    return params * (0.5 + 4.0 / group)


def expected_distinct_experts(cfg: dict, rows: float) -> float:
    """Experts a layer reads for `rows` tokens routed independently and
    uniformly, top-k of E without repeats: E * (1 - (1 - k/E)^rows). An
    expectation: random weights route about uniformly."""
    d = dims(cfg)
    if not d["E"]:
        return 0.0
    return d["E"] * (1.0 - (1.0 - d["k"] / d["E"]) ** rows)


def decode_weight_bytes(cfg: dict, group: int, rows: float = 1.0) -> float:
    """Bytes of the weights one decode step must read at `rows` live rows:
    every int4 matrix of the attention, the router (bf16), the experts
    that `rows` tokens select (expected), the head, and the bf16 norms."""
    d = dims(cfg)
    L = d["L"]
    q = L * attn_params(cfg) + head_params(cfg)
    other = 2 * (2 * L * d["H"] + d["H"])                 # input, post, final norms
    if d["E"]:
        q += L * expected_distinct_experts(cfg, rows) * expert_params(cfg)
        other += 2 * L * d["H"] * d["E"]                  # bf16 router
    else:
        q += L * expert_params(cfg)
    return int4_bytes(q, group) + other


def kv_bytes_per_slot(cfg: dict, elem_bytes: int = 2) -> int:
    """Bytes of one token's K and V over all layers."""
    d = dims(cfg)
    return 2 * d["L"] * d["Nk"] * d["D"] * elem_bytes


def prefill_flops(cfg: dict, S: int) -> float:
    """Model FLOPs of one S-token prompt's prefill: every matmul a token
    touches (2 a multiply-add), the head at the last position only (what a
    prefill must produce: the first token's logits), and causal attention
    (q.k and p.v over i + 1 keys at position i)."""
    d = dims(cfg)
    mm = 2.0 * d["L"] * layer_params(cfg, active=True) * S + 2.0 * head_params(cfg)
    attn = 2.0 * d["L"] * d["Nq"] * d["D"] * S * (S + 1)
    return mm + attn


def decode_flops(cfg: dict, row_steps: float, kv_slots: float) -> float:
    """Model FLOPs of `row_steps` one-token steps whose attention reads
    `kv_slots` K/V slots in all: every matmul a token touches, the head,
    and q.k and p.v over each slot."""
    d = dims(cfg)
    mm = 2.0 * (d["L"] * layer_params(cfg, active=True) + head_params(cfg)) * row_steps
    attn = 4.0 * d["L"] * d["Nq"] * d["D"] * kv_slots
    return mm + attn
