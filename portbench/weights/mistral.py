"""The benchmark's inputs for the Mistral family (dense and MoE, HF
MistralForCausalLM and MixtralForCausalLM): every weight at int4, made on
the device from the seed, in the form it is served in.

The matrices are drawn straight as packed int4 (int4.py; no bf16 matrix is
made and quantized), a weight's standard deviation about 0.02. The
embedding is bf16 N(0, 0.02^2); the norm weights bf16 1 + N(0, 0.1^2), so
that a weight read at another layer shows. The head's vocabulary is padded
with zero columns to a multiple of 2048.

A MoE model's routing is made well conditioned without changing the
scale of the residual stream. A random router sends a token to experts
whose logits lie within the program's rounding of the third's, and bf16
against fp32 then picks other experts for some tokens in some layers (5.6 %
of the decisions in a 32-layer run), which parts the program from any fp32
reference however sound it is. So the first E coordinates of the hidden
state are kept for routing: token t's embedding holds 0.3 at coordinate
first_t and 0.2 at second_t and 0 at the other E - 2 (its other coordinates
are N(0, 0.02^2), as a dense model's); no layer writes there (the output
columns 0 .. E - 1 of every o and expert down matrix are q = 0); layer l's
router reads coordinate pi_l(e) for expert e with a gain of 0.25 and nothing
else, pi_l a permutation of the layer's own. In every layer a token's two
coordinates then give its pair of experts positive logits and every other
expert exactly 0, in bf16 as in fp32, whatever the rest of the stream
holds, and the routing coordinates carry about 7 % of the embedding's
energy and a vanishing share of the later stream's: attention, the pool and
the experts set the logits as in a dense model. Every token takes 2 of E
experts, its pair uniform over the pairs.

One torch.Generator on the device, seeded with the seed, draws every tensor
in a fixed order, a layer of a stack a call: the same seed gives the same
bytes. The returned dict holds plain tensors; the system under test and the
reference are each handed the same ones.
"""

from __future__ import annotations

import torch

from portbench.weights.int4 import ZERO, int4_stack, padded_head

ROUTE_EMBED = (0.3, 0.2)   # a token's embedding at its first and second routing coordinate
ROUTE_GAIN = 0.25          # the router's weight on a layer's routing coordinate


def _routed_embedding(gen, V, H, E, L, device):
    """(embedding [V, H] bf16, router [L, H, E] bf16, each token's pair of
    routing coordinates [V, 2]) of a MoE model whose top-2 routing each
    token decides exactly (module docstring). A token's experts in layer l
    are its pair's coordinates through pi_l, so the number of distinct
    experts a set of tokens needs is the same in every layer: the distinct
    coordinates among their pairs."""
    first = torch.randint(0, E, (V,), generator=gen, device=device)
    second = (first + torch.randint(1, E, (V,), generator=gen, device=device)) % E
    emb = torch.randn((V, H), generator=gen, device=device) * 0.02
    emb[:, :E] = 0.0
    rows = torch.arange(V, device=device)
    emb[rows, first] = ROUTE_EMBED[0]
    emb[rows, second] = ROUTE_EMBED[1]
    perm = torch.stack([torch.randperm(E, generator=gen, device=device) for _ in range(L)])
    router = torch.zeros((L, H, E), device=device)
    router[:, :E, :] = ROUTE_GAIN * torch.eye(E, device=device)[perm].transpose(1, 2)
    pairs = torch.stack([first, second], dim=1).cpu().numpy()          # [V, 2]
    return emb.to(torch.bfloat16), router.to(torch.bfloat16), pairs


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of a Mistral-family model (dense or MoE) at int4, group
    `cfg["quantization"]["group_size"]`, from `seed`. Keys: group, embed, final_ln,
    input_ln, post_ln ([L, H] bf16), qkv, o, head and either gate_up, down
    or router ([L, H, E] bf16), route_pairs, moe_gate_up, moe_down; each
    int4 entry a (data, scales) pair. `group` is the group size."""
    H, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    Nq = cfg["num_attention_heads"]
    Nk = cfg.get("num_key_value_heads") or Nq
    D = cfg.get("head_dim") or H // Nq
    I, E = cfg["intermediate_size"], cfg.get("num_local_experts") or 0
    g = cfg["quantization"]["group_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    w = {"group": g}
    if E:
        w["embed"], w["router"], w["route_pairs"] = _routed_embedding(gen, V, H, E, L, device)
    else:
        w["embed"] = normal(V, H, std=0.02)
    w["input_ln"] = 1 + normal(L, H, std=0.1)
    w["post_ln"] = 1 + normal(L, H, std=0.1)
    w["final_ln"] = 1 + normal(H, std=0.1)
    w["qkv"] = int4_stack(gen, (L,), H, (Nq + 2 * Nk) * D, g, device)
    w["o"] = int4_stack(gen, (L,), Nq * D, H, g, device)
    if E:
        w["moe_gate_up"] = int4_stack(gen, (L, E), H, 2 * I, g, device)
        w["moe_down"] = int4_stack(gen, (L, E), I, H, g, device)
        w["o"][0][..., :E] = ZERO            # no layer writes the routing coordinates
        w["moe_down"][0][..., :E] = ZERO
    else:
        w["gate_up"] = int4_stack(gen, (L,), H, 2 * I, g, device)
        w["down"] = int4_stack(gen, (L,), I, H, g, device)
    w["head"] = padded_head(gen, H, V, g, device)
    return w
