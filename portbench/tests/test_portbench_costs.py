"""The frozen cost arithmetic against counts made by hand at the two
configurations' shapes."""

import pytest

from portbench import costs, harness

MISTRAL = harness.load_json("configs", "mistral7b_int4")
MIXTRAL = harness.load_json("configs", "mixtral8x7b_int4")


def test_mistral_int4_weights_a_decode_step_reads():
    # a layer: qkv 4096 x 6144, o 4096 x 4096, gate_up 4096 x 28672, down 14336 x 4096
    layer = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    assert layer == 218_103_808
    params = 32 * layer + 4096 * 32768                   # and the head
    bytes_ = params * (0.5 + 4 / 64) + 2 * (2 * 32 * 4096 + 4096)   # int4, scales, norms
    assert bytes_ == 4_001_898_496                       # 4.002 GB
    assert costs.decode_weight_bytes(MISTRAL, 64) == pytest.approx(bytes_)


def test_mixtral_int4_weights():
    attn = 4096 * 6144 + 4096 * 4096
    expert = 3 * 4096 * 14336
    stacks = 32 * (attn + 8 * expert) + 4096 * 32000
    # every int4 matrix at group 128: 24.72 GB; with the bf16 embedding, router
    # and norms the weights the benchmark makes come to 24.98 GB (a run on the
    # card allocates 25.14 GB with the rope tables and the allocator's rounding)
    assert stacks * (0.5 + 4 / 128) == pytest.approx(24.72e9, rel=1e-3)
    # a decode step at 32 live rows reads, in expectation, every expert
    assert costs.expected_distinct_experts(MIXTRAL, 32) == pytest.approx(8 * (1 - 0.75 ** 32))
    full = costs.decode_weight_bytes(MIXTRAL, 128, rows=1e9)
    assert full == pytest.approx(stacks * (0.5 + 4 / 128) + 2 * (2 * 32 * 4096 + 4096)
                                 + 2 * 32 * 4096 * 8)
    # one row: its 2 experts of each layer
    one = costs.decode_weight_bytes(MIXTRAL, 128, rows=1)
    assert one == pytest.approx(full - 32 * 6 * expert * (0.5 + 4 / 128))


def test_prefill_and_decode_flops():
    S = 1024
    layer = 218_103_808
    want = 2 * 32 * layer * S + 2 * 4096 * 32768 + 2 * 32 * 32 * 128 * S * (S + 1)
    assert costs.prefill_flops(MISTRAL, S) == want
    # Mixtral: 2 of 8 experts and the router a token
    act = 4096 * 6144 + 4096 * 4096 + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert costs.layer_params(MIXTRAL, active=True) == act
    assert costs.decode_flops(MIXTRAL, 10, 500) == (2 * (32 * act + 4096 * 32000) * 10
                                                    + 4 * 32 * 32 * 128 * 500)


def test_kv_bytes_and_peaks():
    assert costs.kv_bytes_per_slot(MISTRAL) == 2 * 32 * 8 * 128 * 2 == 131072
    assert costs.PEAK_BF16_FLOPS == 989e12 and costs.HBM_BYTES_PER_S == 3.35e12
