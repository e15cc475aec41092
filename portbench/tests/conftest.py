"""Tests of the benchmark harness. They are not part of the repository's
tier-1 suite (tests/); run them with

    python -m pytest portbench/tests -q

Tests marked `cuda` need the card and skip without one."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(cell: str):
    """(workload, config) of a cell cut to a size the CPU runs in seconds:
    2 layers of hidden 256, 4 rows, short prompts and outputs, 3 req/s."""
    from portbench import harness

    wl, cfg = harness.load_cell(cell)
    cfg = dict(cfg, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=1000,
               max_position_embeddings=2048)
    if cfg.get("num_local_experts"):
        cfg["num_local_experts"] = 4
    cfg["quantization"] = dict(cfg["quantization"], group_size=64)
    wl = copy.deepcopy(wl)
    t = wl["traffic"]
    t["prompt"].update(min=16, max=200, median=64)
    t["output"].update(min=8, max=24, median=12)
    t["lead_in_s"] = 2.0
    if "rate_per_s" in t:
        t["rate_per_s"] = 3.0
    else:
        t.update(clients=4, pool=32)
    wl["scheduler"]["batch_capacity"] = 4
    wl["check"].update(tokens=40, max_requests=3,
                       limits={"max_gap": 0.25, "mean_gap": 0.05})
    return wl, cfg
