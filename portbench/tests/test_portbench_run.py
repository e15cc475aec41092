"""A whole run on the CPU at a tiny size, the look for a card skipped:
sound, it is correct; with the timed path broken underneath (a token
altered where the decode quantum produces it) `correct` comes out false.
The command line without a card, or without the program, prints no result
and exits non-zero. On the card: the control (the program's fp8 KV pool)
fails each cell's limits."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, tiny

METRICS = [("ttft_p95_s", "s"), ("tpot_p95_ms", "ms"), ("out_tok_s", "tokens/s"),
           ("setup_s", "s"), ("queue_wait_p95_s", "s"), ("decode_step_ms.serve", "ms")]


def _run(cell, seed, fault=None):
    wl, cfg = tiny(cell)
    with torch.inference_mode():
        return harness.run(wl, cfg, seed, 4.0, False, device="cpu", metrics=METRICS,
                           t_process0=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("cell", ["mistral7b_int4.chat", "mixtral8x7b_int4.batch"])
def test_a_sound_run_is_correct(cell):
    r = _run(cell, 3_000_000_123)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m for m, _ in METRICS}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["mistral7b_int4.chat", "mixtral8x7b_int4.batch"])
def test_an_altered_token_is_not_correct(cell):
    r = _run(cell, 3_000_000_123, fault="token")
    assert not r["correct"], r["checks"]


def test_the_command_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mistral7b_int4.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


def test_the_command_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mistral7b_int4.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral7b_int4.chat", "mistral7b_int4.longprompt",
                                  "mixtral8x7b_int4.batch"])
def test_the_control_fails_the_limits(cell, card):
    """The program with its fp8 KV pool at the cell's size and load, a
    short window: the comparison must come out not correct."""
    wl, cfg = harness.load_cell(cell)
    with torch.inference_mode():
        r = harness.run(wl, cfg, 3_000_000_777, 10.0, False, device=card, metrics=[],
                        t_process0=time.perf_counter(), kv_cache_dtype="fp8")
    assert r["numbers"] and not r["correct"], json.dumps(r["checks"])
