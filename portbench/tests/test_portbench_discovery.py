"""The harness finds every configuration, cell and metric by the names
BENCHMARK.json gives, and a new configuration, traffic mix and metric
come in as new files and entries alone: a copy of the benchmark with a
dummy of each added (its weights module too), no existing file edited,
runs the dummy cell."""

import json
import shutil
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert (ROOT / c["file"]).exists()
        assert callable(harness.module("weights", cfg["weights"]).make_weights)
        assert harness.module("systems", cfg["system"]) is not None
        assert harness.module("reference", cfg["reference"]) is not None
        for k in c["reduced"]:
            assert k in cfg
    for w in BENCH["workloads"]:
        wl, cfg = harness.load_cell(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert harness.module("traffic", wl["traffic"]["kind"]).Traffic
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_cell_reports_its_metrics():
    for w in BENCH["workloads"]:
        e2e = [n for n, _ in harness.metrics_for(BENCH, w["name"], False)]
        layer = [n for n, _ in harness.metrics_for(BENCH, w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        moved = {m["moves"] for m in BENCH["per_layer"] if m["name"] in layer}
        assert moved <= set(e2e)


def test_a_new_cell_needs_new_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "mistral7b_int4.json").read_text())
    cfg.update(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=1000,
               max_position_embeddings=2048, weights="dummy_w",
               quantization=dict(cfg["quantization"], group_size=64))
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (pb / "weights" / "dummy_w.py").write_text(
        "import torch\n\nfrom portbench.weights.mistral import make_weights as _family\n\n\n"
        "def make_weights(cfg, seed, device):\n"
        "    w = _family(cfg, seed, device)\n"
        "    w['final_ln'] = torch.ones_like(w['final_ln'])\n"
        "    return w\n")
    (pb / "traffic" / "dummy_kind.py").write_text(
        "from portbench.traffic.open_loop import Traffic as _T\n\n\n"
        "class Traffic(_T):\n    pass\n")
    (pb / "metrics" / "dummy_tokens.py").write_text(
        "def read(rec):\n    return float(sum(len(r['tokens']) for r in rec.requests))\n")
    wl = dict(config="dummy_cfg", chips=1, why="dummy",
              traffic=dict(kind="dummy_kind", rate_per_s=3.0, lead_in_s=1.0, schedule_seed=1,
                           prompt=dict(dist="uniform", min=16, max=64),
                           output=dict(dist="uniform", min=8, max=16)),
              scheduler=dict(batch_capacity=4, block_size=64, decode_quantum=8,
                             prefill_bucket=64, dtype="bfloat16"),
              check=dict(tokens=24, max_requests=3, limits=dict(max_gap=0.25)))
    (pb / "workloads" / "dummy_cfg.mix.json").write_text(json.dumps(wl))
    code = ("import sys, time, json\n"
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from portbench import harness\n"
            f"assert harness.HERE == __import__('pathlib').Path({str(pb)!r})\n"
            "wl, cfg = harness.load_cell('dummy_cfg.mix')\n"
            "r = harness.run(wl, cfg, 9, 3.0, False, device='cpu', t_process0=time.perf_counter(),\n"
            "                metrics=[('dummy_tokens', 'tokens'), ('ttft_p95_s', 's')])\n"
            "assert 'portbench.weights.dummy_w' in sys.modules\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["metrics"]["dummy_tokens"]["value"] > 0 and "ttft_p95_s" in r["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
