"""The harness's import check compares whole top-level names, and neither
the harness nor the reference loads JAX or the JAX package (the port's
name begins with the JAX package's)."""

import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT


def test_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    for m in harness.FORBIDDEN:
        mods.pop(m, None)
    mods["tinygpt_tpu_torch"] = object()
    mods["tinygpt_tpu_torch.ops"] = object()
    mods["jaxtyping"] = object()
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == []
    mods["tinygpt_tpu.ops.quant"] = object()
    mods["jax.numpy"] = object()
    assert harness.forbidden_modules() == ["jax", "tinygpt_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    tops = _loaded("import portbench.run, portbench.harness, portbench.sweep, "
                   "portbench.control\n"
                   "from portbench.systems import causal_lm\n"
                   "from portbench.traffic import open_loop, closed_loop")
    assert "tinygpt_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded("from portbench.reference import mistral")
    assert not tops & {"tinygpt_tpu_torch", *harness.FORBIDDEN}
