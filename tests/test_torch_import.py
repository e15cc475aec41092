"""The port stands alone: tinygpt_tpu_torch and chip_smoke.py import
neither jax nor tinygpt_tpu, the kernels are built at first use and not at
import, and chip_smoke.py without the rest of the repository (or without
a card) exits non-zero and prints no result."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "tinygpt_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tinygpt_tpu_torch
for m in pkgutil.walk_packages(tinygpt_tpu_torch.__path__, "tinygpt_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinygpt_tpu"))
assert not bad, bad
from tinygpt_tpu_torch.ops import cuda_build, host_build
assert not cuda_build._libs, "a kernel library was loaded at import"
assert not host_build._libs, "a host library was loaded at import"
print("imported", len([m for m in sys.modules if m.startswith("tinygpt_tpu_torch")]))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("imported")


_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinygpt_tpu"))
assert not bad, bad
print("imported", sys.argv[1])
"""


@pytest.mark.parametrize("module", ["tinygpt_tpu_torch.parallel",
                                    "tinygpt_tpu_torch.parallel.distributed",
                                    "tinygpt_tpu_torch.parallel.sharding",
                                    "tinygpt_tpu_torch.parallel.pipeline"])
def test_parallel_imports_alone_without_jax(module):
    """Each module of parallel/ imports first in a fresh process (no
    import cycle through the models or the engine), without jax or
    tinygpt_tpu."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"imported {module}"


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tinygpt_tpu)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo (and
    here, with no card) the script exits non-zero with no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _clean_env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cuda_build_paths(monkeypatch, tmp_path):
    """Library names carry a hash of the sources and flags; without nvcc
    the build raises instead of loading anything stale."""
    from tinygpt_tpu_torch.ops import cuda_build

    for src in cuda_build.SOURCES:
        p = cuda_build.library_path(src)
        assert p.parent == cuda_build.BUILD_DIR
        assert p.name.startswith(Path(src).stem + "-") and p.suffix == ".so"
        assert cuda_build.library_path(src) == p  # stable
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-g",))
    assert all(cuda_build.library_path(s) != p for s in cuda_build.SOURCES[-1:])
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()


_IMPORT_SERVING = """
import sys
import tinygpt_tpu_torch.server, tinygpt_tpu_torch.server.api, tinygpt_tpu_torch.server.utils
import tinygpt_tpu_torch.engine.scheduler, tinygpt_tpu_torch.engine.paged_kv
import tinygpt_tpu_torch.engine.native_pool, tinygpt_tpu_torch.ops.paged_attention
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinygpt_tpu"))
assert not bad, bad
print("serving path imports alone")
"""


def test_serving_modules_import_without_jax():
    """The server, the scheduler and the paged modules import neither jax
    nor the JAX package."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_SERVING], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "serving path imports alone" in r.stdout


_IMPORT_QUANT = """
import sys
import tinygpt_tpu_torch.ops.awq, tinygpt_tpu_torch.evaluate, tinygpt_tpu_torch.ops.quant_kernels
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinygpt_tpu"))
assert not bad, bad
from tinygpt_tpu_torch.ops import cuda_build
assert "int8_matmul.cu" in cuda_build.SOURCES and not cuda_build._libs
print("quantization path imports alone")
"""


def test_quantization_modules_import_without_jax():
    """AWQ, the evaluator and the int8 kernel wrappers import neither jax
    nor the JAX package, and build nothing at import."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_QUANT], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "quantization path imports alone" in r.stdout


def test_evaluate_main_runs_only_as_a_script():
    r = subprocess.run([sys.executable, "-m", "tinygpt_tpu_torch.evaluate", "--help"],
                       cwd=REPO, env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "--text" in r.stdout and "--device" in r.stdout


def test_web_ui_is_a_copy():
    ui = Path("server") / "web" / "index.html"
    assert (PKG / ui).read_bytes() == (REPO / "tinygpt_tpu" / ui).read_bytes()


def test_server_main_runs_only_as_a_script():
    """`python -m tinygpt_tpu_torch.server` parses its arguments; importing
    the module (as pkgutil.walk_packages does) runs nothing."""
    r = subprocess.run([sys.executable, "-m", "tinygpt_tpu_torch.server", "--help"],
                       cwd=REPO, env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "--model" in r.stdout and "--device" in r.stdout


_IMPORT_SPEC = """
import sys
import tinygpt_tpu_torch.models.causal_lm as lm
from tinygpt_tpu_torch.engine.engine import ngram_draft
from tinygpt_tpu_torch.engine.kv_cache import kv_cast
assert lm.decode_paged_spec_steps and lm.spec_accept and lm.ngram_draft_batched
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinygpt_tpu"))
assert not bad, bad
from tinygpt_tpu_torch.ops import cuda_build
assert "paged_decode_spec.cu" in cuda_build.SOURCES and not cuda_build._libs
print("speculation path imports alone")
"""


def test_speculation_modules_import_without_jax():
    """The speculative quantum, the engine's draft and the fp8 cast import
    neither jax nor the JAX package, in either order of the models and
    engine packages (the engine imports the model's speculation at call
    time), and build nothing at import."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_SPEC], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "speculation path imports alone" in r.stdout
