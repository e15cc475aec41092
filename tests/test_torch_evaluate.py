"""The port's perplexity evaluator (tinygpt_tpu_torch.evaluate) against the
JAX package's (tinygpt_tpu.evaluate), on the CPU: window_nll and
perplexity in fp32 on the same params and tokens (float, int8, int4),
every token scored exactly once, the log-perplexity budgets of the JAX
package's quantization test, and the command line on a model dir with
the generated tokenizer.

Both packages compute the same fp32 forward in another summation order:
the summed NLL agrees to 1e-5 relative."""

import functools
import math
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu import evaluate as jeval  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import get_model as j_get_model  # noqa: E402
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params  # noqa: E402
from tinygpt_tpu_torch import evaluate  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm, get_model  # noqa: E402
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir  # noqa: E402

REL = 1e-5
TINY = dict(model_type="llama", vocab_size=503, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5)


@functools.lru_cache(maxsize=None)
def _llama(bits=None):
    """(JAX cfg, model, params; port cfg, model, params; 300 token ids)."""
    jcfg = j_parse(TINY)
    jp = j_get_model("llama").init_params(jcfg, seed=33, dtype=jnp.float32)
    tp = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if bits:
        jp = j_quantize_params(jp, bits=bits, group_size=32)
        from tinygpt_tpu_torch.ops.quant import quantize_params

        tp = quantize_params(tp, bits=bits, group_size=32)
    ids = [int(x) for x in np.random.default_rng(0).integers(2, TINY["vocab_size"], 300)]
    return (jcfg, j_get_model("llama"), jp, parse_model_config(TINY), get_model("llama"),
            tp, ids)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("window,stride", [(64, 32), (100, 100), (128, 48)])
def test_window_nll_matches_jax(window, stride, bits):
    """int8 / int4 here carry the JAX CPU route's bf16 rounding of the
    dequantized weights against the port's exact fp32 dequantization, so
    the quantized cases hold the NLL to 1e-3 relative."""
    jcfg, jmodel, jp, cfg, model, tp, ids = _llama(bits)
    want = jeval.window_nll(jmodel, jcfg, jp, ids, window=window, stride=stride)
    got = evaluate.window_nll(model, cfg, tp, ids, window=window, stride=stride,
                              attn_impl="plain")
    assert got[1] == want[1] == len(ids) - 1
    assert abs(got[0] - want[0]) <= (REL if bits is None else 1e-3) * abs(want[0])


def test_perplexity_matches_jax_and_routes_agree():
    jcfg, jmodel, jp, cfg, model, tp, ids = _llama()
    want = jeval.perplexity(jmodel, jcfg, jp, ids, window=64, stride=32)
    for impl in ("kernel", "plain"):  # on the CPU both are the plain versions
        got = evaluate.perplexity(model, cfg, tp, ids, window=64, stride=32, attn_impl=impl)
        assert abs(got - want) <= REL * want
    # random model on random tokens: ppl near the vocab size, finite
    assert 1.0 < want < TINY["vocab_size"] * 10


@pytest.mark.parametrize("n,window,stride", [(2, 512, 256), (37, 16, 5), (300, 64, 32),
                                             (301, 300, 299), (257, 64, 64)])
def test_every_token_scored_once(n, window, stride):
    _, _, _, cfg, model, tp, ids = _llama()
    ids = (ids * 2)[:n]
    nll, scored = evaluate.window_nll(model, cfg, tp, ids, window=window, stride=stride)
    assert scored == n - 1 and math.isfinite(nll)
    with pytest.raises(ValueError, match="2 tokens"):
        evaluate.window_nll(model, cfg, tp, ids[:1])


@pytest.mark.parametrize("bits,budget", [(8, 0.05), (4, 0.5)])
def test_quantization_ppl_delta(bits, budget):
    """The JAX package's budgets on log-ppl deltas (a scaled-down analog of
    the int8 <= 0.1 and int4 <= 0.5 quality gates)."""
    *_, cfg, model, tp, ids = _llama()
    qp = _llama(bits)[5]
    base = evaluate.perplexity(model, cfg, tp, ids, window=64, stride=32)
    qppl = evaluate.perplexity(model, cfg, qp, ids, window=64, stride=32)
    assert abs(math.log(qppl) - math.log(base)) < budget


def test_fp8_kv_dtype_matches_jax():
    """kv_dtype=float8_e4m3fn: each window's cache in e4m3, the NLL within
    1e-5 relative of the JAX evaluator's on its fp8 cache."""
    jcfg, jmodel, jp, cfg, model, tp, ids = _llama()
    want = jeval.window_nll(jmodel, jcfg, jp, ids, window=64, stride=32,
                            kv_dtype=jnp.float8_e4m3fn)
    got = evaluate.window_nll(model, cfg, tp, ids, window=64, stride=32,
                              kv_dtype=torch.float8_e4m3fn)
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= REL * abs(want[0])


@pytest.fixture(scope="module")
def model_dir_and_text(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval_llama")
    write_random_model_dir(str(d), TINY, seed=21, dtype=torch.float32)
    text = d / "eval.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 12
                    + "Pack my box with five dozen liquor jugs.\n" * 6, encoding="utf-8")
    return str(d), str(text)


def _ppl(out: str) -> float:
    return float(re.search(r"perplexity: ([0-9.]+) over (\d+) tokens", out).group(1))


@pytest.mark.parametrize("extra", [[], ["--quantization", "int8"],
                                   ["--quantization", "int4", "--no-awq"]])
def test_main_matches_jax(model_dir_and_text, capsys, extra):
    d, text = model_dir_and_text
    args = ["--model", d, "--text", text, "--window", "64", "--stride", "32"] + extra
    assert jeval.main(args) == 0
    want = _ppl(capsys.readouterr().out)
    assert evaluate.main(args + ["--device", "cpu"]) == 0
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= 2e-3 * want  # printed to 4 decimals; bf16-rounded JAX weights


def test_main_with_awq(model_dir_and_text, capsys):
    """int4 runs AWQ by default (calibrating on the built-in corpus through
    the model dir's tokenizer), as the JAX command does."""
    d, text = model_dir_and_text
    args = ["--model", d, "--text", text, "--window", "64", "--stride", "32",
            "--quantization", "int4", "--max-tokens", "100"]
    assert jeval.main(args) == 0
    want = _ppl(capsys.readouterr().out)
    assert evaluate.main(args + ["--device", "cpu", "--impl", "plain"]) == 0
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= 2e-3 * want
