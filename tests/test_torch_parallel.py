"""The port's parallel/ helpers in one process, against the JAX package's
(tests/test_parallel.py, tests/test_pipeline.py::test_stage_roundtrip):
meshes and their errors, the runtime's single-process degradations, the
spec trees, each rank's cut of the params (the fused [q | k | v] and
[gate | up] regrouping, int4 and int8 shards, the fallback to a whole
block), and the pipeline's staging round trip. A rank's shard is cut with a
stand-in mesh that names its coordinates (no process group is needed to
cut)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygpt_tpu.hf.config import parse_model_config as j_parse
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.parallel import pipeline as jpl
from tinygpt_tpu.parallel.sharding import param_pspecs as j_param_pspecs
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm
from tinygpt_tpu_torch.ops.quant import dequantize, quantize_params
from tinygpt_tpu_torch.parallel import distributed, make_mesh, param_pspecs, shard_params
from tinygpt_tpu_torch.parallel import pipeline as pl
from tinygpt_tpu_torch.parallel.sharding import (
    cache_pspecs,
    data_pspecs,
    local_config,
    mesh_dims,
    shard_context,
)

BASE = dict(model_type="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5)


class StandIn:
    """A mesh's shape and one rank's coordinates: all that cutting needs."""

    def __init__(self, shape, **coords):
        self.shape = shape
        self.coords = {a: coords.get(a, 0) for a in shape}

    def index(self, axis):
        return self.coords[axis]

    def group(self, *axes):
        return None


def _params(cfg_kw=BASE, seed=0):
    cfg = parse_model_config(cfg_kw)
    return cfg, causal_lm.init_params(cfg, seed=seed, dtype=torch.float32, device="cpu")


def test_initialize_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.world() == (0, 1)
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"


def test_host_local_batch_slice(monkeypatch):
    assert distributed.host_local_batch_slice(16) == (0, 16)
    monkeypatch.setattr(distributed, "world", lambda: (2, 4))
    assert distributed.host_local_batch_slice(16) == (8, 4)
    with pytest.raises(ValueError):
        distributed.host_local_batch_slice(7)


def test_hybrid_mesh_flat_fallback():
    # one node of 8 ranks for dcn_dp = 2: the flat layout (with a warning)
    arr = distributed.hybrid_ranks(8, 8, dcn_dp=2, dp=2, sp=1, tp=2)
    assert arr.shape == (2, 2, 1, 2)
    assert arr.reshape(-1).tolist() == list(range(8))
    # two nodes of 4: node-major ranks put dcn_dp on the nodes
    assert distributed.hybrid_ranks(8, 4, dcn_dp=2, tp=4)[1].reshape(-1).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        distributed.hybrid_ranks(8, 8, dcn_dp=3, dp=1, sp=1, tp=1)
    # a world of one rank: the runtime's hybrid_mesh is the flat one
    m = distributed.hybrid_mesh()
    assert m.shape == {"dcn_dp": 1, "dp": 1, "sp": 1, "tp": 1}


def test_make_mesh_axes_and_errors():
    m = make_mesh(n_devices=1)
    assert m.axis_names == ("dp", "sp", "tp")
    assert m.shape == {"dp": 1, "sp": 1, "tp": 1} and m.index("tp") == 0
    assert m.group("tp") is None
    with pytest.raises(ValueError):
        make_mesh(n_devices=8, dp=3, sp=1, tp=1, devices=range(8))
    with pytest.raises(ValueError, match="process group"):
        make_mesh(dp=2, sp=1, tp=2, devices=range(4))
    assert mesh_dims((2, 1, 4)) == (2, 1, 1, 4)
    assert mesh_dims((1, 1, 2, 4)) == (1, 1, 2, 4)
    assert data_pspecs(sp=True) == ("dp", "sp")


@pytest.mark.parametrize("fam", ["llama", "mixtral", "gpt2"])
def test_specs_are_the_jax_specs(fam):
    """Unresolved, the spec trees are the JAX package's PartitionSpecs."""
    kw = dict(BASE, hidden_size=64, intermediate_size=128, num_attention_heads=4)
    if fam == "mixtral":
        kw.update(model_type="mixtral", num_local_experts=4)
    if fam == "gpt2":
        kw = dict(model_type="gpt2", vocab_size=64, n_embd=64, n_layer=2, n_head=4,
                  n_positions=32)
    jcfg = j_parse(kw)
    jparams = (jlm.init_params(jcfg, seed=0, dtype=jnp.float32) if fam != "gpt2" else
               __import__("tinygpt_tpu.models.gpt2", fromlist=["x"]).init_params(
                   jcfg, seed=0, dtype=jnp.float32))
    cfg = parse_model_config(kw)
    want = j_param_pspecs(jcfg, jparams)
    got = param_pspecs(cfg, jax.tree.map(np.asarray, jparams))
    for k, v in want.items():
        if k == "layers":
            assert {lk: tuple(s) for lk, s in v.items()} == got["layers"]
        else:
            assert (None if v is None else tuple(v)) == got[k], k
    jc = jax.tree.map(lambda s: tuple(s), __import__(
        "tinygpt_tpu.parallel.sharding", fromlist=["x"]).cache_pspecs(jcfg, 2),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert cache_pspecs(cfg, 2) == {"k": jc.k, "v": jc.v, "kv_pos": jc.kv_pos,
                                    "valid": jc.valid, "length": jc.length}


def _cut(cfg, params, tp, r, sp=1, s=0):
    mesh = StandIn({"dp": 1, "sp": sp, "tp": tp}, tp=r, sp=s)
    specs = param_pspecs(cfg, params, mesh)
    return specs, shard_params(params, mesh, specs, cfg)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_qkv_and_gate_up_regrouped(tp):
    """Rank r holds [q_r | k_r | v_r] and [gate_r | up_r]; at tp = 4 and 8
    over 2 KV heads each rank keeps the one KV head its queries read."""
    cfg, params = _params()
    D, Nq, Nk, I = 64, 8, 2, 1024
    full = params["layers"]
    for r in range(tp):
        specs, p = _cut(cfg, params, tp, r)
        assert specs["layers"]["o_w"] == (None, "tp", None)
        nq = Nq // tp
        h = r * Nk // tp if Nk % tp == 0 else r // (tp // Nk)
        nk = max(Nk // tp, 1)
        q = full["qkv_w"][..., r * nq * D : (r + 1) * nq * D]
        k = full["qkv_w"][..., Nq * D + h * D : Nq * D + (h + nk) * D]
        v = full["qkv_w"][..., (Nq + Nk) * D + h * D : (Nq + Nk) * D + (h + nk) * D]
        assert torch.equal(p["layers"]["qkv_w"], torch.cat([q, k, v], dim=-1))
        n = I // tp
        gu = full["gate_up_w"]
        assert torch.equal(p["layers"]["gate_up_w"],
                           torch.cat([gu[..., r * n : (r + 1) * n],
                                      gu[..., I + r * n : I + (r + 1) * n]], dim=-1))
        assert torch.equal(p["layers"]["down_w"], full["down_w"][:, r * n : (r + 1) * n])
        assert torch.equal(p["embed"], params["embed"][r * 512 // tp : (r + 1) * 512 // tp])
        lc = local_config(cfg, shard_context(cfg, specs, StandIn({"dp": 1, "sp": 1, "tp": tp},
                                                                    tp=r)))
        assert (lc.num_attention_heads, lc.num_kv_heads, lc.head_dim) == (nq, nk, D)
        assert lc.vocab_size == 512 // tp and lc.intermediate_size == n


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_shards_are_their_rows(bits):
    """A quantized weight's shard is a QuantizedTensor of the rank's own
    rows and columns: column cuts of data and scales, row cuts on whole
    groups (int4 unpacked, cut and packed again), byte for byte what
    quantizing the cut float weight gives."""
    cfg, params = _params()
    q = quantize_params(params, bits=bits, group_size=64)
    for r in range(2):
        _, qp = _cut(cfg, q, 2, r)
        _, fp = _cut(cfg, params, 2, r)
        want = quantize_params(fp, bits=bits, group_size=64)
        for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
            got, w = qp["layers"][k], want["layers"][k]
            assert torch.equal(got.data, w.data) and torch.equal(got.scales, w.scales), k
            assert got.in_dim == w.in_dim
        # the head: the rank's real vocab columns, the pad columns dropped
        head = dequantize(qp["lm_head"], torch.float32)
        full = dequantize(q["lm_head"], torch.float32)[:, :512]
        assert torch.equal(head, full[:, r * 256 : (r + 1) * 256])


def test_blocks_fall_back_to_whole():
    """An int4 o whose shard would hold fewer than 256 rows keeps the
    attention block whole (qkv, o and the KV heads), as a vocab that tp
    does not divide keeps the embedding and head whole; the MLP still
    cuts."""
    kw = dict(BASE, hidden_size=256, intermediate_size=1024, num_attention_heads=4,
              vocab_size=503)
    cfg, params = _params(kw)
    q = quantize_params(params, bits=4, group_size=64)
    specs, p = _cut(cfg, q, 2, 1)
    assert specs["layers"]["qkv_w"] == (None, None, None)
    assert specs["layers"]["o_w"] == (None, None, None)
    assert specs["layers"]["down_w"] == (None, "tp", None)
    assert specs["embed"] == (None, None) and specs["lm_head"] == (None, None)
    assert torch.equal(p["layers"]["o_w"].data, q["layers"]["o_w"].data)
    sc = shard_context(cfg, specs, StandIn({"dp": 1, "sp": 1, "tp": 2}, tp=1))
    assert (sc.attn, sc.mlp, sc.vocab) == (False, True, False)


def test_experts_over_sp():
    kw = dict(BASE, model_type="mixtral", hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_local_experts=4)
    cfg, params = _params(kw)
    specs, p = _cut(cfg, params, 2, 1, sp=2, s=1)
    assert p["layers"]["moe_gate_up_w"].shape == (2, 2, 64, 128)
    gu = params["layers"]["moe_gate_up_w"][:, 2:]
    assert torch.equal(p["layers"]["moe_gate_up_w"],
                       torch.cat([gu[..., 64:128], gu[..., 192:]], dim=-1))
    sc = shard_context(cfg, specs, StandIn({"dp": 1, "sp": 2, "tp": 2}, tp=1, sp=1))
    assert (sc.ep, sc.expert_start, sc.experts, sc.seq) == (True, 2, 2, False)


def test_stage_roundtrip():
    """tests/test_pipeline.py::test_stage_roundtrip on the port, and the
    staged layers, cache and specs against the JAX package's."""
    jcfg = j_parse(dict(BASE, hidden_size=64, intermediate_size=128, num_attention_heads=4,
                        num_hidden_layers=4))
    jparams = jlm.init_params(jcfg, seed=0, dtype=jnp.float32)
    cfg = parse_model_config(dict(BASE, hidden_size=64, intermediate_size=128,
                                  num_attention_heads=4, num_hidden_layers=4))
    params = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    staged = pl.stage_layers(params["layers"], 2)
    jstaged = jpl.stage_layers(jparams["layers"], 2)
    for k in params["layers"]:
        np.testing.assert_array_equal(staged[k].numpy(), np.asarray(jstaged[k]))
    back = pl.unstage_layers(staged)
    for k in params["layers"]:
        assert torch.equal(back[k], params["layers"][k])
    with pytest.raises(ValueError):
        pl.stage_layers(params["layers"], 3)
    q = quantize_params(params, bits=8, group_size=64)
    qs = pl.unstage_layers(pl.stage_layers(q["layers"], 2))
    assert torch.equal(qs["qkv_w"].data, q["layers"]["qkv_w"].data)
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache

    cache = create_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    cache.k.normal_()
    sc = pl.stage_cache(cache, 2)
    assert sc.k.shape == (2, 2, 2, 2, 8, 16)
    assert torch.equal(pl.unstage_cache(sc).k, cache.k)
    jspec = jpl.staged_param_specs(jcfg, dict(jparams, layers=jstaged), 2)
    spec = pl.staged_param_specs(cfg, dict(params, layers=staged), 2)
    assert {k: tuple(v) for k, v in jspec["layers"].items()} == spec["layers"]
    assert tuple(jspec["embed"]) == spec["embed"]
