"""Meshes, the sharding rules, and each rank's shard of the params.

Counterpart of tinygpt_tpu/parallel/sharding.py on torch.distributed. A
`Mesh` is the ranks array reshaped to named axes, ("dp", "sp", "tp") for
the engine and the batcher, with one process group per slice of an axis.
The specs are the JAX package's PartitionSpecs as plain tuples of axis
names (None: replicated dim):

  * Megatron tp: qkv and gate/up sharded on their output dim, o and down
    on their input dim (one all-reduce each), the KV cache on its KV heads,
    the embedding and the lm_head on the vocab;
  * MoE experts over "sp" (expert parallelism), tp inside each expert;
  * prefill inputs shard their batch on "dp" and, with sp, their sequence.

The JAX package hands the specs to GSPMD, which shards the LOGICAL
tensors and inserts the collectives. Here each rank holds a real shard
and the models call the collectives themselves (models/causal_lm.py,
models/gpt2.py), so three things differ:

  * fused layouts are regrouped: `qkv_w` is [q | k | v] on its last dim
    and `gate_up_w` [gate | up]; rank r's shard is [q_r | k_r | v_r] and
    [gate_r | up_r], never a plain chunk of the fused columns;
  * a block is sharded whole or not at all (`param_pspecs(..., mesh=)`):
    the attention block (qkv columns, o rows, the cache's KV heads) where
    tp divides the query heads and the KV heads divide tp or tp them, and
    o's rows cut on the quantized kernels' boundaries (a whole group;
    int4 also a multiple of 256 rows); the MLP block where tp divides the
    intermediate dim and down's rows cut likewise; the vocab where tp
    divides it. A block that cannot is replicated, and its collective
    skipped. Where tp is a multiple of the KV heads, each rank keeps the
    one KV head its query heads read;
  * int4 data packs row p with row p + in/2 (quant.pack_int4), so a row
    shard is unpacked, cut and packed again: every shard is a
    QuantizedTensor of its own rows, byte for byte the layout the kernels
    take. Scales are cut on whole groups.

`shard_context` and `local_config` tell a rank's model code what it holds:
the groups of its collectives, and the head, vocab and expert counts of
its shard (the kernels see only local shapes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, _pack_int4_torch
from tinygpt_tpu_torch.ops.quant_kernels import unpack_int4
from tinygpt_tpu_torch.parallel.distributed import world
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("parallel")

# the fused last dims that are regrouped per rank rather than chunked
_QKV_KEYS = ("qkv_w", "qkv_b")
_GATE_UP_KEYS = ("gate_up_w", "moe_gate_up_w")


class Mesh:
    """Ranks reshaped to named axes, with one process group per slice of
    each axis (and of each combination in `combos`). Every rank of the
    world constructs every mesh, in the same order: torch.distributed
    creates groups collectively. A rank outside the mesh has no
    coordinates. An axis slice of one rank has no group (None)."""

    def __init__(self, ranks, axis_names: Sequence[str],
                 combos: Sequence[Tuple[str, ...]] = ()):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        rank, size = world()
        if self.ranks.size > 1 and not dist.is_initialized():
            raise ValueError(f"a mesh of {self.ranks.size} ranks needs a process "
                             f"group (parallel.distributed.initialize)")
        if self.ranks.max() >= size:
            raise ValueError(f"mesh ranks up to {int(self.ranks.max())} in a world "
                             f"of {size}")
        where = np.argwhere(self.ranks == rank)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self._groups = {}
        for axes in [(a,) for a in self.axis_names] + [tuple(c) for c in combos]:
            self._groups[axes] = self._make_groups(axes)

    def _make_groups(self, axes):
        keep = [self.axis_names.index(a) for a in axes]
        n = int(np.prod([self.ranks.shape[i] for i in keep]))
        if n == 1:
            return None
        other = [i for i in range(self.ranks.ndim) if i not in keep]
        lines = np.transpose(self.ranks, other + keep).reshape(-1, n)
        rank, mine = world()[0], None
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = g
        return mine

    def group(self, *axes: str):
        """This rank's group along `axes` (one axis, or a combination
        given at construction); None where that slice has one rank."""
        return self._groups[tuple(axes)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        if self.coords is None:
            raise ValueError("this rank is not in the mesh")
        return self.coords[axis]

    def src(self, **coords) -> int:
        """The global rank at `coords`, this rank's on every other axis."""
        at = dict(self.coords)
        at.update(coords)
        return int(self.ranks[tuple(at[a] for a in self.axis_names)])


def make_mesh(n_devices: Optional[int] = None, dp: int = 1, tp: Optional[int] = None,
              sp: int = 1, devices=None) -> Mesh:
    """Mesh over ("dp", "sp", "tp") of the first n ranks (default: the
    world), with groups for each axis and for ("sp", "tp") (the MoE
    reduction under expert parallelism)."""
    devices = list(devices if devices is not None else range(world()[1]))
    n = n_devices or len(devices)
    devices = devices[:n]
    if tp is None:
        tp = n // (dp * sp)
    if dp * sp * tp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) * tp({tp}) != devices({n})")
    arr = np.asarray(devices).reshape(dp, sp, tp)
    return Mesh(arr, ("dp", "sp", "tp"), combos=(("sp", "tp"),))


def data_pspecs(sp: bool = False, batch_axes="dp"):
    """The spec of the (ids, positions, valid) prefill inputs: batch on dp
    (or a ("dcn_dp", "dp") tuple on hybrid meshes), sequence on sp."""
    return (batch_axes, "sp" if sp else None)


def _layer_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    if cfg.model_type == "gpt2":
        return {
            "ln1_w": (), "ln1_b": (),
            "qkv_w": (None, None, "tp"), "qkv_b": (None, "tp"),
            "o_w": (None, "tp", None), "o_b": (),
            "ln2_w": (), "ln2_b": (),
            "fc_w": (None, None, "tp"), "fc_b": (None, "tp"),
            "proj_w": (None, "tp", None), "proj_b": (),
        }
    return {
        "input_ln": (), "qkv_w": (None, None, "tp"), "qkv_b": (None, "tp"),
        "o_w": (None, "tp", None), "post_ln": (),
        "gate_up_w": (None, None, "tp"), "down_w": (None, "tp", None),
        "q_norm": (), "k_norm": (),
        # MoE: experts over "sp" (expert parallelism), tp inside each expert
        "router_w": (),
        "moe_gate_up_w": (None, "sp", None, "tp"),
        "moe_down_w": (None, "sp", "tp", None),
    }


# the weights of each block: cut together or not at all
_ATTN_KEYS = ("qkv_w", "qkv_b", "o_w")
_MLP_KEYS = ("gate_up_w", "down_w", "fc_w", "fc_b", "proj_w", "moe_gate_up_w",
             "moe_down_w")


def _row_cut_ok(w, parts: int, rows: int) -> bool:
    """Whether the input dim of weight `w` ([..., rows, out], or a
    QuantizedTensor of `rows` real rows) cuts into `parts` shards that the
    kernels take: equal parts, whole quantization groups, and for int4 a
    multiple of 256 rows (quant.quantize_weight's row padding) with no pad
    rows."""
    if rows % parts:
        return False
    if not isinstance(w, QuantizedTensor):
        return True
    loc = rows // parts
    return (w.in_dim == rows and loc % w.group_size == 0
            and (w.bits != 4 or loc % 256 == 0))


def _heads_cut_ok(Nq: int, Nk: int, tp: int) -> bool:
    return Nq % tp == 0 and (Nk % tp == 0 or tp % Nk == 0)


def _drop(spec, axis: str):
    return tuple(None if a == axis else a for a in spec)


def param_pspecs(cfg: ModelConfig, params: Dict, mesh: Optional[Mesh] = None) -> Dict:
    """The spec tree of the causal_lm / gpt2 params: the JAX package's
    specs as tuples. Given the mesh, the specs are resolved for real
    shards: a block that cannot be cut whole (module docstring) drops its
    "tp", the vocab drops "tp" where tp does not divide it (or leaves a
    quantized head of fewer than 8 columns a rank), and the experts drop
    "sp" where sp does not divide them."""
    layer_specs = _layer_specs(cfg)
    lay = params["layers"]
    if cfg.model_type == "gpt2":
        specs = {"wte": ("tp", None), "wpe": (), "lnf_w": (), "lnf_b": ()}
    else:
        specs = {"embed": ("tp", None), "final_ln": (), "rope_cos": (), "rope_sin": (),
                 "lm_head": None if params.get("lm_head") is None else (None, "tp")}
    specs["layers"] = {k: layer_specs[k] for k in lay}
    if mesh is None:
        return specs
    tp, sp = mesh.shape.get("tp", 1), mesh.shape.get("sp", 1)
    D, Nq, Nk = cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    attn = tp > 1 and _heads_cut_ok(Nq, Nk, tp) and _row_cut_ok(lay["o_w"], tp, Nq * D)
    I = cfg.intermediate_size
    down = lay.get("down_w", lay.get("proj_w", lay.get("moe_down_w")))
    mlp = tp > 1 and I % tp == 0 and (2 * I // tp) % 8 == 0 and _row_cut_ok(down, tp, I)
    E = cfg.num_local_experts
    ep = sp > 1 and E > 0 and E % sp == 0
    V = cfg.vocab_size
    vocab = tp > 1 and V % tp == 0 and (V // tp) % 8 == 0
    for k in list(specs["layers"]):
        s = specs["layers"][k]
        if (k in _ATTN_KEYS and not attn) or (k in _MLP_KEYS and not mlp):
            s = _drop(s, "tp")
        if k.startswith("moe_") and not ep:
            s = _drop(s, "sp")
        specs["layers"][k] = s
    if not vocab:
        for k in ("embed", "wte", "lm_head"):
            if specs.get(k) is not None:
                specs[k] = _drop(specs[k], "tp")
    return specs


def cache_pspecs(cfg: ModelConfig, tp_size: int, batch_axes="dp") -> Dict:
    """The spec of the KV cache [L, B, Nk, T, D]: KV heads on tp when tp
    divides them, batch on dp (or ("dcn_dp", "dp"))."""
    kv_tp = "tp" if tp_size > 1 and cfg.num_kv_heads % tp_size == 0 else None
    return {"k": (None, batch_axes, kv_tp, None, None),
            "v": (None, batch_axes, kv_tp, None, None),
            "kv_pos": (batch_axes, None), "valid": (batch_axes, None), "length": ()}


# -- cutting a rank's shard ------------------------------------------------------------


def _qkv_columns(cfg: ModelConfig, tp: int, r: int) -> torch.Tensor:
    """Rank r's columns of the fused [q | k | v] dim: its query heads, then
    the KV heads they read (all of its share where tp divides the KV heads,
    else the one KV head of its group)."""
    D, Nq, Nk = cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    nq = Nq // tp
    q = torch.arange(r * nq * D, (r + 1) * nq * D)
    if Nk % tp == 0:
        nk = Nk // tp
        kv = torch.arange(r * nk * D, (r + 1) * nk * D)
    else:
        h = r // (tp // Nk)
        kv = torch.arange(h * D, (h + 1) * D)
    return torch.cat([q, Nq * D + kv, (Nq + Nk) * D + kv])


def _halves_columns(width: int, parts: int, r: int) -> torch.Tensor:
    """Rank r's columns of a fused [a | b] dim of `width`: [a_r | b_r]."""
    half = width // 2
    n = half // parts
    a = torch.arange(r * n, (r + 1) * n)
    return torch.cat([a, half + a])


def _cut_rows(x: torch.Tensor, dim: int, parts: int, r: int, packed: bool) -> torch.Tensor:
    if not packed:
        return x.chunk(parts, dim=dim)[r].contiguous()
    q = unpack_int4(x)                      # [..., in, out], dim == -2
    return _pack_int4_torch(q.chunk(parts, dim=-2)[r]).contiguous()


def _cut(x, spec, mesh: Mesh, key: str, cfg: Optional[ModelConfig]):
    """A tensor's or QuantizedTensor's shard under `spec`; a dim that an
    axis does not divide stays whole (the JAX rule)."""
    if x is None:
        return None
    spec = tuple(spec or ())
    if isinstance(x, QuantizedTensor):
        return _cut_quantized(x, spec, mesh, key, cfg)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, r = mesh.shape[ax], mesh.index(ax)
        if n == 1 or x.shape[d] % n:
            continue
        if d == x.ndim - 1 and key in _QKV_KEYS and cfg is not None:
            x = x.index_select(d, _qkv_columns(cfg, n, r).to(x.device))
        elif d == x.ndim - 1 and key in _GATE_UP_KEYS:
            x = x.index_select(d, _halves_columns(x.shape[d], n, r).to(x.device))
        else:
            x = x.chunk(n, dim=d)[r]
        x = x.contiguous()
    return x


def _cut_quantized(qt: QuantizedTensor, spec, mesh: Mesh, key: str,
                   cfg: Optional[ModelConfig]) -> QuantizedTensor:
    """A QuantizedTensor's shard: leading dims (layers, experts) and the
    output dim cut on data and scales alike; the input dim cut on whole
    groups, int4 unpacked, cut and packed again. The lm_head's vocab
    columns are cut over the real vocab, its pad columns dropped."""
    data, scales, in_dim = qt.data, qt.scales, qt.in_dim
    nd = data.ndim
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, r = mesh.shape[ax], mesh.index(ax)
        if n == 1:
            continue
        if d == nd - 1:
            if key == "lm_head" and cfg is not None:
                vl = cfg.vocab_size // n
                cols = torch.arange(r * vl, (r + 1) * vl)
            elif key in _QKV_KEYS and cfg is not None:
                cols = _qkv_columns(cfg, n, r)
            elif key in _GATE_UP_KEYS:
                cols = _halves_columns(data.shape[-1], n, r)
            elif data.shape[-1] % n == 0:
                cols = torch.arange(r * (data.shape[-1] // n), (r + 1) * (data.shape[-1] // n))
            else:
                continue
            data = data.index_select(d, cols.to(data.device)).contiguous()
            scales = scales.index_select(d, cols.to(scales.device)).contiguous()
        elif d == nd - 2:
            if in_dim % (n * qt.group_size):
                continue
            data = _cut_rows(data, d, n, r, qt.bits == 4)
            scales = scales.chunk(n, dim=d)[r].contiguous()
            in_dim //= n
        elif data.shape[d] % n == 0:
            data = data.chunk(n, dim=d)[r].contiguous()
            scales = scales.chunk(n, dim=d)[r].contiguous()
    return QuantizedTensor(data, scales, qt.bits, qt.group_size, in_dim)


def shard_params(params: Dict, mesh: Mesh, specs: Dict,
                 cfg: Optional[ModelConfig] = None) -> Dict:
    """This rank's shard of a full params dict under `specs` (resolve them
    with param_pspecs(cfg, params, mesh) first, so that every block is cut
    whole or kept whole). `cfg` gives the head layout that the fused qkv
    columns are regrouped by, and the real vocab of a quantized head. The
    full params may live on the CPU: each shard is cut there and is moved
    by the caller."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {lk: _cut(lv, specs[k].get(lk), mesh, lk, cfg)
                      for lk, lv in v.items()}
        else:
            out[k] = _cut(v, specs.get(k), mesh, k, cfg)
    return out


# -- what a rank holds -------------------------------------------------------------


@dataclass
class ShardContext:
    """What the model code of one rank needs to know about its shard: the
    groups its collectives run over and which blocks are cut. Params
    carry it under the key "shard" (absent on a single device, where the
    code path is unchanged)."""

    tp: int = 1
    tp_rank: int = 0
    tp_group: Any = None
    attn: bool = False      # attention block cut over tp: all-reduce after o
    mlp: bool = False       # MLP block cut over tp: all-reduce after down
    vocab: bool = False     # embedding and head cut over the vocab
    vocab_start: int = 0
    sp: int = 1
    sp_rank: int = 0
    sp_group: Any = None
    seq: bool = False       # prefill sequence cut over sp (dense models)
    ep: bool = False        # experts cut over sp
    expert_start: int = 0
    experts: int = 0        # local experts (0: not a MoE model)
    moe_group: Any = None   # the group the MoE MLP's partial sums reduce over


def _has(spec, axis: str) -> bool:
    return spec is not None and axis in spec


def shard_context(cfg: ModelConfig, specs: Dict, mesh: Mesh) -> ShardContext:
    """The ShardContext of this rank for params cut by `specs`."""
    tp, sp = mesh.shape.get("tp", 1), mesh.shape.get("sp", 1)
    lay = specs["layers"]
    tp_rank = mesh.index("tp") if tp > 1 else 0
    sp_rank = mesh.index("sp") if sp > 1 else 0
    attn = _has(lay.get("o_w"), "tp")
    mlp = any(_has(lay.get(k), "tp") for k in ("down_w", "proj_w", "moe_down_w"))
    vocab = _has(specs.get("embed", specs.get("wte")), "tp")
    E = cfg.num_local_experts
    ep = _has(lay.get("moe_gate_up_w"), "sp")
    e_loc = E // sp if ep else E
    moe_group = None
    if E:
        if ep and mlp:
            moe_group = mesh.group("sp", "tp")
        elif ep:
            moe_group = mesh.group("sp")
        elif mlp:
            moe_group = mesh.group("tp")
    return ShardContext(
        tp=tp, tp_rank=tp_rank, tp_group=mesh.group("tp") if tp > 1 else None,
        attn=attn, mlp=mlp, vocab=vocab,
        vocab_start=tp_rank * (cfg.vocab_size // tp) if vocab else 0,
        sp=sp, sp_rank=sp_rank, sp_group=mesh.group("sp") if sp > 1 else None,
        seq=sp > 1 and not E, ep=ep, expert_start=sp_rank * e_loc if ep else 0,
        experts=e_loc, moe_group=moe_group)


def local_config(cfg: ModelConfig, sc: ShardContext, layers: Optional[int] = None
                 ) -> ModelConfig:
    """The model config of a rank's shard: its query and KV heads (the
    head dim made explicit), its vocab, its intermediate dim, and with
    `layers` its pipeline stage's layer count. Expert counts stay global
    (routing runs over every expert; ShardContext names the local ones)."""
    D, Nq, Nk = cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    kw = dict(explicit_head_dim=D)
    if sc.attn:
        kw.update(num_attention_heads=Nq // sc.tp,
                  num_key_value_heads=Nk // sc.tp if Nk % sc.tp == 0 else 1)
    if sc.mlp:
        kw["intermediate_size"] = cfg.intermediate_size // sc.tp
    if sc.vocab:
        kw["vocab_size"] = cfg.vocab_size // sc.tp
    if layers is not None:
        kw["num_hidden_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def mesh_dims(mesh_shape) -> Tuple[int, int, int, int]:
    """(dp, sp, pp, tp) of a (dp, sp, tp) or (dp, sp, pp, tp) mesh shape."""
    shape = tuple(int(x) for x in mesh_shape)
    if len(shape) == 3:
        return shape[0], shape[1], 1, shape[2]
    if len(shape) == 4:
        return shape
    raise ValueError(f"mesh shape {shape}: want (dp, sp, tp) or (dp, sp, pp, tp)")


def check_world(mesh_shape) -> None:
    """A mesh runs one rank a process: its size must be the world's (1
    outside a process group). Raises ValueError otherwise, so that a mesh
    never runs quietly on one rank."""
    n = int(np.prod(mesh_dims(mesh_shape)))
    size = world()[1]
    if n != size:
        raise ValueError(f"mesh {tuple(mesh_shape)} has {n} ranks, the world {size}: "
                         f"start one process a rank and join the process group "
                         f"(parallel.distributed.initialize) first")


def shard_model(params: Dict, cfg: ModelConfig, mesh: Mesh) -> Tuple[Dict, ModelConfig]:
    """This rank's shard of a model's full params on `mesh` (resolved
    specs, ShardContext under "shard") and its local model config."""
    specs = param_pspecs(cfg, params, mesh)
    out = shard_params(params, mesh, specs, cfg)
    sc = shard_context(cfg, specs, mesh)
    out["shard"] = sc
    log.info("rank %d of mesh %s: attention %s, MLP %s, vocab %s, experts %s",
             world()[0], dict(mesh.shape), "cut" if sc.attn else "whole",
             "cut" if sc.mlp else "whole", "cut" if sc.vocab else "whole",
             f"{sc.expert_start}+{sc.experts}" if sc.ep else "whole")
    return out, local_config(cfg, sc)
