"""The port's stepwise paged decode against the JAX package's, on the CPU:
causal_lm.forward_paged (one whole decode step over the pool, attention
through K9's route) on a tiny llama and a mistral whose sliding window (8)
binds, and the ContinuousBatcher's stepwise quantum (a model namespace
without decode_paged_steps runs n_steps forward_paged steps) against the
JAX batcher given the same namespace, and against the port's frozen
quantum.

Both packages compute the same fp32 functions in another order: logits
within 1e-4, greedy streams equal up to a first difference that must be
a near-tie of the JAX dense logits (tests/test_torch_scheduler.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_scheduler import (
    LOGIT_TOL,
    SC,
    _assert_streams_agree,
    _models,
    _prompts,
    _run,
)
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, SchedulerConfig
from tinygpt_tpu_torch.models import causal_lm, get_model
from tinygpt_tpu_torch.ops import attention_kernels as ak


def paged_state(cfg, seed, lengths, starts, active, MB=4, n_blocks=24, bs=16):
    """A numpy PagedKVState: random pools (block 0 too), each active row
    owning distinct blocks for its length plus 8 slots, inactive rows a
    zero table."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    shape = (cfg.num_hidden_layers, n_blocks, cfg.num_kv_heads, bs, cfg.head_dim)
    tables = np.zeros((B, MB), np.int32)
    free = list(range(1, n_blocks))
    for b in range(B):
        if active[b]:
            nb = min(MB, -(-(lengths[b] + 8) // bs))
            tables[b, :nb] = free[:nb]
            free = free[nb:]
    return dict(k_pool=(rng.standard_normal(shape) * 0.5).astype(np.float32),
                v_pool=(rng.standard_normal(shape) * 0.5).astype(np.float32),
                block_tables=tables, lengths=np.asarray(lengths, np.int32),
                starts=np.asarray(starts, np.int32), active=np.asarray(active, bool))


def run_forward_paged(jmod, jparams, jcfg, tmod, tparams, cfg, st, forced, impl):
    """Steps of forward_paged on forced tokens [n, B] in both packages from
    the same state. Returns ([(port logits, JAX logits)] per step, port
    state, JAX state)."""
    jstate = JPagedKVState(**{k: jnp.asarray(v) for k, v in st.items()})
    tstate = PagedKVState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    seen = []
    for tok in forced:
        jlg, jstate = jmod.forward_paged(jparams, jcfg, jnp.asarray(tok), jstate)
        tlg, tstate = tmod.forward_paged(tparams, cfg, torch.from_numpy(tok), tstate,
                                         attn_impl=impl)
        seen.append((tlg.numpy(), np.asarray(jlg)))
    return seen, tstate, jstate


def assert_paged_steps_agree(seen, tstate, jstate, active):
    """Active rows' logits, the advanced lengths, and the pools outside the
    null block (inactive rows write there, in an order neither package
    fixes)."""
    for i, (got, want) in enumerate(seen):
        np.testing.assert_allclose(got[active], want[active], **LOGIT_TOL,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jstate.lengths))
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[:, 1:],
                                   np.asarray(getattr(jstate, name))[:, 1:], **LOGIT_TOL)


@pytest.mark.parametrize("fam", ["llama", "mistral"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_paged_matches_jax(fam, impl):
    """Three steps on forced tokens: rows of ragged lengths (mistral's
    window of 8 binds on each), one starting inside its first block, one
    crossing a block boundary, and an inactive row with a stale length."""
    jcfg, jparams, cfg, tparams = _models(fam)
    active = np.array([True, True, True, False])
    st = paged_state(cfg, 5, [20, 31, 7, 45], [0, 3, 0, 0], active)
    forced = np.random.default_rng(6).integers(3, 101, (3, 4)).astype(np.int32)
    ak.reset_launches()
    seen, tstate, jstate = run_forward_paged(jlm, jparams, jcfg, causal_lm, tparams, cfg,
                                             st, forced, impl)
    assert not ak.LAUNCHES  # the CPU runs the plain versions
    assert_paged_steps_agree(seen, tstate, jstate, active)


def test_forward_paged_fp8_pools_match_jax():
    """e4m3 pools: each step's K/V are cast (saturating at +-448) before
    the in-pool write, and attention decodes the e4m3 slots."""
    jcfg, jparams, cfg, tparams = _models("llama")
    active = np.array([True, True, False])
    st = paged_state(cfg, 7, [17, 40, 3], [0, 0, 0], active)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    for name in ("k_pool", "v_pool"):
        jst[name] = jst[name].astype(jnp.float8_e4m3fn)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    for name in ("k_pool", "v_pool"):
        tst[name] = torch.from_numpy(
            np.array(jst[name]).view(np.uint8)).view(torch.float8_e4m3fn)
    jstate, tstate = JPagedKVState(**jst), PagedKVState(**tst)
    forced = np.random.default_rng(8).integers(3, 101, (2, 3)).astype(np.int32)
    for i, tok in enumerate(forced):
        jlg, jstate = jlm.forward_paged(jparams, jcfg, jnp.asarray(tok), jstate)
        tlg, tstate = causal_lm.forward_paged(tparams, cfg, torch.from_numpy(tok), tstate)
        np.testing.assert_allclose(tlg.numpy()[active], np.asarray(jlg)[active],
                                   **LOGIT_TOL, err_msg=f"step {i}")
    for name in ("k_pool", "v_pool"):
        got = getattr(tstate, name)[:, 1:].view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, np.array(getattr(jstate, name)[:, 1:]).view(np.uint8))


def stepwise(ns):
    """The namespace without decode_paged_steps: the batcher's stepwise
    quantum (forward_paged) then runs, in both packages."""
    return SimpleNamespace(**{k: v for k, v in vars(ns).items()
                              if k != "decode_paged_steps"})


@pytest.mark.parametrize("fam", ["llama", "mistral"])
def test_stepwise_quantum_streams_match_jax_and_frozen(fam):
    """Staggered requests, more than the 3 rows: the port's stepwise
    quantum against the JAX batcher's (the same namespace) and against the
    port's frozen quantum."""
    jcfg, jparams, cfg, tparams = _models(fam)
    prompts = _prompts(17, (5, 20, 37, 3, 2))
    arrivals = [0, 0, 1, 3, 6]
    kw = dict(batch_capacity=3, n_blocks=40, max_blocks_per_seq=6, decode_quantum=4)
    jb = JBatcher(stepwise(j_get_model(jcfg.model_type)), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **kw))
    want, _ = _run(jb, prompts, 9, arrivals)
    b = ContinuousBatcher(stepwise(get_model(cfg.model_type)), cfg, tparams, eos_ids=set(),
                          config=SchedulerConfig(**SC, **kw))
    got, reasons = _run(b, prompts, 9, arrivals)
    frozen, _ = _run(ContinuousBatcher(get_model(cfg.model_type), cfg, tparams,
                                       eos_ids=set(), config=SchedulerConfig(**SC, **kw)),
                     prompts, 9, arrivals)
    assert all(len(v) == 9 for v in got.values()) and set(reasons.values()) == {"length"}
    _assert_streams_agree(fam, prompts, got, want)
    _assert_streams_agree(fam, prompts, got, frozen)


def test_stepwise_quantum_runs_forward_paged_only():
    """The stepwise quantum calls forward_paged, never decode_paged_steps;
    the frozen quantum the reverse."""
    _, _, cfg, tparams = _models("llama")
    counts = {"forward_paged": 0, "decode_paged_steps": 0}

    def counting(ns):
        out = SimpleNamespace(**vars(ns))
        for name in counts:
            fn = getattr(ns, name, None)
            if fn is not None:
                def wrapped(*a, _fn=fn, _name=name, **k):
                    counts[_name] += 1
                    return _fn(*a, **k)
                setattr(out, name, wrapped)
        return out

    kw = dict(batch_capacity=2, n_blocks=20, max_blocks_per_seq=4, decode_quantum=4)
    for ns, used, unused in ((stepwise(get_model("llama")), "forward_paged",
                              "decode_paged_steps"),
                             (get_model("llama"), "decode_paged_steps", "forward_paged")):
        counts.update(forward_paged=0, decode_paged_steps=0)
        b = ContinuousBatcher(counting(ns), cfg, tparams, eos_ids=set(),
                              config=SchedulerConfig(**SC, **kw))
        got, _ = _run(b, _prompts(19, (6, 9)), 9)
        assert all(len(v) == 9 for v in got.values())
        assert counts[used] > 0 and counts[unused] == 0
