"""The remat policies "dots_plus", "dots_plus_ln", "offload" and
"search" of the port (kernels.attention.remat_policy,
incubate.autotune, GPTConfig) against the JAX package's.

- One stacked ``gpt_tiny`` f32 step: the loss (1e-4 relative) and every
  gradient (1e-4 of its largest magnitude), the tolerances of
  ``tests/test_torch_train.py``, against the JAX model under the same
  policy. The JAX package cannot wire "offload" on the CPU (its
  ``save_from_both_policies`` rejects the offload policy's decisions
  there), so the port's "offload" is held against the JAX "dots" step;
  on the CPU the port's "offload" keeps its tensors where they are and
  computes what "dots" computes.
- A census of what each policy keeps for the backward: a dispatch mode
  around the forward records every op's outputs, and the policy's own
  rule (``attention.saves``) picks the kept ones. torch's selective
  checkpoint holds them in its own cache, which
  ``torch.autograd.graph.saved_tensors_hooks`` does not see, so a
  saved-tensors census would count nothing: "dots_plus" keeps L more
  ``[B, S, F]`` tensors than "dots", "dots_plus_ln" 2L more ``[B, S,
  H]`` than "dots_plus".
- ``search_remat_policy`` gives the JAX one's plan and table for equal
  explicit budgets and rates; the model resolves "search" per shape.
- The flash forward runs once a layer under each policy that keeps it.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle2_tpu as paddle
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.incubate import autotune as jautotune
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu_torch.incubate import autotune as tautotune
from paddle2_tpu_torch.kernels import attention, flash_attn
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)

TOL = 1e-4
B, S = 2, 16
NEW = ("dots_plus", "dots_plus_ln", "offload")


def _cfg(gran, **kw):
    return dict(stacked_blocks=True, use_recompute=True,
                recompute_granularity=gran, fused_head_loss=True, **kw)


def _port(gran, state, **kw):
    tm = GPTForCausalLM(gpt_tiny(**_cfg(gran, **kw)), device="cpu", seed=1)
    tm.load_state_dict(gpt_state_from_reference(state))
    return tm


def _ids():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, 128, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


def _near(got, want):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(np.asarray(got, np.float32) - want).max() <= TOL * scale


@pytest.mark.parametrize("gran", NEW)
def test_loss_and_grads_match_jax_under_the_policy(gran):
    jgran = "dots" if gran == "offload" else gran
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(**_cfg(jgran)))
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    ids, labels = _ids()
    jloss = paddle.jit.to_static(lambda i, y: jm(i, labels=y)[1])(
        Tensor(ids), Tensor(labels))
    jloss.backward()
    jgrads = gpt_state_from_reference(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    tm = _port(gran, state)
    _, loss = tm(torch.from_numpy(ids).long(),
                 labels=torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        _near(tgrads[name].grad.numpy(), want.numpy())
    assert attention.offload_to_host.bytes == 0    # nothing left the CPU


class _Census(TorchDispatchMode):
    """Every op of a forward with its outputs' shapes and, for the tag
    op, its name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((func, args[1:2], [tuple(o.shape) for o in outs
                                           if isinstance(o, torch.Tensor)]))
        return out


def _kept(gran):
    """Shapes the policy keeps in one stacked gpt_tiny forward."""
    tm = GPTForCausalLM(gpt_tiny(**_cfg(gran)), device="cpu", seed=1)
    ids = torch.from_numpy(_ids()[0]).long()
    census = _Census()
    with census:
        tm(ids, labels=ids)
    return [shape for op, a, shapes in census.ops
            if attention.saves(gran, op, None, *a) for shape in shapes]


def test_each_policy_keeps_what_its_docstring_says():
    cfg = gpt_tiny()
    L, H, F = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
    kept = {g: Counter(_kept(g)) for g in ("dots",) + NEW}
    assert kept["dots_plus"] - kept["dots"] == Counter({(B, S, F): L})
    assert kept["dots"] - kept["dots_plus"] == Counter()
    assert kept["dots_plus_ln"] - kept["dots_plus"] == \
        Counter({(B, S, H): 2 * L})                  # both LN tags
    assert kept["dots_plus"] - kept["dots_plus_ln"] == Counter()
    assert kept["offload"] == kept["dots"]
    # the dots: per layer qkv, out_proj, up, down (2-D products) and the
    # flash op's o [B, heads, S, D] with its f32 lse [B, heads, S]
    d = kept["dots"]
    assert d[(B * S, 3 * H)] == L and d[(B * S, F)] == L
    assert d[(B, cfg.num_heads, S)] == L


@pytest.mark.parametrize("gran", ("dots",) + NEW)
def test_the_flash_forward_runs_once_a_layer(gran, monkeypatch):
    calls = []
    orig = flash_attn.flash_fwd_reference
    monkeypatch.setattr(flash_attn, "flash_fwd_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tm = GPTForCausalLM(gpt_tiny(**_cfg(gran)), device="cpu", seed=1)
    ids = torch.from_numpy(_ids()[0]).long()
    tm(ids, labels=ids)[1].backward()
    assert len(calls) == tm.cfg.num_layers


def test_remat_policy_takes_the_granularities():
    for g in attention.POLICIES:
        assert callable(attention.remat_policy(g))
    assert attention.remat_policy("full") is None
    with pytest.raises(ValueError, match="resolved per"):
        attention.remat_policy("search")
    with pytest.raises(ValueError, match="unknown remat granularity"):
        attention.remat_policy("dots_and_more")


def _as_dict(plan):
    d = dataclasses.asdict(plan)
    d["table"] = [dict(r) for r in d["table"]]
    return d


# (budget GB, peak FLOP/s) that land on each candidate of the bench
# GPT's table: save_all, dots_plus_ln, dots_plus, dots, save_nothing,
# offload_dots (a slow card: recompute dearer than the host link), and
# nothing fits
PLANS = [(40.0, 989e12), (12.4, 989e12), (11.8, 989e12), (11.0, 989e12),
         (8.0, 989e12), (8.0, 1e11), (2.0, 989e12)]


@pytest.mark.parametrize("budget_gb,peak", PLANS)
def test_search_gives_the_jax_plan_for_equal_rates(budget_gb, peak,
                                                    monkeypatch):
    monkeypatch.setattr(tautotune, "_offload_supported",
                        jautotune._offload_supported)
    kw = dict(hidden=1024, num_layers=24, num_heads=16, seq=1024, batch=8,
              budget_bytes=budget_gb * 1e9, fixed_bytes=337e6 * 16,
              peak_flops=peak, hbm_bps=3.35e12, offload_gbps=64.0)
    want = jautotune.search_remat_policy(**kw)
    got = tautotune.search_remat_policy(**kw)
    assert _as_dict(got) == _as_dict(want)
    assert got.cache_token() == want.cache_token()


def test_the_model_resolves_search_per_shape(monkeypatch):
    monkeypatch.delenv("PADDLE_REMAT_BUDGET_GB", raising=False)
    tm = GPTForCausalLM(gpt_tiny(**_cfg("search")), device="cpu", seed=1)
    with pytest.raises(ValueError,
                       match="remat_budget_gb or PADDLE_REMAT_BUDGET_GB"):
        tm.gpt.remat_plan(B, S)
    monkeypatch.setenv("PADDLE_REMAT_BUDGET_GB", "1.0")
    plan = tm.gpt.remat_plan(B, S)
    assert plan is tm.gpt.remat_plan(B, S)           # cached per shape
    assert tm.gpt.remat_plan(B, 2 * S) is not plan
    cfg = tm.cfg
    n = sum(p.numel() for p in tm.parameters())
    want = tautotune.search_remat_policy(
        hidden=cfg.hidden_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, seq=S, batch=B, ffn=cfg.ffn_size,
        budget_bytes=1e9, fixed_bytes=n * 16.0)
    assert _as_dict(plan) == _as_dict(want)
    # a budget below the fixed bytes fits nothing: full recompute
    tight = GPTForCausalLM(gpt_tiny(**_cfg("search", remat_budget_gb=1e-6)),
                           device="cpu", seed=1)
    p = tight.gpt.remat_plan(B, S)
    assert (p.policy, p.granularity, p.fits) == ("save_nothing", "full",
                                                 False)
    assert GPTForCausalLM(gpt_tiny(**_cfg("dots")), device="cpu",
                          seed=1).gpt.remat_plan(B, S) is None
