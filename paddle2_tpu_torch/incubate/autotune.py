"""Remat policy search: the counterpart of the remat half of
``paddle2_tpu/incubate/autotune.py`` (``:199-404``), with the same
candidate table, scores and seeded tie-break.

:func:`search_remat_policy` enumerates checkpoint policies for a GPT
block (save-everything / save-dots with the gelu and LayerNorm variants
/ save-nothing / host-offload), scores each by the deterministic cost
model (recompute FLOPs added + HBM bytes re-touched + offload traffic,
against activation bytes saved and an explicit memory budget), and
picks the policy of least modeled overhead that fits. The winner wires
into ``models/gpt.py`` (``recompute_granularity="search"``). The rates
come from the port's cost model: the card's peak and HBM rate
(``chip_peak``) and the PCIe host link (``host_link_bps``).

The kernel-tuning half of the JAX module (``set_config``,
``best_flash_blocks`` and its block scores) is TPU tuning and waits for
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..observability.cost_model import (
    HOST_ENV as OFFLOAD_ENV,
    host_link_bps as _host_link_bps,
)

AUTOTUNE_SEED_ENV = "PADDLE_AUTOTUNE_SEED"

# elementwise recompute cost, FLOPs per element (nominal op counts; only
# RELATIVE weight matters — every candidate is scored by the same table)
_LN_FLOPS_PER_ELEM = 8.0        # two reduction passes + normalize+affine
_GELU_FLOPS_PER_ELEM = 12.0     # tanh-approx gelu
_ADD_FLOPS_PER_ELEM = 1.0

__all__ = ["RematCandidate", "RematPlan", "gpt_remat_candidates",
           "search_remat_policy", "OFFLOAD_ENV", "AUTOTUNE_SEED_ENV"]


def _tie_rng():
    import numpy as np
    return np.random.RandomState(
        int(os.environ.get(AUTOTUNE_SEED_ENV, "0")))


@dataclass
class RematCandidate:
    """One remat policy's per-layer accounting at a given (batch, seq).

    ``granularity`` is the ``GPTConfig.recompute_granularity`` value
    the candidate wires to (``None`` = no checkpoint at all).
    ``saved_bytes`` is the activation HBM held per layer for backward;
    ``recompute_flops``/``recompute_bytes`` the extra work backward
    pays; ``offload_bytes`` what leaves HBM for pinned host memory
    (charged at the offload link, twice: out in forward, back in
    backward)."""
    name: str
    granularity: Optional[str]
    saved_bytes: float
    recompute_flops: float
    recompute_bytes: float
    offload_bytes: float = 0.0
    wired: bool = True      # False: this host cannot run the policy

    def overhead_s(self, peak_flops: float, hbm_bps: float,
                   offload_bps: float) -> float:
        """Modeled backward-overhead seconds per layer — the score."""
        return (self.recompute_flops / peak_flops
                + self.recompute_bytes / hbm_bps
                + 2.0 * self.offload_bytes / offload_bps)


@dataclass
class RematPlan:
    """The searcher's verdict: the chosen policy plus the full scored
    table (the bench prints it; the budget gate re-checks it)."""
    policy: str
    granularity: Optional[str]
    use_recompute: bool
    fits: bool
    budget_bytes: float
    fixed_bytes: float
    activation_bytes: float     # L x saved_bytes of the chosen policy
    total_bytes: float
    recompute_flops: float      # L x per-layer, chosen policy
    overhead_s: float           # L x per-layer modeled seconds
    table: List[Dict] = field(default_factory=list)

    def cache_token(self) -> Tuple:
        """Hashable token of the plan (the JAX package keys its
        ``jit.train_step`` program cache with it; the eager port has no
        program cache)."""
        return ("remat", self.policy, self.granularity,
                self.use_recompute)


def _offload_supported() -> bool:
    """Whether the "offload" policy can run here: wherever CUDA pinned
    host memory exists (a CUDA device is available). On the CPU the
    tensors are on the host already, and the candidate is not wired."""
    import torch
    return torch.cuda.is_available()


def gpt_remat_candidates(hidden: int, ffn: int, num_heads: int,
                         tokens: int, act_bytes: int = 2
                         ) -> List[RematCandidate]:
    """The per-layer accounting table for one GPT pre-LN block at
    ``tokens = batch x seq`` activations of ``act_bytes`` each.

    Saved-tensor census per policy (t = tokens, H = hidden, F = ffn):

    ===================  ==========================================
    save_all             every intermediate: ln1/ln2 (2H), qkv (3H),
                         flash o (H) + f32 lse, out_proj (H), both
                         residuals (2H), up (F), gelu (F), down (H)
    save_dots_plus_ln    dots + gelu + both LN outputs
    save_dots_plus       dots + gelu output   (the "save-qkv-and-mlp-
                         activations" point: every matmul input in
                         backward is materialized)
    save_dots            matmul outputs + pinned flash (o, lse) only
    save_nothing         block input only; backward re-runs the whole
                         forward (matmul FLOPs included)
    save_all_offload     save_all's tensors, parked in pinned host
                         memory — HBM cost of save_nothing, transfer
                         cost of the full activation set
    ===================  ==========================================
    """
    t, H, F, N = float(tokens), float(hidden), float(ffn), float(num_heads)
    a = float(act_bytes)
    lse = t * N * 4.0                       # f32, per layer
    dots = t * (7.0 * H + F) * a + lse      # in + qkv + o + proj + up+down
    all_saved = t * (10.0 * H + 2.0 * F) * a + lse
    ln_flops = 2.0 * _LN_FLOPS_PER_ELEM * t * H          # ln1 + ln2
    gelu_flops = _GELU_FLOPS_PER_ELEM * t * F
    add_flops = 2.0 * _ADD_FLOPS_PER_ELEM * t * H
    cands = [
        RematCandidate("save_all", None, all_saved, 0.0, 0.0),
        RematCandidate(
            "save_dots_plus_ln", "dots_plus_ln",
            dots + t * (2.0 * H + F) * a,
            add_flops, 2.0 * t * H * a),
        RematCandidate(
            "save_dots_plus", "dots_plus",
            dots + t * F * a,
            ln_flops + add_flops, t * (6.0 * H) * a),
        RematCandidate(
            "save_dots", "dots", dots,
            ln_flops + gelu_flops + add_flops,
            t * (6.0 * H + 2.0 * F) * a),
    ]
    return cands


def search_remat_policy(*, hidden: int, num_layers: int, num_heads: int,
                        seq: int, batch: int,
                        ffn: Optional[int] = None,
                        budget_bytes: float,
                        fixed_bytes: float = 0.0,
                        act_bytes: int = 2,
                        peak_flops: Optional[float] = None,
                        hbm_bps: Optional[float] = None,
                        offload_gbps: Optional[float] = None,
                        allow_offload: bool = True) -> RematPlan:
    """Deterministic remat policy search for a GPT block stack.

    Enumerates the candidate table, keeps the candidates whose total
    footprint (``fixed_bytes`` — params/grads/optimizer state — plus
    ``num_layers x saved_bytes``) fits ``budget_bytes``, and returns
    the one with the LOWEST modeled backward overhead (recompute FLOPs
    at the chip peak + re-touched HBM bytes at the HBM rate + offload
    traffic at the host link). Exact-score ties break through the
    seeded autotune RNG. When nothing fits, ``save_nothing`` is
    returned with ``fits=False`` — minimal memory is the only honest
    fallback, and the caller (bench gate / README) surfaces it.

    Pure function of its arguments + the rate model: the same config
    resolves to the same policy on every host with the same card. The
    rates default to :func:`~paddle2_tpu_torch.observability.cost_model.
    chip_peak` and ``host_link_bps`` (the card's figures)."""
    from ..observability.cost_model import chip_peak
    if peak_flops is None or hbm_bps is None:
        p, h, _ = chip_peak()
        peak_flops = peak_flops if peak_flops is not None else p
        hbm_bps = hbm_bps if hbm_bps is not None else h
    offload_bps = _host_link_bps(offload_gbps)
    F = int(ffn if ffn is not None else 4 * hidden)
    tokens = int(batch) * int(seq)
    t, H = float(tokens), float(hidden)
    a = float(act_bytes)
    cands = gpt_remat_candidates(hidden, F, num_heads, tokens, act_bytes)
    # save_nothing: full forward re-run in backward (matmul FLOPs are
    # geometry-dependent — built here where seq is known)
    mm_flops = 2.0 * t * H * (4.0 * H + 2.0 * F) + 4.0 * t * seq * H
    ew_flops = (2.0 * _LN_FLOPS_PER_ELEM * t * H
                + _GELU_FLOPS_PER_ELEM * t * F
                + 2.0 * _ADD_FLOPS_PER_ELEM * t * H)
    cands.append(RematCandidate(
        "save_nothing", "full", t * H * a,
        mm_flops + ew_flops, t * (10.0 * H + 2.0 * F) * a))
    if allow_offload:
        # offload variant: HBM footprint of save_nothing, backward
        # work of save_dots — the dot outputs are parked in pinned
        # host memory (and charged twice on the host link) instead of
        # recomputed or held in HBM
        dots_c = next(c for c in cands if c.name == "save_dots")
        cands.append(RematCandidate(
            "offload_dots", "offload", t * H * a,
            dots_c.recompute_flops, dots_c.recompute_bytes,
            offload_bytes=dots_c.saved_bytes,
            wired=_offload_supported()))
    # residual stream between layers rides on top of every policy
    residual = t * H * a
    L = int(num_layers)
    rows: List[Dict] = []
    fitting: List[Tuple[float, RematCandidate, float]] = []
    for c in cands:
        total = float(fixed_bytes) + L * c.saved_bytes + residual
        fits = total <= float(budget_bytes)
        score = L * c.overhead_s(peak_flops, hbm_bps, offload_bps)
        rows.append({
            "policy": c.name, "granularity": c.granularity,
            "saved_bytes_per_layer": c.saved_bytes,
            "recompute_flops": L * c.recompute_flops,
            "recompute_bytes": L * c.recompute_bytes,
            "offload_bytes": L * c.offload_bytes,
            "total_bytes": total, "fits": fits, "wired": c.wired,
            "overhead_s": score})
        if fits and c.wired:
            fitting.append((score, c, total))
    if fitting:
        best_score = min(s for s, _, _ in fitting)
        tied = [(c, tot) for s, c, tot in fitting if s == best_score]
        chosen, total = tied[0] if len(tied) == 1 else \
            tied[_tie_rng().randint(len(tied))]
        fits = True
        score = best_score
    else:
        chosen = next(c for c in cands if c.name == "save_nothing")
        total = float(fixed_bytes) + L * chosen.saved_bytes + residual
        fits = total <= float(budget_bytes)
        score = L * chosen.overhead_s(peak_flops, hbm_bps, offload_bps)
    return RematPlan(
        policy=chosen.name, granularity=chosen.granularity,
        use_recompute=chosen.granularity is not None,
        fits=fits, budget_bytes=float(budget_bytes),
        fixed_bytes=float(fixed_bytes),
        activation_bytes=L * chosen.saved_bytes,
        total_bytes=total,
        recompute_flops=L * chosen.recompute_flops,
        overhead_s=score, table=rows)
