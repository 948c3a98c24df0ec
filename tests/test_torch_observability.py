"""The port's observability plane (paddle2_tpu_torch.observability)
against the JAX package's (paddle2_tpu.observability).

The registry, step-window and Prometheus cases of
``tests/test_observability.py`` run against both metrics modules; under
a patched clock the same call sequence writes the same JSONL records in
both; the cost model's arithmetic (``wire_bytes``, ``LinkModel``,
``CollectiveTraffic``, ``StepCost``, ``PhasedStepCost``,
``pipeline_bubble_fraction``) gives equal numbers for equal explicit
rates (exactly: the same float operations in the same order); the
port's chip table names cards, not TPUs; ``program_cost`` of a
``gpt_tiny`` step counts the flash ops by their formulas. No case
compiles JAX."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import paddle2_tpu.observability as jobs
from paddle2_tpu.observability import cost_model as jcm
from paddle2_tpu.observability import metrics as jmetrics
import paddle2_tpu_torch as tp
import paddle2_tpu_torch.observability as tobs
from paddle2_tpu_torch.observability import cost_model as tcm
from paddle2_tpu_torch.observability import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
MODS = {"jax": jmetrics, "torch": tmetrics}


@pytest.fixture(autouse=True)
def _clean_planes():
    for m in MODS.values():
        m.disable()
    yield
    for m in MODS.values():
        m.disable()


@pytest.fixture(params=list(MODS))
def metrics(request):
    return MODS[request.param]


def test_the_packages_export_the_same_names():
    assert tobs.__all__ == jobs.__all__
    assert tmetrics.__all__[:len(jmetrics.__all__)] == jmetrics.__all__
    for name in jcm.__all__:
        assert hasattr(tcm, name), name
    for name in ("PHASES", "EVENT_COST_OPS", "METRICS_DIR_ENV",
                 "METRICS_FLUSH_ENV"):
        assert getattr(tmetrics, name) == getattr(jmetrics, name)


# ---------------------------------------------------------------- registry
def test_counter_gauge_histogram(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0)
    pl.inc("requests_total", op="a")
    pl.inc("requests_total", 2.0, op="a")
    pl.inc("requests_total", op="b")
    assert pl.counter("requests_total").value(op="a") == 3.0
    assert pl.counter("requests_total").value(op="b") == 1.0
    pl.set_gauge("scale", 42.0)
    pl.set_gauge("scale", 7.0)
    assert pl.gauge("scale").value() == 7.0
    pl.observe("lat_seconds", 0.003)
    pl.observe("lat_seconds", 4.0)
    snap = pl.snapshot()
    assert snap["histograms"]["lat_seconds"][""]["count"] == 2
    assert snap["histograms"]["lat_seconds"][""]["sum"] == \
        pytest.approx(4.003)


def test_counter_cannot_decrease_and_kinds_do_not_collide(metrics,
                                                          tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0)
    with pytest.raises(ValueError):
        pl.inc("x_total", -1.0)
    pl.inc("thing")
    with pytest.raises(TypeError):
        pl.set_gauge("thing", 1.0)


def test_disabled_hooks_are_noops(metrics, monkeypatch):
    assert metrics.active() is None
    metrics.inc("never")
    metrics.set_gauge("never", 1.0)
    metrics.observe("never", 1.0)
    assert metrics.step_end() is None
    with metrics.phase("compute"):
        pass
    monkeypatch.delenv(metrics.METRICS_DIR_ENV, raising=False)
    with pytest.raises(ValueError):
        metrics.enable()


# ------------------------------------------------------------ step windows
def test_components_sum_exactly(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0)
    with pl.phase("input"):
        time.sleep(0.002)
    with pl.phase("compute"):
        time.sleep(0.004)
        with pl.phase("collective"):    # nested: innermost owns it
            time.sleep(0.003)
    rec = pl.step_end(tokens=1024)
    parts = (rec["input_wait_s"] + rec["compute_s"] + rec["collective_s"]
             + rec["host_s"])
    assert rec["total_s"] == pytest.approx(parts, abs=1e-12)
    assert rec["host_s"] >= 0 and rec["collective_s"] >= 0.003
    assert rec["compute_s"] >= 0.004
    assert rec["tokens"] == 1024 and rec["tokens_per_s"] > 0


def test_unclosed_phase_reset_and_flush_clamp(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0, flush_steps=2)
    pl.phase_enter("compute")           # never exited (error path)
    rec = pl.step_end()
    assert rec["compute_s"] > 0
    time.sleep(0.02)
    pl.phase_enter("compute")
    pl.step_window_reset()
    rec = pl.step_end()
    assert rec["total_s"] < 0.02 and rec["compute_s"] == 0.0
    again = metrics.enable(str(tmp_path), flush_steps=0)
    assert again is pl and pl.flush_steps == 1
    pl.step_end()


def test_background_inc_races_flush(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0, flush_steps=1)
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            pl.inc("quarantines_total", reason=f"r{i}")
            i += 1
    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        for _ in range(20):
            pl.step_end()
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_stream_file_names_and_records(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=3, flush_steps=2)
    pl.step_end()
    pl.step_end()                       # auto-flush here
    assert pl.stream_path.endswith("metrics_rank_3.jsonl")
    assert pl.prom_path.endswith("metrics_rank_3.prom")
    pl.inc("late_total")
    pl.flush()
    lines = [json.loads(ln) for ln in open(pl.stream_path)]
    steps = [r for r in lines if r["type"] == "step"]
    snaps = [r for r in lines if r["type"] == "metrics"]
    assert len(steps) == 2 and steps[0]["rank"] == 3
    assert snaps[-1]["counters"]["late_total"][""] == 1.0


def test_textfile_format(metrics, tmp_path):
    pl = metrics.enable(str(tmp_path), rank=0)
    pl.inc("req_total", 3, op="all_reduce")
    pl.set_gauge("scale", 2.5)
    pl.observe("dur_seconds", 0.004)
    text = open(pl.export_prometheus()).read()
    assert "# TYPE req_total counter" in text
    assert 'req_total{op="all_reduce"} 3.0' in text
    assert "# TYPE scale gauge" in text and "scale 2.5" in text
    assert 'dur_seconds_bucket{le="+Inf"} 1' in text
    assert "dur_seconds_count 1" in text


def _record_calls(mod, directory):
    """One call sequence on ``mod``'s plane: every record kind."""
    pl = mod.enable(str(directory), rank=1, flush_steps=3)
    for i in range(4):
        with mod.phase("input"):
            pass
        with mod.phase("compute"):
            with mod.phase("collective"):
                pass
        mod.inc("steps_seen_total", op=f"k{i % 2}")
        mod.set_gauge("amp_loss_scale", 2.0 ** (10 - i))
        mod.observe("save_seconds", 0.01 * i)
        mod.step_end(tokens=512, samples=4, loss_scale=1024.0, loss=0.5)
    mod.flush()
    path = pl.export_prometheus()
    mod.disable()
    return (Path(pl.stream_path).read_text(), Path(path).read_text())


def test_a_patched_clock_gives_the_same_records(tmp_path, monkeypatch):
    """The same calls under the same clock write byte-equal JSONL streams
    and Prometheus files in both packages."""
    outs = []
    for name, mod in MODS.items():
        ticks = iter(range(10_000))
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(ticks) * 0.001)
        monkeypatch.setattr(time, "time", lambda: 1.7e9)
        outs.append(_record_calls(mod, tmp_path / name))
        monkeypatch.undo()
    assert outs[0] == outs[1]
    recs = [json.loads(ln) for ln in outs[1][0].splitlines()]
    assert [r["type"] for r in recs].count("step") == 4


def test_auto_enable_needs_the_worker_guard(tmp_path):
    code = ("import paddle2_tpu_torch.observability.metrics as m; "
            "print(m.active() is not None)")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PADDLE_", "FLAGS_"))}
    base["PYTHONPATH"] = str(ROOT)
    got = []
    for extra in ({}, {"PADDLE_TRAINER_ID": "0"}):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env={**base, "PADDLE_METRICS_DIR": str(tmp_path),
                              **extra})
        got.append(out.stdout.strip())
    assert got == ["False", "True"]


# -------------------------------------------------------------- cost model
def test_wire_bytes_formulas_match():
    for op in ("all_reduce_sum", "all_gather", "reduce_scatter",
               "all_to_all", "broadcast", "ppermute", "barrier",
               "mystery_op"):
        for n in (1, 2, 8):
            assert tcm.wire_bytes(op, 1024.0, n) == \
                jcm.wire_bytes(op, 1024.0, n)
    assert tcm.wire_bytes("all_reduce_sum", 1024.0, 8) == \
        pytest.approx(2 * 7 / 8 * 1024.0)


def _rates(mod):
    return mod.LinkModel(ici_gbps=100.0, dcn_gbps=10.0, dcn_axes=["pp"],
                         ici_latency_us=1.5, dcn_latency_us=40.0)


def _traffic(mod):
    tr = mod.CollectiveTraffic()
    tr.add("all_reduce_sum", 1e6, axes=("dp",), group_size=4,
           overlappable=True)
    tr.add("all_gather", 2e6, axes=("pp",), group_size=4)
    tr.add_hierarchical_all_reduce(3e6, ("dp",), ("pp",), 4, 2,
                                   overlappable=True)
    counts = tr.add_all_to_all_matrix([[0, 1e3, 2e3, 0], [5e2, 0, 0, 1e3],
                                       [1e3, 1e3, 0, 7e2], [0, 3e2, 1e3, 0]],
                                      ranks_per_slice=2, hierarchical=True)
    ring = tr.add_ring_hops(4e5, [0, 0, 1, 1])
    return tr, counts, ring


def test_link_model_and_traffic_agree_for_equal_rates():
    jl, tl = _rates(jcm), _rates(tcm)
    for axes in ((), ("dp",), ("pp",), ("dp", "pp"), ("x_dcn",)):
        assert tl.link_class(axes) == jl.link_class(axes)
        assert tl.latency(axes) == jl.latency(axes)
        assert tl.seconds(1e9, axes) == jl.seconds(1e9, axes)
    (jt, jc, jr), (tt, tc, tr) = _traffic(jcm), _traffic(tcm)
    assert (tc, tr) == (jc, jr)
    assert tt.entries == jt.entries
    for fn in ("wire_bytes_total", "payload_bytes_total",
               "overlappable_wire_bytes", "exposed_wire_bytes", "by_op"):
        assert getattr(tt, fn)() == getattr(jt, fn)()
    assert tt.seconds(tl) == jt.seconds(jl)
    assert tt.overlap_split(tl, 1e-4) == jt.overlap_split(jl, 1e-4)
    assert tt.overlap_split_by_class(tl, 1e-4) == \
        jt.overlap_split_by_class(jl, 1e-4)
    for cls in ("host", "ici", "dcn"):
        assert tcm.sparse_transfer_seconds(1e6, cls, tl, 3, 16.0) == \
            jcm.sparse_transfer_seconds(1e6, cls, jl, 3, 16.0)


def test_step_costs_agree_for_equal_rates():
    out = []
    for mod in (jcm, tcm):
        tr, _, _ = _traffic(mod)
        sc = mod.StepCost(flops=3e12, hbm_bytes=2e9, traffic=tr,
                          link=_rates(mod), peak_flops=1e14, hbm_bps=1e12)
        ph = mod.PhasedStepCost().add("fwd_bwd", sc).add(
            "update", mod.StepCost(flops=1e9, hbm_bytes=5e9,
                                   peak_flops=1e14, hbm_bps=1e12))
        out.append((sc.roofline(), sc.mfu(0.05), ph.breakdown(),
                    ph.mfu_modeled(), ph.step_record_fields(),
                    [mod.pipeline_bubble_fraction(p, m, v)
                     for p, m, v in ((1, 4, 1), (4, 8, 1), (8, 16, 2))]))
    out[0][0].pop("chip")
    out[1][0].pop("chip")
    assert out[0] == out[1]
    sc = tcm.StepCost(flops=1e12, hbm_bytes=1e9, peak_flops=1e14,
                      hbm_bps=1e12)
    assert sc.bound() == "compute" and sc.mfu(0.02) == pytest.approx(0.5)


def test_chip_table_names_cards_and_no_tpu(monkeypatch):
    tpu = ("v4", "v5", "v6", "lite", "trillium", "tpu")
    for table in (tcm.CHIP_PEAKS, tcm.CHIP_HBM_GB):
        assert table and not any(k in key for key in table for k in tpu)
    monkeypatch.delenv(tcm.PEAK_ENV, raising=False)
    monkeypatch.delenv(tcm.HBM_ENV, raising=False)
    peak, hbm, label = tcm.chip_peak("cpu")
    assert (peak, hbm) == (1e11, 5e10) and label.startswith("cpu-nominal")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tcm.chip_peak(torch.device("cuda", 0))[:2] == (989e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="PADDLE_PEAK_TFLOPS.*"
                       "PADDLE_HBM_GBPS"):
        tcm.chip_peak(torch.device("cuda", 0))
    monkeypatch.setenv(tcm.PEAK_ENV, "100")
    monkeypatch.setenv(tcm.HBM_ENV, "2000")
    assert tcm.chip_peak(torch.device("cuda", 0)) == (1e14, 2e12,
                                                      "env-override")
    with pytest.raises(ValueError, match="PADDLE_HBM_CAPACITY_GB"):
        tcm.chip_hbm_gb("cpu")
    # the nominal link figures are the node's, not a TPU pod's
    assert (tcm.DEFAULT_ICI_GBPS, tcm.DEFAULT_DCN_GBPS,
            tcm.DEFAULT_HOST_GBPS) == (450.0, 50.0, 64.0)


def test_program_cost_counts_the_flash_ops_by_their_formula():
    """One ``gpt_tiny`` training step (stacked, "dots", fused head): the
    counter sees each block's products, and the flash forward and
    backward ops as one op each, counted over the full S x S square;
    the fused AdamW (its C entry on the card) counts nothing."""
    from paddle2_tpu_torch import jit
    from paddle2_tpu_torch.kernels.flash_attn import attention_flops
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle2_tpu_torch.optimizer import AdamW
    tp.set_device("cpu")
    cfg = gpt_tiny(use_recompute=True, recompute_granularity="dots",
                   stacked_blocks=True, fused_head_loss=True)
    model = GPTForCausalLM(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                fused=True)
    step = jit.train_step(lambda i, l: model(i, labels=l)[1], opt)
    B, S = 2, 64
    ids = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(0))
    cost = tcm.program_cost(step, (ids, ids))
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    D = H // cfg.num_heads
    fwd = attention_flops(B, cfg.num_heads, S, S, D, D)
    bwd = attention_flops(B, cfg.num_heads, S, S, D, D, backward=True)
    assert cost["flops paddle2_tpu_torch.flash_attn"] == L * fwd
    assert cost["flops paddle2_tpu_torch.flash_attn_bwd"] == L * bwd
    assert bwd == 2.5 * fwd                 # five products against two
    tokens = B * S
    # blocks' products 6 * 12 H^2 a layer, the fused head's 8 V H (its
    # backward recomputes the logits), the attention 14 S H a layer
    want = (6 * 12 * H * H * L + 8 * V * H + 14 * S * H * L) * tokens
    assert cost["flops"] == want
    step.collect_cost = True
    step(ids, ids)
    assert tcm.step_cost_of_program(step).flops == want
