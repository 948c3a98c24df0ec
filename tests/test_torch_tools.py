"""The port's offline tools (paddle2_tpu_torch.tools: perf_doctor,
serve_doctor, flight_doctor) against the JAX package's
(paddle2_tpu.tools): on the same metrics streams, request traces and
flight-recorder dumps both give equal ``--json`` reports (and text
reports, and exit codes). A stream that the port's ``jit.train_step``
wrote and one that the JAX package's wrote for the same ``gpt_tiny``
steps both parse through both tools, with equal step and token
counts. The port's tools import nothing of torch or JAX."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle2_tpu as jpaddle
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.observability import metrics as jmetrics
from paddle2_tpu.tools import flight_doctor as jflight
from paddle2_tpu.tools import perf_doctor as jperf
from paddle2_tpu.tools import serve_doctor as jserve
import paddle2_tpu_torch as tp
from paddle2_tpu_torch import jit
from paddle2_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle2_tpu_torch.observability import metrics as tmetrics
from paddle2_tpu_torch.optimizer import AdamW
from paddle2_tpu_torch.tools import flight_doctor as tflight
from paddle2_tpu_torch.tools import perf_doctor as tperf
from paddle2_tpu_torch.tools import serve_doctor as tserve

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    jmetrics.disable()
    tmetrics.disable()


def _both(capsys, jmain, tmain, argv):
    """Each package's ``main(argv)``: (exit code, stdout) twice."""
    out = []
    for main in (jmain, tmain):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_the_tools_import_only_the_standard_library():
    stdlib = {"argparse", "json", "os", "statistics", "sys", "time",
              "typing", "__future__"}
    for path in sorted((ROOT / "paddle2_tpu_torch" / "tools").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert all(n.split(".")[0] in stdlib for n in names), \
                (path.name, names)


# ------------------------------------------------------------- perf_doctor
def _write_stream(d, rank, steps, inp=0.002, comp=0.010, coll=0.001,
                  host=0.0005, tokens=2048, counters=None, extra=None,
                  hist=False):
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(steps):
        lines.append(json.dumps({
            "type": "step", "rank": rank, "step": i,
            "total_s": inp + comp + coll + host, "input_wait_s": inp,
            "compute_s": comp, "collective_s": coll, "host_s": host,
            "tokens": tokens, **(extra or {})}))
    hists = {}
    if hist:
        hists = {"checkpoint_save_seconds": {"": {
            "sum": 1.5, "count": 4, "buckets": [0.1, 0.5, 1.0, None],
            "counts": [1, 3, 4, 4]}}}
    lines.append(json.dumps({
        "type": "metrics", "rank": rank,
        "counters": {"steps_total": {"": steps}, **(counters or {})},
        "gauges": {"amp_loss_scale": {"": 1024.0}}, "histograms": hists}))
    with open(os.path.join(d, f"metrics_rank_{rank}.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _fleet(d, slow=False):
    cost = {"modeled_step_s": 0.011, "roofline_s": 0.011,
            "modeled_flops": 1e12, "peak_flops": 989e12}
    _write_stream(d, 0, 10, counters={"step_retries_total": {"": 2}},
                  extra=cost, hist=True)
    _write_stream(d, 1, 10, extra=cost)
    _write_stream(d, 2, 10, comp=0.200 if slow else 0.010, extra=cost)
    _write_stream(d, 3, 10, inp=0.040, extra=cost)


def test_perf_doctor_reports_agree(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fleet(a)
    _fleet(b, slow=True)
    fd = tmp_path / "flight"
    fd.mkdir()
    (fd / "rank_0.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"type": "header", "rank": 0, "reason": "sigterm"},
        {"type": "event", "n": 0, "kind": "step_retry"})) + "\n")
    for argv in (["--json", a], [a, "--flight-dir", str(fd)],
                 ["diff", a, b, "--json"], ["diff", a, b],
                 ["diff", a, a], [str(tmp_path / "empty")]):
        (jrc, jout), (trc, tout) = _both(capsys, jperf.main, tperf.main,
                                         argv)
        assert (trc, tout) == (jrc, jout), argv
    rep = json.loads(_both(capsys, jperf.main, tperf.main,
                           ["--json", b])[1][1])
    assert 2 in rep["straggler"]["step_time"]["suspects"]


# ------------------------------------------------------------ serve_doctor
def _rec(event, t, **kw):
    return {"type": "span", "event": event, "t": t, **kw}


def _trace_dir(tmp_path, name, queue_s):
    recs = []
    for tid in range(3):
        t0 = float(tid)
        q = queue_s * (1 + tid)
        recs += [_rec("submit", t0, tid=tid), _rec("admit", t0 + q, tid=tid),
                 _rec("prefill", t0 + q, end=t0 + q + 0.1, tid=tid),
                 _rec("decode_step_dropped", t0 + q + 0.1, dur=0.05,
                      tids=[tid], chaos="drop_decode_step"),
                 _rec("decode_step", t0 + q + 0.15, dur=0.2, tids=[tid]),
                 _rec("finish", t0 + q + 0.35, tid=tid, tokens=2)]
    d = tmp_path / name
    d.mkdir()
    (d / "trace_rank_0.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs) + "\n")
    return str(d)


def test_serve_doctor_reports_agree(tmp_path, capsys):
    base = _trace_dir(tmp_path, "b", 0.1)
    cand = _trace_dir(tmp_path, "c", 0.6)
    for argv in (["--json", base], [base], ["diff", base, cand, "--json"],
                 ["diff", base, cand, "--threshold", "10"],
                 ["diff", base, base]):
        (jrc, jout), (trc, tout) = _both(capsys, jserve.main, tserve.main,
                                         argv)
        assert (trc, tout) == (jrc, jout), argv


# ----------------------------------------------------------- flight_doctor
def _dumps(d):
    """Two ranks that disagree on collective 1 (a desync), with serving
    and step events and a gossip dir for the straggler view."""
    d.mkdir()
    for r in (0, 1):
        recs = [{"type": "header", "rank": r, "world": 2,
                 "reason": "watchdog", "node": f"n{r}"},
                {"type": "event", "n": 0, "kind": "step_ok", "step": 4},
                {"type": "event", "n": 1, "kind": "collective_enter",
                 "cseq": 0, "op": "all_reduce", "shape": [8],
                 "dtype": "float32"},
                {"type": "event", "n": 2, "kind": "collective_exit",
                 "cseq": 0},
                {"type": "event", "n": 3, "kind": "collective_enter",
                 "cseq": 1, "op": "all_reduce" if r == 0 else "all_gather",
                 "shape": [8], "dtype": "float32"},
                {"type": "event", "n": 4, "kind": "serving",
                 "event": "admit", "req": 3}]
        (d / f"rank_{r}.jsonl").write_text(
            "\n".join(json.dumps(x) for x in recs) + "\n")
    g = d / "gossip"
    g.mkdir()
    (g / "rank.0").write_text("0.1")
    (g / "rank.1").write_text("0.9")
    return str(d), str(g)


def test_flight_doctor_reports_agree(tmp_path, capsys):
    d, g = _dumps(tmp_path / "flight")
    for argv in (["--json", d, "--gossip-dir", g], [d]):
        (jrc, jout), (trc, tout) = _both(capsys, jflight.main, tflight.main,
                                         argv)
        assert (trc, tout) == (jrc, jout), argv
    assert jrc == jflight.DESYNC_EXIT


# --------------------------------------------------- train_step streams
STEPS, B, S = 3, 2, 16


def _port_stream(directory):
    tp.set_device("cpu")
    model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = jit.train_step(lambda i, l: model(i, labels=l)[1], opt)
    ids = torch.randint(0, 128, (B, S), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    pl = tmetrics.enable(str(directory), rank=0)
    for _ in range(STEPS):
        step(ids, ids)
    tmetrics.flush()
    tmetrics.disable()
    return pl.stream_path


def _jax_stream(directory):
    jpaddle.seed(0)
    model = JaxGPT(jax_tiny())
    opt = jpaddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=model.parameters())
    step = jpaddle.jit.train_step(lambda i, l: model(i, labels=l)[1], opt,
                                  layers=[model])
    ids = jpaddle.to_tensor(np.random.default_rng(0).integers(
        0, 128, (B, S)).astype(np.int32))
    pl = jmetrics.enable(str(directory), rank=0)
    for _ in range(STEPS):
        step(ids, ids)
    jmetrics.flush()
    jmetrics.disable()
    return pl.stream_path


def test_train_step_streams_parse_through_both_tools(tmp_path):
    """Each package's train step writes one step record a call (samples
    B, tokens B·S, a compute phase); both perf_doctors read both
    streams and count the same steps and tokens."""
    streams = {"torch": _port_stream(tmp_path / "torch"),
               "jax": _jax_stream(tmp_path / "jax")}
    counts = {}
    for who, path in streams.items():
        recs = [json.loads(ln) for ln in open(path)]
        steps = [r for r in recs if r["type"] == "step"]
        assert len(steps) == STEPS
        assert all(s["tokens"] == B * S and s["samples"] == B
                   and s["compute_s"] > 0 for s in steps), who
        for tool in (jperf, tperf):
            rep = tool.summarize(tool.load_streams(str(Path(path).parent)),
                                 warmup=0)
            agg = rep["aggregate"]
            counts.setdefault(who, []).append(
                (agg["steps"], rep["per_rank"][0]["tokens_total"]
                 if "tokens_total" in rep["per_rank"][0] else None,
                 rep["counters"].get("steps_total")))
        assert counts[who][0] == counts[who][1], who
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][0][0] == STEPS
