"""The ajAlm activity block's tracing: the `alm` span around the filter's
table and each degree's shifts, and the host counter `alm_tables` (one a
filter evaluation).  CPU, a tiny MS_Global spectrum; no JAX."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.ops.alm import alm_table
from tamcmc_tpu_torch.utils import metrics
from tamcmc_tpu_torch.utils.metrics import counters, counters_since, span

N_PER_L = (3, 3, 3, 0)
ROT = {"model_MS_Global_ajAlm_HarveyLike":
       [1.2, 0.01, 0.0, 1.0, 1e-3, math.radians(30), math.radians(10), 0.0],
       "model_MS_Global_a1etaa3_HarveyLike": [1.2, 1.0, 0.01, 0.0]}


def _walkers(name, k=4):
    """The model, its grid and k parameter vectors of a three-order star."""
    fn, layout = build_model(name, n_per_l=N_PER_L)
    f0 = torch.tensor([2000.0, 2085.0, 2170.0], dtype=torch.float64)
    blocks = {"heights": [4.0, 8.0, 4.0], "visibilities": [1.5, 0.53],
              "freq_l0": f0, "freq_l1": f0 + 42.5, "freq_l2": f0 - 10.2,
              "rot": ROT[name], "widths": [1.0, 1.5, 2.0],
              "noise": [50.0, 0.002, 4.0, 10.0, 0.0004, 2.0, -1.0, -1.0,
                        2.0, 0.2],
              "inclination": [math.radians(55)], "trunc": [0.0]}
    p = torch.zeros(layout.ndim, dtype=torch.float64)
    for block, v in blocks.items():
        o = layout.offset(block)
        p[o:o + layout.size(block)] = torch.as_tensor(v, dtype=torch.float64)
    jitter = 1e-3 * torch.randn((k, layout.ndim), dtype=torch.float64,
                                generator=torch.Generator().manual_seed(0))
    nu = torch.linspace(1900.0, 2300.0, 800, dtype=torch.float64)
    return fn, nu, p + jitter


def _forward_backward(name):
    fn, nu, p = _walkers(name)
    p.requires_grad_(True)
    fn(p, nu).sum().backward()
    return p.grad


def test_one_forward_and_backward_opens_alm_spans(tmp_path):
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            metrics.tracing():
        grad = _forward_backward("model_MS_Global_ajAlm_HarveyLike")
    moved = counters_since(before)
    assert moved["alm_tables"] == {"alm": 1}
    assert torch.isfinite(grad).all()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    alm = [e for e in events if e.get("ph") == "X"
           and e.get("name") == metrics.SPAN_PREFIX + "alm"]
    # the table once, then the shifts of l = 1 and l = 2
    assert len(alm) == 3
    assert all(e["cat"] == "user_annotation" for e in alm)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and any(a["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= a["ts"] + a["dur"] for a in alm)]
    assert ops, "no operation ran inside the alm spans"


def test_the_alm_span_is_the_shared_noop_with_tracing_off():
    assert span("alm") is metrics._NOOP
    with metrics.tracing():
        s = span("alm")
        assert s is not metrics._NOOP and s.name == "alm"
    assert span("alm") is metrics._NOOP


@pytest.mark.parametrize("name, tables",
                         [("model_MS_Global_ajAlm_HarveyLike", 1),
                          ("model_MS_Global_a1etaa3_HarveyLike", 0)])
def test_alm_tables_counts_the_filter_evaluations(name, tables):
    """Counted with tracing off as well: a host integer, bumped once a
    forward of the ajAlm assembly and never by another law."""
    before = counters()
    _forward_backward(name)
    assert counters_since(before)["alm_tables"] == (
        {"alm": tables} if tables else {})
    before = counters()
    t = torch.tensor([0.5, 0.6])
    alm_table(t, 0.2 * t)
    alm_table(t, 0.2 * t, kind="gauss")
    assert counters_since(before)["alm_tables"] == {"alm": 2}
