"""benchmark/spans.py on a hand-built Chrome trace: the rule that gives
each device operation a layer, the layer numbers, the two breakdowns; the
readers of benchmark/metrics/ unmoved by the program's span events; None
where a trace holds no program span (a program without the tracing
switch); and benchmark/tools/span_breakdown.py end to end on the CPU."""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark import trace as trace_mod
from benchmark.tests import tiny

MAIN, ENGINE, OTHER = 100, 200, 300
STEPS = 2

# (start, end, name) of the program's spans on the sampler's thread (us)
SPANS = [(0, 1000, "chunk"), (10, 400, "step"), (12, 18, "mala.propose"),
         (20, 300, "logpost"), (30, 100, "model.assemble"),
         (40, 80, "armm.solve"), (110, 140, "likelihood"),
         (150, 290, "logL.grad"), (292, 298, "prior"),
         (310, 390, "mala.accept"), (405, 410, "record"),
         (810, 900, "collect")]
# forward ops (start, end, name, sequence number): seq 9 is peeked in
# armm.solve by a comparison and taken by the product in model.assemble
FORWARD = [(44, 45, "aten::gt", 7), (50, 52, "aten::where", 7),
           (78, 79, "aten::gt", 9), (95, 96, "aten::mul", 9)]
# the autograd engine's events on its own thread (seq None: no number)
BACKWARD = [(160, 200, "autograd::engine::evaluate_function: "
             "WhereBackward0", 7), (161, 199, "WhereBackward0", 7),
            (205, 230, "autograd::engine::evaluate_function: "
             "MulBackward0", 9),
            (240, 250, "autograd::engine::evaluate_function: "
             "torch::autograd::AccumulateGrad", None)]
# correlation: (launch thread, start, duration, device start, end, name,
# the layer the rule gives)
ELEMENTWISE = "void at::native::elementwise_kernel<128, 4>(int)"
OPS = {
    1: (MAIN, 15, 5, 20, 30, ELEMENTWISE, "mala.propose"),
    2: (MAIN, 55, 5, 60, 100, "void at::native::where_kernel(int)",
        "armm.solve"),
    3: (MAIN, 96, 3, 100, 110, ELEMENTWISE, "model.assemble"),
    4: (MAIN, 120, 5, 125, 225,
        "void lorentz_fwd_chi22p_kernel<4>(float const*)", spans.KERNELS),
    5: (ENGINE, 170, 5, 230, 250, ELEMENTWISE, "armm.solve"),
    6: (ENGINE, 210, 5, 250, 260, ELEMENTWISE, "model.assemble"),
    7: (ENGINE, 245, 3, 262, 270, ELEMENTWISE, "logL.grad"),
    8: (ENGINE, 260, 5, 280, 380,
        "void lorentz_bwd_kernel<false, false>(float const*)",
        spans.KERNELS),
    9: (MAIN, 320, 80, 390, 400, ELEMENTWISE, "mala.accept"),
    10: (MAIN, 820, 70, 880, 890, "Memcpy DtoH (Device -> Pinned)",
         "collect"),
    11: (OTHER, 950, 2, 960, 970, ELEMENTWISE, "chunk"),
    99: (None, None, None, 975, 980, ELEMENTWISE, spans.UNATTRIBUTED),
}


def _event(cat, name, tid, a, b, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": float(a), "dur": float(b - a), "args": args}


def _events(with_spans=True, late=False):
    ev = [_event("cpu_op", "aten::add", MAIN, 13, 17)]
    if with_spans:
        ev += [_event("user_annotation", "tamcmc/" + n, MAIN, a, b)
               for a, b, n in SPANS]
    for a, b, name, seq in FORWARD:
        ev.append(_event("cpu_op", name, MAIN, a, b,
                         **{"Sequence number": seq, "Fwd thread id": 0}))
    for a, b, name, seq in BACKWARD:
        extra = ({} if seq is None else
                 {"Sequence number": seq, "Fwd thread id": 1})
        ev.append(_event("cpu_op", name, ENGINE, a, b, **extra))
    for corr, (tid, t, dur, a, b, name, _) in OPS.items():
        if tid is not None:
            ev.append(_event("cuda_runtime", "cudaLaunchKernel", tid, t,
                             t + dur, correlation=corr))
        if late and corr == 3:
            a = 90
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append(_event(cat, name, 7, a, b, correlation=corr))
    return {"traceEvents": ev}


def _write(tmp_path, **kw):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_events(**kw)))
    return path


def test_each_device_operation_gets_the_rules_layer(tmp_path):
    sp = spans.read(_write(tmp_path), STEPS)
    want = sorted((v[3], v[4], v[6]) for v in OPS.values())
    assert [(a, b, layer) for a, b, _, layer in sp.ops] == want
    assert sp.late == 0 and sp.steps == STEPS
    assert [s[2] for s in sp.spans] == [s[2] for s in SPANS]


def test_the_breakdowns_by_span(tmp_path):
    sp = spans.read(_write(tmp_path), STEPS)
    dev = sp.device_by_span()
    assert dev[spans.KERNELS] == pytest.approx(200e-6)
    assert dev["armm.solve"] == pytest.approx(60e-6)
    assert dev["model.assemble"] == pytest.approx(20e-6)
    assert sum(dev.values()) == pytest.approx(sum(
        (v[4] - v[3]) * 1e-6 for v in OPS.values()))
    idle = sp.idle_by_span()
    assert idle == pytest.approx({
        "mala.propose": 20e-6, "armm.solve": 35e-6, spans.KERNELS: 25e-6,
        "logL.grad": 2e-6, "mala.accept": 10e-6, "collect": 480e-6,
        "chunk": 70e-6, spans.UNATTRIBUTED: 5e-6, spans.TAIL: 20e-6})
    assert sum(idle.values()) == pytest.approx(1e-6 * (1000 - sp.busy_us))


def test_the_layer_numbers(tmp_path):
    sp = spans.read(_write(tmp_path), STEPS)
    got = spans.layer_metrics(sp, {"collect": 10})
    assert got == pytest.approx({
        # the step span's 390 us less the 80 us launch that waited
        "host_step_ms": (390 - 80) / 1e3 / STEPS,
        "host_syncs_per_step": 10 / STEPS,
        "assembly_device_ms": (40 + 10 + 20 + 10) / 1e3 / STEPS,
        "sampler_device_ms": (10 + 8 + 10 + 10 + 10) / 1e3 / STEPS,
        "assembly_idle_ms": (30 + 5) / 1e3 / STEPS,
        "unattributed_device_ms": 5 / 1e3 / STEPS})
    whole = trace_mod.read_chrome_trace(_write(tmp_path), STEPS, 1e-3)
    nonkernel = trace_mod.union_us(
        [(a, b) for a, b, _, _ in whole.select(
            lambda n: not n.startswith("lorentz_"))]) / 1e3 / STEPS
    assert nonkernel == pytest.approx(got["assembly_device_ms"]
                                      + got["sampler_device_ms"]
                                      + got["unattributed_device_ms"])


def test_a_device_operation_before_its_launch_is_counted(tmp_path):
    sp = spans.read(_write(tmp_path, late=True), STEPS)
    assert (sp.late, sp.lead_us) == (1, 6.0)


def test_no_program_span_gives_none(tmp_path):
    assert spans.read(_write(tmp_path, with_spans=False), STEPS) is None


def _run(trace):
    cell = harness.load_cell("kepler_full.stack8")
    theta0 = [np.random.default_rng(0).normal(size=(40, 8, 128, 3))]
    return harness.Run(cell, "f32", 8, 10, 128, 120000, 224, 1e9, 40.0, 0.5,
                       51.0, 1000, theta0, trace)


def test_the_span_events_move_no_existing_reader(tmp_path):
    runs = []
    for with_spans in (False, True):
        d = tmp_path / str(with_spans)
        d.mkdir()
        runs.append(_run(trace_mod.read_chrome_trace(
            _write(d, with_spans=with_spans), STEPS, 1e-3)))
    plain, traced = runs
    assert plain.trace.ops == traced.trace.ops
    assert plain.trace.launch_host == traced.trace.launch_host
    assert plain.trace.idle_gaps() == traced.trace.idle_gaps()
    assert plain.trace.by_name() == traced.trace.by_name()
    names = sorted(p.stem for p in
                   (pathlib.Path(harness.__file__).parent / "metrics")
                   .glob("*.py"))
    assert len(names) == 28
    for name in names:
        assert harness.read_metric(name, plain) == \
            harness.read_metric(name, traced), name


def test_the_tool_runs_a_small_cell_on_the_cpu():
    from benchmark.tools import span_breakdown
    cell = tiny.small("kepler_full.stack8")
    cell.traffic["adapt_steps"] = 0
    t0 = time.perf_counter()
    lines = span_breakdown.measure(cell, 2**31 + 7, 1, torch.device("cpu"))
    assert time.perf_counter() - t0 < 120
    assert [line["tracing"] for line in lines] == [False, True]
    off, on = lines
    assert off["steps"] == on["steps"] == cell.traffic["trace_steps"]
    assert "host_step_ms" not in off and off["idle_share"] is None
    assert 0 < on["host_step_ms"] <= on["host_ms_per_step"]
    assert on["host_syncs_per_step"] == 0.0 and on["late_ops"] == 0
    assert "assembly_device_ms" not in on     # no device on the CPU
