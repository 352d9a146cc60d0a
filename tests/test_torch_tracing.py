"""The port's tracing (`tamcmc_tpu_torch.utils.metrics`): spans on the
profiler's timeline, the host counters, and the sync counter's warnings
hook.  CPU, tiny demos; the sync count of a chunk's records runs only where
there is a CUDA card (`-m card`).  No JAX: the card's machine runs this
file with `python -m pytest --noconftest -m card`."""

import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.parallel.mesh import SamplerMesh
from tamcmc_tpu_torch.parallel.sharded import RECORD_KEYS
from tamcmc_tpu_torch.sampler.driver import run_phase
from tamcmc_tpu_torch.sampler.ensemble import (init_ensemble_state,
                                               stacked_problem)
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
from tamcmc_tpu_torch.utils import metrics
from tamcmc_tpu_torch.utils.metrics import (COUNTERS, counters,
                                            counters_since, span, tracing)

T, C = 2, 4


def _hp(name):
    """The demo's hyperparameters with a swap sweep every other step."""
    hp = make_demo(name, ngrid=2000, n_orders=2)[1]
    return dataclasses.replace(hp, dN_mixing=2)


def _fit(name, device="cpu", seed=0):
    problem = make_demo(name, seed=seed, ngrid=2000, n_orders=2,
                        device=device)[0]
    hp = _hp(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_state(problem, hp, T, C, gen)
    return problem, hp, make_beta_ladder(T, hp.lambda_temp, device=device), \
        state, gen


def _stacked_fit():
    problems = [make_demo("ms_global", seed=s, ngrid=2000, n_orders=2)[0]
                for s in (0, 1)]
    hp = _hp("ms_global")
    gen = torch.Generator().manual_seed(0)
    state = init_ensemble_state(problems, hp, T, C, gen)
    return stacked_problem(problems), hp, make_beta_ladder(
        T, hp.lambda_temp), state, gen


def _spans(tmp_path, fit, on=True, n=4, thin=2, **kw):
    """The program's spans [(start, end, name)] of a profiled phase of n
    steps, sorted by start then outermost first."""
    problem, hp, betas, state, gen = fit
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing(on):
        run_phase(problem, hp, betas, state, gen, n, adapt=False, thin=thin,
                  chunk=n // thin, **kw)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    out = [(e["ts"], e["ts"] + e["dur"], e["name"][len("tamcmc/"):])
           for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("tamcmc/")]
    assert all(e.get("cat") == "user_annotation" for e in events
               if e.get("name", "").startswith("tamcmc/"))
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _chain(spans, leaf):
    """The names of the spans around each `leaf` span, innermost first."""
    chains = []
    for a, b, name in spans:
        if name == leaf:
            chains.append([n for a2, b2, n in reversed(spans)
                           if a2 <= a and b <= b2 and n != leaf])
    return chains


def test_span_is_the_shared_noop_with_tracing_off():
    assert span("step") is span("logpost") is metrics._NOOP
    with tracing():
        s = span("step")
        assert s is not metrics._NOOP and s.name == "step"
        with tracing(False):
            assert span("step") is metrics._NOOP
        assert span("step") is not metrics._NOOP
    assert span("step") is metrics._NOOP


def test_a_phase_profiled_with_tracing_off_has_no_program_span(tmp_path):
    assert _spans(tmp_path, _fit("ms_global"), on=False) == []


@pytest.mark.parametrize("name", ["ms_global", "subgiant_mixed"])
def test_tracing_changes_no_number(name):
    """The same seed gives the same state and records bit for bit with
    tracing on and off."""
    out = []
    for on in (False, True):
        problem, hp, betas, state, gen = _fit(name, seed=3)
        with tracing(on):
            state, rec = run_phase(problem, hp, betas, state, gen, 6,
                                   adapt=True, thin=2, chunk=3)
        out.append((state, rec))
    (s0, r0), (s1, r1) = out
    for f in ("theta", "logL", "logP", "gradL", "gradP", "cov", "log_sigma",
              "nswap_acc"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert r0.keys() == r1.keys() == set(RECORD_KEYS)
    for k in r0:
        assert (r0[k] == r1[k]).all(), k


CHAIN = ["model.assemble", "logpost", "step", "chunk"]
STEP = {"mala.propose", "logpost", "model.assemble", "likelihood",
        "logL.grad", "prior", "mala.accept"}


@pytest.mark.parametrize("case", ["ms_global", "subgiant_mixed", "stacked",
                                  "mesh"])
def test_the_span_tree(tmp_path, case):
    """armm.solve in model.assemble in logpost in step in chunk; every
    layer of the step under each step; run_phase's own spans once a chunk or
    a record.  The stacked ensemble and the mesh runner take the same
    spans."""
    fit = (_stacked_fit() if case == "stacked"
           else _fit("ms_global" if case == "mesh" else case))
    kw = {"mesh": SamplerMesh(1, 1, 0, T, C)} if case == "mesh" else {}
    spans = _spans(tmp_path, fit, n=8, thin=2, **kw)
    names = [s[2] for s in spans]
    assert names.count("chunk") == 1 and names.count("step") == 8
    assert names.count("record") == 4 and names.count("collect") == 1
    assert names.count("callbacks") == 1
    assert names.count("swap") == (4 if case != "mesh" else 0)
    for leaf in STEP:
        assert names.count(leaf) == 8, leaf
    for chain in _chain(spans, "model.assemble"):
        assert chain == CHAIN[1:]
    armm = _chain(spans, "armm.solve")
    assert len(armm) == (8 if case == "subgiant_mixed" else 0)
    for chain in armm:
        assert chain == CHAIN
    for leaf in ("record", "collect", "callbacks"):
        assert all(c == ["chunk"] for c in _chain(spans, leaf))
    assert all(c == ["logpost", "step", "chunk"]
               for c in _chain(spans, "logL.grad"))


@pytest.mark.parametrize("n_steps, thin, chunk, steps, chunks",
                         [(12, 2, 3, 12, 2), (10, 2, 3, 12, 2),
                          (5, 5, 1, 5, 1)])
def test_steps_and_chunks_count_the_plan(n_steps, thin, chunk, steps,
                                         chunks):
    problem, hp, betas, state, gen = _fit("ms_global")
    before = counters()
    run_phase(problem, hp, betas, state, gen, n_steps, adapt=False,
              thin=thin, chunk=chunk)
    moved = counters_since(before)
    assert (moved["steps"], moved["chunks"]) == (steps, chunks)
    assert moved["syncs"] == {}          # tracing off: not counted
    assert moved["launches"] == {}       # the plain versions ran


def test_utils_metrics_loads_no_ops_module():
    """The lowest module owns the counters: importing it alone, in a fresh
    interpreter, loads no module of tamcmc_tpu_torch.ops."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, tamcmc_tpu_torch.utils.metrics; print(sorted(m for m"
            " in sys.modules if m.startswith('tamcmc_tpu_torch.ops')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=dict(
        os.environ, PYTHONPATH=str(root)), capture_output=True, text=True,
        timeout=120, check=True).stdout
    assert out.strip() == "[]"


# each op module that counts: its entry of COUNTERS and that entry's keys
COUNTED = {"lorentzian_kernel": ("launches", {
               "fwd", "bwd", "fwd_bf16", "bwd_bf16", "fwd_chi22p",
               "fwd_chi22p_bf16", "fwd_f64", "bwd_f64", "fwd_chi22p_f64"}),
           "armm_kernel": ("armm_launches", {"armm", "armm_bwd"}),
           "alm": ("alm_tables", {"alm"})}


@pytest.mark.parametrize("module", sorted(COUNTED))
def test_the_ops_count_into_COUNTERS(module):
    """An op module adds to utils.metrics.COUNTERS itself and keeps no
    counter dict of its own."""
    mod = importlib.import_module("tamcmc_tpu_torch.ops." + module)
    key, names = COUNTED[module]
    assert mod.COUNTERS is COUNTERS and set(COUNTERS[key]) == names
    assert not {"LAUNCHES", "ARMM_LAUNCHES", "ALM_TABLES"} & set(vars(mod))


def test_one_alm_table_moves_COUNTERS_by_one():
    """One CPU evaluation of the activity filter counts once in
    COUNTERS["alm_tables"], which ops.alm holds no copy of."""
    from tamcmc_tpu_torch.ops import alm
    theta0 = torch.tensor([0.5, 1.0], dtype=torch.float64)
    before = counters()
    alm.alm_table(theta0, 0.2 * theta0)
    assert counters_since(before)["alm_tables"] == {"alm": 1}
    assert not hasattr(alm, "ALM_TABLES")


def test_the_sync_hook_counts_by_the_innermost_span(monkeypatch):
    """A sync warning counts to the innermost open span and is not shown;
    any other warning goes to the hook that was there."""
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **kw: shown.append(str(message)))
    before = counters()
    with tracing():
        with span("collect"):
            for _ in range(2):
                warnings.warn(metrics.SYNC_WARNING + " (from c10)")
            with span("record"):
                warnings.warn(metrics.SYNC_WARNING)
        warnings.warn(metrics.SYNC_WARNING)
        warnings.warn("another warning", RuntimeWarning)
    warnings.warn(metrics.SYNC_WARNING + " off")   # tracing off: shown
    assert counters_since(before)["syncs"] == {
        "collect": 2, "record": 1, metrics.NO_SPAN: 1}
    assert shown == ["another warning", metrics.SYNC_WARNING + " off"]


def test_tracing_restores_the_sync_mode_and_the_filters(monkeypatch):
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, show = list(warnings.filters), warnings.showwarning
    with pytest.raises(KeyError):
        with tracing():
            assert modes[-1] == "warn" and metrics._on
            assert warnings.showwarning is not show
            assert warnings.filters[0][0] == "always"
            raise KeyError("in the traced block")
    assert modes == ["default", "warn", "default"]
    assert warnings.filters == filters and warnings.showwarning is show
    assert not metrics._on


@pytest.mark.card
def test_a_chunk_of_records_syncs_once_a_key_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    problem, hp, betas, state, gen = _fit("ms_global", device="cuda")
    before = counters()
    with tracing():
        run_phase(problem, hp, betas, state, gen, 8, adapt=False, thin=2,
                  chunk=2)
    syncs = counters_since(before)["syncs"]
    assert syncs.get("collect") == 2 * len(RECORD_KEYS) == 20, syncs
