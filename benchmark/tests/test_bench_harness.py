"""The harness at small sizes on the CPU: a run end to end, its result
line, the faults that have to make `correct` false, the look for JAX, and
a run on the card where there is one."""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.run import forbidden_modules
from benchmark.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 29
CELLS = ["kepler_full.stack8", "subgiant_mixed.stack63",
         "kepler_full.f64.c512"]


def _run(cell, traced=False, **kw):
    return harness.run(cell, SEED, 0.5, traced, "cpu", time.perf_counter(),
                       log=lambda m: None, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct(name):
    out = _run(tiny.small(name))
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] == tiny.SMALL_RUN["check_walkers"]
    assert list(out)[-1] == "checks"
    cell = harness.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_a_traced_run_reports_the_host_side_metrics():
    out = _run(tiny.small("kepler_full.stack8"), traced=True)
    # no device on the CPU: the trace's readers find nothing to read
    assert set(out["metrics"]) == {"problem_build_s", "ess_per_walker_step",
                                   "host_step_ms", "host_syncs_per_step"}
    assert out["device"]["window_s"] > 0
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}


HOST = ("host_step_ms", "host_syncs_per_step")
DEVICE = ("assembly_device_ms", "assembly_idle_ms", "sampler_device_ms")


@pytest.mark.parametrize("name, suffix", [("kepler_full.stack8", ""),
                                          ("subgiant_mixed.stack63",
                                           ".dense")])
def test_a_traced_run_reads_the_programs_spans_and_counters(name, suffix,
                                                           monkeypatch):
    """The span and counter readers of a traced run on the CPU: the host
    figures as numbers, the device figures absent (None: no device
    operation in the trace).  The trace of the whole step comes from a
    pass with the program's tracing off, the spans from a second one."""
    passes = []
    profiled = harness.profiled

    def spy(*args, **kw):
        passes.append(kw.get("on", True))
        return profiled(*args, **kw)
    monkeypatch.setattr(harness, "profiled", spy)
    cell = tiny.small(name)
    names = {m["name"] for m in cell.per_layer}
    assert {n + suffix for n in HOST + DEVICE} <= names
    out = _run(cell, traced=True)
    assert passes == [False, True]
    got = out["metrics"]
    assert got["host_step_ms" + suffix]["value"] > 0
    assert got["host_step_ms" + suffix]["unit"] == "ms/step"
    # nothing synchronises on the CPU
    assert got["host_syncs_per_step" + suffix]["value"] == 0.0
    assert not {n + suffix for n in DEVICE} & set(got)
    assert out["correct"]


def test_an_untraced_run_keeps_no_spans():
    run = harness.Run(None, "f32", 1, 1, 1, 1, 1, 1, 0.0, 0.0, 1.0, 1, [])
    for name in HOST + DEVICE:
        assert harness.read_metric(name, run) is None


@pytest.mark.parametrize("name, chains", [("kepler_full.stack8", 2),
                                          ("subgiant_mixed.stack63", 8),
                                          ("kepler_full.f64.c512", 2)])
def test_the_control_is_not_correct(name, chains):
    """The program in the precision below the configuration's, at the
    cell's grid and component count with one star and 16-64 walkers: a
    gap over its limit makes the check fail."""
    out = _run(tiny.cell(name, stars=1, chains=chains, adapt_steps=0,
                         chunk=1, check_walkers=64, check_block=1),
               control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k != "stuck_share")


def _no_step(problem, hp, betas, state, generator, adapt):
    return state.replace(step=state.step + 1)


def _half_batch(original):
    """The log-posterior of the first half of each rung's walkers; the
    rest get that half's mean."""
    def fn(self, x):
        h = max(x.shape[-2] // 2, 1)
        (lL, lP), (gL, gP) = original(self, x[..., :h, :])

        def fill(v, vec):
            d = v.ndim - (2 if vec else 1)
            rest = v.mean(d, keepdim=True).expand(
                v.shape[:d] + (x.shape[-2] - h,) + v.shape[d + 1:])
            return torch.cat([v, rest], dim=d)
        return ((fill(lL, False), fill(lP, False)),
                (fill(gL, True), fill(gP, True)))
    return fn


def _altered(original):
    """The likelihood's answer altered where it is produced: its value one
    nat up and its gradient 1 % larger."""
    def fn(*a, **k):
        out = original(*a, **k)
        return out + 1.0 + 0.01 * (out - out.detach())
    return fn


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from tamcmc_tpu_torch.sampler import driver, problem
    if fault == "state unchanged":
        monkeypatch.setattr(driver, "raw_step", _no_step)
    elif fault == "half the batch":
        fn = _half_batch(problem.Problem.logparts_and_grad)
        monkeypatch.setattr(problem.Problem, "logparts_and_grad", fn)
        monkeypatch.setattr(problem.Problem, "batched_logparts_and_grad", fn)
    else:
        monkeypatch.setattr(problem, "lorentzian_chi22p",
                            _altered(problem.lorentzian_chi22p))
    out = _run(tiny.small(name))
    assert not out["correct"]


def test_the_look_for_jax_compares_whole_top_level_names():
    assert forbidden_modules(["tamcmc_tpu_torch", "tamcmc_tpu_torch.cli",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "tamcmc_tpu.ops", "flax"]) == \
        ["flax", "jax", "tamcmc_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness; from benchmark.tests import tiny;"
            "from benchmark.run import forbidden_modules;"
            "harness.run(tiny.small('subgiant_mixed.stack63'), 1, 0.2, False,"
            " 'cpu', time.perf_counter(), log=lambda m: None);"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "kepler_full.stack8", "--seed", "3", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_layers_device_ms_add_up_on_the_card(name):
    """The spans' parts, assembly + sampler + unattributed, against the
    whole non-kernel device time of the same traced steps, within 2 %."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    import types
    from benchmark import spans
    from benchmark.tools import span_breakdown
    dev = torch.device("cuda")
    cell = harness.load_cell(name)
    problem, hp, betas, state, gen = span_breakdown.setup(cell, SEED, dev)
    state, whole, sp, moved = harness.profiled(problem, hp, betas, state,
                                               gen, cell.traffic, dev)
    run = types.SimpleNamespace(trace=whole, spans=sp, counters=moved)
    parts = sum(harness.read_metric(n, run) for n in
                ("assembly_device_ms", "sampler_device_ms"))
    parts += spans.layer_metrics(sp, moved["syncs"])["unattributed_device_ms"]
    whole_ms = harness.read_metric("nonkernel_device_ms", run)
    assert parts == pytest.approx(whole_ms, rel=0.02)


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "subgiant_mixed.stack63", "--seed", str(SEED), "--seconds", "5",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
