"""The `ms_global_ajalm` family (`kepler_ajalm`): the float64 reference
against the program's plain torch version on the CPU, the cell's check at
small sizes with its control and two planted faults in the activity
block, the quadrature error of the model's 96-node rule, and the readers
of the block's span and counter."""

import json
import math
import pathlib
import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness, spans, traffic
from benchmark.reference import family
from benchmark.tests import tiny

HERE = pathlib.Path(__file__).resolve().parents[1]
NAME = "kepler_ajalm.stack8"
SEED = 2**31 + 53
D = torch.float64
FAM = family("ms_global_ajalm")


def _config(**over):
    return dict(json.loads((HERE / "configs" / "kepler_ajalm.json")
                           .read_text()), **over)


def _draws(cfg, k, seed):
    """k parameter vectors (k, D) of one star, float64: its truth with
    every free parameter drawn inside its prior (uniform over a uniform
    prior, from a Gaussian prior, and log-uniform within a factor of two
    of the truth under a Jeffreys prior's maximum)."""
    rng = np.random.default_rng(seed)
    truth, rows = FAM.star(cfg, rng)
    p = np.repeat(truth[None], k, axis=0)
    for i, (_, kind, h) in enumerate(rows):
        if kind == "uniform":
            p[:, i] = rng.uniform(h[0], h[1], k)
        elif kind == "gaussian":
            p[:, i] = rng.normal(h[0], h[1], k)
        elif kind == "jeffreys":
            p[:, i] = np.minimum(truth[i] * 2.0 ** rng.uniform(-1, 1, k),
                                 h[1])
    return torch.as_tensor(p), rows


def _program_assemble(cfg):
    from tamcmc_tpu_torch.models import build_model
    fn, layout = build_model(cfg["model"], **FAM.spec_kwargs(cfg))
    assert layout.ndim == sum(s for _, s in FAM.blocks(cfg))
    return fn._assemble


def _rot_index(cfg, name):
    names = [b for b, _ in FAM.blocks(cfg)]
    return sum(s for _, s in FAM.blocks(cfg)[:names.index("rot")]) \
        + FAM.ROT.index(name)


def test_the_assembly_matches_the_program_in_float64():
    """(H, C, W, B) equal to 1e-10 relative.  The centres also allow 1e-7
    of the centrifugal term: the program holds Q_lm as float32 values
    (ops/rotation.py, as the JAX package does), which are within 5.2e-8
    of the exact ratios for l <= 3."""
    cfg = _config(**FAM.SMALL)
    p, _ = _draws(cfg, 32, 3)
    theirs = _program_assemble(cfg)(p)
    ours = FAM.assemble(cfg, p)
    off = p.clone()
    off[:, _rot_index(cfg, "eta_sw")] = 0.0
    centrifugal = (ours[1] - FAM.assemble(cfg, off)[1]).abs()
    assert float(centrifugal.max()) > 1.0        # a1 up to 8 uHz: ~10 uHz
    for name, a, b in zip("HCWB", ours, theirs):
        assert a.shape == b.shape, name
        tol = 1e-10 * b.abs() + (1e-7 * centrifugal if name == "C" else 0)
        assert torch.all((a - b).abs() <= tol), name
    assert torch.equal(ours[4], theirs[4])


def test_the_activity_term_moves_the_centres_by_epsilon_nu_alm():
    """The l > 0 centres less the same law with epsilon 0 are epsilon
    nu_nl A_l|m|: the activity term, not a rounding, is what was
    compared."""
    cfg = _config(**FAM.SMALL)
    p, _ = _draws(cfg, 4, 5)
    off = p.clone()
    off[:, _rot_index(cfg, "epsilon")] = 0.0
    shift = FAM.assemble(cfg, p)[1] - FAM.assemble(cfg, off)[1]
    n = cfg["n_orders"]
    assert torch.all(shift[:, :n] == 0)
    assert float(shift[:, n:].abs().max()) > 0.1


def _program_ranges(fn, n_comp):
    """Each component's bin range (lo, hi) in the program's segment plan."""
    lo, hi = np.full(n_comp, np.iinfo(np.int64).max), np.zeros(n_comp, int)
    for idx, a, b in fn._window_groups:
        for k in idx:
            lo[k], hi[k] = min(lo[k], a), max(hi[k], b)
    return lo, hi


@pytest.mark.parametrize("eta_sw", [0.0, 1.0])
def test_log_parts_and_grad_match_the_program(eta_sw, tmp_path):
    """The reference's log-posterior and its gradient against the
    program's plain torch versions in float64, 16 walkers drawn inside the
    priors at the small grid, both summing each component over the
    program's window ranges (the next test holds the reference's own):
    equal to 1e-9 relative.  With the centrifugal term on, the gradient is
    held to 1e-6 of its largest entry: the program's float32 Q_lm (5.2e-8
    of the term, ~1e-8 uHz at a1 1.2 uHz) moves the epsilon gradient, the
    largest, by 1e-7 of itself; with the term off they agree to 1e-14."""
    cfg = _config(**FAM.SMALL)
    stars = traffic.make_stars(cfg, 1, 7, 0, "cpu")
    stars.p0[:, _rot_index(cfg, "eta_sw")] = eta_sw
    paths = traffic.write_problems(cfg, stars, 2, 2, tmp_path)
    problem = harness._build(paths, "f64", torch.device("cpu"))[0]
    assert problem.model_meta["name"] == cfg["model"]
    target = traffic.reference_target(cfg, stars, "cpu")
    lo, hi = _program_ranges(problem.model_fn, FAM.n_components(cfg))
    target.comp_lo, target.comp_hi = torch.as_tensor(lo), torch.as_tensor(hi)
    p, _ = _draws(cfg, 16, 11)
    p[:, _rot_index(cfg, "a1")] = cfg["rot"]["a1"]
    x = p[:, torch.as_tensor(stars.free)]
    (pl, pp), (pgl, pgp) = problem.logparts_and_grad(x)
    (rl, rp), (rgl, rgp) = target.log_parts_and_grad(
        torch.zeros(16, dtype=int), x)
    assert torch.allclose(pl, rl, rtol=1e-9, atol=0)
    assert torch.allclose(pp, rp, rtol=1e-9, atol=0)
    tol = 1e-6 if eta_sw else 1e-9
    for a, b in ((pgl, rgl), (pgp, rgp)):
        scale = b.abs().amax(-1, keepdim=True)
        assert float(((a - b).abs() / scale).max()) < tol


def test_the_window_ranges_match_the_program_to_a_bin(tmp_path):
    """The reference's window ranges (its float64 start-point centres,
    rounded to float32) against the program's segment plan (centres
    assembled in float32) at the configuration's grid, two stars: a bound
    may fall in the neighbouring bin where the two centres round apart
    (the activity term's float32 quadrature), never further."""
    cfg = _config()
    stars = traffic.make_stars(cfg, 2, 11, 0, "cpu")
    paths = traffic.write_problems(cfg, stars, 2, 2, tmp_path)
    problem = harness._build(paths, "f32", torch.device("cpu"))[0]
    target = traffic.reference_target(cfg, stars, "cpu")
    lo, hi = _program_ranges(problem.model_fn, FAM.n_components(cfg))
    for ours, theirs in ((target.comp_lo.numpy(), lo),
                         (target.comp_hi.numpy(), hi)):
        assert np.abs(ours - theirs).max() <= 1
        assert (ours != theirs).mean() < 0.1


def _run(cell, traced=False, **kw):
    return harness.run(cell, SEED, 0.5, traced, "cpu", time.perf_counter(),
                       log=lambda m: None, **kw)


def test_a_small_run_is_correct_and_reads_one_table_a_step():
    out = _run(tiny.small(NAME), traced=True)
    assert out["correct"] and out["failed"] == 0
    got = out["metrics"]
    # one filter evaluation a MALA step; no device op on the CPU
    assert got["alm_tables_per_step"] == {"value": 1.0,
                                          "unit": "tables/step"}
    assert "alm_device_ms" not in got and "alm_launches_per_step" not in got
    out = _run(tiny.small(NAME))
    assert out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.load_cell(NAME).end_to_end}
    assert {"walker_steps_per_s", "setup_s"} <= set(out["metrics"])


def test_the_control_is_not_correct():
    """The program in bf16 at the cell's grid and component count, one
    star and 20 walkers."""
    out = _run(tiny.cell(NAME, stars=1, chains=2, adapt_steps=0, chunk=1,
                         check_walkers=64, check_block=1), control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k != "stuck_share")


def _zero_shifts(real):
    def fn(l, nu_nl, *a, **kw):
        return torch.zeros_like(real(l, nu_nl, *a, **kw))
    return fn


def _swapped(real):
    def fn(theta0, delta, *a, **kw):
        return real(delta, theta0, *a, **kw)
    return fn


@pytest.mark.parametrize("fault", ["activity term left out",
                                   "theta0 and delta swapped"])
def test_a_fault_in_the_activity_block_is_not_correct(fault, monkeypatch):
    from tamcmc_tpu_torch.models import common
    if fault == "activity term left out":
        monkeypatch.setattr(common, "alm_shifts",
                            _zero_shifts(common.alm_shifts))
    else:
        monkeypatch.setattr(common, "alm_table", _swapped(common.alm_table))
    out = _run(tiny.small(NAME))
    assert not out["correct"]


def test_the_quadrature_error_of_the_96_node_rule():
    """A_lm of every (l, |m|), l = 1..3, by the model's 96 nodes against
    1,024, at the configuration's truth and at 200 prior draws of (theta0,
    delta).  Under 1e-3 at the truth (2.0e-4); the largest over the draws
    is 3.1e-3, a band near the equator, where the two hemispheres' gates
    overlap under the cap at 1 (PERF.md section 4 gives the shift it
    makes)."""
    cfg = _config()
    r, pr = cfg["rot"], cfg["priors"]
    deg = math.pi / 180
    rng = np.random.default_rng(200)
    theta0 = np.concatenate([[r["theta0_deg"]], rng.uniform(
        *pr["theta0_deg"], 200)]) * deg
    delta = np.concatenate([[r["delta_deg"]], rng.uniform(
        *pr["delta_deg"], 200)]) * deg
    t0, dl = torch.as_tensor(theta0), torch.as_tensor(delta)
    gap = torch.cat([(FAM.alm(l, t0, dl) - FAM.alm(l, t0, dl, n_nodes=1024))
                     .abs() for l in (1, 2, 3)], -1)        # (201, 9)
    assert float(gap[0].max()) < 1e-3
    assert float(gap[1:].max()) < 1e-2


def test_the_legendre_recursion_against_closed_forms():
    x = np.linspace(-1, 1, 7)
    s2 = 1 - x * x
    assert np.all(FAM.legendre_sq(0, 0, x) == 1.0)
    assert np.allclose(FAM.legendre_sq(1, 1, x), 0.5 * s2)
    assert np.allclose(FAM.legendre_sq(2, 0, x), 0.25 * (3 * x**2 - 1)**2)
    assert np.allclose(FAM.legendre_sq(3, 2, x),
                       (15 * x * s2)**2 / 120)
    assert np.allclose(FAM.legendre_sq(3, 3, x), (15 * s2**1.5)**2 / 720)


def _spans(names, ops=()):
    return spans.Spans(sorted(ops), sorted((i, i + 1, n)
                                           for i, n in enumerate(names)),
                       [], 0, 0.0, 2)


@pytest.mark.parametrize("metric", ["alm_device_ms", "alm_launches_per_step",
                                    "alm_tables_per_step"])
def test_the_readers_read_nothing_of_a_program_without_the_block(metric):
    """None without spans, without an `alm` span or counter (a program
    that has neither, as before this configuration), or without device
    operations for the device readers."""
    op = (0.0, 1000.0, "k", "model.assemble")
    for sp, counters in ((None, None), (_spans(["step"], [op]),
                                        {"syncs": {}, "steps": 2})):
        run = types.SimpleNamespace(spans=sp, counters=counters)
        assert harness.read_metric(metric, run) is None


def test_the_readers_of_the_block():
    ops = [(0.0, 1000.0, "a", "alm"), (500.0, 1500.0, "b", "alm"),
           (2000.0, 2600.0, "c", "model.assemble")]
    run = types.SimpleNamespace(spans=_spans(["step", "alm", "alm"], ops),
                                counters={"syncs": {}, "alm_tables": {"alm": 2}})
    assert harness.read_metric("alm_device_ms", run) == pytest.approx(0.75)
    assert harness.read_metric("alm_launches_per_step", run) == 1.0
    assert harness.read_metric("alm_tables_per_step", run) == 1.0
