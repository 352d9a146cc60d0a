"""The frozen reference against hand-worked values, and against the
program's plain torch versions where both compute the same thing."""

import ast
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from benchmark import ess, traffic
from benchmark.reference import ms_global, posterior, rgb_asympt, spectrum
from benchmark.reference.priors import log_prior

HERE = pathlib.Path(__file__).resolve().parents[1]
D = torch.float64


def test_lorentzian_by_hand():
    nu = torch.tensor([10.0, 11.0, 12.0], dtype=D)
    one = torch.ones(1, dtype=D)
    # x = 2 (nu - 10) / 2 = 0, 1, 2: H / (1 + x^2) = 2, 1, 0.4
    out = spectrum.lorentzian_sum(nu, 2 * one, 10 * one, 2 * one, 0 * one)
    assert torch.allclose(out, torch.tensor([2.0, 1.0, 0.4], dtype=D))
    # asymmetry b = 0.1 at x = 1: 2 ((1 + 0.1)^2 + 0.01) / 2 = 1.22
    out = spectrum.lorentzian_sum(nu, 2 * one, 10 * one, 2 * one, 0.1 * one)
    assert float(out[1]) == pytest.approx(1.22, rel=1e-14)
    # a component summed on bins [1, 3) only
    out = spectrum.lorentzian_sum(nu, 2 * one, 10 * one, 2 * one, 0 * one,
                                  torch.tensor([1]), torch.tensor([3]))
    assert out.tolist() == pytest.approx([0.0, 1.0, 0.4], rel=1e-14)


def test_background_and_chi22p_by_hand():
    nu = torch.tensor([2.0], dtype=D)
    noise = torch.tensor([4.0, 0.5, 2.0, -1.0, -1.0, 2.0, 1.0, 0.0, 2.0, 0.3],
                         dtype=D)
    # 4 / (1 + (0.5 * 2)^2) = 2; the terms with A or B <= 0 are absent
    assert float(spectrum.harvey_like(nu, noise)[0]) == pytest.approx(2.3)
    spec = torch.tensor([1.0, 8.0], dtype=D)
    model = torch.tensor([2.0, 4.0], dtype=D)
    # -(ln 2 + 1/2 + ln 4 + 8/4)
    assert float(spectrum.chi22p(spec, model)) == pytest.approx(
        -(3 * math.log(2.0) + 2.5), rel=1e-14)


def test_priors_by_hand():
    x = torch.tensor([[1.0, 3.0, 2.0]], dtype=D)
    hyp = torch.tensor([[[0.0, 4.0], [1.0, 2.0], [0.5, 10.0]]], dtype=D)
    lp = log_prior(["uniform", "gaussian", "jeffreys"], hyp, x)
    want = (-math.log(4.0) - 0.5 - math.log(2.0 * math.sqrt(2 * math.pi))
            - math.log(2.5) - math.log(math.log1p(20.0)))
    assert float(lp[0]) == pytest.approx(want, rel=1e-14)
    out = log_prior(["uniform", "gaussian", "jeffreys"], hyp,
                    torch.tensor([[5.0, 3.0, 2.0]], dtype=D))
    assert float(out[0]) == -1e30


def _config(name, **over):
    return dict(json.loads((HERE / "configs" / f"{name}.json").read_text()),
                **over)


def test_armm_matches_the_program_in_float64():
    from tamcmc_tpu_torch.ops.armm import mixed_mode_frequencies
    cfg = _config("subgiant_mixed")
    n_p, n_g = rgb_asympt.pole_counts(cfg)
    g = torch.Generator().manual_seed(3)
    k = 16

    def draw(mid, half):
        return mid + half * (2 * torch.rand(k, generator=g, dtype=D) - 1)
    args = (draw(10.0, 0.05), draw(0.4, 0.05), draw(80.0, 3.0),
            draw(0.0, 0.2), draw(0.15, 0.05))
    zero = torch.zeros(k, dtype=D)
    ours = rgb_asympt.mixed_modes(cfg, *args, zero, zero, zero)
    theirs = mixed_mode_frequencies(*args, cfg["numin"], cfg["numax_win"],
                                    n_p, n_g)
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_window_groups_match_the_program():
    from tamcmc_tpu_torch.ops.lorentzian import make_static_window_groups
    rng = np.random.default_rng(5)
    c = np.sort(rng.uniform(1500, 2900, 224)).astype(np.float32)
    hw = rng.uniform(40, 130, 224).astype(np.float32)
    assert spectrum.window_groups(c, hw, 1520.0, 0.0113, 120000) == \
        list(make_static_window_groups(c, hw, 1520.0, 0.0113, 120000))


def test_window_ranges_match_the_program_at_full_size():
    """The kepler_full configuration's component-bins, the reference's
    window rule against the program's segment plan, on two stars."""
    from tamcmc_tpu_torch.models.ms_global import (MSGlobalSpec,
                                                   build_ms_global)
    cfg = _config("kepler_full")
    rows_p0 = []
    for s in range(2):
        rng = np.random.default_rng(11 + s)
        truth, rows = ms_global.star(cfg, rng)
        rows = [(n, k, [float(np.float32(v)) for v in h]) for n, k, h in rows]
        rows_p0.append(traffic._start(cfg, truth, rows, rng))
    nu = np.linspace(cfg["nu_lo"], cfg["nu_hi"], cfg["n_bins"])
    step = float(np.median(np.diff(nu)))
    lo, hi = posterior.window_ranges(cfg, np.stack(rows_p0), float(nu[0]),
                                     step, cfg["n_bins"])
    hint = (tuple(tuple(float(v) for v in p) for p in rows_p0),
            float(nu[0]), step, cfg["n_bins"], cfg["window_margin"])
    fn, _ = build_ms_global(MSGlobalSpec(n_per_l=(14, 14, 14, 14),
                                         window_hint=hint))
    theirs = sum(len(idx) * (b - a) for idx, a, b in fn._window_groups)
    assert int((hi - lo).sum()) == theirs


@pytest.mark.parametrize("name", ["kepler_full", "subgiant_mixed"])
def test_posterior_matches_the_programs_plain_version(name, tmp_path):
    """The reference's log-posterior and gradient against the program's
    plain torch versions in float64 on the CPU, at a small grid."""
    from tamcmc_tpu_torch import cli
    small = ({"n_orders": 3, "n_bins": 2000, "nu_lo": 1990.0,
              "nu_hi": 2410.0} if name == "kepler_full" else {"n_bins": 900})
    cfg = _config(name, **small)
    stars = traffic.make_stars(cfg, 1, 7, 0, "cpu")
    path, = traffic.write_problems(cfg, stars, 2, 2, tmp_path)
    args = cli._parser().parse_args(["run", "--problem", str(path),
                                     "--outdir", str(tmp_path), "--device",
                                     "cpu", "--precision", "f64"])
    problem, *_ = cli._build_problem(args, torch.device("cpu"))
    problem = problem.astype(D)
    x0 = torch.as_tensor(stars.p0[0, stars.free])
    x = x0 + 1e-3 * torch.randn((3,) + x0.shape, dtype=D,
                                generator=torch.Generator().manual_seed(1))
    (pl, pp), (pgl, pgp) = problem.logparts_and_grad(x)
    target = traffic.reference_target(cfg, stars, "cpu")
    (rl, rp), (rgl, rgp) = target.log_parts_and_grad(torch.zeros(3, dtype=int),
                                                     x)
    assert torch.allclose(pl, rl, rtol=1e-11, atol=1e-8)
    assert torch.allclose(pp, rp, rtol=1e-11, atol=1e-8)
    scale = rgl.abs().max()
    # the closed-form backward and autograd sum in other orders
    assert float((pgl - rgl).abs().max() / scale) < 1e-7
    assert float((pgp - rgp).abs().max()) < 1e-8


def test_ess_is_the_programs():
    from tamcmc_tpu_torch.diagnostics.ess import effective_sample_size
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.standard_normal((300, 16)), axis=0) * 0.1 \
        + rng.standard_normal((300, 16))
    assert ess.effective_sample_size(x) == effective_sample_size(x)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"tamcmc_tpu_torch", "tamcmc_tpu", "jax"}, path


def test_the_benchmark_imports_no_jax():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "tamcmc_tpu"}, path
