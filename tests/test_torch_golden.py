"""BASELINE config 1's golden posterior through the PyTorch port, in
distribution.

The port's problem is built from the reference demo's arrays (the golden
was made on its data) and sampled with the port's run_phases on the CPU at
the reference test's run length, ladder and walkers.  The comparison is
tests/test_parity_harness.py's: per parameter, z < 4 with ESS-aware
Monte-Carlo errors on both sides, and a std ratio in (1/1.5, 1.5).
"""

import dataclasses
import json
import pathlib

import numpy as np
import torch

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.diagnostics.ess import effective_sample_size
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.sampler.driver import PhasePlan, run_phases
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.state import MALAHyper
from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "config1_posterior.json"


def test_config1_golden_posterior_in_distribution():
    """A config-1 fit through the port's run_phases on the reference demo's
    data (the golden was made on them) matches the checked-in long-run
    moments within ESS-aware Monte-Carlo error, with the reference test's
    run length, ladder, walkers and bounds."""
    g = json.loads(GOLDEN.read_text())
    jp, jhp, _, _ = j_make_demo("single_lorentzian", seed=0)
    problem = convert.problem_from_reference(jp)
    hp = MALAHyper(**dataclasses.asdict(jhp))
    plan = PhasePlan(burnin=500, learning=2000, acquire=4000, thin=4,
                     chunk=500)
    gen = torch.Generator().manual_seed(99)
    betas = make_beta_ladder(3, hp.lambda_temp)
    state = init_state(problem, hp, 3, 8, gen)
    _, results = run_phases(problem, hp, betas, state, gen, plan)
    th = results["A"]["theta0"]                     # (E, C, Df)
    flat = th.reshape(-1, th.shape[-1])
    for i, name in enumerate(g["names"]):
        j = problem.free_names.index(name)
        ess = max(effective_sample_size(th[:, :, j]), 2.0)
        se = np.sqrt(flat[:, j].std(ddof=1) ** 2 / ess
                     + g["std"][i] ** 2 / g["ess"][i])
        z = abs(flat[:, j].mean() - g["mean"][i]) / max(se, 1e-300)
        assert z < 4.0, (name, z, flat[:, j].mean(), g["mean"][i])
        ratio = flat[:, j].std(ddof=1) / max(g["std"][i], 1e-300)
        assert 1 / 1.5 < ratio < 1.5, (name, ratio)
