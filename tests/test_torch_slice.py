"""The PyTorch port's main path end to end on the CPU: `run` through the
port's CLI at a tiny size, its outputs read by the reference package's
reader, and the port importing and running with JAX and tamcmc_tpu refused.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tamcmc_tpu.io.outputs import read_bin_samples
from tamcmc_tpu.sampler.driver import resolve_emit_plan as j_resolve_emit_plan
from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.sampler.driver import PhasePlan, run_phases
from tamcmc_tpu_torch.sampler.driver import \
    resolve_emit_plan as t_resolve_emit_plan
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--demo", "ms_global", "--device", "cpu", "--n-orders", "2",
        "--ngrid", "2000", "--temps", "2", "--chains", "4", "--burnin", "30",
        "--learning", "30", "--acquire", "30", "--thin", "5"]
DF = 16            # free parameters of the 2-order demo
SUBGIANT_TINY = ["--demo", "subgiant_mixed", "--device", "cpu", "--n-orders",
                 "2", "--ngrid", "2000", "--temps", "2", "--chains", "4",
                 "--burnin", "10", "--learning", "10", "--acquire", "10",
                 "--thin", "5"]


def test_run_outputs_read_by_reference(tmp_path):
    res = cli.main(["run", *TINY, "--outdir", str(tmp_path)])
    assert set(res["phases"]) == {"B", "L", "A"}
    np.testing.assert_allclose(np.load(tmp_path / "betas.npy"),
                               [1.0, 1.0 / 1.5], rtol=1e-6)
    for phase in ("B", "L", "A"):
        flat, names = read_bin_samples(str(tmp_path), phase)
        chains, _ = read_bin_samples(str(tmp_path), phase, with_chains=True)
        assert flat.shape == (6 * 4, DF) and chains.shape == (6, 4, DF)
        assert len(names) == DF and names[0] == "H_0"
        assert np.all(np.isfinite(flat))
        z = np.load(tmp_path / f"{phase}_chains.npz")
        assert z["logL"].shape == (6, 2, 4) and z["cov_diag0"].shape == (6, DF)
        assert np.all(np.isfinite(z["logL"])) and np.all(np.isfinite(z["logP"]))
        assert 0.0 < res["phases"][phase]["cold_acceptance"] < 1.0


@pytest.mark.parametrize("n_steps,thin,chunk", [(200, 5, 200), (30, 5, 4),
                                                (7, 10, 200), (100, 1, 30)])
def test_resolve_emit_plan_matches_jax(n_steps, thin, chunk):
    assert t_resolve_emit_plan(n_steps, thin, chunk) == \
        j_resolve_emit_plan(n_steps, thin, chunk)


def test_run_phases_local_runner():
    """The B -> L -> A library runner: per-phase records of the plan's
    shape, adaptation frozen in Acquire, the step clock at the total."""
    problem, hp, _, _ = make_demo("ms_global", seed=1, ngrid=2000, n_orders=2)
    plan = PhasePlan(burnin=20, learning=10, acquire=10, thin=5, chunk=2)
    gen = torch.Generator().manual_seed(1)
    betas = make_beta_ladder(2, hp.lambda_temp)
    state = init_state(problem, hp, 2, 4, gen)
    ended = []
    state, results = run_phases(problem, hp, betas, state, gen, plan,
                                on_phase_end=lambda n, s, o: ended.append(n))
    assert ended == list(results) == ["B", "L", "A"]
    assert state.step == 40
    for name, n_emit in (("B", 4), ("L", 2), ("A", 2)):
        outs = results[name]
        assert outs["theta0"].shape == (n_emit, 4, DF)
        assert outs["logL"].shape == (n_emit, 2, 4)
        assert np.all(np.isfinite(outs["logL"]))
    # swaps every dN_mixing = 10 steps with alternating parity; two rungs
    # form a pair only in the even sweeps (steps 20 and 40)
    np.testing.assert_array_equal(results["A"]["swap_att"][-1], [2.0, 0.0])


def test_cuda_device_without_gpu_fails_loudly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["run", "--demo", "ms_global", "--device", "cuda",
                  "--outdir", str(tmp_path)])


def test_chip_smoke_without_gpu_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


ISOLATED = textwrap.dedent("""
    import importlib, importlib.abc, json, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "flax", "tamcmc_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    torch.set_num_threads(1)
    import tamcmc_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(tamcmc_tpu_torch.__path__,
                                                  "tamcmc_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    from tamcmc_tpu_torch import cli
    for outdir, *args in json.loads(sys.argv[1]):
        cli.main(["run", *args, "--outdir", outdir])
    leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("isolated-ok", len(mods))
""")


def test_port_runs_without_jax_or_reference(tmp_path):
    """Every module imports, and `run` drives configs 3 and 5 (the ARMM
    solver and the dense path included), with jax and tamcmc_tpu refused."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = [[str(tmp_path / "ms_global"), *TINY],
            [str(tmp_path / "subgiant_mixed"), *SUBGIANT_TINY]]
    proc = subprocess.run(
        [sys.executable, "-c", ISOLATED, json.dumps(runs)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "isolated-ok" in proc.stdout
    assert int(proc.stdout.split("isolated-ok")[1]) >= 25
    for outdir, *_ in runs:
        assert (pathlib.Path(outdir) / "A_samples.hdr").exists()
