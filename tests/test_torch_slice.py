"""The PyTorch port's main path end to end on the CPU: `run` through the
port's CLI at a tiny size, its outputs read by the reference package's
reader, and the port importing and running with JAX and tamcmc_tpu refused.

The file-driven path (`make-example`, `validate`, `run --problem`,
`model-eval`) is driven on an exported `ms_global` example of 2,000 bins:
the problem both packages build from that one file has the same window
segments and mask, one MALA step from the same state with injected draws
agrees at the tolerances of tests/test_torch_sampler.py, and `model-eval`
writes the reference's columns within rtol 2e-5.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu import cli as j_cli
from tamcmc_tpu.io.outputs import read_bin_samples
from tamcmc_tpu.sampler.mala import default_init_scales as j_init_scales
from tamcmc_tpu.sampler.mala import mala_step as j_mala_step
from tamcmc_tpu.sampler.state import SamplerState as JState
from tamcmc_tpu.sampler.driver import resolve_emit_plan as j_resolve_emit_plan
from tamcmc_tpu_torch import cli, convert
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.sampler.driver import PhasePlan, run_phases
from tamcmc_tpu_torch.sampler.driver import \
    resolve_emit_plan as t_resolve_emit_plan
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.mala import mala_step as t_mala_step
from tamcmc_tpu_torch.sampler.state import MALAHyper
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
    res = cli.main(["run", *TINY, "--no-report", "--outdir", str(tmp_path)])
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


def test_make_example_runs_on_the_card_unless_asked(tmp_path):
    """make-example generates its spectrum on `--device`, cuda by default
    like every verb that computes; without a card it exits and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["make-example", "--demo", "single_lorentzian",
                  "--outdir", str(tmp_path / "ex")])
    assert not (tmp_path / "ex").exists()


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
    assert {"tamcmc_tpu_torch.io.native",
            "tamcmc_tpu_torch.bench",
            "tamcmc_tpu_torch.validate_bf16",
            "tamcmc_tpu_torch.validate_f64",
            "tamcmc_tpu_torch.golden_flagship",
            "tamcmc_tpu_torch.scale_procs",
            "tamcmc_tpu_torch.ab_ladder",
            "tamcmc_tpu_torch.parallel.mesh",
            "tamcmc_tpu_torch.parallel.distributed",
            "tamcmc_tpu_torch.parallel.sharded",
            "tamcmc_tpu_torch.parallel.shardmap_runner",
            "tamcmc_tpu_torch.sampler.analytic"} <= set(mods), mods
    from tamcmc_tpu_torch.sampler.analytic import std_gaussian
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.state import MALAHyper
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    from tamcmc_tpu_torch.parallel.mesh import SamplerMesh
    g = torch.Generator().manual_seed(0)
    st = init_state(std_gaussian(2), MALAHyper(), 2, 4, g)
    run_phase(std_gaussian(2), MALAHyper(), make_beta_ladder(2, 1.5), st, g,
              10, mesh=SamplerMesh(1, 1, 0, 2, 4))
    from tamcmc_tpu_torch import cli
    for argv in json.loads(sys.argv[1]):
        cli.main(argv)
    leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    # the records went through the port's own recordio, not native/'s
    maps = open("/proc/self/maps").read()
    assert "build/tamcmc_tpu_torch/recordio-" in maps
    assert "librecordio" not in maps
    print("isolated-ok", len(mods))
""")


def test_port_runs_without_jax_or_reference(tmp_path):
    """Every module imports, `run` drives configs 3 and 5 (the ARMM solver
    and the dense path included), the file-driven path runs from
    `make-example` to `model-eval` (TOML and .model, an ajAlm file with
    window segments, an ajfit table), a fit with `--ckpt-every` stops after
    Learning and is resumed through its checkpoint, the adaptive ladder
    runs, a bf16 fit runs, a mesh fit runs in this process (1x1) and over
    two processes (2x1), the analytic target runs through the mesh runner,
    `batch` runs a TOML table serially and stacked and a .cfg table with
    its master and errors files, and `export`, `stats`, `compare` and
    `evidence` read the results, with jax and tamcmc_tpu refused."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ex, aj = tmp_path / "example", tmp_path / "ajfit"
    few = ["--device", "cpu", "--temps", "2", "--chains", "4", "--burnin",
           "10", "--learning", "10", "--acquire", "10", "--thin", "5",
           "--no-report"]
    runs = {"ms_global": ["--demo", *TINY[1:], "--no-report"],
            "subgiant_mixed": ["--demo", *SUBGIANT_TINY[1:], "--no-report"],
            "toml": ["--problem", str(ex / "problem.toml"), *few],
            "model": ["--problem", str(ex / "problem.model"), *few],
            "ajfit": ["--problem", str(aj / "problem.toml"), *few],
            "ladder": ["--demo", *TINY[1:], "--temps", "4", "--chunk", "1",
                       "--adapt-ladder", "--no-report"],
            "bf16": ["--demo", *TINY[1:], "--precision", "bf16",
                     "--no-report"],
            "mesh1x1": ["--demo", *TINY[1:], "--mesh", "1x1",
                        "--no-report"],
            "mesh2x1": ["--demo", *TINY[1:], "--mesh", "2x1",
                        "--no-report"]}
    table = tmp_path / "batch" / "presets.toml"
    table.parent.mkdir()
    table.write_text("".join(
        f'[[star]]\ndemo = "single_lorentzian"\nseed = {seed}\n'
        f'outdir = "s{seed}"\ntemps = 2\nchains = 4\nburnin = 10\n'
        f'learning = 10\nacquire = 10\nthin = 5\n\n' for seed in (0, 1)))
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "presets.cfg").write_text(
        f"a {ex / 'problem.toml'} 10 10 10 BLA a temps=2 chains=4 thin=5\n")
    (cfg / "default.cfg").write_text("[MALA]\nlambda_temp= 1.3\n")
    (cfg / "errors.cfg").write_text("default_rel 0.02\n")
    long_fit = ["run", "--demo", *TINY[1:], "--chunk", "2", "--ckpt-every",
                "1", "--no-report", "--outdir", str(tmp_path / "long")]
    fit = str(tmp_path / "long")
    argvs = [["make-example", "--device", "cpu",
              "--demo", "ms_global", "--ngrid", "2000",
              "--outdir", str(ex), "--model-format"],
             ["make-example", "--device", "cpu",
              "--demo", "ajfit", "--outdir", str(aj),
              "--npz"],
             ["validate", str(ex / "problem.toml"), str(ex / "problem.model"),
              str(aj / "problem.toml")],
             *(["run", *args, "--outdir", str(tmp_path / name)]
               for name, args in runs.items()),
             [*long_fit, "--acquire", "0"],       # stops after Learning
             [*long_fit, "--resume"],             # Acquire from restore.npz
             ["export", "--outdir", fit, "--thin", "2", "--out",
              str(tmp_path / "export.txt")],
             ["stats", "--outdir", fit, "--json",
              str(tmp_path / "stats.json")],
             ["compare", fit, str(tmp_path / "export.txt")],
             ["evidence", "--outdir", fit, "--json",
              str(tmp_path / "evidence.json")],
             ["model-eval", "--problem", str(ex / "problem.toml"), "--device",
              "cpu", "--out", str(tmp_path / "model_eval.txt")],
             ["list-models"],
             ["batch", "--presets", str(table), "--device", "cpu",
              "--no-report"],
             ["batch", "--presets", str(table), "--device", "cpu",
              "--stacked", "--ckpt-every", "1"],
             ["batch", "--presets", str(cfg / "presets.cfg"), "--config",
              str(cfg / "default.cfg"), "--errors", str(cfg / "errors.cfg"),
              "--device", "cpu", "--no-report"]]
    proc = subprocess.run(
        [sys.executable, "-c", ISOLATED, json.dumps(argvs)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "isolated-ok" in proc.stdout
    assert int(proc.stdout.split("isolated-ok")[1]) >= 55
    for name in runs:
        if name != "mesh2x1":
            assert (tmp_path / name / "A_samples.hdr").exists(), name
    for k in (0, 1):
        assert (tmp_path / "mesh2x1" / f"A_samples.host{k}.hdr").exists()
    assert not (tmp_path / "mesh2x1" / "A_samples.hdr").exists()
    for star in ("batch/s0", "batch/s1", "cfg/a"):
        assert (tmp_path / star / "A_samples.hdr").exists()
        assert (tmp_path / star / "summary.json").exists()
    assert (tmp_path / "batch" / "stacked_restore.npz").exists()
    assert "stacked ensemble: 2 stars" in proc.stdout
    assert np.loadtxt(tmp_path / "model_eval.txt").shape == (2000, 3)
    assert "model_MS_local_Hnlm\n" in proc.stdout
    # the resumed fit: Acquire came from the checkpoint Learning left
    assert "resumed from" in proc.stdout and "after phase L" in proc.stdout
    assert (tmp_path / "long" / "A_samples.hdr").exists()
    assert np.loadtxt(tmp_path / "export.txt").shape == (3 * 4, DF)
    assert len(json.loads((tmp_path / "stats.json").read_text())) == DF
    assert "--> CONSISTENT" in proc.stdout
    assert np.isfinite(json.loads(
        (tmp_path / "evidence.json").read_text())["logZ"])
    betas = np.load(tmp_path / "ladder" / "betas.npy")
    assert betas[0] == 1.0 and np.all(np.diff(betas) < 0)
    assert not np.allclose(betas, 1.5 ** -np.arange(4.0))


# ---------------------------------------------------------------------------
# the file-driven path against the reference on one exported example
# ---------------------------------------------------------------------------

def _args(problem, **kw):
    """The attributes both packages' `_build_problem` read."""
    base = dict(demo=None, problem=problem and str(problem), seed=0, temps=None,
                chains=None, burnin=None, learning=None, acquire=None,
                thin=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """`make-example --demo ms_global --ngrid 2000` by the port, plus the
    same file with auto_window, and with a freq_range."""
    out = tmp_path_factory.mktemp("example")
    cli.main(["make-example", "--device", "cpu",
              "--demo", "ms_global", "--ngrid", "2000",
              "--outdir", str(out), "--model-format"])
    text = (out / "problem.toml").read_text()
    (out / "window.toml").write_text(text.replace(
        "[problem]", "[problem]\nauto_window = true", 1))
    (out / "range.toml").write_text(text.replace(
        "[problem]", "[problem]\nfreq_range = [2300.0, 2700.0]", 1))
    return out


def test_example_files_are_what_the_reference_writes(example, tmp_path):
    """Same verb, same demo: the reference's problem.toml holds the same
    model, spec, priors, start point, sampler and phases (its spectrum is
    its own noise draw)."""
    from tamcmc_tpu.io.problemfile import read_problem_file as j_read
    from tamcmc_tpu_torch.io.problemfile import read_problem_file
    j_cli.main(["make-example", "--demo", "ms_global", "--ngrid", "2000",
                "--outdir", str(tmp_path), "--model-format"])
    got = read_problem_file(str(example / "problem.toml"))
    want = j_read(str(tmp_path / "problem.toml"))
    for k in ("model", "likelihood", "data", "freq_range", "spec_kwargs",
              "sampler", "phases", "auto_window", "family_constraints"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["params0"], want["params0"])
    np.testing.assert_array_equal(got["priors"].kinds, want["priors"].kinds)
    np.testing.assert_array_equal(got["priors"].hypers,
                                  want["priors"].hypers)
    assert (example / "problem.model").read_text() == \
        (tmp_path / "problem.model").read_text()
    np.testing.assert_array_equal(np.loadtxt(example / "truth.txt"),
                                  np.loadtxt(tmp_path / "truth.txt"))
    # the grids: a float64 linspace here (it reads back to the float32 grid
    # the demo fits), a float32 linspace there, an ulp apart at some bins
    np.testing.assert_allclose(
        np.loadtxt(example / "spectrum.data")[:, 0].astype(np.float32),
        np.loadtxt(tmp_path / "spectrum.data")[:, 0], rtol=1.2e-7)


@pytest.mark.parametrize("name", ["problem.toml", "window.toml",
                                  "problem.model"])
def test_run_problem_file_on_cpu(example, name, tmp_path):
    res = cli.main(["run", "--problem", str(example / name), "--device",
                    "cpu", "--chains", "4", "--burnin", "20", "--learning",
                    "15", "--acquire", "15", "--thin", "5", "--no-report",
                    "--outdir", str(tmp_path)])
    # temperatures from the file's [phases] (a .model file has none: 6)
    assert (res["n_temps"], res["n_chains"]) == (6, 4)
    assert [res["phases"][p]["steps"] for p in "BLA"] == [20, 15, 15]
    np.testing.assert_allclose(np.load(tmp_path / "betas.npy"),
                               (1.5 if name.endswith("toml") else 1.4)
                               ** -np.arange(6.0), rtol=1e-6)
    flat, names = read_bin_samples(str(tmp_path), "A")
    assert flat.shape == (3 * 4, 36) and names[0] == "H_0"
    assert np.all(np.isfinite(flat))
    z = np.load(tmp_path / "A_chains.npz")
    assert np.all(np.isfinite(z["logL"])) and np.all(np.isfinite(z["logP"]))


def test_file_problem_matches_reference(example):
    """Both packages build the same problem from one file: layout, free
    names, window segments from auto_window, and the freq_range mask."""
    for name in ("problem.toml", "window.toml", "range.toml"):
        jp, jhp, jplan, jmeta = j_cli._build_problem(_args(example / name))
        tp, thp, tplan, tmeta = cli._build_problem(_args(example / name),
                                                   torch.device("cpu"))
        assert tp.free_names == jp.free_names
        assert (tp.layout.names, tp.layout.sizes) == \
            (jp.layout.names, jp.layout.sizes)
        np.testing.assert_array_equal(tp.params0.numpy(),
                                      np.asarray(jp.params0))
        np.testing.assert_array_equal(tp.nu.numpy(), np.asarray(jp.nu))
        np.testing.assert_array_equal(tp.spec.numpy(), np.asarray(jp.spec))
        assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
        assert tmeta == jmeta
        groups = getattr(jp.model_fn, "_window_groups", None)
        assert getattr(tp.model_fn, "_window_groups", None) == groups
        assert (groups is not None) == (name == "window.toml")
        if name == "range.toml":
            np.testing.assert_array_equal(tp.mask.numpy(),
                                          np.asarray(jp.mask))
            assert 0 < tp.mask.sum() < tp.mask.numel()
            assert tp._pieces_hook is None
        else:
            assert tp.mask is None and jp.mask is None
        x = np.asarray(jp.extract(jp.params0))[None, None].repeat(2, 1)
        x[0, 1] *= 1.0 + 1e-4              # (T, C, Df) = (1, 2, Df)
        jl, jP = jax.jit(jp.batched_log_parts)(jnp.asarray(x))
        tl, tP = tp.batched_log_parts(torch.as_tensor(x))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5)


def test_mala_step_on_file_problem_matches_reference(example):
    """One adaptive step of each package on the problem it built from the
    file (window segments on), same state, same injected draws; the
    tolerances of tests/test_torch_sampler.py."""
    T, C = 2, 18                       # 2 C >= Df = 36: ensemble covariance
    jp, jhp, _, _ = j_cli._build_problem(_args(example / "window.toml"))
    tp, thp, _, _ = cli._build_problem(_args(example / "window.toml"),
                                       torch.device("cpu"))
    Df = jp.ndim_free
    rng = np.random.default_rng(7)
    u_scale = np.asarray(j_init_scales(jp), np.float32)
    u_center = np.asarray(jp.extract(jp.params0))
    theta = rng.normal(0.0, 0.5, (T, C, Df)).astype(np.float32)
    (logL, logP), (gL, gP) = jax.jit(jp.batched_logparts_and_grad)(
        jnp.asarray(u_center + u_scale * theta))
    a = rng.normal(size=(T, C, Df, Df)) / np.sqrt(Df)
    cov = (np.eye(Df) + a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
    arrays = dict(
        theta=theta, logL=np.asarray(logL), logP=np.asarray(logP),
        gradL=np.asarray(gL) * u_scale, gradP=np.asarray(gP) * u_scale,
        mu=rng.normal(0.0, 0.1, (T, C, Df)).astype(np.float32),
        cov=cov, chol=chol,
        ichol=np.linalg.inv(chol.astype(np.float64)).astype(np.float32),
        log_sigma=rng.normal(-0.6, 0.2, (T, C)).astype(np.float32),
        step=np.asarray(9, np.int32),
        naccept=np.zeros(T, np.float32), nprop=np.asarray(9.0, np.float32),
        acc_rate=rng.uniform(0.3, 0.7, (T, C)).astype(np.float32),
        nswap_att=np.zeros(T, np.float32), nswap_acc=np.zeros(T, np.float32),
        scales0=np.ones(Df, np.float32), u_center=u_center, u_scale=u_scale)
    xi = rng.standard_normal(theta.shape).astype(np.float32)
    u = rng.uniform(size=(T, C)).astype(np.float32)
    betas = np.asarray([1.0, 1.0 / 1.5], np.float32)
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    assert isinstance(thp, MALAHyper)

    jn = jax.jit(lambda s, d: j_mala_step(
        jp, jhp, jnp.asarray(betas), s, jax.random.PRNGKey(0), draws=d))(
        JState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        (jnp.asarray(xi), jnp.asarray(u)))
    tn = t_mala_step(tp, thp, torch.as_tensor(betas),
                     convert.state_from_arrays(arrays),
                     draws=(torch.as_tensor(xi), torch.as_tensor(u)))
    got = convert.state_to_arrays(tn)
    want = {f.name: np.asarray(getattr(jn, f.name))
            for f in dataclasses.fields(jn)}

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    acc_t = np.any(got["theta"] != arrays["theta"], -1)
    acc_j = np.any(want["theta"] != arrays["theta"], -1)
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_j.sum() < acc_j.size
    for f in ("theta", "mu", "cov", "gradL", "gradP", "chol", "ichol"):
        assert rel(got[f], want[f]) <= 1e-5, f
    np.testing.assert_allclose(got["logL"], want["logL"], rtol=1e-5)
    np.testing.assert_allclose(got["naccept"], want["naccept"], rtol=1e-6)


@pytest.mark.parametrize("name", ["problem.toml", "window.toml",
                                  "range.toml"])
def test_model_eval_writes_the_reference_columns(example, name, tmp_path):
    a, b = tmp_path / "t.txt", tmp_path / "j.txt"
    cli.main(["model-eval", "--problem", str(example / name), "--device",
              "cpu", "--out", str(a)])
    j_cli.main(["model-eval", "--problem", str(example / name), "--out",
                str(b)])
    got, want = np.loadtxt(a), np.loadtxt(b)
    assert got.shape == want.shape == (2000, 3)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=2e-5)
    assert a.read_text().splitlines()[0] == b.read_text().splitlines()[0]


def test_model_eval_takes_full_and_free_only_vectors(example, tmp_path):
    tp = cli._build_problem(_args(example / "problem.toml"),
                            torch.device("cpu"))[0]
    full = tp.params0.numpy().astype(np.float64)
    full[tp.free_idx[0]] *= 1.5            # H_0
    np.savetxt(tmp_path / "full.txt", full)
    np.savetxt(tmp_path / "free.txt", full[tp.free_idx])
    tables = []
    for vec in ("full.txt", "free.txt"):
        out = tmp_path / (vec + ".out")
        cli.main(["model-eval", "--problem", str(example / "problem.toml"),
                  "--device", "cpu", "--params", str(tmp_path / vec),
                  "--out", str(out)])
        tables.append(np.loadtxt(out))
    np.testing.assert_array_equal(tables[0], tables[1])
    with torch.no_grad():
        want = tp.model_fn(torch.as_tensor(full, dtype=torch.float32), tp.nu)
    np.testing.assert_array_equal(tables[0][:, 2].astype(np.float32),
                                  want.numpy())


def test_adapt_ladder_is_refused_never_ignored(example, tmp_path):
    """adapt_ladder is never ignored, from a file's [sampler] block or from
    the flag, with a file or a demo (it was refused until the ladder was
    ported): the run adapts the ladder in Burn-in and Learning and leaves
    the final one in betas.npy."""
    text = (example / "problem.toml").read_text()
    path = tmp_path / "ladder.toml"
    path.write_text(text.replace("[sampler]",
                                 "[sampler]\nadapt_ladder = true", 1)
                    .replace('data = "spectrum.data"',
                             f'data = "{example / "spectrum.data"}"'))
    few = ["--device", "cpu", "--temps", "4", "--chains", "4", "--burnin",
           "20", "--learning", "20", "--acquire", "10", "--thin", "5",
           "--chunk", "1", "--no-report"]
    for i, (argv, lam) in enumerate((
            (["--problem", str(path)], 1.5),
            (["--problem", str(example / "problem.toml"), "--adapt-ladder"],
             1.5),
            (["--demo", "single_lorentzian", "--adapt-ladder"], 1.6))):
        out = tmp_path / f"out{i}"
        cli.main(["run", *argv, *few, "--outdir", str(out)])
        betas = np.load(out / "betas.npy")
        assert betas[0] == 1.0 and np.all(np.diff(betas) < 0)
        assert not np.allclose(betas, lam ** -np.arange(4.0))
        events = [json.loads(ln) for ln in
                  (out / "metrics.jsonl").read_text().splitlines()]
        final = [e for e in events if e["event"] == "ladder_final"]
        assert final and final[0]["updates"] == 8     # B and L, not A
    # without the switch the ladder stays geometric
    cli.main(["run", "--problem", str(example / "problem.toml"), *few,
              "--outdir", str(tmp_path / "fixed")])
    np.testing.assert_allclose(np.load(tmp_path / "fixed" / "betas.npy"),
                               1.5 ** -np.arange(4.0), rtol=1e-6)


@pytest.mark.parametrize("verb", ["run", "model-eval"])
@pytest.mark.parametrize("flag", ["--ngrid", "--n-orders"])
def test_demo_size_flags_are_refused_with_a_problem_file(example, tmp_path,
                                                         verb, flag):
    """A file's grid and mode counts are its own: the flags that cut a demo
    to size exit with an error instead of being ignored."""
    out = (["--outdir", str(tmp_path / "o")] if verb == "run"
           else ["--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match=f"{flag}: only with --demo"):
        cli.main([verb, "--problem", str(example / "problem.toml"),
                  "--device", "cpu", flag, "2", *out])
    assert not (tmp_path / "o").exists()


def test_model_eval_has_no_sampler_flags(example, tmp_path):
    """model-eval runs no sampler: the ladder, phase and sampler flags
    belong to `run` alone."""
    with pytest.raises(SystemExit):
        cli.main(["model-eval", "--problem", str(example / "problem.toml"),
                  "--device", "cpu", "--temps", "2",
                  "--out", str(tmp_path / "m.txt")])
    assert not (tmp_path / "m.txt").exists()


def test_file_sampler_block_and_flags(example, tmp_path):
    """[sampler] values reach MALAHyper, the command line overrides them,
    an unknown field is refused loudly, and the flags reach a demo too."""
    args = _args(example / "problem.toml", lambda_temp=1.2, dn_mixing=7,
                 no_drift=True, target_acc=0.3, thin=3, burnin=11)
    _, hp, plan, _ = cli._build_problem(args, torch.device("cpu"))
    jhp, jplan = j_cli._build_problem(args)[1:3]
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert (hp.lambda_temp, hp.dN_mixing, hp.use_drift,
            hp.target_acceptance) == (1.2, 7, False, 0.3)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert (plan.burnin, plan.learning, plan.thin) == (11, 12000, 3)
    demo = _args(None, demo="single_lorentzian", no_drift=True,
                 lambda_temp=2.0)
    assert dataclasses.asdict(cli._build_problem(
        demo, torch.device("cpu"))[1]) == dataclasses.asdict(
        j_cli._build_problem(demo)[1])
    bad = tmp_path / "bad.toml"
    bad.write_text((example / "problem.toml").read_text().replace(
        "[sampler]", "[sampler]\nnot_a_knob = 3", 1).replace(
        'data = "spectrum.data"', f'data = "{example / "spectrum.data"}"'))
    with pytest.raises(SystemExit, match="not_a_knob"):
        cli._build_problem(_args(bad), torch.device("cpu"))
    with pytest.raises(SystemExit, match="--demo NAME or --problem FILE"):
        cli.main(["run", "--device", "cpu", "--outdir", str(tmp_path / "o")])


def test_auto_prior_rows_are_resolved_or_the_run_exits(example, tmp_path):
    """An Auto frequency row is fitted under the reference's derived prior;
    an Auto rotation row stops the run with a clean exit that names it."""
    lines = (example / "problem.model").read_text().splitlines()

    def auto(name):
        out = [f"{name}  {ln.split()[1]}  1  Auto"
               if ln.split()[:1] == [name] else ln for ln in lines]
        return "\n".join(out).replace(
            "!data= spectrum.data", f"!data= {example / 'spectrum.data'}")

    ok = tmp_path / "ok.model"
    ok.write_text(auto("f1_2") + "\n")
    tp = cli._build_problem(_args(ok), torch.device("cpu"))[0]
    jp = j_cli._build_problem(_args(ok))[0]
    np.testing.assert_array_equal(tp.priors.kinds, jp.priors.kinds)
    np.testing.assert_array_equal(tp.priors.hypers, jp.priors.hypers)
    assert "f1_2" in tp.free_names
    bad = tmp_path / "bad.model"
    bad.write_text(auto("a1") + "\n")
    with pytest.raises(SystemExit, match="Auto prior on parameter 'a1'"):
        cli._build_problem(_args(bad), torch.device("cpu"))
