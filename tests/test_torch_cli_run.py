"""The long fit through the PyTorch port's CLI on the CPU: a child process
killed with SIGKILL mid-Learning and resumed ends byte for byte as the
uninterrupted run (fixed and adaptive ladder), the run's side files
(metrics.jsonl, summary.json, inrun/, the report), and the verbs that read
a run (`export`, `stats`, `compare`, `evidence`) print what tamcmc_tpu.cli
prints on the same directory."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tamcmc_tpu import cli as j_cli
from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.io.outputs import OutputWriter
from tamcmc_tpu_torch.repeat_check import same_outputs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIT = ["run", "--demo", "ms_global", "--device", "cpu", "--n-orders", "2",
       "--ngrid", "2000", "--temps", "4", "--chains", "4", "--burnin", "60",
       "--learning", "300", "--acquire", "100", "--thin", "5", "--chunk", "2",
       "--ckpt-every", "2", "--no-report"]


def _child(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "tamcmc_tpu_torch.cli", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.mark.parametrize("ladder", [[], ["--adapt-ladder"]],
                         ids=["fixed", "adaptive"])
def test_sigkill_mid_learning_and_resume_is_bitwise(tmp_path, ladder):
    clean, run = tmp_path / "clean", tmp_path / "run"
    proc = _child([*FIT, *ladder, "--outdir", str(clean)])
    assert proc.wait(timeout=300) == 0, proc.stdout.read()[-2000:]

    proc = _child([*FIT, *ladder, "--outdir", str(run)])
    deadline = time.time() + 120
    while not (run / "L_chains_partial.npz").exists():
        assert proc.poll() is None and time.time() < deadline, \
            "the child ended before its first Learning checkpoint"
        time.sleep(0.02)
    time.sleep(0.5)                       # a few chunks into Learning
    proc.send_signal(signal.SIGKILL)
    assert proc.wait(timeout=60) == -signal.SIGKILL
    assert not (run / "L_samples.hdr").exists()       # killed inside L
    meta = np.load(run / "restore.npz")
    assert str(meta["phase"]) == "L" and int(meta["meta_in_progress"]) == 1
    emitted = int(meta["meta_emitted"])
    assert 0 < emitted < 60
    if ladder:
        assert int(meta["meta_ladder_updates"]) == 6 + emitted // 2

    proc = _child([*FIT, *ladder, "--outdir", str(run), "--resume"])
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, out[-2000:]
    assert f"mid-phase L ({emitted} records already emitted)" in out
    assert same_outputs(clean, run) == []
    for phase, n in (("B", 12), ("L", 60), ("A", 20)):
        assert (run / f"{phase}_samples.hdr").read_text() == \
            (clean / f"{phase}_samples.hdr").read_text()
        assert f"Nsamples= {n * 4}" in (run / f"{phase}_samples.hdr") \
            .read_text()
    assert not list(run.glob("*partial*")) and not list(run.glob("*.tmp"))
    betas = np.load(run / "betas.npy")
    geometric = 1.5 ** -np.arange(4.0)
    if ladder:
        assert betas[0] == 1.0 and np.all(np.diff(betas) < 0)
        assert not np.allclose(betas, geometric)
        events = [json.loads(ln) for ln in
                  (run / "metrics.jsonl").read_text().splitlines()]
        final = [e for e in events if e["event"] == "ladder_final"]
        assert final[-1]["updates"] == 6 + 30
        np.testing.assert_allclose(final[-1]["betas"], betas, atol=1e-6)
    else:
        np.testing.assert_allclose(betas, geometric, rtol=1e-6)


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """One small finished fit with every side file: in-run reports, debug
    checks, the final report."""
    out = tmp_path_factory.mktemp("fit")
    res = cli.main(["run", "--demo", "single_lorentzian", "--device", "cpu",
                    "--temps", "3", "--chains", "4", "--burnin", "40",
                    "--learning", "120", "--acquire", "400", "--thin", "4",
                    "--chunk", "10", "--report-every", "8", "--debug",
                    "--max-rows", "2", "--outdir", str(out)])
    torch.autograd.set_detect_anomaly(False)
    return out, res


def test_run_leaves_the_reference_side_files(fit, capsys):
    out, res = fit
    assert [res["phases"][p]["steps"] for p in "BLA"] == [40, 120, 400]
    events = [json.loads(ln) for ln in
              (out / "metrics.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds.count("phase_end") == 3
    assert kinds.count("inrun_report") == 1          # 14 chunks, every 8
    start = events[0]
    assert (start["n_temps"], start["n_chains"], start["ndim_free"],
            start["runner"], start["precision"], start["device"]) == \
        (3, 4, 4, "local", "f32", "cpu")
    end = [e for e in events if e["event"] == "phase_end"][-1]
    assert end["phase"] == "A" and end["steps"] == 400
    assert len(end["acceptance"]) == 3 and len(end["swap_rates"]) == 2
    assert len(end["sigma"]) == 3 and end["cold_acceptance"] == \
        end["acceptance"][0]
    assert all(np.isfinite(end["swap_rates"]))
    report = ["param_pdfs.png", "traces.png", "acceptance.png",
              "logL_trace.png", "swap_rates.png", "spectrum_fit.png"]
    for name in report:
        assert (out / name).stat().st_size > 1000, name
        assert (out / "inrun" / name).stat().st_size > 1000, name
    rows = json.loads((out / "summary.json").read_text())
    assert [r["name"] for r in rows] == ["H", "nu0", "width", "white"]
    assert set(rows[0]) == {"name", "mean", "std", "quantiles", "median",
                            "ess", "tau", "rhat"}
    z = np.load(out / "restore.npz")
    assert str(z["phase"]) == "A" and "meta_in_progress" not in z.files
    np.testing.assert_allclose(np.load(out / "betas.npy"),
                               1.6 ** -np.arange(3.0), rtol=1e-6)


def _both(argv, capsys):
    """The stdout of the port's and of the reference's CLI for one argv,
    and their exit codes."""
    outs = []
    for main in (cli.main, j_cli.main):
        capsys.readouterr()
        code = 0
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
        outs.append((capsys.readouterr().out, code))
    return outs


def test_stats_prints_and_writes_what_the_reference_does(fit, tmp_path,
                                                         capsys):
    out, _ = fit
    (t_txt, t_code), (j_txt, j_code) = _both(
        ["stats", "--outdir", str(out), "--max-rows", "3"], capsys)
    assert t_txt == j_txt and t_code == j_code == 0
    assert t_txt.splitlines()[0].split() == ["param", "median", "mean", "std",
                                             "q16", "q84", "ESS", "Rhat"]
    assert len(t_txt.splitlines()) == 4
    cli.main(["stats", "--outdir", str(out), "--phase", "L", "--json",
              str(tmp_path / "t.json")])
    j_cli.main(["stats", "--outdir", str(out), "--phase", "L", "--json",
                str(tmp_path / "j.json")])
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_evidence_prints_and_writes_what_the_reference_does(fit, tmp_path,
                                                            capsys):
    out, _ = fit
    (t_txt, _), (j_txt, _) = _both(
        ["evidence", "--outdir", str(out), "--burn-frac", "0.2", "--json",
         str(tmp_path / "e.json")], capsys)
    assert t_txt == j_txt and t_txt.startswith("ln Z                = ")
    assert len(t_txt.splitlines()) == 4 + 3
    res = json.loads((tmp_path / "e.json").read_text())
    assert np.isfinite(res["logZ"]) and len(res["mean_logL"]) == 3
    (tmp_path / "nobetas").mkdir()
    (tmp_path / "nobetas" / "A_chains.npz").write_bytes(
        (out / "A_chains.npz").read_bytes())
    for main in (cli.main, j_cli.main):
        with pytest.raises(SystemExit, match="betas.npy missing"):
            main(["evidence", "--outdir", str(tmp_path / "nobetas")])


def test_compare_exit_codes_and_text(fit, tmp_path, capsys):
    """An outdir against its own export is consistent (exit 0); against a
    shifted copy it is not (exit 1); the text and the JSON are the
    reference's."""
    out, _ = fit
    exp = tmp_path / "export.txt"
    (t_txt, _), (j_txt, _) = _both(
        ["export", "--outdir", str(out), "--out", str(exp)], capsys)
    assert t_txt == j_txt and "(100 emits x 4 walkers)" in t_txt
    (t_txt, t_code), (j_txt, j_code) = _both(
        ["compare", str(out), str(exp), "--json", str(tmp_path / "c.json")],
        capsys)
    assert t_txt == j_txt and t_code == j_code == 0
    assert "--> CONSISTENT: 4 common params" in t_txt
    assert json.loads((tmp_path / "c.json").read_text())["consistent"]
    table = np.loadtxt(exp)
    table[:, 1] += 5.0 * table[:, 1].std()
    np.savetxt(tmp_path / "shifted.txt", table,
               header=exp.read_text().splitlines()[0].lstrip("# "))
    (t_txt, t_code), (j_txt, j_code) = _both(
        ["compare", str(out), str(tmp_path / "shifted.txt"), "--z", "4"],
        capsys)
    assert t_txt == j_txt and t_code == j_code == 1
    assert "MISMATCH" in t_txt and "INCONSISTENT" in t_txt
    # two run directories: per-walker chains from the .hdr's Nchains
    (t_txt, t_code), (j_txt, j_code) = _both(
        ["compare", str(out), str(out), "--phase", "L"], capsys)
    assert t_txt == j_txt and t_code == j_code == 0


@pytest.mark.parametrize("flags,emits", [(["--thin", "3"], [0, 3, 6, 9]),
                                         (["--range", "2:4"], [2, 3]),
                                         (["--thin", "2", "--range", "1:3"],
                                          [2, 4])])
def test_export_thins_and_ranges_on_the_emit_axis(tmp_path, capsys, flags,
                                                  emits):
    """tests/test_io.py::TestExportThinning's cases on the port's writer
    and verb: every selected emit carries all its walkers, and the table
    is the one the reference's `export` writes from the same directory."""
    Cn, Df, E = 4, 3, 10
    w = OutputWriter(str(tmp_path), ["a", "b", "c"], n_temps=2, n_chains=Cn)
    e_i, c_i, d_i = np.meshgrid(np.arange(E), np.arange(Cn), np.arange(Df),
                                indexing="ij")
    w.append_chunk("A", {"theta0": (100 * e_i + 10 * c_i + d_i).astype(float),
                         "logL": np.zeros((E, 2, Cn))})
    w.close()
    (t_txt, _), (j_txt, _) = _both(
        ["export", "--outdir", str(tmp_path), *flags, "--out",
         str(tmp_path / "t.txt")], capsys)
    assert t_txt.replace("t.txt", "") == j_txt.replace("t.txt", "")
    txt = np.loadtxt(tmp_path / "t.txt")
    j_cli.main(["export", "--outdir", str(tmp_path), *flags])
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "A_samples.txt").read_text()
    assert txt.shape == (len(emits) * Cn, Df)
    np.testing.assert_array_equal(np.unique(txt[:, 0] // 100), emits)
    for e in emits:
        rows = txt[txt[:, 0] // 100 == e]
        np.testing.assert_array_equal(np.sort(rows[:, 0] % 100 // 10),
                                      np.arange(Cn))


@pytest.mark.parametrize("precision", ["bf16", "f64"])
def test_other_precisions_exit_with_not_ported_yet(tmp_path, precision):
    """The two other precisions used to exit here; they are ported now and
    run on the cpu, each recorded in the checkpoint (their numbers are
    held against the reference in tests/test_torch_precision.py)."""
    res = cli.main(["run", "--demo", "single_lorentzian", "--device", "cpu",
                    "--precision", precision, "--temps", "2", "--chains",
                    "4", "--burnin", "10", "--learning", "10", "--acquire",
                    "10", "--thin", "5", "--no-report", "--outdir",
                    str(tmp_path / "o")])
    assert set(res["phases"]) == {"B", "L", "A"}
    z = np.load(tmp_path / "o" / "restore.npz")
    assert str(z["meta_precision"]) == precision
    assert z["state_theta"].dtype == (np.float64 if precision == "f64"
                                      else np.float32)


def test_run_without_matplotlib_fails_before_it_samples(tmp_path,
                                                        monkeypatch):
    """A report cannot be made: the run says so at once and writes nothing;
    with --no-report it runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    few = ["run", "--demo", "single_lorentzian", "--device", "cpu", "--temps",
           "2", "--chains", "4", "--burnin", "8", "--learning", "8",
           "--acquire", "8", "--thin", "4"]
    for flags in ([], ["--no-report", "--report-every", "1"]):
        with pytest.raises(SystemExit, match="needs matplotlib"):
            cli.main([*few, *flags, "--outdir", str(tmp_path / "o")])
        assert not (tmp_path / "o").exists()
    cli.main([*few, "--no-report", "--outdir", str(tmp_path / "o")])
    assert (tmp_path / "o" / "summary.json").exists()
    assert not (tmp_path / "o" / "traces.png").exists()


def test_profile_writes_a_chrome_trace_of_the_acquire_phase(tmp_path):
    cli.main(["run", "--demo", "single_lorentzian", "--device", "cpu",
              "--temps", "2", "--chains", "4", "--burnin", "8", "--learning",
              "8", "--acquire", "8", "--thin", "4", "--no-report",
              "--profile", "--outdir", str(tmp_path)])
    trace = json.loads((tmp_path / "torch_trace" / "acquire.json")
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::randn" in names and "aten::cholesky_ex" not in names
    # the program's spans, and the profiled phase's counters in its
    # phase_end line: 8 steps, one chunk of 2 records
    assert {"tamcmc/step", "tamcmc/logpost"} <= names
    ends = {e["phase"]: e for e in map(
        json.loads, (tmp_path / "metrics.jsonl").read_text().splitlines())
        if e["event"] == "phase_end"}
    assert "counters" not in ends["B"] and "counters" not in ends["L"]
    assert ends["A"]["counters"] == {"steps": 8, "chunks": 1, "syncs": {},
                                     "launches": {}, "armm_launches": {},
                                     "alm_tables": {}}


def test_a_failing_phase_aborts_the_writer_and_propagates(tmp_path,
                                                          monkeypatch):
    """No .hdr for the interrupted phase, the exception reaches the
    caller, and the last checkpoint resumes."""
    from tamcmc_tpu_torch.sampler import driver
    real, calls = driver.raw_step, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) > 30:
            raise RuntimeError("injected fault")
        return real(*a, **kw)

    few = ["run", "--demo", "single_lorentzian", "--device", "cpu", "--temps",
           "2", "--chains", "4", "--burnin", "16", "--learning", "32",
           "--acquire", "16", "--thin", "4", "--chunk", "2", "--ckpt-every",
           "1", "--no-report"]
    monkeypatch.setattr(driver, "raw_step", failing)
    with pytest.raises(RuntimeError, match="injected fault"):
        cli.main([*few, "--outdir", str(tmp_path / "run")])
    monkeypatch.undo()
    assert (tmp_path / "run" / "B_samples.hdr").exists()
    assert not (tmp_path / "run" / "L_samples.hdr").exists()
    cli.main([*few, "--outdir", str(tmp_path / "run"), "--resume"])
    cli.main([*few, "--outdir", str(tmp_path / "clean")])
    assert same_outputs(tmp_path / "clean", tmp_path / "run") == []


def test_a_kill_between_a_phase_s_files_and_its_checkpoint_resumes(
        tmp_path, monkeypatch):
    """Learning's .hdr and chains.npz are written, its end-of-phase
    checkpoint is not: the resume continues from the last mid-phase
    checkpoint, whose partial chains file is still there, and ends byte for
    byte as the uninterrupted run."""
    from tamcmc_tpu_torch.io import checkpoint
    real = checkpoint.save_checkpoint

    def dies_at_the_end_of_learning(path, state, rng_state, phase="",
                                    meta=None):
        if phase == "L" and "in_progress" not in meta:
            raise KeyboardInterrupt
        return real(path, state, rng_state, phase=phase, meta=meta)

    few = ["run", "--demo", "single_lorentzian", "--device", "cpu", "--temps",
           "3", "--chains", "4", "--burnin", "16", "--learning", "40",
           "--acquire", "16", "--thin", "4", "--chunk", "2", "--ckpt-every",
           "2", "--no-report"]
    monkeypatch.setattr(checkpoint, "save_checkpoint",
                        dies_at_the_end_of_learning)
    with pytest.raises(KeyboardInterrupt):
        cli.main([*few, "--adapt-ladder", "--outdir", str(tmp_path / "run")])
    monkeypatch.undo()
    run = tmp_path / "run"
    assert (run / "L_samples.hdr").exists()
    assert (run / "L_chains_partial.npz").exists()
    z = np.load(run / "restore.npz")
    assert str(z["phase"]) == "L" and int(z["meta_emitted"]) == 8
    cli.main([*few, "--adapt-ladder", "--outdir", str(run), "--resume"])
    cli.main([*few, "--adapt-ladder", "--outdir", str(tmp_path / "clean")])
    assert same_outputs(tmp_path / "clean", run) == []
    assert not list(run.glob("*partial*"))


def test_make_example_passes_validate_with_auto_window(tmp_path, capsys):
    """The flagship demos' examples pass the port's own linter once
    `auto_window = true` is set: the grid column is the demo's float64
    linspace (it reads back to the float32 grid the demo fits, whose own
    spacing varies by more than 1e-3 of a bin here), and the start point's
    rows outside a bounded prior are moved into its support and named."""
    from tamcmc_tpu_torch.demos import make_demo
    from tamcmc_tpu_torch.io.data import read_spectrum
    from tamcmc_tpu_torch.io.problemfile import read_problem_file
    from tamcmc_tpu_torch.io.validate import validate_problem
    cli.main(["make-example", "--demo", "kepler_full", "--ngrid", "30000",
              "--device", "cpu", "--outdir", str(tmp_path)])
    said = capsys.readouterr().out
    assert "start point moved into its prior's support: H_0 -0.649723 -> " \
        "0.2 (+0.849723)" in said
    path = tmp_path / "problem.toml"
    path.write_text(path.read_text().replace(
        "[problem]", "[problem]\nauto_window = true", 1))
    assert validate_problem(str(path)) == ([], [])
    cli.main(["validate", str(path)])
    assert capsys.readouterr().out.strip().endswith("OK")
    problem, _, _, meta = make_demo("kepler_full", ngrid=30000)
    nu = read_spectrum(str(tmp_path / "spectrum.data"))["nu"]
    np.testing.assert_array_equal(nu, meta["nu64"])
    np.testing.assert_array_equal(nu.astype(np.float32), problem.nu.numpy())
    steps = np.diff(problem.nu.numpy().astype(np.float64))
    assert steps.max() - steps.min() > 1e-3 * np.median(steps)
    # the start: the demo's, except the rows that were outside
    p0 = read_problem_file(str(path))["params0"]
    demo = problem.params0.numpy().astype(np.float64)
    moved = np.nonzero(p0 != demo)[0]
    assert [problem.priors.names[i] for i in moved] == ["H_0"]
    assert demo[moved[0]] < 0 and p0[moved[0]] == 0.2
