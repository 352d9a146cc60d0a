"""The port's `batch` verb on the CPU: a TOML presets table run serially,
a .cfg table with its master (config_default) and errors files, `--stacked`
(a heterogeneous set refused; a stacked ensemble killed with SIGKILL inside
Learning and resumed ends byte for byte as the uninterrupted one, star by
star), and the stacked checkpoint's gate.  Every star's .bin files read
back through the reference's tamcmc_tpu.io.outputs.read_bin_samples."""

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
from tamcmc_tpu.io.outputs import read_bin_samples
from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.io import refconfig
from tamcmc_tpu_torch.repeat_check import same_outputs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FEW = {"temps": 2, "chains": 4, "burnin": 20, "learning": 20,
       "acquire": 20, "thin": 5}


def _toml(rows):
    """A presets table of [[star]] rows (dicts)."""
    def val(v):
        return json.dumps(v) if isinstance(v, str) else str(v).lower()
    return "\n".join("[[star]]\n" + "".join(f"{k} = {val(v)}\n"
                                            for k, v in row.items())
                     for row in rows)


def _example(tmp, demo, seed, ngrid=None):
    """`make-example` of a demo on the CPU; its problem.toml."""
    out = tmp / f"{demo}_{seed}"
    cli.main(["make-example", "--demo", demo, "--device", "cpu", "--seed",
              str(seed), "--outdir", str(out),
              *(["--ngrid", str(ngrid)] if ngrid else [])])
    return out / "problem.toml"


def test_serial_toml_runs_each_star_as_run_would(tmp_path):
    rows = [{"demo": "single_lorentzian", "seed": s, "outdir": f"s{i}",
             **FEW} for i, s in enumerate((0, 7))]
    table = tmp_path / "presets.toml"
    table.write_text(_toml(rows))
    res = cli.main(["batch", "--presets", str(table), "--device", "cpu",
                    "--no-report"])
    assert len(res) == 2 and all(r["n_temps"] == 2 for r in res)
    for s in ("s0", "s1"):
        th, names = read_bin_samples(str(tmp_path / s), "A")
        assert th.shape == (20 // 5 * 4, 4) and np.isfinite(th).all()
        assert names == ["H", "nu0", "width", "white"]
        assert (tmp_path / s / "summary.json").exists()
    assert (tmp_path / "s0" / "A_samples.bin").read_bytes() != \
        (tmp_path / "s1" / "A_samples.bin").read_bytes()
    # star 0 is the `run` its row describes, byte for byte
    direct = tmp_path / "direct"
    cli.main(["run", "--demo", "single_lorentzian", "--seed", "0",
              "--device", "cpu", "--no-report", "--outdir", str(direct),
              *(a for k, v in FEW.items() for a in (f"--{k}", str(v)))])
    assert same_outputs(direct, tmp_path / "s0") == []


def test_cfg_table_with_master_and_errors(tmp_path):
    """The reference workflow from .cfg files alone: the master's [MALA]
    block reaches the sampler below the rows, the errors table seeds the
    proposal scales (scales_from_errors), the action string zeroes phases."""
    problem = _example(tmp_path, "single_lorentzian", 0)
    refconfig.write_config_default_provisional(
        str(tmp_path / "default.cfg"), sampler={"lambda_temp": 1.6},
        temps=3, chains=4, thin=5)
    refconfig.write_config_presets_provisional(
        str(tmp_path / "presets.cfg"),
        [{"id": "a", "problem": str(problem), "outdir": "fit_a",
          "burnin": 20, "learning": 20, "acquire": 20},
         {"id": "b", "problem": str(problem), "outdir": "fit_b",
          "burnin": 20, "learning": 0, "acquire": 20, "seed": 4}])
    refconfig.write_errors_default_provisional(
        str(tmp_path / "errors.cfg"), {"nu0": 0.3, "default_rel": 0.05})
    cli.main(["batch", "--presets", str(tmp_path / "presets.cfg"),
              "--config", str(tmp_path / "default.cfg"), "--errors",
              str(tmp_path / "errors.cfg"), "--device", "cpu",
              "--no-report"])
    args = cli._parser().parse_args(["run", "--problem", str(problem),
                                     "--device", "cpu", "--outdir", "x"])
    built = cli._build_problem(args, torch.device("cpu"))[0]
    want = refconfig.scales_from_errors(
        built, {"nu0": 0.3, "default_rel": 0.05})
    for name, phases in (("fit_a", "BLA"), ("fit_b", "BA")):
        out = tmp_path / name
        z = np.load(out / "restore.npz")
        np.testing.assert_allclose(z["state_u_scale"], want, rtol=1e-6)
        assert z["state_theta"].shape[:2] == (3, 4)
        np.testing.assert_allclose(np.load(out / "betas.npy"),
                                   1.6 ** -np.arange(3.0), rtol=1e-6)
        assert [p for p in "BLA" if (out / f"{p}_samples.hdr").exists()] \
            == list(phases)
    with pytest.raises(SystemExit, match="subset of 'BLA'"):
        (tmp_path / "bad.cfg").write_text("s m.model 1 2 3 ZZ out\n")
        cli.main(["batch", "--presets", str(tmp_path / "bad.cfg"),
                  "--device", "cpu"])


def test_stacked_refuses_a_heterogeneous_set(tmp_path):
    table = tmp_path / "presets.toml"
    table.write_text(_toml([{"demo": "single_lorentzian", "outdir": "s0"},
                            {"demo": "harvey_background",
                             "outdir": "s1"}]))
    with pytest.raises(SystemExit, match="not stackable"):
        cli.main(["batch", "--presets", str(table), "--stacked",
                  "--device", "cpu"])
    assert not (tmp_path / "s0").exists()


STACK = {"temps": 2, "chains": 4, "burnin": 20, "learning": 100,
         "acquire": 20, "thin": 5, "chunk": 2}


def _child(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "tamcmc_tpu_torch.cli", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_stacked_sigkill_in_learning_and_resume_is_bitwise(tmp_path):
    """Two ms_global stars (make-example, 2,000 bins, offset spectra and
    start points: merged windows) stacked; SIGKILL inside Learning, then
    `--resume`: every star's .bin, chains.npz arrays and betas.npy
    byte-equal to the uninterrupted ensemble's."""
    problems = [_example(tmp_path, "ms_global", s, ngrid=2000)
                for s in (0, 1)]
    runs = {}
    for name in ("clean", "run"):
        d = tmp_path / name
        d.mkdir()
        (d / "presets.toml").write_text(_toml(
            [{"problem": str(p), "seed": 3, "outdir": f"star{i}", **STACK}
             for i, p in enumerate(problems)]))
        runs[name] = ["batch", "--presets", str(d / "presets.toml"),
                      "--stacked", "--ckpt-every", "2", "--device", "cpu"]
    proc = _child(runs["clean"])
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, out[-2000:]
    assert "stacked ensemble: 2 stars x 2 temps x 4 walkers" in out

    run = tmp_path / "run"
    proc = _child(runs["run"])
    deadline = time.time() + 120
    while not (run / "star1" / "L_chains_partial.npz").exists():
        assert proc.poll() is None and time.time() < deadline, \
            "the child ended before its first Learning checkpoint"
        time.sleep(0.02)
    time.sleep(0.2)                       # a few chunks into Learning
    proc.send_signal(signal.SIGKILL)
    assert proc.wait(timeout=60) == -signal.SIGKILL
    meta = np.load(run / "stacked_restore.npz")
    assert str(meta["phase"]) == "L" and int(meta["meta_in_progress"]) == 1
    emitted = int(meta["meta_emitted"])
    assert 0 < emitted < 20 and int(meta["meta_n_stars"]) == 2
    assert not (run / "star0" / "L_samples.hdr").exists()

    proc = _child([*runs["run"], "--resume"])
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, out[-2000:]
    assert f"mid-phase L ({emitted} records already emitted)" in out
    for star in ("star0", "star1"):
        assert same_outputs(tmp_path / "clean" / star, run / star) == []
        for phase, n in (("B", 4), ("L", 20), ("A", 4)):
            th, _ = read_bin_samples(str(run / star), phase)
            assert th.shape[0] == n * 4
    a0, _ = read_bin_samples(str(run / "star0"), "A")
    a1, _ = read_bin_samples(str(run / "star1"), "A")
    assert not np.array_equal(a0, a1)
    assert not list(run.rglob("*partial*")) and not list(run.rglob("*.tmp"))


def test_stacked_gate_records_run_s_fields_and_the_star_count(tmp_path):
    """The stacked checkpoint records what run's does plus the number of
    stars; a resume that changes any is refused without touching a file.
    The reference's records only the precision and resumes a table whose
    thin changed (its defect (b) in a new place, not copied)."""
    rows = [{"demo": "single_lorentzian", "seed": s, "outdir": f"s{i}",
             **FEW} for i, s in enumerate((0, 7))]
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        d.mkdir()
        (d / "presets.toml").write_text(_toml(rows))
    table = str(port / "presets.toml")
    cli.main(["batch", "--presets", table, "--stacked", "--device", "cpu"])
    z = np.load(port / "stacked_restore.npz")
    assert {k for k in z.files if k.startswith("meta_")} == {
        f"meta_{k}" for k in ("precision", "runner", "device", "chunk",
                              "thin", "adapt_ladder", "n_temps", "n_chains",
                              "n_stars")}
    assert str(z["meta_runner"]) == "stacked"
    assert int(z["meta_n_stars"]) == 2
    before = {p: p.read_bytes() for p in port.rglob("*") if p.is_file()}
    changed = {"thin": _toml([{**rows[0], "thin": 4}, rows[1]]),
               "stars in the presets table": _toml(rows + [
                   {**rows[0], "outdir": "s9"}])}
    for word, body in changed.items():
        (port / "presets.toml").write_text(body)
        with pytest.raises(SystemExit, match=word):
            cli.main(["batch", "--presets", table, "--stacked", "--device",
                      "cpu", "--resume"])
    (port / "presets.toml").write_text(_toml(rows))
    with pytest.raises(SystemExit, match="precision"):
        cli.main(["batch", "--presets", table, "--stacked", "--device",
                  "cpu", "--resume", "--precision", "bf16"])
    assert {p: p.read_bytes() for p in port.rglob("*") if p.is_file()} \
        == before

    j_cli.main(["batch", "--presets", str(ref / "presets.toml"),
                "--stacked"])
    assert {k for k in np.load(ref / "stacked_restore.npz").files
            if k.startswith("meta_")} == {"meta_precision"}
    (ref / "presets.toml").write_text(_toml([{**rows[0], "thin": 4},
                                             rows[1]]))
    j_cli.main(["batch", "--presets", str(ref / "presets.toml"),
                "--stacked", "--resume"])
