"""`run --mesh TxC` of the PyTorch port on the CPU: two processes over gloo
started by `run` itself, against the local run and against themselves
killed and resumed (the counterparts of tests/test_cli_mesh.py), and the
refusals of the mesh flags and of the resume gate."""

import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.io.outputs import read_bin_samples
from tamcmc_tpu_torch.repeat_check import same_outputs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIT = ["run", "--demo", "ms_global", "--device", "cpu", "--n-orders", "2",
       "--ngrid", "2000", "--temps", "4", "--chains", "4", "--burnin", "40",
       "--learning", "300", "--acquire", "40", "--thin", "5", "--chunk", "2",
       "--ckpt-every", "2", "--no-report"]


def _child(args, **env_extra):
    """The CLI in a process group of its own (a kill reaches every rank)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "tamcmc_tpu_torch.cli", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(args):
    proc = _child(args)
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, out[-3000:]
    return out


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The local fit (in this process) and the same fit as `--mesh 2x1`."""
    base = tmp_path_factory.mktemp("mesh_cli")
    cli.main([*FIT, "--outdir", str(base / "local")])
    out = _finish([*FIT, "--mesh", "2x1", "--outdir", str(base / "mesh")])
    return base / "local", base / "mesh", out


def test_mesh_2x1_is_the_local_fit_byte_for_byte(fits):
    local, mesh, out = fits
    assert "mesh 2x1 (gspmd runner): 2 processes, backend gloo" in out
    _same_fit(local, mesh)
    for phase in ("B", "L", "A"):
        a = read_bin_samples(str(local), phase, with_chains=True)[0]
        # each process wrote its half of the cold rung's walkers
        for k, walkers in ((0, (0, 2)), (1, (2, 4))):
            hdr = (mesh / f"{phase}_samples.host{k}.hdr").read_text()
            assert "Nchains= 2" in hdr
            part = np.fromfile(mesh / f"{phase}_samples.host{k}.bin",
                               "<f8").reshape(a.shape[0], 2, -1)
            assert np.array_equal(part, a[:, walkers[0]:walkers[1]])
    assert np.array_equal(np.load(local / "betas.npy"),
                          np.load(mesh / "betas.npy"))
    assert not list(mesh.glob("*_samples.bin"))     # shards only
    events = [__import__("json").loads(line) for line in
              (mesh / "metrics.jsonl").read_text().splitlines()]
    start = events[0]
    assert (start["event"], start["mesh"], start["runner"],
            start["processes"], start["backend"]) == \
        ("run_start", "2x1", "gspmd", 2, "gloo")
    ranks = [e for e in events if e["event"] == "rank_end"]
    assert [(e["rank"], e["device"], e["steps"]) for e in ranks] == \
        [(0, "cpu", 380), (1, "cpu", 380)]


def _same_fit(local, mesh):
    """The merged shards and chains.npz of a mesh fit are the local fit's,
    byte for byte."""
    for phase in ("B", "L", "A"):
        a, names_a = read_bin_samples(str(local), phase, with_chains=True)
        b, names_b = read_bin_samples(str(mesh), phase, with_chains=True)
        assert names_a == names_b
        assert a.tobytes() == b.tobytes(), phase
        za, zb = (np.load(d / f"{phase}_chains.npz") for d in (local, mesh))
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].tobytes() == \
                zb[k].tobytes(), (phase, k)


def test_launcher_environment_runs_the_local_fit(fits, tmp_path):
    """`run --mesh 2x1 --distributed` in two processes that a launcher
    started, joined through torchrun's environment (env://), is the local
    fit byte for byte."""
    local, _, _ = fits
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "env"
    procs = [_child([*FIT, "--mesh", "2x1", "--distributed", "--outdir",
                     str(out)], MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                    LOCAL_RANK=str(r))
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs[0][-2000:] + \
        logs[1][-2000:]
    assert "mesh 2x1 (gspmd runner): 2 processes, backend gloo" in logs[0]
    _same_fit(local, out)
    assert (out / "A_samples.host1.hdr").exists()


def test_mesh_run_killed_in_learning_resumes_byte_equal(fits, tmp_path):
    _, clean, _ = fits
    run = tmp_path / "run"
    args = [*FIT, "--mesh", "2x1", "--outdir", str(run)]
    proc = _child(args)
    deadline = time.time() + 120
    while not (run / "L_chains_partial.npz").exists():
        assert proc.poll() is None and time.time() < deadline, \
            "the ranks ended before their first Learning checkpoint"
        time.sleep(0.02)
    time.sleep(0.5)
    os.killpg(proc.pid, signal.SIGKILL)        # the launcher and its ranks
    proc.wait(timeout=60)
    assert not (run / "L_samples.host0.hdr").exists()    # killed inside L
    z = np.load(run / "restore.npz")
    assert str(z["phase"]) == "L" and str(z["meta_mesh"]) == "2x1"
    emitted = int(z["meta_emitted"])
    assert 0 < emitted < 60
    # a resume under another mesh or runner is refused, nothing touched
    before = {p.name: p.read_bytes() for p in run.iterdir()}
    for flags, word in ((["--mesh", "1x2"], "--mesh 2x1 but this run "
                                            "requests --mesh 1x2"),
                        (["--mesh", "2x1", "--runner", "shardmap"],
                         "--runner gspmd but this run requests --runner "
                         "shardmap"),
                        ([], "--runner gspmd but this run requests --runner "
                             "local")):
        with pytest.raises(SystemExit, match=word):
            cli.main([*FIT, *flags, "--outdir", str(run), "--resume"])
    assert {p.name: p.read_bytes() for p in run.iterdir()} == before
    out = _finish([*args, "--resume"])
    assert f"mid-phase L ({emitted} records already emitted)" in out
    assert same_outputs(clean, run) == []
    for phase in ("B", "L", "A"):
        for k in (0, 1):
            name = f"{phase}_samples.host{k}"
            assert (run / f"{name}.bin").read_bytes() == \
                (clean / f"{name}.bin").read_bytes()
    assert not list(run.glob("*partial*")) and not list(run.glob("*.tmp"))


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "3x1"], "mesh 3x1 must divide temps x chains"),
    (["--mesh", "1x3"], "mesh 1x3 must divide temps x chains"),
    (["--runner", "shardmap"], "requires --mesh"),
    (["--mesh", "2x1", "--adapt-ladder"], "local-runner only"),
    (["--mesh", "2by1"], "--mesh expects TEMPSxCHAINS"),
    (["--distributed", "--mesh", "2x1"], "needs 2 processes; this run has 1"),
])
def test_mesh_flags_refused(tmp_path, flags, match):
    """Refused in this process, before any rank starts or any file is
    written."""
    with pytest.raises(SystemExit, match=match):
        cli.main([*FIT, *flags, "--outdir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def test_a_failing_rank_fails_the_launcher(tmp_path):
    """A rank that exits with an error stops the run: the launcher exits
    non-zero and says which rank."""
    bad = tmp_path / "bad.toml"
    bad.write_text('model = "no_such_model"\n')
    proc = _child(["run", "--problem", str(bad), "--device", "cpu",
                   "--mesh", "2x1", "--temps", "2", "--chains", "2",
                   "--no-report", "--outdir", str(tmp_path / "out")])
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode != 0
    assert "--mesh: rank" in out and "failed" in out, out[-2000:]
