"""The kill windows of the port's phase loop (`cli._run_phases`), made
deterministic: the checkpoint writer is replaced by one that raises a
BaseException (a kill) at a chosen call, the fit is resumed with
`--resume` in the same process, and it must end byte for byte as the
uninterrupted fit, for `run` and for `batch --stacked`.

The windows: after a mid-phase `save_partial` and before its checkpoint
(the partial chain file is then one checkpoint interval newer than
restore.npz, and the resume must cut it back); after a phase's files and
before its end checkpoint; after that checkpoint and before the partial
file is removed.  Beside them, `OutputWriter.resume_phase` on a partial
file with more and with fewer records than the checkpoint claims."""

import json
import pathlib

import numpy as np
import pytest
import torch

from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.io import checkpoint
from tamcmc_tpu_torch.io.outputs import OutputWriter
from tamcmc_tpu_torch.repeat_check import same_outputs

torch.set_num_threads(1)

PLAN = {"temps": 4, "chains": 4, "burnin": 10, "learning": 60,
        "acquire": 10, "thin": 5, "chunk": 2}
FIT = ["run", "--demo", "ms_global", "--n-orders", "2", "--ngrid", "2000",
       *(a for k, v in PLAN.items() for a in (f"--{k}", str(v))),
       "--ckpt-every", "2", "--device", "cpu", "--no-report"]


class Killed(BaseException):
    """What a SIGKILL is to the loop: nothing after it runs."""


def _kill_at(monkeypatch, window, nth=2):
    """Replace the checkpoint writer so that the run stops in `window`:
    'mid-phase' before the nth in-progress checkpoint of L is written,
    'before phase-end checkpoint' before L's end checkpoint is written,
    'after phase-end checkpoint' just after it (before L's partial file is
    removed)."""
    real = checkpoint.save_checkpoint
    seen = []

    def save(path, state, rng_state, phase="", meta=None):
        in_progress = int((meta or {}).get("in_progress", 0))
        if phase == "L" and in_progress:
            seen.append(phase)
            if window == "mid-phase" and len(seen) == nth:
                raise Killed
        if phase == "L" and not in_progress:
            if window == "before phase-end checkpoint":
                raise Killed
            real(path, state, rng_state, phase, meta)
            raise Killed
        return real(path, state, rng_state, phase, meta)

    monkeypatch.setattr(checkpoint, "save_checkpoint", save)


def _stacked_table(tmp, problems, name):
    d = tmp / name
    d.mkdir()
    rows = [{"problem": str(p), "seed": 3, "outdir": f"star{i}", **PLAN}
            for i, p in enumerate(problems)]
    (d / "presets.toml").write_text("\n".join(
        "[[star]]\n" + "".join(f"{k} = {json.dumps(v)}\n"
                               for k, v in row.items()) for row in rows))
    return d, ["batch", "--presets", str(d / "presets.toml"), "--stacked",
               "--ckpt-every", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The uninterrupted fits of both verbs under one directory, and the
    two stars' problem files."""
    base = tmp_path_factory.mktemp("window")
    cli.main([*FIT, "--outdir", str(base / "run")])
    problems = []
    for s in (0, 1):
        out = base / f"example{s}"
        cli.main(["make-example", "--demo", "ms_global", "--device", "cpu",
                  "--seed", str(s), "--ngrid", "2000", "--outdir", str(out)])
        problems.append(out / "problem.toml")
    d, argv = _stacked_table(base, problems, "stacked")
    cli.main(argv)
    return base, problems


def _verb(verb, clean, tmp_path):
    """(argv, [(clean dir, resumed dir)]) of `verb` writing under tmp_path."""
    base, problems = clean
    if verb == "run":
        return ([*FIT, "--outdir", str(tmp_path / "run")],
                [(base / "run", tmp_path / "run")])
    d, argv = _stacked_table(tmp_path, problems, "stacked")
    return argv, [(base / "stacked" / f"star{i}", d / f"star{i}")
                  for i in range(2)]


@pytest.mark.parametrize("verb", ["run", "batch --stacked"])
@pytest.mark.parametrize("window", ["mid-phase", "before phase-end checkpoint",
                                    "after phase-end checkpoint"])
def test_a_kill_in_each_window_resumes_byte_equal(clean, tmp_path,
                                                  monkeypatch, verb, window,
                                                  capsys):
    argv, pairs = _verb(verb, clean, tmp_path)
    with monkeypatch.context() as m:
        _kill_at(m, window)
        with pytest.raises(Killed):
            cli.main(argv)
    for _, run in pairs:
        assert not (run / "A_samples.bin").exists()
        if window == "mid-phase":
            # the partial chain file holds one interval past the checkpoint
            part = np.load(run / "L_chains_partial.npz")
            assert int(part["__count__"]) == 8 * 4
        if window == "after phase-end checkpoint":
            assert (run / "L_chains_partial.npz").exists()
    capsys.readouterr()
    cli.main([*argv, "--resume"])
    out = capsys.readouterr().out
    if window == "mid-phase":
        # the second of L's three mid-phase checkpoints was never written
        assert "mid-phase L (4 records already emitted)" in out
    elif window == "before phase-end checkpoint":
        assert "mid-phase L (12 records already emitted)" in out
    else:
        assert "after phase L" in out
    for want, run in pairs:
        assert same_outputs(want, run) == []
        assert not list(run.glob("*partial*")) and \
            not list(run.glob("*.tmp"))


def _records(E, C, Df, T, start):
    """One chunk's host records: theta0 and the chain diagnostics, every
    value its position in the phase (so rows are easy to tell apart)."""
    v = np.arange(start, start + E, dtype=np.float64)
    return {"theta0": np.broadcast_to(v[:, None, None], (E, C, Df)).copy(),
            "logL": np.broadcast_to(v[:, None, None], (E, T, C)).copy(),
            "acc_rate": np.broadcast_to(v[:, None], (E, T)).copy()}


def test_resume_phase_cuts_the_partial_file_to_the_checkpoint(tmp_path):
    E, C, Df, T = 2, 3, 2, 2
    w = OutputWriter(str(tmp_path), ["a", "b"], T, C)
    for k in range(3):
        w.append_chunk("L", _records(E, C, Df, T, k * E))
        w.save_partial("L")             # the last one has no checkpoint
    w.abort()
    assert int(np.load(tmp_path / "L_chains_partial.npz")["__count__"]) \
        == 3 * E * C
    r = OutputWriter(str(tmp_path), ["a", "b"], T, C)
    r.resume_phase("L", 2 * E * C)      # the checkpoint covers two chunks
    r.append_chunk("L", _records(E, C, Df, T, 2 * E))
    r.close()
    z = np.load(tmp_path / "L_chains.npz")
    want = np.arange(3 * E, dtype=np.float64)
    assert np.array_equal(z["acc_rate"][:, 0], want)
    assert np.array_equal(z["logL"][:, 0, 0], want)
    raw = np.fromfile(tmp_path / "L_samples.bin", "<f8").reshape(-1, C, Df)
    assert np.array_equal(raw[:, 0, 0], want)


def test_resume_phase_refuses_a_partial_file_behind_the_checkpoint(tmp_path):
    E, C, Df, T = 2, 3, 2, 2
    w = OutputWriter(str(tmp_path), ["a", "b"], T, C)
    w.append_chunk("L", _records(E, C, Df, T, 0))
    w.save_partial("L")
    w.append_chunk("L", _records(E, C, Df, T, E))
    w.abort()
    before = (tmp_path / "L_samples.bin").read_bytes()
    with pytest.raises(ValueError, match=f"holds {E * C} records and the "
                                         f"checkpoint claims {2 * E * C}"):
        OutputWriter(str(tmp_path), ["a", "b"], T, C).resume_phase(
            "L", 2 * E * C)
    assert (tmp_path / "L_samples.bin").read_bytes() == before
    (tmp_path / "L_chains_partial.npz").unlink()
    with pytest.raises(ValueError, match="holds 0 records"):
        OutputWriter(str(tmp_path), ["a", "b"], T, C).resume_phase(
            "L", E * C)
    # a shard without the chain diagnostics has nothing to cut
    OutputWriter(str(tmp_path), ["a", "b"], T, C,
                 keep_chains=False).resume_phase("L", E * C)
