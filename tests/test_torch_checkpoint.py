"""Checkpoint and bitwise resume of the PyTorch port: the npz round trip of
every state field and the generator, the schema refusals, in-process
resumes against an uninterrupted run, the resume gate (with what the
reference's gate lets through), and a reference checkpoint carried across
by convert."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu import cli as j_cli
from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.io import checkpoint as j_ckpt
from tamcmc_tpu.io import outputs as j_outputs
from tamcmc_tpu.sampler.mala import init_state as j_init_state
from tamcmc_tpu.sampler.mala import mala_step as j_mala_step
from tamcmc_tpu_torch import cli, convert
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.io.checkpoint import (SCHEMA_VERSION, load_checkpoint,
                                            read_meta, save_checkpoint)
from tamcmc_tpu_torch.io.outputs import OutputWriter
from tamcmc_tpu_torch.sampler.driver import run_phase
from tamcmc_tpu_torch.sampler.mala import init_state, mala_step
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState
from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

torch.set_num_threads(1)

T, C = 3, 4


@pytest.fixture(scope="module")
def fit():
    """config 1 after a few adaptive steps: a state no field of which is at
    its initial value."""
    problem, hp, _, _ = make_demo("single_lorentzian", seed=0)
    hp = dataclasses.replace(hp, dN_mixing=2)
    betas = make_beta_ladder(T, hp.lambda_temp)
    gen = torch.Generator().manual_seed(1)
    state = init_state(problem, hp, T, C, gen)
    state, _ = run_phase(problem, hp, betas, state, gen, 24, thin=4, chunk=3)
    return problem, hp, betas, state, gen.get_state()


def _rewrite(path, **changes):
    """The npz at `path` with entries replaced (None drops one)."""
    z = dict(np.load(path))
    for k, v in changes.items():
        if v is None:
            del z[k]
        else:
            z[k] = np.asarray(v)
    np.savez(path, **z)


def test_the_state_has_one_memory_layout(fit):
    """A checkpoint restores row-major tensors, so the running state must be
    row-major too (the Cholesky factor and its inverse come back
    column-major from the library): on a CUDA device the layout decides
    which library kernel multiplies, and with it the rounding."""
    state = fit[3]
    assert state.step == 24                       # past two chol refreshes
    for f in dataclasses.fields(SamplerState):
        if f.name != "step":
            assert getattr(state, f.name).is_contiguous(), f.name


def test_round_trip_of_every_field_and_the_generator(fit, tmp_path):
    problem, hp, betas, state, rng_state = fit
    path = tmp_path / "restore.npz"
    nbytes = save_checkpoint(str(path), state, rng_state, phase="L",
                             meta={"emitted": 6, "chunk": 3})
    assert 0 < nbytes <= path.stat().st_size
    z = np.load(path, allow_pickle=False)        # numpy only, no pickle
    assert int(z["schema_version"]) == SCHEMA_VERSION == 1
    assert z["rng_state"].dtype == np.uint8 and str(z["rng_device"]) == "cpu"
    assert z["state_step"].dtype == np.int32
    back, gen, phase, meta = load_checkpoint(str(path))
    assert phase == "L" and int(meta["emitted"]) == 6
    assert read_meta(str(path)).keys() == {"emitted", "chunk", "rng_device"}
    for f in dataclasses.fields(SamplerState):
        a, b = getattr(state, f.name), getattr(back, f.name)
        if f.name == "step":
            assert a == b == 24 and isinstance(b, int)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    # the first draws after a restore are the uninterrupted run's
    cont = torch.Generator()
    cont.set_state(rng_state)
    assert torch.equal(torch.randn(5, generator=gen),
                       torch.randn(5, generator=cont))
    # and so is the next step, bit for bit
    cont.set_state(rng_state)
    gen.set_state(rng_state)
    a = mala_step(problem, hp, betas, state, cont)
    b = mala_step(problem, hp, betas, back, gen)
    for f in ("theta", "logL", "cov", "log_sigma", "acc_rate"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("change,match", [
    ({"schema_version": 2}, "schema v2, this build expects v1"),
    ({"schema_version": None}, "schema v0"),
    ({"state_chol": None}, r"missing fields \['chol'\]"),
    ({"rng_state": None}, r"missing fields \['rng_state'\]"),
    ({"rng_device": "cuda"}, "cuda random generator and cannot continue on "
                             "cpu"),
])
def test_mismatched_or_incomplete_checkpoint_is_refused(fit, tmp_path, change,
                                                        match):
    path = tmp_path / "restore.npz"
    save_checkpoint(str(path), fit[3], fit[4])
    _rewrite(path, **change)
    with pytest.raises(ValueError, match=match):
        load_checkpoint(str(path))


def test_a_write_that_dies_leaves_the_previous_checkpoint(fit, tmp_path,
                                                          monkeypatch):
    path = tmp_path / "restore.npz"
    save_checkpoint(str(path), fit[3], fit[4], phase="B")
    before = path.read_bytes()

    def dies(f, **arrays):
        f.write(b"PK half a zip")
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", dies)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(str(path), fit[3], fit[4], phase="L")
    monkeypatch.undo()
    assert path.read_bytes() == before
    assert load_checkpoint(str(path))[2] == "B"


def _phase(problem, hp, betas, state, gen, outdir, ckpt_at=None,
           already=0, ladder=None, n_steps=48):
    """One Learning phase of 12 records in chunks of 2 through the writer;
    with `ckpt_at`, a checkpoint (and partial file) at that record count
    and an exception two chunks later, as a kill would have it."""
    writer = OutputWriter(str(outdir), problem.free_names, T, C)
    if already:
        writer.resume_phase("L", already * C)

    def on_state(s, rng_state, emitted):
        if emitted == ckpt_at:
            writer.save_partial("L")
            meta = {"emitted": emitted}
            if ladder is not None:
                meta.update({f"ladder_{k}": v for k, v in ladder.items()})
            save_checkpoint(str(outdir / "restore.npz"), s, rng_state,
                            phase="L", meta=meta)
        if ckpt_at is not None and emitted == ckpt_at + 4:
            raise KeyboardInterrupt

    try:
        state, outs = run_phase(
            problem, hp, betas, state, gen, n_steps, thin=4, chunk=2,
            on_chunk=lambda o: writer.append_chunk("L", o),
            on_state=on_state, already_emitted=already, ladder=ladder)
    except KeyboardInterrupt:
        writer.abort()
        return None, None
    writer.close()
    return state, outs


def _same_files(a, b):
    assert (a / "L_samples.bin").read_bytes() == \
        (b / "L_samples.bin").read_bytes()
    assert (a / "L_samples.hdr").read_text() == \
        (b / "L_samples.hdr").read_text()
    za, zb = np.load(a / "L_chains.npz"), np.load(b / "L_chains.npz")
    assert za.files == zb.files
    for k in za.files:
        assert za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize("ckpt_at", [0, 4, 6, 12])
@pytest.mark.parametrize("adapt_ladder", [False, True])
def test_in_process_resume_is_bitwise(fit, tmp_path, ckpt_at, adapt_ladder):
    """Checkpoint at the phase's start (the boundary after Burn-in), inside
    it, or at its end; the continuation from the npz leaves the files and
    the final state of the uninterrupted run."""
    problem, hp, betas, state0, rng0 = fit

    def ladder():
        return {"betas": betas.numpy().astype(np.float64), "updates": 0,
                "last_att": np.zeros(T), "last_acc": np.zeros(T)} \
            if adapt_ladder else None

    def generator():
        g = torch.Generator()
        g.set_state(rng0)
        return g

    clean, run = tmp_path / "clean", tmp_path / "run"
    lad_clean = ladder()
    want, _ = _phase(problem, hp, betas, state0, generator(), clean,
                     ladder=lad_clean)
    if ckpt_at == 0:
        run.mkdir()
        save_checkpoint(str(run / "restore.npz"), state0, rng0, phase="B")
        lad = ladder()
    elif ckpt_at == 12:
        lad = ladder()
        _phase(problem, hp, betas, state0, generator(), run, ladder=lad)
        # the end-of-phase checkpoint cmd_run writes; the phase's files are
        # final, and a resume at the boundary emits nothing more
        got, outs = run_phase(problem, hp, betas, want, generator(), 48,
                              thin=4, chunk=2, already_emitted=12, ladder=lad)
        assert outs == {} and got is want
        _same_files(run, clean)
        return
    else:
        lad = ladder()
        assert _phase(problem, hp, betas, state0, generator(), run,
                      ckpt_at=ckpt_at, ladder=lad) == (None, None)
        assert not (run / "L_samples.hdr").exists()
        assert (run / "L_samples.bin").stat().st_size > \
            ckpt_at * C * problem.ndim_free * 8
    state, gen, phase, meta = load_checkpoint(str(run / "restore.npz"))
    if adapt_ladder and ckpt_at:
        lad = {k: (int(meta[f"ladder_{k}"]) if k == "updates"
                   else np.asarray(meta[f"ladder_{k}"])) for k in lad}
        assert lad["updates"] == ckpt_at // 2
    got, outs = _phase(problem, hp, betas, state, gen, run,
                       already=int(meta.get("emitted", 0)), ladder=lad)
    assert outs["theta0"].shape[0] == 12 - ckpt_at
    _same_files(run, clean)
    for f in dataclasses.fields(SamplerState):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert (a == b) if f.name == "step" else torch.equal(a, b), f.name
    if adapt_ladder:
        assert lad["betas"].tobytes() == lad_clean["betas"].tobytes()
        assert not np.allclose(lad["betas"], betas.numpy())


def test_already_emitted_must_be_a_multiple_of_the_chunk(fit):
    problem, hp, betas, state, rng_state = fit
    gen = torch.Generator()
    gen.set_state(rng_state)
    with pytest.raises(ValueError, match="already_emitted=3 is not a "
                                         "multiple of chunk=2"):
        run_phase(problem, hp, betas, state, gen, 48, thin=4, chunk=2,
                  already_emitted=3)


# ---------------------------------------------------------------------------
# the resume gate
# ---------------------------------------------------------------------------

RUN = ["run", "--demo", "single_lorentzian", "--device", "cpu", "--temps",
       "3", "--chains", "4", "--burnin", "16", "--learning", "16",
       "--acquire", "16", "--thin", "4", "--chunk", "2", "--ckpt-every", "1",
       "--no-report"]


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    out = tmp_path_factory.mktemp("finished")
    cli.main([*RUN, "--outdir", str(out)])
    return out


def _snapshot(d):
    return {p.name: p.read_bytes() for p in d.iterdir()}


@pytest.mark.parametrize("flags,rewrite,match", [
    (["--chunk", "4"], {}, "--chunk 2 but this run requests --chunk 4"),
    (["--thin", "2"], {}, "--thin 4 but this run requests --thin 2"),
    (["--adapt-ladder"], {}, "--adapt-ladder False but this run requests "
                             "--adapt-ladder True"),
    (["--temps", "4"], {}, "--temps 3 but this run requests --temps 4"),
    (["--chains", "8"], {}, "--chains 4 but this run requests --chains 8"),
    ([], {"meta_device": "cuda"}, "--device cuda but this run requests "
                                  "--device cpu"),
    ([], {"meta_precision": "bf16"}, "--precision bf16 but this run "
                                     "requests --precision f32"),
    ([], {"meta_runner": "distributed"}, "--runner distributed but this run "
                                         "requests --runner local"),
    ([], {"meta_chunk": None}, "does not record chunk"),
])
def test_gate_refuses_a_resume_that_differs(finished, tmp_path, flags,
                                            rewrite, match):
    """One sentence that names the field, both values and the way out; no
    file of the run directory is touched."""
    out = tmp_path / "run"
    out.mkdir()
    for name, data in _snapshot(finished).items():
        (out / name).write_bytes(data)
    if rewrite:
        _rewrite(out / "restore.npz", **rewrite)
    before = _snapshot(out)
    with pytest.raises(SystemExit, match=match) as ei:
        cli.main([*RUN, *flags, "--outdir", str(out), "--resume"])
    assert "refusing to resume" in str(ei.value)
    assert "fresh outdir" in str(ei.value)
    assert _snapshot(out) == before


def test_resume_of_a_finished_run_and_of_no_checkpoint(finished, tmp_path,
                                                       capsys):
    """The same flags resume; with every phase done nothing is sampled and
    the sample files stay as they are.  Without a checkpoint --resume starts
    the run."""
    before = _snapshot(finished)
    res = cli.main([*RUN, "--outdir", str(finished), "--resume"])
    assert res["phases"] == {}
    assert "resumed from" in capsys.readouterr().out
    after = _snapshot(finished)
    for name in before:
        if name != "metrics.jsonl":
            assert after[name] == before[name], name
    res = cli.main([*RUN, "--outdir", str(tmp_path / "new"), "--resume"])
    assert set(res["phases"]) == {"B", "L", "A"}


def test_the_reference_gate_accepts_what_the_port_refuses(tmp_path, capsys):
    """Known defects (a) and (b) of the reference's gate, not copied: its
    checkpoint records neither the chunk nor the ladder mode, and a resume
    that changes both goes through."""
    out = tmp_path / "ref"
    base = ["run", "--demo", "single_lorentzian", "--temps", "3", "--chains",
            "4", "--burnin", "16", "--learning", "16", "--acquire", "16",
            "--thin", "4", "--no-report", "--outdir", str(out)]
    j_cli.main([*base, "--chunk", "2"])
    meta = {k for k in np.load(out / "restore.npz").files
            if k.startswith("meta_")}
    assert meta == {"meta_precision", "meta_runner"}
    j_cli.main([*base, "--chunk", "4", "--adapt-ladder", "--resume"])
    assert "resumed from" in capsys.readouterr().out


def test_the_reference_resume_keeps_stale_chain_rows(tmp_path):
    """Known defect (h) of the reference, not copied: its
    `OutputWriter.resume_phase` truncates the .bin to the checkpoint's
    records but loads the whole partial chain file, which `save_partial`
    wrote one checkpoint interval later when a kill fell between the two;
    the resumed chains.npz then holds those rows twice.  The port's cuts
    the chain buffers to the checkpoint as well."""
    E, C, T, Df = 2, 3, 2, 2

    def chunk(k):
        v = np.arange(k * E, (k + 1) * E, dtype=np.float64)
        return {"theta0": np.broadcast_to(v[:, None, None], (E, C, Df)).copy(),
                "logL": np.broadcast_to(v[:, None, None], (E, T, C)).copy()}

    rows = {}
    for name, writer in (("ref", j_outputs.OutputWriter),
                         ("port", OutputWriter)):
        d = tmp_path / name
        w = writer(str(d), ["a", "b"], T, C)
        for k in range(3):          # the third save_partial has no checkpoint
            w.append_chunk("L", chunk(k))
            w.save_partial("L")
        w.abort()
        r = writer(str(d), ["a", "b"], T, C)
        r.resume_phase("L", 2 * E * C)          # the checkpoint: two chunks
        r.append_chunk("L", chunk(2))
        r.close()
        rows[name] = np.load(d / "L_chains.npz")["logL"][:, 0, 0]
        assert np.array_equal(
            np.fromfile(d / "L_samples.bin", "<f8").reshape(-1, C, Df)[:, 0, 0],
            np.arange(3 * E))                    # the .bin is cut in both
    assert np.array_equal(rows["port"], np.arange(3 * E))
    assert np.array_equal(rows["ref"], [0, 1, 2, 3, 4, 5, 4, 5])


# ---------------------------------------------------------------------------
# a reference checkpoint carried across
# ---------------------------------------------------------------------------

def test_reference_checkpoint_carried_across_steps_like_the_reference(
        tmp_path):
    """A restore.npz written by the reference: its state_* arrays become
    the port's state (the PRNG key cannot cross, a generator is supplied),
    and one step with injected draws agrees with the reference's step from
    the state it loads itself, at tests/test_torch_sampler.py's one-step
    tolerances (1e-5 of each array's scale, logL rtol 1e-5)."""
    Tn, Cn = 2, 10
    jp, jhp, _, _ = j_make_demo("ms_global", seed=0, ngrid=2000, n_orders=2)
    js = j_init_state(jp, jhp, Tn, Cn, jax.random.PRNGKey(5))
    betas = np.asarray([1.0, 1 / 1.5], np.float32)
    rng = np.random.default_rng(12)

    def draws():
        return (rng.standard_normal((Tn, Cn, jp.ndim_free))
                .astype(np.float32),
                rng.uniform(size=(Tn, Cn)).astype(np.float32))

    step = jax.jit(lambda s, d: j_mala_step(
        jp, jhp, jnp.asarray(betas), s, jax.random.PRNGKey(0), draws=d))
    for _ in range(3):                      # off the initial state
        js = step(js, tuple(jnp.asarray(a) for a in draws()))
    path = tmp_path / "restore.npz"
    j_ckpt.save_checkpoint(str(path), js, jax.random.PRNGKey(9), phase="L")
    js, _, _, _ = j_ckpt.load_checkpoint(str(path))

    gen = torch.Generator().manual_seed(9)
    ts, gen = convert.state_from_reference_checkpoint(
        np.load(path, allow_pickle=False), gen)
    assert ts.step == 3 and isinstance(gen, torch.Generator)
    with pytest.raises(ValueError, match="generator lives on cpu"):
        convert.state_from_reference_checkpoint(np.load(path), gen, "meta")
    tp = convert.problem_from_reference(jp)
    thp = MALAHyper(**dataclasses.asdict(jhp))
    xi, u = draws()
    jn = step(js, (jnp.asarray(xi), jnp.asarray(u)))
    tn = mala_step(tp, thp, torch.as_tensor(betas), ts,
                   draws=(torch.as_tensor(xi), torch.as_tensor(u)))
    got = convert.state_to_arrays(tn)
    for f in ("theta", "mu", "cov", "gradL", "gradP", "chol", "ichol"):
        want = np.asarray(getattr(jn, f))
        assert np.abs(got[f] - want).max() \
            <= 1e-5 * max(np.abs(want).max(), 1e-30), f
    np.testing.assert_allclose(got["logL"], np.asarray(jn.logL), rtol=1e-5)
    assert got["step"] == 4
    # and back: the reference loads what the port's state gives
    arrays = convert.reference_checkpoint_arrays(tn)
    np.savez(tmp_path / "back.npz", **arrays,
             prng_key=np.asarray(jax.random.key_data(jax.random.PRNGKey(1))),
             phase=np.asarray("L"),
             schema_version=np.asarray(j_ckpt.SCHEMA_VERSION))
    jb, _, phase, _ = j_ckpt.load_checkpoint(str(tmp_path / "back.npz"))
    assert phase == "L" and int(jb.step) == 4
    np.testing.assert_array_equal(np.asarray(jb.cov), got["cov"])
