"""The PyTorch port's problem files against the JAX reference's: either
package reads what the other wrote to the same content, malformed `.model`
lines fail with their line number, `validate_problem` reports the
reference's errors and warnings, and `resolve_auto_priors` derives the
reference's hyperparameters and refuses the same rows.

Everything here is host-side: files in a temporary directory, numpy arrays
and prior tables.  Hyperparameters and start values are compared exactly
(both packages parse the same text with Python's float).
"""

import pathlib

import numpy as np
import pytest
import torch

from tamcmc_tpu.cli import main as j_main
from tamcmc_tpu.io import problemfile as j_pf
from tamcmc_tpu.io import reference as j_ref
from tamcmc_tpu.io.data import read_spectrum as j_read_spectrum
from tamcmc_tpu.io.data import write_spectrum as j_write_spectrum
from tamcmc_tpu.io.validate import validate_problem as j_validate
from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu.models.ms_global import MSGlobalSpec as JMSGlobalSpec
from tamcmc_tpu.stats import auto_priors as j_auto
from tamcmc_tpu.stats.priors import PriorTable as JPriorTable
from tamcmc_tpu_torch.cli import main as t_main
from tamcmc_tpu_torch.io import problemfile as t_pf
from tamcmc_tpu_torch.io import reference as t_ref
from tamcmc_tpu_torch.io.data import read_spectrum, write_spectrum
from tamcmc_tpu_torch.io.validate import validate_problem
from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec
from tamcmc_tpu_torch.stats import auto_priors as t_auto
from tamcmc_tpu_torch.stats.priors import PriorKind, PriorTable

torch.set_num_threads(1)

MS = "model_MS_Global_a1etaa3_HarveyLike"


def _same_cfg(got, want):
    """Two readers' dicts hold the same content (prior tables by field)."""
    assert set(got) == set(want)
    for k in want:
        if k == "priors":
            np.testing.assert_array_equal(got[k].kinds, want[k].kinds)
            np.testing.assert_array_equal(got[k].hypers, want[k].hypers)
            assert tuple(got[k].names) == tuple(want[k].names)
        elif k == "params0":
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        else:
            assert got[k] == want[k], k


def _rows():
    """One row of every prior kind, with awkward floats."""
    return [("H_0", "jeffreys", 0.2, 100.0), ("f0", "gaussian", 2100.1, 1.0),
            ("a1", "uniform", 0.0, 8.0), ("asym", "fix"),
            ("ug", "uniform_gaussian", 0.0, 1.0, 0.3),
            ("gug", "gug", 0.0, 1.0, 0.2, 0.4), ("auto", "auto")]


P0 = np.asarray([8.0, 2100.1000000000004, 1.2, 0.0, 0.5, 1e-3, 1.0 / 3.0])
EXTRAS = dict(likelihood="chi_square", data="spectrum.npz",
              freq_range=(1500.0, 3500.5),
              spec_kwargs={"n_per_l": (3, 3, 3, 0), "n_harvey": 2,
                           "noise_kind": "harvey_1985"},
              sampler={"lambda_temp": 1.35, "use_drift": False,
                       "dN_mixing": 5},
              phases={"burnin": 100, "learning": 200, "acquire": 300,
                      "thin": 4, "temps": 3, "chains": 16})


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_toml_written_by_one_package_is_read_by_the_other(writer, tmp_path):
    path = str(tmp_path / "problem.toml")
    if writer == "reference":
        j_pf.write_problem_file(path, MS, P0, JPriorTable.from_rows(_rows()),
                                **EXTRAS)
    else:
        t_pf.write_problem_file(path, MS, P0, PriorTable.from_rows(_rows()),
                                **EXTRAS)
    got, want = t_pf.read_problem_file(path), j_pf.read_problem_file(path)
    _same_cfg(got, want)
    assert got["model"] == MS and got["likelihood"] == "chi_square"
    assert got["freq_range"] == [1500.0, 3500.5]
    assert got["spec_kwargs"] == EXTRAS["spec_kwargs"]
    assert got["sampler"] == EXTRAS["sampler"]
    assert got["phases"] == EXTRAS["phases"]
    np.testing.assert_array_equal(got["params0"], P0)
    assert [PriorKind(int(k)).name.lower() for k in got["priors"].kinds] == \
        [r[1] for r in _rows()]
    assert got["family_constraints"] and not got["auto_window"]


def test_toml_problem_switches_round_trip(tmp_path):
    """auto_window, window_margin and family_constraints, which the port's
    writer emits where they differ from the defaults, read back in both
    packages; without them the two writers give the same text."""
    pri = PriorTable.from_rows(_rows())
    a, b, c = (str(tmp_path / n) for n in ("a.toml", "b.toml", "c.toml"))
    t_pf.write_problem_file(a, MS, P0, pri, **EXTRAS)
    j_pf.write_problem_file(b, MS, P0, JPriorTable.from_rows(_rows()),
                            **EXTRAS)
    assert pathlib.Path(a).read_text() == pathlib.Path(b).read_text()
    t_pf.write_problem_file(c, MS, P0, pri, auto_window=True,
                            window_margin=7.5, family_constraints=False,
                            **EXTRAS)
    got, want = t_pf.read_problem_file(c), j_pf.read_problem_file(c)
    _same_cfg(got, want)
    assert got["auto_window"] and got["window_margin"] == 7.5
    assert not got["family_constraints"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_model_file_written_by_one_package_is_read_by_the_other(
        writer, tmp_path, capsys):
    path = str(tmp_path / "problem.model")
    kw = {k: EXTRAS[k] for k in ("likelihood", "data", "freq_range",
                                 "spec_kwargs")}
    if writer == "reference":
        j_ref.write_model_provisional(path, MS, P0,
                                      JPriorTable.from_rows(_rows()), **kw)
    else:
        t_ref.write_model_provisional(path, MS, P0,
                                      PriorTable.from_rows(_rows()), **kw)
    t_ref._BANNER_SHOWN = False
    got, want = t_ref.read_model_provisional(path), \
        j_ref.read_model_provisional(path)
    assert "PROVISIONAL" in capsys.readouterr().err
    t_ref.read_model_provisional(path)
    assert "PROVISIONAL" not in capsys.readouterr().err     # once a process
    _same_cfg(got, want)
    assert got["freq_range"] == (1500.0, 3500.5)
    assert got["spec_kwargs"] == EXTRAS["spec_kwargs"]
    np.testing.assert_array_equal(got["params0"], P0)
    # a fixed or auto row is written with relax 0 and read as fix
    kinds = [PriorKind(int(k)) for k in got["priors"].kinds]
    assert kinds[3] == kinds[6] == PriorKind.FIX
    assert kinds[:3] == [PriorKind.JEFFREYS, PriorKind.GAUSSIAN,
                         PriorKind.UNIFORM]


def test_model_files_of_both_writers_are_the_same_text(tmp_path):
    a, b = str(tmp_path / "a.model"), str(tmp_path / "b.model")
    t_ref.write_model_provisional(a, MS, P0, PriorTable.from_rows(_rows()),
                                  data="x.data", spec_kwargs={"n_harvey": 2})
    j_ref.write_model_provisional(b, MS, P0, JPriorTable.from_rows(_rows()),
                                  data="x.data", spec_kwargs={"n_harvey": 2})
    assert pathlib.Path(a).read_text() == pathlib.Path(b).read_text()


BAD_MODEL_LINES = [
    ("a1  1.2  1  Uniform  0.0", "prior Uniform needs 2"),
    ("a1  1.2  2  Uniform  0.0 8.0", "relax flag must be 0 or 1"),
    ("a1  1.2  1  Cauchy  0.0 8.0", "unknown prior"),
    ("a1  x.y  1  Uniform  0.0 8.0", "non-numeric initial value"),
    ("a1  1.2  1  Uniform  0.0 eight", "non-numeric hyperparameter"),
    ("a1  1.2  1  GUG  0 1 2 3 4", "at most 4 hyperparameters"),
    ("a1  1.2", "parameter row needs"),
    ("!fit_range= 1500.0", "fit_range needs 2 numbers"),
    ("!fit_range= low high", "non-numeric fit_range"),
    ("!colour= blue", "unknown header key"),
]


@pytest.mark.parametrize("line,message", BAD_MODEL_LINES)
def test_malformed_model_line_fails_with_its_line_number(line, message,
                                                         tmp_path):
    path = tmp_path / "bad.model"
    path.write_text(f"! a comment\n!model_fullname= {MS}\n"
                    f"H_0  5.0  1  Jeffreys  0.1 100.0\n{line}\n")
    errors = []
    for reader in (t_ref.read_model_provisional, j_ref.read_model_provisional):
        with pytest.raises(ValueError, match=message) as ei:
            reader(str(path))
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith(f"{path}:4: ")


def test_model_file_without_name_or_rows_is_refused(tmp_path):
    path = tmp_path / "empty.model"
    path.write_text("! nothing\n")
    with pytest.raises(ValueError, match="model_fullname"):
        t_ref.read_model_provisional(str(path))
    path.write_text(f"!model_fullname= {MS}\n")
    with pytest.raises(ValueError, match="no parameter rows"):
        t_ref.read_model_provisional(str(path))
    with pytest.raises(NotImplementedError, match="BYTE-compat"):
        t_pf.read_reference_model(str(path))


@pytest.mark.parametrize("name,sigma", [("s.data", False), ("s.data", True),
                                        ("s.npz", False), ("s.npz", True)])
def test_spectrum_files_cross_read(name, sigma, tmp_path):
    rng = np.random.default_rng(0)
    nu = np.linspace(1000.0, 1100.0, 64).astype(np.float32)
    power = rng.exponential(size=64).astype(np.float32)
    sig = power / 7.0 if sigma else None
    a, b = str(tmp_path / ("t_" + name)), str(tmp_path / ("j_" + name))
    write_spectrum(a, nu, power, sigma=sig)
    j_write_spectrum(b, nu, power, sigma=sig)
    for path in (a, b):
        got, want = read_spectrum(path), j_read_spectrum(path)
        assert set(got) == set(want) == \
            {"nu", "power"} | ({"sigma"} if sigma else set())
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            np.testing.assert_array_equal(
                np.asarray(got[k], np.float32),
                {"nu": nu, "power": power, "sigma": sig}[k])
    if name.endswith(".data"):
        p = tmp_path / "comments.data"
        p.write_text("# c\n! c\n* c\n\n1.0 2.0\n3.0 4.0\n")
        np.testing.assert_array_equal(read_spectrum(str(p))["power"],
                                      [2.0, 4.0])
        p.write_text("1.0\n2.0\n")
        with pytest.raises(ValueError, match=">=2 columns"):
            read_spectrum(str(p))


# ---------------------------------------------------------------------------
# validate_problem on the cases of the reference's own tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def example_dir(tmp_path_factory):
    """`make-example --demo single_lorentzian` written by the PORT."""
    out = tmp_path_factory.mktemp("example")
    t_main(["make-example", "--device", "cpu",
            "--demo", "single_lorentzian", "--outdir",
            str(out), "--model-format"])
    return out


def _patch(example_dir, tmp_path, transform, name="problem.toml"):
    text = transform((example_dir / name).read_text())
    for data in ("spectrum.data",):
        text = text.replace(f'data = "{data}"',
                            f'data = "{example_dir / data}"')
        text = text.replace(f"!data= {data}", f"!data= {example_dir / data}")
    dst = tmp_path / name
    dst.write_text(text)
    return str(dst)


def _both(path):
    got, want = validate_problem(path), j_validate(path)
    # the unknown-model error cites the list-models verb and the registry's
    # size, the same in both; every other message is data of the file
    assert got == want
    return got


def test_validate_clean_example_passes(example_dir):
    assert _both(str(example_dir / "problem.toml")) == ([], [])
    assert _both(str(example_dir / "problem.model")) == ([], [])
    t_main(["validate", str(example_dir / "problem.toml"),
            str(example_dir / "problem.model")])


VALIDATE_CASES = {
    "unknown model": (lambda s: s.replace("model_Single_Lorentzian",
                                          "model_Nope"), "unknown model"),
    "bad uniform hypers": (lambda s: s.replace(
        "hyper = [30.0, 70.0, 0.0, 0.0]", "hyper = [70.0, 30.0, 0.0, 0.0]"),
        "Uniform needs hi > lo"),
    "start outside support": (lambda s: s.replace(
        "value = 48.0", "value = 120.0"), "outside Uniform"),
    "missing data file": (lambda s: s.replace(
        'data = "spectrum.data"', 'data = "gone.data"'),
        "data file not found"),
    "bad freq_range": (lambda s: s.replace(
        "[problem]", "[problem]\nfreq_range = [5000.0, 6000.0]", 1),
        "does not overlap"),
    "inverted freq_range": (lambda s: s.replace(
        "[problem]", "[problem]\nfreq_range = [60.0, 40.0]", 1),
        "freq_range lo >= hi"),
    "jeffreys knee": (lambda s: s.replace(
        "hyper = [0.5, 100.0, 0.0, 0.0]", "hyper = [0.0, 100.0, 0.0, 0.0]"),
        "Jeffreys needs knee"),
    "bad lambda": (lambda s: s.replace(
        "lambda_temp = 1.6", "lambda_temp = 0.9"), "lambda_temp must be > 1"),
    "bad phase": (lambda s: s.replace("burnin = 1000", "burnin = 0"),
                  "must be a positive integer"),
    "chi_square without sigma": (lambda s: s.replace(
        'likelihood = "chi22p"', 'likelihood = "chi_square"'),
        "needs a 3rd"),
    "wrong parameter count": (lambda s: s + '\n[[param]]\nname = "x"\n'
                              'value = 1.0\nprior = "fix"\nhyper = []\n',
                              "!= model layout size"),
    "not toml": (lambda s: s + "\n[[[", "parse failed"),
}


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_errors_match_reference(case, example_dir, tmp_path):
    transform, message = VALIDATE_CASES[case]
    path = _patch(example_dir, tmp_path, transform)
    errors, _ = _both(path)
    assert any(message in e for e in errors), errors
    with pytest.raises(SystemExit) as ei:
        t_main(["validate", path])
    assert ei.value.code == 1


def test_validate_missing_file():
    errors, warns = _both("/nonexistent/problem.toml")
    assert "no such file" in errors[0] and warns == []


def test_validate_warnings_match_reference(example_dir, tmp_path):
    path = _patch(example_dir, tmp_path, lambda s: s.replace(
        "[sampler]", "[sampler]\nnot_a_knob = 3", 1).replace(
        "[phases]", "[phases]\nepochs = 3", 1).replace(
        'prior = "uniform"\nhyper = [30.0, 70.0, 0.0, 0.0]',
        'prior = "gaussian"\nhyper = [50.0, 0.1, 0.0, 0.0]').replace(
        "[problem]", "[problem]\nauto_window = true", 1))
    errors, warns = _both(path)
    assert errors == []
    for message in ("unknown key 'not_a_knob'", "unknown key 'epochs'",
                    "prior sigma", "auto_window only applies"):
        assert any(message in w for w in warns), (message, warns)
    t_main(["validate", path])          # warnings alone exit 0


def test_validate_model_file_with_auto_row(example_dir, tmp_path):
    """An Auto row that can be derived passes; one that cannot is an error
    that names the parameter, in both packages."""
    ok = _patch(example_dir, tmp_path, lambda s: "\n".join(
        f"nu0  {ln.split()[1]}  1  Auto" if ln.startswith("nu0") else ln
        for ln in s.splitlines()) + "\n", name="problem.model")
    assert _both(ok) == ([], [])
    # a Harvey shape parameter has no data-driven rule
    hb = tmp_path / "hb"
    t_main(["make-example", "--device", "cpu",
            "--demo", "harvey_background", "--outdir",
            str(hb), "--ngrid", "2048", "--model-format"])
    lines = (hb / "problem.model").read_text().splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith("A1"))
    lines[i] = f"A1  {lines[i].split()[1]}  1  Auto"
    (hb / "problem.model").write_text("\n".join(lines) + "\n")
    errors, _ = _both(str(hb / "problem.model"))
    assert any("'A1'" in e and "Auto prior" in e for e in errors), errors


@pytest.fixture(scope="module")
def ms_example(tmp_path_factory):
    """`make-example --demo ms_global --ngrid 1024` written by the
    REFERENCE."""
    out = tmp_path_factory.mktemp("ms")
    j_main(["make-example", "--demo", "ms_global", "--outdir", str(out),
            "--ngrid", "1024"])
    return out


def test_validate_crossed_frequencies_and_window_grid(ms_example, tmp_path):
    lines = (ms_example / "problem.toml").read_text().splitlines()
    vals = [i + 1 for i, ln in enumerate(lines)
            if ln.startswith('name = "f0_')]
    lines[vals[0]], lines[vals[1]] = lines[vals[1]], lines[vals[0]]
    bad = tmp_path / "crossed.toml"
    bad.write_text("\n".join(lines).replace(
        'data = "spectrum.data"', f'data = "{ms_example / "spectrum.data"}"'))
    errors, _ = _both(str(bad))
    assert any("strictly ascending" in e for e in errors), errors
    # auto_window on a fine float32 grid (0.085 uHz bins at 2,500 uHz, where
    # a float32 step is 2.4e-4 uHz): the exported spacing varies by more
    # than 1e-3 of a bin, which both packages report
    fine = tmp_path / "fine"
    t_main(["make-example", "--device", "cpu",
            "--demo", "ms_global", "--outdir", str(fine),
            "--ngrid", "16384"])
    path = _patch(fine, tmp_path, lambda s: s.replace(
        "[problem]", "[problem]\nauto_window = true", 1))
    errors, _ = _both(path)
    assert any("uniform frequency grid" in e for e in errors), errors
    assert _both(_patch(ms_example, tmp_path, lambda s: s.replace(
        "[problem]", "[problem]\nauto_window = true", 1))) == ([], [])


def test_validate_ajfit_crossed_centroids(tmp_path):
    t_main(["make-example", "--device", "cpu",
            "--demo", "ajfit", "--outdir", str(tmp_path)])
    assert _both(str(tmp_path / "problem.toml")) == ([], [])
    lines = (tmp_path / "problem.toml").read_text().splitlines()
    vals = [i + 1 for i, ln in enumerate(lines)
            if ln.startswith('name = "nu_')]
    lines[vals[0]], lines[vals[1]] = lines[vals[1]], lines[vals[0]]
    (tmp_path / "crossed.toml").write_text("\n".join(lines))
    errors, _ = _both(str(tmp_path / "crossed.toml"))
    assert any("'nu_nl' centroids" in e for e in errors), errors


# ---------------------------------------------------------------------------
# resolve_auto_priors on the cases of the reference's own tests
# ---------------------------------------------------------------------------

NU = np.linspace(1800.0, 2400.0, 4000)
SPEC = np.full(4000, 2.0) * (1.0 + 0.1 * np.sin(np.arange(4000)))


def _auto_setup(auto_names):
    kw = dict(n_per_l=(3, 0, 0, 0), n_harvey=1)
    _, jlay = j_build_model(MS, JMSGlobalSpec(**kw))
    _, tlay = build_model(MS, MSGlobalSpec(**kw))
    names = tlay.param_names()
    assert names == jlay.param_names()
    rows = [(n, "auto") if n in auto_names else (n, "fix") for n in names]
    p0 = np.zeros(tlay.ndim)
    fo = tlay.offset("freq_l0")
    p0[fo:fo + 3] = [2000.0, 2100.0, 2200.0]
    p0[tlay.offset("heights"):tlay.offset("heights") + 3] = 8.0
    p0[tlay.offset("widths"):tlay.offset("widths") + 3] = 1.5
    return (tlay, PriorTable.from_rows(rows)), \
        (jlay, JPriorTable.from_rows(rows)), p0, names


@pytest.mark.parametrize("auto", [
    ("freq_l0_1",), ("heights_0",), ("widths_2", "inclination"),
    ("noise_3",), ("heights_0", "heights_2", "freq_l0_0", "widths_1",
                   "noise_3", "inclination"),
])
def test_auto_priors_derive_the_reference_hypers(auto):
    (tlay, tpri), (jlay, jpri), p0, names = _auto_setup(set(auto))
    assert set(auto) <= set(names)
    got = t_auto.resolve_auto_priors(tpri, p0, layout=tlay, nu=NU, spec=SPEC)
    want = j_auto.resolve_auto_priors(jpri, p0, layout=jlay, nu=NU, spec=SPEC)
    np.testing.assert_array_equal(got.kinds, want.kinds)
    np.testing.assert_array_equal(got.hypers, want.hypers)
    assert tuple(got.names) == tuple(want.names)
    for n in auto:
        assert got.free_mask[names.index(n)]
    assert int(got.free_mask.sum()) == len(auto)


def test_auto_priors_noop_without_auto_rows():
    (tlay, tpri), _, p0, _ = _auto_setup(set())
    assert t_auto.resolve_auto_priors(tpri, p0, layout=tlay) is tpri


@pytest.mark.parametrize("auto,kw,message", [
    ("rot_0", dict(nu=NU, spec=SPEC), "rot"),
    ("noise_0", dict(nu=NU, spec=SPEC), "white-noise floor"),
    ("heights_0", dict(), "spectrum"),
    ("widths_0", dict(spec=SPEC), "frequency grid"),
    ("trunc", dict(nu=NU, spec=SPEC), "'trunc'"),
])
def test_auto_priors_refuse_the_reference_rows(auto, kw, message):
    (tlay, tpri), (jlay, jpri), p0, _ = _auto_setup({auto})
    with pytest.raises(t_auto.AutoPriorError, match=message) as ti:
        t_auto.resolve_auto_priors(tpri, p0, layout=tlay, **kw)
    with pytest.raises(j_auto.AutoPriorError, match=message):
        j_auto.resolve_auto_priors(jpri, p0, layout=jlay, **kw)
    assert f"'{auto}'" in str(ti.value)       # the error names the parameter
    with pytest.raises(t_auto.AutoPriorError, match="layout"):
        t_auto.resolve_auto_priors(PriorTable.from_rows([("x", "auto")]),
                                   np.zeros(1))
