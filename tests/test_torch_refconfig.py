"""The port's provisional `.cfg` trio (tamcmc_tpu_torch/io/refconfig.py)
against tamcmc_tpu.io.refconfig on the same files: equal results, the same
rejection messages, files written byte-equal, and equal proposal scales
from an errors table (the cases of tests/test_refconfig.py)."""

import numpy as np
import pytest
import torch

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.io import refconfig as jr
from tamcmc_tpu_torch.convert import problem_from_reference
from tamcmc_tpu_torch.io import refconfig as tr

torch.set_num_threads(1)

GOOD_DEFAULT = """\
! provisional master config
[data]
data_dir= ./spectra
[models]
model_fullname= model_Single_Lorentzian
likelihood= chi22p
[MALA]
Nchains= 4            ; rungs
Nwalkers= 6
lambda_temp= 1.5
dN_mixing= 8
target_acceptance= 0.3
use_drift= 0
c0= 2.0               ; reference alias of gain_c0
epsilon1= 1e-7
cov_estimator= walker
[outputs]
thin= 5
ckpt_every= 2
"""

GOOD_PRESETS = """\
! id    model_file     Bi   Li   Ai   action  outdir
star0   s0.model      100  200  300   BLA     fit0  seed=3
star1   s1.model      100  200  300   A       fit1  temps=2 chains=4
star2   s2.toml       10   20   30    LB      fit2  thin=4
"""

GOOD_ERRORS = """\
! param  sigma
nu0          0.25
width        0.5
default_rel  0.02
"""

BAD = {
    "default": [("[MALA]\nbogus_knob= 1\n"), ("[weird]\n"),
                ("[MALA]\nuse_drift= 2\n"), ("[MALA]\nlambda_temp= abc\n"),
                ("lambda_temp= 1.2\n"), ("[outputs]\nwhatever= 3\n"),
                ("[MALA]\nlambda_temp= 1.2\nbogus= 1\n"),
                ("[data]\nx= 1\n"), ("[models]\nmodel= m\n"),
                ("[MALA]\nno equals sign\n")],
    "presets": ["only three cols\n", "s m.model a 2 3 BLA out\n",
                "s m.model 1 2 3 XY out\n",
                "s m.model 1 2 3 BLA out stray\n",
                "s m.model 1 2 3 BLA out nope=1\n",
                "s m.model 1 2 3 BLA out seed=x\n", "! only a comment\n"],
    "errors": ["a1 0.05 extra\n", "a1 abc\n", "a1 -0.1\n",
               "a1 0.1\na1 0.2\n", "", "a1 inf\n"],
}
READERS = {"default": "read_config_default_provisional",
           "presets": "read_config_presets_provisional",
           "errors": "read_errors_default_provisional"}


@pytest.mark.parametrize("kind,body", [
    ("default", GOOD_DEFAULT), ("presets", GOOD_PRESETS),
    ("errors", GOOD_ERRORS)])
def test_readers_return_the_reference_s_result(tmp_path, kind, body):
    p = tmp_path / "c.cfg"
    p.write_text(body)
    got = getattr(tr, READERS[kind])(str(p))
    want = getattr(jr, READERS[kind])(str(p))
    assert got == want and type(got) is type(want)
    if kind == "default":
        assert got["sampler"]["gain_c0"] == 2.0     # alias resolved
        assert got["sampler"]["use_drift"] is False


@pytest.mark.parametrize("kind,i", [(k, i) for k, bodies in BAD.items()
                                    for i in range(len(bodies))])
def test_readers_refuse_with_the_reference_s_message(tmp_path, kind, i):
    p = tmp_path / "c.cfg"
    p.write_text(BAD[kind][i])
    with pytest.raises(ValueError) as want:
        getattr(jr, READERS[kind])(str(p))
    with pytest.raises(ValueError) as got:
        getattr(tr, READERS[kind])(str(p))
    assert str(got.value) == str(want.value)


def test_writers_write_the_reference_s_bytes(tmp_path):
    kw = dict(data_dir="d", model="m", likelihood="chi22p",
              sampler={"lambda_temp": 1.3, "use_drift": True}, temps=6,
              chains=4, thin=10, ckpt_every=0)
    stars = [{"id": "x", "problem": "x.model", "outdir": "ox", "burnin": 10,
              "learning": 20, "acquire": 30, "seed": 5},
             {"problem": "y.toml", "acquire": 7, "temps": 2},
             {"problem": "z.model", "action": "LA", "chains": 8}]
    table = {"a1": 0.05, "inc": 0.1, "default_rel": 1e-3}
    for name, pos, named in (
            ("write_config_default_provisional", (), kw),
            ("write_config_default_provisional", (), {}),
            ("write_config_presets_provisional", (stars,), {}),
            ("write_errors_default_provisional", (table,), {})):
        a, b = tmp_path / "port.cfg", tmp_path / "ref.cfg"
        getattr(tr, name)(str(a), *pos, **named)
        getattr(jr, name)(str(b), *pos, **named)
        assert a.read_bytes() == b.read_bytes(), name
    # and what they write reads back
    tr.write_config_presets_provisional(str(a), stars)
    back = tr.read_config_presets_provisional(str(a))
    assert [s["problem"] for s in back] == ["x.model", "y.toml", "z.model"]
    assert back[0]["seed"] == 5 and back[1]["burnin"] == 0
    assert back[2]["action"] == "LA" and back[2]["chains"] == 8


@pytest.mark.parametrize("table", [
    {"nu0": 0.25, "width": 0.5, "default_rel": 0.02},
    {"nu0": 0.3},
    {"default_rel": 0.05, "not_a_parameter": 1.0}])
def test_scales_from_errors_are_the_reference_s(table):
    jp, _, _, _ = j_make_demo("single_lorentzian", seed=0)
    tp = problem_from_reference(jp)
    got = tr.scales_from_errors(tp, table)
    want = jr.scales_from_errors(jp, table)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if "nu0" in table:
        assert got[tp.free_names.index("nu0")] == table["nu0"]
