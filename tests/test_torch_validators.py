"""The port's posterior anchors on the CPU at tiny plans:
tamcmc_tpu_torch.validate_bf16, .validate_f64 and .golden_flagship (the
counterparts of tools/validate_bf16.py, validate_f64.py and
golden_flagship.py).  The full plans run on the card."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from tamcmc_tpu.diagnostics.compare import compare_posteriors as j_compare
from tamcmc_tpu_torch import golden_flagship, validate_bf16, validate_f64
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.diagnostics.compare import compare_posteriors
from tamcmc_tpu_torch.sampler.driver import PhasePlan

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = PhasePlan(burnin=8, learning=8, acquire=16, thin=4, chunk=2)
MS_GLOBAL = dict(validate_bf16.CONFIGS)["ms_global"]


@pytest.mark.parametrize("n, bad, ok", [
    (4, 0, True), (4, 1, True), (4, 2, False), (10, 1, True),
    (10, 2, False), (26, 1, True), (26, 2, False), (40, 2, True),
    (40, 3, False), (59, 2, True)])
def test_the_reference_ok_rule(n, bad, ok):
    assert validate_bf16.config_ok(n, bad) is ok


def test_compare_flags_are_the_reference_flags():
    rng = np.random.default_rng(11)
    E, C, D = 200, 8, 6
    a = rng.normal(size=(E, C, D)).astype(np.float32)
    b = rng.normal(size=(E, C, D)).astype(np.float32)
    b[..., 1] += 0.5            # a shifted mean
    b[..., 3] *= 2.0            # a wider spread
    names = [f"p{i}" for i in range(D)]
    got = compare_posteriors(a, names, b, names, z_threshold=4.0)
    want = j_compare(a, names, b, names, z_threshold=4.0)
    assert [r["ok"] for r in got["params"]] == \
        [r["ok"] for r in want["params"]] == [True, False, True, False,
                                               True, True]
    np.testing.assert_allclose([r["z"] for r in got["params"]],
                               [r["z"] for r in want["params"]], rtol=1e-12)


def test_validate_bf16_fits_one_spectrum_in_both_precisions():
    p32, hp, _, _ = make_demo("ms_global", seed=0, **MS_GLOBAL)
    drawn16 = make_demo("ms_global", seed=0, precision="bf16",
                        **MS_GLOBAL)[0]
    assert not torch.equal(drawn16.spec, p32.spec)   # its own draw differs
    p16 = validate_bf16.with_data(drawn16, p32)
    assert torch.equal(p16.spec, p32.spec)
    assert p16.model_meta["precision"] == "bf16"
    (t32, n32), (t16, n16) = (validate_bf16.fit(p, hp, TINY)
                              for p in (p32, p16))
    assert t32.shape == t16.shape == (TINY.acquire // TINY.thin,
                                      validate_bf16.CHAINS, 26)
    assert n32 == n16 == p32.free_names
    line = validate_bf16.judge("ms_global", (t32, n32), (t16, n16))
    assert set(line) == {"config", "n_params", "inconsistent", "ok"}
    assert line["n_params"] == 26


def test_validate_f64_sides_share_one_realisation():
    for demo, kw in validate_bf16.CONFIGS:
        p32, p64, hp = validate_f64.problems(demo, kw, torch.device("cpu"))
        assert p32.spec.dtype == torch.float32
        assert p64.spec.dtype == p64.params0.dtype == torch.float64
        for name in ("spec", "nu", "params0"):
            assert torch.equal(getattr(p64, name).float(),
                               getattr(p32, name)), (demo, name)
    (t32, names), (t64, names64) = (validate_bf16.fit(p, hp, TINY)
                                    for p in (p32, p64))
    assert t32.shape == t64.shape == (4, validate_bf16.CHAINS, 26)
    assert names == names64 == p32.free_names


def test_with_data_refuses_another_grid():
    a = make_demo("ms_global", seed=0, ngrid=2000, n_orders=2)[0]
    b = make_demo("ms_global", seed=0, ngrid=2400, n_orders=2)[0]
    with pytest.raises(ValueError, match="differ in nu"):
        validate_bf16.with_data(a, b)


def _digest(folder):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.iterdir()) if p.is_file()}


def test_golden_generate_writes_the_schema_elsewhere(tmp_path, monkeypatch):
    golden = ROOT / "tests" / "golden"
    before = _digest(golden)
    monkeypatch.setattr(golden_flagship, "PLAN", TINY)
    out = tmp_path / "port_golden.json"
    # a tiny plan is far from the long run's moments: the comparison fails
    assert golden_flagship.main(["generate", "--out", str(out), "--device",
                                 "cpu"]) == 1
    doc = json.loads(out.read_text())
    ref = json.loads((golden / "flagship_posterior.json").read_text())
    assert set(doc) == set(ref) == {"provenance", "f32", "bf16"}
    for precision in ("f32", "bf16"):
        assert set(doc[precision]) == set(ref[precision])
        assert doc[precision]["names"] == ref[precision]["names"]
        assert all(len(v) == 26 for v in doc[precision].values())
        np.testing.assert_allclose(doc[precision]["truth"],
                                   ref[precision]["truth"], rtol=1e-6)
    assert doc["provenance"]["plan"]["acquire"] == TINY.acquire
    assert _digest(golden) == before
    with pytest.raises(SystemExit, match="the reference's golden"):
        golden_flagship.main(["generate", "--out", str(
            golden / "flagship_posterior.json"), "--device", "cpu"])
    assert _digest(golden) == before
