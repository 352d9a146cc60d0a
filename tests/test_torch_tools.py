"""The port's measurement tools on the CPU at tiny sizes: `scale_procs`
(the local run and `--mesh 2x1` / `1x2` over gloo, each a CLI run in its
own process with one plan), `ab_ladder` (the static and the adaptive
ladder on one problem, seed and plan) and the parts of `kernel_ab` (the
kernels alone, on the card) that run without one."""

import json

import numpy as np
import pytest
import torch

from tamcmc_tpu_torch import ab_ladder, kernel_ab, scale_procs

torch.set_num_threads(1)


def test_layouts_are_the_local_run_then_both_meshes_a_count():
    assert scale_procs.layouts([1, 2, 4]) == [None, "2x1", "1x2", "4x1",
                                              "1x4"]


def test_scale_procs_measures_every_layout_on_one_plan(tmp_path, monkeypatch,
                                                       capsys):
    """The local run and both two-process meshes at the sizes of
    tests/test_torch_cli_mesh.py, one repeat: a line a run with ms/step of
    each phase from its metrics.jsonl, then one a layout against the local
    median; the plan is the same in every run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "scale.jsonl"
    assert scale_procs.main([
        "--device", "cpu", "--demo", "ms_global", "--n-orders", "2",
        "--ngrid", "2000", "--temps", "4", "--chains", "4", "--steps", "20",
        "--chunk", "2", "--ckpt-every", "2", "--procs", "1", "2",
        "--repeats", "1", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == [json.loads(x) for x in out.read_text().splitlines()]
    runs = [x for x in lines if "mesh" in x]
    assert [(x["mesh"], x["processes"], x["backend"]) for x in runs] == [
        (None, 1, "none"), ("2x1", 2, "gloo"), ("1x2", 2, "gloo")]
    for x in runs:
        assert set(x["ms_per_step"]) == {"B", "L", "A"}
        assert all(v > 0 for v in x["ms_per_step"].values())
        assert x["plan"] == runs[0]["plan"] and x["card"] is None
    summary = {x["summary"]: x for x in lines if "summary" in x}
    assert set(summary) == {"local", "2x1", "1x2"}
    assert summary["local"]["vs_local"] == 1.0
    assert summary["2x1"]["vs_local"] == pytest.approx(
        summary["2x1"]["median"] / summary["local"]["median"])


def test_ab_ladder_runs_both_arms_on_one_plan(tmp_path, capsys):
    out = tmp_path / "ab.jsonl"
    assert ab_ladder.main([
        "--device", "cpu", "--configs", "kepler_full", "--ngrid", "2000",
        "--n-orders", "2", "--plan", "10,30,20,5", "--chunk", "2",
        "--chains", "4", "--temps", "3", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["arm"] for x in lines] == ["static", "adaptive"]
    keys = {"tool", "config", "T", "C", "arm", "plan", "ngrid", "n_orders",
            "ess_per_s", "ess_median", "acquire_s", "acquire_steps",
            "ms_per_step", "swap_rates", "swap_spread", "final_betas",
            "card"}
    for x in lines:
        assert set(x) == keys
        assert x["acquire_steps"] == 20 and x["card"] is None
        assert len(x["swap_rates"]) == 2 and len(x["final_betas"]) == 3
        assert x["ess_per_s"] > 0
    static, adaptive = lines
    assert static["final_betas"][0] == adaptive["final_betas"][0] == 1.0
    assert static["final_betas"] != adaptive["final_betas"]


def test_kernel_ab_needs_a_card(monkeypatch):
    """kernel_ab times CUDA kernels: without a card it exits 1 before any
    work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--precision", "both"]) == 1


@pytest.mark.parametrize("mangled,label", [
    ("_Z18lorentz_fwd_kernelILb0ELi4EEvPKfS1_", "lorentz_fwd_kernel<0,4>"),
    ("_Z23lorentz_fwd_bf16_kernelILi1EEvPKfS1_",
     "lorentz_fwd_bf16_kernel<1>"),
    ("_Z18lorentz_bwd_kernelILb0ELb1EEvPKfS1_", "lorentz_bwd_kernel<0,1>"),
    ("_Z19rcp_mismatch_kernelPi", "_Z19rcp_mismatch_kernelPi")])
def test_kernel_ab_names_each_instantiation(mangled, label):
    assert kernel_ab._kernel_label(mangled) == label


def test_kernel_ab_reduced_flagship_inputs_in_both_precisions():
    """The 64-walker regime: the golden fit's shapes, its plain version in
    each precision (the bf16 one rounds) and the wrapper's route, which on
    the CPU is the plain version."""
    inp = kernel_ab.regime_inputs("segment reduced flagship",
                                  torch.device("cpu"),
                                  np.random.default_rng(0))
    assert tuple(inp["args"][0].shape) == (64, 36)
    assert inp["nu"].shape[0] == inp["g"].shape[1] == 6000
    outs = {p: kernel_ab._plain(inp, p)[0] for p in ("f32", "bf16")}
    rel = float((outs["bf16"] - outs["f32"]).abs().max()
                / outs["f32"].abs().max())
    assert 1e-4 < rel < 1e-1
    with torch.no_grad():
        routed = inp["wrapper"](inp["nu"], *inp["args"], precision="bf16")
    assert torch.allclose(routed, outs["bf16"], rtol=1e-5, atol=1e-5)


def test_kernel_ab_signed_error_and_cover():
    """The toward-zero reading is negative for results shrunk toward zero,
    positive for grown ones and zero for the plain values themselves; the
    cover count is the most component ranges that hold one bin."""
    want = torch.tensor([[2.0, -4.0], [1.0, -1.0]], dtype=torch.float64)
    assert kernel_ab._toward_zero(want, want) == 0.0
    assert kernel_ab._toward_zero(want * (1 - 1e-3), want) == \
        pytest.approx(-1e-3)
    assert kernel_ab._toward_zero(want * (1 + 1e-3), want) == \
        pytest.approx(1e-3)
    lo, hi = np.array([0, 2, 5, 7]), np.array([4, 6, 5, 9])
    assert kernel_ab._max_cover(lo, hi, 10) == 2
    assert kernel_ab._max_cover(np.zeros(3, np.int64),
                                np.full(3, 8), 8) == 3
