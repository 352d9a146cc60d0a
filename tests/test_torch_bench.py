"""The port's bench (tamcmc_tpu_torch/bench.py) on the CPU at a tiny size,
and its counts against the reference bench.py's arithmetic at full width.

The CPU run checks the line's fields and arithmetic only: every time in it
is the CPU's, and `step_mfu`, a device metric, is null there.
"""

import io
import json
import contextlib

import numpy as np
import pytest
import torch

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.diagnostics.ess import effective_sample_size as j_ess
from tamcmc_tpu_torch import bench
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.diagnostics.ess import effective_sample_size
from tamcmc_tpu_torch.ops import lorentzian_kernel as K

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--ngrid", "2000", "--n-orders", "2", "--temps",
        "2", "--walkers", "4", "--reps", "1"]
CARRIED = {"device", "precision", "raw_steps_per_s", "walkers", "temps",
           "grid_bins", "free_dims", "ess_median_per_param", "warmup_s",
           "timed_s", "comp_bins_per_walker", "window_reduction",
           "lorentzian_components", "t_full_step_ms"}
DROPPED = {"vs_baseline", "baseline_steps_per_s_numpy_sequential",
           "achieved_gflops_f32", "op_mix_speed_of_light_ms",
           "frac_of_op_mix_sol", "issue_speed_of_light_ms",
           "frac_of_issue_sol", "ops_issue_peak_measured",
           "ops_issue_peak_used_e12", "issue_bench_suspect",
           "issue_op_model", "issue_model_note",
           "vpu_fma_peak_gflops_measured", "roofline_frac_of_vpu_fma",
           "fma_bench_suspect"}
PROFILED = {"t_model_fwd_ms", "t_model_fwdbwd_ms", "t_chol_refresh_ms",
            "model_eval_frac_of_step"}


def _line(monkeypatch, argv):
    """The bench's stdout (exactly one line) as a dict, two short adapting
    phases and one short timed rep."""
    monkeypatch.setattr(bench, "SCHEDULE", bench.Schedule(
        adapt_phases=2, adapt_emit=10, emit=20, thin=5, reps=1))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(argv) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("flags", [[], ["--precision", "f32", "--profile",
                                        "--no-mesh-ratio"]],
                         ids=["bf16-mesh-ratio", "f32-profile"])
def test_tiny_bench_line(monkeypatch, flags):
    res = _line(monkeypatch, TINY + flags)
    d = res["detail"]
    precision = "f32" if "f32" in flags else "bf16"
    assert (res["metric"], res["unit"], res["precision"], d["precision"]) \
        == ("eff_samples_per_s_per_chip", "ESS/s", precision, precision)
    assert CARRIED <= set(d) and not DROPPED & (set(d) | set(res))
    assert res["value"] == d["ess_median_per_param"] / d["timed_s"] > 0
    assert (d["walkers"], d["temps"], d["grid_bins"], d["timed_steps"]) == \
        (4, 2, 2000, 100)
    assert d["timed_s"] == sum(d["rep_s"]) and len(d["rep_s"]) == 1
    assert d["raw_steps_per_s"] == 100 / d["timed_s"]
    assert d["t_full_step_ms"] == 1e3 * d["timed_s"] / 100
    assert d["device"] == "cpu" and d["step_mfu"] is None
    assert d["step_bound_ms"] == bench.step_bound_ms(
        8, d["lorentzian_components"], 2000, d["comp_bins_per_walker"],
        precision)
    # the plain versions ran: no kernel launched on the CPU
    assert d["launches_per_step"] == {
        f"lorentz_{K.launch_key(k, precision)}": 0.0
        for k in ("fwd_chi22p", "bwd")}
    mesh = {"mesh1x1_gspmd_ratio", "mesh1x1_shardmap_ratio"}
    if "--profile" in flags:
        assert PROFILED <= set(d) and not mesh & set(d)
        assert d["model_eval_frac_of_step"] == \
            d["t_model_fwdbwd_ms"] / d["t_full_step_ms"]
    else:
        assert mesh <= set(d) and not PROFILED & set(d)
        assert all(d[k] > 0 for k in mesh)


def test_counts_are_the_reference_bench_arithmetic():
    """bench.py:137-143 on the reference's full-width ms_global against the
    port's problem_fields on its own."""
    jp, _, _, jmeta = j_make_demo("ms_global", seed=0)
    K_ref = sum(n * (2 * l + 1) for l, n in
                enumerate(jmeta["spec_kwargs"]["n_per_l"]))
    N_ref = int(np.asarray(jp.nu).shape[0])
    comp_ref = sum(len(idx) * (hi - lo)
                   for idx, lo, hi in jp.model_fn._window_groups)
    got = bench.problem_fields(make_demo("ms_global", seed=0)[0])
    assert got == {"grid_bins": N_ref, "free_dims": len(jp.free_names),
                   "lorentzian_components": K_ref,
                   "comp_bins_per_walker": comp_ref,
                   "window_reduction": K_ref * N_ref / comp_ref}
    assert (got["comp_bins_per_walker"], got["lorentzian_components"],
            got["grid_bins"], got["free_dims"]) == (536_675, 54, 40_000, 36)


def test_headline_ess_is_the_reference_arithmetic():
    rng = np.random.default_rng(3)
    E, C, Df = 120, 16, 5
    walk = np.cumsum(rng.normal(size=(E, C, Df)), axis=0) * 0.1
    theta = (walk + rng.normal(size=(E, C, Df))).astype(np.float32)
    port = np.median([effective_sample_size(theta.astype(np.float64)[:, :, i])
                      for i in range(Df)])
    ref = np.median([j_ess(theta[:, :, i]) for i in range(Df)])
    assert abs(port - ref) <= 1e-12 * abs(ref)


def test_step_bound_is_the_hand_count():
    """Bt = 8 walkers, 3 components, N = 100 bins, 150 component-bins a
    walker.  Forward float32: 9 x 8 x 150 operations against 4 (100 + 8 x
    100 + 4 x 8 x 3) bytes; backward: 15 x 8 x 150 against 4 (100 + 800 +
    8 x 24) bytes; at this size the bytes bind both.  The likelihood: 24 x
    800 float32 operations and 800 logarithms."""
    f32, mufu, hbm = 67e12, 67e12 / 16, 3.35e12
    fwd = max(9 * 8 * 150 / f32, 4 * (100 + 800 + 96) / hbm)
    bwd = max(15 * 8 * 150 / f32, 4 * (100 + 800 + 192) / hbm)
    lik = 24 * 800 / f32 + 800 / mufu
    assert bench.step_bound_ms(8, 3, 100, 150, "f32") == \
        pytest.approx(1e3 * (fwd + bwd + lik), rel=1e-12)
    # a wide shape, where the operations bind: bf16 counts (4, 5, 2) and
    # (4, 7, 10) float32, packed bf16 and tensor-core operations
    pairs = 768 * 536_675
    fwd16 = pairs * (4 / f32 + 5 / (2 * f32) + 2 / 989e12)
    bwd16 = pairs * (4 / f32 + 7 / (2 * f32) + 10 / 989e12)
    lik = 768 * 40_000 * (24 / f32 + 1 / mufu)
    assert bench.step_bound_ms(768, 54, 40_000, 536_675, "bf16") == \
        pytest.approx(1e3 * (fwd16 + bwd16 + lik), rel=1e-12)


def test_bench_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device"):
        bench.main([])
