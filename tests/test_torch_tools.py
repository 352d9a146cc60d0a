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


_SASS = """
	code for sm_90a
		Function : _Z18lorentz_fwd_kernelILb0ELi4ELb1EEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
        /*0010*/                   MUFU.RCP R2, R3 ;           /* 0x0000000003027308 */
        /*0020*/                   MUFU.RCP R4, R5 ;           /* 0x0000000005047308 */
        /*0030*/              @!P0 BRA 0x10 ;                  /* 0x0000000000008947 */
        /*0040*/                   MUFU.RCP R2, R3 ;           /* 0x0000000003027308 */
        /*0050*/                   STL [R1], R2 ;              /* 0x0000000201007387 */
        /*0060*/                   EXIT ;                      /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                   /* 0xfffffffc00fc7947 */
        /*0080*/                   MUFU.RSQ R2, R3 ;           /* 0x0000000003027308 */
		Function : _Z18lorentz_fwd_kernelILb0ELi4ELb0EEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
        /*0010*/                   MUFU.RCP R2, R3 ;           /* 0x0000000003027308 */
        /*0020*/                   MUFU.RCP R4, R5 ;           /* 0x0000000005047308 */
        /*0030*/              @!P0 BRA 0x10 ;                  /* 0x0000000000008947 */
        /*0040*/                   EXIT ;                      /* 0x000000000000794d */
        /*0050*/                   BRA 0x50;                   /* 0xfffffffc00fc7947 */
"""

_RES_USAGE = """Resource usage:
 Common:
  GLOBAL:0
 Function _Z18lorentz_fwd_kernelILb0ELi4ELb1EEvPKf:
  REG:64 STACK:0 SHARED:31488 LOCAL:0 CONSTANT[0]:532 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_kernel_ab_counts_the_epilogue_in_the_sass():
    """`--sass`: the body ends at its closing self-branch (the slow path's
    subroutine after it is not counted), a loop with two MUFU is listed,
    LDL / STL and the registers are read, and the epilogue is the CHI
    instantiation's body less the same instantiation's without it, per
    (walker, bin) of a thread (4 walkers x 4 bins)."""
    k = kernel_ab._parse_sass(_SASS)
    chi, plain = k["lorentz_fwd_kernel<0,4,1>"], k["lorentz_fwd_kernel<0,4,0>"]
    assert chi["instructions"] == 7 and plain["instructions"] == 5
    assert chi["stl"] == 1 and chi["ldl"] == 0 and plain["stl"] == 0
    assert chi["ops"]["MUFU.RCP"] == 3 and "MUFU.RSQ" not in chi["ops"]
    assert [loop["instructions"] for loop in chi["loops"]] == [3]
    # the code's hash tells two builds of one kernel apart
    assert chi["sha"] != plain["sha"]
    again = kernel_ab._parse_sass(_SASS.replace("_Z18", "_Z18", 1))
    assert again["lorentz_fwd_kernel<0,4,0>"]["sha"] == plain["sha"]
    res = kernel_ab._parse_res_usage(_RES_USAGE)
    assert res == {"lorentz_fwd_kernel<0,4,1>": {
        "registers": 64, "local_bytes": 0, "shared_bytes": 31488}}
    epi = kernel_ab._epilogues(k)
    assert list(epi) == ["lorentz_fwd_kernel<0,4,1>"]
    # the kernels of their own with the epilogue and their siblings
    assert kernel_ab._without_epilogue("lorentz_fwd_chi22p_kernel<4>") == (
        "lorentz_fwd_kernel<0,4>", 4)
    assert kernel_ab._without_epilogue(
        "lorentz_fwd_bf16_chi22p_kernel<1>") == ("lorentz_fwd_bf16_kernel<1>",
                                                  1)
    assert kernel_ab._without_epilogue(
        "lorentz_fwd_f64_chi22p_kernel<2>") == ("lorentz_fwd_f64_kernel<2>",
                                                2)
    assert kernel_ab._without_epilogue("lorentz_fwd_kernel<0,4,0>") is None
    assert kernel_ab._without_epilogue("lorentz_bwd_kernel<0,1>") is None
    assert epi["lorentz_fwd_kernel<0,4,1>"] == {
        "walker_bins": 16, "instructions": 2, "mufu": {"MUFU.RCP": 1},
        "instructions_per_walker_bin": 2 / 16, "mufu_per_walker_bin": 1 / 16}


_SASS_F64 = """
		Function : _Z22lorentz_bwd_f64_kernelPKd
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
        /*0010*/                   MUFU.RCP64H R3, R5 ;        /* 0x0000000003027308 */
        /*0020*/                   DFMA R6, -R4, R2, 1 ;       /* 0x0000000003027309 */
        /*0030*/                   BSSY B0, 0x60 ;             /* 0x0000000003027310 */
        /*0040*/                   DADD R8, R6, R8 ;           /* 0x0000000003027311 */
        /*0050*/              @!P0 CALL.REL.NOINC 0x100 ;      /* 0x0000000003027312 */
        /*0060*/                   MUFU.RCP64H R3, R7 ;        /* 0x0000000003027313 */
        /*0070*/                   DMUL R10, R6, R8 ;          /* 0x0000000003027314 */
        /*0080*/              @!P1 BRA 0x10 ;                  /* 0x0000000000008947 */
        /*0090*/                   EXIT ;                      /* 0x000000000000794d */
        /*00a0*/                   BRA 0xa0;                   /* 0xfffffffc00fc7947 */
"""


def test_kernel_ab_counts_a_float64_loop_per_component_bin():
    """`--sass` on a float64 loop: its component-bins a pass are its
    MUFU.RCP64H estimates (one a component-bin), and beside its
    instructions per component-bin it reads the float64-pipe ones and the
    BSSY and CALL of a reciprocal's slow path."""
    k = kernel_ab._parse_sass(_SASS_F64)
    (loop,) = k["_Z22lorentz_bwd_f64_kernelPKd"]["loops"]
    assert loop["instructions"] == 8 and loop["rcp"] == 2
    assert loop["bssy"] == 1 and loop["call"] == 1 and loop["f64_pipe"] == 3
    assert loop["per_comp_bin"] == 4.0 and loop["f64_pipe_per_comp_bin"] == 1.5
    # a float32 loop counts its MUFU.RCP the same way
    (loop32,) = kernel_ab._parse_sass(_SASS)[
        "lorentz_fwd_kernel<0,4,0>"]["loops"]
    assert loop32["rcp"] == 2 and loop32["per_comp_bin"] == 1.5
    assert loop32["bssy"] == loop32["call"] == loop32["f64_pipe"] == 0


def test_kernel_ab_mufu_floor():
    """One MUFU result per component-bin (and per walker-bin with the
    epilogue) over 16 a clock per SM: 1.126 ms at kepler_full's 1,280
    walkers and 3,682,749 component-bins, above its operations bound."""
    floor = kernel_ab.mufu_floor_ms(1280, 120000, 3682749)
    assert floor == pytest.approx(1280 * 3682749 / (67e12 / 16) * 1e3)
    assert floor == pytest.approx(1.1257, abs=1e-4)
    assert kernel_ab.mufu_floor_ms(1280, 120000, 3682749, chi22p=True) \
        == pytest.approx(floor + 1e3 * 1280 * 120000 / (67e12 / 16))
    from tamcmc_tpu_torch.ops import lorentzian_kernel as K
    assert floor > K.bound_ms("fwd", 1280, 224, 120000, 3682749)[0]


def test_kernel_ab_names_the_backward_loops():
    """`--sass`: the float32 backward's inner loops by components a pass
    (a float4 group of nu and of g a pass: two shared loads for 4 bins)
    and by the clamp (an FMNMX before the reciprocal); a loop with
    shuffles (an item's whole range and reduction) is not one."""
    loops = [
        {"rcp": 8, "ops": {"FFMA": 48, "LDS": 2, "MUFU": 8},
         "instructions": 104, "per_comp_bin": 13.0},
        {"rcp": 8, "ops": {"FMNMX": 8, "LDS": 4, "MUFU": 8},
         "instructions": 145, "per_comp_bin": 18.125},
        {"rcp": 28, "ops": {"LDS": 20, "SHFL": 45, "MUFU": 28},
         "instructions": 721, "per_comp_bin": 25.75}]
    assert kernel_ab.group_loops(loops) == [(2.0, False, 13.0),
                                            (1.0, True, 18.125)]


def test_kernel_ab_unclamped_share_by_the_rule():
    """The share of (walker, component, chunk) ranges that skip the
    reciprocal's clamp, by the rule, over the chunks the launch takes: one
    centre of twelve past 2^62 in x on both of a 1,000-bin grid's chunks."""
    nu = np.linspace(1000.0, 1100.0, 1000, dtype=np.float32)
    rng = np.random.default_rng(0)
    C = rng.uniform(1010, 1090, (4, 3)).astype(np.float32)
    W = np.ones((4, 3), np.float32)
    assert kernel_ab.unclamped_share(nu, C, W, (np.zeros(3),
                                                np.full(3, 1000))) == 1.0
    C[1, 2] = 1e20
    share = kernel_ab.unclamped_share(nu, C, W, (np.zeros(3),
                                                 np.full(3, 1000)))
    assert share == 1 - 2 / 24


def test_kernel_ab_clamp_check_holds_the_plain_version():
    """`check_clamp_path_f32` on the CPU, where both sides are the plain
    version (float32 against float64): NaN exactly where the float64 one
    is, the rest within its tolerance, and the components left as they were
    bit for bit those of a run on unchanged inputs."""
    res = kernel_ab.check_clamp_path_f32(torch.device("cpu"), bt=8, n=4000)
    assert res["nan_where_plain"] and res["unchanged_components_bitwise"]
    assert res["grad_max_rel_err"] < 1e-6
