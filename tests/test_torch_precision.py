"""The port's precisions against the JAX reference: the bf16 profile stream
(`run --precision bf16`) and the f64 validation mode (`--precision f64`).

Inputs are made with numpy from seeds and fed to both packages.  The JAX
bf16 stream is switched on with its process-wide setter and switched back
in a `finally`, as tests/test_ops.py does; its calls here are eager, so no
jit cache holds the other precision.  x64 is enabled only inside
`jax.enable_x64(True)`, which leaves every other test of the worker in
float32.

Tolerances:
  bf16, port against JAX on the CPU: values within 1e-5 x max|value|,
    gradients within 1e-4 x max|gradient| per tensor (both round after each
    bf16 op; the float32 sums run in another order).  The bf16 stream
    itself differs from float32 by ~6e-3 x max here, so a missed branch
    fails.
  f64, port against JAX under x64: logL, logP and both gradients within
    1e-9 relative to their max.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.ops import lorentzian as jl
from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.convert import problem_from_reference
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.ops import lorentzian as tl

torch.set_num_threads(1)

VAL_BF16, GRAD_BF16 = 1e-5, 1e-4
F64 = 1e-9
SMALL = ["--ngrid", "2000", "--n-orders", "2", "--temps", "2", "--chains",
         "4", "--burnin", "20", "--learning", "20", "--acquire", "20",
         "--thin", "5", "--device", "cpu", "--no-report"]


@contextlib.contextmanager
def jax_bf16():
    jl._reset_precision_guard()
    jl.set_profile_precision("bf16")
    try:
        yield
    finally:
        jl._reset_precision_guard()
        jl.set_profile_precision("f32")


def _case(seed=3, bt=3, nc=24, n=4096):
    """tests/test_ops.py's bf16 case, batched over walkers."""
    rng = np.random.default_rng(seed)
    nu = np.linspace(1000.0, 1200.0, n).astype(np.float32)
    H = rng.uniform(1, 10, (bt, nc)).astype(np.float32)
    C = rng.uniform(1010, 1190, (bt, nc)).astype(np.float32)
    W = rng.uniform(0.5, 3.0, (bt, nc)).astype(np.float32)
    B = rng.uniform(-0.05, 0.05, (bt, nc)).astype(np.float32)
    g = rng.normal(size=(bt, n)).astype(np.float32)
    segs = jl.partition_window_groups(jl.make_static_window_groups(
        C[0], 20.0 * W[0] + 2.0, 1000.0, 200.0 / (n - 1), n))
    return nu, (H, C, W, B), g, segs


def _jax(fn, args, g):
    val = np.asarray(fn(*map(jnp.asarray, args)))
    grads = jax.grad(lambda *a: jnp.sum(g * fn(*a)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))
    return val, [np.asarray(x) for x in grads]


def _torch(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _max_rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("form", ["dense", "segments"])
def test_bf16_stream_matches_the_reference(form):
    nu, args, g, segs = _case()
    jnu, tnu = jnp.asarray(nu), torch.as_tensor(nu)
    if form == "dense":
        def j_fn(*a):
            return jax.vmap(lambda *r: jl.sum_lorentzians(jnu, *r))(*a)

        def t_fn(*a, precision="bf16"):
            return tl.sum_lorentzians(tnu, *a, precision=precision)
    else:
        assert len(segs) > 3

        def j_fn(*a):
            return jax.vmap(lambda *r: jl.sum_lorentzians_segments(
                jnu, *r, segs))(*a)

        def t_fn(*a, precision="bf16"):
            return tl.sum_lorentzians_segments(tnu, *a, segs,
                                               precision=precision)
    with jax_bf16():
        want = _jax(j_fn, args, g)
    got = _torch(t_fn, args, g)
    assert _max_rel(got[0], want[0]) <= VAL_BF16
    for a, b in zip(got[1], want[1]):
        assert np.all(np.isfinite(a)) and _max_rel(a, b) <= GRAD_BF16
    # the stream really is bf16: float32 differs by far more than the bound
    f32 = _torch(lambda *a: t_fn(*a, precision="f32"), args, g)
    assert _max_rel(f32[0], want[0]) > 100 * VAL_BF16
    # and the segment pieces the piece-wise likelihood reads agree too
    if form == "segments":
        pieces = tl.segment_values(tnu, *map(torch.as_tensor, args), segs,
                                   precision="bf16")
        with jax_bf16():
            jp = jl.segment_values(jnu, *(jnp.asarray(a[0]) for a in args),
                                   segs)
        for (lo, hi, tv), (jlo, jhi, jv) in zip(pieces, jp):
            assert (lo, hi) == (jlo, jhi)
            np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv),
                                       rtol=0, atol=VAL_BF16 * want[0].max())


def test_precision_is_a_property_of_each_problem():
    """An f32 and a bf16 problem in one process, evaluated in turns: each
    gives its own result, the f32 one bit for bit the f32 build's."""
    problem, _, _, _ = make_demo("ms_global", ngrid=2000, n_orders=2)
    # the bf16 demo's spectrum itself comes from the bf16 stream, as the
    # reference's does; hold both problems to the same data here
    p16 = dataclasses.replace(
        make_demo("ms_global", ngrid=2000, n_orders=2,
                  precision="bf16")[0], spec=problem.spec)
    assert p16.model_meta["precision"] == "bf16"
    assert p16.model_fn._plan.precision == "bf16"
    assert problem.model_fn._plan.precision == "f32"
    assert not torch.equal(make_demo("ms_global", ngrid=2000, n_orders=2,
                                     precision="bf16")[0].spec,
                           problem.spec)
    rng = np.random.default_rng(0)
    x0 = problem.extract(problem.params0)
    x = x0 + 1e-3 * x0.abs() * torch.as_tensor(
        rng.standard_normal((2, 3, x0.shape[0])), dtype=torch.float32)
    a32 = problem.logparts_and_grad(x)
    a16 = p16.logparts_and_grad(x)
    b32 = problem.logparts_and_grad(x)
    b16 = p16.logparts_and_grad(x)
    for u, v in zip(a32[0] + a32[1], b32[0] + b32[1]):
        assert torch.equal(u, v)
    for u, v in zip(a16[0] + a16[1], b16[0] + b16[1]):
        assert torch.equal(u, v)
    assert not torch.equal(a32[0][0], a16[0][0])        # logL
    assert torch.equal(a32[0][1], a16[0][1])            # logP: no profile
    rel = float(((a16[0][0] - a32[0][0]) / a32[0][0]).abs().max())
    assert 0 < rel < 1e-3


def test_f64_problem_matches_the_reference_under_x64():
    jp, _, _, _ = j_make_demo("ms_global", seed=0, ngrid=2000, n_orders=2)
    tp = problem_from_reference(jp).astype(torch.float64)
    assert tp.nu.dtype == tp.spec.dtype == tp.params0.dtype == torch.float64
    rng = np.random.default_rng(0)
    x0 = np.asarray(jp.extract(jp.params0), np.float64)
    x = x0 + 1e-3 * np.abs(x0) * rng.standard_normal((3, x0.shape[0]))
    (tL, tP), (tgL, tgP) = tp.logparts_and_grad(torch.as_tensor(x))
    assert tL.dtype == tgL.dtype == torch.float64
    with jax.enable_x64(True):
        jp64 = jp.astype(jnp.float64)
        want = jax.vmap(jp64.logparts_and_grad)(jnp.asarray(x))
        (jL, jP), (jgL, jgP) = [[np.asarray(a) for a in pair]
                                for pair in want]
    assert jL.dtype == np.float64
    for got, ref in ((tL, jL), (tP, jP), (tgL, jgL), (tgP, jgP)):
        assert _max_rel(got.numpy(), ref) <= F64


def test_run_f64_on_the_cpu_writes_a_double_state(tmp_path):
    out = tmp_path / "fit"
    cli.main(["run", "--demo", "single_lorentzian", "--outdir", str(out),
              "--precision", "f64", "--burnin", "40", "--learning", "80",
              "--acquire", "80", "--thin", "4", "--temps", "2", "--chains",
              "4", "--device", "cpu", "--no-report"])
    z = np.load(out / "restore.npz")
    assert z["state_theta"].dtype == np.float64
    assert z["state_cov"].dtype == np.float64
    assert str(z["meta_precision"]) == "f64"
    assert np.isfinite(z["state_logL"]).all()


@pytest.mark.parametrize("precision", ["f64", "bf16", "f32"])
def test_run_on_cuda_without_a_card_exits_before_any_work(tmp_path,
                                                          monkeypatch,
                                                          precision):
    """Every precision runs on a CUDA device (f64 through the kernels'
    float64 instantiation); where no card is available each one exits with
    the device check's message before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "fit"
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        cli.main(["run", "--demo", "ms_global", "--outdir", str(out),
                  "--precision", precision, "--device", "cuda"])
    assert not out.exists()


def test_bf16_run_and_the_resume_gate(tmp_path):
    """`run --precision bf16` records its precision; a checkpoint of one
    precision refuses a resume in the other (tests/test_cli.py's gate)."""
    f32, bf16 = tmp_path / "f32", tmp_path / "bf16"
    cli.main(["run", "--demo", "ms_global", "--outdir", str(f32), *SMALL])
    cli.main(["run", "--demo", "ms_global", "--outdir", str(bf16), *SMALL,
              "--precision", "bf16"])
    z = np.load(bf16 / "restore.npz")
    assert str(z["meta_precision"]) == "bf16"
    assert np.isfinite(z["state_logL"]).all()
    assert not np.array_equal(z["state_theta"],
                              np.load(f32 / "restore.npz")["state_theta"])
    for outdir, other in ((f32, "bf16"), (bf16, "f32")):
        before = {p.name: p.read_bytes() for p in outdir.iterdir()}
        with pytest.raises(SystemExit, match="precision"):
            cli.main(["run", "--demo", "ms_global", "--outdir", str(outdir),
                      *SMALL, "--resume", "--precision", other])
        assert {p.name: p.read_bytes() for p in outdir.iterdir()} == before
