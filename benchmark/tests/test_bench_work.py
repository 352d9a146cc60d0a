"""The benchmark's frozen work counts against the program's
`lorentzian_kernel.bound_ms` at today's shapes.  They differ only where
the benchmark takes the data sheet's peaks: 34 TFLOP/s float64 (the
program's 33.5) and 132 x 16 x 1.98e9 logarithms/s (the program's
67e12 / 16)."""

import pytest

from benchmark import trace, work

# (walkers, components, bins, component-bins a walker) of the cells
SHAPES = {"kepler_full.stack8": (10240, 224, 120000, 3682749),
          "subgiant_mixed.stack63": (64512, 210, 7576, 210 * 7576),
          "kepler_full.f64.c512": (5120, 224, 120000, 3682749),
          "kepler_full": (1280, 224, 120000, 3682749)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["fwd", "bwd", "fwd_chi22p"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_kernel_bounds_are_the_programs(shape, kind, precision):
    from tamcmc_tpu_torch.ops import lorentzian_kernel as K
    bt, nc, n, cb = SHAPES[shape]
    theirs, _ = K.bound_ms(kind, bt, nc, n, cb, precision=precision)
    ours = work.kernel_bound_ms(kind, bt, nc, n, cb, precision)
    if precision == "f64":
        ours *= work.PEAK_F64 / K.PEAK_F64
        assert ours == pytest.approx(theirs, rel=1e-12)
    else:
        assert ours == pytest.approx(theirs, rel=2e-3)


def test_the_step_bound_is_the_programs():
    from tamcmc_tpu_torch import bench
    bt, nc, n, cb = SHAPES["kepler_full"]
    assert work.step_bound_ms(bt, nc, n, cb, "f32") == pytest.approx(
        bench.step_bound_ms(bt, nc, n, cb, "f32"), rel=2e-3)


def test_union_of_intervals():
    assert trace.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
