"""The step's counted work (tamcmc_tpu_torch/bench.py `step_bound_ms`)
against a hand count, and the port's ESS against the reference's, the
arithmetic of the headline ESS/s."""

import numpy as np
import pytest

from tamcmc_tpu.diagnostics.ess import effective_sample_size as j_ess
from tamcmc_tpu_torch import bench
from tamcmc_tpu_torch.diagnostics.ess import effective_sample_size


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

