"""The step's counted work on the card: `step_bound_ms`, the least time a
step of the fused likelihood needs on an H100 (the counterpart of the
reference bench.py's speed of light), from both Lorentzian kernels'
`lorentzian_kernel.bound_ms` and the likelihood's own operations.

The module keeps this name only because benchmark/tests/test_bench_work.py
anchors the benchmark's `work.step_bound_ms` to this function, until a change
to the benchmark moves that anchor; the benchmark (`benchmark/run.py`)
measures the step.
"""

from __future__ import annotations

from tamcmc_tpu_torch.ops import lorentzian_kernel as K

# The likelihood's work per (bin, walker), the reference's count
# (bench.py:234-239): 24 float32 operations forward and backward, and one
# logarithm, which runs on the special-function units.
LIKELIHOOD_OPS = 24
LOGS = 1


def step_bound_ms(walkers, ncomp, n_bins, comp_bins, precision) -> float:
    """Least ms the step's counted work needs on an H100: both kernels'
    bound at Bt = walkers (all rungs), the likelihood's LIKELIHOOD_OPS
    float32 operations per (bin, walker) over PEAK_F32 and its LOGS
    logarithms over the MUFU rate."""
    kernels = sum(K.bound_ms(kind, walkers, ncomp, n_bins, comp_bins,
                             precision=precision)[0]
                  for kind in ("fwd", "bwd"))
    return kernels + 1e3 * walkers * n_bins * (LIKELIHOOD_OPS / K.PEAK_F32
                                               + LOGS / K.PEAK_MUFU)
