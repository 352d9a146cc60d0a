"""Effective sample size of MCMC draws: the multi-chain estimator of
Vehtari et al. (2021, Bayesian Analysis 16, 667), per-walker FFT
autocovariances combined with the between-walker variance, truncated by
Geyer's (1992) initial positive sequence; ESS = N W / tau.

A frozen copy of the arithmetic of the program's diagnostics/ess.py, so
that a change there does not move the benchmark's ESS.
"""

from __future__ import annotations

import numpy as np


def _acov_1d(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) autocovariance via FFT; shape (n,)."""
    n = x.shape[0]
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def autocorr_time(chain: np.ndarray) -> float:
    """chain: (N,) or (N, W) samples (W walkers of one posterior).
    Returns the multi-chain integrated autocorrelation time tau (>= 1).

    The draws are cast to float64 first."""
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim == 1:
        chain = chain[:, None]
    n, w = chain.shape
    if n < 4:
        return 1.0
    acovs = np.stack([_acov_1d(chain[:, j]) for j in range(w)])   # (W, N)
    # within-chain variance (unbiased) and between-chain variance of means
    Wvar = float(np.mean(acovs[:, 0]) * n / (n - 1))
    if Wvar <= 0:
        return 1.0
    if w > 1:
        Bvar = float(np.var(chain.mean(axis=0), ddof=1))
    else:
        Bvar = 0.0
    var_plus = Wvar * (n - 1) / n + Bvar
    rho = 1.0 - (Wvar - np.mean(acovs, axis=0)) / var_plus      # (N,)
    # Geyer (1992) initial positive sequence: tau = 2*sum(Gamma_m) - 1 with
    # Gamma_m = rho[2m] + rho[2m+1], truncated at the first Gamma_m <= 0.
    npair = n // 2
    gam = rho[0:2 * npair:2] + rho[1:2 * npair:2]
    s = 0.0
    for g in gam:
        if g <= 0:
            break
        s += g
    return max(float(2.0 * s - 1.0), 1.0)


def effective_sample_size(chain: np.ndarray) -> float:
    """chain: (N,) or (N, W). ESS = N*W / tau (multi-chain tau)."""
    if chain.ndim == 1:
        chain = chain[:, None]
    n, w = chain.shape
    return n * w / autocorr_time(chain)
