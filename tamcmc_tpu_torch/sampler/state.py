"""Sampler state and hyperparameters (port of tamcmc_tpu/sampler/state.py;
reference `MALA.h`/`model_def.h` members [U]).

All tempered chains and walkers live on leading tensor axes (T temperatures,
C walkers per temperature, Df free dims).  `theta` and mu/cov/chol/grad*
live in the standardized u-space x = u_center + u_scale * u: in float32 the
proposal increment would otherwise underflow against ulp(theta) at uHz
frequencies (~2.6e-4 at 2200 uHz) and the Robbins-Monro scale death-spirals
(see the reference's state.py).  `step` is a host integer: phase logic
branches on it in Python with no device synchronisation.
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.utils.constants import TARGET_ACCEPTANCE


@dataclasses.dataclass(frozen=True)
class SamplerState:
    theta: torch.Tensor       # (T, C, Df) positions in standardized u-space
    logL: torch.Tensor        # (T, C) untempered log-likelihood
    logP: torch.Tensor        # (T, C) log-prior
    gradL: torch.Tensor       # (T, C, Df) d logL / d theta
    gradP: torch.Tensor       # (T, C, Df) d logP / d theta
    mu: torch.Tensor          # (T, C, Df) adaptive proposal mean
    cov: torch.Tensor         # (T, C, Df, Df) proposal covariance
    chol: torch.Tensor        # (T, C, Df, Df) cholesky(cov + floor + eps I)
    ichol: torch.Tensor       # (T, C, Df, Df) inv(chol), refreshed with it;
                              # zeros in RW mode (never read)
    log_sigma: torch.Tensor   # (T, C) adaptive scale (log)
    step: int                 # global iteration counter (adaptation clock)
    naccept: torch.Tensor     # (T,) accepted proposals (walker mean, summed)
    nprop: torch.Tensor       # () proposals per (t, c) slot
    acc_rate: torch.Tensor    # (T, C) smoothed instantaneous acceptance
    nswap_att: torch.Tensor   # (T,) swap attempts of pair (t, t+1)
    nswap_acc: torch.Tensor   # (T,) accepted swaps of pair (t, t+1)
    scales0: torch.Tensor     # (Df,) initial u-space scales (cov floor)
    u_center: torch.Tensor    # (Df,) physical = u_center + u_scale * theta
    u_scale: torch.Tensor     # (Df,) prior-derived standardization scales

    def replace(self, **kw) -> "SamplerState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MALAHyper:
    """Static hyperparameters of the Atchade (2006) adaptive scheme; the
    reference package's defaults and field meanings (see its state.py)."""
    target_acceptance: float = None   # None -> 0.574 with drift, 0.234 RW
    use_drift: bool = True            # False -> adaptive RW-Metropolis
    cov_estimator: str = "auto"       # "ensemble" | "walker" | "auto"
                                      # (ensemble iff 2*C >= Df)
    cov_floor: float = 1e-4           # cov += floor * diag(scales0^2)
    drift_delta: float = 1000.0       # truncation bound on |grad|
    gain_c0: float = 1.0              # gamma_k = c0 / (k0 + k)^alpha
    gain_k0: float = 10.0
    gain_alpha: float = 0.6
    eps_cov: float = 1e-8             # ridge added before cholesky
    dN_chol: int = 10                 # refresh chol(Sigma) every K adapt steps
    log_sigma_min: float = -15.0      # projection bounds on the scale
    log_sigma_max: float = 4.0
    sigma0_scale: float = 1.0         # initial sigma = 2.38/sqrt(Df) * this
    dN_mixing: int = 10               # tempering swap cadence
    lambda_temp: float = 1.4          # geometric ladder T_k = lambda^k
    acc_smooth: float = 0.02          # EMA factor for reported acceptance
    adapt_ladder: bool = False        # dynamic ladder: not ported (refused)
    sigma_acc_estimator: str = "expected"   # "expected" | "realized"

    def resolved_target(self) -> float:
        if self.target_acceptance is not None:
            return self.target_acceptance
        return 0.574 if self.use_drift else TARGET_ACCEPTANCE

    def resolved_cov_estimator(self, n_chains: int, ndim_free: int) -> str:
        if self.cov_estimator != "auto":
            return self.cov_estimator
        return "ensemble" if 2 * n_chains >= ndim_free else "walker"
