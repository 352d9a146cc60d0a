"""Mode-width relation of Appourchaux et al. (2016, A&A 595, C2), port of
tamcmc_tpu/ops/widths.py (reference `model_*_AppWidth_*` families [U]):

    ln Gamma(nu) = alpha ln(nu/numax) + ln(Gamma_alpha)
                   - ln(dGamma_dip) / (1 + (2 ln(nu/nu_dip) / ln(W_dip/numax))^2)

a power law in nu with a Lorentzian-in-log-frequency dip of depth
dGamma_dip near nu_dip and log-width set by W_dip.
"""

from __future__ import annotations

import torch


def appourchaux2016_width(nu, numax, alpha, gamma_alpha, dgamma_dip,
                          nu_dip, w_dip):
    """Gamma(nu) [uHz]; nu (..., n), parameters broadcastable to it (pass
    (..., 1) per-walker parameters).  Parameters are clipped away from the
    singular points, as in the reference."""
    numax = torch.clamp(numax, min=1e-3)
    nu_dip = torch.clamp(nu_dip, min=1e-3)
    gamma_alpha = torch.clamp(gamma_alpha, min=1e-6)
    dgamma_dip = torch.clamp(dgamma_dip, min=1.0 + 1e-6)
    w_dip = torch.clamp(w_dip, min=1e-3)
    nu = torch.clamp(nu, min=1e-3)

    log_ratio = torch.log(nu / numax)
    denom_log = torch.log(w_dip / numax)
    # keep |ln(W_dip/numax)| away from 0 (dip width degenerate with numax)
    denom_log = torch.where(
        torch.abs(denom_log) < 1e-3,
        torch.where(denom_log < 0, torch.full_like(denom_log, -1e-3),
                    torch.full_like(denom_log, 1e-3)),
        denom_log)
    dip = torch.log(dgamma_dip) / (1.0 + (2.0 * torch.log(nu / nu_dip)
                                          / denom_log) ** 2)
    return torch.exp(alpha * log_ratio + torch.log(gamma_alpha) - dip)
