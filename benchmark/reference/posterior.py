"""The log-posterior of a fit and its gradient, float64 plain torch: the
family's model assembly, the Lorentzian sum in its mode (over each
component's window range, or every bin), the Harvey-like background, the
chi^2 (2 d.o.f.) likelihood, the priors and the family's constraints.

`Target` holds what the benchmark made for a stack of stars (grid,
spectra, start points, prior tables) and derives the window ranges itself
from the start points, by the configuration's window rule.  Nothing here
comes from the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import family, spectrum
from benchmark.reference.priors import NEG_BIG, log_prior


@dataclasses.dataclass
class Target:
    """One configuration's stack of S stars on one grid.

    nu (N,) the grid as the fit sees it; spec (S, N); p0 (S, D) start
    points (the fixed parameters' values); free (D,) bool; kinds (F,);
    hypers (S, F, 2); all float64 (the values the inputs hold)."""
    cfg: dict
    nu: torch.Tensor
    spec: torch.Tensor
    p0: torch.Tensor
    free: np.ndarray
    kinds: list
    hypers: torch.Tensor
    comp_lo: torch.Tensor = None
    comp_hi: torch.Tensor = None

    @property
    def family(self):
        return family(self.cfg["family"])

    def __post_init__(self):
        if self.cfg.get("windows"):
            lo, hi = window_ranges(self.cfg, self.p0.cpu().numpy(),
                                   self.cfg["nu_start"], self.cfg["nu_step"],
                                   self.nu.shape[0])
            self.comp_lo = torch.as_tensor(lo, device=self.nu.device)
            self.comp_hi = torch.as_tensor(hi, device=self.nu.device)

    def embed(self, star, x):
        """Full parameter vectors (k, D) from free ones (k, F) of the stars
        `star` (k,)."""
        full = self.p0[star].clone()
        full[:, torch.as_tensor(self.free, device=x.device)] = x
        return full

    def log_parts(self, star, x):
        """(logL, logP) (k,) of free parameter vectors x (k, F)."""
        full = self.embed(star, x)
        H, C, W, B, noise = self.family.assemble(self.cfg, full)
        model = spectrum.lorentzian_sum(self.nu, H, C, W, B, self.comp_lo,
                                        self.comp_hi) \
            + spectrum.harvey_like(self.nu, noise)
        logL = spectrum.chi22p(self.spec[star], model)
        viol = self.family.constraints(self.cfg, full)
        logP = log_prior(self.kinds, self.hypers[star], x) \
            + torch.clamp(NEG_BIG * viol, min=NEG_BIG)
        return logL, logP

    def log_parts_and_grad(self, star, x):
        """((logL, logP), (dlogL/dx, dlogP/dx)), x (k, F) float64."""
        x = x.detach().requires_grad_(True)
        logL, logP = self.log_parts(star, x)
        gL, = torch.autograd.grad(logL.sum(), x, retain_graph=True)
        gP, = torch.autograd.grad(logP.sum(), x, allow_unused=True)
        if gP is None:
            gP = torch.zeros_like(x)
        return (logL.detach(), logP.detach()), (gL, gP)


def window_ranges(cfg, p0s, nu_start, nu_step, n_bins):
    """Each component's bin range (comp_lo, comp_hi) from the stars' start
    points p0s (S, D): every star's window c -/+ (trunc max(Gamma, 1e-3) +
    margin), their union per component, then the window groups."""
    fam = family(cfg["family"])
    lo = hi = None
    for p0 in np.asarray(p0s, np.float64):
        with torch.no_grad():
            _, C0, W0, _, _ = fam.assemble(cfg, torch.as_tensor(p0))
        s_lo, s_hi = spectrum.window_bounds(C0.numpy(), W0.numpy(),
                                            fam.trunc_of(cfg, p0),
                                            cfg["window_margin"])
        lo = s_lo if lo is None else np.minimum(lo, s_lo)
        hi = s_hi if hi is None else np.maximum(hi, s_hi)
    centers = np.float32(0.5) * (lo + hi)
    halves = np.float32(0.5) * (hi - lo)
    groups = spectrum.window_groups(centers, halves, nu_start, nu_step,
                                    n_bins)
    return spectrum.component_ranges(groups, lo.shape[0])
