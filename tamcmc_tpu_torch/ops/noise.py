"""Granulation / activity noise-background models (port of
tamcmc_tpu/ops/noise.py; reference `noise_models.cpp` [U]).

  harvey_like : N(nu) = A / (1 + (B * nu)^p)          per component
  harvey_1985 : N(nu) = A tc / (1 + (2 pi nu tc 1e-3)^p)
Negative/zero (A, B) components are "absent" (contribute 0), the reference's
-1 placeholder convention.  Parameters broadcast against the grid: pass
(..., 1) parameters and an (n,) grid for a (..., n) result.
"""

import math

import torch


def harvey_like(nu, A, B, p):
    """One Harvey-like component A/(1 + (B*nu)^p); A [ppm^2/uHz], B [1/uHz]."""
    active = (A > 0) & (B > 0)
    safe_B = torch.where(active, B, torch.ones_like(B))
    val = A / (1.0 + (safe_B * nu) ** p)
    return torch.where(active, val, torch.zeros_like(val))


def harvey_1985(nu, A, tc, p):
    """Classic Harvey (1985) profile A*tc/(1 + (2*pi*nu*tc*1e-3)^p)."""
    active = (A > 0) & (tc > 0)
    safe_tc = torch.where(active, tc, torch.ones_like(tc))
    val = A * safe_tc / (1.0 + (2.0 * math.pi * nu * safe_tc * 1e-3) ** p)
    return torch.where(active, val, torch.zeros_like(val))


def kallinger2014(nu, noise_params, nu_nyquist):
    """Kallinger et al. (2014, A&A 570, A41) granulation background: two
    slope-4 super-Lorentzians, each normalised to its rms amplitude squared,
    apodised by the sinc^2 sampling response, plus white noise:

        N(nu) = eta^2(nu) sum_i xi a_i^2 / b_i / (1 + (nu/b_i)^4) + W
        eta(nu) = sinc(pi/2 nu/nu_nyq),   xi = 2 sqrt(2) / pi

    noise_params: (..., 5) = [a1, b1, a2, b2, W] (a in ppm, b in uHz) ->
    (..., n)."""
    xi = 2.0 * math.sqrt(2.0) / math.pi
    eta2 = torch.sinc(0.5 * nu / nu_nyquist) ** 2   # sinc(x) = sin(pi x)/(pi x)
    total = torch.zeros_like(nu)
    for k in range(2):
        a = noise_params[..., 2 * k, None]
        b = noise_params[..., 2 * k + 1, None]
        active = (a > 0) & (b > 0)
        safe_b = torch.where(active, b, torch.ones_like(b))
        comp = xi * a ** 2 / safe_b / (1.0 + (nu / safe_b) ** 4)
        total = total + torch.where(active, comp, torch.zeros_like(comp))
    return eta2 * total + torch.clamp(noise_params[..., 4, None], min=0.0)


def _background_terms(nu, noise_params, n_harvey, kind, const):
    """(Harvey sum, clamped white level, whether every Harvey term and
    whether the white level were read from `const`)."""
    fn = harvey_like if kind == "harvey_like" else harvey_1985

    def fixed(lo, hi):
        return const is not None and bool(const[1][lo:hi].all())

    def block(lo, hi):
        if fixed(lo, hi):
            return const[0][..., lo:hi].detach()
        return noise_params[..., lo:hi]

    total = torch.zeros_like(nu)
    for k in range(n_harvey):
        A, B, p = (v[..., None] for v in block(3 * k, 3 * k + 3).unbind(-1))
        total = total + fn(nu, A, B, p)
    white = torch.clamp(block(3 * n_harvey, 3 * n_harvey + 1), min=0.0)
    harvey_fixed = all(fixed(3 * k, 3 * k + 3) for k in range(n_harvey))
    return total, white, harvey_fixed, fixed(3 * n_harvey, 3 * n_harvey + 1)


def noise_background(nu, noise_params, n_harvey: int = 3,
                     kind: str = "harvey_like", const=None):
    """n_harvey components + white noise on grid nu (n,).

    noise_params: (..., 3*n_harvey + 1) = [A1,B1,p1, ..., N0] -> (..., n).

    const: optional (noise0 (3*n_harvey + 1,), fixed (3*n_harvey + 1,) bool).
    A Harvey component whose A, B and p are all fixed, and a fixed white
    level, are read from noise0 instead: they depend on no walker, so they
    are evaluated once, unbatched and outside autograd (once per star where
    noise0 has a leading star axis, (S, 1, 1, 3*n_harvey + 1)).  The
    values, and the order of the sum, are those of the batched
    evaluation."""
    total, white, _, _ = _background_terms(nu, noise_params, n_harvey, kind,
                                           const)
    return total + white


def noise_background_parts(nu, noise_params, n_harvey: int = 3,
                           kind: str = "harvey_like", const=None):
    """noise_background as (shared, per_walker), the fused likelihood's
    bg_n and bg_b: shared + per_walker is its value, the same sum in the
    same order.  With every Harvey term read from `const`, shared is their
    sum ((n,), or a row per star) and per_walker the white level (..., 1),
    or shared the whole background and per_walker None when the white
    level is fixed too; with a free Harvey term, shared is None and
    per_walker the whole (..., n) background."""
    total, white, harvey_fixed, white_fixed = _background_terms(
        nu, noise_params, n_harvey, kind, const)
    if not harvey_fixed:
        return None, total + white
    if white_fixed:
        return total + white, None
    return total, white
