"""ARMM: asymptotic mixed-mode solver for the l=1 modes of evolved stars
(port of tamcmc_tpu/ops/armm.py; reference `external/ARMM/solver_mm.cpp`,
`bump_DP.cpp` [U]).

The p/g coupling eigenvalue condition (Mosser et al. 2012, A&A 540, A143)

    tan(theta_p) = q * tan(theta_g)
    theta_p = pi * (nu / Dnu - eps_p)
    theta_g = pi * (1e6 / (DPi1 * nu) - eps_g)      [nu in uHz, DPi1 in s]

has exactly one root between two consecutive poles of either tangent, where
f = tan(theta_p) - q tan(theta_g) sweeps -inf -> +inf.  The solver builds
static-size padded pole arrays, sorts them, and runs a fixed-count
bisection on every interval: no data-dependent shapes, no convergence test.

Unlike the reference (one star, vmapped by the caller), every function here
is batched over the leading dims of its tensor arguments: scalars per walker
(...,) -> (..., n_p_poles + n_g_poles - 1) per mode.  Gradients flow, as in
JAX, through the bracket ends (the poles) and the closed forms, never
through the bisection's `f > 0` decisions.

The bisection is routed by device: CUDA tensors run the hand-written kernel
pair (ops/armm_kernel.py, csrc/armm.cu), which gives the plain loop's roots
and gradients bit for bit; every other tensor runs `bisect_plain`.
"""

from __future__ import annotations

import math

import torch

from tamcmc_tpu_torch.ops import armm_kernel


def _rdiv(c: float, t):
    """c / t as a true division (python-scalar / tensor would be a
    reciprocal-multiply in torch, one rounding off the reference's)."""
    return torch.full_like(t, c) / t


def _theta_p(nu, dnu, eps_p, delta0l=0.0, alpha_p=0.0, nmax_x=0.0):
    """p-mode phase with the O(2) asymptotic relation (bump_DP depth [U]):
    theta_p = pi (x - eps_p - delta0l/Dnu - alpha_p/2 (x - n_max)^2),
    x = nu / Dnu."""
    x = nu / dnu
    return math.pi * (x - eps_p - delta0l / dnu
                      - 0.5 * alpha_p * (x - nmax_x) ** 2)


def _theta_g(nu, dpi1, eps_g, alpha_g=0.0, pi0_x=0.0):
    """g-mode phase with period-spacing curvature [U]:
    theta_g = pi (y - eps_g - alpha_g/2 (y - y0)^2),  y = 1e6 / (DPi1 nu)."""
    y = _rdiv(1e6, dpi1 * nu)
    return math.pi * (y - eps_g - 0.5 * alpha_g * (y - pi0_x) ** 2)


def _f(nu, dnu, eps_p, dpi1, eps_g, q, delta0l=0.0, alpha_p=0.0,
       nmax_x=0.0, alpha_g=0.0, pi0_x=0.0):
    return (torch.tan(_theta_p(nu, dnu, eps_p, delta0l, alpha_p, nmax_x))
            - q * torch.tan(_theta_g(nu, dpi1, eps_g, alpha_g, pi0_x)))


def bisect_plain(lo, hi, n_bisect, *walker, decisions=None):
    """n_bisect halvings of every bracket [lo, hi] (..., S) toward the
    sign change of `_f`, whose walker scalars `walker` (the order of
    armm_kernel.ROW, each (..., 1)) follow nu; returns the midpoints
    (..., S).  The plain version of the kernel pair: CPU tensors run it,
    and the tests hold the kernels to it.  `decisions`, a list, gets each
    halving's `f > 0`."""
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        pos = _f(mid, *walker) > 0
        if decisions is not None:
            decisions.append(pos)
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    return 0.5 * (lo + hi)


def _bisect(lo, hi, n_bisect, *walker):
    """The bisection of `mixed_mode_frequencies`: the kernel pair for CUDA
    tensors (it raises rather than fall back), `bisect_plain` otherwise."""
    if lo.device.type == "cuda":
        return armm_kernel.bisect(lo, hi, n_bisect, *walker)
    return bisect_plain(lo, hi, n_bisect, *walker)


def mixed_mode_frequencies(dnu, eps_p, dpi1, eps_g, q, numin, numax,
                           n_p_poles: int, n_g_poles: int, n_bisect: int = 45,
                           delta0l=0.0, alpha_p=0.0, alpha_g=0.0):
    """All l=1 mixed-mode frequencies in [numin, numax].

    dnu [uHz]: a tensor (...,); eps_p, dpi1 [s], eps_g, q and the O(2)
    terms delta0l [uHz], alpha_p, alpha_g: tensors or floats broadcastable
    to it.  numin/numax: floats; n_p_poles/n_g_poles: static pole-count
    pads (`count_poles`).  Returns (freqs, zeta, valid), each (...,
    n_p_poles + n_g_poles - 1); invalid (padded) slots hold freq = numax,
    zeta = 0, valid = 0.
    """
    kw = {"dtype": dnu.dtype, "device": dnu.device}
    args = torch.broadcast_tensors(*(torch.as_tensor(a, **kw) for a in (
        dnu, eps_p, dpi1, eps_g, q, delta0l, alpha_p, alpha_g)))
    dnu, eps_p, dpi1, eps_g, q, delta0l, alpha_p, alpha_g = (
        a[..., None] for a in args)

    nmax_x = _rdiv(0.5 * (numin + numax), dnu)        # curvature pivot (order)
    pi0_x = _rdiv(1e6, dpi1 * (0.5 * (numin + numax)))  # pivot (period)

    # p-mode tangent poles theta_p = pi (k + 1/2); with curvature the pole
    # equation is quadratic in x: 3 fixed-point sweeps from the linear pole
    ar_p = torch.arange(n_p_poles, **kw)
    k0p = torch.floor(_rdiv(numin, dnu) - 0.5 - eps_p - delta0l / dnu)
    kp = k0p + ar_p
    xp = kp + 0.5 + eps_p + delta0l / dnu
    for _ in range(3):
        xp = kp + 0.5 + eps_p + delta0l / dnu \
            + 0.5 * alpha_p * (xp - nmax_x) ** 2
    p_poles = dnu * xp
    # g-mode tangent poles theta_g = pi (k + 1/2), same fixed point in y
    ar_g = torch.arange(n_g_poles, **kw)
    k0g = torch.floor(_rdiv(1e6, dpi1 * numax) - 0.5 - eps_g)
    kg = k0g + ar_g
    yg = kg + 0.5 + eps_g
    for _ in range(3):
        yg = kg + 0.5 + eps_g + 0.5 * alpha_g * (yg - pi0_x) ** 2
    g_poles = _rdiv(1e6, dpi1 * yg)

    poles = torch.cat([p_poles, g_poles], dim=-1)
    poles = torch.sort(torch.clamp(poles, numin, numax), dim=-1).values

    a, b = poles[..., :-1], poles[..., 1:]
    width = b - a
    valid = width > 1e-4                     # collapsed (clamped) intervals
    eps = torch.clamp(width * 1e-3, min=1e-6)
    freqs = _bisect(a + eps, b - eps, n_bisect, dnu, eps_p, dpi1, eps_g, q,
                    delta0l, alpha_p, nmax_x, alpha_g, pi0_x)

    # window-edge intervals are truncated by the clamp and need not bracket
    # a root: validate every root on the well-conditioned phase form
    tp_r = _theta_p(freqs, dnu, eps_p, delta0l, alpha_p, nmax_x)
    tg_r = _theta_g(freqs, dpi1, eps_g, alpha_g, pi0_x)
    phase_res = torch.remainder(
        tp_r - torch.atan(q * torch.tan(tg_r)) + math.pi / 2,
        math.pi) - math.pi / 2
    valid = valid & (torch.abs(phase_res) < 0.05)

    denom = q ** 2 * torch.cos(tg_r) ** 2 + torch.sin(tg_r) ** 2
    # nu_Hz^2 DPi1_s / Dnu_Hz = nu_uHz^2 * 1e-6 * DPi1 / Dnu_uHz
    zeta = _rdiv(1.0, 1.0 + (freqs ** 2 * 1e-6) * dpi1 / dnu
                 * q / torch.clamp(denom, min=1e-12))

    freqs = torch.where(valid, freqs, torch.full_like(freqs, numax))
    zeta = torch.where(valid, zeta, torch.zeros_like(zeta))
    return freqs, zeta, valid.to(freqs.dtype)


def count_poles(dnu, dpi1, eps_p, eps_g, numin, numax, margin: int = 4):
    """Host-side static pole-count bounds for a window, from reference
    values of (dnu, dpi1), with `margin` slack for the prior's wander."""
    n_p = int(math.ceil((numax - numin) / dnu)) + margin
    n_g = int(math.ceil(1e6 / dpi1 * (1.0 / numin - 1.0 / numax))) + margin
    return n_p, n_g
