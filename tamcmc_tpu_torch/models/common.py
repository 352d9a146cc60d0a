"""Assembly of mode sets into flat component arrays (port of
tamcmc_tpu/models/common.py; reference `io_ms_global.cpp`/`models.cpp` [U]).

Heights and widths are free parameters at the l=0 frequencies; l>0 modes
take them interpolated linearly in frequency (heights scaled by the sampled
visibility V^2_l), and the 2l+1 azimuthal components are weighted by the
inclination visibilities and split by the rotation law: a1-eta-a3 with a
shared or per-degree/per-order a1, the a-coefficients a1..a6, or the odd
a-coefficients with the Alm activity shifts.  Everything is batched over
leading dims: (..., n) blocks -> (..., ncomp) components.
"""

from __future__ import annotations

import numpy as np
import torch

from tamcmc_tpu_torch.ops.alm import alm_shifts, alm_table
from tamcmc_tpu_torch.ops.rotation import (
    centrifugal_shift_aj, split_frequencies_a1etaa3, split_frequencies_aj)
from tamcmc_tpu_torch.ops.visibilities import mode_visibility
from tamcmc_tpu_torch.utils.metrics import span

# np.spacing(np.finfo(f32).eps): below this a knot spacing counts as zero
# (jnp.interp's guard against NaN gradients on coincident knots)
_DX0 = {torch.float32: float(np.spacing(np.finfo(np.float32).eps)),
        torch.float64: float(np.spacing(np.finfo(np.float64).eps))}


def interp_monotonic(x, xp, fp):
    """Linear interpolation with edge clamping, differentiable in x, xp, fp.

    Same arithmetic as jnp.interp: x (..., M), sorted knots xp and values fp
    (..., K) -> (..., M); fp[0] left of xp[0], fp[-1] right of xp[-1].

    The knots and values of each point's interval are picked by a one-hot
    (M, K) product, not by `gather`: several points read one knot, and
    `gather`'s backward on a CUDA device adds them with floating-point
    atomics in an order that varies from run to run (the dense mixed modes
    of the RGB family put a dozen on one knot), while a product and a sum
    have a fixed order.  The forward value is the same number: the knot's
    value plus zeros."""
    K = xp.shape[-1]
    xp_b = xp.expand(x.shape[:-1] + (K,))
    fp_b = fp.expand(x.shape[:-1] + (K,))
    i = torch.searchsorted(xp_b.detach().contiguous(), x.detach().contiguous(),
                           right=True).clamp(1, K - 1)
    knots = torch.arange(K, device=x.device)
    hi = (i[..., None] == knots).to(x.dtype)                 # (..., M, K)
    lo = (i[..., None] - 1 == knots).to(x.dtype)

    def take(v, hot):
        return torch.sum(v[..., None, :] * hot, dim=-1)

    xp_hi, xp_lo = take(xp_b, hi), take(xp_b, lo)
    fp_hi, fp_lo = take(fp_b, hi), take(fp_b, lo)
    dx = xp_hi - xp_lo
    dx0 = torch.abs(dx) <= _DX0[dx.dtype]
    f = torch.where(dx0, fp_lo,
                    fp_lo + ((x - xp_lo) / torch.where(dx0, torch.ones_like(dx),
                                                       dx)) * (fp_hi - fp_lo))
    f = torch.where(x < xp_b[..., :1], fp_b[..., :1], f)
    return torch.where(x > xp_b[..., -1:], fp_b[..., -1:], f)


def _assemble_components(freqs_per_l, heights_l0, widths_l0, visibilities,
                         inc_rad, asym, centres):
    """Flat component arrays (H, C, W, B), each (..., ncomp), for any
    splitting law: `centres(l, fl)` gives degree l's component frequencies
    (..., N_l, 2l+1) from its frequency block fl (..., N_l).

    freqs_per_l: list indexed by l of (..., N_l) frequency blocks (empty
    ones are skipped); visibilities: (..., lmax) V^2 for l=1..lmax; inc_rad,
    asym: (...,)."""
    f0 = freqs_per_l[0]
    hs, cs, ws, bs = [], [], [], []
    for l, fl in enumerate(freqs_per_l):
        if fl.shape[-1] == 0:
            continue
        if l == 0:
            h_l, w_l = heights_l0, widths_l0
        else:
            h_l = interp_monotonic(fl, f0, heights_l0) \
                * visibilities[..., l - 1:l]
            w_l = interp_monotonic(fl, f0, widths_l0)
        eps = mode_visibility(l, inc_rad)                     # (..., 2l+1)
        nus = centres(l, fl)
        H = h_l[..., :, None] * eps[..., None, :]
        W = w_l[..., :, None].expand(nus.shape)
        B = asym[..., None, None].expand(nus.shape)
        for acc, t in ((hs, H), (cs, nus), (ws, W), (bs, B)):
            acc.append(t.reshape(t.shape[:-2] + (-1,)))
    return (torch.cat(hs, -1), torch.cat(cs, -1),
            torch.cat(ws, -1), torch.cat(bs, -1))


def assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                            visibilities, inc_rad, a1_per_l, eta0, a3, asym):
    """The a1-eta-a3 splitting with a per-degree a1 table: a1_per_l is a
    list indexed by l of a1 broadcastable to (..., N_l), a (..., 1) shared
    splitting (a1etaa3, a1l) or (..., N_l) per order (a1n, a1nl); eta0, a3:
    (...,)."""
    return _assemble_components(
        freqs_per_l, heights_l0, widths_l0, visibilities, inc_rad, asym,
        lambda l, fl: split_frequencies_a1etaa3(l, fl, a1_per_l[l], eta0, a3))


def assemble_components_a1etaa3(freqs_per_l, heights_l0, widths_l0,
                                visibilities, inc_rad, a1, eta0, a3, asym):
    """a1etaa3 law: one shared a1 (...,) for every degree (reference
    `model_MS_Global_a1etaa3_*` [U])."""
    return assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                                   visibilities, inc_rad,
                                   [a1[..., None]] * len(freqs_per_l),
                                   eta0, a3, asym)


def assemble_components_aj(freqs_per_l, heights_l0, widths_l0,
                           visibilities, inc_rad, aj, eta0, asym):
    """The general a-coefficient law, aj (..., 6) = a1..a6 per walker, with
    the centrifugal eta0 term (reference `model_MS_Global_aj_*` [U])."""
    a1 = aj[..., 0]
    return _assemble_components(
        freqs_per_l, heights_l0, widths_l0, visibilities, inc_rad, asym,
        lambda l, fl: centrifugal_shift_aj(
            l, split_frequencies_aj(l, fl, aj), eta0, a1))


def assemble_components_ajAlm(freqs_per_l, heights_l0, widths_l0,
                              visibilities, inc_rad, a1, a3, a5, eta0,
                              epsilon, theta0, delta, asym,
                              filter_kind: str = "gate"):
    """Odd a-coefficients (a1, a3, a5), the centrifugal eta0 term and the
    Alm activity shifts on l > 0 (reference `model_MS_Global_ajAlm_*` [U]):
    the even asphericity comes from the activity model, not from fitted
    a2/a4/a6.  The activity filter is evaluated once for all degrees; the
    table and each degree's shifts run in the `alm` span."""
    zero = torch.zeros_like(a1)
    aj = torch.stack([a1, zero, a3, zero, a5, zero], -1)
    with span("alm"):
        table = alm_table(theta0, delta, filter_kind)

    def centres(l, fl):
        nus = centrifugal_shift_aj(l, split_frequencies_aj(l, fl, aj), eta0,
                                   a1)
        if l > 0:
            with span("alm"):
                shift = alm_shifts(l, fl, epsilon, theta0, delta,
                                   kind=filter_kind, table=table)
            nus = nus + shift
        return nus

    return _assemble_components(freqs_per_l, heights_l0, widths_l0,
                                visibilities, inc_rad, asym, centres)


def fixed_noise(layout, fixed):
    """The noise block of a Problem's `fixed` hand-off (params0 (D,), fixed
    mask (D,)), as ops/noise.py noise_background's `const`; None without
    one.  Every model_fn takes `fixed=None` and passes this on, so the
    background terms whose parameters are all fixed are evaluated once per
    call, unbatched and outside autograd."""
    if fixed is None:
        return None
    return tuple(layout.get(a, "noise") for a in fixed)


def dnu_from_freqs(f0):
    """Mean large separation [uHz] from the l=0 ridge (..., N0) -> (...,)."""
    if f0.shape[-1] < 2:
        return torch.full(f0.shape[:-1], 100.0, dtype=f0.dtype,
                          device=f0.device)
    return (f0[..., -1] - f0[..., 0]) / (f0.shape[-1] - 1)
