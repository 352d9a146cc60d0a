"""Assembly of mode sets into flat component arrays (port of
tamcmc_tpu/models/common.py; reference `io_ms_global.cpp`/`models.cpp` [U]).

Heights and widths are free parameters at the l=0 frequencies; l>0 modes
take them interpolated linearly in frequency (heights scaled by the sampled
visibility V^2_l), and the 2l+1 azimuthal components are weighted by the
inclination visibilities and split by the rotation law.  Everything is
batched over leading dims: (..., n) blocks -> (..., ncomp) components.
"""

from __future__ import annotations

import numpy as np
import torch

from tamcmc_tpu_torch.ops.rotation import split_frequencies_a1etaa3
from tamcmc_tpu_torch.ops.visibilities import mode_visibility

# np.spacing(np.finfo(f32).eps): below this a knot spacing counts as zero
# (jnp.interp's guard against NaN gradients on coincident knots)
_DX0 = {torch.float32: float(np.spacing(np.finfo(np.float32).eps)),
        torch.float64: float(np.spacing(np.finfo(np.float64).eps))}


def interp_monotonic(x, xp, fp):
    """Linear interpolation with edge clamping, differentiable in x, xp, fp.

    Same arithmetic as jnp.interp: x (..., M), sorted knots xp and values fp
    (..., K) -> (..., M); fp[0] left of xp[0], fp[-1] right of xp[-1]."""
    K = xp.shape[-1]
    xp_b = xp.expand(x.shape[:-1] + (K,))
    fp_b = fp.expand(x.shape[:-1] + (K,))
    i = torch.searchsorted(xp_b.detach().contiguous(), x.detach().contiguous(),
                           right=True).clamp(1, K - 1)
    xp_hi, xp_lo = xp_b.gather(-1, i), xp_b.gather(-1, i - 1)
    fp_hi, fp_lo = fp_b.gather(-1, i), fp_b.gather(-1, i - 1)
    dx = xp_hi - xp_lo
    dx0 = torch.abs(dx) <= _DX0[dx.dtype]
    f = torch.where(dx0, fp_lo,
                    fp_lo + ((x - xp_lo) / torch.where(dx0, torch.ones_like(dx),
                                                       dx)) * (fp_hi - fp_lo))
    f = torch.where(x < xp_b[..., :1], fp_b[..., :1], f)
    return torch.where(x > xp_b[..., -1:], fp_b[..., -1:], f)


def assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                            visibilities, inc_rad, a1_per_l, eta0, a3, asym):
    """Flat component arrays (H, C, W, B), each (..., ncomp), under the
    a1-eta-a3 splitting with a per-degree a1 table.

    freqs_per_l: list indexed by l of (..., N_l) frequency blocks;
    visibilities: (..., lmax) V^2 for l=1..lmax; a1_per_l: list indexed by l
    of a1 broadcastable to (..., N_l); inc_rad, eta0, a3, asym: (...,)."""
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
        nus = split_frequencies_a1etaa3(l, fl, a1_per_l[l], eta0, a3)
        H = h_l[..., :, None] * eps[..., None, :]
        W = w_l[..., :, None].expand(nus.shape)
        B = asym[..., None, None].expand(nus.shape)
        for acc, t in ((hs, H), (cs, nus), (ws, W), (bs, B)):
            acc.append(t.reshape(t.shape[:-2] + (-1,)))
    return (torch.cat(hs, -1), torch.cat(cs, -1),
            torch.cat(ws, -1), torch.cat(bs, -1))


def assemble_components_a1etaa3(freqs_per_l, heights_l0, widths_l0,
                                visibilities, inc_rad, a1, eta0, a3, asym):
    """a1etaa3 law: one shared a1 (...,) for every degree (reference
    `model_MS_Global_a1etaa3_*` [U])."""
    return assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                                   visibilities, inc_rad,
                                   [a1[..., None]] * len(freqs_per_l),
                                   eta0, a3, asym)


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
