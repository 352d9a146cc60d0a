"""The spectrum's plain mathematics in float64: Lorentzian profiles summed
over each component's range of bins, the Harvey-like background, the
chi^2 (2 d.o.f.) likelihood, and the static truncation windows that decide
each component's range.

A frozen copy of the model's equations, written from their published form
(Nigam & Kosovichev 1998 profile; Harvey 1985 background; the c*Gamma
window rule of the reference sampler), plain torch, no kernel.  It imports
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

WIDTH_FLOOR = 1e-6          # Gamma is floored before x = 2 (nu - c) / Gamma
MODEL_FLOOR = 1e-12         # M is floored before ln M and S / M
GROUP_MAX = 64              # components a window group may hold
NEW_GROUP_COST_BINS = 512   # component-bins charged for opening a group


def lorentzian_sum(nu, H, C, W, B, comp_lo=None, comp_hi=None):
    """sum_k H_k [(1 + b_k x)^2 + b_k^2] / (1 + x^2), x = 2 (nu - c_k) /
    max(Gamma_k, 1e-6), each component on its bins [comp_lo, comp_hi) (all
    bins without ranges).  nu (N,), H, C, W, B (..., K) -> (..., N)."""
    n = torch.arange(nu.shape[0], device=nu.device)
    x = 2.0 * (nu - C[..., None]) / torch.clamp(W, min=WIDTH_FLOOR)[..., None]
    b = B[..., None]
    prof = H[..., None] * ((1.0 + b * x) ** 2 + b * b) / (1.0 + x * x)
    if comp_lo is not None:
        inside = (n >= comp_lo[:, None]) & (n < comp_hi[:, None])  # (K, N)
        prof = torch.where(inside, prof, torch.zeros_like(prof))
    return prof.sum(-2)


def harvey_like(nu, noise, n_harvey=3):
    """sum_i A_i / (1 + (B_i nu)^p_i) over the terms with A, B > 0, plus
    max(N0, 0).  noise (..., 3 n_harvey + 1) -> (..., N)."""
    total = torch.zeros(noise.shape[:-1] + nu.shape, dtype=nu.dtype,
                        device=nu.device)
    for k in range(n_harvey):
        A, Bk, p = (noise[..., 3 * k + i, None] for i in range(3))
        on = (A > 0) & (Bk > 0)
        safe = torch.where(on, Bk, torch.ones_like(Bk))
        term = A / (1.0 + (safe * nu) ** p)
        total = total + torch.where(on, term, torch.zeros_like(term))
    return total + torch.clamp(noise[..., 3 * n_harvey, None], min=0.0)


def chi22p(spec, model):
    """-sum_n [ln M_n + S_n / M_n], M floored at 1e-12."""
    m = torch.clamp(model, min=MODEL_FLOOR)
    return -torch.sum(torch.log(m) + spec / m, dim=-1)


def window_groups(centers, halfwidths, nu_start, nu_step, n_bins):
    """The static window groups: components in order of centre, each joining
    the open group while that costs fewer component-bins than opening a new
    one (NEW_GROUP_COST_BINS a group, at most GROUP_MAX components).
    Returns [(component indices, bin_lo, bin_hi)]; each component is summed
    on its group's bins."""
    centers = np.asarray(centers, dtype=np.float64)
    halfwidths = np.asarray(halfwidths, dtype=np.float64)

    def bins(lo_f, hi_f):
        lo = int(np.clip(np.floor((lo_f - nu_start) / nu_step), 0, n_bins))
        hi = int(np.clip(np.ceil((hi_f - nu_start) / nu_step) + 1, 0,
                         n_bins))
        return lo, max(hi, lo)

    groups, cur, cur_lo, cur_hi = [], [], 0.0, 0.0
    for i in np.argsort(centers):
        lo_f, hi_f = centers[i] - halfwidths[i], centers[i] + halfwidths[i]
        if cur:
            u_lo, u_hi = min(cur_lo, lo_f), max(cur_hi, hi_f)
            k = len(cur)
            extend = (k + 1) * (u_hi - u_lo) / nu_step
            split = (k * (cur_hi - cur_lo) + (hi_f - lo_f)) / nu_step \
                + NEW_GROUP_COST_BINS
            if extend <= split and k < GROUP_MAX:
                cur.append(int(i))
                cur_lo, cur_hi = u_lo, u_hi
                continue
            groups.append((tuple(cur),) + bins(cur_lo, cur_hi))
        cur, cur_lo, cur_hi = [int(i)], lo_f, hi_f
    if cur:
        groups.append((tuple(cur),) + bins(cur_lo, cur_hi))
    return groups


def component_ranges(groups, n_comp):
    """(comp_lo, comp_hi) int64 arrays (K,) from window groups; a component
    of an empty group gets an empty range."""
    lo = np.zeros(n_comp, np.int64)
    hi = np.zeros(n_comp, np.int64)
    for idx, glo, ghi in groups:
        lo[list(idx)] = glo
        hi[list(idx)] = max(ghi, glo)
    return lo, hi


def window_bounds(C0, W0, trunc, margin):
    """One star's window [lo, hi] per component, formed in float32 from
    its start point's components: c -/+ (trunc * max(Gamma, 1e-3) +
    margin)."""
    c = np.asarray(C0, np.float32)
    hw = np.float32(trunc) * np.maximum(np.asarray(W0, np.float32),
                                        np.float32(1e-3)) + np.float32(margin)
    return c - hw, c + hw
