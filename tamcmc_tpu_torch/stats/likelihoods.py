"""Spectral likelihoods (port of tamcmc_tpu/stats/likelihoods.py; reference
`likelihoods.cpp` [U]).

chi^2 with 2 d.o.f. (raw periodogram):  logL = -sum_i [ln M_i + S_i / M_i]
Gaussian chi^2 (averaged spectra):      logL = -0.5 sum_i ((S_i - M_i)/s_i)^2
Reductions run over the last axis, batched over leading dims.
"""

import torch


def likelihood_chi22p(spec, model, mask=None):
    """chi^2(2 d.o.f.) log-likelihood; the model is floored at 1e-12 so log
    and gradient stay finite when a proposal wanders to zero power."""
    m = torch.clamp(model, min=1e-12)
    terms = torch.log(m) + spec / m
    if mask is not None:
        terms = terms * mask
    return -torch.sum(terms, dim=-1)


def likelihood_chi_square(spec, model, sigma, mask=None):
    """Gaussian log-likelihood for averaged spectra with per-bin sigma."""
    s = torch.clamp(sigma, min=1e-12)
    terms = ((spec - model) / s) ** 2
    if mask is not None:
        terms = terms * mask
    return -0.5 * torch.sum(terms, dim=-1)


def likelihood_chi22p_pieces(spec, segments, bg_fn):
    """chi^2(2 d.o.f.) log-likelihood over a static window partition.

    segments: [(lo, hi, seg_values (..., hi-lo))], disjoint and sorted (the
    `_segments_and_bg` hook of a window-partitioned model); bg_fn(lo, hi)
    evaluates the background on bins [lo, hi).  Quiet bins between pieces
    hold the background alone.  Equal to likelihood_chi22p(spec,
    concat(pieces) + bg) up to f32 reassociation.

    Eager torch pays one launch per op and per piece, so the pieces are
    joined (zero-filled gaps) and the background evaluated once over the
    grid: one reduction pass instead of one per piece."""
    N = spec.shape[-1]
    pos = 0
    parts = []
    for lo, hi, seg in segments:
        # host-side invariant check on the static bounds: raw OVERLAPPING
        # window groups would double-count overlap bins and miscount gaps
        if lo < pos or hi > N:
            raise ValueError(
                f"segment [{lo}, {hi}) violates the sorted-disjoint "
                f"partition invariant (previous end {pos}, grid size {N}); "
                "pass partition_window_groups output, not raw window groups")
        if lo > pos:
            parts.append((pos, lo))
        parts.append(seg)
        pos = hi
    bg = bg_fn(0, N)
    if not segments:
        return likelihood_chi22p(spec, bg)
    lead = segments[0][2].shape[:-1]
    if pos < N:
        parts.append((pos, N))
    modes = torch.cat([p if torch.is_tensor(p)
                       else spec.new_zeros(lead + (p[1] - p[0],))
                       for p in parts], dim=-1)
    return likelihood_chi22p(spec, modes + bg)


_REGISTRY = {
    "chi22p": likelihood_chi22p,
    "chi(2,2p)": likelihood_chi22p,
    "chi_square": likelihood_chi_square,
}


def get_likelihood(name: str):
    key = name.strip().lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown likelihood '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]
