"""Parallel tempering: geometric ladder + adjacent-pair swap sweeps.

Port of tamcmc_tpu/sampler/tempering.py (reference
`MALA::parallel_tempering` [U]).  A swap event applies an even/odd-parity
sweep of all adjacent pairs at once, batched over walkers; adaptation
statistics stay with the rung.  A stacked ensemble's state has a leading
star axis, (S, T, C, ...): pairs are formed inside each star.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tamcmc_tpu_torch.sampler.state import SamplerState


def make_beta_ladder(n_temps: int, lambda_temp: float, device=None):
    """beta_k = 1 / lambda^k, k = 0..T-1; beta[0] = 1 is the cold rung."""
    T = lambda_temp ** np.arange(n_temps)
    return torch.as_tensor(1.0 / T, dtype=torch.float32, device=device)


def _partners(n_temps: int, parity: int) -> np.ndarray:
    """Static partner index per rung for an even(0)/odd(1) parity sweep."""
    p = np.arange(n_temps)
    for i in range(parity, n_temps - 1, 2):
        p[i], p[i + 1] = i + 1, i
    return p


@functools.lru_cache(maxsize=64)
def _partner_tables(n_temps: int, parity: int, device):
    """(partner, lower rung of each pair, is_paired, is_low) on `device`."""
    part = _partners(n_temps, parity)
    ar = np.arange(n_temps)
    return tuple(torch.as_tensor(a, device=device) for a in
                 (part, np.minimum(ar, part), part != ar, part == ar + 1))


def tempering_swap(betas, state: SamplerState, parity: int,
                   generator: torch.Generator = None, u=None):
    """One parity sweep of adjacent-pair swaps, batched over walkers.

    parity: host int 0/1.  u: optional (T, C) uniforms ((S, T, C) stacked)
    used instead of drawing from `generator` (the reference's hook)."""
    T, C = state.logL.shape[-2:]
    if T < 2:
        return state
    partner, low, is_paired, is_low = _partner_tables(
        T, int(parity), state.theta.device)

    t_axis = state.logL.ndim - 2           # 1 with a star axis, else 0

    def rungs(x, idx):
        """x's rungs in the order idx along the temperature axis."""
        return torch.index_select(x, t_axis, idx)

    logL_p = rungs(state.logL, partner)
    # pair acceptance (beta_lo - beta_hi)(logL_hi - logL_lo), the same value
    # seen from both members of a pair
    delta = (betas[:, None] - betas[partner][:, None]) * (logL_p - state.logL)
    if u is None:
        u = torch.rand(state.logL.shape, generator=generator,
                       dtype=state.logL.dtype, device=state.logL.device)
    u_pair = rungs(u, low)                 # one uniform per pair
    accept = (torch.log(u_pair + 1e-38) < delta) & is_paired[:, None]
    acc3 = accept[..., None]

    def swapped(x, acc):
        return torch.where(acc, rungs(x, partner), x)

    att = is_low.to(state.nswap_att.dtype)
    # the walker mean as the reference's compiler forms it: the count times
    # float32(1 / C), so the counters agree bit for bit
    accf = accept.to(state.nswap_acc.dtype).sum(dim=-1) * (1.0 / C) * att
    return state.replace(
        theta=swapped(state.theta, acc3),
        logL=swapped(state.logL, accept),
        logP=swapped(state.logP, accept),
        gradL=swapped(state.gradL, acc3),
        gradP=swapped(state.gradP, acc3),
        nswap_att=state.nswap_att + att,
        nswap_acc=state.nswap_acc + accf)
