"""Prior densities and linear interpolation, float64 plain torch.

A parameter's prior is one of: fix (no density), uniform [lo, hi], gaussian
(mu, sigma), jeffreys (knee, max): p(x) = 1 / ((x + knee) ln(1 + max /
knee)) on [0, max].  Outside its support a density scores NEG_BIG, and a
violated cross-parameter constraint scores NEG_BIG once per violation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_BIG = -1e30


def log_prior(kinds, hypers, x):
    """Sum of the log-densities of the free parameters x (..., F); kinds
    (F,) strings, hypers (..., F, 2) float64 broadcast against x."""
    h0, h1 = hypers[..., 0], hypers[..., 1]
    k = np.asarray(kinds)
    uni = torch.as_tensor(k == "uniform", device=x.device)
    gau = torch.as_tensor(k == "gaussian", device=x.device)
    jef = torch.as_tensor(k == "jeffreys", device=x.device)
    known = {"uniform", "gaussian", "jeffreys"}
    if not bool((uni | gau | jef).all()):
        raise ValueError(f"free parameters of unknown prior kinds: "
                         f"{sorted(set(k) - known)}")
    one = torch.ones_like(x)
    lo_u, hi_u = torch.where(uni, h0, 0 * one), torch.where(uni, h1, one)
    lp_u = torch.where((x >= lo_u) & (x <= hi_u), -torch.log(hi_u - lo_u),
                       NEG_BIG * one)
    mu, sig = torch.where(gau, h0, 0 * one), torch.where(gau, h1, one)
    lp_g = -0.5 * ((x - mu) / sig) ** 2 \
        - torch.log(sig * math.sqrt(2 * math.pi))
    knee = torch.where(jef, h0, one)
    top = torch.maximum(torch.where(jef, h1, one), knee)
    inside = (x >= 0) & (x <= top)
    xs = torch.where(inside, x, 0 * one)
    lp_j = torch.where(inside, -torch.log(xs + knee)
                       - torch.log(torch.log1p(top / knee)), NEG_BIG * one)
    lp = torch.where(uni, lp_u, torch.where(gau, lp_g, lp_j))
    return torch.clamp(lp.sum(-1), min=NEG_BIG)


def interp(x, xp, fp):
    """Linear interpolation of (xp, fp) at x, held at the end values outside
    [xp[0], xp[-1]]; x (..., M), xp and fp (..., K), xp ascending."""
    K = xp.shape[-1]
    xpb = xp.expand(x.shape[:-1] + (K,)).contiguous()
    fpb = fp.expand(x.shape[:-1] + (K,))
    i = torch.searchsorted(xpb.detach(), x.detach().contiguous(),
                           right=True).clamp(1, K - 1)
    x0, x1 = xpb.gather(-1, i - 1), xpb.gather(-1, i)
    f0, f1 = fpb.gather(-1, i - 1), fpb.gather(-1, i)
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xpb[..., :1], fpb[..., :1], f)
    return torch.where(x > xpb[..., -1:], fpb[..., -1:], f)
