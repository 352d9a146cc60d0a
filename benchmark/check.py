"""Whether the timed path's answers are correct: a sample of walkers, drawn
from the seed, taken from the state the window left, recomputed by the
float64 reference and compared.

Each walker's answer is what the MALA state carries for it: its position
theta (standardised, x = u_center + u_scale theta), its log-likelihood and
log-prior, and their gradients with respect to theta.  The numbers
compared:

  logpost_gap       the largest |(logL + logP) - reference| over the
                    sample, in nats;
  grad_gap          the largest |d(logL + logP)/dtheta - reference| /
                    |reference| over the sample (vector norms);
  grad_gap_param    per free parameter, the largest |difference| over the
                    sample relative to each walker's |reference|; the
                    median over the parameters;
  stuck_share       the share of the sample whose theta is where it was
                    when the window opened (a step that returns its state
                    unchanged).

A cell compares those its workload file gives a limit.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def sample_walkers(seed, n_walkers, k):
    """k distinct flat walker indices of the (S, T, C) state, from the
    seed."""
    rng = np.random.default_rng([seed, 17])
    return np.sort(rng.choice(n_walkers, size=min(k, n_walkers),
                              replace=False))


def numbers(target, star, answers, start_theta, uc, us, dtype, block):
    """The compared numbers and each walker's gaps.

    star (K,) the walkers' stars; answers {theta, logL, logP, gradL,
    gradP} of the sample (host tensors, the program's type); start_theta
    (K, F) their theta when the window opened; uc, us (S, F) the
    standardisation in the cell's type `dtype` ("f32" | "f64")."""
    dev = target.nu.device
    tdt = DTYPES[dtype]
    theta = answers["theta"].to(dev)
    star_t = torch.as_tensor(star, device=dev)
    uc_t, us_t = (torch.as_tensor(a, device=dev, dtype=tdt) for a in (uc, us))
    x = (uc_t[star_t] + us_t[star_t] * theta.to(tdt)).to(torch.float64)
    lp, grads = [], []
    for lo in range(0, x.shape[0], block):
        sl = slice(lo, lo + block)
        (lL, lP), (gL, gP) = target.log_parts_and_grad(star_t[sl], x[sl])
        lp.append(lL + lP)
        grads.append((gL + gP) * us_t[star_t[sl]].to(torch.float64))
    ref_lp, ref_g = torch.cat(lp).cpu(), torch.cat(grads).cpu()
    prog_lp = (answers["logL"] + answers["logP"]).to(torch.float64)
    prog_g = (answers["gradL"] + answers["gradP"]).to(torch.float64)
    lp_gap = torch.nan_to_num((prog_lp - ref_lp).abs(), nan=np.inf)
    norm = ref_g.norm(dim=-1).clamp(min=1e-300)
    diff = torch.nan_to_num((prog_g - ref_g).abs(), nan=np.inf)
    g_gap = torch.nan_to_num(diff.norm(dim=-1) / norm, nan=np.inf)
    per_param = (diff / norm[:, None]).max(dim=0).values
    stuck = (answers["theta"] == start_theta).all(dim=-1)
    return ({"logpost_gap": float(lp_gap.max()),
             "grad_gap": float(g_gap.max()),
             "grad_gap_param": float(per_param.median()),
             "stuck_share": float(stuck.to(torch.float64).mean())},
            {"logpost_gap": lp_gap, "grad_gap": g_gap, "stuck": stuck})


def judge(values, per_walker, limits):
    """(correct, failed walkers, checks {name: {value, limit}}) against the
    cell's limits; a walker fails on a gap over its limit (one that has
    not moved still carries a correct answer)."""
    checks = {k: {"value": values[k], "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    bad = torch.zeros_like(per_walker["stuck"])
    for k in ("logpost_gap", "grad_gap"):
        if k in limits:
            bad |= per_walker[k] > limits[k]
    return correct, int(bad.sum()), checks
