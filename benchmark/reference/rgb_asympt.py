"""Evolved-star fit with mixed modes (`model_RGB_asympt_a1etaa3_HarveyLike`)
in float64 plain torch.

l = 0 and l = 2 p modes are free; the l = 1 mixed modes are the roots of
the asymptotic coupling condition tan(theta_p) = q tan(theta_g) (Mosser et
al. 2012, A&A 540, A143) in the window [numin, numax], found by bisection
between the sorted poles of the two tangents (45 halvings each).  Each
mixed mode takes the interpolated p-mode height (times V^2_1) and width
times (1 - zeta), the width floored at 0.005 uHz, and the splitting
zeta a1_core / 2 + (1 - zeta) a1_env, zeta the mode's g-mode inertia
share.  Dnu and eps_p for the condition come from a least-squares line
through the l = 0 frequencies against radial order.

Also the configuration's synthetic star: its truth, its priors and its
start point, drawn from a seed.

Parameter vector: heights (n), visibilities [V^2_1, V^2_2], freq_l0 (n),
freq_l2 (n), mixed [DPi1, eps_g, q, delta0l, alpha_p, alpha_g],
rot [a1_env, a1_core, asym], widths (n), noise (10), inclination, trunc.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.ms_global import visibility
from benchmark.reference.priors import interp

N_BISECT = 45
WIDTH_MIN = 0.005
# the CPU cut of the tests: the window on 1,500 bins
SMALL = {"n_bins": 1500}


def pole_counts(cfg):
    """Pole slots of the two tangents in the window, each with 4 spare."""
    lo, hi = cfg["numin"], cfg["numax_win"]
    n_p = int(math.ceil((hi - lo) / cfg["dnu"])) + 4
    n_g = int(math.ceil(1e6 / cfg["dpi1"] * (1.0 / lo - 1.0 / hi))) + 4
    return n_p, n_g


def spec_kwargs(cfg):
    """The problem file's [spec] block."""
    n_p, n_g = pole_counts(cfg)
    return {"n_orders": cfg["n_orders"], "numin": float(cfg["numin"]),
            "numax_win": float(cfg["numax_win"]), "n_p_poles": n_p,
            "n_g_poles": n_g}


def blocks(cfg):
    n = cfg["n_orders"]
    return [("heights", n), ("visibilities", 2), ("freq_l0", n),
            ("freq_l2", n), ("mixed", 6), ("rot", 3), ("widths", n),
            ("noise", 10), ("inclination", 1), ("trunc", 1)]


def n_components(cfg):
    n_p, n_g = pole_counts(cfg)
    return cfg["n_orders"] * 6 + 3 * (n_p + n_g - 1)


def _offsets(cfg):
    off, o = {}, 0
    for name, size in blocks(cfg):
        off[name] = (o, size)
        o += size
    return off


def _get(p, off, name):
    o, s = off[name]
    return p[..., o:o + s]


def _theta_p(nu, dnu, eps_p, d0l, a_p, nmax_x):
    x = nu / dnu
    return math.pi * (x - eps_p - d0l / dnu - 0.5 * a_p * (x - nmax_x) ** 2)


def _theta_g(nu, dpi1, eps_g, a_g, pi0_x):
    y = 1e6 / (dpi1 * nu)
    return math.pi * (y - eps_g - 0.5 * a_g * (y - pi0_x) ** 2)


def mixed_modes(cfg, dnu, eps_p, dpi1, eps_g, q, d0l, a_p, a_g):
    """(frequencies, zeta, valid) (..., n_p + n_g - 1) of the l = 1 mixed
    modes in the window; an empty slot holds numax, zeta 0, valid 0."""
    lo_w, hi_w = cfg["numin"], cfg["numax_win"]
    n_p, n_g = pole_counts(cfg)
    dnu, eps_p, dpi1, eps_g, q, d0l, a_p, a_g = (
        t[..., None] for t in (dnu, eps_p, dpi1, eps_g, q, d0l, a_p, a_g))
    mid_w = 0.5 * (lo_w + hi_w)
    nmax_x, pi0_x = mid_w / dnu, 1e6 / (dpi1 * mid_w)
    kw = {"dtype": dnu.dtype, "device": dnu.device}
    kp = torch.floor(lo_w / dnu - 0.5 - eps_p - d0l / dnu) \
        + torch.arange(n_p, **kw)
    xp = kp + 0.5 + eps_p + d0l / dnu
    for _ in range(3):
        xp = kp + 0.5 + eps_p + d0l / dnu + 0.5 * a_p * (xp - nmax_x) ** 2
    kg = torch.floor(1e6 / (dpi1 * hi_w) - 0.5 - eps_g) \
        + torch.arange(n_g, **kw)
    yg = kg + 0.5 + eps_g
    for _ in range(3):
        yg = kg + 0.5 + eps_g + 0.5 * a_g * (yg - pi0_x) ** 2
    poles = torch.cat([dnu * xp, 1e6 / (dpi1 * yg)], -1)
    poles = torch.sort(torch.clamp(poles, lo_w, hi_w), -1).values
    a, b = poles[..., :-1], poles[..., 1:]
    valid = (b - a) > 1e-4
    eps = torch.clamp((b - a) * 1e-3, min=1e-6)
    lo, hi = a + eps, b - eps
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        f = torch.tan(_theta_p(mid, dnu, eps_p, d0l, a_p, nmax_x)) \
            - q * torch.tan(_theta_g(mid, dpi1, eps_g, a_g, pi0_x))
        lo, hi = torch.where(f > 0, lo, mid), torch.where(f > 0, mid, hi)
    nu = 0.5 * (lo + hi)
    tp = _theta_p(nu, dnu, eps_p, d0l, a_p, nmax_x)
    tg = _theta_g(nu, dpi1, eps_g, a_g, pi0_x)
    res = torch.remainder(tp - torch.atan(q * torch.tan(tg)) + math.pi / 2,
                          math.pi) - math.pi / 2
    valid = valid & (torch.abs(res) < 0.05)
    den = q**2 * torch.cos(tg) ** 2 + torch.sin(tg) ** 2
    zeta = 1.0 / (1.0 + nu**2 * 1e-6 * dpi1 / dnu * q
                  / torch.clamp(den, min=1e-12))
    nu = torch.where(valid, nu, torch.full_like(nu, hi_w))
    zeta = torch.where(valid, zeta, torch.zeros_like(zeta))
    return nu, zeta, valid.to(nu.dtype)


def assemble(cfg, p):
    """Components (H, C, W, B) (..., K), ordered l = 0, l = 2, l = 1, and
    the noise block of parameter vectors p (..., D)."""
    off = _offsets(cfg)
    heights, widths = _get(p, off, "heights"), _get(p, off, "widths")
    f0, f2 = _get(p, off, "freq_l0"), _get(p, off, "freq_l2")
    vis = _get(p, off, "visibilities")
    dpi1, eps_g, q, d0l, a_p, a_g = _get(p, off, "mixed").unbind(-1)
    a1_env, a1_core, asym = _get(p, off, "rot").unbind(-1)
    inc = _get(p, off, "inclination")[..., 0]
    k = torch.arange(f0.shape[-1], dtype=p.dtype, device=p.device)
    dk = k - k.mean()
    fbar = f0.mean(-1)
    dnu = torch.clamp((dk * (f0 - fbar[..., None])).sum(-1) / (dk * dk).sum(),
                      min=0.1)
    eps_p = torch.remainder((fbar - dnu * k.mean()) / dnu, 1.0)

    def flat(t):
        return t.flatten(-2)

    m2 = torch.arange(-2, 3, dtype=p.dtype, device=p.device)
    c2 = f2[..., :, None] + m2 * a1_env[..., None, None]
    h2 = interp(f2, f0, heights) * vis[..., 1:2]
    w2 = interp(f2, f0, widths)
    f1, zeta, valid = mixed_modes(cfg, dnu, eps_p, dpi1, eps_g, q, d0l, a_p,
                                  a_g)
    h1 = interp(f1, f0, heights) * vis[..., 0:1] * valid
    w1 = torch.clamp(interp(f1, f0, widths) * (1.0 - zeta), min=WIDTH_MIN)
    split = zeta * a1_core[..., None] / 2.0 + (1.0 - zeta) * a1_env[..., None]
    m1 = torch.arange(-1, 2, dtype=p.dtype, device=p.device)
    c1 = f1[..., :, None] + m1 * split[..., :, None]
    H = torch.cat([heights * visibility(0, inc),
                   flat(h2[..., :, None] * visibility(2, inc)[..., None, :]),
                   flat(h1[..., :, None] * visibility(1, inc)[..., None, :])],
                  -1)
    C = torch.cat([f0, flat(c2), flat(c1)], -1)
    W = torch.cat([widths, flat(w2[..., :, None].expand(c2.shape)),
                   flat(w1[..., :, None].expand(c1.shape))], -1)
    return H, C, W, asym[..., None].expand(H.shape), _get(p, off, "noise")


def star(cfg, rng):
    """(truth, prior rows [(name, kind, hyper)]) of one synthetic star."""
    n = cfg["n_orders"]
    off = _offsets(cfg)
    truth = np.zeros(sum(s for _, s in blocks(cfg)))

    def put(name, values):
        o, _ = off[name]
        truth[o:o + len(values)] = values

    f0 = cfg["numin"] + cfg["dnu"] * (np.arange(n) + cfg["eps_p"])
    put("heights", [cfg["height"]] * n)
    put("visibilities", cfg["visibilities"])
    put("freq_l0", f0)
    put("freq_l2", f0 + cfg["d02"])
    put("mixed", [cfg["dpi1"], cfg["eps_g"], cfg["q"], 0.0, 0.0, 0.0])
    put("rot", cfg["rot"])
    put("widths", [cfg["width"]] * n)
    put("noise", cfg["noise"])
    put("inclination", [math.radians(cfg["inclination_deg"])])
    pr = cfg["priors"]
    rows = [(f"H_{i}", "jeffreys", pr["height"]) for i in range(n)]
    rows += [("V2_1", "gaussian", [cfg["visibilities"][0], pr["v1_sigma"]]),
             ("V2_2", "gaussian", [cfg["visibilities"][1], pr["v2_sigma"]])]
    rows += [(f"f0_{i}", "gaussian", [f0[i], pr["freq_sigma"]])
             for i in range(n)]
    rows += [(f"f2_{i}", "gaussian", [f0[i] + cfg["d02"], pr["freq_sigma"]])
             for i in range(n)]
    rows += [("DPi1", "uniform", pr["dpi1"]),
             ("eps_g", "uniform", pr["eps_g"]),
             ("q", "uniform", pr["q"]), ("delta0l", "fix", []),
             ("alpha_p", "fix", []), ("alpha_g", "fix", []),
             ("a1_env", "uniform", pr["a1_env"]),
             ("a1_core", "uniform", pr["a1_core"]), ("asym", "fix", [])]
    rows += [(f"W_{i}", "jeffreys", pr["width"]) for i in range(n)]
    rows += [(k, "fix", []) for k in ("An1", "Bn1", "pn1", "An2", "Bn2",
                                      "pn2", "An3", "Bn3", "pn3")]
    rows += [("N0", "jeffreys", pr["white"]),
             ("inc", "uniform", [0.0, math.pi / 2]), ("trunc", "fix", [])]
    return truth, rows


def constraints(cfg, p):
    """Violations of the family's constraints (...,): ascending l = 0 and
    l = 2 frequencies, heights and widths not negative, DPi1 >= 1e-3 s,
    q >= 1e-4, inclination in [0, pi/2]."""
    off = _offsets(cfg)
    viol = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for name in ("freq_l0", "freq_l2"):
        f = _get(p, off, name)
        viol = viol + (f[..., 1:] <= f[..., :-1]).to(p.dtype).sum(-1)
    for name in ("heights", "widths"):
        viol = viol + (_get(p, off, name) < 0).to(p.dtype).sum(-1)
    mixed = _get(p, off, "mixed")
    viol = viol + (mixed[..., 0] < 1e-3).to(p.dtype) \
        + (mixed[..., 2] < 1e-4).to(p.dtype)
    inc = _get(p, off, "inclination")
    return viol + ((inc < 0) | (inc > math.pi / 2)).to(p.dtype).sum(-1)
