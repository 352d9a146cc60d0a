"""Main-sequence global fit (`model_MS_Global_a1etaa3_HarveyLike`) in float64
plain torch: l = 0..lmax p modes, heights and widths free at the l = 0
frequencies and interpolated linearly to l > 0, heights scaled by V^2_l,
azimuthal components weighted by the inclination visibilities (Gizon &
Solanki 2003) and split by the a1-eta-a3 law, plus three Harvey-like terms
and a white level.

Also the configuration's synthetic star: its truth, its priors and its
start point, drawn from a seed.

Parameter vector (the model's block order): heights (n), visibilities
(lmax), freq_l0..freq_l3 (n or 0), rot [a1, eta_sw, a3, asym], widths (n),
noise [A1, B1, p1, A2, B2, p2, A3, B3, p3, N0], inclination, trunc.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.priors import interp

G_CGS = 6.667e-8
RHO_SUN = 1.408
DNU_SUN = 135.1
# the CPU cut of the tests: three orders about numax on 3,000 bins
SMALL = {"n_orders": 3, "n_bins": 3000, "nu_lo": 2200 - 85 * 2.5,
         "nu_hi": 2200 + 85 * 2.5}


def n_per_l(cfg):
    return [cfg["n_orders"] if l <= cfg["lmax"] else 0 for l in range(4)]


def spec_kwargs(cfg):
    """The problem file's [spec] block."""
    return {"n_per_l": n_per_l(cfg)}


def blocks(cfg):
    n = cfg["n_orders"]
    out = [("heights", n), ("visibilities", max(cfg["lmax"], 1))]
    out += [(f"freq_l{l}", k) for l, k in enumerate(n_per_l(cfg))]
    out += [("rot", 4), ("widths", n), ("noise", 10), ("inclination", 1),
            ("trunc", 1)]
    return out


def n_components(cfg):
    return sum(k * (2 * l + 1) for l, k in enumerate(n_per_l(cfg)))


def _offsets(cfg):
    off, o = {}, 0
    for name, size in blocks(cfg):
        off[name] = (o, size)
        o += size
    return off


def _get(p, off, name):
    o, s = off[name]
    return p[..., o:o + s]


def visibility(l, inc):
    """eps_lm(i), m = -l..l, summing to 1: inc (...,) -> (..., 2l+1)."""
    c, s = torch.cos(inc), torch.sin(inc)
    if l == 0:
        return torch.ones(inc.shape + (1,), dtype=inc.dtype,
                          device=inc.device)
    if l == 1:
        e = [0.5 * s**2, c**2]
        return torch.stack([e[0], e[1], e[0]], -1)
    if l == 2:
        e0 = 0.25 * (3.0 * c**2 - 1.0) ** 2
        e1 = 1.5 * c**2 * s**2
        e2 = 0.375 * s**4
        return torch.stack([e2, e1, e0, e1, e2], -1)
    e0 = 0.25 * (5.0 * c**3 - 3.0 * c) ** 2
    e1 = 0.1875 * (5.0 * c**2 - 1.0) ** 2 * s**2
    e2 = 1.875 * c**2 * s**4
    e3 = 0.3125 * s**6
    return torch.stack([e3, e2, e1, e0, e1, e2, e3], -1)


def ritzwoller_lavely(l, jmax=3):
    """P_j(m), j = 1..jmax, m = -l..l, orthogonal over m with P_j(l) = l."""
    m = np.arange(-l, l + 1, dtype=np.float64)
    basis, out = [np.ones_like(m)], np.zeros((jmax, 2 * l + 1))
    for j in range(1, jmax + 1):
        v = m**j if j <= 2 * l else np.zeros_like(m)
        if j <= 2 * l:
            for b in basis:
                if np.dot(b, b) > 0:
                    v = v - np.dot(v, b) / np.dot(b, b) * b
        basis.append(v)
        if abs(v[-1]) > 0:
            out[j - 1] = v * (l / v[-1])
    return out


def assemble(cfg, p):
    """Components (H, C, W, B) (..., K) and the noise block of parameter
    vectors p (..., D)."""
    off = _offsets(cfg)
    f0 = _get(p, off, "freq_l0")
    heights, widths = _get(p, off, "heights"), _get(p, off, "widths")
    vis = _get(p, off, "visibilities")
    a1, sw, a3, asym = (_get(p, off, "rot")[..., i] for i in range(4))
    inc = _get(p, off, "inclination")[..., 0]
    dnu = (f0[..., -1] - f0[..., 0]) / (f0.shape[-1] - 1)
    eta0 = 3.0 * math.pi / (G_CGS * RHO_SUN) * (DNU_SUN / dnu) ** 2
    eta0 = torch.where(sw > 0.5, eta0, torch.zeros_like(eta0))
    hs, cs, ws = [], [], []
    for l in range(4):
        fl = _get(p, off, f"freq_l{l}")
        if fl.shape[-1] == 0:
            continue
        if l == 0:
            h, w = heights, widths
        else:
            h = interp(fl, f0, heights) * vis[..., l - 1:l]
            w = interp(fl, f0, widths)
        m = torch.arange(-l, l + 1, dtype=p.dtype, device=p.device)
        q = (l * (l + 1) - 3.0 * m**2) / ((2 * l - 1) * (2 * l + 3)) \
            if l else torch.zeros_like(m)
        p3 = torch.as_tensor(ritzwoller_lavely(l)[2], dtype=p.dtype,
                             device=p.device)
        nu = fl[..., None]
        a1b = a1[..., None, None]
        c = nu + m * a1b + eta0[..., None, None] * (a1b * 1e-6) ** 2 * nu * q \
            + a3[..., None, None] * p3
        eps = visibility(l, inc)
        hs.append((h[..., :, None] * eps[..., None, :]).flatten(-2))
        cs.append(c.flatten(-2))
        ws.append(w[..., :, None].expand(c.shape).flatten(-2))
    H, C, W = (torch.cat(t, -1) for t in (hs, cs, ws))
    return H, C, W, asym[..., None].expand(H.shape), _get(p, off, "noise")


def trunc_of(cfg, p0):
    o, _ = _offsets(cfg)["trunc"]
    return float(p0[o]) or 40.0


def star(cfg, rng):
    """(truth, prior rows [(name, kind, hyper)]) of one synthetic star."""
    n, lmax = cfg["n_orders"], cfg["lmax"]
    dnu, numax = cfg["dnu"], cfg["numax"]
    off = _offsets(cfg)
    f0 = numax + dnu * (np.arange(n) - n / 2) \
        + rng.normal(0.0, cfg["freq_scatter"], n)
    f0.sort()
    env = np.exp(-0.5 * ((f0 - numax) / (cfg["envelope_frac"] * numax)) ** 2)
    truth = np.zeros(sum(s for _, s in blocks(cfg)))

    def put(name, values):
        o, s = off[name]
        truth[o:o + len(values)] = values

    put("heights", cfg["height_peak"] * env + cfg["height_floor"])
    vis = cfg["visibilities"][:max(lmax, 1)]
    put("visibilities", vis)
    for l in range(lmax + 1):
        put(f"freq_l{l}", f0 + cfg["ridge_offsets"][l] * dnu)
    put("rot", cfg["rot"])
    put("widths", cfg["width_lo"] + (cfg["width_hi"] - cfg["width_lo"])
        * (f0 - f0[0]) / (f0[-1] - f0[0]))
    put("noise", cfg["noise"])
    put("inclination", [math.radians(cfg["inclination_deg"])])
    put("trunc", [cfg["trunc"]])
    pr = cfg["priors"]
    rows = [(f"H_{i}", "jeffreys", pr["height"]) for i in range(n)]
    rows += [(f"V2_{l}", "gaussian", [vis[l - 1], pr["visibility_sigma"]])
             for l in range(1, lmax + 1)]
    for l in range(4):
        o, s = off[f"freq_l{l}"]
        rows += [(f"f{l}_{i}", "gaussian", [truth[o + i], pr["freq_sigma"]])
                 for i in range(s)]
    rows += [("a1", "uniform", pr["a1"]), ("eta_sw", "fix", []),
             ("a3", "gaussian", pr["a3"]), ("asym", "fix", [])]
    rows += [(f"W_{i}", "jeffreys", pr["width"]) for i in range(n)]
    rows += [(k, "fix", []) for k in ("An1", "Bn1", "pn1", "An2", "Bn2",
                                      "pn2", "An3", "Bn3", "pn3")]
    rows += [("N0", "jeffreys", pr["white"]),
             ("inc", "uniform", [0.0, math.pi / 2]), ("trunc", "fix", [])]
    return truth, rows


def constraints(cfg, p):
    """Violations of the family's cross-parameter constraints (...,):
    ascending frequencies per degree, heights, widths, visibilities and a1
    not negative, inclination in [0, pi/2]."""
    off = _offsets(cfg)
    viol = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for l in range(4):
        f = _get(p, off, f"freq_l{l}")
        if f.shape[-1] > 1:
            viol = viol + (f[..., 1:] <= f[..., :-1]).to(p.dtype).sum(-1)
    for name in ("heights", "widths", "visibilities"):
        viol = viol + (_get(p, off, name) < 0).to(p.dtype).sum(-1)
    inc = _get(p, off, "inclination")
    viol = viol + ((inc < 0) | (inc > math.pi / 2)).to(p.dtype).sum(-1)
    return viol + (_get(p, off, "rot")[..., :1] < 0).to(p.dtype).sum(-1)
