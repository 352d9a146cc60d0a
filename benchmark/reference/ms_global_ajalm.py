"""Main-sequence global fit with odd a-coefficients and an activity band
(`model_MS_Global_ajAlm_HarveyLike`) in float64 plain torch.

The spectrum is the `ms_global` family's (heights and widths free at the
l = 0 frequencies and interpolated to l > 0, V^2_l, the inclination
visibilities, three Harvey-like terms and a white level); only the rotation
block and the centres differ.  Each (n, l, m) centre is

    nu_nlm = (nu_nl + a1 P1(m) + a3 P3(m) + a5 P5(m))
             (1 + eta0 (a1 1e-6)^2 Q_lm) + epsilon nu_nl A_lm(theta0, delta)

with P_j the Ritzwoller-Lavely polynomials (P_j(l) = l), Q_lm = (l(l+1) -
3 m^2) / ((2l - 1)(2l + 3)), eta0 = 3 pi / (G rho_sun) (Dnu_sun / Dnu)^2
where the eta switch is on (the centrifugal term acts on the split
frequency), and the activity term on l > 0 only.  A_lm is the latitudinal
average of |Y_lm|^2 over an activity band at latitude theta0 of full width
delta, in both hemispheres (Gizon 2002, AN 323, 251):

    A_lm = int |Y_lm|^2 W sin(theta) dtheta / int |Y_lm|^2 sin(theta) dtheta

Departures from the published description, each the model's own
definition:

- the integrals are a 96-node Gauss-Legendre rule in colatitude, not the
  exact integral (against 1,024 nodes: 2.0e-4 of A_lm at the
  configuration's truth, up to 3.1e-3 over its prior, for a band near the
  equator: PERF.md section 4);
- the band W is a gate smoothed by sigmoids 0.02 rad wide at both edges,
  the two hemispheres' gates summed and capped at 1, and delta floored at
  1e-3 rad, not a sharp box;
- A_lm depends on |m| only, and the activity term takes the unsplit nu_nl.

|Y_lm|^2 comes from this file's own associated-Legendre recursion.  The
assembly runs with TF32 off (`exact_float32`), so no product on a CUDA
card rounds below float32 whatever the process set.

Parameter vector (the model's block order): heights (n), visibilities
(lmax), freq_l0..freq_l3 (n or 0), rot [a1, a3, a5, eta_sw, epsilon,
theta0, delta, asym] (theta0 and delta in radians), widths (n), noise [A1,
B1, p1, A2, B2, p2, A3, B3, p3, N0], inclination, trunc.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from benchmark.reference import ms_global
from benchmark.reference.ms_global import (DNU_SUN, G_CGS, RHO_SUN, n_per_l,
                                           ritzwoller_lavely, visibility)
from benchmark.reference.priors import interp

SMALL = ms_global.SMALL
ROT = ("a1", "a3", "a5", "eta_sw", "epsilon", "theta0", "delta", "asym")
QUAD_NODES = 96
SMOOTH = 0.02               # rad, the gate's sigmoid edges
DELTA_MIN = 1e-3            # rad


def spec_kwargs(cfg):
    """The problem file's [spec] block."""
    return {"n_per_l": n_per_l(cfg), "alm_filter": "gate"}


def blocks(cfg):
    return [("rot", len(ROT)) if name == "rot" else (name, size)
            for name, size in ms_global.blocks(cfg)]


def n_components(cfg):
    return ms_global.n_components(cfg)


def _offsets(cfg):
    off, o = {}, 0
    for name, size in blocks(cfg):
        off[name] = (o, size)
        o += size
    return off


def _get(p, off, name):
    o, s = off[name]
    return p[..., o:o + s]


def legendre_sq(l, m, x):
    """[P_l^m(x)]^2 (l - m)! / (l + m)!, m >= 0, by the recursion in l:
    P_m^m = (-1)^m (2m - 1)!! (1 - x^2)^(m/2), P_{m+1}^m = (2m + 1) x P_m^m,
    (l - m) P_l^m = (2l - 1) x P_{l-1}^m - (l + m - 1) P_{l-2}^m."""
    pmm = np.ones_like(x)
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    for k in range(1, m + 1):
        pmm = -(2 * k - 1) * s * pmm
    prev, cur = pmm, pmm
    if l > m:
        prev, cur = pmm, (2 * m + 1) * x * pmm
        for j in range(m + 2, l + 1):
            prev, cur = cur, ((2 * j - 1) * x * cur
                              - (j + m - 1) * prev) / (j - m)
    return cur**2 * math.factorial(l - m) / math.factorial(l + m)


@functools.lru_cache(maxsize=8)
def quadrature(n_nodes=QUAD_NODES):
    """(theta (n,), w (n,)): Gauss-Legendre nodes mapped to colatitudes in
    [0, pi] and their weights times the map's pi / 2."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    return math.pi / 2 * (x + 1.0), math.pi / 2 * w


def band_filter(theta, theta0, delta):
    """W (..., n) at colatitudes theta (n,) of bands at latitudes -+theta0
    (...,) of full width delta (...,)."""
    lat = math.pi / 2 - theta
    d = torch.clamp(delta, min=DELTA_MIN)[..., None]
    w = 0.0
    for c in (theta0[..., None], -theta0[..., None]):
        w = w + torch.sigmoid((lat - (c - d / 2)) / SMOOTH) \
            * torch.sigmoid(((c + d / 2) - lat) / SMOOTH)
    return torch.clamp(w, max=1.0)


def alm(l, theta0, delta, n_nodes=QUAD_NODES):
    """A_l|m| (..., l + 1) for |m| = 0..l of theta0, delta (...,)."""
    th, w = quadrature(n_nodes)
    sin = np.sin(th)
    kern = torch.as_tensor(np.stack([w * legendre_sq(l, m, np.cos(th)) * sin
                                     for m in range(l + 1)]),
                           dtype=theta0.dtype, device=theta0.device)
    W = band_filter(torch.as_tensor(th, dtype=theta0.dtype,
                                    device=theta0.device), theta0, delta)
    return (W[..., None, :] * kern).sum(-1) / kern.sum(-1)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for CUDA matrix products and cuDNN inside the block; the
    process's settings come back on exit."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = was


def assemble(cfg, p):
    """Components (H, C, W, B) (..., K) and the noise block of parameter
    vectors p (..., D)."""
    with exact_float32():
        return _assemble(cfg, p)


def _assemble(cfg, p):
    off = _offsets(cfg)
    f0 = _get(p, off, "freq_l0")
    heights, widths = _get(p, off, "heights"), _get(p, off, "widths")
    vis = _get(p, off, "visibilities")
    a1, a3, a5, sw, eps, theta0, delta, asym = (
        _get(p, off, "rot")[..., i] for i in range(len(ROT)))
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
        pj = torch.as_tensor(ritzwoller_lavely(l, jmax=5), dtype=p.dtype,
                             device=p.device)
        nu = fl[..., None]
        split = nu + (a1[..., None, None] * pj[0] + a3[..., None, None]
                      * pj[2] + a5[..., None, None] * pj[4])
        c = split + eta0[..., None, None] * (a1[..., None, None] * 1e-6) \
            ** 2 * split * q
        if l:
            a = alm(l, theta0, delta)[..., m.abs().long()]   # (..., 2l+1)
            c = c + eps[..., None, None] * nu * a[..., None, :]
        e = visibility(l, inc)
        hs.append((h[..., :, None] * e[..., None, :]).flatten(-2))
        cs.append(c.flatten(-2))
        ws.append(w[..., :, None].expand(c.shape).flatten(-2))
    H, C, W = (torch.cat(t, -1) for t in (hs, cs, ws))
    return H, C, W, asym[..., None].expand(H.shape), _get(p, off, "noise")


def trunc_of(cfg, p0):
    o, _ = _offsets(cfg)["trunc"]
    return float(p0[o]) or 40.0


def star(cfg, rng):
    """(truth, prior rows [(name, kind, hyper)]) of one synthetic star: the
    `ms_global` family's star from the same draws, its rotation block
    replaced by this law's."""
    r, pr = cfg["rot"], cfg["priors"]
    base = dict(cfg, rot=[r["a1"], r["eta_sw"], r["a3"], r["asym"]])
    truth4, rows4 = ms_global.star(base, rng)
    o = sum(size for name, size in ms_global.blocks(cfg)[:[
        b for b, _ in ms_global.blocks(cfg)].index("rot")])
    deg = math.pi / 180.0
    rot = [r["a1"], r["a3"], r["a5"], r["eta_sw"], r["epsilon"],
           r["theta0_deg"] * deg, r["delta_deg"] * deg, r["asym"]]
    rows = [("a1", "uniform", pr["a1"]), ("a3", "gaussian", pr["a3"]),
            ("a5", "gaussian", pr["a5"]), ("eta_sw", "fix", []),
            ("epsilon", "uniform", pr["epsilon"]),
            ("theta0", "uniform", [v * deg for v in pr["theta0_deg"]]),
            ("delta", "uniform", [v * deg for v in pr["delta_deg"]]),
            ("asym", "fix", [])]
    truth = np.concatenate([truth4[:o], rot, truth4[o + 4:]])
    return truth, rows4[:o] + rows + rows4[o + 4:]


def constraints(cfg, p):
    """Violations of the family's cross-parameter constraints (...,), the
    `ms_global` family's: ascending frequencies per degree, heights,
    widths, visibilities and a1 not negative, inclination in [0, pi/2]."""
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
