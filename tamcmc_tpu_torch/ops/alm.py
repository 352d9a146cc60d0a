"""Alm: activity-induced (l, m) frequency perturbation (port of
tamcmc_tpu/ops/alm.py; reference `external/Alm/*.cpp` [U]).

The shift of an (l, m) mode caused by a magnetic-activity band at latitude
theta0 with full width delta is the latitudinal average of the mode's
sensitivity kernel |Y_lm|^2 over an activity filter, times a magnitude
epsilon:

    dnu_lm = epsilon nu_nl A_lm(theta0, delta)
    A_lm   = int |Y_lm|^2 W sin(theta) dtheta / int |Y_lm|^2 sin(theta) dtheta

with W a hemisphere-symmetric gate, triangle or gauss filter centred on
colatitudes pi/2 -+ theta0.  The integral is a 96-node Gauss-Legendre
quadrature whose nodes and kernel weights are constants, uploaded once per
(dtype, device).

Batched over leading dims: theta0, delta, epsilon are (...,) per walker, so
the filter is (..., 96).  A_lm depends on |m| only, so the ten distinct
(l, |m|) kernels for l <= 3 form one (10, 96) constant that meets one filter
evaluation (`alm_table`); `alm` and `alm_shifts` index the result.  Each
evaluation bumps the host counter `utils.metrics.COUNTERS["alm_tables"]
["alm"]` (no launch, no synchronise).

The gate, the filter the MS_Global ajAlm models use, is evaluated as one
(..., n, 4) sigmoid of the four band edges of both hemispheres, and the
shifts gather their m = -l..l rows with one index: each is one launch on
the card, which runs these small operations at the host's pace.  The
clamps split a gradient at an exact tie differently from jnp.maximum /
jnp.minimum; off the ties (delta = 1e-3, a filter exactly 0 or 1) both
give the same gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tamcmc_tpu_torch.utils.metrics import COUNTERS

_QUAD_ORDER = 96
_NODES, _WEIGHTS = np.polynomial.legendre.leggauss(_QUAD_ORDER)
# map x in [-1, 1] -> theta in [0, pi]
_THETA = (np.pi / 2) * (_NODES + 1.0)
_W_TH = (np.pi / 2) * _WEIGHTS

LMAX = 3
# row of (l, |m|) in alm_table's last axis: l(l+1)/2 + |m|
_ROW = {(l, m): l * (l + 1) // 2 + m
        for l in range(LMAX + 1) for m in range(l + 1)}
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
# the gate's four edges, latitude theta0 * _EDGE_T0 + delta * _EDGE_D: the
# lower and upper edge of the northern band, then of the southern; a lower
# edge's sigmoid rises with latitude, an upper edge's falls (_EDGE_SIGN)
_EDGE_T0 = (1.0, 1.0, -1.0, -1.0)
_EDGE_D = (-0.5, 0.5, -0.5, 0.5)
_EDGE_SIGN = (1.0, -1.0, 1.0, -1.0)


def _plm2(l: int, m: int, x):
    """[P_l^|m|(x)]^2 (l-|m|)!/(l+|m|)!: the phi-averaged |Y_lm|^2 shape, up
    to the common (2l+1)/4pi factor, which cancels in A_lm.  x: a tensor or
    a numpy array."""
    m = abs(m)
    s2 = 1.0 - x * x          # sin^2 theta
    if l == 0:
        return x * 0 + 1
    if l == 1:
        return {0: x**2, 1: 0.5 * s2}[m]
    if l == 2:
        return {0: 0.25 * (3 * x**2 - 1) ** 2,
                1: (1.0 / 6.0) * 9.0 * x**2 * s2,
                2: (1.0 / 24.0) * 9.0 * s2**2}[m]
    if l == 3:
        return {0: 0.25 * (5 * x**3 - 3 * x) ** 2,
                1: (1.0 / 12.0) * 2.25 * (5 * x**2 - 1) ** 2 * s2,
                2: (1.0 / 120.0) * 225.0 * x**2 * s2**2,
                3: (1.0 / 720.0) * 225.0 * s2**3}[m]
    raise NotImplementedError(f"Alm kernels implemented for l<=3, got {l}")


@functools.lru_cache(maxsize=16)
def _quadrature(dtype, device):
    """(theta (96,), wk (10, 96), den (10,)) on `device`: the colatitude
    nodes, the quadrature weight times kernel times sin(theta) of every
    (l, |m|) row, and each row's sum floored at 1e-30.  Formed in `dtype`
    arithmetic, the reference's."""
    dt = _NP_DTYPES[dtype]
    x = np.cos(_THETA).astype(dt)
    th = _THETA.astype(dt)
    w = _W_TH.astype(dt)
    wk = np.stack([w * (_plm2(l, m, x) * np.sin(th)) for (l, m) in _ROW])
    den = np.maximum(wk.sum(-1), dt(1e-30))
    return tuple(torch.as_tensor(a, device=device) for a in (th, wk, den))


@functools.lru_cache(maxsize=16)
def _gate_constants(dtype, device, smooth):
    """The gate's edge coefficients (4,), (4,) and slopes sign / smooth
    (4,) on `device`."""
    return tuple(torch.tensor(v, dtype=dtype, device=device) for v in
                 (_EDGE_T0, _EDGE_D, [s / smooth for s in _EDGE_SIGN]))


@functools.lru_cache(maxsize=64)
def _m_rows(l: int, device):
    """alm_table's rows of m = -l..l, (2l+1,) on `device`."""
    return torch.tensor([_ROW[l, abs(m)] for m in range(-l, l + 1)],
                        device=device)


def activity_filter(theta, theta0, delta, kind: str = "gate",
                    smooth: float = 0.02):
    """Hemisphere-symmetric latitude filter W(theta) in [0, 1].

    theta: colatitude grid (n,); theta0: active LATITUDE (0 = equator) and
    delta: full band width, both (...,).  Returns (..., n).  'gate' is a
    sigmoid-smoothed box (width `smooth` rad), 'triangle' a tent, 'gauss' a
    Gaussian band whose FWHM is delta."""
    lat = torch.pi / 2 - theta          # latitude of the quadrature node
    d = torch.clamp(delta, min=1e-3)[..., None]
    theta0 = theta0[..., None]
    if kind == "gate":
        c0, cd, slope = _gate_constants(d.dtype, d.device, smooth)
        edges = torch.addcmul(theta0 * c0, d, cd)                # (..., 4)
        s = torch.sigmoid((lat[:, None] - edges[..., None, :]) * slope)
        # each band rises at its lower edge and falls at its upper
        return torch.clamp((s[..., 0::2] * s[..., 1::2]).sum(-1), max=1.0)

    def band(c):
        if kind == "triangle":
            return torch.clamp(1.0 - torch.abs(lat - c) / (d / 2.0), min=0.0)
        if kind == "gauss":
            sig = d / 2.3548200450309493        # FWHM -> sigma
            return torch.exp(-0.5 * ((lat - c) / sig) ** 2)
        raise KeyError(f"unknown activity filter '{kind}'")

    # active bands in both hemispheres, capped at 1 where they overlap
    return torch.clamp(band(theta0) + band(-theta0), max=1.0)


def alm_table(theta0, delta, kind: str = "gate"):
    """A_lm of every (l, |m|), l <= 3, from one filter evaluation:
    theta0, delta (...,) in radians -> (..., 10), row l(l+1)/2 + |m|."""
    th, wk, den = _quadrature(theta0.dtype, theta0.device)
    COUNTERS["alm_tables"]["alm"] += 1
    W = activity_filter(th, theta0, delta, kind=kind)        # (..., 96)
    return (wk * W[..., None, :]).sum(-1) / den


def alm(l: int, m: int, theta0, delta, kind: str = "gate"):
    """Normalised kernel-weighted filter average A_lm(theta0, delta) in
    [0, 1]: static (l, m), theta0 and delta (...,) -> (...,)."""
    if l > LMAX:
        raise NotImplementedError(f"Alm kernels implemented for l<=3, got {l}")
    return alm_table(theta0, delta, kind)[..., _ROW[l, abs(m)]]


def alm_shifts(l: int, nu_nl, epsilon, theta0, delta, kind: str = "gate",
               table=None):
    """Activity shifts for all m = -l..l: dnu_lm = epsilon nu_nl A_lm.

    nu_nl: (..., N_l); epsilon, theta0, delta: (...,); `table`: alm_table of
    the same theta0, delta and kind when the caller already has it (one
    filter evaluation for all degrees).  Returns (..., N_l, 2l+1)."""
    if table is None:
        table = alm_table(theta0, delta, kind)
    a = table.index_select(-1, _m_rows(l, table.device))    # m = -l..l
    return (epsilon[..., None, None] * nu_nl[..., None]) * a[..., None, :]
