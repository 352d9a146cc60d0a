"""Vectorised prior tables (port of tamcmc_tpu/stats/priors.py; reference
`priors_calc.cpp` [U]).

A prior is a static table: an int kind code and a (4,) hyperparameter row
per parameter.  Out-of-support values score NEG_BIG (not -inf) so gradients
stay finite.  Each kind is evaluated only on its own rows (static index
sets): computing every kind on every row and selecting with torch.where
would turn the unselected branches' infinities into NaN gradients (0 * inf).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np
import torch

NEG_BIG = -1e30  # "minus infinity" that keeps autodiff finite
_SQRT2PI = float(np.sqrt(2.0 * np.pi))


class PriorKind(IntEnum):
    FIX = 0
    UNIFORM = 1
    GAUSSIAN = 2
    JEFFREYS = 3          # modified Jeffreys: p ~ 1/(x + h0) on [0, h1]
    UNIFORM_GAUSSIAN = 4  # flat on [h0,h1], Gaussian tail sigma=h2 above h1
    GUG = 5               # Gaussian(h2) below h0, flat [h0,h1], Gaussian(h3) above h1
    AUTO = 6              # resolved at setup; scores as FIX if it reaches sampling


def _lp_uniform(h, x):
    lo, hi = h[..., 0], h[..., 1]
    inside = (x >= lo) & (x <= hi)
    lp = -torch.log(torch.clamp(hi - lo, min=1e-30))
    return torch.where(inside, lp, NEG_BIG)


def _lp_gaussian(h, x):
    mu, sig = h[..., 0], torch.clamp(h[..., 1], min=1e-30)
    return -0.5 * ((x - mu) / sig) ** 2 - torch.log(sig * _SQRT2PI)


def _lp_jeffreys(h, x):
    """p(x) = 1 / ((x + h0) ln(1 + h1/h0)) on [0, h1]."""
    knee = torch.clamp(h[..., 0], min=1e-30)
    hi = torch.maximum(h[..., 1], knee)
    inside = (x >= 0.0) & (x <= hi)
    norm = torch.log1p(hi / knee)
    lp = -torch.log(torch.clamp(x + knee, min=1e-30)) - torch.log(norm)
    return torch.where(inside, lp, NEG_BIG)


def _lp_uniform_gaussian(h, x):
    lo, hi, sig = h[..., 0], h[..., 1], torch.clamp(h[..., 2], min=1e-30)
    Z = (hi - lo) + sig * _SQRT2PI / 2.0
    flat = (x >= lo) & (x <= hi)
    lp_flat = -torch.log(torch.clamp(Z, min=1e-30))
    lp_tail = lp_flat - 0.5 * ((x - hi) / sig) ** 2
    return torch.where(x < lo, NEG_BIG, torch.where(flat, lp_flat, lp_tail))


def _lp_gug(h, x):
    lo, hi = h[..., 0], h[..., 1]
    sig_lo = torch.clamp(h[..., 2], min=1e-30)
    sig_hi = torch.clamp(h[..., 3], min=1e-30)
    Z = (hi - lo) + (sig_lo + sig_hi) * _SQRT2PI / 2.0
    lp_flat = -torch.log(torch.clamp(Z, min=1e-30))
    lp_lo = lp_flat - 0.5 * ((x - lo) / sig_lo) ** 2
    lp_hi = lp_flat - 0.5 * ((x - hi) / sig_hi) ** 2
    return torch.where(x < lo, lp_lo, torch.where(x > hi, lp_hi, lp_flat))


_KIND_FNS = {PriorKind.UNIFORM: _lp_uniform,
             PriorKind.GAUSSIAN: _lp_gaussian,
             PriorKind.JEFFREYS: _lp_jeffreys,
             PriorKind.UNIFORM_GAUSSIAN: _lp_uniform_gaussian,
             PriorKind.GUG: _lp_gug}          # FIX and AUTO score 0


@dataclasses.dataclass(frozen=True)
class PriorTable:
    """Static prior specification for a D-dim parameter vector.

    kinds: (D,) int PriorKind codes; hypers: (D, 4), or (..., D, 4) with
    leading axes that broadcast against the parameters' (a stacked
    ensemble's (S, 1, 1, D, 4): one row set per star); names: optional."""
    kinds: np.ndarray
    hypers: np.ndarray
    names: tuple = ()
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    def __post_init__(self):
        if self.hypers.ndim < 2 \
                or self.hypers.shape[-2:] != (self.kinds.shape[0], 4):
            raise ValueError(f"kinds {self.kinds.shape} and hypers "
                             f"{self.hypers.shape} do not form a (D, 4) table")

    @property
    def ndim(self):
        return int(self.kinds.shape[0])

    @property
    def free_mask(self) -> np.ndarray:
        return ~np.isin(np.asarray(self.kinds),
                        [int(PriorKind.FIX), int(PriorKind.AUTO)])

    def _groups(self, dtype, device):
        """[(fn, row index tensor, hyper rows)] per kind present, uploaded
        once per (dtype, device)."""
        key = (dtype, torch.device(device))
        if key not in self._on_device:
            kinds = np.asarray(self.kinds)
            self._on_device[key] = [
                (fn, torch.as_tensor(np.nonzero(kinds == int(kind))[0],
                                     device=device),
                 torch.as_tensor(
                     np.asarray(self.hypers)[..., kinds == int(kind), :],
                     dtype=dtype, device=device))
                for kind, fn in _KIND_FNS.items()
                if np.any(kinds == int(kind))]
        return self._on_device[key]

    def log_prior(self, params):
        """Total log-prior of full parameter vectors: (..., D) -> (...,)."""
        total = params.new_zeros(params.shape[:-1])
        for fn, idx, hyp in self._groups(params.dtype, params.device):
            total = total + torch.sum(fn(hyp, params[..., idx]), dim=-1)
        # floor so several out-of-support params don't overflow to -inf;
        # maximum (not clamp) splits the gradient at a tie, as the reference
        return torch.maximum(total, torch.full_like(total, NEG_BIG))

    @staticmethod
    def from_rows(rows):
        """rows: iterable of (name, kind: PriorKind|str, [h0..h3]) tuples."""
        kinds, hypers, names = [], [], []
        for name, kind, *h in rows:
            if isinstance(kind, str):
                kind = PriorKind[kind.upper()]
            hh = list(h[0]) if h and isinstance(
                h[0], (list, tuple, np.ndarray)) else list(h)
            hh = (hh + [0.0] * 4)[:4]
            kinds.append(int(kind))
            hypers.append(hh)
            names.append(name)
        return PriorTable(np.asarray(kinds, dtype=np.int32),
                          np.asarray(hypers, dtype=np.float64).reshape(-1, 4),
                          tuple(names))
