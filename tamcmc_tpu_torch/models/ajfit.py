"""ajfit: fit a-coefficients (+ Alm activity asphericity) to measured
per-(n, l, m) mode frequencies (port of tamcmc_tpu/models/ajfit.py;
reference `io_ajfit.cpp` + `model_ajfit` [U]).

The data are a TABLE of azimuthal-component centroid frequencies nu_nlm
(typically from an earlier peak-bagging posterior) with Gaussian
uncertainties; the model predicts

    nu_nlm = nu_nl + sum_{j=1..6} a_j P_j^{(l)}(m)      (Ritzwoller & Lavely)
           + epsilon nu_nl A_lm(theta0, delta)          (optional Alm term)

and the likelihood is the per-point-sigma Gaussian `chi_square`, not the
spectral chi^2(2 d.o.f.).  There is no frequency grid and no Lorentzian:
`nu` passed to model_fn is the data-point index and is ignored, so the
sampler stack runs unchanged on a D ~ tens parameter space.  No kernel of
the port runs on this model.

`model_fn(params (..., D), nu, fixed=None) -> (..., n_points)`, batched over
leading dims; the data vector is m = -l..l within each multiplet, multiplets
in spec order.
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.ops.alm import alm_shifts, alm_table
from tamcmc_tpu_torch.ops.rotation import split_frequencies_aj
from tamcmc_tpu_torch.utils.blocks import BlockLayout


@dataclasses.dataclass(frozen=True)
class AjFitSpec:
    """l_per_multiplet: degree of each fitted multiplet (one nu_nl nuisance
    centroid per entry); data points are ALL 2l+1 m-components of each
    multiplet, flattened in order.  include_activity adds the
    (epsilon, theta0, delta) Alm asphericity block."""
    l_per_multiplet: tuple = (1, 1, 1, 2, 2, 2)
    include_activity: bool = True
    filter_kind: str = "gate"          # gate | triangle | gauss (ops/alm.py)

    def __post_init__(self):
        if not all(1 <= l <= 3 for l in self.l_per_multiplet):
            raise AssertionError("ajfit multiplets must have 1 <= l <= 3 "
                                 "(l=0 has no splitting)")

    @property
    def n_points(self) -> int:
        return sum(2 * l + 1 for l in self.l_per_multiplet)

    def layout(self):
        blocks = [("nu_nl", len(self.l_per_multiplet)), ("aj", 6)]
        if self.include_activity:
            blocks.append(("activity", 3))    # epsilon, theta0, delta [rad]
        return BlockLayout.make(blocks)

    def point_labels(self):
        """Flat (multiplet, l, m) label per data point, in output order."""
        out = []
        for i, l in enumerate(self.l_per_multiplet):
            out += [(i, l, m) for m in range(-l, l + 1)]
        return out


def build_ajfit(spec: AjFitSpec):
    layout = spec.layout()
    ls = spec.l_per_multiplet
    # multiplets grouped by degree: one splitting call per distinct l, then
    # a static re-ordering back to spec order
    groups = {}
    for i, l in enumerate(ls):
        groups.setdefault(l, []).append(i)

    def model_fn(params, nu, fixed=None):
        del nu, fixed                           # table fit: no grid
        nu_nl = layout.get(params, "nu_nl")     # (..., n_multiplets)
        aj = layout.get(params, "aj")           # (..., 6)
        if spec.include_activity:
            eps, th0, delta = (layout.get(params, "activity")[..., i]
                               for i in range(3))
            table = alm_table(th0, delta, spec.filter_kind)
        segs = [None] * len(ls)
        for l, idxs in groups.items():
            nus = torch.stack([nu_nl[..., i] for i in idxs], -1)   # (..., k)
            pred = split_frequencies_aj(l, nus, aj)          # (..., k, 2l+1)
            if spec.include_activity:
                pred = pred + alm_shifts(l, nus, eps, th0, delta,
                                         kind=spec.filter_kind, table=table)
            for row, i in enumerate(idxs):
                segs[i] = pred[..., row, :]
        return torch.cat(segs, -1)              # (..., n_points)

    return model_fn, layout
