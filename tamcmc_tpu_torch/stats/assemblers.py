"""Family prior assemblers: cross-parameter constraints (port of
tamcmc_tpu/stats/assemblers.py; reference `priors_calc.cpp`
`priors_MS_Global`, `priors_local`, `priors_asymptotic` [U]).

Each constraint is fn(full_params (..., D)) -> (...,): 0 when satisfied and
NEG_BIG per violation, so a violating proposal is rejected with
probability ~1 while gradients stay finite (the constraint terms carry none).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from tamcmc_tpu_torch.stats.priors import NEG_BIG
from tamcmc_tpu_torch.utils.blocks import BlockLayout


def ordering(layout: BlockLayout, block: str) -> Callable:
    """Strictly-ascending constraint on a (possibly empty) block."""
    o, n = layout.offset(block), layout.size(block)

    def fn(p):
        if n < 2:
            return p.new_zeros(p.shape[:-1])
        x = p[..., o:o + n]
        viol = (x[..., 1:] <= x[..., :-1]).to(p.dtype).sum(-1)
        return NEG_BIG * viol

    return fn


def bounded(layout: BlockLayout, block: str, lo=None, hi=None,
            index: Optional[int] = None, count: Optional[int] = None):
    """Box constraint on a block (or its [index:index+count) sub-slice)."""
    o, n = layout.offset(block), layout.size(block)
    if index is not None:
        o += index
        n = count if count is not None else 1

    def fn(p):
        viol = p.new_zeros(p.shape[:-1])
        if n == 0:
            return viol
        x = p[..., o:o + n]
        if lo is not None:
            viol = viol + (x < lo).to(p.dtype).sum(-1)
        if hi is not None:
            viol = viol + (x > hi).to(p.dtype).sum(-1)
        return NEG_BIG * viol

    return fn


def compose(*fns) -> Optional[Callable]:
    """Sum of constraint terms; None for an empty list (no extra_logp)."""
    fns = [f for f in fns if f is not None]
    if not fns:
        return None

    def total(p):
        s = fns[0](p)
        for f in fns[1:]:
            s = s + f(p)
        # several simultaneous violations must not overflow f32
        return s.clamp(min=NEG_BIG)

    return total


def _ms_global_constraints(layout: BlockLayout):
    """Frequency ordering per degree, non-negative heights/widths/
    visibilities, inclination in [0, pi/2], a1 >= 0."""
    cons = [ordering(layout, b) for b in layout.names
            if b.startswith("freq_l")]
    cons.append(bounded(layout, "heights", lo=0.0))
    if "widths" in layout.names:
        cons.append(bounded(layout, "widths", lo=0.0))
    cons.append(bounded(layout, "visibilities", lo=0.0))
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination", lo=0.0, hi=math.pi / 2))
    if "rot" in layout.names:
        cons.append(bounded(layout, "rot", lo=0.0, index=0))
    return cons


def _rgb_constraints(layout: BlockLayout):
    """p-mode ordering, non-negative heights/widths, the ARMM solver's
    domain (DPi1 >= 1e-3 s, q >= 1e-4), inclination in [0, pi/2]."""
    cons = [ordering(layout, b) for b in layout.names
            if b.startswith("freq_l")]
    cons.append(bounded(layout, "heights", lo=0.0))
    if "widths" in layout.names:
        cons.append(bounded(layout, "widths", lo=0.0))
    if "mixed" in layout.names:
        cons.append(bounded(layout, "mixed", lo=1e-3, index=0))  # DPi1
        cons.append(bounded(layout, "mixed", lo=1e-4, index=2))  # q
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination", lo=0.0, hi=math.pi / 2))
    return cons


def _local_constraints(layout: BlockLayout):
    """Non-negative per-mode heights and widths (every `height_l*` and
    `width_l*` block of the layout), inclination in [0, pi/2] where the
    layout has one.  The windows of a local fit do not overlap, so the
    frequencies carry no ordering term."""
    cons = [bounded(layout, b, lo=0.0) for b in layout.names
            if b.startswith(("height_l", "width_l"))]
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination", lo=0.0, hi=math.pi / 2))
    return cons


def _ajfit_constraints(layout: BlockLayout):
    """Ordered nuisance centroids (the fitted multiplets are a
    frequency-sorted table) and a physical activity block: epsilon >= 0,
    theta0 in [0, pi/2] (a latitude), delta >= 1e-3."""
    cons = [ordering(layout, "nu_nl")]
    if "activity" in layout.names:
        cons.append(bounded(layout, "activity", lo=0.0, index=0))
        cons.append(bounded(layout, "activity", lo=0.0, hi=math.pi / 2,
                            index=1))
        cons.append(bounded(layout, "activity", lo=1e-3, index=2))
    return cons


def build_family_constraints(model_name: str,
                             layout: BlockLayout) -> Optional[Callable]:
    """Model name -> composed extra_logp, matched on the family prefix;
    None for the test and background families (per-parameter priors
    suffice)."""
    name = model_name.strip().lower()
    if name.startswith("model_ms_global"):
        return compose(*_ms_global_constraints(layout))
    if name.startswith("model_ms_local"):
        return compose(*_local_constraints(layout))
    if name.startswith("model_rgb_asympt"):
        return compose(*_rgb_constraints(layout))
    if name.startswith("model_ajfit"):
        return compose(*_ajfit_constraints(layout))
    return None
