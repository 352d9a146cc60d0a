"""Setup-time resolution of `Auto` priors (port of
tamcmc_tpu/stats/auto_priors.py; host-side numpy).

In cpptamcmc an `Auto` prior row delegates the hyperparameter choice to the
io layer, which derives it at setup from the data and the rest of the
.model file (`io_ms_global.cpp` [U]).  Its exact derivations are not known
here, so this module implements a PROVISIONAL, conservative subset keyed by
the parameter's ABI block (utils/blocks.py), and REFUSES, loudly and at
setup, any Auto row it cannot derive: an Auto row either becomes a derived
prior here or the fit never starts.  It never acts as Fix, which would
freeze a parameter the reference would fit.

Derivations (all flagged [U]):

  heights       modified Jeffreys, knee = 0.1 x median(spec),
                max = 10 x max(spec)           (data sets the power scale)
  freq_l0..3    Uniform(x0 - d, x0 + d), d = max(Dnu/4, 20 grid steps)
                with Dnu estimated from the freq_l0 comb of params0
                (keeps the mode identifiable inside its own order)
  widths        modified Jeffreys, knee = grid step (resolution floor),
                max = Dnu/2                    (wider than any real mode)
  noise (last entry = white-noise floor N0)
                modified Jeffreys, knee = 0.1 x median(spec),
                max = 10 x median(spec)
  inclination   Uniform(0, pi/2)               (the geometric domain)

Everything else (visibilities, rotation/aj coefficients, Harvey shape
parameters, mixed-mode/ARMM blocks, trunc) is refused: no defensible
data-driven rule is known for them.
"""

from __future__ import annotations

import math

import numpy as np

from tamcmc_tpu_torch.stats.priors import PriorTable, PriorKind


class AutoPriorError(ValueError):
    """An Auto prior row could not be derived — the fit must not start."""


def _block_of(layout, idx: int):
    off = 0
    for name, size in zip(layout.names, layout.sizes):
        if off <= idx < off + size:
            return name, idx - off, size
        off += size
    return None, None, None


def _dnu_estimate(layout, params0):
    if layout is None or "freq_l0" not in layout.names:
        return None
    f0 = np.asarray(params0)[layout.offset("freq_l0"):
                             layout.offset("freq_l0") + layout.size("freq_l0")]
    if f0.size >= 2:
        d = float(np.median(np.diff(np.sort(f0))))
        if d > 0:
            return d
    return None


def resolve_auto_priors(priors: PriorTable, params0, layout=None, nu=None,
                        spec=None) -> PriorTable:
    """Return a PriorTable with every AUTO row replaced by a derived prior.

    Raises AutoPriorError, naming the parameter, for any AUTO row outside
    the derivable subset or missing its required inputs (data, layout).
    No-op (same object) when the table has no AUTO rows."""
    kinds = np.asarray(priors.kinds)
    auto_idx = np.nonzero(kinds == int(PriorKind.AUTO))[0]
    if auto_idx.size == 0:
        return priors
    names = list(priors.names) if priors.names else \
        [f"p{i}" for i in range(priors.ndim)]
    new_kinds = kinds.copy()
    new_hypers = np.asarray(priors.hypers, dtype=np.float64).copy()
    p0 = np.asarray(params0, dtype=np.float64)

    spec_np = None if spec is None else np.asarray(spec, dtype=np.float64)
    grid_step = None
    if nu is not None:
        nu_np = np.asarray(nu, dtype=np.float64)
        if nu_np.size >= 2:
            grid_step = float(np.median(np.diff(nu_np)))
    dnu = _dnu_estimate(layout, p0)

    def refuse(i, why):
        raise AutoPriorError(
            f"Auto prior on parameter '{names[i]}' (index {i}) cannot be "
            f"derived: {why}.  Give it an explicit prior — silently fixing "
            "it would change the posterior (SURVEY hard-part 5).")

    for i in auto_idx:
        i = int(i)
        block, _, _ = (None, None, None) if layout is None \
            else _block_of(layout, i)
        if block is None:
            refuse(i, "no ABI block layout available")
        if block == "heights":
            if spec_np is None:
                refuse(i, "needs the observed spectrum for the power scale")
            knee = 0.1 * float(np.median(spec_np))
            hi = 10.0 * float(np.max(spec_np))
            new_kinds[i] = int(PriorKind.JEFFREYS)
            new_hypers[i] = [max(knee, 1e-12), max(hi, 1e-9), 0, 0]
        elif block.startswith("freq_l"):
            if dnu is None and grid_step is None:
                refuse(i, "needs a freq_l0 comb or a frequency grid to set "
                          "the window half-width")
            half = max(0.25 * dnu if dnu else 0.0,
                       20.0 * grid_step if grid_step else 0.0)
            if half <= 0:
                refuse(i, "derived window half-width is zero")
            new_kinds[i] = int(PriorKind.UNIFORM)
            new_hypers[i] = [p0[i] - half, p0[i] + half, 0, 0]
        elif block == "widths":
            if grid_step is None or dnu is None:
                refuse(i, "needs the frequency grid AND a freq_l0 comb")
            new_kinds[i] = int(PriorKind.JEFFREYS)
            new_hypers[i] = [grid_step, 0.5 * dnu, 0, 0]
        elif block == "noise":
            off = layout.offset("noise")
            size = layout.size("noise")
            if i != off + size - 1:
                refuse(i, "only the white-noise floor (last noise entry) "
                          "has a data-driven rule; Harvey shape parameters "
                          "need explicit priors")
            if spec_np is None:
                refuse(i, "needs the observed spectrum")
            med = float(np.median(spec_np))
            new_kinds[i] = int(PriorKind.JEFFREYS)
            new_hypers[i] = [max(0.1 * med, 1e-12), max(10.0 * med, 1e-9),
                             0, 0]
        elif block == "inclination":
            new_kinds[i] = int(PriorKind.UNIFORM)
            new_hypers[i] = [0.0, math.pi / 2, 0, 0]
        elif block == "mode":
            # single-Lorentzian family ABI: [H, nu0, Gamma] (test_models.py)
            pos = i - layout.offset("mode")
            if nu is None:
                refuse(i, "needs the frequency grid")
            span = float(nu_np[-1] - nu_np[0])
            if pos == 0:
                if spec_np is None:
                    refuse(i, "needs the observed spectrum for the power "
                              "scale")
                new_kinds[i] = int(PriorKind.JEFFREYS)
                new_hypers[i] = [max(0.1 * float(np.median(spec_np)), 1e-12),
                                 max(10.0 * float(np.max(spec_np)), 1e-9),
                                 0, 0]
            elif pos == 1:
                half = 0.1 * span
                new_kinds[i] = int(PriorKind.UNIFORM)
                new_hypers[i] = [p0[i] - half, p0[i] + half, 0, 0]
            elif pos == 2:
                new_kinds[i] = int(PriorKind.JEFFREYS)
                new_hypers[i] = [max(grid_step or 1e-6, 1e-9), 0.1 * span,
                                 0, 0]
            else:
                refuse(i, f"mode-block position {pos} has no derivable rule")
        else:
            refuse(i, f"block '{block}' has no derivable rule")

    return PriorTable(new_kinds.astype(np.int32), new_hypers, priors.names)
