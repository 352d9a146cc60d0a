"""MS Global model family, the "peak bagging" models (port of
tamcmc_tpu/models/ms_global.py; reference `model_MS_Global_*` [U]).

Block ABI (BlockLayout, the reference's plength order):
  heights (N0,), visibilities (lmax,), freq_l0..freq_l3, rot (by rotation
  law, see MSGlobalSpec.rot_size), widths (N0,) or the 6 parameters of the
  width relation, noise (3*nh+1,), inclination (1,) [rad], trunc (1,).

`model_fn(params (..., D), nu (N,), fixed=None) -> (..., N)` is batched over
leading dims; `fixed` is the Problem's (params0, fixed mask) hand-off
(models/common.py fixed_noise).  Widths are free per order, or the
Appourchaux+2016 relation (`width_kind="app2016"`, ops/widths.py) over the
l=0 ridge.  With a `window_hint` the Lorentzian sum runs over static window
segments anchored at params0 (the reference's c*Gamma truncation algorithm)
through the segment-mode kernels on CUDA; without one, through the dense
mode.  The build's `precision` picks the profile stream (ops/lorentzian.py)
of every call and of the plan.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tamcmc_tpu_torch.models.common import (
    assemble_components_a1etaa3, assemble_components_a1x,
    assemble_components_aj, assemble_components_ajAlm, dnu_from_freqs,
    fixed_noise)
from tamcmc_tpu_torch.ops.lorentzian import (
    make_static_window_groups, partition_window_groups, segment_values,
    sum_lorentzians, sum_lorentzians_segments)
from tamcmc_tpu_torch.ops.lorentzian_kernel import (check_precision,
                                                    dense_plan, segment_plan)
from tamcmc_tpu_torch.ops.noise import (noise_background,
                                        noise_background_parts)
from tamcmc_tpu_torch.ops.widths import appourchaux2016_width
from tamcmc_tpu_torch.utils.blocks import BlockLayout
from tamcmc_tpu_torch.utils.constants import DNU_SUN, G_CGS, RHO_SUN


@dataclasses.dataclass(frozen=True)
class MSGlobalSpec:
    """Static structure of an MS-Global problem (fixes all shapes)."""
    n_per_l: tuple          # mode counts for l=0..3, e.g. (6, 6, 6, 0)
    n_harvey: int = 3
    rotation: str = "a1etaa3"   # a1etaa3 | a1a2a3 | a1l | a1n | a1nl | aj | ajAlm
    alm_filter: str = "gate"    # ajAlm's activity filter (ops/alm.py)
    noise_kind: str = "harvey_like"   # or "harvey_1985"
    width_kind: str = "free"          # or "app2016" (6-parameter relation)
    window_hint: tuple = None   # (params0_tuple, nu_start, nu_step, n_bins,
                                # margin_uHz) -> static window segments; a
                                # tuple of params0 tuples (a stacked
                                # ensemble) takes the union of their windows

    @property
    def lmax(self):
        return max(l for l, n in enumerate(self.n_per_l) if n > 0 or l == 0)

    def rot_size(self) -> int:
        # the rot block per rotation law:
        #  a1etaa3 [a1, eta_sw, a3, asym]
        #  a1a2a3  [a1, a2, a3, asym]   (a2 fitted directly, no eta term)
        #  a1l     [a1_l1, a1_l2, eta_sw, a3, asym]   (l=3 takes the mean)
        #  a1n     [a1_0..a1_{N0-1}, eta_sw, a3, asym]
        #  a1nl    [a1l1_0.., a1l2_0.., eta_sw, a3, asym]
        #  aj      [a1..a6, eta_sw, asym]
        #  ajAlm   [a1, a3, a5, eta_sw, epsilon, theta0, delta, asym]
        n0 = self.n_per_l[0]
        return {"a1etaa3": 4, "a1a2a3": 4, "a1l": 5, "a1n": n0 + 3,
                "a1nl": 2 * n0 + 3, "aj": 8, "ajAlm": 8}[self.rotation]

    def width_size(self) -> int:
        return self.n_per_l[0] if self.width_kind == "free" else 6

    def layout(self) -> BlockLayout:
        spec = [("heights", self.n_per_l[0]),
                ("visibilities", max(self.lmax, 1) if self.lmax >= 1 else 0)]
        for l in range(4):
            spec.append((f"freq_l{l}",
                         self.n_per_l[l] if l < len(self.n_per_l) else 0))
        spec += [("rot", self.rot_size()),
                 ("widths", self.width_size()),
                 ("noise", 3 * self.n_harvey + 1),
                 ("inclination", 1),
                 ("trunc", 1)]
        return BlockLayout.make(spec)


ROTATIONS = ("a1etaa3", "a1a2a3", "a1l", "a1n", "a1nl", "aj", "ajAlm")


def _eta0_ingraph(f0, switch):
    """eta0 [s^2] from the in-graph Dnu scaling where switch > 0.5, else 0:
    eta0 = 3 pi / (G rho_sun (Dnu/Dnu_sun)^2)."""
    dnu = dnu_from_freqs(f0)
    # a true division (python-scalar / tensor would be a reciprocal-multiply)
    ratio = torch.full_like(dnu, DNU_SUN) / dnu
    eta0 = 3.0 * math.pi / (G_CGS * RHO_SUN) * ratio ** 2
    return torch.where(switch > 0.5, eta0, torch.zeros_like(eta0))


def _window_segments(assemble, layout, window_hint):
    """Static disjoint window segments anchored at params0 (host side).

    The components are assembled from the float32 params0 on the CPU and the
    window bounds formed in float32, the reference's arithmetic, so both
    packages cut the grid into the same segments.  With one params0 per
    star (a stacked ensemble's hint) each component's window is the union
    of the stars' windows, so one segment plan serves every star."""
    p0_t, nu_start, nu_step, n_bins, margin = window_hint
    stars = (p0_t if p0_t and isinstance(p0_t[0], (tuple, list))
             else (p0_t,))
    lo = hi = None
    for star_p0 in stars:
        p0 = torch.as_tensor(np.asarray(star_p0, dtype=np.float32))
        with torch.no_grad():
            _, C0, W0, _, _ = assemble(p0)
        trunc0 = float(layout.get(p0, "trunc")[0]) or 40.0
        hw = trunc0 * np.maximum(W0.numpy(), 1e-3) + float(margin)
        C0 = C0.numpy()
        lo = C0 - hw if lo is None else np.minimum(lo, C0 - hw)
        hi = C0 + hw if hi is None else np.maximum(hi, C0 + hw)
    return partition_window_groups(make_static_window_groups(
        0.5 * (lo + hi), 0.5 * (hi - lo), nu_start, nu_step, int(n_bins)))


def build_ms_global(spec: MSGlobalSpec, precision: str = "f32"):
    """Return (model_fn, layout): model_fn(params (..., D), nu) -> (..., N).

    model_fn carries `_assemble` (params -> component arrays and noise
    block), `_background` (noise block -> background on a grid), `_spec`,
    the `_chi22p_inputs` hook of the fused likelihood and, with
    spec.window_hint, `_window_groups` (the disjoint segments), `_plan`
    (their kernel plan, built once here) and the `_segments_and_bg` hook of
    the piece-wise likelihood."""
    if spec.rotation not in ROTATIONS:
        raise ValueError(f"unknown rotation {spec.rotation!r}; have "
                         f"{', '.join(ROTATIONS)}")
    if spec.width_kind not in ("free", "app2016"):
        raise ValueError(f"unknown width_kind {spec.width_kind!r}")
    check_precision(precision)
    layout = spec.layout()
    n_per_l = tuple(spec.n_per_l) + (0,) * (4 - len(spec.n_per_l))
    n0 = n_per_l[0]

    def assemble(params):
        heights = layout.get(params, "heights")
        widths = layout.get(params, "widths")
        if spec.width_kind == "app2016":
            # the 6-parameter relation on the l=0 ridge; l>0 widths then
            # come from the usual interpolation
            widths = appourchaux2016_width(
                layout.get(params, "freq_l0"),
                *(widths[..., i, None] for i in range(6)))
        vis = layout.get(params, "visibilities")
        freqs_per_l = [layout.get(params, f"freq_l{l}") for l in range(4)]
        rot = layout.get(params, "rot")
        noise = layout.get(params, "noise")
        inc = layout.get(params, "inclination")[..., 0]
        common = (freqs_per_l, heights, widths, vis, inc)
        if spec.rotation == "a1etaa3":
            a1, sw, a3, asym = (rot[..., i] for i in range(4))
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_a1etaa3(*common, a1, eta0, a3,
                                                     asym)
        elif spec.rotation == "a1a2a3":
            # nu_nlm = nu + a1 P1(m) + a2 P2(m) + a3 P3(m), no eta term
            a1, a2, a3, asym = (rot[..., i] for i in range(4))
            zero = torch.zeros_like(a1)
            aj6 = torch.stack([a1, a2, a3, zero, zero, zero], -1)
            H, C, W, B = assemble_components_aj(*common, aj6, zero, asym)
        elif spec.rotation in ("a1l", "a1n", "a1nl"):
            if spec.rotation == "a1l":
                a1_1, a1_2 = rot[..., 0:1], rot[..., 1:2]
                sw, a3, asym = rot[..., 2], rot[..., 3], rot[..., 4]
                # l=0 has no splitting; l=3 takes the mean of l=1 and 2 [U]
                a1_per_l = [a1_1, a1_1, a1_2, 0.5 * (a1_1 + a1_2)]
            elif spec.rotation == "a1n":
                a1n = rot[..., 0:n0]
                sw, a3, asym = (rot[..., n0 + i] for i in range(3))
                a1_per_l = [a1n[..., :n_per_l[l]] for l in range(4)]
            else:           # a1nl: per-order tables for l=1 and for l=2
                a1n1, a1n2 = rot[..., 0:n0], rot[..., n0:2 * n0]
                sw, a3, asym = (rot[..., 2 * n0 + i] for i in range(3))
                a1m = 0.5 * (a1n1 + a1n2)
                a1_per_l = [a1n1[..., :n_per_l[0]], a1n1[..., :n_per_l[1]],
                            a1n2[..., :n_per_l[2]], a1m[..., :n_per_l[3]]]
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_a1x(*common, a1_per_l, eta0, a3,
                                                 asym)
        elif spec.rotation == "ajAlm":
            a1, a3, a5, sw, epsilon, theta0, delta, asym = (
                rot[..., i] for i in range(8))
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_ajAlm(
                *common, a1, a3, a5, eta0, epsilon, theta0, delta, asym,
                filter_kind=spec.alm_filter)
        else:               # aj
            aj = rot[..., 0:6]
            sw, asym = rot[..., 6], rot[..., 7]
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_aj(*common, aj, eta0, asym)
        return H, C, W, B, noise

    groups = plan = None
    if spec.window_hint is not None:
        groups = _window_segments(assemble, layout, spec.window_hint)
        ncomp = sum(n * (2 * l + 1) for l, n in enumerate(spec.n_per_l))
        plan = segment_plan(groups, ncomp, int(spec.window_hint[3]),
                            precision=precision)

    def background(nu, noise, const=None):
        """The background of a noise block on the bins `nu`; const: as
        ops/noise.py noise_background's."""
        return noise_background(nu, noise, n_harvey=spec.n_harvey,
                                kind=spec.noise_kind, const=const)

    def model_fn(params, nu, fixed=None):
        H, C, W, B, noise = assemble(params)
        if groups is not None:
            modes = sum_lorentzians_segments(nu, H, C, W, B, groups, plan,
                                             precision)
        else:
            modes = sum_lorentzians(nu, H, C, W, B, precision)
        return modes + background(nu, noise, fixed_noise(layout, fixed))

    def chi22p_inputs(params, nu, fixed=None):
        """(H, C, W, B, plan, bg_n, bg_b) of ops/lorentzian.py
        lorentzian_chi22p: the components, the segment plan (the dense one
        without a window hint) and the background split into its part no
        walker changes and its per-walker part (ops/noise.py
        noise_background_parts).  fixed: as model_fn's."""
        H, C, W, B, noise = assemble(params)
        # without pieces the background alone carries the walkers' shape
        const = fixed_noise(layout, fixed) if groups != () else None
        bg_n, bg_b = noise_background_parts(
            nu, noise, n_harvey=spec.n_harvey, kind=spec.noise_kind,
            const=const)
        use = plan if groups is not None else dense_plan(
            nu.shape[0], H.shape[-1], precision=precision)
        return H, C, W, B, use, bg_n, bg_b

    model_fn._assemble = assemble      # params -> (H, C, W, B, noise)
    model_fn._background = background  # (nu, noise, const) -> background
    model_fn._spec = spec              # the spec this model was built from
    model_fn._window_groups = groups
    model_fn._plan = plan
    model_fn._chi22p_inputs = chi22p_inputs
    if groups is not None:
        def segments_and_bg(params, nu, fixed=None):
            """The partition's piece values plus a background evaluator on
            bins [lo, hi), without the assembled spectrum; feeds
            likelihood_chi22p_pieces.

            fixed: as model_fn's."""
            H, C, W, B, noise = assemble(params)
            # without pieces the background alone carries the walkers' shape
            const = fixed_noise(layout, fixed) if groups else None

            def bg_fn(lo, hi):
                return background(nu[lo:hi], noise, const)

            return segment_values(nu, H, C, W, B, groups, plan,
                                  precision), bg_fn

        model_fn._segments_and_bg = segments_and_bg
    return model_fn, layout
