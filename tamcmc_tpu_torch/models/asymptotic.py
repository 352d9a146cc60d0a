"""RGB / subgiant asymptotic model family: dense l=1 mixed modes (port of
tamcmc_tpu/models/asymptotic.py; reference `model_RGB_asympt_*`, `models.cpp`
+ `external/ARMM` [U]).

l=0 and l=2 p modes are fitted individually; the l=1 forest of mixed modes
is generated from the asymptotic period-spacing relation (DPi1, eps_g, q) by
the ARMM solver (ops/armm.py), each mode's width and splitting scaled by its
g-mode inertia fraction zeta:
  width_1    = W_p(nu) (1 - zeta), floored at 0.005 uHz
  height_1   = H_p(nu) V^2_1                        height_kind "equipartition"
             = H_p(nu) V^2_1 (1 - zeta)             height_kind "inertia"
  splitting  = m (zeta a1_core / 2 + (1 - zeta) a1_env)
Dnu and eps_p for the solver come from an in-graph least-squares line fit of
freq_l0 against radial order.

Block ABI (the reference's):
  heights (N0,)  visibilities (2,) [V^2_1, V^2_2]  freq_l0 (N0,)  freq_l2 (N0,)
  mixed (6,) [DPi1 s, eps_g, q, delta0l uHz, alpha_p, alpha_g]
  rot (3,) [a1_env, a1_core, asym]  widths (N0,) or (6,) for app2016
  noise (3nh+1,)  inclination (1,)  trunc (1,)
  per_mode "hw": + mix_hfact, mix_wfact (n_mixed,) factor tables
  per_mode "hw_scatter": + mix_fshift (n_mixed,) frequency scatter [uHz]

`model_fn(params (..., D), nu (N,), fixed=None) -> (..., N)` is batched over
leading dims.  The Lorentzian sum is the dense routed `sum_lorentzians`: on
CUDA tensors the hand-written kernels in dense mode.
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.models.common import fixed_noise, interp_monotonic
from tamcmc_tpu_torch.ops.armm import mixed_mode_frequencies
from tamcmc_tpu_torch.ops.lorentzian import sum_lorentzians
from tamcmc_tpu_torch.ops.lorentzian_kernel import (check_precision,
                                                    dense_plan)
from tamcmc_tpu_torch.ops.noise import (noise_background,
                                        noise_background_parts)
from tamcmc_tpu_torch.ops.visibilities import mode_visibility
from tamcmc_tpu_torch.ops.widths import appourchaux2016_width
from tamcmc_tpu_torch.utils.blocks import BlockLayout
from tamcmc_tpu_torch.utils.metrics import span


@dataclasses.dataclass(frozen=True)
class RGBAsymptSpec:
    n_orders: int               # l=0 (and l=2) radial orders
    numin: float                # mixed-mode search window (static)
    numax_win: float
    n_p_poles: int              # static pole-count pads (armm.count_poles)
    n_g_poles: int
    n_harvey: int = 3
    width_kind: str = "free"    # or "app2016" (6-parameter relation)
    height_kind: str = "equipartition"  # or "inertia"
    noise_kind: str = "harvey_like"     # or "harvey_1985"
    per_mode: str = "none"      # "none", "hw" or "hw_scatter": per-mode
                                # factor tables (x1 = the asymptotic value)
                                # and frequency scatter (0 = exact)

    @property
    def n_mixed(self) -> int:
        """Padded mixed-mode count (the solver's output size)."""
        return self.n_p_poles + self.n_g_poles - 1

    def layout(self) -> BlockLayout:
        n0 = self.n_orders
        nw = n0 if self.width_kind == "free" else 6
        spec = [("heights", n0), ("visibilities", 2),
                ("freq_l0", n0), ("freq_l2", n0),
                ("mixed", 6), ("rot", 3),
                ("widths", nw), ("noise", 3 * self.n_harvey + 1),
                ("inclination", 1), ("trunc", 1)]
        # per-mode blocks append, so every other block keeps its offset
        if self.per_mode in ("hw", "hw_scatter"):
            spec += [("mix_hfact", self.n_mixed), ("mix_wfact", self.n_mixed)]
        if self.per_mode == "hw_scatter":
            spec += [("mix_fshift", self.n_mixed)]
        if self.per_mode not in ("none", "hw", "hw_scatter"):
            raise ValueError(f"unknown per_mode {self.per_mode!r}")
        return BlockLayout.make(spec)


def _flat(t):
    """(..., n, m) -> (..., n*m), mode-major as the reference concatenates."""
    return t.reshape(t.shape[:-2] + (-1,))


def _ridge_fit(f0):
    """In-graph Dnu and eps_p (...,) from a least-squares line of the l=0
    ridge f0 (..., n0) against radial order."""
    k = torch.arange(f0.shape[-1], dtype=f0.dtype, device=f0.device)
    dk = k - k.mean()
    fbar = f0.mean(-1)
    dnu = torch.clamp((dk * (f0 - fbar[..., None])).sum(-1)
                      / (dk * dk).sum(), min=0.1)
    intercept = fbar - dnu * k.mean()
    return dnu, torch.remainder(intercept / dnu, 1.0)


def build_rgb_asympt(spec: RGBAsymptSpec, precision: str = "f32"):
    """Return (model_fn, layout); model_fn carries `_assemble` (params ->
    (H, C, W, B, noise), components ordered l=0, l=2, l=1), `_background`
    (noise block -> background on a grid) and the `_chi22p_inputs` hook of
    the fused likelihood.  `precision` is the Lorentzian
    profile stream's ("f32" | "bf16", ops/lorentzian.py)."""
    if spec.height_kind not in ("equipartition", "inertia"):
        raise ValueError(f"unknown height_kind {spec.height_kind!r}")
    if spec.width_kind not in ("free", "app2016"):
        raise ValueError(f"unknown width_kind {spec.width_kind!r}")
    check_precision(precision)
    layout = spec.layout()

    def assemble(params):
        heights = layout.get(params, "heights")
        widths = layout.get(params, "widths")
        f0 = layout.get(params, "freq_l0")
        if spec.width_kind == "app2016":
            widths = appourchaux2016_width(
                f0, *(widths[..., i, None] for i in range(6)))
        vis = layout.get(params, "visibilities")
        f2 = layout.get(params, "freq_l2")
        dpi1, eps_g, q, delta0l, alpha_p, alpha_g = \
            layout.get(params, "mixed").unbind(-1)
        a1_env, a1_core, asym = layout.get(params, "rot").unbind(-1)
        inc = layout.get(params, "inclination")[..., 0]
        noise = layout.get(params, "noise")

        dnu, eps_p = _ridge_fit(f0)

        # l = 0: individual p modes
        hs = [heights * mode_visibility(0, inc)]
        cs, ws = [f0], [widths]
        # l = 2: individual p modes split by a1_env
        eps2 = mode_visibility(2, inc)                         # (..., 5)
        m2 = torch.arange(-2, 3, dtype=f0.dtype, device=f0.device)
        h2 = interp_monotonic(f2, f0, heights) * vis[..., 1:2]
        w2 = interp_monotonic(f2, f0, widths)
        nus2 = f2[..., :, None] + m2 * a1_env[..., None, None]
        hs.append(_flat(h2[..., :, None] * eps2[..., None, :]))
        cs.append(_flat(nus2))
        ws.append(_flat(w2[..., :, None].expand(nus2.shape)))
        # l = 1: the asymptotic mixed-mode forest
        with span("armm.solve"):
            f1, zeta, valid = mixed_mode_frequencies(
                dnu, eps_p, dpi1, eps_g, q, spec.numin, spec.numax_win,
                spec.n_p_poles, spec.n_g_poles,
                delta0l=delta0l, alpha_p=alpha_p, alpha_g=alpha_g)
        if spec.per_mode == "hw_scatter":
            # displace each mode after the solver (zeta keeps its value at
            # the solved frequency), before the height/width interpolation
            f1 = f1 + layout.get(params, "mix_fshift")
        h1 = interp_monotonic(f1, f0, heights) * vis[..., 0:1] * valid
        if spec.height_kind == "inertia":
            h1 = h1 * (1.0 - zeta)
        w1 = torch.clamp(interp_monotonic(f1, f0, widths) * (1.0 - zeta),
                         min=0.005)
        if spec.per_mode in ("hw", "hw_scatter"):
            h1 = h1 * layout.get(params, "mix_hfact")
            w1 = torch.clamp(w1 * layout.get(params, "mix_wfact"), min=0.005)
        split = zeta * a1_core[..., None] / 2.0 \
            + (1.0 - zeta) * a1_env[..., None]
        eps1 = mode_visibility(1, inc)                         # (..., 3)
        m1 = torch.arange(-1, 2, dtype=f0.dtype, device=f0.device)
        nus1 = f1[..., :, None] + m1 * split[..., :, None]
        hs.append(_flat(h1[..., :, None] * eps1[..., None, :]))
        cs.append(_flat(nus1))
        ws.append(_flat(w1[..., :, None].expand(nus1.shape)))

        H, C, W = (torch.cat(t, dim=-1) for t in (hs, cs, ws))
        B = asym[..., None].expand(H.shape)
        return H, C, W, B, noise

    def background(nu, noise, const=None):
        """The background of a noise block on the bins `nu`; const: as
        ops/noise.py noise_background's."""
        return noise_background(nu, noise, n_harvey=spec.n_harvey,
                                kind=spec.noise_kind, const=const)

    def model_fn(params, nu, fixed=None):
        H, C, W, B, noise = assemble(params)
        return sum_lorentzians(nu, H, C, W, B, precision) + background(
            nu, noise, fixed_noise(layout, fixed))

    def chi22p_inputs(params, nu, fixed=None):
        """(H, C, W, B, plan, bg_n, bg_b) of ops/lorentzian.py
        lorentzian_chi22p: the components, the dense plan and the
        background split as ops/noise.py noise_background_parts splits
        it."""
        H, C, W, B, noise = assemble(params)
        bg_n, bg_b = noise_background_parts(
            nu, noise, n_harvey=spec.n_harvey, kind=spec.noise_kind,
            const=fixed_noise(layout, fixed))
        return (H, C, W, B, dense_plan(nu.shape[0], H.shape[-1],
                                       precision=precision), bg_n, bg_b)

    model_fn._spec = spec
    model_fn._assemble = assemble
    model_fn._background = background
    model_fn._chi22p_inputs = chi22p_inputs
    return model_fn, layout
