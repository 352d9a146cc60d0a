"""MS local model family: windowed fits with per-mode free parameters (port
of tamcmc_tpu/models/local.py; reference `model_MS_local_basic`,
`model_MS_local_Hnlm` / `io_local.cpp` [U]).

Unlike the global family, every mode of every degree carries its own free
(height, frequency, width); only the rotation, the inclination and the
(locally flat) noise are shared.  No interpolation and no window segments:
the Lorentzian sum is the dense one over the fit window.

Block ABI:
  height_l{0..3} (N_l,)   per-mode heights
  freq_l{0..3}   (N_l,)   per-mode frequencies [uHz]
  width_l{0..3}  (N_l,)   per-mode widths [uHz]
  hfactor_l{1..3} (l+1,)  Hnlm only: relative power of |m| = 0..l
  rot            (2,)     [a1, asym]
  noise          (1,)     local white-noise level
  inclination    (1,)     basic only

`model_fn(params (..., D), nu (N,), fixed=None) -> (..., N)` is batched over
leading dims; `fixed` is accepted like every model's and unused (there is
no Harvey term to evaluate once).
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.ops.lorentzian import sum_lorentzians
from tamcmc_tpu_torch.ops.lorentzian_kernel import (check_precision,
                                                    dense_plan)
from tamcmc_tpu_torch.ops.rotation import split_frequencies_a1etaa3
from tamcmc_tpu_torch.ops.visibilities import mode_visibility
from tamcmc_tpu_torch.utils.blocks import BlockLayout


def _per_mode_blocks(n_per_l):
    n = tuple(n_per_l) + (0,) * (4 - len(n_per_l))
    return n, [(f"{block}_l{l}", n[l])
               for block in ("height", "freq", "width") for l in range(4)]


@dataclasses.dataclass(frozen=True)
class MSLocalSpec:
    n_per_l: tuple          # mode counts for l = 0..3

    def layout(self) -> BlockLayout:
        _, spec = _per_mode_blocks(self.n_per_l)
        return BlockLayout.make(
            spec + [("rot", 2), ("noise", 1), ("inclination", 1)])


@dataclasses.dataclass(frozen=True)
class MSLocalHnlmSpec:
    """Local fit with free azimuthal height ratios (reference
    `model_MS_local_Hnlm` [U]): each degree carries a free per-|m| height
    factor vector (symmetric in +-m) instead of the inclination law.  Used
    where magnetism or activity breaks that law."""
    n_per_l: tuple

    def layout(self) -> BlockLayout:
        n, spec = _per_mode_blocks(self.n_per_l)
        spec += [(f"hfactor_l{l}", (l + 1) if n[l] else 0)
                 for l in range(1, 4)]
        return BlockLayout.make(spec + [("rot", 2), ("noise", 1)])


def _build_local(layout, n_per_l, m_weights, precision):
    """(model_fn, layout) of a local model: `m_weights(params, l)` gives the
    (..., 2l+1) relative powers of degree l's m = -l..l components;
    `precision` is the Lorentzian profile stream's."""
    check_precision(precision)
    n = tuple(n_per_l) + (0,) * (4 - len(n_per_l))

    def assemble(params):
        rot = layout.get(params, "rot")
        a1, asym = rot[..., 0], rot[..., 1]
        zero = torch.zeros_like(a1)
        hs, cs, ws, bs = [], [], [], []
        for l in range(4):
            if n[l] == 0:
                continue
            h_l = layout.get(params, f"height_l{l}")
            f_l = layout.get(params, f"freq_l{l}")
            w_l = layout.get(params, f"width_l{l}")
            eps = m_weights(params, l)
            nus = split_frequencies_a1etaa3(l, f_l, a1[..., None], zero, zero)
            H = h_l[..., :, None] * eps[..., None, :]
            W = w_l[..., :, None].expand(nus.shape)
            B = asym[..., None, None].expand(nus.shape)
            for acc, t in ((hs, H), (cs, nus), (ws, W), (bs, B)):
                acc.append(t.reshape(t.shape[:-2] + (-1,)))
        return (torch.cat(hs, -1), torch.cat(cs, -1), torch.cat(ws, -1),
                torch.cat(bs, -1), layout.get(params, "noise"))

    def background(nu, noise, const=None):
        """The flat white level (..., 1) of a noise block; `nu` and `const`
        are taken like every spectrum model's hook and unused."""
        return torch.clamp(noise, min=1e-9)

    def model_fn(params, nu, fixed=None):
        H, C, W, B, noise = assemble(params)
        return sum_lorentzians(nu, H, C, W, B, precision) \
            + background(nu, noise)

    def chi22p_inputs(params, nu, fixed=None):
        """(H, C, W, B, plan, bg_n, bg_b) of ops/lorentzian.py
        lorentzian_chi22p: the components, the dense plan, no shared
        background and the white level (..., 1) per walker."""
        H, C, W, B, noise = assemble(params)
        return (H, C, W, B, dense_plan(nu.shape[0], H.shape[-1],
                                       precision=precision),
                None, background(nu, noise))

    model_fn._assemble = assemble      # params -> (H, C, W, B, noise)
    model_fn._background = background  # (nu, noise, const) -> background
    model_fn._chi22p_inputs = chi22p_inputs
    return model_fn, layout


def build_ms_local(spec: MSLocalSpec, precision: str = "f32"):
    layout = spec.layout()

    def m_weights(params, l):
        return mode_visibility(l, layout.get(params, "inclination")[..., 0])

    return _build_local(layout, spec.n_per_l, m_weights, precision)


def build_ms_local_hnlm(spec: MSLocalHnlmSpec, precision: str = "f32"):
    layout = spec.layout()

    def m_weights(params, l):
        if l == 0:
            return params.new_ones((1,))
        # free |m| factors, mirrored to m = -l..l
        hf = layout.get(params, f"hfactor_l{l}")             # (..., l+1)
        return torch.cat([hf.flip(-1), hf[..., 1:]], -1)     # (..., 2l+1)

    return _build_local(layout, spec.n_per_l, m_weights, precision)
