"""Analytic smoke-test models (port of tamcmc_tpu/models/test_models.py;
reference `model_Test_Gaussian`, `model_Harvey_Gaussian` [U]), BASELINE
config 1's single Lorentzian + white noise, config 2's pure Harvey
background, and the Kallinger (2014) background.

Every `model_fn(params (..., D), nu (N,), fixed=None) -> (..., N)` is batched
over leading dims; `fixed` is the Problem's (params0, fixed mask) hand-off,
used by the builders whose background is `noise_background`.
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.models.common import fixed_noise
from tamcmc_tpu_torch.ops.lorentzian import lorentzian_profile
from tamcmc_tpu_torch.ops.noise import kallinger2014, noise_background
from tamcmc_tpu_torch.utils.blocks import BlockLayout


def _gaussian(nu, g, floor):
    """A exp(-(nu - mu)^2 / (2 sigma^2)) from a (..., 3) [A, mu, sigma]
    block, sigma floored."""
    A, mu, sig = (g[..., i, None] for i in range(3))
    sig = torch.clamp(sig, min=floor)
    return A * torch.exp(-0.5 * ((nu - mu) / sig) ** 2)


@dataclasses.dataclass(frozen=True)
class TestGaussianSpec:
    """params: [A, mu, sigma, white]."""

    def layout(self):
        return BlockLayout.make([("gauss", 3), ("noise", 1)])


def build_test_gaussian(spec: TestGaussianSpec):
    layout = spec.layout()

    def model_fn(params, nu, fixed=None):
        white = torch.clamp(params[..., 3, None], min=0.0)
        return _gaussian(nu, params[..., 0:3], 1e-6) + white

    return model_fn, layout


@dataclasses.dataclass(frozen=True)
class HarveyGaussianSpec:
    """params: [A1, B1, p1, ..., white] + [Ag, mug, sigg] (noise first, the
    reference's Harvey_Gaussian order [U])."""
    n_harvey: int = 1

    def layout(self):
        return BlockLayout.make([("noise", 3 * self.n_harvey + 1),
                                 ("gauss", 3)])


def build_harvey_gaussian(spec: HarveyGaussianSpec):
    layout = spec.layout()

    def model_fn(params, nu, fixed=None):
        bg = noise_background(nu, layout.get(params, "noise"),
                              n_harvey=spec.n_harvey,
                              const=fixed_noise(layout, fixed))
        return bg + _gaussian(nu, layout.get(params, "gauss"), 1e-6)

    return model_fn, layout


@dataclasses.dataclass(frozen=True)
class SingleLorentzianSpec:
    """BASELINE config 1: one Lorentzian + white noise.
    params: [H, nu0, Gamma, white]."""

    def layout(self):
        return BlockLayout.make([("mode", 3), ("noise", 1)])


def build_single_lorentzian(spec: SingleLorentzianSpec):
    layout = spec.layout()

    def model_fn(params, nu, fixed=None):
        H, nu0, W = (params[..., i, None] for i in range(3))
        white = torch.clamp(params[..., 3, None], min=1e-9)
        return lorentzian_profile(nu, H, nu0, W) + white

    return model_fn, layout


@dataclasses.dataclass(frozen=True)
class HarveyBackgroundSpec:
    """BASELINE config 2: pure noise-background fit (3 Harvey + white).
    params: [A1, B1, p1, A2, B2, p2, A3, B3, p3, N0]."""
    n_harvey: int = 3

    def layout(self):
        return BlockLayout.make([("noise", 3 * self.n_harvey + 1)])


def build_harvey_background(spec: HarveyBackgroundSpec):
    layout = spec.layout()

    def model_fn(params, nu, fixed=None):
        bg = noise_background(nu, layout.get(params, "noise"),
                              n_harvey=spec.n_harvey,
                              const=fixed_noise(layout, fixed))
        # with every term fixed the background is one unbatched row
        return bg.expand(params.shape[:-1] + nu.shape)

    return model_fn, layout


@dataclasses.dataclass(frozen=True)
class Kallinger2014Spec:
    """Kallinger et al. (2014) two-component granulation background plus an
    optional Gaussian p-mode envelope.
    params: [a1, b1, a2, b2, W] (+ [Agauss, numax, sigma] if with_gaussian).
    """
    nu_nyquist: float = 283.2       # Kepler long cadence [uHz]
    with_gaussian: bool = True

    def layout(self):
        spec = [("noise", 5)]
        if self.with_gaussian:
            spec.append(("gauss", 3))
        return BlockLayout.make(spec)


def build_kallinger2014(spec: Kallinger2014Spec):
    layout = spec.layout()

    def model_fn(params, nu, fixed=None):
        bg = kallinger2014(nu, layout.get(params, "noise"), spec.nu_nyquist)
        if spec.with_gaussian:
            bg = bg + _gaussian(nu, layout.get(params, "gauss"), 1e-3)
        return bg

    return model_fn, layout
