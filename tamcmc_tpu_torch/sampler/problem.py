"""Problem: immutable bundle of (model, likelihood, priors, data).

Port of tamcmc_tpu/sampler/problem.py (reference `model_def.cpp` [U]).
Fixed ("Fix"/"Auto") parameters are excluded from the sampling space: the
sampler works in the Df-dim free subspace and `embed` rebuilds the full
vector.  Every method is batched over leading dims of its argument.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tamcmc_tpu_torch.ops.lorentzian import lorentzian_chi22p
from tamcmc_tpu_torch.stats.likelihoods import (get_likelihood,
                                                likelihood_chi22p)
from tamcmc_tpu_torch.stats.priors import PriorTable
from tamcmc_tpu_torch.utils.blocks import BlockLayout
from tamcmc_tpu_torch.utils.metrics import span


@dataclasses.dataclass(frozen=True)
class Problem:
    model_fn: Callable            # (full (..., D), nu, fixed=None) -> (..., N)
    layout: BlockLayout
    priors: PriorTable
    nu: torch.Tensor              # (N,) frequency grid
    spec: torch.Tensor            # (N,) observed power spectrum
    params0: torch.Tensor         # (D,) initial/fixed parameter vector
    likelihood: str = "chi22p"
    sigma_spec: Optional[torch.Tensor] = None   # chi_square likelihood
    mask: Optional[torch.Tensor] = None
    extra_logp: Optional[Callable] = None      # cross-parameter constraints
    model_meta: Optional[dict] = None

    def __post_init__(self):
        if self.priors.ndim != self.layout.ndim:
            raise ValueError(f"prior table has {self.priors.ndim} rows, "
                             f"layout {self.layout.ndim}")

    def astype(self, dtype):
        """Copy with nu, spec, params0, sigma_spec and mask cast to `dtype`.

        The f64 validation path (`run --precision f64`, on the CPU or a
        CUDA device, where the Lorentzian sums run the kernels' float64
        instantiation): the reference samples in double precision [U], and
        every state tensor init_state makes follows params0's dtype, so the
        whole sampler then runs in float64.  What the model closure baked in
        at build time (the window segments) stays as built, from float32
        params0, as in the reference's Problem.astype; every tensor it hands
        the kernels is formed from the cast parameters and data, so float64
        (the kernels refuse a mix of types).  The temperature ladder stays
        float32, as the reference's make_beta_ladder builds it."""
        def c(a):
            return None if a is None else a.to(dtype)
        return dataclasses.replace(
            self, nu=c(self.nu), spec=c(self.spec), params0=c(self.params0),
            sigma_spec=c(self.sigma_spec), mask=c(self.mask))

    # ---- free-subspace machinery (static) ----
    @property
    def free_idx(self) -> np.ndarray:
        return np.nonzero(self.priors.free_mask)[0]

    @property
    def ndim_free(self) -> int:
        return int(self.free_idx.shape[0])

    @property
    def free_names(self):
        if self.priors.names and len(self.priors.names) == self.layout.ndim:
            names = list(self.priors.names)
        else:
            names = self.layout.param_names()
        return [names[i] for i in self.free_idx]

    @property
    def _embed_runs(self):
        """Maximal runs of (is_free, full_lo, full_hi, free_lo)."""
        free = self.priors.free_mask
        runs, i, n_free_seen = [], 0, 0
        D = free.shape[0]
        while i < D:
            j = i
            while j < D and free[j] == free[i]:
                j += 1
            runs.append((bool(free[i]), i, j, n_free_seen))
            if free[i]:
                n_free_seen += j - i
            i = j
        return tuple(runs)

    def embed(self, x):
        """(..., Df) free vector -> (..., D) full params, fixed entries from
        params0: a concat of static runs (no scatter).

        The reference builds the same concat so that fixed runs stay
        unbatched constants under vmap: every model subexpression that
        depends only on fixed parameters (the Harvey background when its
        A/B/p are frozen, the common production setup) is computed once per
        step, not once per walker, and gets no gradient.  Eager torch
        materialises the fixed runs into every row, so the port keeps that
        property explicitly instead: `_logL_from_full` hands the model (its
        fused-likelihood hook or its model_fn) (params0, fixed mask), and the
        model evaluates its all-fixed terms once from params0."""
        batch = x.shape[:-1]
        pieces = []
        for is_free, lo, hi, flo in self._embed_runs:
            if is_free:
                pieces.append(x[..., flo:flo + (hi - lo)])
            else:
                pieces.append(self.params0[..., lo:hi].expand(
                    batch + (hi - lo,)))
        return torch.cat(pieces, dim=-1)

    def extract(self, full):
        return full[..., torch.as_tensor(self.free_idx, device=full.device)]

    # ---- log-posterior pieces ----
    def _model_hook(self, name):
        """The model's hook `name` where the fit is chi22p without a
        mask, else None."""
        try:
            is_chi22p = get_likelihood(self.likelihood) is likelihood_chi22p
        except KeyError:
            is_chi22p = False
        if is_chi22p and self.mask is None:
            return getattr(self.model_fn, name, None)
        return None

    @property
    def _pieces_hook(self):
        """The piece-wise chi22p hook of window-partitioned models (their
        segment plan is what `_chi22p_hook` hands the fused likelihood)."""
        return self._model_hook("_segments_and_bg")

    @property
    def _chi22p_hook(self):
        """The fused likelihood's inputs of a Lorentzian spectrum model
        (ops/lorentzian.py lorentzian_chi22p): on the card one forward
        kernel with the likelihood as its epilogue, on the CPU the plain
        chain."""
        return self._model_hook("_chi22p_inputs")

    def _logL_from_full(self, full):
        fixed = (self.params0, ~self.priors.free_mask)
        hook = self._chi22p_hook
        if hook is not None:
            with span("model.assemble"):
                H, C, W, B, plan, bg_n, bg_b = hook(full, self.nu,
                                                    fixed=fixed)
            with span("likelihood"):
                return lorentzian_chi22p(self.nu, self.spec, H, C, W, B,
                                         plan, bg_n, bg_b, plan.precision)
        with span("model.assemble"):
            model = self.model_fn(full, self.nu, fixed=fixed)
        lfn = get_likelihood(self.likelihood)
        with span("likelihood"):
            if self.likelihood == "chi_square":
                return lfn(self.spec, model, self.sigma_spec, self.mask)
            return lfn(self.spec, model, self.mask)

    def _logP_from_full(self, full):
        logP = self.priors.log_prior(full)
        if self.extra_logp is not None:
            logP = logP + self.extra_logp(full)
        return logP

    def log_parts(self, x):
        """x: (..., Df) -> (logL, logP), each (...,); no gradients."""
        with torch.no_grad(), span("logpost"):
            full = self.embed(x)
            logL = self._logL_from_full(full)
            with span("prior"):
                return logL, self._logP_from_full(full)

    def logparts_and_grad(self, x):
        """Values + gradients of both log-posterior pieces, (..., Df) ->
        ((logL, logP), (gradL, gradP)).

        The model+likelihood graph is traversed backward exactly once; the
        prior piece never touches the grid, so its gradient is a separate,
        Df-sized backward.  Walkers are independent, so the gradient of the
        batch sum is each walker's own gradient."""
        with torch.enable_grad(), span("logpost"):
            xl = x.detach().requires_grad_(True)
            logL = self._logL_from_full(self.embed(xl))
            with span("logL.grad"):
                gradL, = torch.autograd.grad(logL.sum(), xl)
            with span("prior"):
                xp = x.detach().requires_grad_(True)
                logP = self._logP_from_full(self.embed(xp))
                # uniform and fixed rows alone make a prior that is constant
                # on its support: no graph reaches x, and the gradient is zero
                gradP = (torch.autograd.grad(logP.sum(), xp)[0]
                         if logP.requires_grad else torch.zeros_like(xp))
        return (logL.detach(), logP.detach()), (gradL, gradP)

    # the reference's vmap-ed forms; the methods above already batch over
    # any leading dims, (T, C, Df) included
    batched_logparts_and_grad = logparts_and_grad
    batched_log_parts = log_parts
