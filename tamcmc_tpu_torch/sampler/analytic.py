"""Analytic targets for sampler validation (port of
tamcmc_tpu/sampler/analytic.py; the role the reference's `model_Test_Gaussian`
plays for the C++ sampler [U]).

A target with a known posterior and no spectrum in the loop: it exercises the
sampler, the ladder and the multi-process runner (parallel/) without a model
or a kernel.  It implements the port's Problem protocol (ndim_free, params0,
free_idx, free_names, extract, embed, log_parts, logparts_and_grad and the
`batched_*` aliases), so every sampler code path runs on it as on a Problem.

`logpdf` and `log_prior` take (..., D) tensors and return (...,).  The state
init treats a problem without a prior table as an identity map (u_center 0,
u_scale 1, initial scales 0.1), as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnalyticProblem:
    """logL = logpdf(x); logP = log_prior(x) (default 0)."""
    logpdf: Callable
    ndim: int
    x0: np.ndarray
    log_prior: Optional[Callable] = None
    device: str = "cpu"

    priors = None              # no prior table: init_state's identity map

    @property
    def ndim_free(self) -> int:
        return int(self.ndim)

    @property
    def params0(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.x0, np.float32),
                               device=self.device)

    @property
    def free_idx(self) -> np.ndarray:
        return np.arange(self.ndim)

    @property
    def free_names(self):
        return [f"x_{i}" for i in range(self.ndim)]

    def extract(self, full):
        return full

    def embed(self, x):
        return x

    def _parts(self, x):
        logL = self.logpdf(x)
        logP = (self.log_prior(x) if self.log_prior is not None
                else torch.zeros((), dtype=x.dtype, device=x.device))
        return logL, logP.expand(logL.shape)

    def log_parts(self, x):
        """x: (..., D) -> (logL, logP), each (...,); no gradients."""
        with torch.no_grad():
            return self._parts(x)

    def logparts_and_grad(self, x):
        """((logL, logP), (gradL, gradP)): one backward of each piece's
        batch sum (walkers are independent, so each row's gradient is its
        own)."""
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            logL, logP = self._parts(xl)
            gradL, = torch.autograd.grad(logL.sum(), xl, retain_graph=True)
            gradP = (torch.autograd.grad(logP.sum(), xl)[0]
                     if logP.requires_grad else torch.zeros_like(xl))
        return (logL.detach(), logP.detach()), (gradL, gradP)

    batched_logparts_and_grad = logparts_and_grad
    batched_log_parts = log_parts


def std_gaussian(ndim: int, device="cpu") -> AnalyticProblem:
    return AnalyticProblem(logpdf=lambda x: -0.5 * torch.sum(x**2, dim=-1),
                           ndim=ndim, x0=np.zeros(ndim), device=device)


def correlated_gaussian(cov: np.ndarray, device="cpu") -> AnalyticProblem:
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                           device=device)

    def logpdf(x):
        # x @ (P @ x) per row
        return -0.5 * torch.sum(x * (x @ prec.T), dim=-1)

    d = cov.shape[0]
    return AnalyticProblem(logpdf=logpdf, ndim=d, x0=np.zeros(d),
                           device=device)


def bimodal_1d(sep: float = 4.0, device="cpu") -> AnalyticProblem:
    """Two unit-variance modes at +-sep/2: exercises tempering mixing."""
    def logpdf(x):
        a = -0.5 * (x[..., 0] - sep / 2) ** 2
        b = -0.5 * (x[..., 0] + sep / 2) ** 2
        return torch.logaddexp(a, b) - math.log(2.0)
    return AnalyticProblem(logpdf=logpdf, ndim=1, x0=np.zeros(1),
                           device=device)
