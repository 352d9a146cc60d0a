"""Adaptive truncated-drift MALA step (Atchade 2006), batched over all
(T temperatures x C walkers).  Port of tamcmc_tpu/sampler/mala.py (reference
`MALA::D_MALA` + Robbins-Monro updates in `MALA.cpp` [U]).

Proposal:    x' = x + (sigma^2/2) Sigma D(x) + sigma chol(Sigma) xi
Truncation:  D(x) = g * min(1, delta/|g|),  g = beta gradL + gradP
Acceptance:  log a = beta dlogL + dlogP + log q(x|x') - log q(x'|x)
Adaptation:  mu, Sigma by the ensemble or walker estimator; log sigma by
             Robbins-Monro toward the target acceptance; gamma_k =
             c0/(k0 + k)^alpha.  The Cholesky factor refreshes every
             dN_chol steps (host-integer step counter, no device sync).

A stacked ensemble (sampler/ensemble.py) runs the same step with a leading
star axis: theta (S, T, C, Df), the per-star vectors (scales0, u_center,
u_scale) (S, Df).  Walker moments reduce over C only, never over S; with S
absent every tensor and every operation is the single-star step's.
"""

from __future__ import annotations

import numpy as np
import torch

from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState
from tamcmc_tpu_torch.stats.priors import PriorKind
from tamcmc_tpu_torch.utils.metrics import span


def _truncate_drift(g, delta):
    """Scale each walker's gradient to norm <= delta."""
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(delta / torch.clamp(norm, min=1e-30), max=1.0)


def _batched_tri_inverse(chol):
    """inv(L) per walker by one batched triangular solve against I."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype,
                    device=chol.device).expand(chol.shape)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def _matvec(m, v):
    return torch.einsum("tcij,tcj->tci" if v.ndim == 3 else
                        "stcij,stcj->stci", m, v)


def _per_walker(v):
    """A per-star (..., Df) vector broadcast against (..., T, C, Df)."""
    return v[..., None, None, :]


def default_init_scales(problem) -> np.ndarray:
    """Per-free-parameter step scales from the prior table: Gaussian
    sigma/10; uniform-like range/100; Jeffreys max/100; else |p0|/100.
    Computed in params0's dtype (float32), as the reference does.  An
    analytic target without a prior table gets 0.1."""
    if getattr(problem, "priors", None) is None:
        return np.full(problem.ndim_free, 0.1)
    kinds = np.asarray(problem.priors.kinds)
    hyp = np.asarray(problem.priors.hypers)
    p0 = problem.params0.detach().cpu().numpy()
    scales = np.maximum(np.abs(p0) * 0.01, 1e-6)
    for i in range(kinds.shape[0]):
        k = kinds[i]
        if k == int(PriorKind.GAUSSIAN):
            scales[i] = max(hyp[i, 1] * 0.1, 1e-8)
        elif k in (int(PriorKind.UNIFORM), int(PriorKind.UNIFORM_GAUSSIAN),
                   int(PriorKind.GUG)):
            scales[i] = max((hyp[i, 1] - hyp[i, 0]) * 0.01, 1e-8)
        elif k == int(PriorKind.JEFFREYS):
            scales[i] = max(hyp[i, 1] * 0.01, 1e-8)
    return scales[problem.free_idx]


def init_state(problem: Problem, hp: MALAHyper, n_temps: int, n_chains: int,
               generator: torch.Generator, init_scales=None,
               jitter: float = 1e-4, block=None) -> SamplerState:
    """All walkers at params0 (+ jitter), Sigma = identity in u-space
    (u_scale = init_scales, u_center = params0's free part).  A problem
    without a prior table (sampler/analytic.py) keeps the identity map
    (u_center 0, u_scale 1) and starts Sigma at diag(init_scales^2), as the
    reference does.

    block: (rung slice, walker slice) of one rank of a mesh run: the jitter
    is drawn for all (T, C) walkers, as the local run draws it, and only the
    block's walkers are kept and evaluated (mesh.STATE_SPLIT's layout)."""
    Df = problem.ndim_free
    x0 = problem.extract(problem.params0)
    dt, dev = x0.dtype, x0.device
    if init_scales is None:
        init_scales = default_init_scales(problem)
    phys = torch.as_tensor(np.asarray(init_scales), dtype=dt, device=dev)
    if getattr(problem, "priors", None) is None:
        u_scale = torch.ones(Df, dtype=dt, device=dev)
        u_center = torch.zeros_like(x0)
        scales = phys                                   # u-space
    else:
        u_scale = phys
        u_center = x0
        scales = torch.ones(Df, dtype=dt, device=dev)  # u-space
    noise = torch.randn((n_temps, n_chains, Df), generator=generator,
                        dtype=dt, device=dev)
    if block is not None:
        noise = noise[block].contiguous()
    TC = tuple(noise.shape[:2])
    n_temps = TC[0]
    theta0 = ((x0 - u_center) / u_scale).expand(TC + (Df,)) \
        + jitter * scales * noise
    (logL, logP), (gL, gP) = problem.batched_logparts_and_grad(
        u_center + u_scale * theta0)
    eye = torch.eye(Df, dtype=dt, device=dev)
    sigma0 = hp.sigma0_scale * 2.38 / np.sqrt(max(Df, 1))
    return SamplerState(
        theta=theta0, logL=logL, logP=logP,
        gradL=gL * u_scale, gradP=gP * u_scale,
        mu=((x0 - u_center) / u_scale).expand(TC + (Df,)).clone(),
        cov=(eye * scales**2).expand(TC + (Df, Df)).clone(),
        chol=(eye * scales).expand(TC + (Df, Df)).clone(),
        ichol=((eye / scales).expand(TC + (Df, Df)).clone() if hp.use_drift
               else torch.zeros(TC + (Df, Df), dtype=dt, device=dev)),
        log_sigma=torch.full(TC, float(np.log(sigma0)), dtype=dt, device=dev),
        step=0,
        naccept=torch.zeros(n_temps, dtype=dt, device=dev),
        nprop=torch.zeros((), dtype=dt, device=dev),
        acc_rate=torch.full(TC, hp.resolved_target(), dtype=dt, device=dev),
        nswap_att=torch.zeros(n_temps, dtype=dt, device=dev),
        nswap_acc=torch.zeros(n_temps, dtype=dt, device=dev),
        scales0=scales, u_center=u_center, u_scale=u_scale)


def mala_step(problem: Problem, hp: MALAHyper, betas, state: SamplerState,
              generator: torch.Generator = None, adapt: bool = True,
              draws=None, axis_reduce=None) -> SamplerState:
    """One batched MALA(+adaptation) step for all (T, C) walkers.

    betas: (T,) inverse temperatures.  draws: optional (xi (T,C,Df) normal,
    u_acc (T,C) uniform; (S, T, C, ...) for a stacked ensemble) used
    instead of drawing from `generator` (the reference's hook; parity tests
    feed both packages the same numbers).

    axis_reduce: optional fn(x, axis, keepdims=False) replacing every mean
    over the walker axis (the ensemble moments and the acceptance count).
    The multi-process runner (parallel/shardmap_runner.py) passes one that
    sums its shard's walkers across the ranks of a temperature row and
    divides by the global C; it also resolves hp's covariance estimator from
    that global C, so that a walker-sharded run does not switch estimator.
    """
    C, Df = state.theta.shape[-2:]
    cmean = axis_reduce if axis_reduce is not None else (
        lambda x, axis, keepdims=False: torch.mean(x, dim=axis,
                                                   keepdim=keepdims))
    dt, dev = state.theta.dtype, state.theta.device
    u_center, u_scale = _per_walker(state.u_center), _per_walker(state.u_scale)
    sigma = torch.exp(state.log_sigma)                       # (T, C)
    s2 = (sigma**2)[..., None]
    b = betas[:, None]                                       # (T, 1)

    with span("mala.propose"):
        if hp.use_drift:
            g = b[..., None] * state.gradL + state.gradP
            drift = _truncate_drift(g, hp.drift_delta)
            mean_fwd = state.theta + 0.5 * s2 * _matvec(state.cov, drift)
        else:
            mean_fwd = state.theta
        xi = (torch.randn(state.theta.shape, generator=generator, dtype=dt,
                          device=dev)
              if draws is None else draws[0])
        prop = mean_fwd + sigma[..., None] * _matvec(state.chol, xi)

        # the model sees physical coordinates; gradients chain back to u-space
        prop_x = u_center + u_scale * prop

    if hp.use_drift:
        (logLp, logPp), (gLp, gPp) = problem.batched_logparts_and_grad(prop_x)
        gLp = gLp * u_scale
        gPp = gPp * u_scale
        gp = b[..., None] * gLp + gPp
        drift_p = _truncate_drift(gp, hp.drift_delta)
        mean_rev = prop + 0.5 * s2 * _matvec(state.cov, drift_p)
        r = _matvec(state.ichol, state.theta - mean_rev)
        logq_rev = -0.5 * torch.sum(r**2, dim=-1) / sigma**2
        logq_fwd = -0.5 * torch.sum(xi**2, dim=-1)
        q_corr = logq_rev - logq_fwd
    else:
        logLp, logPp = problem.batched_log_parts(prop_x)
        gLp = torch.zeros_like(state.gradL)
        gPp = torch.zeros_like(state.gradP)
        q_corr = 0.0

    with span("mala.accept"):
        dlog = b * (logLp - state.logL) + (logPp - state.logP) + q_corr
        u_acc = (torch.rand(state.logL.shape, generator=generator, dtype=dt,
                            device=dev)
                 if draws is None else draws[1])
        accept = torch.log(u_acc + 1e-38) < dlog             # (T, C)
        accf = accept.to(dt)
        acc3 = accept[..., None]

        theta = torch.where(acc3, prop, state.theta)
        logL = torch.where(accept, logLp, state.logL)
        logP = torch.where(accept, logPp, state.logP)
        gradL = torch.where(acc3, gLp, state.gradL)
        gradP = torch.where(acc3, gPp, state.gradP)

        inst_acc = torch.clamp(torch.exp(dlog), max=1.0)
        acc_rate = ((1 - hp.acc_smooth) * state.acc_rate
                    + hp.acc_smooth * inst_acc)

        step = state.step + 1
        mu, cov, chol, ichol = state.mu, state.cov, state.chol, state.ichol
        log_sigma = state.log_sigma
        if adapt:
            k = float(step)
            gamma = hp.gain_c0 / (hp.gain_k0 + k) ** hp.gain_alpha
            if hp.resolved_cov_estimator(C, Df) == "ensemble":
                # pooled cross-walker moments per temperature
                mean_c = cmean(theta, -2, keepdims=True)      # (T, 1, Df)
                mu = state.mu + gamma * (mean_c - state.mu)
                dev_ = theta - mu
                emp = cmean(dev_[..., :, None] * dev_[..., None, :], -3,
                            keepdims=True)
                cov = state.cov + gamma * (emp - state.cov)
            else:
                # per-walker expanding-window moments (1/k gain)
                gm = 1.0 / max(k, 1.0)
                mu = state.mu + gm * (theta - state.mu)
                dev_ = theta - mu
                emp = dev_[..., :, None] * dev_[..., None, :]
                cov = state.cov + gm * (emp - state.cov)
            if step % hp.dN_chol == 0:
                eye = torch.eye(Df, dtype=dt, device=dev)
                floor = torch.diag_embed(
                    _per_walker(hp.cov_floor * state.scales0**2))
                ch, info = torch.linalg.cholesky_ex(
                    cov + floor + hp.eps_cov * eye)
                # SPD guard: a failed factorisation keeps the previous factor
                bad = (info != 0) | torch.isnan(ch).any(dim=(-2, -1))
                # the factorisation and the solve hand back column-major
                # matrices; the state keeps one layout, row-major, so that a
                # state restored from a checkpoint (row-major) multiplies
                # through the same library kernels as the one that was saved
                # and a resumed fit continues bit for bit
                chol = torch.where(bad[..., None, None], state.chol,
                                   ch).contiguous()
                if hp.use_drift:
                    ichol = _batched_tri_inverse(chol).contiguous()
            acc_est = (inst_acc if hp.sigma_acc_estimator == "expected"
                       else accf)
            log_sigma = torch.clamp(
                state.log_sigma + gamma * (acc_est - hp.resolved_target()),
                hp.log_sigma_min, hp.log_sigma_max)

        return state.replace(
            theta=theta, logL=logL, logP=logP, gradL=gradL, gradP=gradP,
            mu=mu, cov=cov, chol=chol, ichol=ichol, log_sigma=log_sigma,
            step=step, naccept=state.naccept + cmean(accf, -1),
            nprop=state.nprop + 1.0, acc_rate=acc_rate)
