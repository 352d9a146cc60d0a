"""Phase machine (Burn-in -> Learning -> Acquire) and the chunked step loop.

Port of tamcmc_tpu/sampler/driver.py, local runner only (reference
`MALA::execute` + `main.cpp` phases [U]).  `lax.scan` becomes a Python loop;
the step counter is a host integer, so the swap cadence and parity are
Python control flow with no device synchronisation.  Records stay on the
device until the end of a chunk, which copies them to the host in one go.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional

import numpy as np
import torch

from tamcmc_tpu_torch.sampler.mala import mala_step
from tamcmc_tpu_torch.sampler.state import SamplerState
from tamcmc_tpu_torch.sampler.tempering import tempering_swap


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Iteration counts per phase; names follow the reference (B/L/A)."""
    burnin: int = 2000
    learning: int = 10000
    acquire: int = 20000
    thin: int = 10
    chunk: int = 200          # emitted records per device->host transfer

    def phases(self):
        return [("B", self.burnin, True), ("L", self.learning, True),
                ("A", self.acquire, False)]


def raw_step(problem, hp, betas, state, generator, adapt):
    """One MALA step, then a parity swap sweep every dN_mixing steps."""
    state = mala_step(problem, hp, betas, state, generator, adapt=adapt)
    if state.step % hp.dN_mixing == 0:
        parity = (state.step // hp.dN_mixing) % 2
        state = tempering_swap(betas, state, parity, generator)
    return state


def make_record(state: SamplerState):
    """One emitted (thinned) record: the cold rung's walkers in physical
    units plus adaptation telemetry (device tensors)."""
    return {
        "theta0": state.u_center + state.u_scale * state.theta[0],  # (C, Df)
        "logL": state.logL,                                         # (T, C)
        "logP": state.logP,                                         # (T, C)
        "logP0": state.logP[0],                                     # (C,)
        "log_sigma": torch.mean(state.log_sigma, 1),                # (T,)
        "acc_rate": torch.mean(state.acc_rate, 1),                  # (T,)
        "mu0": state.u_center + state.u_scale * torch.mean(state.mu[0], 0),
        "cov_diag0": state.u_scale**2 * torch.mean(torch.diagonal(
            state.cov[0], dim1=-2, dim2=-1), 0),                    # (Df,)
        "swap_att": state.nswap_att,                                # (T,)
        "swap_acc": state.nswap_acc,                                # (T,)
    }


def resolve_emit_plan(n_steps: int, thin: int, chunk: int):
    """(n_emit_total, chunk): the final partial chunk runs at the full chunk
    size, and the overshoot is reported, never silent."""
    n_emit_total = max(n_steps // thin, 1)
    chunk = min(chunk, n_emit_total)
    overshoot = (-n_emit_total) % chunk
    if overshoot:
        n_emit_total += overshoot
        print(f"note: requested {n_steps} steps rounds up to "
              f"{n_emit_total * thin} ({n_emit_total} emitted records, "
              f"chunk={chunk}); the extra {overshoot * thin} steps enter "
              "the returned posterior", file=sys.stderr)
    return n_emit_total, chunk


def run_phase(problem, hp, betas, state, generator, n_steps, adapt=True,
              thin=1, chunk=200, on_chunk: Optional[Callable] = None):
    """Run one phase; returns (state, dict of stacked host outputs).

    on_chunk(outputs) is called with the host (numpy) records of each chunk
    for streaming writers."""
    if hp.adapt_ladder:
        raise NotImplementedError("the adaptive temperature ladder is not "
                                  "ported; run with a fixed ladder")
    n_emit_total, chunk = resolve_emit_plan(n_steps, thin, chunk)
    collected = []
    for _ in range(n_emit_total // chunk):
        records = []
        for _ in range(chunk):
            for _ in range(thin):
                state = raw_step(problem, hp, betas, state, generator, adapt)
            records.append(make_record(state))
        outs = {k: torch.stack([r[k] for r in records]).cpu().numpy()
                for k in records[0]}
        if on_chunk is not None:
            on_chunk(outs)
        collected.append(outs)
    return state, {k: np.concatenate([c[k] for c in collected], axis=0)
                   for k in collected[0]}


def run_phases(problem, hp, betas, state, generator, plan: PhasePlan,
               on_phase_end: Optional[Callable] = None):
    """Full B -> L -> A run.  Returns (state, {phase: outputs})."""
    results = {}
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0:
            continue
        state, outs = run_phase(problem, hp, betas, state, generator, n_steps,
                                adapt=adapt, thin=plan.thin, chunk=plan.chunk)
        results[name] = outs
        if on_phase_end is not None:
            on_phase_end(name, state, outs)
    return state, results
