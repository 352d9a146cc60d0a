"""Phase machine (Burn-in -> Learning -> Acquire) and the chunked step loop.

Port of tamcmc_tpu/sampler/driver.py (reference `MALA::execute` +
`main.cpp` phases [U]).  `mesh=` routes a phase through the multi-process
runner (parallel/shardmap_runner.py).  `lax.scan` becomes a Python loop;
the step counter is a host integer, so the swap cadence and parity are
Python control flow with no device synchronisation.  Records stay on the
device until the end of a chunk, which copies them to the host in one go.
`betas` is a tensor the loop replaces between chunks when the ladder adapts;
nothing is compiled, so nothing has to be rebuilt for it.
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
from tamcmc_tpu_torch.utils.metrics import COUNTERS, span


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
        with span("swap"):
            state = tempering_swap(betas, state, parity, generator)
    return state


def moments_to_physical(mu0, cov_diag0, u_center, u_scale):
    """The cold rung's walker-mean moments from u-space to physical units."""
    return u_center + u_scale * mu0, u_scale**2 * cov_diag0


def make_record(state: SamplerState, wreduce=torch.mean, physical=True):
    """One emitted (thinned) record: the cold rung's walkers in physical
    units plus adaptation telemetry (device tensors).  A stacked ensemble's
    state gives every entry a leading star axis.

    wreduce(x, dim) is the reduction over walkers: the mean, or on a rank
    of a walker-sharded mesh run the shard's sum, with physical=False
    leaving mu0 and cov_diag0 in u-space until parallel.sharded.
    gather_records has finished the mean over every shard."""
    uc, us = state.u_center[..., None, :], state.u_scale[..., None, :]
    mu0 = wreduce(state.mu[..., 0, :, :], -2)                       # (Df,)
    cov_diag0 = wreduce(torch.diagonal(
        state.cov[..., 0, :, :, :], dim1=-2, dim2=-1), -2)           # (Df,)
    if physical:
        mu0, cov_diag0 = moments_to_physical(mu0, cov_diag0,
                                             state.u_center, state.u_scale)
    return {
        "theta0": uc + us * state.theta[..., 0, :, :],              # (C, Df)
        "logL": state.logL,                                         # (T, C)
        "logP": state.logP,                                         # (T, C)
        "logP0": state.logP[..., 0, :],                             # (C,)
        "log_sigma": wreduce(state.log_sigma, -1),                  # (T,)
        "acc_rate": wreduce(state.acc_rate, -1),                    # (T,)
        "mu0": mu0, "cov_diag0": cov_diag0,
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
              thin=1, chunk=200, on_chunk: Optional[Callable] = None,
              on_state: Optional[Callable] = None, already_emitted: int = 0,
              ladder: Optional[dict] = None, mesh=None,
              runner_kind: Optional[str] = None):
    """Run one phase; returns (state, dict of stacked host outputs).

    on_chunk(outputs) is called with the host (numpy) records of each chunk
    for streaming writers.

    on_state(state, generator_state, emitted) is called after each chunk
    with the carry state and `generator.get_state()`: one generator draws
    for every step, so checkpointing exactly this pair makes a mid-phase
    resume bitwise identical to the uninterrupted run.

    already_emitted: skip this many records, emitted before a mid-phase
    resume; a multiple of the chunk size, or ValueError (the resumed run
    would checkpoint and adapt the ladder at other steps).  Resumed exactly
    at the phase's end, the outputs are {}.

    ladder: the adaptive ladder's mutable state, shared across phases when
    hp.adapt_ladder (sampler/ladder.py): {"betas": (T,) float64 array,
    "updates": int, "last_att": (T,), "last_acc": (T,)}.  It replaces
    `betas`: adapting phases update it between chunks toward uniform pair
    swap acceptance, from the cumulative swap counters of the chunk's last
    record; frozen phases use its betas as they are.

    mesh: a parallel.mesh.SamplerMesh runs the phase on this rank's blocks
    of the state (parallel/shardmap_runner.py; `state` is the rank's, from
    parallel.sharded.shard_state; `betas` whole); the records handed to
    on_chunk and returned are whole on every rank.  runner_kind: the
    reference's signature ("gspmd" or "shardmap"); both names run the one
    runner here.  The adaptive ladder is local-runner only.
    """
    n_emit_total, chunk = resolve_emit_plan(n_steps, thin, chunk)
    if already_emitted % chunk != 0:
        raise ValueError(f"already_emitted={already_emitted} is not a "
                         f"multiple of chunk={chunk}; the resumed run would "
                         "not continue the interrupted one")
    if mesh is not None:
        from tamcmc_tpu_torch.parallel.shardmap_runner import MeshRunner
        if ladder is not None:
            raise ValueError("the adaptive ladder (hp.adapt_ladder) is "
                             "local-runner only; drop the mesh or the ladder")
        runner = MeshRunner(problem, hp, betas, mesh, generator, adapt)
        step, record, collect = runner.step, runner.record, runner.collect
    else:
        def step(s):
            return raw_step(problem, hp, betas, s, generator, adapt)

        def collect(records, _state):
            return {k: torch.stack([r[k] for r in records]).cpu().numpy()
                    for k in records[0]}
        record = make_record

    def device_betas():
        return torch.as_tensor(ladder["betas"], dtype=betas.dtype,
                               device=betas.device)

    if ladder is not None:
        betas = device_betas()
    collected = []
    emitted = already_emitted
    while emitted < n_emit_total:
        with span("chunk"):
            records = []
            for _ in range(chunk):
                for _ in range(thin):
                    with span("step"):
                        state = step(state)
                    COUNTERS["steps"] += 1
                with span("record"):
                    records.append(record(state))
            with span("collect"):
                outs = collect(records, state)
            emitted += chunk
            COUNTERS["chunks"] += 1
            with span("callbacks"):
                if ladder is not None and adapt:
                    from tamcmc_tpu_torch.sampler.ladder import update_ladder
                    att, acc = outs["swap_att"][-1], outs["swap_acc"][-1]
                    ladder["updates"] += 1
                    ladder["betas"] = update_ladder(
                        ladder["betas"], att - ladder["last_att"],
                        acc - ladder["last_acc"], ladder["updates"])
                    ladder["last_att"], ladder["last_acc"] = att, acc
                    betas = device_betas()
                if on_chunk is not None:
                    on_chunk(outs)
                if on_state is not None:
                    on_state(state, generator.get_state(), emitted)
        collected.append(outs)
    if not collected:          # resumed exactly at the phase boundary
        return state, {}
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
