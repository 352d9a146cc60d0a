"""The multi-process runner: the tempered MALA fit over a (temperature
shards x walker shards) mesh of ranks, every collective explicit (port of
tamcmc_tpu/parallel/shardmap_runner.py; it also stands in for the GSPMD
runner of parallel/sharded.py: `--runner gspmd` and `--runner shardmap` both
run this one runner).

Per raw step, on each rank, the local step's math on the rank's blocks:

  * Random numbers.  Every rank holds the run's one torch.Generator with the
    same seed and draws the GLOBAL xi (T, C, Df), u_acc (T, C) and, on swap
    steps, the swap u (T, C) in the local runner's order, then keeps its
    rows through mala_step's `draws=` and the swap's `u`.  The chains are
    therefore the local run's whatever the mesh (the property the
    reference's `_fold_draws` buys with per-walker keys).
  * Walker means (ensemble moments, acceptance count) under walker
    sharding: the shard's sums, all_reduce(SUM) over the temperature row,
    divided by the global C (mala_step's `axis_reduce`); the covariance
    estimator is resolved from the global C.  Without walker shards the
    means are the plain ones, bit for bit.
  * Swaps, on swap steps only (the step counter is a host integer): the
    parity sweep of sampler/tempering.py on global rung indices.  A pair
    inside a rank's block swaps locally; only a pair that straddles two
    blocks exchanges its rows (theta, logL, logP, gradL, gradP of the rank's
    walkers) with the neighbour, point to point.  The ladder (betas) and the
    uniforms are whole on every rank, so neither travels.  The pair shares
    the low rung's uniform, adaptation statistics stay with the rung, and
    the acceptance counter is the count of accepted pairs summed over the
    walker shards times float32(1 / C), the local counter bit for bit.
  * Records stay on the rank until a chunk's end; then one all_gather
    assembles the cold rung's walkers, the (T, C) logL/logP and the
    per-rung telemetry on every rank (sharded.gather_records).
"""

from __future__ import annotations

import dataclasses

import torch

from tamcmc_tpu_torch.parallel import distributed
from tamcmc_tpu_torch.parallel.mesh import SamplerMesh
from tamcmc_tpu_torch.parallel.sharded import RECORD_KEYS, gather_records
from tamcmc_tpu_torch.sampler.driver import make_record
from tamcmc_tpu_torch.sampler.mala import mala_step
from tamcmc_tpu_torch.sampler.state import SamplerState
from tamcmc_tpu_torch.sampler.tempering import _partner_tables, _partners

def walker_mean(mesh: SamplerMesh, group):
    """mala_step's axis_reduce with walker shards: the shard's sum, summed
    over the temperature row's ranks (`group`), over the global C."""
    def cmean(x, axis, keepdims=False):
        s = torch.sum(x, dim=axis, keepdim=keepdims)
        return distributed.all_reduce_sum(s, group) / mesh.C
    return cmean


def _pack(state, row):
    """One rung's rows of the fields a swap moves, (c_loc, 3 Df + 2)."""
    return torch.cat([state.theta[row], state.logL[row][:, None],
                      state.logP[row][:, None], state.gradL[row],
                      state.gradP[row]], dim=-1)


def _unpack(buf, Df):
    return {"theta": buf[:, :Df], "logL": buf[:, Df],
            "logP": buf[:, Df + 1], "gradL": buf[:, Df + 2:2 * Df + 2],
            "gradP": buf[:, 2 * Df + 2:]}


def swap_across(betas, state: SamplerState, parity: int, u, mesh: SamplerMesh,
                group=None):
    """One parity sweep of adjacent-pair swaps on this rank's blocks: the
    math of sampler.tempering.tempering_swap on global rungs, `betas` (T,)
    and `u` (T, C) whole.  A collective for the two ranks of each pair that
    straddles a block boundary (both know it from the parity alone)."""
    T, t0, tl = mesh.T, mesh.t_lo, mesh.t_loc
    if T < 2:
        return state
    part = _partners(T, int(parity))
    Df = state.theta.shape[-1]
    sends, sides = [], []
    if part[t0] == t0 - 1:                 # my first rung pairs below
        sends.append((mesh.rank_of(mesh.ti - 1, mesh.ci), _pack(state, 0)))
        sides.append("lo")
    if part[t0 + tl - 1] == t0 + tl:       # my last rung pairs above
        sends.append((mesh.rank_of(mesh.ti + 1, mesh.ci), _pack(state, -1)))
        sides.append("hi")
    halo = dict(zip(sides, (_unpack(b, Df) for b in
                            distributed.exchange(sends))))
    idx = torch.as_tensor(part[t0:t0 + tl] - t0 + 1, device=state.theta.device)

    def partner_rows(name):
        """x_global[partner(t)] for each of my rungs t."""
        x = getattr(state, name)
        lo = halo["lo"][name][None] if "lo" in halo else x[:1]
        hi = halo["hi"][name][None] if "hi" in halo else x[-1:]
        return torch.cat([lo, x, hi]).index_select(0, idx)

    partner, low, is_paired, is_low = (
        a[t0:t0 + tl] for a in _partner_tables(T, int(parity),
                                               state.theta.device))
    logL_p = partner_rows("logL")
    delta = (betas[t0:t0 + tl][:, None] - betas[partner][:, None]) \
        * (logL_p - state.logL)
    u_pair = u.index_select(0, low)[:, mesh.csl]
    accept = (torch.log(u_pair + 1e-38) < delta) & is_paired[:, None]
    acc3 = accept[..., None]

    def swapped(name, acc):
        return torch.where(acc, partner_rows(name), getattr(state, name))

    att = is_low.to(state.nswap_att.dtype)
    count = accept.to(state.nswap_acc.dtype).sum(dim=-1)
    if mesh.n_chain > 1:
        count = distributed.all_reduce_sum(count, group)
    # the walker mean as tempering_swap forms it: the count times
    # float32(1 / C), so the counters agree bit for bit
    accf = count * (1.0 / mesh.C) * att
    return state.replace(
        theta=swapped("theta", acc3), logL=swapped("logL", accept),
        logP=swapped("logP", accept), gradL=swapped("gradL", acc3),
        gradP=swapped("gradP", acc3),
        nswap_att=state.nswap_att + att, nswap_acc=state.nswap_acc + accf)


@dataclasses.dataclass
class MeshRunner:
    """The raw step, the per-emit record and the per-chunk assembly of one
    phase on this rank; sampler.driver.run_phase drives them."""
    problem: object
    hp: object
    betas: torch.Tensor       # (T,) whole
    mesh: SamplerMesh
    generator: torch.Generator
    adapt: bool

    def __post_init__(self):
        # "auto" resolves from the GLOBAL walker count: a shard's C would
        # switch a walker-sharded run to the per-walker estimator
        self.hp_step = dataclasses.replace(
            self.hp, cov_estimator=self.hp.resolved_cov_estimator(
                self.mesh.C, self.problem.ndim_free))
        self.betas_loc = self.betas[self.mesh.tsl]
        # without walker shards the plain means, bit for bit
        self.group = self.cmean = None
        if self.mesh.n_chain > 1:
            self.group = distributed.walker_group(self.mesh)
            self.cmean = walker_mean(self.mesh, self.group)

    def step(self, state: SamplerState) -> SamplerState:
        m, g = self.mesh, self.generator
        dt, dev = state.theta.dtype, state.theta.device
        xi = torch.randn((m.T, m.C, state.theta.shape[-1]), generator=g,
                         dtype=dt, device=dev)[m.tsl, m.csl].contiguous()
        u_acc = torch.rand((m.T, m.C), generator=g, dtype=dt,
                           device=dev)[m.tsl, m.csl].contiguous()
        state = mala_step(self.problem, self.hp_step, self.betas_loc, state,
                          None, adapt=self.adapt, draws=(xi, u_acc),
                          axis_reduce=self.cmean)
        if state.step % self.hp.dN_mixing == 0 and m.T >= 2:
            parity = (state.step // self.hp.dN_mixing) % 2
            u = torch.rand((m.T, m.C), generator=g, dtype=state.logL.dtype,
                           device=dev)
            state = swap_across(self.betas, state, parity, u, m, self.group)
        return state

    def record(self, state: SamplerState) -> dict:
        """make_record of this rank's blocks: under walker sharding the
        walker means are the shard's sums, finished by gather_records.  Off
        the first temperature block the cold-rung keys describe the block's
        first rung, and gather_records ignores them."""
        if self.mesh.n_chain == 1:
            return make_record(state)
        return make_record(state, torch.sum, physical=False)

    def collect(self, records, state: SamplerState) -> dict:
        """A chunk's records, whole, as host arrays on every rank."""
        local = {k: torch.stack([r[k] for r in records]) for k in RECORD_KEYS}
        return gather_records(local, self.mesh,
                              state.u_center.cpu().numpy(),
                              state.u_scale.cpu().numpy())
