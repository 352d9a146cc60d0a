"""A mesh run's state and records across ranks (port of
tamcmc_tpu/parallel/sharded.py `shard_state` / `gather_state_to_host`).

Plain torch has no GSPMD: a rank holds its blocks of the state as ordinary
tensors, and every crossing is an explicit collective.  `shard_state` cuts a
whole state (built by init_state, or loaded from a checkpoint) into this
rank's blocks; `gather_state` assembles the whole state on every rank (a
checkpoint, a phase's end); `gather_records` assembles a chunk's records
(once per chunk, never per step).  All three read mesh.STATE_SPLIT.
"""

from __future__ import annotations

import numpy as np
import torch

from tamcmc_tpu_torch.parallel import distributed
from tamcmc_tpu_torch.parallel.mesh import STATE_SPLIT, SamplerMesh
from tamcmc_tpu_torch.sampler.driver import moments_to_physical
from tamcmc_tpu_torch.sampler.state import SamplerState


def shard_state(state: SamplerState, mesh: SamplerMesh) -> SamplerState:
    """This rank's blocks of a whole state, as contiguous tensors of their
    own (row-major, as every state tensor is)."""
    if mesh.size == 1:
        return state
    kw = {}
    for name, split in STATE_SPLIT.items():
        x = getattr(state, name)
        if split == "TC":
            x = x[mesh.tsl, mesh.csl].clone(
                memory_format=torch.contiguous_format)
        elif split == "T":
            x = x[mesh.tsl].clone()
        kw[name] = x
    return SamplerState(**kw)


def _split_fields(split):
    return [n for n, s in STATE_SPLIT.items() if s == split]


def gather_state(state: SamplerState, mesh: SamplerMesh) -> SamplerState:
    """The whole state on every rank (a collective: every rank calls it at
    the same point), on this rank's device.  Rung-split counters are equal
    on the ranks of a temperature row (their walker counts were summed), so
    the row's first rank gives them."""
    if mesh.size == 1:
        return state
    tc, t = _split_fields("TC"), _split_fields("T")
    local = [getattr(state, n) for n in tc + t]
    parts = distributed.all_gather_flat(
        torch.cat([x.reshape(-1) for x in local]))
    dev = state.theta.device
    kw = {n: getattr(state, n) for n in _split_fields("")}
    for x, name in zip(local, tc + t):
        k = len(STATE_SPLIT[name])          # the leading axes split
        kw[name] = torch.empty((mesh.T, mesh.C)[:k] + tuple(x.shape[k:]),
                               dtype=x.dtype)
    for r, flat in enumerate(parts):
        tsl, csl = mesh.blocks(r)
        off = 0
        for x, name in zip(local, tc + t):
            piece = flat[off:off + x.numel()].reshape(x.shape)
            off += x.numel()
            if STATE_SPLIT[name] == "TC":
                kw[name][tsl, csl] = piece
            elif r % mesh.n_chain == 0:
                kw[name][tsl] = piece
    for name in tc + t:
        kw[name] = kw[name].to(dev)
    return SamplerState(**kw)


# make_record's keys, in its order
RECORD_KEYS = ("theta0", "logL", "logP", "logP0", "log_sigma", "acc_rate",
               "mu0", "cov_diag0", "swap_att", "swap_acc")


def gather_records(local: dict, mesh: SamplerMesh, u_center, u_scale) -> dict:
    """A chunk's records, whole, on every rank as host numpy arrays (one
    all_gather).  local: this rank's stacked records {key: (E, ...)} as
    MeshRunner.record makes them: the cold-rung keys (theta0, logP0, mu0,
    cov_diag0) are read from the first temperature block's ranks only, and
    with walker shards the walker means are a shard's sums, finished here
    with the global C and mapped with the state's (u_center, u_scale)
    (host arrays) by driver.moments_to_physical."""
    if mesh.size == 1:
        return {k: local[k].cpu().numpy() for k in RECORD_KEYS}
    parts = distributed.all_gather_flat(
        torch.cat([local[k].reshape(-1) for k in RECORD_KEYS]))
    E = local["logL"].shape[0]
    dt = parts[0].numpy().dtype
    Df = local["theta0"].shape[-1]
    out = {"theta0": np.empty((E, mesh.C, Df), dt),
           "logL": np.empty((E, mesh.T, mesh.C), dt),
           "logP": np.empty((E, mesh.T, mesh.C), dt),
           "logP0": np.empty((E, mesh.C), dt),
           "log_sigma": np.zeros((E, mesh.T), dt),
           "acc_rate": np.zeros((E, mesh.T), dt),
           "mu0": np.zeros((E, Df), dt), "cov_diag0": np.zeros((E, Df), dt),
           "swap_att": np.empty((E, mesh.T), dt),
           "swap_acc": np.empty((E, mesh.T), dt)}
    summed = mesh.n_chain > 1
    for r, flat in enumerate(parts):
        off, d = 0, {}
        for k in RECORD_KEYS:
            n = local[k].numel()
            d[k] = flat[off:off + n].reshape(local[k].shape).numpy()
            off += n
        tsl, csl = mesh.blocks(r)
        ti, ci = divmod(r, mesh.n_chain)
        out["logL"][:, tsl, csl] = d["logL"]
        out["logP"][:, tsl, csl] = d["logP"]
        for k in ("log_sigma", "acc_rate"):
            if summed:
                out[k][:, tsl] += d[k]
            else:
                out[k][:, tsl] = d[k]
        if ci == 0:            # equal on the ranks of a row
            out["swap_att"][:, tsl] = d["swap_att"]
            out["swap_acc"][:, tsl] = d["swap_acc"]
        if ti == 0:
            out["theta0"][:, csl] = d["theta0"]
            out["logP0"][:, csl] = d["logP0"]
            for k in ("mu0", "cov_diag0"):
                if summed:
                    out[k] += d[k]
                else:
                    out[k] = d[k]
    if summed:
        c = dt.type(mesh.C)
        out["log_sigma"] /= c
        out["acc_rate"] /= c
        out["mu0"], out["cov_diag0"] = moments_to_physical(
            out["mu0"] / c, out["cov_diag0"] / c, u_center, u_scale)
    return out
