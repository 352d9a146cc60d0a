"""The sampler mesh: a (temperature shards x walker shards) grid of ranks,
and the one table of how each SamplerState field splits over it (port of
tamcmc_tpu/parallel/mesh.py: `SamplerMesh` stands for `make_sampler_mesh`,
`STATE_SPLIT` for `state_pspecs`).

Rank r of a T_s x C_s mesh holds the rung block ti = r // C_s and the walker
block ci = r % C_s: temperatures are the slowest-varying axis, so the ranks
of one temperature row (whose walker means are summed every adapting step)
are neighbours, and only the rare swap steps cross temperature blocks.

The grids (nu, spec) and the problem are whole on every rank: a grid is
~1e5 bins and the frequency axis is never split.
"""

from __future__ import annotations

import dataclasses

# How each SamplerState field splits: "TC" on its first two axes (rung,
# walker), "T" on its first axis (rung), "" whole on every rank.  Every
# slice (sharded.shard_state), gather (sharded.gather_state) and so every
# checkpoint of a mesh run reads this table.
STATE_SPLIT = {
    "theta": "TC", "logL": "TC", "logP": "TC", "gradL": "TC", "gradP": "TC",
    "mu": "TC", "cov": "TC", "chol": "TC", "ichol": "TC", "log_sigma": "TC",
    "acc_rate": "TC",
    "naccept": "T", "nswap_att": "T", "nswap_acc": "T",
    "step": "", "nprop": "", "scales0": "", "u_center": "", "u_scale": "",
}


def parse_mesh(spec: str):
    """'TxC' -> (n_temp_shards, n_chain_shards), e.g. '2x1'."""
    try:
        t, c = spec.lower().split("x")
        t, c = int(t), int(c)
    except (AttributeError, ValueError):
        raise SystemExit(f"--mesh expects TEMPSxCHAINS (e.g. 2x1), got "
                         f"{spec!r}")
    if t < 1 or c < 1:
        raise SystemExit(f"--mesh {spec}: both factors must be >= 1")
    return t, c


@dataclasses.dataclass(frozen=True)
class SamplerMesh:
    """This rank's place on a (n_temp x n_chain) mesh over a T x C
    ensemble."""
    n_temp: int               # temperature shards
    n_chain: int              # walker shards
    rank: int                 # this process, 0 .. n_temp * n_chain - 1
    T: int                    # global temperatures
    C: int                    # global walkers per temperature

    def __post_init__(self):
        if self.T % self.n_temp or self.C % self.n_chain:
            raise ValueError(f"mesh {self.n_temp}x{self.n_chain} must divide "
                             f"temps x chains = {self.T}x{self.C}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not on a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return self.n_temp * self.n_chain

    @property
    def ti(self) -> int:
        return self.rank // self.n_chain

    @property
    def ci(self) -> int:
        return self.rank % self.n_chain

    @property
    def t_loc(self) -> int:
        return self.T // self.n_temp

    @property
    def c_loc(self) -> int:
        return self.C // self.n_chain

    @property
    def t_lo(self) -> int:
        return self.ti * self.t_loc

    @property
    def tsl(self) -> slice:
        return self.blocks(self.rank)[0]

    @property
    def csl(self) -> slice:
        return self.blocks(self.rank)[1]

    def rank_of(self, ti: int, ci: int) -> int:
        return ti * self.n_chain + ci

    def row_ranks(self, ti: int):
        """The ranks of temperature block ti (one walker reduction group)."""
        return [self.rank_of(ti, c) for c in range(self.n_chain)]

    def blocks(self, rank: int):
        """(rung slice, walker slice) that `rank` holds."""
        ti, ci = divmod(rank, self.n_chain)
        return (slice(ti * self.t_loc, (ti + 1) * self.t_loc),
                slice(ci * self.c_loc, (ci + 1) * self.c_loc))
