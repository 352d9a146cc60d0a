"""The flat parameter-vector ABI: `params` + `plength` block partitioning.

The reference encodes every model's parameters as ONE flat vector partitioned
into named blocks by a `plength` integer list (`models.cpp`, `model_def.cpp`
[U]; SURVEY.md section 2 "Model dictionary").  We keep that ABI so reference
`.model` files map 1:1, and resolve all block offsets as static Python ints,
so every block read is a plain slice of the last tensor axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Named, statically-sized partition of a flat parameter vector."""
    names: tuple
    sizes: tuple

    def __post_init__(self):
        assert len(self.names) == len(self.sizes)

    @property
    def plength(self):
        return list(self.sizes)

    @property
    def ndim(self):
        return int(sum(self.sizes))

    def offset(self, name: str) -> int:
        i = self.names.index(name)
        return int(sum(self.sizes[:i]))

    def size(self, name: str) -> int:
        return int(self.sizes[self.names.index(name)])

    def get(self, params, name: str):
        """Static slice of the block `name` out of a (..., D) params array."""
        o = self.offset(name)
        return params[..., o:o + self.size(name)]

    def param_names(self) -> list:
        """Flat per-parameter names block/index, for outputs + diagnostics."""
        out = []
        for n, s in zip(self.names, self.sizes):
            if s == 1:
                out.append(n)
            else:
                out.extend(f"{n}_{k}" for k in range(s))
        return out

    @staticmethod
    def make(spec: Sequence):
        """spec: iterable of (name, size) pairs."""
        names, sizes = zip(*spec) if spec else ((), ())
        return BlockLayout(tuple(names), tuple(int(s) for s in sizes))
