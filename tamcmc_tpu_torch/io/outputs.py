"""Sample writers, byte-compatible with tamcmc_tpu/io/outputs.py (reference
`outputs.cpp` buffered writers [U]).

  {phase}_samples.bin  raw little-endian float64 records, one row per
                       (emit, walker): Df values of the cold rung
  {phase}_samples.hdr  ASCII sidecar: Nvars, Nsamples, Nchains, names, dtype
  {phase}_chains.npz   logL/logP (emit, T, C), logP0, log_sigma, acc_rate,
                       mu0, cov_diag0, swap_att/swap_acc

tamcmc_tpu.io.outputs.read_bin_samples reads what this writes.
"""

from __future__ import annotations

import pathlib

import numpy as np


class OutputWriter:
    def __init__(self, outdir: str, param_names, n_temps: int, n_chains: int):
        self.outdir = pathlib.Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.param_names = list(param_names)
        self.n_temps = n_temps
        self.n_chains = n_chains
        self._bin_handles = {}
        self._counts = {}
        self._chain_buffers = {}

    def _bin_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_samples.bin"

    def _hdr_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_samples.hdr"

    def append_chunk(self, phase: str, outs: dict):
        """outs: host records of one chunk — theta0 (E, C, Df) plus the
        chain diagnostics (leading emit axis)."""
        theta0 = np.asarray(outs["theta0"], dtype=np.float64)
        E, C, Df = theta0.shape
        f = self._bin_handles.get(phase)
        if f is None:
            f = self._bin_handles[phase] = open(self._bin_path(phase), "wb")
            self._counts[phase] = 0
            self._chain_buffers[phase] = []
        f.write(theta0.reshape(E * C, Df).astype("<f8").tobytes())
        self._counts[phase] += E * C
        self._chain_buffers[phase].append(
            {k: np.asarray(v) for k, v in outs.items() if k != "theta0"})

    def finalize_phase(self, phase: str):
        if phase not in self._bin_handles:
            return
        self._bin_handles.pop(phase).close()
        with open(self._hdr_path(phase), "w") as h:
            h.write("# tamcmc-tpu samples header\n")
            h.write(f"Nvars= {len(self.param_names)}\n")
            h.write(f"Nsamples= {self._counts[phase]}\n")
            h.write(f"Nchains= {self.n_chains}\n")
            h.write("variable_names= " + " ".join(self.param_names) + "\n")
            h.write("dtype= float64_le\n")
        bufs = self._chain_buffers.pop(phase)
        stacked = {k: np.concatenate([b[k] for b in bufs], axis=0)
                   for k in bufs[0]}
        np.savez_compressed(self.outdir / f"{phase}_chains.npz", **stacked)

    def abort(self):
        """Close open .bin handles without headers (a failed run)."""
        for f in self._bin_handles.values():
            f.close()
        self._bin_handles.clear()

    def close(self):
        for phase in list(self._bin_handles):
            self.finalize_phase(phase)
