"""Sample writers and readers, byte-compatible with tamcmc_tpu/io/outputs.py
(reference `outputs.cpp` buffered writers [U]): each package's reader reads
the other's writer.

  {phase}_samples.bin  raw little-endian float64 records, one row per
                       (emit, walker): Df values of the cold rung
  {phase}_samples.hdr  ASCII sidecar: Nvars, Nsamples, Nchains, names, dtype
  {phase}_chains.npz   logL/logP (emit, T, C), logP0, log_sigma, acc_rate,
                       mu0, cov_diag0, swap_att/swap_acc (cumulative)

A fresh phase's .bin goes through io/native.py's NativeRecordWriter (a
background thread writes while the sampler steps); a resumed phase appends
through `PlainRecordWriter`, a plain file handle, which is also the plain
version the tests hold the native file to byte for byte.

Mid-phase resume: `save_partial` flushes the .bin (the native writer's
barrier) and persists the in-memory chain buffers as
{phase}_chains_partial.npz with their record count; the caller then writes
the sampler checkpoint.  A kill between the two leaves a partial file newer
than the checkpoint, so `resume_phase` cuts both the .bin (a killed process
can also leave whole or torn records past the checkpoint) and the reloaded
buffers to the checkpoint's record count.  Together with the sampler
checkpoint taken at the same chunk boundary the continuation is
byte-identical to the uninterrupted run.  The partial npz is written to a
temporary name and renamed into place, so a kill during the write leaves
the previous file, never a broken zip.

A run over several processes (parallel/) writes shards: each process's
writer has a `walker_slice` (its share of the cold rung's walkers, from
`parallel.distributed.process_local_slice`) and a `shard_tag` ("hostK"), and
writes {phase}_samples.hostK.bin/.hdr, whose Nchains is the shard's own
walker count; only one writer (`keep_chains`, process 0) keeps the chain
diagnostics.  `read_bin_samples` merges the shards in the order of K.
"""

from __future__ import annotations

import glob
import os
import pathlib
import re
import sys

import numpy as np

from tamcmc_tpu_torch.io.native import NativeRecordWriter


class PlainRecordWriter:
    """Records of `nvars` float64 values through a Python file handle:
    `append=True` continues an existing file (a resumed phase), else the
    file is truncated.  NativeRecordWriter's interface, written
    synchronously."""

    def __init__(self, path, nvars: int, append: bool = False):
        self._f = open(path, "ab" if append else "wb")
        self.nvars = nvars

    def append(self, records: np.ndarray):
        self._f.write(np.asarray(records).astype("<f8").tobytes())

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def discard_stale_tmps(path):
    """Remove the temporary files of `atomic_savez(path)` that a process
    killed during the write left behind (one process writes a given path)."""
    path = pathlib.Path(path)
    for tmp in path.parent.glob(f"{glob.escape(path.name)}.*.tmp"):
        tmp.unlink(missing_ok=True)


def atomic_savez(path, **arrays):
    """np.savez to `path` through a temporary file in the same directory and
    os.replace: a reader, or a process resumed after a kill, sees the old
    file or the new one, never a half-written zip (and the next write
    removes the temporary file a killed one left)."""
    path = pathlib.Path(path)
    discard_stale_tmps(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class OutputWriter:
    """`native=False` writes fresh phases through PlainRecordWriter: the
    plain version, for the tests and the timing that compare the two."""

    def __init__(self, outdir: str, param_names, n_temps: int, n_chains: int,
                 walker_slice=None, shard_tag: str = "",
                 keep_chains: bool = True, native: bool = True):
        self.outdir = pathlib.Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.param_names = list(param_names)
        self.n_temps = n_temps
        self.n_chains = n_chains
        self.walker_slice = walker_slice      # (start, stop) on the C axis
        self.shard_tag = shard_tag            # "" or "hostK"
        self.keep_chains = keep_chains
        self.native = native
        self._bin_handles = {}
        self._counts = {}
        self._chain_buffers = {}

    @property
    def walkers_written(self) -> int:
        """Cold-rung walkers in each of this writer's records."""
        if self.walker_slice is None:
            return self.n_chains
        lo, hi = self.walker_slice
        return hi - lo

    def _tag(self) -> str:
        return f".{self.shard_tag}" if self.shard_tag else ""

    def _bin_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_samples{self._tag()}.bin"

    def _hdr_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_samples{self._tag()}.hdr"

    def _partial_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_chains_partial.npz"

    # --- streaming API (called per chunk by run_phase) ---
    def append_chunk(self, phase: str, outs: dict):
        """outs: host records of one chunk — theta0 (E, C, Df) plus the
        chain diagnostics (leading emit axis)."""
        theta0 = np.asarray(outs["theta0"], dtype=np.float64)
        if self.walker_slice is not None:
            lo, hi = self.walker_slice
            theta0 = theta0[:, lo:hi]
        E, C, Df = theta0.shape
        f = self._bin_handles.get(phase)
        if f is None:
            path = self._bin_path(phase)
            f = self._bin_handles[phase] = (
                NativeRecordWriter(path, Df) if self.native
                else PlainRecordWriter(path, Df))
            self._counts[phase] = 0
            self._chain_buffers[phase] = []
        f.append(theta0.reshape(E * C, Df))
        self._counts[phase] += E * C
        if self.keep_chains:
            self._chain_buffers[phase].append(
                {k: np.asarray(v) for k, v in outs.items() if k != "theta0"})

    @staticmethod
    def _stack(bufs) -> dict:
        return {k: np.concatenate([b[k] for b in bufs], axis=0)
                for k in bufs[0]}

    # --- mid-phase checkpoint support ---
    def save_partial(self, phase: str):
        """Flush the .bin and persist the chain buffers with their record
        count; pairs with the sampler checkpoint that the caller writes next
        (the .bin must hold at least what that checkpoint claims)."""
        f = self._bin_handles.get(phase)
        if f is not None:
            f.flush()
        if self.keep_chains and self._chain_buffers.get(phase):
            atomic_savez(self._partial_path(phase),
                         **self._stack(self._chain_buffers[phase]),
                         __count__=np.asarray(self._counts[phase]))

    def resume_phase(self, phase: str, n_records: int):
        """Re-open a partially written phase at exactly n_records records:
        the .bin truncated and the partial chain buffers cut to the emits
        of those records.  A kill after `save_partial` and before its
        checkpoint leaves more in both than the checkpoint covers; fewer
        records in the partial file than the checkpoint claims means a
        damaged run directory, and raises before any file is touched."""
        Df = len(self.param_names)
        path = self._bin_path(phase)
        if not path.exists():
            raise FileNotFoundError(f"cannot resume: {path} missing")
        bufs = []
        if self.keep_chains and n_records:
            pp = self._partial_path(phase)
            z = np.load(pp) if pp.exists() else {"__count__": 0}
            if int(z["__count__"]) < n_records:
                raise ValueError(
                    f"cannot resume: {pp.name} holds {int(z['__count__'])} "
                    f"records and the checkpoint claims {n_records}; the "
                    "run directory is damaged (start the run in a fresh "
                    "outdir)")
            emits = n_records // self.walkers_written
            bufs.append({k: z[k][:emits] for k in z.files
                         if k != "__count__"})
        with open(path, "rb+") as f:
            f.truncate(n_records * Df * 8)
        # the native writer owns a file it opens and truncates: append here
        self._bin_handles[phase] = PlainRecordWriter(path, Df, append=True)
        self._counts[phase] = n_records
        self._chain_buffers[phase] = bufs

    def finalize_phase(self, phase: str, keep_partial: bool = False):
        """Close the phase's .bin, write its .hdr and chains.npz.  With
        `keep_partial` the partial chains file stays until
        `discard_partial`: a caller that checkpoints the phase's end next
        keeps it until that checkpoint is on disk, so that a kill between
        the two still finds what the last mid-phase checkpoint needs."""
        if phase not in self._bin_handles:
            return
        self._bin_handles.pop(phase).close()
        with open(self._hdr_path(phase), "w") as h:
            h.write("# tamcmc-tpu samples header\n")
            h.write(f"Nvars= {len(self.param_names)}\n")
            h.write(f"Nsamples= {self._counts[phase]}\n")
            # a shard's own walkers: each shard reads back as (E, its C, D)
            h.write(f"Nchains= {self.walkers_written}\n")
            h.write("variable_names= " + " ".join(self.param_names) + "\n")
            h.write("dtype= float64_le\n")
        bufs = self._chain_buffers.pop(phase)
        if self.keep_chains:
            np.savez_compressed(self.outdir / f"{phase}_chains.npz",
                                **self._stack(bufs))
        if not keep_partial:
            self.discard_partial(phase)

    def discard_partial(self, phase: str):
        if not self.keep_chains:     # the writer that keeps them owns them
            return
        self._partial_path(phase).unlink(missing_ok=True)
        discard_stale_tmps(self._partial_path(phase))

    def abort(self):
        """Close the .bin writers WITHOUT finalizing (no .hdr): a failed run
        leaves the interrupted phase as a killed process would after its
        last flush, and `resume_phase` truncates to the checkpoint."""
        for f in self._bin_handles.values():
            f.close()
        self._bin_handles.clear()

    def close(self):
        for phase in list(self._bin_handles):
            self.finalize_phase(phase)


def _read_one(bin_path: pathlib.Path, hdr_path: pathlib.Path):
    hdr = {}
    with open(hdr_path) as f:
        for line in f:
            if line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            hdr[k.strip()] = v.strip()
    nvars = int(hdr["Nvars"])
    names = hdr["variable_names"].split()
    raw = np.fromfile(bin_path, dtype="<f8")
    n = raw.size // nvars
    if n != int(hdr["Nsamples"]):
        raise ValueError(f"{bin_path}: bin/hdr mismatch: {n} records vs "
                         f"{hdr['Nsamples']}")
    return raw.reshape(n, nvars), names, int(hdr.get("Nchains", 0))


def _host_number(path: str) -> int:
    """K of a shard file {phase}_samples.hostK.bin."""
    return int(re.search(r"\.host(\d+)\.bin$", path).group(1))


def read_bin_samples(outdir: str, phase: str, with_chains: bool = False):
    """Read back {phase}_samples.bin via its .hdr -> (samples, names), the
    reference's bin2txt input path.  A multi-process run leaves per-process
    shards ({phase}_samples.hostK.bin); they are concatenated in the order
    of K as an integer (host10 after host9).

    with_chains=True returns samples reshaped to (E, C, D) using the .hdr's
    Nchains (shards concatenate on the walker axis): per-walker chain
    structure is what autocorrelation-aware consumers (ESS, `compare`) need;
    the flat (E*C, D) interleaving destroys per-walker autocorrelation and
    inflates ESS by about tau."""
    outdir = pathlib.Path(outdir)

    def _chains(s, nchains):
        n = s.shape[0]
        if nchains and n % nchains == 0:
            return s.reshape(n // nchains, nchains, s.shape[1])
        # unknown layout (a .hdr without Nchains, or a record count that a
        # crash left non-divisible): one flat pseudo-chain, with a warning,
        # since emit-axis consumers (export --thin, ESS) then stride across
        # walkers
        print(f"warning: {phase}_samples has no usable Nchains "
              f"(Nchains={nchains}, {n} records); treating the interleaved "
              "record stream as one pseudo-chain — thinning/ESS will stride "
              "across walkers", file=sys.stderr)
        return s[:, None, :]

    single = outdir / f"{phase}_samples.bin"
    if single.exists():
        s, names, nchains = _read_one(single, outdir / f"{phase}_samples.hdr")
        return (_chains(s, nchains), names) if with_chains else (s, names)
    shards = sorted(glob.glob(str(outdir / f"{phase}_samples.host*.bin")),
                    key=_host_number)
    if not shards:
        raise FileNotFoundError(f"no {phase}_samples[.host*].bin in {outdir}")
    parts, names = [], None
    for b in shards:
        s, names, nchains = _read_one(pathlib.Path(b),
                                      pathlib.Path(b[:-4] + ".hdr"))
        parts.append(_chains(s, nchains) if with_chains else s)
    if with_chains:
        emits = {p.shape[0] for p in parts}
        if len(emits) == 1:
            return np.concatenate(parts, axis=1), names
        # desynced shards (an aborted host): flatten back to pseudo-chains
        print(f"warning: host shards of {phase}_samples are desynced "
              f"(emit counts {sorted(emits)}); flattening to pseudo-chains — "
              "thinning/ESS will stride across walkers", file=sys.stderr)
        parts = [p.reshape(-1, p.shape[-1])[:, None, :] for p in parts]
        return np.concatenate(parts, axis=0), names
    return np.concatenate(parts, axis=0), names
