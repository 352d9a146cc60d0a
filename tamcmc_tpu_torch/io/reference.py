"""PROVISIONAL reader/writer for the reference's `.model` problem format
(port of tamcmc_tpu/io/reference.py; both packages read each other's
files).

The reference's `.model` file is the de-facto user API of cpptamcmc
(`io_ms_global.cpp`, `io_local.cpp` [U]): per-parameter initial values,
relax (free/fixed) flags, prior kind + hyperparameters, plus model-family
switches.  Its exact byte format is not known here, so this module
implements the format's documented *semantics* in a line-oriented layout
chosen to be plausible and strict:

    ! free-text header comment
    !model_fullname= model_MS_Global_a1etaa3_HarveyLike
    !data= spectrum.data                  (optional)
    !likelihood= chi22p                   (optional, default chi22p)
    !fit_range= 1500.0 3500.0             (optional)
    !spec.n_per_l= 13 13 13 0             (model-family Spec kwargs)
    # one row per parameter, in plength ABI order:
    # [name] value relax prior_name [h0 h1 h2 h3]
    heights_0   5.0  1  Jeffreys  0.1 100.0
    a1          1.2  1  Uniform   0.0 8.0
    asym        0.0  0  Fix

Semantics implemented:
  * relax=1 -> parameter is free, prior from prior_name + hypers
  * relax=0 -> parameter frozen at value (kind Fix, regardless of prior col)
  * prior names (case-insensitive): Fix, Uniform, Gaussian, Jeffreys,
    Uniform_Gaussian, GUG (Gaussian_Uniform_Gaussian), Auto

Every read prints the provisional-format banner once per process, and
`problemfile.read_reference_model` (the byte-compat entry) keeps raising,
so no silent mis-parse is possible.  Errors cite the file and line.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from tamcmc_tpu_torch.stats.priors import PriorTable, PriorKind

_BANNER_SHOWN = False

_PRIOR_NAMES = {
    "fix": PriorKind.FIX,
    "uniform": PriorKind.UNIFORM,
    "gaussian": PriorKind.GAUSSIAN,
    "jeffreys": PriorKind.JEFFREYS,
    "uniform_gaussian": PriorKind.UNIFORM_GAUSSIAN,
    "gug": PriorKind.GUG,
    "gaussian_uniform_gaussian": PriorKind.GUG,
    "auto": PriorKind.AUTO,
}

_N_HYPERS = {          # required hyperparameter count per prior kind
    PriorKind.FIX: 0, PriorKind.UNIFORM: 2, PriorKind.GAUSSIAN: 2,
    PriorKind.JEFFREYS: 2, PriorKind.UNIFORM_GAUSSIAN: 3,
    PriorKind.GUG: 4, PriorKind.AUTO: 0,
}


def _banner():
    global _BANNER_SHOWN
    if not _BANNER_SHOWN:
        print("WARNING: reading PROVISIONAL .model format: the reference's "
              "byte format is not known "
              "(tamcmc_tpu_torch/io/reference.py); validate posteriors "
              "against the native TOML path", file=sys.stderr)
        _BANNER_SHOWN = True


def _fail(path, lineno, msg):
    raise ValueError(f"{path}:{lineno}: {msg}")


def read_model_provisional(path: str) -> dict:
    """Parse a provisional-format .model file.

    Returns the same dict shape as problemfile.read_problem_file:
    model, likelihood, data, freq_range, spec_kwargs, sampler, phases,
    params0, priors, family_constraints.
    """
    _banner()
    path = str(path)
    header = {"likelihood": "chi22p", "data": None, "freq_range": None}
    spec_kwargs = {}
    model_name = None
    rows, values = [], []

    with open(path) as f:
        for lineno, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("!"):
                if "=" not in line:
                    continue                      # free-text header comment
                k, v = line[1:].split("=", 1)
                k, v = k.strip(), v.strip()
                if k == "model_fullname":
                    model_name = v
                elif k == "data":
                    header["data"] = v
                elif k == "likelihood":
                    header["likelihood"] = v
                elif k == "fit_range":
                    parts = v.split()
                    if len(parts) != 2:
                        _fail(path, lineno, f"fit_range needs 2 numbers, "
                                            f"got {v!r}")
                    try:
                        header["freq_range"] = (float(parts[0]),
                                                float(parts[1]))
                    except ValueError:
                        _fail(path, lineno, f"non-numeric fit_range {v!r}")
                elif k.startswith("spec."):
                    parts = v.split()
                    try:
                        nums = [float(p) for p in parts]
                    except ValueError:
                        spec_kwargs[k[5:]] = v     # string-valued kwarg
                        continue
                    ints = [int(n) for n in nums]
                    vals = ints if all(i == n for i, n in zip(ints, nums)) \
                        else nums
                    spec_kwargs[k[5:]] = tuple(vals) if len(vals) > 1 \
                        else vals[0]
                else:
                    _fail(path, lineno, f"unknown header key !{k}=")
                continue

            # --- parameter row: [name] value relax prior [h0..h3] ---
            toks = line.split()
            name = None
            try:
                float(toks[0])
            except ValueError:
                name = toks[0]
                toks = toks[1:]
            if len(toks) < 3:
                _fail(path, lineno,
                      "parameter row needs: [name] value relax prior "
                      f"[hypers...], got {line!r}")
            try:
                value = float(toks[0])
            except ValueError:
                _fail(path, lineno, f"non-numeric initial value {toks[0]!r}")
            if toks[1] not in ("0", "1"):
                _fail(path, lineno, f"relax flag must be 0 or 1, "
                                    f"got {toks[1]!r}")
            relax = toks[1] == "1"
            pname = toks[2].lower()
            if pname not in _PRIOR_NAMES:
                _fail(path, lineno, f"unknown prior {toks[2]!r}; valid: "
                                    f"{sorted(set(_PRIOR_NAMES))}")
            kind = _PRIOR_NAMES[pname] if relax else PriorKind.FIX
            try:
                hypers = [float(t) for t in toks[3:]]
            except ValueError:
                _fail(path, lineno, f"non-numeric hyperparameter in {line!r}")
            if len(hypers) > 4:
                _fail(path, lineno, f"at most 4 hyperparameters, "
                                    f"got {len(hypers)}")
            if relax and len(hypers) < _N_HYPERS[kind]:
                _fail(path, lineno,
                      f"prior {toks[2]} needs {_N_HYPERS[kind]} "
                      f"hyperparameters, got {len(hypers)}")
            rows.append((name or f"p{len(rows)}", kind, hypers))
            values.append(value)

    if model_name is None:
        raise ValueError(f"{path}: missing required !model_fullname= header")
    if not rows:
        raise ValueError(f"{path}: no parameter rows")
    return {
        "model": model_name,
        "likelihood": header["likelihood"],
        "data": header["data"],
        "freq_range": header["freq_range"],
        "spec_kwargs": spec_kwargs,
        "sampler": {},
        "phases": {},
        "params0": np.asarray(values, dtype=np.float64),
        "priors": PriorTable.from_rows(rows),
        "family_constraints": True,
    }


def write_model_provisional(path: str, model: str, params0,
                            priors: PriorTable, likelihood="chi22p",
                            data=None, freq_range=None, spec_kwargs=None):
    """Emit the provisional .model format (inverse of
    read_model_provisional)."""
    lines = ["! tamcmc-tpu PROVISIONAL .model export (see io/reference.py)",
             f"!model_fullname= {model}",
             f"!likelihood= {likelihood}"]
    if data:
        lines.append(f"!data= {data}")
    if freq_range is not None:
        lines.append(f"!fit_range= {freq_range[0]} {freq_range[1]}")
    for k, v in (spec_kwargs or {}).items():
        vv = " ".join(str(x) for x in v) if isinstance(v, (tuple, list)) \
            else str(v)
        lines.append(f"!spec.{k}= {vv}")
    names = priors.names or [f"p{i}" for i in range(priors.ndim)]
    p0 = np.asarray(params0, dtype=np.float64)
    for i in range(priors.ndim):
        kind = PriorKind(int(priors.kinds[i]))
        relax = 0 if kind in (PriorKind.FIX, PriorKind.AUTO) else 1
        nh = _N_HYPERS[kind]
        hyp = " ".join(repr(float(h)) for h in priors.hypers[i][:nh])
        row = f"{names[i]}  {float(p0[i])!r}  {relax}  {kind.name.title()}"
        lines.append(row + (f"  {hyp}" if hyp else ""))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
