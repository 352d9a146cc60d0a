"""Problem files: the user-facing encoding of a fit (port of
tamcmc_tpu/io/problemfile.py; both packages read each other's files).

The reference's `.model` file is the de-facto user API of the whole tool:
per-parameter initial values, free/fixed (relax) flags, prior kinds and
hyperparameters, plus model-family switches (`io_ms_global.cpp` etc. [U]).
Its exact byte format is not known here, so this module defines the native
**TOML problem file** with the same information content, and
`read_reference_model` marks where a byte-compatible reader would go.

Native format (TOML):

    [problem]
    model = "model_MS_Global_a1etaa3_HarveyLike"
    likelihood = "chi22p"
    data = "spectrum.data"           # or .npz
    freq_range = [1500.0, 3500.0]    # optional fit window (masked, not cut)

    [spec]                            # kwargs of the model family's Spec
    n_per_l = [13, 13, 13, 0]

    [sampler]                         # optional: MALAHyper overrides, the
    lambda_temp = 1.4                 #   reference config_default.cfg MALA
    dN_mixing = 10                    #   section [U]
    use_drift = true
    target_acceptance = 0.574         # omit -> optimal-scaling default

    [phases]                          # optional: B/L/A iteration plan, the
    burnin = 2000                     #   reference config_presets.cfg phase
    learning = 10000                  #   rows [U]
    acquire = 20000
    thin = 10
    temps = 6
    chains = 8

    [[param]]                         # one block per parameter, in ABI order
    name = "heights_0"                # informational; order is authoritative
    value = 5.0
    prior = "jeffreys"                # fix|uniform|gaussian|jeffreys|
    hyper = [0.1, 100.0]              #   uniform_gaussian|gug|auto
"""

from __future__ import annotations

import tomllib

import numpy as np

from tamcmc_tpu_torch.stats.priors import PriorTable, PriorKind


def read_problem_file(path: str):
    """Parse a native problem file -> dict with keys
    model, likelihood, data, freq_range, spec_kwargs, params0, priors."""
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    prob = doc.get("problem", {})
    out = {
        "model": prob["model"],
        "likelihood": prob.get("likelihood", "chi22p"),
        "data": prob.get("data"),
        "freq_range": prob.get("freq_range"),
        # family cross-parameter constraints (stats/assemblers.py) are ON by
        # default, the reference's priors_MS_Global behaviour [U]; set
        # `family_constraints = false` under [problem] to opt out.
        "family_constraints": bool(prob.get("family_constraints", True)),
        # auto_window = true: static c*Gamma truncation windows anchored at
        # params0 (ops/lorentzian.py window segments), the reference's
        # truncation algorithm, several times less Lorentzian arithmetic.  Off by
        # default for file-based problems: if your priors allow frequencies
        # to wander more than `window_margin` uHz (default 10) past their
        # initial values, stay dense.
        "auto_window": bool(prob.get("auto_window", False)),
        "window_margin": float(prob.get("window_margin", 10.0)),
        "spec_kwargs": {k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in doc.get("spec", {}).items()},
        "sampler": dict(doc.get("sampler", {})),
        "phases": dict(doc.get("phases", {})),
    }
    rows, values = [], []
    for p in doc.get("param", []):
        kind = p.get("prior", "fix")
        hyper = p.get("hyper", [])
        rows.append((p.get("name", f"p{len(rows)}"), kind, hyper))
        values.append(float(p["value"]))
    out["params0"] = np.asarray(values, dtype=np.float64)
    out["priors"] = PriorTable.from_rows(rows)
    return out


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (tuple, list)):
        return f"[{', '.join(_toml_value(x) for x in v)}]"
    if isinstance(v, str):
        return f'"{v}"'
    return str(v)


def write_problem_file(path: str, model: str, params0, priors: PriorTable,
                       likelihood="chi22p", data=None, freq_range=None,
                       spec_kwargs=None, sampler=None, phases=None,
                       auto_window=False, window_margin=None,
                       family_constraints=True):
    """Emit the native TOML problem file (inverse of read_problem_file).
    The [problem] switches auto_window, window_margin and
    family_constraints are written only where they differ from the
    reader's defaults."""
    lines = ["[problem]", f'model = "{model}"', f'likelihood = "{likelihood}"']
    if data:
        lines.append(f'data = "{data}"')
    if freq_range is not None:
        lines.append(f"freq_range = [{freq_range[0]}, {freq_range[1]}]")
    if auto_window:
        lines.append("auto_window = true")
    if window_margin is not None:
        lines.append(f"window_margin = {float(window_margin)!r}")
    if not family_constraints:
        lines.append("family_constraints = false")
    for section, kv in (("spec", spec_kwargs), ("sampler", sampler),
                        ("phases", phases)):
        if kv:
            lines += ["", f"[{section}]"]
            lines += [f"{k} = {_toml_value(v)}" for k, v in kv.items()]
    names = priors.names if priors.names else [f"p{i}" for i in range(priors.ndim)]
    for i in range(priors.ndim):
        lines += ["", "[[param]]",
                  f'name = "{names[i]}"',
                  f"value = {float(np.asarray(params0)[i])!r}",
                  f'prior = "{PriorKind(int(priors.kinds[i])).name.lower()}"',
                  f"hyper = [{', '.join(repr(float(h)) for h in priors.hypers[i])}]"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_reference_model(path: str):
    """BYTE-compatible reader for the C++ reference's `.model` format: not
    written, because that format's source (`io_ms_global.cpp`) is not known
    here, and raising instead of guessing keeps silent mis-parses
    impossible.

    A PROVISIONAL reader implementing the format's documented *semantics*
    (initial values, relax flags, prior kind + hypers per row, family
    switches) is io/reference.py `read_model_provisional`; `run --problem
    x.model` goes through it, with a warning banner."""
    raise NotImplementedError(
        "reference .model BYTE-compat requires the reference's source; use "
        "io.reference.read_model_provisional (semantic, provisional) or "
        "the native TOML problem file")
