"""PROVISIONAL readers and writers for the reference's three-`.cfg` config
system.  Port of tamcmc_tpu/io/refconfig.py: numpy only, the same layouts,
results and error messages.

The reference executable is driven by a trio of text configs (`config.cpp`,
`Config/default/*.cfg` [U]; SURVEY.md section 2 "Config system", section
5.6):

  * config_default.cfg — the master: data paths, model/likelihood names,
    MALA hyperparameters, output cadence;
  * config_presets.cfg — the "presets" table: one row per star with its
    .model file, per-phase iteration counts and phase plan (which of
    Burn-in/Learning/Acquire to run), output location — the reference runs
    the selected rows SERIALLY;
  * errors_default.cfg — per-parameter fallback proposal step sizes used to
    seed the sampler's covariance when the .model file does not pin them.

The byte format of those files is not in this repository, so this module
implements the trio's SEMANTICS in a documented, strict, line-oriented
provisional layout.  Every read prints the provisional-format banner; every
parse error carries file:line; the writers give the round-trip fixtures.

Provisional layouts
-------------------

config_default.cfg — `[section]` + `key= value`, `;`/`#`/`!` comments:

    [data]
    data_dir= ./spectra
    [models]
    model_fullname= model_MS_Global_a1etaa3_HarveyLike   ; optional default
    likelihood= chi22p
    [MALA]
    Nchains= 6            ; temperature rungs (reference name [U])
    Nwalkers= 4           ; walkers per rung (this rebuild's ensemble axis)
    lambda_temp= 1.4
    dN_mixing= 10
    target_acceptance= 0.234
    use_drift= 0          ; 0 -> adaptive RW (reference default mode [U])
    [outputs]
    thin= 10
    ckpt_every= 0

config_presets.cfg — fixed 7-column whitespace table + key=value extras:

    ! id    model_file   Bi    Li     Ai     action  outdir
    star0   star0.model  2000  10000  20000  BLA     fits/star0  seed=1
    star1   star1.model  2000  10000  20000  A       fits/star1

  `action` selects the phases to run (any subset of the letters B, L, A);
  a phase absent from the action string gets 0 iterations — with `--resume`
  this reproduces the reference's per-phase restart workflow.

errors_default.cfg — `param_name  sigma` rows:

    a1           0.05
    inclination  0.1
    default_rel  0.01    ; fallback: sigma = default_rel * |start value|

  Matching is by exact free-parameter name; `default_rel` covers the rest.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

_BANNER_SHOWN = False

# MALAHyper field names accepted in [MALA], plus reference-style aliases [U]
_MALA_KEYS = {
    "lambda_temp": ("lambda_temp", float),
    "dn_mixing": ("dN_mixing", int),
    "target_acceptance": ("target_acceptance", float),
    "use_drift": ("use_drift", bool),
    "gain_c0": ("gain_c0", float),
    "gain_k0": ("gain_k0", float),
    "gain_alpha": ("gain_alpha", float),
    "drift_delta": ("drift_delta", float),
    "dn_chol": ("dN_chol", int),
    "cov_estimator": ("cov_estimator", str),
    "sigma_acc_estimator": ("sigma_acc_estimator", str),
    "eps_cov": ("eps_cov", float),
    "cov_floor": ("cov_floor", float),
    "sigma0_scale": ("sigma0_scale", float),
    # reference-style aliases (config_default.cfg MALA block [U])
    "c0": ("gain_c0", float),
    "epsilon1": ("eps_cov", float),
}


def _banner():
    global _BANNER_SHOWN
    if not _BANNER_SHOWN:
        print("WARNING: reading PROVISIONAL .cfg format — the reference "
              "byte format was not available for re-grounding "
              "(tamcmc_tpu_torch/io/refconfig.py); validate against the "
              "native TOML path", file=sys.stderr)
        _BANNER_SHOWN = True


def _fail(path, lineno, msg):
    raise ValueError(f"{path}:{lineno}: {msg}")


def _lines(path):
    with open(path) as f:
        for lineno, raw in enumerate(f, start=1):
            line = raw.split(";")[0].strip()
            if not line or line.startswith(("#", "!")):
                continue
            yield lineno, line


def read_config_default_provisional(path: str) -> dict:
    """Parse a provisional config_default.cfg.

    Returns {"data_dir", "model", "likelihood", "sampler" (MALAHyper field
    overrides), "temps", "chains", "thin", "ckpt_every"} with None/{} where
    the file is silent.  Unknown sections/keys are hard errors (a silently
    ignored sampler knob changes the posterior — SURVEY hard-part 5)."""
    _banner()
    path = str(path)
    out = {"data_dir": None, "model": None, "likelihood": None,
           "sampler": {}, "temps": None, "chains": None, "thin": None,
           "ckpt_every": None}
    section = None
    for lineno, line in _lines(path):
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip().lower()
            if section not in ("data", "models", "mala", "outputs"):
                _fail(path, lineno, f"unknown section [{section}]; valid: "
                                    "[data] [models] [MALA] [outputs]")
            continue
        if "=" not in line:
            _fail(path, lineno, f"expected key= value, got {line!r}")
        k, v = (t.strip() for t in line.split("=", 1))
        kl = k.lower()
        if section == "data":
            if kl != "data_dir":
                _fail(path, lineno, f"unknown [data] key {k!r}")
            out["data_dir"] = v
        elif section == "models":
            if kl == "model_fullname":
                out["model"] = v
            elif kl == "likelihood":
                out["likelihood"] = v
            else:
                _fail(path, lineno, f"unknown [models] key {k!r}")
        elif section == "mala":
            if kl == "nchains":
                out["temps"] = _num(path, lineno, k, v, int)
            elif kl == "nwalkers":
                out["chains"] = _num(path, lineno, k, v, int)
            elif kl in _MALA_KEYS:
                field, typ = _MALA_KEYS[kl]
                if typ is bool:
                    if v not in ("0", "1"):
                        _fail(path, lineno, f"{k} must be 0 or 1, got {v!r}")
                    out["sampler"][field] = v == "1"
                elif typ is str:
                    out["sampler"][field] = v
                else:
                    out["sampler"][field] = _num(path, lineno, k, v, typ)
            else:
                _fail(path, lineno, f"unknown [MALA] key {k!r}; valid: "
                                    f"Nchains Nwalkers {sorted(_MALA_KEYS)}")
        elif section == "outputs":
            if kl == "thin":
                out["thin"] = _num(path, lineno, k, v, int)
            elif kl == "ckpt_every":
                out["ckpt_every"] = _num(path, lineno, k, v, int)
            else:
                _fail(path, lineno, f"unknown [outputs] key {k!r}")
        else:
            _fail(path, lineno, f"key {k!r} before any [section]")
    return out


def _num(path, lineno, k, v, typ):
    try:
        return typ(float(v)) if typ is int else typ(v)
    except ValueError:
        _fail(path, lineno, f"non-numeric value for {k}: {v!r}")


_STAR_EXTRAS = {"seed": int, "temps": int, "chains": int, "thin": int}


def read_config_presets_provisional(path: str) -> list:
    """Parse a provisional config_presets.cfg into the star-dict list the
    `tamcmc batch` workflow consumes (cli.cmd_batch): one dict per row with
    problem/outdir/burnin/learning/acquire(+thin/seed/temps/chains)."""
    _banner()
    path = str(path)
    stars = []
    for lineno, line in _lines(path):
        toks = line.split()
        if len(toks) < 7:
            _fail(path, lineno,
                  "presets row needs 7 columns: id model_file Bi Li Ai "
                  f"action outdir [key=value...], got {len(toks)}: {line!r}")
        sid, model_file = toks[0], toks[1]
        try:
            bi, li, ai = (int(t) for t in toks[2:5])
        except ValueError:
            _fail(path, lineno, f"non-integer phase counts {toks[2:5]}")
        action = toks[5].upper()
        if not action or any(c not in "BLA" for c in action):
            _fail(path, lineno, f"action must be a subset of 'BLA', "
                                f"got {toks[5]!r}")
        star = {
            "id": sid,
            "problem": model_file,
            "outdir": toks[6],
            "burnin": bi if "B" in action else 0,
            "learning": li if "L" in action else 0,
            "acquire": ai if "A" in action else 0,
            "action": action,
        }
        for extra in toks[7:]:
            if "=" not in extra:
                _fail(path, lineno, f"trailing token {extra!r} is not "
                                    "key=value")
            k, v = extra.split("=", 1)
            if k not in _STAR_EXTRAS:
                _fail(path, lineno, f"unknown extra {k!r}; valid: "
                                    f"{sorted(_STAR_EXTRAS)}")
            star[k] = _num(path, lineno, k, v, _STAR_EXTRAS[k])
        stars.append(star)
    if not stars:
        raise ValueError(f"{path}: no preset rows")
    return stars


def read_errors_default_provisional(path: str) -> dict:
    """Parse a provisional errors_default.cfg: {param_name: sigma} plus the
    optional 'default_rel' relative fallback."""
    _banner()
    path = str(path)
    table = {}
    for lineno, line in _lines(path):
        toks = line.split()
        if len(toks) != 2:
            _fail(path, lineno, f"errors row needs 'name sigma', got {line!r}")
        try:
            sig = float(toks[1])
        except ValueError:
            _fail(path, lineno, f"non-numeric sigma {toks[1]!r}")
        if sig <= 0 or not np.isfinite(sig):
            _fail(path, lineno, f"sigma must be finite and > 0, got {sig}")
        if toks[0] in table:
            _fail(path, lineno, f"duplicate entry for {toks[0]!r}")
        table[toks[0]] = sig
    if not table:
        raise ValueError(f"{path}: no error rows")
    return table


def scales_from_errors(problem, table: dict) -> np.ndarray:
    """(Df,) initial proposal scales: prior-derived defaults overridden by
    the errors table's exact-name matches; 'default_rel' replaces the
    remaining entries with default_rel * max(|start|, 1e-6).  This is the
    errors_default.cfg role: seeding the proposal covariance (SURVEY 2)."""
    from tamcmc_tpu_torch.sampler.mala import default_init_scales
    scales = np.asarray(default_init_scales(problem), dtype=np.float64).copy()
    names = problem.free_names
    rel = table.get("default_rel")
    p0 = problem.extract(problem.params0).detach().cpu().numpy()
    matched = set()
    for i, n in enumerate(names):
        if n in table:
            scales[i] = table[n]
            matched.add(n)
        elif rel is not None:
            scales[i] = rel * max(abs(float(p0[i])), 1e-6)
    unknown = sorted(set(table) - matched - {"default_rel"})
    if unknown:
        print(f"errors_default: {len(unknown)} entries matched no free "
              f"parameter (first: {unknown[:5]})", file=sys.stderr)
    return scales


# ---- exporters: round-trip fixtures for re-grounding day ----

def write_config_default_provisional(path, data_dir=None, model=None,
                                     likelihood=None, sampler=None,
                                     temps=None, chains=None, thin=None,
                                     ckpt_every=None):
    lines = ["! tamcmc-tpu PROVISIONAL config_default export "
             "(see io/refconfig.py)"]
    if data_dir is not None:
        lines += ["[data]", f"data_dir= {data_dir}"]
    if model is not None or likelihood is not None:
        lines.append("[models]")
        if model is not None:
            lines.append(f"model_fullname= {model}")
        if likelihood is not None:
            lines.append(f"likelihood= {likelihood}")
    lines.append("[MALA]")
    if temps is not None:
        lines.append(f"Nchains= {temps}")
    if chains is not None:
        lines.append(f"Nwalkers= {chains}")
    for k, v in (sampler or {}).items():
        if isinstance(v, bool):
            v = int(v)
        lines.append(f"{k}= {v}")
    if thin is not None or ckpt_every is not None:
        lines.append("[outputs]")
        if thin is not None:
            lines.append(f"thin= {thin}")
        if ckpt_every is not None:
            lines.append(f"ckpt_every= {ckpt_every}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_config_presets_provisional(path, stars):
    lines = ["! tamcmc-tpu PROVISIONAL config_presets export",
             "! id  model_file  Bi  Li  Ai  action  outdir  [key=value...]"]
    for i, s in enumerate(stars):
        action = s.get("action") or "".join(
            c for c, n in (("B", s.get("burnin", 0)),
                           ("L", s.get("learning", 0)),
                           ("A", s.get("acquire", 0))) if n) or "BLA"
        row = (f"{s.get('id', f'star{i}')}  {s['problem']}  "
               f"{s.get('burnin', 0)}  {s.get('learning', 0)}  "
               f"{s.get('acquire', 0)}  {action}  "
               f"{s.get('outdir', f'star_{i}')}")
        for k in sorted(_STAR_EXTRAS):
            if k in s:
                row += f"  {k}={s[k]}"
        lines.append(row)
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_errors_default_provisional(path, table):
    lines = ["! tamcmc-tpu PROVISIONAL errors_default export",
             "! param_name  sigma"]
    for k, v in table.items():
        lines.append(f"{k}  {float(v)!r}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
