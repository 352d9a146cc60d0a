"""Problem-file validation, the `errors_default.cfg` analog (port of
tamcmc_tpu/io/validate.py).

The reference ships a third config file, `errors_default.cfg`, whose job is
fallback/validation of user setups (`config.cpp` [U]): a mis-parsed prior
or an initial value outside its prior support silently changes (or stalls)
the posterior.  This module makes those checks explicit and runnable BEFORE
a fit: `validate problem.toml` lints the setup and reports every problem at
once, instead of the sampler discovering them one NaN at a time.

Everything here runs on the host: numpy, plus building the model once for
its layout.  No device is touched.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

from tamcmc_tpu_torch.stats.priors import PriorKind


def _support_check(kind: int, h, x: float):
    """Returns (level, msg) for an initial value vs its per-param prior:
    level is None (fine), "warning" (legal but suspicious) or "error"
    (zero prior support: the fit cannot start).  Mirrors stats/priors.py's
    support logic in plain numpy."""
    k = PriorKind(int(kind))
    if k in (PriorKind.FIX, PriorKind.AUTO):
        return None, None
    if k == PriorKind.UNIFORM:
        if not (h[0] <= x <= h[1]):
            return "error", f"value {x:g} outside Uniform[{h[0]:g}, {h[1]:g}]"
    elif k == PriorKind.GAUSSIAN:
        sig = max(h[1], 1e-30)
        z = abs(x - h[0]) / sig
        if z > 5.0:
            # the Gaussian has full support: deliberately over-dispersed
            # starts are standard convergence-checking practice, so this is
            # a WARNING, not a blocker (hard errors stay reserved for
            # genuinely zero-support starts)
            return "warning", (f"value {x:g} is {z:.1f} prior sigma from the "
                               f"Gaussian({h[0]:g}, {h[1]:g}) mean — walkers "
                               "start in a prior-gradient desert")
    elif k == PriorKind.JEFFREYS:
        if not (0.0 <= x <= h[1]):
            return "error", f"value {x:g} outside Jeffreys[0, {h[1]:g}]"
    elif k == PriorKind.UNIFORM_GAUSSIAN:
        if x < h[0]:
            return "error", (f"value {x:g} below Uniform-Gaussian lower "
                             f"edge {h[0]:g}")
    # GUG has full support
    return None, None


def _hyper_check(name: str, kind: int, h):
    """Per-row hyperparameter sanity; returns list of error strings."""
    k = PriorKind(int(kind))
    errs = []
    if k == PriorKind.UNIFORM and not h[1] > h[0]:
        errs.append(f"param '{name}': Uniform needs hi > lo, got "
                    f"[{h[0]:g}, {h[1]:g}]")
    if k == PriorKind.GAUSSIAN and not h[1] > 0:
        errs.append(f"param '{name}': Gaussian needs sigma > 0, got {h[1]:g}")
    if k == PriorKind.JEFFREYS:
        if not h[0] > 0:
            errs.append(f"param '{name}': Jeffreys needs knee h0 > 0, got {h[0]:g}")
        if not h[1] > h[0]:
            errs.append(f"param '{name}': Jeffreys needs max h1 > knee h0, "
                        f"got h1={h[1]:g} h0={h[0]:g}")
    if k == PriorKind.UNIFORM_GAUSSIAN:
        if not h[1] >= h[0]:
            errs.append(f"param '{name}': Uniform-Gaussian needs hi >= lo")
        if not h[2] > 0:
            errs.append(f"param '{name}': Uniform-Gaussian needs sigma > 0")
    if k == PriorKind.GUG:
        if not h[1] >= h[0]:
            errs.append(f"param '{name}': GUG needs hi >= lo")
        if not (h[2] > 0 and h[3] > 0):
            errs.append(f"param '{name}': GUG needs both sigmas > 0")
    return errs


_SAMPLER_KEYS = {
    "target_acceptance", "use_drift", "cov_estimator", "cov_floor",
    "drift_delta", "gain_c0", "gain_k0", "gain_alpha", "eps_cov", "dN_chol",
    "log_sigma_min", "log_sigma_max", "sigma0_scale", "dN_mixing",
    "lambda_temp", "acc_smooth", "sigma_acc_estimator",
}
_PHASE_KEYS = {"burnin", "learning", "acquire", "thin", "temps", "chains"}


def validate_problem(path: str):
    """Lint a problem file (TOML or provisional .model).

    Returns (errors, warnings): lists of human-readable strings.  Never
    raises for content problems — only for an unreadable path."""
    errors, warnings = [], []
    p = pathlib.Path(path)
    if not p.exists():
        return [f"{path}: no such file"], []

    try:
        if str(path).endswith(".model"):
            from tamcmc_tpu_torch.io.reference import read_model_provisional
            cfg = read_model_provisional(str(path))
        else:
            from tamcmc_tpu_torch.io.problemfile import read_problem_file
            cfg = read_problem_file(str(path))
    except Exception as e:
        return [f"{path}: parse failed: {e}"], []

    # --- model + spec ---
    layout = None
    from tamcmc_tpu_torch.models import build_model
    from tamcmc_tpu_torch.models.registry import list_models
    try:
        _, layout = build_model(cfg["model"], **cfg["spec_kwargs"])
    except KeyError:
        errors.append(f"unknown model '{cfg['model']}'; see `tamcmc "
                      f"list-models` ({len(list_models())} families)")
    except Exception as e:
        errors.append(f"model '{cfg['model']}' rejected its [spec] kwargs "
                      f"{cfg['spec_kwargs']}: {e}")

    # --- parameter table ---
    priors, params0 = cfg["priors"], np.asarray(cfg["params0"])
    if layout is not None and priors.ndim != layout.ndim:
        errors.append(f"[[param]] count {priors.ndim} != model layout size "
                      f"{layout.ndim} (blocks: "
                      + ", ".join(f"{n}={s}" for n, s in
                                  zip(layout.names, layout.sizes)) + ")")
    if params0.shape[0] != priors.ndim:
        errors.append(f"{params0.shape[0]} values vs {priors.ndim} priors")
    names = priors.names or tuple(f"p{i}" for i in range(priors.ndim))
    for i in range(priors.ndim):
        errors.extend(_hyper_check(names[i], priors.kinds[i], priors.hypers[i]))
    for i in range(min(priors.ndim, params0.shape[0])):
        if not math.isfinite(float(params0[i])):
            errors.append(f"param '{names[i]}': non-finite initial value")
            continue
        level, msg = _support_check(priors.kinds[i], priors.hypers[i],
                                    float(params0[i]))
        if level == "error":
            errors.append(f"param '{names[i]}': {msg}")
        elif level == "warning":
            warnings.append(f"param '{names[i]}': {msg}")
    if int(priors.free_mask.sum()) == 0:
        errors.append("every parameter is Fix/Auto — nothing to sample")


    # --- family cross-parameter constraints at the start point ---
    # (numpy mirror of the assembler's two primitive kinds; keeps validation
    # device-free)
    if layout is not None and cfg.get("family_constraints", True) and \
            params0.shape[0] == layout.ndim:
        name_l = cfg["model"].strip().lower()
        freq_blocks = [n for n in layout.names if n.startswith("freq_l")]
        if name_l.startswith(("model_ms_global", "model_rgb_asympt")):
            for b in freq_blocks:
                o, n = layout.offset(b), layout.size(b)
                x = params0[o:o + n]
                if n >= 2 and np.any(np.diff(x) <= 0):
                    errors.append(f"initial '{b}' frequencies are not "
                                  "strictly ascending — the family "
                                  "constraint rejects every proposal from "
                                  "this start")
        if name_l.startswith("model_ajfit"):
            o, n = layout.offset("nu_nl"), layout.size("nu_nl")
            if n >= 2 and np.any(np.diff(params0[o:o + n]) <= 0):
                errors.append("initial 'nu_nl' centroids are not strictly "
                              "ascending (ajfit family constraint)")

    # --- data ---
    data_nu, data_power = None, None
    data_rel = cfg.get("data")
    if data_rel:
        data_path = pathlib.Path(data_rel)
        if not data_path.is_absolute():
            data_path = p.parent / data_path
        if not data_path.exists():
            errors.append(f"data file not found: {data_path}")
        else:
            try:
                from tamcmc_tpu_torch.io.data import read_spectrum
                d = read_spectrum(str(data_path))
                nu = np.asarray(d["nu"])
                data_nu, data_power = nu, np.asarray(d["power"])
                if nu.shape[0] < 8:
                    warnings.append(f"data has only {nu.shape[0]} bins")
                if np.any(np.diff(nu) <= 0):
                    errors.append("data frequency grid is not strictly "
                                  "increasing")
                if cfg["likelihood"] == "chi_square" and "sigma" not in d:
                    errors.append("likelihood 'chi_square' needs a 3rd "
                                  "(sigma) data column; none found")
                if cfg["likelihood"] == "chi22p" and "sigma" in d:
                    warnings.append("data has a sigma column but chi22p "
                                    "ignores it (use likelihood = "
                                    "'chi_square' for averaged spectra)")
                fr = cfg.get("freq_range")
                if fr is not None:
                    if fr[0] >= fr[1]:
                        errors.append(f"freq_range lo >= hi: {fr}")
                    elif fr[1] < nu[0] or fr[0] > nu[-1]:
                        errors.append(f"freq_range {fr} does not overlap the "
                                      f"data grid [{nu[0]:g}, {nu[-1]:g}]")
                if cfg.get("auto_window"):
                    steps = np.diff(nu)
                    if steps.size and (steps.max() - steps.min()) > \
                            1e-3 * np.median(steps):
                        errors.append("auto_window needs a uniform frequency "
                                      "grid; this grid's bin width varies")
            except Exception as e:
                errors.append(f"data file unreadable: {e}")
    elif cfg["model"].lower() != "model_ajfit":
        warnings.append("no data path in [problem]; run will fail unless "
                        "data is supplied another way")
    if cfg.get("auto_window") and \
            not cfg["model"].lower().startswith("model_ms_global"):
        warnings.append("auto_window only applies to MS-Global families; "
                        "ignored for this model")

    # --- Auto prior rows must be derivable at setup (stats/auto_priors) ---
    if layout is not None and priors.ndim == layout.ndim and \
            np.any(np.asarray(priors.kinds) == int(PriorKind.AUTO)):
        from tamcmc_tpu_torch.stats.auto_priors import (resolve_auto_priors,
                                                  AutoPriorError)
        try:
            resolve_auto_priors(priors, params0, layout=layout,
                                nu=data_nu, spec=data_power)
        except AutoPriorError as e:
            errors.append(str(e))

    # --- sampler / phases sections ---
    for k in cfg.get("sampler", {}):
        if k not in _SAMPLER_KEYS:
            warnings.append(f"[sampler] unknown key '{k}' (valid: "
                            + ", ".join(sorted(_SAMPLER_KEYS)) + ")")
    lam = cfg.get("sampler", {}).get("lambda_temp")
    if lam is not None and not lam > 1.0:
        errors.append(f"[sampler] lambda_temp must be > 1, got {lam}")
    for k, v in cfg.get("phases", {}).items():
        if k not in _PHASE_KEYS:
            warnings.append(f"[phases] unknown key '{k}' (valid: "
                            + ", ".join(sorted(_PHASE_KEYS)) + ")")
        elif not (isinstance(v, int) and v > 0):
            errors.append(f"[phases] {k} must be a positive integer, got {v!r}")

    return errors, warnings
