"""The one generator of the benchmark's inputs: a cell's stars, their
spectra and their problem files.

A cell fits a fixed catalogue of stars, and the run's seed sets the order
in which they are stacked (and, in harness.py, the sampler's random
numbers): every seed gets the same set of stars, so the same work.
Catalogue star k draws its truth and start point from numpy's
default_rng(catalogue_seed + k), and its spectrum is the configuration's
model at the truth (the reference's dense float64 sum, every component on
every bin) times chi^2 (2 d.o.f.) / 2 noise, an exponential draw on the
device from a torch.Generator seeded with catalogue_seed + k, stored in
float32.
Each star is written as `spectrum.npz` (the float64 grid and the float32
power) and a TOML `problem.toml` in the program's problem-file format: the
model, the data, the window rule, the sampler's ladder and every
parameter's start value and prior, all values float32-exact, so that the
program and the reference read the same numbers.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from benchmark.reference import family, posterior, spectrum


@dataclasses.dataclass
class Stars:
    """A cell's S stars: start points (S, D), each star's prior rows, the
    grid (N,) float64 and the spectra (S, N) float32 (host numpy)."""
    p0: np.ndarray
    rows: list
    nu: np.ndarray
    spec: np.ndarray

    @property
    def free(self):
        return np.array([kind != "fix" for _, kind, _ in self.rows[0]])


def _f32(v):
    return float(np.float32(v))


def _start(cfg, truth, rows, rng):
    """The start point: the truth moved by the configuration's rule on the
    free parameters, then into each bounded prior's support."""
    free = np.array([k != "fix" for _, k, _ in rows])
    p0 = truth.copy()
    rule = cfg["start"]
    noise = rng.standard_normal(int(free.sum()))
    if rule["rule"] == "relative":
        p0[free] *= 1.0 + rule["factor"] * noise
    else:
        scale = []
        for _, kind, h in rows:
            if kind == "gaussian":
                scale.append(h[1] * 0.1)
            elif kind == "uniform":
                scale.append((h[1] - h[0]) * 0.01)
            elif kind == "jeffreys":
                scale.append(h[1] * 0.01)
        p0[free] += rule["factor"] * np.asarray(scale) * noise
    for i, (_, kind, h) in enumerate(rows):
        if kind == "uniform":
            p0[i] = min(max(p0[i], h[0]), h[1])
        elif kind == "jeffreys" and not 0.0 <= p0[i] <= h[1]:
            p0[i] = min(max(p0[i], h[0]), h[1])
    return np.float32(p0).astype(np.float64)


def make_stars(cfg, n_stars, catalogue_seed, seed, device):
    """The catalogue's n_stars stars in the order of a run with seed
    `seed`, on `device`."""
    fam = family(cfg["family"])
    nu64 = np.linspace(cfg["nu_lo"], cfg["nu_hi"], cfg["n_bins"])
    nu = torch.as_tensor(np.float32(nu64).astype(np.float64), device=device)
    starts, rows, specs = [], [], []
    for k in np.random.default_rng(seed).permutation(n_stars):
        rng = np.random.default_rng(catalogue_seed + int(k))
        truth, rows_k = fam.star(cfg, rng)
        rows_k = [(n, kind, [_f32(v) for v in h]) for n, kind, h in rows_k]
        starts.append(_start(cfg, truth, rows_k, rng))
        rows.append(rows_k)
        with torch.no_grad():
            H, C, W, B, noise = fam.assemble(
                cfg, torch.as_tensor(truth, device=device))
            model = spectrum.lorentzian_sum(nu, H, C, W, B) \
                + spectrum.harvey_like(nu, noise)
            gen = torch.Generator(device=device).manual_seed(
                catalogue_seed + int(k))
            spec = model * torch.empty_like(model).exponential_(generator=gen)
        specs.append(spec.to(torch.float32).cpu().numpy())
    return Stars(np.stack(starts), rows, nu64, np.stack(specs))


def _toml(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml(x) for x in v) + "]"
    if isinstance(v, str):
        return f'"{v}"'
    return repr(float(v)) if isinstance(v, float) else str(v)


def write_problems(cfg, stars, n_temps, n_chains, outdir):
    """Each star's spectrum.npz and problem.toml under outdir/star_<s>;
    returns the problem files' paths."""
    spec = family(cfg["family"]).spec_kwargs(cfg)
    paths = []
    for s in range(stars.p0.shape[0]):
        d = pathlib.Path(outdir) / f"star_{s}"
        d.mkdir(parents=True, exist_ok=True)
        np.savez(d / "spectrum.npz", nu=stars.nu, power=stars.spec[s])
        lines = ["[problem]", f'model = "{cfg["model"]}"',
                 'likelihood = "chi22p"', 'data = "spectrum.npz"']
        if cfg["windows"]:
            lines += ["auto_window = true",
                      f"window_margin = {float(cfg['window_margin'])!r}"]
        lines += ["", "[spec]"]
        lines += [f"{k} = {_toml(v)}" for k, v in spec.items()]
        lines += ["", "[sampler]", "use_drift = true",
                  f"lambda_temp = {float(cfg['lambda_temp'])!r}",
                  f"dN_mixing = {int(cfg['dN_mixing'])}",
                  "", "[phases]", f"temps = {int(n_temps)}",
                  f"chains = {int(n_chains)}"]
        for i, (name, kind, hyper) in enumerate(stars.rows[s]):
            lines += ["", "[[param]]", f'name = "{name}"',
                      f"value = {float(stars.p0[s, i])!r}",
                      f'prior = "{kind}"', f"hyper = {_toml(list(hyper))}"]
        (d / "problem.toml").write_text("\n".join(lines) + "\n")
        paths.append(d / "problem.toml")
    return paths


def reference_target(cfg, stars, device):
    """The reference's view of the same inputs (posterior.Target)."""
    free = stars.free
    kinds = [k for _, k, _ in stars.rows[0] if k != "fix"]
    hypers = np.array([[h[:2] for _, k, h in rows if k != "fix"]
                       for rows in stars.rows], dtype=np.float64)
    nu = stars.nu
    full = dict(cfg, nu_start=float(nu[0]),
                nu_step=float(np.median(np.diff(nu))))
    return posterior.Target(
        cfg=full,
        nu=torch.as_tensor(np.float32(nu).astype(np.float64), device=device),
        spec=torch.as_tensor(stars.spec.astype(np.float64), device=device),
        p0=torch.as_tensor(stars.p0, device=device), free=free, kinds=kinds,
        hypers=torch.as_tensor(hypers, device=device))


def u_scales(stars, dtype):
    """Each star's standardisation of the free parameters (S, F), in the
    cell's floating type: Gaussian sigma / 10, uniform range / 100,
    Jeffreys max / 100 (the sampler's rule from the prior table)."""
    out = []
    for rows in stars.rows:
        sc = []
        for _, kind, h in rows:
            if kind == "gaussian":
                sc.append(max(h[1] * 0.1, 1e-8))
            elif kind == "uniform":
                sc.append(max((h[1] - h[0]) * 0.01, 1e-8))
            elif kind == "jeffreys":
                sc.append(max(h[1] * 0.01, 1e-8))
        out.append(sc)
    return np.asarray(out, dtype=np.float32 if dtype == "f32" else np.float64)
