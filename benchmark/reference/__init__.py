"""The plain reference, and its configuration families loaded by name.

A configuration's `family` names a module `<family>.py` in this directory
(`DIR`).  Its interface, which the harness, the traffic generator and the
reference's posterior call:

  blocks(cfg)         the parameter vector's blocks [(name, size)]
  n_components(cfg)   Lorentzian components of the model
  assemble(cfg, p)    (H, C, W, B, noise) of parameter vectors p
  trunc_of(cfg, p0)   a window's half-width in widths (windowed only)
  star(cfg, rng)      (truth, prior rows) of one synthetic star
  constraints(cfg, p) violations of the cross-parameter constraints
  spec_kwargs(cfg)    the problem file's [spec] block
  SMALL               the configuration keys of its CPU cut (tests)

So a new family is a new file here, with no edit anywhere else.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

DIR = pathlib.Path(__file__).resolve().parent


def family(name):
    """The family module `DIR/<name>.py`, imported once as
    `benchmark.reference.<name>`."""
    key = f"{__name__}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = DIR / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise FileNotFoundError(
            f"configuration family {name!r}: no reference file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
