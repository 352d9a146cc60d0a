"""Spectrum data IO (port of tamcmc_tpu/io/data.py; reference `.data`
readers behind `Data_Nd`, `data.h`, `string_handler.cpp` [U]).

Format: ASCII, '#', '!' or '*' comment lines, two or three
whitespace-separated columns: frequency [uHz], power [ppm^2/uHz] (, sigma).
npz is also supported for fast round-trips.  Host-side numpy; the reference
tries its C++ table reader first and falls back to numpy, the port has the
numpy reader only.
"""

from __future__ import annotations

import numpy as np


def read_spectrum(path: str):
    """Returns dict with 'nu', 'power' (and 'sigma' if a 3rd column exists)."""
    p = str(path)
    if p.endswith(".npz"):
        z = np.load(p)
        out = {"nu": z["nu"], "power": z["power"]}
        if "sigma" in z:
            out["sigma"] = z["sigma"]
        return out
    rows = []
    with open(p) as f:
        for line in f:
            t = line.strip()
            if not t or t[0] in "#!*":
                continue
            rows.append([float(v) for v in t.split()])
    arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError(f"{path}: expected >=2 columns, got shape {arr.shape}")
    out = {"nu": arr[:, 0], "power": arr[:, 1]}
    if arr.shape[1] >= 3:
        out["sigma"] = arr[:, 2]
    return out


def write_spectrum(path: str, nu, power, sigma=None):
    p = str(path)
    if p.endswith(".npz"):
        data = {"nu": nu, "power": power}
        if sigma is not None:
            data["sigma"] = sigma
        np.savez_compressed(p, **data)
        return
    cols = [nu, power] + ([sigma] if sigma is not None else [])
    np.savetxt(p, np.column_stack(cols),
               header="frequency_uHz power_ppm2_uHz" +
                      (" sigma" if sigma is not None else ""))
