"""Spectrum data IO (port of tamcmc_tpu/io/data.py; reference `.data`
readers behind `Data_Nd`, `data.h`, `string_handler.cpp` [U]).

Format: ASCII, '#', '!' or '*' comment lines, two or three
whitespace-separated columns: frequency [uHz], power [ppm^2/uHz] (, sigma).
npz is also supported for fast round-trips.  An ASCII file is parsed by
io/native.py's `native_read_table` (a `strtod` loop in C++; no fallback);
`read_table_plain` is the plain Python version.  Both round correctly, so
they give the same float64 bits (`make-example` writes the grid column in
float64, and the window plan is built from those exact values).
"""

from __future__ import annotations

import numpy as np

from tamcmc_tpu_torch.io.native import native_read_table


def read_table_plain(path) -> np.ndarray:
    """The plain version of `native_read_table`: Python's `float` on every
    whitespace-separated field of each non-comment line."""
    rows = []
    with open(path) as f:
        for line in f:
            t = line.strip()
            if not t or t[0] in "#!*":
                continue
            rows.append([float(v) for v in t.split()])
    return np.asarray(rows, dtype=np.float64)


def read_spectrum(path: str):
    """Returns dict with 'nu', 'power' (and 'sigma' if a 3rd column exists)."""
    p = str(path)
    if p.endswith(".npz"):
        z = np.load(p)
        out = {"nu": z["nu"], "power": z["power"]}
        if "sigma" in z:
            out["sigma"] = z["sigma"]
        return out
    arr = native_read_table(p)
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
