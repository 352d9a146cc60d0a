"""Rotational splitting of (l, m) mode frequencies, a1etaa3 law (port of
tamcmc_tpu/ops/rotation.py; reference `function_rot.cpp` [U]):

  nu_nlm = nu_nl + m a1 + eta0 (a1 Hz)^2 nu_nl Q_lm + a3 P3(m)

with Q_lm = (l(l+1) - 3m^2)/((2l-1)(2l+3)) and P3 the Ritzwoller & Lavely
(1991) polynomial normalised so P_j(l) = l (host-side numpy, static per l).
"""

import functools

import numpy as np
import torch


def rl_polynomials(l: int, jmax: int = 6) -> np.ndarray:
    """Ritzwoller-Lavely polynomials P_j^{(l)}(m), j=1..jmax, m=-l..l:
    float64 (jmax, 2l+1), rows j > 2l zero; exact discrete Gram-Schmidt
    with P_j(l) = l."""
    m = np.arange(-l, l + 1, dtype=np.float64)
    basis = [np.ones_like(m)]
    for j in range(1, jmax + 1):
        if j > 2 * l:
            basis.append(np.zeros_like(m))
            continue
        v = m**j
        for b in basis:
            nb = np.dot(b, b)
            if nb > 0:
                v = v - (np.dot(v, b) / nb) * b
        basis.append(v)
    out = np.zeros((jmax, 2 * l + 1))
    for j in range(1, jmax + 1):
        v = basis[j]
        tail = v[-1]
        if abs(tail) > 0:
            out[j - 1] = v * (l / tail)
    return out


def qlm(l: int) -> np.ndarray:
    """Quadrupole weight Q_lm, shape (2l+1,), m = -l..l; Q_00 = 0."""
    if l == 0:
        return np.zeros((1,))
    m = np.arange(-l, l + 1, dtype=np.float64)
    return (l * (l + 1) - 3.0 * m**2) / ((2 * l - 1) * (2 * l + 3))


@functools.lru_cache(maxsize=64)
def _a1etaa3_consts(l: int, dtype, device):
    """(m, Q_lm, P3(m)) as float32 values on `device`, uploaded once."""
    p3 = rl_polynomials(l, 3)[2] if l >= 2 else np.zeros(2 * l + 1)
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
        device=device, dtype=dtype)
        for a in (np.arange(-l, l + 1), qlm(l), p3))


def split_frequencies_a1etaa3(l: int, nu_nl, a1, eta0, a3):
    """Frequencies of the 2l+1 azimuthal components [uHz].

    nu_nl: (..., N_l); a1 broadcastable to nu_nl (a (..., 1) shared
    splitting, or (..., N_l) per order); eta0 [s^2] and a3 [uHz]: (...,).
    Returns (..., N_l, 2l+1)."""
    m, q, p3 = _a1etaa3_consts(l, nu_nl.dtype, nu_nl.device)
    nu = nu_nl[..., None]
    a1b = a1[..., None]
    eta0 = eta0[..., None, None]
    a3 = a3[..., None, None]
    return nu + m * a1b + eta0 * (a1b * 1e-6) ** 2 * nu * q + a3 * p3
