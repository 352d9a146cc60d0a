"""Rotational splitting of (l, m) mode frequencies (port of
tamcmc_tpu/ops/rotation.py; reference `function_rot.cpp` [U]).  Two laws:

  a1etaa3:  nu_nlm = nu_nl + m a1 + eta0 (a1 Hz)^2 nu_nl Q_lm + a3 P3(m)
  aj:       nu_nlm = nu_nl + sum_{j=1..6} a_j P_j(m)
            (+ eta0 (a1 Hz)^2 nu_nlm Q_lm when the model's eta switch is on)

with Q_lm = (l(l+1) - 3m^2)/((2l-1)(2l+3)) and P_j the Ritzwoller & Lavely
(1991) polynomials normalised so P_j(l) = l (host-side numpy, static per l).
Everything is batched over leading dims: per-walker scalars are (...,),
frequency blocks (..., N_l), results (..., N_l, 2l+1).
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


@functools.lru_cache(maxsize=64)
def _aj_consts(l: int, dtype, device):
    """(P_1..P_6 (6, 2l+1), Q_lm (2l+1,)) as float32 values on `device`."""
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
        device=device, dtype=dtype) for a in (rl_polynomials(l, 6), qlm(l)))


def split_frequencies_aj(l: int, nu_nl, aj_coeffs):
    """General a-coefficient splitting nu + sum_j a_j P_j(m) [uHz].

    nu_nl: (..., N_l); aj_coeffs: (..., 6), a1..a6 per walker (entries with
    j > 2l meet a zero polynomial row).  Returns (..., N_l, 2l+1)."""
    polys, _ = _aj_consts(l, nu_nl.dtype, nu_nl.device)
    # six terms per m: a product and a sum, no matrix-multiply library call
    shift = (aj_coeffs[..., :, None] * polys).sum(-2)         # (..., 2l+1)
    return nu_nl[..., None] + shift[..., None, :]


def centrifugal_shift_aj(l: int, nu_nlm, eta0, a1):
    """The aj family's centrifugal term: nu + eta0 (a1 Hz)^2 nu Q_lm.

    nu_nlm: (..., N_l, 2l+1); eta0 [s^2] and a1 [uHz]: (...,)."""
    _, q = _aj_consts(l, nu_nlm.dtype, nu_nlm.device)
    eta0 = eta0[..., None, None]
    a1 = a1[..., None, None]
    return nu_nlm + eta0 * (a1 * 1e-6) ** 2 * nu_nlm * q
