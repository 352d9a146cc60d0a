"""Mode visibilities eps_lm(i) = (l-|m|)!/(l+|m|)! [P_l^|m|(cos i)]^2
(Gizon & Solanki 2003), normalised so sum_m eps_lm = 1.  Port of
tamcmc_tpu/ops/visibilities.py (reference `function_rot.cpp` [U])."""

import torch


def mode_visibility(l: int, inc_rad):
    """eps_lm(i) for m = -l..l: inc_rad (...,) -> (..., 2l+1)."""
    c = torch.cos(inc_rad)
    s = torch.sin(inc_rad)
    if l == 0:
        return torch.ones(inc_rad.shape + (1,), dtype=inc_rad.dtype,
                          device=inc_rad.device)
    if l == 1:
        e0 = c**2
        e1 = 0.5 * s**2
        return torch.stack([e1, e0, e1], dim=-1)
    if l == 2:
        e0 = 0.25 * (3.0 * c**2 - 1.0) ** 2
        # sin(2i)^2 = 4 c^2 s^2 — algebraic form, differentiable everywhere
        e1 = (3.0 / 8.0) * 4.0 * c**2 * s**2
        e2 = (3.0 / 8.0) * s**4
        return torch.stack([e2, e1, e0, e1, e2], dim=-1)
    if l == 3:
        e0 = 0.25 * (5.0 * c**3 - 3.0 * c) ** 2
        e1 = (3.0 / 16.0) * (5.0 * c**2 - 1.0) ** 2 * s**2
        e2 = (15.0 / 8.0) * c**2 * s**4
        e3 = (5.0 / 16.0) * s**6
        return torch.stack([e3, e2, e1, e0, e1, e2, e3], dim=-1)
    raise NotImplementedError(f"visibilities only implemented for l<=3, got l={l}")
