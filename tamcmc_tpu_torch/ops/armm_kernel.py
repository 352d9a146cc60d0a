"""Wrapper of the hand-written CUDA bisection of the ARMM solver
(csrc/armm.cu).

It replaces no TPU kernel: the reference's 45 halvings
(tamcmc_tpu/ops/armm.py, mixed_mode_frequencies) are jnp code that XLA
fuses, and the port's plain loop (ops/armm.py `bisect_plain`) is ~30 small
torch ops a halving.  The forward kernel runs every halving of one
(walker, slot) in registers and writes the root and its decisions as one
64-bit mask; the backward kernel replays the mask in reverse with the
upstream gradient.  Both repeat the plain loop's arithmetic and autograd's
sums one rounding at a time, so roots and gradients are the plain loop's on
the card bit for bit (the source's note says how).

This module holds the launches, the autograd Function and the plain
replays the tests hold the kernels to, and counts each launch in
`utils.metrics.COUNTERS["armm_launches"]`; it routes nothing.  ops/armm.py
chooses by tensor device and calls `bisect` for CUDA tensors,
which raises on anything it cannot launch: a failed build, a bad argument
or a refused launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tamcmc_tpu_torch.ops import _cuda_build
from tamcmc_tpu_torch.utils.metrics import COUNTERS

MAX_BISECT = 64          # decisions a mask holds (.cu)
# the walker scalars of a row, in the order of ops/armm.py `_f` (.cu)
ROW = ("dnu", "eps_p", "dpi1", "eps_g", "q", "delta0l", "alpha_p", "nmax_x",
       "alpha_g", "pi0_x")

# SASS instructions a thread issues per halving of the float32 forward on
# its common path (both tanf in their three-part reduction, both divisions
# on their fast path; `cuobjdump -sass` of the sm_90a build, CUDA 12.9):
# 9 for mid / dnu, 20 up to 1e6 / (dpi1 mid), 16 to the first reduction,
# 24 to the second, 30 to the next halving.  Its special-function ops (three
# or five MUFU.RCP, two F2I) cost fewer of their quarter-rate slots.
INSTR_PER_HALVING = 99
# Lane-instructions the H100 SXM dispatches a second: 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz.
PEAK_LANE_INSTR = 132 * 4 * 32 * 1.98e9


def bound_ms(n_slots: int, n_bisect: int = 45) -> float:
    """Least ms of the float32 forward over n_slots (walker, slot)
    brackets: its instructions over the card's dispatch rate (its bytes,
    20 a slot, take ~30 times less)."""
    return 1e3 * n_slots * n_bisect * INSTR_PER_HALVING / PEAK_LANE_INSTR


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernels, with their C argument types."""
    lib = _cuda_build.load("armm")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("armm_bisect_fwd", "armm_bisect_fwd_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 5 + [L, I, I, P]
        fn.restype = I
    for name in ("armm_bisect_bwd", "armm_bisect_bwd_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 4 + [L, I, P]
        fn.restype = I
    return lib


def _launcher(kind: str, dtype):
    return getattr(_lib(), f"armm_bisect_{kind}"
                   + ("_f64" if dtype == torch.float64 else ""))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check(lo, hi, rows, n_bisect):
    if lo.device.type != "cuda":
        raise ValueError(f"the ARMM bisection kernel needs CUDA tensors, got "
                         f"lo on {lo.device}")
    if lo.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the ARMM bisection kernel runs float32 or float64,"
                         f" got {lo.dtype}")
    w, s = lo.shape
    for t, shape, name in ((hi, (w, s), "hi"), (rows, (w, len(ROW)),
                                                 "rows")):
        if (t.device != lo.device or t.dtype != lo.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {lo.dtype} "
                             f"{shape} tensor on {lo.device}, as lo")
    if not lo.is_contiguous():
        raise ValueError("lo must be contiguous")
    if not 0 <= n_bisect <= MAX_BISECT:
        raise ValueError(f"n_bisect must lie in [0, {MAX_BISECT}], got "
                         f"{n_bisect}")


def bisect_forward(lo, hi, rows, n_bisect: int):
    """The forward kernel: lo, hi (W, S) brackets and rows (W, len(ROW))
    walker scalars, all contiguous CUDA float32 or float64 -> (freqs (W, S),
    mask (W, S) int64 of the decisions)."""
    _check(lo, hi, rows, n_bisect)
    freqs = torch.empty_like(lo)
    mask = torch.empty(lo.shape, dtype=torch.int64, device=lo.device)
    if lo.numel():
        _raise_on(_launcher("fwd", lo.dtype)(
            *map(_ptr, (lo, hi, rows, freqs, mask)), lo.numel(),
            lo.shape[1], n_bisect, _stream(lo.device)), "armm_bisect_fwd")
        COUNTERS["armm_launches"]["armm"] += 1
    return freqs, mask


def bisect_backward(g, mask, n_bisect: int):
    """The backward kernel: the gradients (glo, ghi) of the brackets from
    the upstream gradient g of the roots and the forward's mask."""
    g = g.contiguous()
    if (g.device.type != "cuda" or mask.device != g.device
            or mask.dtype != torch.int64 or mask.shape != g.shape
            or not mask.is_contiguous()):
        raise ValueError("g and the forward's int64 mask must be CUDA "
                         "tensors of one shape")
    if not 0 <= n_bisect <= MAX_BISECT:
        raise ValueError(f"n_bisect must lie in [0, {MAX_BISECT}], got "
                         f"{n_bisect}")
    glo, ghi = torch.empty_like(g), torch.empty_like(g)
    if g.numel():
        _raise_on(_launcher("bwd", g.dtype)(
            *map(_ptr, (g, mask, glo, ghi)), g.numel(), n_bisect,
            _stream(g.device)), "armm_bisect_bwd")
        COUNTERS["armm_launches"]["armm_bwd"] += 1
    return glo, ghi


class _Bisect(torch.autograd.Function):
    """Forward kernel in forward, backward kernel in backward; the walker
    scalars get no gradient (they reach the roots only through the
    decisions)."""

    @staticmethod
    def forward(ctx, lo, hi, rows, n_bisect):
        freqs, mask = bisect_forward(lo, hi, rows, n_bisect)
        ctx.save_for_backward(mask)
        ctx.n_bisect = n_bisect
        return freqs

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        glo, ghi = bisect_backward(g, mask, ctx.n_bisect)
        return glo, ghi, None, None


def bisect(lo, hi, n_bisect: int, *walker):
    """Kernel path of ops/armm.py `_bisect`: brackets lo, hi (..., S) and
    the walker scalars of ROW, each (..., 1), CUDA -> the roots (..., S).
    Differentiable in lo and hi."""
    if len(walker) != len(ROW):
        raise ValueError(f"{len(ROW)} walker scalars ({', '.join(ROW)}), "
                         f"got {len(walker)}")
    s = lo.shape[-1]
    rows = torch.cat([w.detach() for w in walker], dim=-1)
    if rows.shape[:-1] != lo.shape[:-1]:
        raise ValueError(f"walker scalars of shape {tuple(rows.shape[:-1])} "
                         f"for brackets of shape {tuple(lo.shape)}")
    freqs = _Bisect.apply(lo.contiguous().reshape(-1, s),
                          hi.contiguous().reshape(-1, s),
                          rows.reshape(-1, len(ROW)), n_bisect)
    return freqs.reshape(lo.shape)


def pack_decisions(decisions):
    """The forward's mask from the plain loop's decisions (bool tensors, one
    a halving, ops/armm.py `bisect_plain(..., decisions=list)`)."""
    mask = torch.zeros(decisions[0].shape, dtype=torch.int64,
                       device=decisions[0].device)
    for k, pos in enumerate(decisions):
        mask |= pos.to(torch.int64) << k
    return mask


def replay_backward(g, mask, n_bisect: int):
    """The backward kernel's recurrence as torch ops: (glo, ghi) from the
    roots' gradient g and the mask.  The plain version of
    `bisect_backward`; on the CPU it equals autograd's gradient of
    `bisect_plain` bit for bit."""
    zero = torch.zeros_like(g)
    glo = ghi = g * 0.5
    for k in reversed(range(n_bisect)):
        pos = ((mask >> k) & 1).bool()
        gs = (torch.where(pos, ghi, zero) + torch.where(pos, zero, glo)) * 0.5
        glo = torch.where(pos, glo, zero) + gs
        ghi = torch.where(pos, zero, ghi) + gs
    return glo, ghi
