"""The counted work of a fit's step and the H100's published peaks: the
least time the Lorentzian kernels and the whole step could take, from the
shapes alone.

Frozen copies of the counts of the program's ops/lorentzian_kernel.py
(FLOPS, FLOPS_CHI22P, MUFU_CHI22P and bound_ms), so that a change there
does not move a roofline share.  The peaks are NVIDIA's data sheet for the
H100 SXM at 700 W: 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
tensor cores, 3.35 TB/s of HBM3; special-function results (the logarithm)
at 132 SMs x 16 a clock x 1.98 GHz.
"""

from __future__ import annotations

PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12
PEAK_MUFU = 132 * 16 * 1.98e9

# Float32 operations per (walker, component, bin), an FMA as two.
# Forward: d = nu - c, x = d iw, 1 + x^2 (2), the reciprocal,
# h + 2hb x (2), times inv into the sum (2): 9.  Backward: the five up to
# inv, u = g inv, p = x u, q = p inv, r = x q, s = x r, and their five
# sums: 15.
FLOPS = {"fwd": 9, "bwd": 15}
# The chi22p epilogue per (walker, bin): modes + constant, bg_n + bg_b,
# modes + bg, the floor, S / m, ln m + S / m, g = S / m^2 - 1 / m (3),
# the sums of the terms and of g (2): 11, and one logarithm.
FLOPS_CHI22P = 11
MUFU_CHI22P = 1
# The step's likelihood per (walker, bin) beyond the kernels' component
# work, forward and backward: 24 float32 operations and one logarithm.
STEP_LIKELIHOOD_OPS = 24
STEP_LOGS = 1


def kernel_bound_ms(kind, bt, nc, n, comp_bins, precision, spec_rows=1):
    """Least ms one launch of `kind` ("fwd_chi22p" or "bwd") needs: the
    larger of its operations over the peak rate of `precision` ("f32" or
    "f64") and its bytes over PEAK_BYTES.  bt walkers, nc components, n
    bins, comp_bins component-bins a walker; spec_rows rows of spectrum and
    of fixed background (one per star of a stack).  Bytes: every input
    read once and every output written once: nu, four (bt, nc) parameter
    tensors, g (bt, n) written by the forward and read by the backward,
    four (bt, nc) gradients written by the backward; the forward also
    reads the spectrum and background rows and the white levels and writes
    logL."""
    pairs = bt * comp_bins
    peak = PEAK_F64 if precision == "f64" else PEAK_F32
    size = 8 if precision == "f64" else 4
    base = "fwd" if kind == "fwd_chi22p" else kind
    ops_s = FLOPS[base] * pairs / peak
    nbytes = size * (n + bt * n + (8 if kind == "bwd" else 4) * bt * nc)
    if kind == "fwd_chi22p":
        if precision == "f64":
            ops_s += bt * n * (FLOPS_CHI22P + MUFU_CHI22P) / PEAK_F64
        else:
            ops_s += bt * n * (FLOPS_CHI22P / PEAK_F32
                               + MUFU_CHI22P / PEAK_MUFU)
        nbytes += size * (2 * spec_rows * n + 2 * bt)
    return 1e3 * max(ops_s, nbytes / PEAK_BYTES)


def step_bound_ms(bt, nc, n, comp_bins, precision, spec_rows=1):
    """Least ms of a whole MALA step: the forward's and the backward's
    component work (without the epilogue) plus the likelihood's
    STEP_LIKELIHOOD_OPS operations and STEP_LOGS logarithms per (walker,
    bin)."""
    kernels = sum(kernel_bound_ms(k, bt, nc, n, comp_bins, precision,
                                  spec_rows) for k in ("fwd", "bwd"))
    if precision == "f64":
        like = (STEP_LIKELIHOOD_OPS + STEP_LOGS) / PEAK_F64
    else:
        like = STEP_LIKELIHOOD_OPS / PEAK_F32 + STEP_LOGS / PEAK_MUFU
    return kernels + 1e3 * bt * n * like


def comp_bins(comp_lo, comp_hi):
    """Component-bins a walker: the sum of the components' range lengths."""
    return int(sum(max(int(h) - int(l), 0) for l, h in zip(comp_lo,
                                                             comp_hi)))
