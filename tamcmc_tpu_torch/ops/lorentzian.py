"""Lorentzian mode-profile sums: the plain torch reference and the routed
entry points of the main path.

Port of tamcmc_tpu/ops/lorentzian.py.  Profile (Nigam & Kosovichev 1998
asymmetry b), in the factored form the reference uses:
    x = 2 (nu - nu0) / max(Gamma, 1e-6),   inv = 1 / (1 + x^2)
    L(nu) = H b^2 + (H + 2 H b x) * inv

Every function is batched over leading dims: params (..., NC), grid (N,) ->
(..., N).  The plain versions (`*_plain`, `sum_lorentzians_trunc`) are
`torch.autograd.Function`s whose backward is the reference's closed form
(five shared reductions), never naive autograd, which would keep a
(batch, NC, N) residual per op alive.

All routing lives here.  `sum_lorentzians`, `sum_lorentzians_trunc_batched`,
`segment_values`, `sum_lorentzians_segments` and `lorentzian_chi22p` choose
by tensor device only: CUDA tensors go through the hand-written kernels of
ops/lorentzian_kernel.py, CPU tensors through the plain versions here.  A
CUDA tensor never falls back: a failed build, a bad argument or a refused
launch raises.  CUDA float64 tensors (an f64 problem) launch the kernels'
float64 instantiation in the dense, segment and fused forms; the windowed
sum raises for them (float32 only).  The windowed sum runs over the dense
plan, and its kernels visit, per tile or chunk, only the components whose
window meets its bins, a rule read from C and win on the card at each call.

`lorentzian_chi22p` is the main path of every chi22p fit without a mask:
the mode sum, the background and the chi^2(2 dof) likelihood in one
forward kernel (its epilogue), so that the (Bt, N) model never reaches
device memory; its plain version is the unfused chain
(likelihood_chi22p_pieces over `segment_values_plain` on a segment plan,
likelihood_chi22p over `sum_lorentzians_plain` on a dense one).

Precision of the profile stream.  The dense and segment sums take a
`precision` argument, "f32" (the stream in the inputs' own floating type:
float32, or float64 for an f64 problem) or "bf16", the reference's
`set_profile_precision("bf16")` stream: x = (nu - c)(2/W) in float32, then
bf16(x), inv = 1/(1 + xb^2) and (bf16(H) + bf16(2Hb) xb) inv in bfloat16,
summed over components in float32; the backward casts g to bf16 and forms
u, p, q, r, s in bfloat16 with float32 reductions, G and the closed form in
float32.  The model build hands the precision down with every call (and
into its LorentzPlan), so two problems of different precision live in one
process; the reference latches it process-wide because its jit caches bake
it in.  The windowed sums (`sum_lorentzians_trunc*`) are float32 only, in
both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tamcmc_tpu_torch.ops import lorentzian_kernel as _kernel
from tamcmc_tpu_torch.stats.likelihoods import (likelihood_chi22p,
                                                likelihood_chi22p_pieces)

_WFLOOR = 1e-6
_BF16 = torch.bfloat16


def _on_cuda(*tensors) -> bool:
    return any(t.is_cuda for t in tensors)


def lorentzian_profile(nu, height, nu0, width, asym=0.0):
    """One (possibly asymmetric) Lorentzian on grid nu (n,), plain torch:
    H [(1 + b x)^2 + b^2] / (1 + x^2), x = 2 (nu - nu0) / max(Gamma, 1e-6).
    Parameters broadcast against the grid: pass (..., 1) for (..., n)."""
    w = torch.clamp(width, min=_WFLOOR)
    x = 2.0 * (nu - nu0) / w
    num = (1.0 + asym * x) ** 2 + asym ** 2
    return height * num / (1.0 + x * x)


# ---------------------------------------------------------------------------
# dense sum (plain)
# ---------------------------------------------------------------------------

def _fwd_impl(nu, H, C, W, B, precision="f32"):
    w = torch.clamp(W, min=_WFLOOR)
    iw = 2.0 / w
    hb2 = 2.0 * H * B
    x = (nu - C[..., None]) * iw[..., None]               # (..., NC, N)
    # frequency-independent continuum of the asymmetric terms: sum_k H b^2
    cont = torch.sum(H * B * B, dim=-1, keepdim=True)
    if precision == "bf16":
        # x stays float32 (mode positions); the inv/product stream is bf16,
        # each op rounded; the cross-component sum is float32
        xb = x.to(_BF16)
        inv = 1.0 / (1.0 + xb * xb)
        contrib = (H[..., None].to(_BF16) + hb2[..., None].to(_BF16) * xb) \
            * inv
        return cont + torch.sum(contrib, dim=-2, dtype=x.dtype)
    inv = 1.0 / (1.0 + x * x)
    return cont + torch.sum((H[..., None] + hb2[..., None] * x) * inv, dim=-2)


def _bwd_impl(nu, H, C, W, B, g, precision="f32"):
    """Closed-form cotangents of the factored form (reference `_bwd`):
      dL/dH = b^2 + (1 + 2bx)·inv,   dL/db = 2Hb + 2H·x·inv
      dL/dx = 2Hb·inv − (H + 2Hb·x)·2x·inv^2,   dx/dc = −2/w,  dx/dw = −x/w.
    G = Σ g is shared by every component's constant parts.  In bf16 the
    stream u..s runs in bfloat16 (g cast once), its five sums in float32."""
    w = torch.clamp(W, min=_WFLOOR)
    iw = 2.0 / w
    hb2 = 2.0 * H * B
    G = torch.sum(g, dim=-1, keepdim=True)
    x = (nu - C[..., None]) * iw[..., None]
    if precision == "bf16":
        x = x.to(_BF16)
        gs = g.to(_BF16)
    else:
        gs = g
    inv = 1.0 / (1.0 + x * x)
    u = gs[..., None, :] * inv
    p = x * u
    q = p * inv
    r = x * q
    s = x * r
    Su, Sp, Sq, Sr, Ss = (torch.sum(t, dim=-1, dtype=g.dtype)
                          for t in (u, p, q, r, s))
    gh = B * B * G + Su + 2.0 * B * Sp
    gb = hb2 * G + 2.0 * H * Sp
    dx = hb2 * Su - 2.0 * H * Sq - 2.0 * hb2 * Sr
    dxx = hb2 * Sp - 2.0 * H * Sr - 2.0 * hb2 * Ss
    gc = -iw * dx
    gw = torch.where(W > _WFLOOR, -dxx / w, torch.zeros_like(W))
    return gh, gc, gw, gb


class _SumLorentzians(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nu, H, C, W, B, precision):
        ctx.save_for_backward(nu, H, C, W, B)
        ctx.precision = precision
        return _fwd_impl(nu, H, C, W, B, precision)

    @staticmethod
    def backward(ctx, g):
        return ((None,) + _bwd_impl(*ctx.saved_tensors, g, ctx.precision)
                + (None,))


def sum_lorentzians_plain(nu, H, C, W, B, precision="f32"):
    """Dense Lorentzian sum, plain torch: (..., NC) -> (..., N).
    Zero-height components contribute exactly 0 (static padding).
    `precision`: "f32" or "bf16", the profile stream (module docstring)."""
    return _SumLorentzians.apply(nu, H, C, W, B,
                                 _kernel.check_precision(precision))


# ---------------------------------------------------------------------------
# windowed (truncated) sum (plain) — the reference's truncation semantics
# ---------------------------------------------------------------------------

def _trunc_terms(nu, H, C, W, B, win):
    w = torch.clamp(W, min=_WFLOOR)
    iw = 2.0 / w
    d = nu - C[..., None]
    x = d * iw[..., None]
    m = (torch.abs(d) <= win[..., None]).to(nu.dtype)
    inv = 1.0 / (1.0 + x * x)
    return w, iw, x, m, inv


def _trunc_fwd_impl(nu, H, C, W, B, win):
    _, _, x, m, inv = _trunc_terms(nu, H, C, W, B, win)
    hb2 = 2.0 * H * B
    hbb = H * B * B
    contrib = hbb[..., None] + (H[..., None] + hb2[..., None] * x) * inv
    return torch.sum(contrib * m, dim=-2)


def _trunc_bwd_impl(nu, H, C, W, B, win, g):
    """Same closed forms as _bwd_impl with every reduction masked by the
    window; the window gets no gradient (hard edges, like the reference)."""
    w, iw, x, m, inv = _trunc_terms(nu, H, C, W, B, win)
    hb2 = 2.0 * H * B
    gm = g[..., None, :] * m
    u = gm * inv
    p = x * u
    q = p * inv
    r = x * q
    s = x * r
    Gk, Su, Sp, Sq, Sr, Ss = (torch.sum(t, dim=-1)
                              for t in (gm, u, p, q, r, s))
    gh = B * B * Gk + Su + 2.0 * B * Sp
    gb = hb2 * Gk + 2.0 * H * Sp
    dx = hb2 * Su - 2.0 * H * Sq - 2.0 * hb2 * Sr
    dxx = hb2 * Sp - 2.0 * H * Sr - 2.0 * hb2 * Ss
    gc = -iw * dx
    gw = torch.where(W > _WFLOOR, -dxx / w, torch.zeros_like(W))
    return gh, gc, gw, gb


class _SumLorentziansTrunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nu, H, C, W, B, win):
        ctx.save_for_backward(nu, H, C, W, B, win)
        return _trunc_fwd_impl(nu, H, C, W, B, win)

    @staticmethod
    def backward(ctx, g):
        return (None,) + _trunc_bwd_impl(*ctx.saved_tensors, g) + (None,)


def sum_lorentzians_trunc(nu, H, C, W, B, win):
    """Windowed Lorentzian sum, plain torch: (..., NC) -> (..., N).

    A component contributes 0 outside |nu - nu0| <= win; win = +inf is the
    dense profile, a negative window contributes nothing."""
    return _SumLorentziansTrunc.apply(nu, H, C, W, B, win)


# ---------------------------------------------------------------------------
# static window groups and their disjoint partition (host side, numpy)
# ---------------------------------------------------------------------------

_GROUP_MAX = 64   # components per group (the reference's unroll chunk)
_NEW_GROUP_COST_BINS = 512   # (component x bin) cost charged per new group


def make_static_window_groups(centers, halfwidths, nu_start, nu_step,
                              n_bins):
    """Host-side static component groups: a tuple of
    (component_index_tuple, bin_lo, bin_hi) covering every component once.

    centers/halfwidths are numpy (ncomp,) estimates from params0 (halfwidth =
    truncation window plus a wander margin).  Grouping is cost-aware: in
    sorted-centre order a component joins the current group only if that
    costs fewer (component x bin) evaluations than opening a new one, with
    `_NEW_GROUP_COST_BINS` charged per new group.  Identical to the
    reference's ops/lorentzian.py make_static_window_groups at its defaults."""
    centers = np.asarray(centers, dtype=np.float64)
    halfwidths = np.asarray(halfwidths, dtype=np.float64)
    order = np.argsort(centers)

    def _bins(lo_f, hi_f):
        lo = int(np.clip(np.floor((lo_f - nu_start) / nu_step), 0, n_bins))
        hi = int(np.clip(np.ceil((hi_f - nu_start) / nu_step) + 1, 0, n_bins))
        return lo, max(hi, lo)

    groups = []
    cur, cur_lo, cur_hi = [], 0.0, 0.0
    for i in order:
        c, hw = float(centers[i]), float(halfwidths[i])
        lo_f, hi_f = c - hw, c + hw
        if not cur:
            cur, cur_lo, cur_hi = [int(i)], lo_f, hi_f
            continue
        u_lo, u_hi = min(cur_lo, lo_f), max(cur_hi, hi_f)
        n = len(cur)
        cost_extend = (n + 1) * (u_hi - u_lo) / nu_step
        cost_split = (n * (cur_hi - cur_lo) + (hi_f - lo_f)) / nu_step \
            + _NEW_GROUP_COST_BINS
        if cost_extend <= cost_split and n < _GROUP_MAX:
            cur.append(int(i))
            cur_lo, cur_hi = u_lo, u_hi
        else:
            groups.append((tuple(cur),) + _bins(cur_lo, cur_hi))
            cur, cur_lo, cur_hi = [int(i)], lo_f, hi_f
    if cur:
        groups.append((tuple(cur),) + _bins(cur_lo, cur_hi))
    return tuple(groups)


def partition_window_groups(groups):
    """Resolve (possibly overlapping) window groups into DISJOINT sorted
    segments with the same per-bin semantics and comp-bin cost.

    The union of group ranges is cut at every group boundary; each interval
    carries the union of the components of every group covering it, and
    adjacent intervals with identical component sets are re-merged.  Each
    component is evaluated on its own group's range, no more, no less.
    Empty groups (off-grid components) are dropped."""
    live = [(tuple(idx), lo, hi) for idx, lo, hi in groups if hi > lo]
    if not live:
        return ()
    cuts = sorted({b for _, lo, hi in live for b in (lo, hi)})
    segs = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        comps = tuple(sorted({i for idx, glo, ghi in live
                              if glo < hi and ghi > lo for i in idx}))
        if not comps:
            continue
        if segs and segs[-1][0] == comps and segs[-1][2] == lo:
            segs[-1] = (comps, segs[-1][1], hi)
        else:
            segs.append((comps, lo, hi))
    return tuple(segs)


# ---------------------------------------------------------------------------
# routed entry points (CUDA -> kernels, CPU -> plain)
# ---------------------------------------------------------------------------

def _kernel_sum(nu, H, C, W, B, win, plan):
    """Flatten leading dims to the kernel's (Bt, NC) and back; `win` is
    None unless the plan is windowed."""
    lead, nc = H.shape[:-1], H.shape[-1]

    def flat(a):
        return a.expand(lead + (nc,)).reshape(-1, nc).contiguous()

    out = _kernel.windowed_lorentzian_sum(
        nu.contiguous(), flat(H), flat(C), flat(W), flat(B),
        None if win is None else flat(win), plan)
    return out.reshape(lead + (nu.shape[0],))


def sum_lorentzians(nu, H, C, W, B, precision="f32"):
    """Dense Lorentzian sum: nu (N,), params (..., NC) -> (..., N), the
    profile stream in `precision` ("f32" | "bf16")."""
    if _on_cuda(nu, H):
        return _kernel_sum(nu, H, C, W, B, None, _kernel.dense_plan(
            nu.shape[0], H.shape[-1], precision=precision))
    return sum_lorentzians_plain(nu, H, C, W, B, precision)


def sum_lorentzians_trunc_batched(nu, H, C, W, B, win):
    """Batched windowed Lorentzian sum: params (Bt, NC), nu (N,) -> (Bt, N).

    The public name of the reference's Pallas entry
    (ops/pallas_lorentzian.py).  CUDA tensors launch the kernels, which
    skip tiles as the Pallas pair does: a block visits a component only if
    its window meets the block's bins (lorentzian_kernel.window_visits, an
    exact rule), and masks each bin inside a visited one; CPU tensors take
    the plain `sum_lorentzians_trunc` with identical semantics.  One
    difference: a NaN or infinite centre, or a NaN grid bin, gives the
    plain version a NaN gradient (0 x NaN in a masked bin), while the
    kernels visit no tile for such a component (as the Pallas pair, whose
    tile bounds skip it) and give it a gradient of 0."""
    if _on_cuda(nu, H):
        return _kernel_sum(nu, H, C, W, B, win, _kernel.dense_plan(
            nu.shape[0], H.shape[-1], windowed=True))
    return sum_lorentzians_trunc(nu, H, C, W, B, win)


def _segment_pieces_from_full(full, segments):
    """Split a full (..., N) segment sum into the segments' pieces with ONE
    split, whose backward is a single concatenation (per-piece slicing
    would allocate a full-size zero gradient per piece)."""
    n = full.shape[-1]
    bounds = sorted({0, n} | {b for _, lo, hi in segments for b in (lo, hi)})
    chunks = torch.split(full, [b - a for a, b in zip(bounds[:-1], bounds[1:])],
                         dim=-1)
    at = {lo: c for lo, c in zip(bounds[:-1], chunks)}
    return [(lo, hi, at[lo]) for _, lo, hi in segments if hi > lo]


def _kernel_segments_full(nu, H, C, W, B, segments, plan, precision):
    if plan is None:
        plan = _kernel.segment_plan(segments, H.shape[-1], nu.shape[0],
                                    precision=precision)
    elif plan.precision != precision:
        raise ValueError(f"the plan is for precision {plan.precision!r}, "
                         f"the call asks for {precision!r}")
    return _kernel_sum(nu, H, C, W, B, None, plan)


def segment_values_plain(nu, H, C, W, B, segments, precision="f32"):
    out = []
    for idx, lo, hi in segments:
        if hi <= lo:
            continue
        ii = torch.as_tensor(idx, device=H.device)
        out.append((lo, hi, sum_lorentzians_plain(
            nu[lo:hi], H[..., ii], C[..., ii], W[..., ii], B[..., ii],
            precision)))
    return out


def segment_values(nu, H, C, W, B, segments, plan=None, precision="f32"):
    """Each disjoint segment's mode sum: [(lo, hi, values (..., hi - lo))].

    `segments` is partition_window_groups output; `plan` its
    lorentzian_kernel.segment_plan (built from `segments` if None), whose
    precision must be `precision`.  The pieces feed
    likelihood_chi22p_pieces."""
    if _on_cuda(nu, H):
        full = _kernel_segments_full(nu, H, C, W, B, segments, plan,
                                     precision)
        return _segment_pieces_from_full(full, segments)
    return segment_values_plain(nu, H, C, W, B, segments, precision)


def sum_lorentzians_segments_plain(nu, H, C, W, B, segments,
                                   precision="f32"):
    N = nu.shape[0]
    lead = H.shape[:-1]
    pieces, pos = [], 0
    for lo, hi, seg in segment_values_plain(nu, H, C, W, B, segments,
                                            precision):
        if lo > pos:
            pieces.append(nu.new_zeros(lead + (lo - pos,)))
        pieces.append(seg)
        pos = hi
    if pos < N:
        pieces.append(nu.new_zeros(lead + (N - pos,)))
    return torch.cat(pieces, dim=-1)


def sum_lorentzians_segments(nu, H, C, W, B, segments, plan=None,
                             precision="f32"):
    """Windowed accumulation over DISJOINT sorted segments -> (..., N),
    zero outside every segment."""
    if _on_cuda(nu, H):
        return _kernel_segments_full(nu, H, C, W, B, segments, plan,
                                     precision)
    return sum_lorentzians_segments_plain(nu, H, C, W, B, segments,
                                          precision)


# ---------------------------------------------------------------------------
# the fused likelihood: Lorentzian sum + background -> chi22p logL
# ---------------------------------------------------------------------------

def _background_sum(spec, bg_n, bg_b):
    """bg_n + bg_b, the background the model adds to the modes (either may
    be None)."""
    if bg_n is None and bg_b is None:
        return spec.new_zeros(spec.shape[-1])
    if bg_n is None or bg_b is None:
        return bg_b if bg_n is None else bg_n
    return bg_n + bg_b


def lorentzian_chi22p_plain(nu, spec, H, C, W, B, plan, bg_n=None,
                            bg_b=None, precision="f32"):
    """The unfused chain: the mode sum in pieces (a segment plan) or over
    the grid (a dense one) plus bg_n + bg_b, through the chi22p
    likelihood."""
    bg = _background_sum(spec, bg_n, bg_b)
    if plan.segments is not None:
        pieces = segment_values_plain(nu, H, C, W, B, plan.segments,
                                      precision)
        return likelihood_chi22p_pieces(spec, pieces,
                                        lambda lo, hi: bg[..., lo:hi])
    return likelihood_chi22p(
        spec, sum_lorentzians_plain(nu, H, C, W, B, precision) + bg)


def _rows(t, lead, n):
    """(R, N) contiguous rows of `t` (..., N), which broadcasts against the
    walkers' dims `lead`: R is the product of the leading dims that t
    carries (a star axis), each row serving the walkers below it; a general
    broadcast gets one row per walker."""
    shape = (1,) * (len(lead) - (t.ndim - 1)) + tuple(t.shape[:-1])
    k = len(shape)
    while k and shape[k - 1] == 1:
        k -= 1
    if shape[:k] != tuple(lead[:k]):
        k = len(lead)
    rows = math.prod(lead[:k])
    full = tuple(lead[:k]) + (1,) * (len(lead) - k) + (n,)
    return t.reshape(shape + (n,)).expand(full).reshape(rows, n).contiguous()


def _kernel_chi22p(nu, spec, H, C, W, B, plan, bg_n, bg_b):
    """Flatten leading dims to the kernel's (Bt, NC), the spectrum and the
    shared background to rows, the per-walker background to (Bt,) or
    (Bt, N); logL back to the leading dims."""
    lead, nc = tuple(H.shape[:-1]), H.shape[-1]
    n = nu.shape[0]
    bt = math.prod(lead)

    def flat(a):
        return a.expand(lead + (nc,)).reshape(-1, nc).contiguous()

    # the spectrum and the shared background in rows of one shape
    shared = tuple(spec.shape[:-1]) if bg_n is None else \
        torch.broadcast_shapes(spec.shape[:-1], bg_n.shape[:-1])
    spec_rows = _rows(spec.expand(shared + (n,)), lead, n)
    bgn_rows = (None if bg_n is None
                else _rows(bg_n.expand(shared + (n,)), lead, n))
    if bg_b is not None:
        width = bg_b.shape[-1]
        bg_b = bg_b.expand(lead + (width,)).reshape(
            (bt,) if width == 1 else (bt, width)).contiguous()
    logL = _kernel.lorentzian_chi22p_kernel(
        nu.contiguous(), spec_rows, flat(H), flat(C), flat(W), flat(B),
        bgn_rows, bg_b, plan)
    return logL.reshape(lead)


def lorentzian_chi22p(nu, spec, H, C, W, B, plan, bg_n=None, bg_b=None,
                      precision="f32"):
    """chi^2(2 dof) log-likelihood of the Lorentzian sum plus background,
    -sum_n [ln max(M, 1e-12) + S / M] with M = modes + (bg_n + bg_b):
    nu (N,), params (..., NC) -> logL (...).

    plan: the model's segment_plan, or dense_plan for a dense model, in
    `precision`.  spec (N,) or a row per star ((S, 1, ..., N) against
    (S, T, C, NC) walkers).  bg_n: the background no walker changes (the
    all-fixed Harvey terms), (N,) or a row per star, or None; bg_b: the
    per-walker part, (..., 1) (a free white level) or (..., N) (a free
    Harvey term), or None.  Quiet bins outside every segment hold the
    background alone.  CUDA tensors launch the forward kernel with its
    chi22p epilogue (the model never reaches device memory) and the
    backward kernel on its saved gradient; CPU tensors take
    `lorentzian_chi22p_plain`."""
    if plan.windowed or plan.precision != precision:
        raise ValueError(f"the fused likelihood takes a segment or dense "
                         f"plan in {precision!r}; got a "
                         f"{'windowed' if plan.windowed else plan.precision}"
                         " plan")
    if _on_cuda(nu, H):
        return _kernel_chi22p(nu, spec, H, C, W, B, plan, bg_n, bg_b)
    return lorentzian_chi22p_plain(nu, spec, H, C, W, B, plan, bg_n, bg_b,
                                   precision)
