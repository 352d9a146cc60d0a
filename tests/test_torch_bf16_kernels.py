"""What the bf16 Lorentzian kernels (csrc/lorentzian.cu, BF16) rest on,
checked on the CPU.

The reciprocal: the kernels round the hardware estimate of 1 / y to bf16
with no Newton step.  That equals the plain version's division because the
exact 1/y of every bf16 y >= 1 lies at least 2^-16 (relative) from every
bf16 rounding midpoint, and because torch's bf16 division is the correctly
rounded one; the card checks the kernel itself over the same values
(`lorentzian_kernel.rcp_bf16_mismatches`, chip_smoke.py phase 2).

The traversal: the host-side maps of which bins (backward) and component
pairs (forward) go into which mma fragment slots, and the fragment layout
of mma.sync m16n8k16 with the kernels' three B operands, simulated in
numpy.
The kernels' replay against the plain bf16 version is in
tests/test_torch_lorentzian.py.
"""

import math
import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from tamcmc_tpu_torch.ops import lorentzian_kernel as tk

torch.set_num_threads(1)

ONE_BITS = 0x3F80          # bf16 1.0
CLAMP_BITS = 0x7E00        # bf16 2^125, the reciprocal's clamp
SOURCE = (pathlib.Path(tk.__file__).resolve().parents[1] / "csrc"
          / "lorentzian.cu")


def _bf16_fraction(bits: int) -> Fraction:
    """The exact value of the positive normal bf16 with these bits."""
    exp, man = (bits >> 7) & 0xFF, bits & 0x7F
    return Fraction(128 + man, 128) * Fraction(2) ** (exp - 127)


def _midpoint_distance(r: Fraction) -> Fraction:
    """Relative distance of r > 0 from the nearest bf16 rounding midpoint
    (the odd multiples of half a bf16 ulp of r's binade)."""
    e = math.floor(math.log2(r))
    while Fraction(2) ** e > r:
        e -= 1
    while Fraction(2) ** (e + 1) <= r:
        e += 1
    half_ulp = Fraction(2) ** (e - 8)
    k = math.floor(r / half_ulp)
    odd = k if k % 2 else k + 1
    return min(abs(r - j * half_ulp) for j in (odd - 2, odd, odd + 2)) / r


def _round_bf16(v: np.ndarray) -> np.ndarray:
    """Round float64 values (normal in bf16) to bf16, to nearest even."""
    m, e = np.frexp(v)
    return np.ldexp(np.rint(m * 256.0) / 256.0, e)


def test_every_bf16_reciprocal_is_far_from_a_midpoint():
    """1/y for every bf16 y in [1, 2^125] lies >= 2^-16 (relative) from
    every bf16 midpoint: an estimate within a few 2^-23 rounds the same."""
    worst = min(_midpoint_distance(1 / _bf16_fraction(b))
                for b in range(ONE_BITS, CLAMP_BITS + 1))
    assert worst == Fraction(1, 2 ** 16)       # reached at y = 255/128


def test_torch_bf16_division_is_the_correctly_rounded_reciprocal():
    bits = torch.arange(ONE_BITS, CLAMP_BITS + 1, dtype=torch.int16)
    y = bits.view(torch.bfloat16)
    got = (1.0 / y).double().numpy()
    want = _round_bf16(1.0 / y.double().numpy())
    assert np.array_equal(got, want)


def test_bf16_reciprocal_on_the_cpu_is_the_plain_division():
    y = torch.arange(ONE_BITS, CLAMP_BITS + 1,
                     dtype=torch.int16).view(torch.bfloat16)
    assert torch.equal(tk.bf16_reciprocal(y).view(torch.int16),
                       (1.0 / y).view(torch.int16))
    assert tk.rcp_bf16_mismatches("cpu") == (0, CLAMP_BITS - ONE_BITS + 1)
    with pytest.raises(ValueError, match="bfloat16"):
        tk.bf16_reciprocal(torch.ones(4))


def test_source_constants_are_the_ones_checked_here():
    """The kernel's clamp and ones are the bf16 pairs these tests use."""
    text = SOURCE.read_text()
    clamp = int(re.search(r"#define RCP_MAX_BF16X2 (0x[0-9a-f]+)u", text)[1],
                16)
    one = int(re.search(r"#define BF16X2_ONE (0x[0-9a-f]+)u", text)[1], 16)
    assert clamp == CLAMP_BITS * 0x10001
    assert _bf16_fraction(CLAMP_BITS) == 2 ** 125
    assert one == ONE_BITS * 0x10001 == tk.BF16X2_ONE
    assert int(re.search(r"#define FWD_CH (\d+)", text)[1]) == tk.FWD_CH


# ---------------------------------------------------------------------------
# the host-side maps of the traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,end", [
    (0, 4096), (1, 4095), (3, 5), (5, 7), (4, 6), (1, 2), (2, 3), (0, 1),
    (7, 300), (0, 129), (13, 13 + 128 * 3 + 2), (6, 8), (1, 512)])
def test_backward_steps_put_each_bin_in_one_slot(start, end):
    """Each bin of [start, end) sits in exactly one (step, lane, pair,
    half) slot; a lone bin (the unaligned head or tail) rides in lanes
    0-5 of the first step with its partner slot empty (g = 0)."""
    steps = tk.bwd_bf16_steps(start, end)
    assert all(len(step) == 32 and all(len(lane) == 4 for lane in step)
               for step in steps)
    slots = [b for step in steps for lane in step for b in lane
             if b is not None]
    assert sorted(slots) == list(range(start, end))
    lone = [lane[0] for step in steps for lane in step
            if lane[0] is not None and lane[1] is None]
    aligned = range((start + 3) & ~3, end & ~3)
    assert sorted(lone) == [n for n in range(start, end) if n not in aligned]
    assert all(lane[1:] == (None,) * 3 for lane in steps[0][6:]) or not lone
    for step in steps[1 if lone else 0:]:           # float4 groups
        for lane in step:
            assert lane == (None,) * 4 or (
                lane[0] % 4 == 0 and lane == tuple(range(lane[0],
                                                         lane[0] + 4)))


def _pairs_case(kind):
    if kind == "segment":
        rng = np.random.default_rng(3)
        lo = rng.integers(0, 900, 150)
        return tk.LorentzPlan(lo, lo + rng.integers(1, 300, 150), 1200,
                              tile=64, precision="bf16")
    nc = int(kind.split()[1])
    return tk.dense_plan(256, nc, precision="bf16")


@pytest.mark.parametrize("kind", ["segment", "dense 1", "dense 2",
                                  "dense 63", "dense 64", "dense 65",
                                  "dense 131"])
def test_forward_pairs_put_each_component_in_one_slot(kind):
    """Per tile, each listed component sits in exactly one (pair, half)
    slot; a chunk of odd length ends with one lone component; a pair runs
    masked exactly when it holds a component that does not cover the
    tile."""
    plan = _pairs_case(kind)
    odd_chunks = 0
    for t in range(plan.n_tiles):
        p0, p1 = plan.tile_ptr[t], plan.tile_ptr[t + 1]
        listed = plan.tile_comp[p0:p1].tolist()
        full = set(plan.tile_comp[p0:plan.tile_full[t]].tolist())
        pairs = tk.fwd_bf16_pairs(plan, t)
        slots = [k for k0, k1, _ in pairs for k in (k0, k1) if k >= 0]
        assert sorted(slots) == sorted(listed)
        lone = sum(k1 < 0 for _, k1, _ in pairs)
        chunks = [min(tk.FWD_CH, p1 - b) for b in range(p0, p1, tk.FWD_CH)]
        assert lone == sum(c % 2 for c in chunks)
        odd_chunks += lone
        for k0, k1, masked in pairs:
            assert masked == any(k >= 0 and k not in full for k in (k0, k1))
    if kind in ("dense 1", "dense 65", "dense 131"):
        assert odd_chunks > 0


# ---------------------------------------------------------------------------
# mma.sync m16n8k16 with the kernels' B operands, simulated
# ---------------------------------------------------------------------------

def _mma(a, b, c):
    """D = A B + C of one warp's mma.sync.m16n8k16.row.col (bf16 A and B,
    float32 C and D) from per-lane fragments, by the PTX ISA's layouts:
    a[lane, r, h] is register a_r's half h (r = 0: row g, k 2t + h; 1: row
    g + 8, k 2t + h; 2: row g, k 2t + 8 + h; 3: row g + 8, k 2t + 8 + h),
    b[lane, r, h] holds B[2t + 8 r + h][g], c[lane, i] the accumulators
    (row g + 8 (i >= 2), column 2t + i % 2); g = lane / 4, t = lane % 4."""
    A, Bm, Cm = np.zeros((16, 16)), np.zeros((16, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(4):
            for h in range(2):
                A[g + 8 * (r % 2), 2 * t + 8 * (r // 2) + h] = a[lane, r, h]
        for r in range(2):
            for h in range(2):
                Bm[2 * t + 8 * r + h, g] = b[lane, r, h]
        for i in range(4):
            Cm[g + 8 * (i // 2), 2 * t + i % 2] = c[lane, i]
    D = A @ Bm + Cm
    return np.array([[D[lane // 4 + 8 * (i // 2), 2 * (lane % 4) + i % 2]
                      for i in range(4)] for lane in range(32)])


def _b_halves(lane_b):
    """Per-lane (b0, b1) bf16 pairs of ones and zeros as (2, 2) floats."""
    return [[float((x >> (16 * h)) & 0xFFFF == tk.BF16X2_ONE & 0xFFFF)
             for h in range(2)] for x in lane_b]


def test_diagonal_operand_adds_each_lanes_pairs_into_its_own_sums():
    """mma_pairs_bf16: A = (e0, e2, e1, e3) and diag_ones' B make
    acc[i] += lo(e_i) + hi(e_i) in every lane, no value leaving its lane."""
    rng = np.random.default_rng(0)
    e = rng.integers(-64, 64, (32, 4, 2)).astype(float)
    c = rng.integers(-64, 64, (32, 4)).astype(float)
    b = np.array([_b_halves(tk.diag_ones(lane)) for lane in range(32)])
    d = _mma(e[:, [0, 2, 1, 3]], b, c)
    assert np.array_equal(d, c + e.sum(-1))


def test_identity_operand_adds_each_value_into_its_own_sum():
    """The lone component: A = (e01, e23, 0, 0) and ident_ones' B make
    acc[0..3] += the four values of the lane's two bin pairs, in order."""
    rng = np.random.default_rng(2)
    e = rng.integers(-64, 64, (32, 2, 2)).astype(float)
    c = rng.integers(-64, 64, (32, 4)).astype(float)
    a = np.concatenate([e, rng.integers(-64, 64, (32, 2, 2))], axis=1)
    b = np.array([_b_halves(tk.ident_ones(lane)) for lane in range(32)])
    d = _mma(a, b, c)
    assert np.array_equal(d, c + e.reshape(32, 4))


def test_ones_operand_adds_a_quads_rows():
    """mma_rows_bf16: with B all ones, accumulators 0 and 1 of each lane
    gain the sum of a0 and a2 over its quad's four lanes, 2 and 3 that of
    a1 and a3."""
    rng = np.random.default_rng(1)
    a = rng.integers(-64, 64, (32, 4, 2)).astype(float)
    c = np.repeat(rng.integers(-64, 64, (32, 2)).astype(float), 2, axis=1)
    d = _mma(a, np.ones((32, 2, 2)), c)
    quad = a.reshape(8, 4, 4, 2).sum(axis=(1, 3))     # (quad, register)
    for lane in range(32):
        rows = quad[lane // 4]
        assert d[lane, 0] == d[lane, 1] == c[lane, 0] + rows[0] + rows[2]
        assert d[lane, 2] == d[lane, 3] == c[lane, 2] + rows[1] + rows[3]
