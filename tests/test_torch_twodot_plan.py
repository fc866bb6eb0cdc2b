"""Kernel U's and kernel R's plans, and kernel U's lane order, on the CPU.

Kernel U (quant_matmul.twodot_launch) runs the parent's lane chains for C
columns a warp pair in a CTA of 8 pairs, fed by a ring of D slots of S
tiles; kernel R (probes.stream_launch) streams its blocks through a ring of
slots of whole rows where its grid leaves SMs to spare. Neither plan moves a
bit (the card tests hold every plan equal), so what the plans must get right is the card: shared memory a
CTA may hold, CTAs that share an SM where the plan counts on it, and enough
CTAs or slots. testing.twodot_lane_order is the card test's reference for
U's bits: here it is held to the plain version's tolerance, and its f32 FMA
to exact rational arithmetic.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from blama_tpu_torch import testing
from blama_tpu_torch.ops import probes
from blama_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

# the 8B projections (K, N) chip_smoke.py times kernel U at
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 14336),
          "down": (14336, 4096), "lm_head": (4096, 128256)}


def _round_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest f32, ties to even."""
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    return near[0] if len(near) == 1 else next(c for c in near if not c.view(np.int32) & 1)


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    c = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    # a double-rounding case: a*b + c just below the midpoint of 1 + 2^-23
    # and 1 + 2^-22, so that the f64 sum lands on it and ties to the even one
    a[0], b[0], c[0] = np.float32((1 + 2 ** -23) * 2 ** -12), np.float32(
        (1 - 2 ** -23) * 2 ** -12), np.float32(1 + 2 ** -23)
    a[1], b[1], c[1] = -a[0], b[0], -c[0]
    got = testing.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert got[0].item() == np.float32(1 + 2 ** -23)
    assert np.array_equal(got.numpy(), np.array(want, dtype=np.float32))
    inf, nan = float("inf"), float("nan")
    edge = testing.fma_f32(torch.tensor([inf, 3e38, 1.0, nan]), torch.tensor([2.0, 2.0, 1.0, 1.0]),
                           torch.tensor([1.0, 0.0, -inf, 1.0]))
    assert edge[:3].tolist() == [inf, inf, -inf] and edge[3].isnan()


@pytest.mark.parametrize("m,n,tiles,kb", [(1, 8, 4, 1), (3, 5, 8, 4), (16, 3, 16, 8)])
def test_lane_order_is_the_two_dot(m, n, tiles, kb):
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    g = torch.Generator().manual_seed(m + n)
    k = tiles * 256
    codes = torch.randint(0, 16, (n, k), generator=g, dtype=torch.uint8)
    scales = torch.rand((n, k // 32), generator=g) * 0.02 + 0.01
    x = torch.randn((m, k), generator=g)
    got = testing.twodot_lane_order(x, pack_pairs(codes), scales, kb)
    ref = qm.twodot_pos_plain(x, pack_pairs(codes), scales, kb)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_twodot_plan_at_the_8b_shapes():
    """Four columns a warp pair where those CTAs fill a wave, one at wk/wv's
    1024 columns; slots of the most tiles (up to 4) that divide kb."""
    for label, (K, N) in SHAPES.items():
        for M in range(1, 17):
            for kb in range(1, 9):
                c, s, d = qm.twodot_plan(M, N, kb)
                assert c == (1 if label == "wk/wv" else 4), (label, M)
                assert s == (4 if kb % 4 == 0 else 2 if kb % 2 == 0 else 1)
                assert -(-N // (qm.U_PAIRS * c)) >= qm.U_MIN_CTAS


@pytest.mark.parametrize("M", range(1, 17))
def test_twodot_plan_fits_the_card(M):
    mt = next(t for t in (1, 2, 4, 8, 16) if M <= t)
    per_sm = 2 if mt <= 2 else 1
    for N in list(range(1, 300, 7)) + [1024, 4096, 14336, 128256]:
        for kb in range(1, 9):
            plan = qm.twodot_plan(M, N, kb)
            c, s, d = plan
            assert c in (1, 4) and kb % s == 0
            assert 2 <= d <= qm.U_MAX_SLOTS
            smem = qm.twodot_smem(M, plan)
            assert smem <= qm.SMEM_MAX
            assert per_sm * (smem + 1024) <= qm.SMEM_SM
            # the ring is at its cap, or one more slot would not fit
            more = smem + qm.twodot_slot_bytes(mt, c, s)
            assert (d == qm.U_MAX_SLOTS or more > qm.SMEM_MAX
                    or per_sm * (more + 1024) > qm.SMEM_SM)


def test_twodot_slot_bytes():
    # x's rows, then codes and scales of 8 pairs of 4 columns, 2 tiles: 16 + 8 + 2 KB
    assert qm.twodot_slot_bytes(8, 4, 2) == 8 * 2 * 1024 + 32 * 2 * 128 + 32 * 2 * 32


# kernel R's blocks chip_smoke.py times (on a 2048 x 14336 layer), and the
# card tests' edges: bk below 8 and of 1, bn 16 and 16384, many pieces
STREAM = [(2048, 14336, 1024, 4096), (2048, 14336, 64, 2048), (64, 256, 16, 128),
          (100, 1024, 7, 48), (33, 160, 1, 32), (512, 64, 256, 16), (64, 16384, 8, 16384),
          (2048, 14336, 256, 14336)]


def test_stream_plan_of_the_timed_blocks():
    """Six CTAs: the TMA ring, six slots of eight 4096-byte rows; 224 CTAs
    (more than the card's SMs): every thread's cp.async, pieces of sixteen
    2048-byte rows."""
    assert probes.stream_plan(2048, 14336, 1024, 4096) == (8, 6)
    assert probes.stream_plan(2048, 14336, 64, 2048) == (16, 0)


@pytest.mark.parametrize("total", [False, True])
@pytest.mark.parametrize("r,n,bk,bn", STREAM)
def test_stream_plan_fits_the_card(r, n, bk, bn, total):
    rps, slots = probes.stream_plan(r, n, bk, bn, total)
    ctas = (r // bk) * (n // bn)
    assert (slots == 0) == (ctas > probes.N_SMS)
    if slots:
        assert 1 <= rps <= min(bk, 256) and (rps == 1 or rps * bn <= probes.R_SLOT)
        assert 1 <= slots <= min(probes.R_MAX_SLOTS, -(-bk // rps))
    else:
        assert rps * bn <= probes.R_PIECE
    assert probes.stream_smem(bn, rps, slots, total) <= probes.SMEM_MAX
