"""Kernels Q's and V's plan, and their lane order, on the CPU.

Kernels Q and V (quant_matmul.a8s_launch, plane_launch; ops/csrc/slab_gemv.cu)
rebuild, in each lane, the sum order of the one-warp-per-column kernel they
replaced: lane l of a column took groups l and l+32 of a slab, part =
fmaf(dot * ws, xs, part), then slab_sum<HB>'s xor butterfly (Q: bits 0, 1,
3, 4, then lo + hi; V: all five bits), the slabs in K order.
testing.slab_lane_order is that order, and the card tests hold both kernels
to it bit for bit. Here it is held to an exact rational evaluation of the
same tree (each operation rounded once to f32) and to the plain versions'
tolerance; and slab_plan is held to the card: shared memory a CTA may hold,
and every column owned by exactly one warp of one CTA.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from blama_tpu_torch import testing
from blama_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

MATMUL_TOL = 1e-4
N_SMS = 132

# the 8B projections chip_smoke.py times Q and V at, and the tools' other
# widths (autotune_a8s's fused q/k/v, gate/up and padded head)
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 14336),
          "down": (14336, 4096), "lm_head": (4096, 128256)}
TOOL_SHAPES = {"wqkv": (4096, 6144), "wgu": (4096, 28672), "head": (4096, 129024)}


def _round_f32(v: Fraction) -> Fraction:
    """v rounded to the nearest f32, ties to even, as a Fraction."""
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    pick = near[0] if len(near) == 1 else next(c for c in near if not c.view(np.int32) & 1)
    return Fraction(float(pick))


def _exact_tree(xq, xs, codes, scales, kb, hb) -> np.ndarray:
    """The slab lane order written out as a tree of exact rational
    operations, each rounded once to f32: lane l's part = fma(dot · ws, xs,
    0) then fma(dot' · ws', xs', part); the butterfly's levels as a
    recursive split over the lane bits, the last bit first; the slabs
    added in K order."""
    M, K = xq.shape
    N, G, sg = codes.shape[0], K // 32, 8 * kb
    xqn, cn = xq.numpy().astype(np.int64), codes.numpy().astype(np.int64)
    xsn, wsn = xs.numpy(), scales.float().numpy()
    bits = [b for b in (1, 2, 4, 8, 16) if b != hb]

    def tree(parts, lanes, bs):
        if not bs:
            return parts[lanes[0]]
        b = bs[-1]
        lo = tree(parts, [l for l in lanes if not l & b], bs[:-1])
        hi = tree(parts, [l for l in lanes if l & b], bs[:-1])
        return _round_f32(lo + hi)

    out = np.zeros((M, N), dtype=np.float32)
    for m in range(M):
        for n in range(N):
            run = None
            for s0 in range(0, G, sg):
                parts = []
                for lane in range(32):
                    part = Fraction(0)
                    for j in (s0 + lane, s0 + lane + 32):
                        if j < s0 + sg:
                            dot = int(xqn[m, 32 * j:32 * j + 32] @ cn[n, 32 * j:32 * j + 32])
                            t = _round_f32(Fraction(dot) * Fraction(float(wsn[n, j])))
                            part = _round_f32(t * Fraction(float(xsn[m, j])) + part)
                    parts.append(part)
                if hb:
                    acc = _round_f32(tree(parts, [l for l in range(32) if not l & hb], bits)
                                     + tree(parts, [l for l in range(32) if l & hb], bits))
                else:
                    acc = tree(parts, list(range(32)), bits)
                run = acc if run is None else _round_f32(run + acc)
            out[m, n] = float(run)
    return out


def _operands(m, n, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    codes = torch.randint(0, 16, (n, k), generator=g, dtype=torch.uint8)
    sc = torch.rand((n, k // 32), generator=g) * 0.02 + 0.01
    sc = torch.where(torch.rand(sc.shape, generator=g) < 0.3, -sc, sc)
    return x, codes, sc


@pytest.mark.parametrize("hb", [4, 0])
@pytest.mark.parametrize("m,n,k,kb", [(1, 2, 256, 1), (2, 2, 1024, 2), (1, 1, 2048, 4),
                                      (2, 1, 2048, 8), (1, 2, 3072, 3), (1, 1, 1536, 6)])
def test_lane_order_is_its_tree(m, n, k, kb, hb):
    x, codes, sc = _operands(m, n, k, 11 * m + n + kb)
    xq, xs, _ = qm.quant_acts(x)
    sb = sc.to(torch.bfloat16)
    got = testing.slab_lane_order(xq, xs, codes, sb, kb, hb)
    assert np.array_equal(got.numpy(), _exact_tree(xq, xs, codes, sb, kb, hb))


def test_lane_order_tells_the_trees_apart():
    """Lane parts 2^24 (lane 0), -2^24 (lane 4), 1 (lanes 8 and 12): Q's
    tree adds 0 and 8 first (2^24 + 1 ties to 2^24), then lo + hi = 1; V's
    adds 0 and 4 first, and gives 2. So swapping HB, or taking lo + hi
    before the other levels, moves the result."""
    K = 1024
    xq = torch.zeros((1, K), dtype=torch.int8)
    xq[0, ::32] = 1                                  # the first element of every group
    codes = torch.zeros((1, K), dtype=torch.uint8)
    scales = torch.zeros((1, K // 32))
    for g, s in ((0, 2.0 ** 24), (4, -2.0 ** 24), (8, 1.0), (12, 1.0)):
        codes[0, 32 * g], scales[0, g] = 1, s
    xs = torch.ones((1, K // 32))
    sb = scales.to(torch.bfloat16)
    q = testing.slab_lane_order(xq, xs, codes, sb, 4, 4)
    v = testing.slab_lane_order(xq, xs, codes, sb, 4, 0)
    assert q.item() == 1.0 and v.item() == 2.0
    assert q.item() == _exact_tree(xq, xs, codes, sb, 4, 4)[0, 0]
    assert v.item() == _exact_tree(xq, xs, codes, sb, 4, 0)[0, 0]


def test_lane_order_fuses_the_second_term():
    """A lane with two groups (kb > 4) takes the second by one fma: the
    unfused order (two roundings) differs on random inputs, and the fused
    one is the tree's."""
    x, codes, sc = _operands(4, 8, 4096, 3)
    xq, xs, _ = qm.quant_acts(x)
    sb = sc.to(torch.bfloat16)
    fused = testing.slab_lane_order(xq, xs, codes, sb, 8, 4)
    assert not torch.equal(fused, testing.slab_lane_order(xq, xs, codes, sb, 8, 4, fused=False))
    assert np.array_equal(fused[:1, :2].numpy(),
                          _exact_tree(xq[:1], xs[:1], codes[:2], sb[:2], 8, 4))


@pytest.mark.parametrize("kb", range(1, 9))
@pytest.mark.parametrize("m", range(1, 17))
def test_lane_order_is_the_plain_version(m, kb):
    """Within the matmul tolerance of a8s_pos_plain (hb 4) and
    plane_pos_plain (hb 0), which sum the same terms in another order."""
    k = 2 * kb * 256
    x, codes, sc = _operands(m, 6, k, m + 17 * kb)
    xq, xs, _ = qm.quant_acts(x)
    w = qm.pack_a8s(codes, sc.abs(), torch.zeros_like(sc))
    q = testing.slab_lane_order(xq, xs, codes, w.scales, kb, 4)
    ref = qm.a8s_pos_plain(x, w, kb)
    assert (q - ref).abs().max() <= MATMUL_TOL * ref.abs().max()
    v = testing.slab_lane_order(xq, xs, codes, w.scales, kb, 0)
    ref = qm.plane_pos_plain(x, codes.to(torch.int8), w.scales, kb)
    assert (v - ref).abs().max() <= MATMUL_TOL * ref.abs().max()


def test_slab_plan_at_the_8b_shapes():
    """Seven tiles a CTA at gate/up (128 column groups of 112), eight at the
    lm head (1002 groups walked by a wave), one warp a tile; two tiles of
    four warps at wq/wo and down, one tile of eight warps at wk/wv; the
    ring SG_INFLIGHT bytes deep, 4 slots at least and a round of the tile's
    warps (two slots each)."""
    want = {"wq/wo": (2, 4), "wk/wv": (1, 8), "gate/up": (7, 1), "down": (2, 4),
            "lm_head": (8, 1)}
    for label, (K, N) in SHAPES.items():
        for M in range(1, 17):
            for int8 in (False, True):
                t, r, d = qm.slab_plan(M, N, 4, int8, K)
                assert (t, r) == want[label], (label, M)
                slot = qm.slab_slot_bytes(M, 16 * t, int8)
                assert d == max(2 * r, 4, -(-qm.SG_INFLIGHT // slot))
                # no deeper than its floor or the bytes it aims for
                assert d == max(2 * r, 4) or (d - 1) * slot < qm.SG_INFLIGHT


@pytest.mark.parametrize("M", range(1, 17))
def test_slab_plan_fits_the_card(M):
    widths = (list(range(1, 300, 7)) + [1000, 1024, 4096, 14336, 128256]
              + [n for _, n in TOOL_SHAPES.values()])
    for N in widths:
        for kb, K in ((kb, K) for kb in range(1, 9) for K in (2048, 4096, 14336)):
            for int8 in (False, True):
                plan = qm.slab_plan(M, N, kb, int8, K)
                t, r, d = plan
                assert r == qm.SG_MAX_WARPS // t and 2 <= d <= qm.SG_MAX_SLOTS
                assert qm.slab_smem(M, plan, int8, K) <= qm.SMEM_MAX
                # the ring's slots cover a round of the tile's warps, two a step
                assert d >= 2 * r
                tiles = -(-N // 16)
                # the groups fill a wave where the tiles allow it
                assert t == 1 or -(-tiles // t) >= qm.SG_WAVE


@pytest.mark.parametrize("label", list(SHAPES) + list(TOOL_SHAPES) + ["ragged"])
def test_slab_plan_owns_every_column_once(label):
    """The kernel's walk: CTA b of min(groups, 132) takes column groups b,
    b + grid, ...; tile i of a group its 16 columns at 16i, written by the
    tile's first warp. Every column below N is written by exactly one (CTA,
    group, tile, lane)."""
    K, N = {**SHAPES, **TOOL_SHAPES, "ragged": (4096, 1000)}[label]
    for M in (1, 8, 16):
        t, _, _ = qm.slab_plan(M, N, 4)
        cols = 16 * t
        groups = -(-N // cols)
        grid = min(groups, N_SMS)
        owned = np.zeros(N, dtype=np.int64)
        for b in range(grid):
            for g in range(b, groups, grid):
                for tile in range(t):
                    c0 = g * cols + 16 * tile
                    # lane (gq, t) writes columns c0 + gq and c0 + gq + 8, at t == 0
                    for gq in range(8):
                        for c in (c0 + gq, c0 + gq + 8):
                            if c < N:
                                owned[c] += 1
        assert (owned == 1).all()


def test_slab_slot_bytes():
    # x's 8 rows (2 KB), 112 columns' codes (14 KB) and scales (1792 B),
    # x's scales (256 B): 18432 bytes, already on 1024
    assert qm.slab_slot_bytes(8, 112) == 2048 + 112 * 128 + 256 + 112 * 16
    # 16 rows and int8 codes: 4 KB + 32 KB + 512 + 2 KB = 39424, on 1024: 39936
    assert qm.slab_slot_bytes(16, 128, int8=True) == 39936
    # one row: no x in a slot (16 columns' codes and scales, 3 KB on 1024)
    assert qm.slab_slot_bytes(1, 16) == 3072
    # one tile of eight warps, one row: 16 slots, their barriers, the
    # partials' two buffers (8 warps x 2 sums x 2 outputs x 32 lanes x 4
    # bytes) and x's row quantized (4096 codes, 128 scales)
    assert (qm.slab_smem(1, (1, 8, 16), K=4096)
            == 1024 + 16 * 3072 + 256 + 2 * 8 * 2 * 2 * 32 * 4 + 4096 + 512)
    assert qm.slab_smem(8, (7, 1, 10)) == 1024 + 10 * 18432 + 160


def test_slab_plan_refuses_kb():
    for kb in (0, 9):
        with pytest.raises(ValueError):
            qm.slab_plan(1, 4096, kb)
