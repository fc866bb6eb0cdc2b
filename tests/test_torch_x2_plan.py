"""Kernel T's lane order and plan, on the CPU.

Kernel T (quant_matmul.x2_launch; ops/csrc/slab_gemv.cu) keeps the bits of
the one-warp-per-column kernel it replaced: K in steps of 8 superblocks,
lane (tl, c) of a column took superblock tl of each step of a slab and its
groups 2c, 2c+1, part += (float)dot * ws * xs - sxm * wm, then an xor
butterfly over lane bits 0, 2, 3, 4 and lo + hi, the slabs in K order.
testing.x2_lane_order is that order, and the card tests hold the kernel to
it bit for bit. Here it is held to a literal 32-lane loop of the parent
(each operation rounded once to f32, the fused forms through exact rational
arithmetic), told apart from the other forms the compiler could have given
the term, held to the plain version's and the reference's tolerance; the
kernel's walk (chains of emulated lanes, pairs of them, the slab tree) is
held to it on the CPU; and slab_plan's x2 plans are held to the card.
"""

import importlib.util
import pathlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.gguf.quants import quantize_q4_k
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu_torch import testing
from blama_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

MATMUL_TOL = 1e-4
N_SMS = 132
ROOT = pathlib.Path(__file__).resolve().parent.parent

# the 8B projections chip_smoke.py times T at, and a width that fills no tile
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 14336),
          "down": (14336, 4096), "lm_head": (4096, 128256), "ragged": (4096, 1000)}


def _round_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest f32, ties to even."""
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    return near[0] if len(near) == 1 else next(c for c in near if not c.view(np.int32) & 1)


def _term(dot, ws, wm, xs, sxm, form) -> np.float32:
    t = np.float32(np.float32(dot) * ws)
    if form == "fma_xs":
        return _round_f32(Fraction(float(t)) * Fraction(float(xs))
                          - Fraction(float(np.float32(sxm * wm))))
    if form == "fma_min":
        return _round_f32(Fraction(float(np.float32(t * xs)))
                          - Fraction(float(sxm)) * Fraction(float(wm)))
    return np.float32(np.float32(t * xs) - np.float32(sxm * wm))


def _parent_lanes(xq, xs, sxm, codes, ws, wm, kb, form) -> np.ndarray:
    """The parent kernel written out lane by lane: 32 lanes a column, each
    part += term, then slab_sum<2>'s butterfly on every lane at once."""
    M, K = xq.shape
    N, nsb = codes.shape[0], K // 256
    xqn, cn = xq.numpy().astype(np.int64), codes.numpy().astype(np.int64)
    xsn, sxn, wsn, wmn = xs.numpy(), sxm.numpy(), ws.numpy(), wm.numpy()
    out = np.zeros((M, N), np.float32)
    for m in range(M):
        for n in range(N):
            run = None
            for s0 in range(0, nsb, kb):
                part = [np.float32(0.0)] * 32
                for step in range(-(-kb // 8)):
                    for lane in range(32):
                        tl, c = lane >> 2, lane & 3
                        if 8 * step + tl >= kb:
                            continue
                        sb = s0 + 8 * step + tl
                        for g in (8 * sb + 2 * c, 8 * sb + 2 * c + 1):
                            dot = int(xqn[m, 32 * g:32 * g + 32] @ cn[n, 32 * g:32 * g + 32])
                            part[lane] = np.float32(part[lane] + _term(
                                dot, wsn[n, g], wmn[n, g], xsn[m, g], sxn[m, g], form))
                for o in (1, 4, 8, 16):
                    part = [np.float32(part[lane] + part[lane ^ o]) for lane in range(32)]
                acc = np.float32(part[0] + part[2])
                run = acc if run is None else np.float32(run + acc)
            out[m, n] = run
    return out


def _operands(m, n, k, seed):
    """x, and the decoded arrays of random Q4_K superblocks (a third of the
    d and dmin negative, so terms of both signs meet)."""
    rng = np.random.default_rng(seed)
    data = testing.random_q4k(rng, n, k, k ** -0.5).reshape(-1, 144)
    flip = rng.random(data.shape[0]) < 0.3
    data[flip, 1] ^= 0x80
    data[rng.random(data.shape[0]) < 0.3, 3] ^= 0x80
    w = qm.repack_q4k_a8k4(data.reshape(-1), n, k, "cpu")
    codes, ws, wm = qm.decode_q4k_blocks(w.codes.view(-1, 144), n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x, w, codes, ws, wm


# kb 8 and 16, and the whole K as one slab (1, 2, 3 and 12 superblocks)
LITERAL_CASES = [(1, 2, 256, 1), (2, 1, 512, 2), (1, 2, 768, 3), (2, 1, 3072, 12),
                 (1, 1, 2048, 8), (1, 1, 4096, 16), (1, 1, 4096, 8)]


@pytest.mark.parametrize("form", testing.X2_FORMS)
@pytest.mark.parametrize("m,n,k,kb", LITERAL_CASES)
def test_lane_order_is_the_parents_lanes(m, n, k, kb, form):
    x, _, codes, ws, wm = _operands(m, n, k, 7 * m + n + kb)
    xq, xs, sxm = qm.quant_acts(x)
    got = testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kb, form)
    assert np.array_equal(got.numpy(), _parent_lanes(xq, xs, sxm, codes, ws, wm, kb, form))


def test_lane_order_tells_the_forms_apart():
    """On random inputs each pair of term forms gives different outputs, so
    a kernel held to the wrong one fails."""
    x, _, codes, ws, wm = _operands(4, 16, 4096, 3)
    xq, xs, sxm = qm.quant_acts(x)
    outs = {f: testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, 8, f) for f in testing.X2_FORMS}
    for a in testing.X2_FORMS:
        for b in testing.X2_FORMS:
            if a < b:
                assert not torch.equal(outs[a], outs[b]), (a, b)


def test_lane_order_refuses_a_slab_the_parent_did_not_take():
    x, _, codes, ws, wm = _operands(1, 1, 4096, 1)
    xq, xs, sxm = qm.quant_acts(x)
    for kb in (4, 12):      # not a multiple of 8, not the whole K; does not divide K
        with pytest.raises(ValueError):
            testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kb)
    with pytest.raises(ValueError):
        testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, 8, "fma")


@pytest.mark.parametrize("m", range(1, 17))
def test_lane_order_is_the_plain_version(m):
    """Within the matmul tolerance of x2_matmul_plain, which sums the same
    terms in another order: kb 8, 16 and a whole-K slab."""
    for k, kb in ((4096, 8), (4096, 16), (3072, 8)):
        x, w, codes, ws, wm = _operands(m, 6, k, m + k)
        xq, xs, sxm = qm.quant_acts(x)
        kbc = qm.x2_clamp(k, 6, 8, kb)[1]
        got = testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kbc)
        ref = qm.x2_matmul_plain(x, w, 8, kb)
        assert (got - ref).abs().max() <= MATMUL_TOL * ref.abs().max(), (k, kb)


@pytest.fixture(scope="module")
def ab_a8k4():
    """tools/ab_a8k4.py, imported with the jax config its import changes
    put back (as tests/test_torch_tools.py does)."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: jax.config.values[k] for k in keys}
    try:
        spec = importlib.util.spec_from_file_location("_ref_ab_a8k4_x2",
                                                      ROOT / "tools" / "ab_a8k4.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_lane_order_is_the_reference(ab_a8k4, m):
    """Within the matmul tolerance of the reference's x2_matmul (its Pallas
    kernel in interpret mode, un-jitted), weights from the same Q4_K bytes
    (a quantized Gaussian matrix, as tests/test_torch_tools.py builds them)
    through both packages' repack_q4k_a8k4."""
    k, n, kb = 2048, 256, 8
    rng = np.random.default_rng(m)
    w32 = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    data = np.frombuffer(quantize_q4_k(w32), np.uint8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jw = jqm.repack_q4k_a8k4(data, n, k)
    with jax.disable_jit():
        ref = np.asarray(ab_a8k4.x2_matmul(jnp.asarray(x), jw.codes, jw.ddm, jw.scmn,
                                           2048, kb))[:, :n]
    w = qm.repack_q4k_a8k4(data, n, k, "cpu")
    codes, ws, wm = qm.decode_q4k_blocks(w.codes.view(-1, 144), n)
    xq, xs, sxm = qm.quant_acts(torch.from_numpy(x))
    got = testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kb).numpy()
    assert np.abs(got - ref).max() <= MATMUL_TOL * np.abs(ref).max()


def _kernel_walk(xq, xs, sxm, codes, ws, wm, kb, R):
    """What kernel T computes, step by step, on the CPU: the producer's
    slot order (per slab, tl-major), a tile's steps (pairs of emulated lanes
    where kb <= 8, else one lane's chain) taken by R warps in turn with the
    slot index each computes from (slab, step), each lane's four chains
    P(c) = (P + term(2c)) + term(2c + 1) over its superblocks, the level o =
    1 sums, the pair, and the slab tree's leaves folded in step order."""
    M, K = xq.shape
    N, nsb = codes.shape[0], K // 256
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, -1, 32).float(),
                        codes.reshape(N, -1, 32).float())
    t = dots * ws[None]
    term = testing.fma_f32(t, xs[:, None, :].expand_as(t), -(sxm[:, None, :] * wm[None]))
    term = term.reshape(M, N, nsb, 4, 2)
    stream = [sb for s in range(nsb // kb) for tl in range(8)
              for sb in range(s * kb + tl, s * kb + kb, 8)]
    pair = kb <= 8
    per_slab = 4 if pair else 8
    kq, kr = kb >> 3, kb & 7
    leaves = []
    for s in range(nsb // kb):
        for i in range(per_slab):
            tl0 = 2 * i if pair else i
            nxt = s * kb + tl0 * kq + min(tl0, kr)
            x = y = None
            for a in range(2 if pair else 1):
                tl = tl0 + a
                P = torch.zeros((M, N, 4))
                for j in range((kb - tl + 7) >> 3):
                    sb = s * kb + 8 * j + tl
                    assert stream[nxt] == sb, (s, i, a, j)   # the slot holds this superblock
                    nxt += 1
                    for c in range(4):
                        P[..., c] = (P[..., c] + term[:, :, sb, c, 0]) + term[:, :, sb, c, 1]
                vl, vh = P[..., 0] + P[..., 1], P[..., 2] + P[..., 3]
                x, y = (vl, vh) if a == 0 else (x + vl, y + vh)
            leaves.append((s, tl0, x, y))
    # the leaves in step order (the R warps' rounds keep it), into the tree
    assert R >= 1
    run, lv = None, {}
    for s, tl0, x, y in leaves:
        level = 1 if pair else 0
        while level < 3 and (tl0 >> level) & 1:
            x, y = lv[level][0] + x, lv[level][1] + y
            level += 1
        if level < 3:
            lv[level] = (x, y)
            continue
        acc = x + y
        run = acc if run is None else run + acc
    return run


@pytest.mark.parametrize("k,kb", [(4096, 8), (4096, 16), (768, 3), (3072, 12), (4352, 17),
                                  (2048, 8), (256, 1), (512, 2)])
def test_kernel_walk_is_the_lane_order(k, kb):
    x, _, codes, ws, wm = _operands(3, 5, k, k + kb)
    xq, xs, sxm = qm.quant_acts(x)
    want = testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kb)
    assert torch.equal(_kernel_walk(xq, xs, sxm, codes, ws, wm, kb, 1), want)


def test_x2_slot_bytes():
    # 8 rows: x's codes 2 KB, its scales and sxm 2 x 256 B, 112 columns'
    # codes (14 KB) and headers (1792 B): 18688 bytes, on 1024: 19456
    assert qm.slab_slot_bytes(8, 112, x2=True) == 19456
    # 16 rows, 128 columns: 4 KB + 1 KB + 16 KB + 2 KB = 23552, on 1024
    assert qm.slab_slot_bytes(16, 128, x2=True) == 23552
    # one row: the columns' codes and headers only (16 columns: 2304 B)
    assert qm.slab_slot_bytes(1, 16, x2=True) == 3072
    # one tile of 8 warps, one row: 8 slots, barriers, the partials' two
    # buffers, x's row (4096 codes, 128 scales, 128 sxm)
    assert (qm.slab_smem(1, (1, 8, 8), K=4096, x2=True)
            == 1024 + 8 * 3072 + 128 + 2 * 8 * 2 * 2 * 32 * 4 + 4096 + 1024)
    # 8 rows, 7 tiles of one warp: the ring and its barriers
    assert qm.slab_smem(8, (7, 1, 4), x2=True) == 1024 + 4 * 19456 + 64
    assert [qm.x2_step_slots(kb) for kb in (1, 3, 8, 12, 16, 17, 56)] == [2, 2, 2, 2, 2, 3, 7]


@pytest.mark.parametrize("M", range(1, 17))
def test_x2_plan_fits_the_card(M):
    """Every x2 plan: shared memory a CTA may hold, T·R warps at most 8,
    and where R > 1 a ring that holds a round of the tile's steps (the
    launch refuses less); the widths of a wave where the tiles allow it."""
    widths = list(range(1, 300, 13)) + [1000, 1024, 4096, 14336, 128256]
    for N in widths:
        for K, kbs in ((4096, (8, 16)), (14336, (8, 56)), (3072, (12,)), (4352, (17,)),
                       (768, (3,))):
            for kb in kbs:
                plan = qm.slab_plan(M, N, kb, K=K, x2=True)
                t, r, d = plan
                assert t * r <= qm.SG_MAX_WARPS and 2 <= d <= qm.SG_MAX_SLOTS
                assert qm.slab_smem(M, plan, K=K, x2=True) <= qm.SMEM_MAX
                assert r == 1 or d >= r * qm.x2_step_slots(kb)
                tiles = -(-N // 16)
                assert t == 1 or -(-tiles // t) >= qm.SG_WAVE


def test_x2_plan_at_the_8b_shapes():
    """Q's tiles and warps at kb 8 (two slots a step), and at kb 16 (two
    slots a step, one lane's chain); the ring SG_INFLIGHT bytes deep, at
    least 4 slots and a round."""
    want = {"wq/wo": (2, 4), "wk/wv": (1, 8), "gate/up": (7, 1), "down": (2, 4),
            "lm_head": (8, 1), "ragged": (1, 8)}
    for label, (K, N) in SHAPES.items():
        for M in range(1, 17):
            for kb in (8, 16):
                kbc = qm.x2_clamp(K, N, 8, kb)[1]
                t, r, d = qm.slab_plan(M, N, kbc, K=K, x2=True)
                assert (t, r) == want[label], (label, M, kb)
                slot = qm.slab_slot_bytes(M, 16 * t, x2=True)
                assert d == max(2 * r, 4, -(-qm.SG_INFLIGHT // slot)), (label, M, kb)


@pytest.mark.parametrize("label", list(SHAPES))
def test_x2_plan_owns_every_column_once(label):
    """The kernel's walk: CTA b of min(groups, 132) takes column groups b,
    b + grid, ...; tile i of a group its 16 columns at 16i; lane (gq, t)
    of the tile's warps stores columns c0 + gq and c0 + gq + 8 of the
    outputs it owns (o % R == its warp), rows 2t, 2t + 1 (+ 8). Every
    (row, column) below (M, N) is stored exactly once."""
    K, N = SHAPES[label]
    for M in (1, 8, 16):
        t, r, _ = qm.slab_plan(M, N, 8, K=K, x2=True)
        no = 2 if M == 1 else 4 if M <= 8 else 8
        cols = 16 * t
        groups = -(-N // cols)
        grid = min(groups, N_SMS)
        owned = np.zeros((M, N), dtype=np.int64)
        for b in range(grid):
            for g in range(b, groups, grid):
                for tile in range(t):
                    c0 = g * cols + 16 * tile
                    for w in range(r):
                        for lane in range(32):
                            gq, tq = lane >> 2, lane & 3
                            for o in range(no):
                                if o % r != w:
                                    continue
                                col_hi = o if no == 2 else (o >> 1) & 1
                                row = 2 * tq + (0 if no == 2 else (o & 1) + 8 * (o >> 2))
                                n = c0 + gq + 8 * col_hi
                                if row < M and n < N:
                                    owned[row, n] += 1
        assert (owned == 1).all(), (label, M)


def test_x2_plan_refuses_kb():
    with pytest.raises(ValueError):
        qm.slab_plan(1, 4096, 0, x2=True)
