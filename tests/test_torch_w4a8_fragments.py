"""The W4A8 GEMV's tensor-core mapping, sum order and column plan (kernels A,
I, J, M), emulated on the CPU.

On the card each 32-element group dot is one mma.m16n8k32 (s8): A = 16 rows
of activation codes, which the kernel's quantizer writes in fragment order
(rows past M zero), and B = 8 weight columns read as the packed layout lies
(ldmatrix hands lane (g, t) word t of a column's 16 bytes; QuantTensorA8S's
low nibbles are B's first 16 k, the high nibbles the last 16; a
QuantTensorA8K4 chunk of 32 bytes holds two groups, low and high nibbles).
These tests build the fragment registers exactly as the kernel addresses
them, expand them through the PTX ISA's fragment layout into the two
matrices, and hold the products equal to the plain group dots. They also
emulate the kernel's sum order (a warp's residues, the butterfly's levels
in its registers, then across warps) and hold it equal bit for bit, at every
residue split, to the order of one warp per column, within tolerance of the
JAX reference; and the column plan's coverage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.gguf import GGMLType
from blama_tpu.gguf import quants as jquants
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.testing import random_q4k

torch.set_num_threads(1)

NIB = 0x0F0F0F0F
ROWS = (1, 3, 8, 9, 16)


def _words(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4n] → int64 little-endian 32-bit words [..., n]."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _bytes(w: torch.Tensor, signed: bool) -> torch.Tensor:
    """32-bit words [...] → their 4 bytes [..., 4] (s8 or u8 values)."""
    b = torch.stack([(w >> (8 * i)) & 255 for i in range(4)], dim=-1)
    return torch.where(b > 127, b - 256, b) if signed else b


def _x_fragments(xq: torch.Tensor, pg: int) -> torch.Tensor:
    """The kernel's quantizer's writes for phase group pg: word w (elements
    4w..4w+3) of row r to lane (r % 8) * 4 + w % 4, register (r / 8) + 2 (w /
    4) of a 16-row fragment. Returns the registers [32 lanes, 4] (a0..a3)."""
    M = xq.shape[0]
    regs = torch.zeros((32, 4), dtype=torch.int64)
    words = _words(xq[:, 32 * pg:32 * pg + 32].view(torch.uint8))     # [M, 8]
    for r in range(M):
        for w in range(8):
            regs[(r % 8) * 4 + w % 4, r // 8 + 2 * (w // 4)] = words[r, w]
    return regs


def _a_matrix(regs: torch.Tensor) -> torch.Tensor:
    """m16n8k32 .s8 A fragments → A [16, 32]: row g (a0, a2) or g + 8 (a1,
    a3), k = 4t + byte (a0, a1) or 16 + 4t + byte (a2, a3)."""
    A = torch.zeros((16, 32), dtype=torch.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg in range(4):
            row, k0 = g + 8 * (reg & 1), 4 * t + 16 * (reg >> 1)
            A[row, k0:k0 + 4] = _bytes(regs[lane, reg], signed=True)
    return A


def _b_matrix(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """m16n8k32 .s8 B fragments (per lane) → B [32, 8]: column g, k = 4t +
    byte (b0) or 16 + 4t + byte (b1)."""
    B = torch.zeros((32, 8), dtype=torch.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        B[4 * t:4 * t + 4, g] = _bytes(b0[lane], signed=True)
        B[16 + 4 * t:16 + 4 * t + 4, g] = _bytes(b1[lane], signed=True)
    return B


def _ldmatrix(rows16: torch.Tensor) -> torch.Tensor:
    """ldmatrix of one 8 x 16-byte matrix (row g = rows16[g]): lane (g, t)
    gets word t of row g."""
    w = _words(rows16)                                   # [8, 4]
    return torch.stack([w[lane >> 2, lane & 3] for lane in range(32)])


def _acts(m, k, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32))
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("m", ROWS)
def test_split_layout_fragments_give_the_group_dots(m):
    """Kernel A (and J, M): per group, the mma of the quantizer's A
    fragments and ldmatrix's words of the split codes equals _group_dots
    for every row and column of an 8-column tile."""
    n, k = 8, 256
    w = qm.repack_q4k_a8s(random_q4k(np.random.default_rng(m), n, k, k ** -0.5), n, k, "cpu")
    xq = qm.quant_acts(_acts(m, k, m))[0]
    ref = qm._group_dots(xq, qm.unpair_codes(w.codes))              # [M, N, G]
    for gi in range(k // 32):
        r = _ldmatrix(w.codes[:, 16 * gi:16 * gi + 16])             # cols 0..7, group gi
        D = _a_matrix(_x_fragments(xq, gi)) @ _b_matrix(r & NIB, (r >> 4) & NIB)
        assert torch.equal(D[m:], torch.zeros_like(D[m:]))          # rows past M
        assert torch.equal(D[:m].double(), ref[:, :, gi].double()), gi


@pytest.mark.parametrize("m", ROWS)
def test_native_chunk_fragments_give_the_group_dots(m):
    """Kernel I: ldmatrix of a chunk's two 16-byte halves gives B for
    group 2c (low nibbles) and 2c+1 (high nibbles) of the superblock."""
    n, k = 8, 512
    w = qm.repack_q4k_a8k4(random_q4k(np.random.default_rng(50 + m), n, k, k ** -0.5), n, k,
                           "cpu")
    xq = qm.quant_acts(_acts(m, k, 50 + m))[0]
    codes = qm.decode_q4k_blocks(w.codes.view(-1, qm.Q4K_BLOCK), n)[0]
    ref = qm._group_dots(xq, codes)
    blocks = w.codes.view(n, k // 256, qm.Q4K_BLOCK)
    for sb in range(k // 256):
        for c in range(4):
            chunk = blocks[:, sb, 16 + 32 * c:16 + 32 * c + 32]
            r0, r1 = _ldmatrix(chunk[:, :16]), _ldmatrix(chunk[:, 16:])
            for h in range(2):
                gi = 8 * sb + 2 * c + h
                D = _a_matrix(_x_fragments(xq, gi)) @ _b_matrix((r0 >> 4 * h) & NIB,
                                                               (r1 >> 4 * h) & NIB)
                assert torch.equal(D[:m].double(), ref[:, :, gi].double()), gi


# ---------------------------------------------------------------------------
# the sum order
# ---------------------------------------------------------------------------

def _residue(g: int, native: bool) -> int:
    """The partial a group's term goes to (K-block relative group index)."""
    return (g % 64) // 2 if native else g % 32


def _one_warp_order(terms: torch.Tensor, native: bool) -> torch.Tensor:
    """The order of one warp per column: lane l adds the terms of residue l
    in ascending group order, then the xor butterfly 16, 8, 4, 2, 1."""
    p = [torch.zeros(terms.shape[:2]) for _ in range(32)]
    for g in range(terms.shape[2]):
        lane = _residue(g, native)
        p[lane] = p[lane] + terms[:, :, g]
    for o in (16, 8, 4, 2, 1):
        for lane in range(o):
            p[lane] = p[lane] + p[lane + o]
    return p[0]


def _kernel_order(terms: torch.Tensor, native: bool, rw: int) -> torch.Tensor:
    """The redesigned kernel's order: stages of 32 groups; warp r of the rw
    residue splits takes residues r + rw j into its partial j (A: group r +
    rw j of the round; I: chunk pairs u = r + rw i of the stage, groups 2u
    then 2u + 1, into partial 16 h / rw + i for stage parity h); then the
    butterfly's levels over j in the warp and over r across the warps."""
    G = terms.shape[2]
    nj = 32 // rw
    q = [[torch.zeros(terms.shape[:2]) for _ in range(nj)] for _ in range(rw)]
    for s in range(-(-G // 32)):
        ng = min(32, G - 32 * s)
        for r in range(rw):
            if not native:
                for j in range(nj):
                    gi = r + rw * j
                    if gi < ng:
                        q[r][j] = q[r][j] + terms[:, :, 32 * s + gi]
            else:
                nu, h = 16 // rw, s & 1
                for i in range(nu):
                    u = r + rw * i
                    for gi in (2 * u, 2 * u + 1):
                        if gi < ng:
                            q[r][h * nu + i] = q[r][h * nu + i] + terms[:, :, 32 * s + gi]
    for r in range(rw):
        o = nj // 2
        while o:
            for j in range(o):
                q[r][j] = q[r][j] + q[r][j + o]
            o //= 2
    v = [q[r][0] for r in range(rw)]
    o = rw // 2
    while o:
        for r in range(o):
            v[r] = v[r] + v[r + o]
        o //= 2
    return v[0]


def _one_row_order(terms: torch.Tensor, rw: int) -> torch.Tensor:
    """Kernel A's order at one row: in warp r a lane's block group q (0..3)
    takes residues r + rw (4j + q) into its partial j; the butterfly's levels
    over j in the lane, then over q across lanes (xor 16: q ^ 2, then xor 8:
    q ^ 1, each lane adding its own value first), then over r."""
    G = terms.shape[2]
    nj = 32 // rw // 4
    q = [[[torch.zeros(terms.shape[:2]) for _ in range(nj)] for _ in range(4)]
         for _ in range(rw)]
    for s in range(-(-G // 32)):
        ng = min(32, G - 32 * s)
        for r in range(rw):
            for j in range(0, 32 // rw, 4):
                for qq in range(4):
                    gi = r + rw * (j + qq)
                    if gi < ng:
                        q[r][qq][j // 4] = q[r][qq][j // 4] + terms[:, :, 32 * s + gi]
    v = []
    for r in range(rw):
        lanes = []
        for qq in range(4):
            p = q[r][qq]
            o = nj // 2
            while o:
                for j in range(o):
                    p[j] = p[j] + p[j + o]
                o //= 2
            lanes.append(p[0])
        lanes = [lanes[i] + lanes[i ^ 2] for i in range(4)]
        lanes = [lanes[i] + lanes[i ^ 1] for i in range(4)]
        v.append(lanes[0])
    o = rw // 2
    while o:
        for r in range(o):
            v[r] = v[r] + v[r + o]
        o //= 2
    return v[0]


def _terms(x, codes, ws, wm):
    xq, xs, sxm = qm.quant_acts(x)
    return qm._group_dots(xq, codes) * ws[None] * xs[:, None, :] - sxm[:, None, :] * wm[None]


@pytest.mark.parametrize("native", [False, True], ids=["split", "native"])
@pytest.mark.parametrize("rw", qm.GEMV_SPLITS)
def test_every_residue_split_keeps_the_one_warp_order(native, rw):
    """Bit for bit at every split, at a K of 2.75 rounds (a ragged last
    stage) and 5 rows: a row's sum does not depend on rw, M or the tile."""
    n, k, m = 40, 2816, 5
    data = random_q4k(np.random.default_rng(rw), n, k, k ** -0.5)
    x = _acts(m, k, 7 + rw)
    if native:
        w = qm.repack_q4k_a8k4(data, n, k, "cpu")
        terms = _terms(x, *qm.decode_q4k_blocks(w.codes.view(-1, qm.Q4K_BLOCK), n))
    else:
        w = qm.repack_q4k_a8s(data, n, k, "cpu")
        terms = _terms(x, qm.unpair_codes(w.codes), w.scales.float(), w.mins.float())
    ref = _one_warp_order(terms, native)
    out = _kernel_order(terms, native, rw)
    assert torch.equal(out, ref)
    assert torch.equal(_kernel_order(terms[2:3], native, rw), ref[2:3])
    if not native:   # kernel A's one-row path
        assert torch.equal(_one_row_order(terms[2:3], rw), ref[2:3])


@pytest.mark.parametrize("m", [1, 4])
def test_kernel_order_matches_jax(m):
    """The emulated kernel order against the reference's W4A8 kernel (under
    jax.disable_jit: XLA's jit divides amax / 127 through a reciprocal):
    the f32 sums differ only in order, so within the matmul tolerance."""
    n, k = 320, 512
    wf = (np.random.default_rng(3).standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    data = jquants.quantize(wf, GGMLType.Q4_K)
    xf = np.random.default_rng(30 + m).standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(xf, jnp.bfloat16)
    with jax.disable_jit():
        fn = jqm.w4a8_swar_xin if m == 1 else jqm.w4a8_swar_fold
        ref = np.asarray(fn(xb, jqm.repack_q4k_a8s(data, n, k)))[:, :n]
    w = qm.repack_q4k_a8s(data, n, k, "cpu")
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    terms = _terms(x, qm.unpair_codes(w.codes), w.scales.float(), w.mins.float())
    out = _kernel_order(terms, False, 4).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the column plan
# ---------------------------------------------------------------------------

# (N, matrices) of the 8B projections and lm head, Mixtral's banks over 2
# and 8 experts, kernel M's 8 K-blocks, and ragged widths
PLAN_SHAPES = [(4096, 1), (1024, 1), (14336, 1), (128256, 1), (32000, 1), (14336, 2),
               (14336, 8), (4096, 8), (72, 1), (300, 1), (77, 3)]


@pytest.mark.parametrize("N,n_mat", PLAN_SHAPES)
def test_plan_covers_every_column_once(N, n_mat):
    """Each CTA walks tiles b, b + grid, ...: every (matrix, column) lies in
    exactly one tile of exactly one CTA, the grid is at most one wave of
    the card's SMs (so at most two), and a ragged N ends in a partial tile."""
    rw, grid = qm.gemv_plan(N, n_mat)
    bn = 64 // rw
    tiles = qm.gemv_tiles(rw, N, n_mat)
    assert 1 <= grid <= min(tiles, qm.N_SMS)
    seen = np.zeros((n_mat, N), np.int64)
    for b in range(grid):
        for t in range(b, tiles, grid):
            mat, col0 = divmod(t, tiles // n_mat)
            seen[mat, col0 * bn:min(N, (col0 + 1) * bn)] += 1
    assert (seen == 1).all()


def test_plan_fills_the_card_where_the_width_allows():
    """At the 8B shapes the plan launches a CTA on at least 128 of the 132
    SMs (wk/wv's 1024 columns: 128 tiles of 8), and the widest tile where
    the width fills the card anyway."""
    for N in (1024, 4096, 14336, 128256):
        rw, grid = qm.gemv_plan(N)
        assert grid >= 128, (N, rw, grid)
    assert qm.gemv_plan(14336)[0] == 1 and qm.gemv_plan(128256)[0] == 1
    assert qm.gemv_plan(1024)[0] == 8


def test_plan_forced_split():
    assert qm.gemv_plan(4096, 1, rw=8) == (8, qm.N_SMS)
    with pytest.raises(ValueError):
        qm.gemv_plan(4096, 1, rw=3)
