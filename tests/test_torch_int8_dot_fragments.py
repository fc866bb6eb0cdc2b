"""The int8 dots' tensor-core mapping (kernels W and X: swar_dot, i8_dot,
unpack_dot), emulated on the CPU.

On the card a CTA owns 64 columns of b [K, N] and all of K, and streams b
through a ring of 64-row stages. Each stage lies in shared memory in 16-byte chunks, two
rows a 128-byte line, the chunk XORed with 2 * ((row >> 2) & 3). Warp (cg,
kh) takes the columns 32 cg .. 32 cg + 31 and the stage's k32 step kh: lane
(g, t) reads the word of columns 4g..4g+3 in rows 4t..4t+3 (b0) and
16+4t..16+4t+3 (b1), masks the nibbles on the words (swar: lo + hi per
byte; unpack: lo and hi apart), and transposes each 4 x 4 bytes with eight
prmt, so n8 tile j holds the columns 4g + j. a's 32 rows (two m16 tiles,
zeros past M) lie beside b's in the stage, 64 bytes a row, two rows a line, the
chunk XORed with (row >> 1) & 3, and ldmatrix.x4 reads each m16 tile's A
fragment. These tests build the stage, the words, the prmt selectors' bytes
and the fragments exactly as the kernel addresses them, expand the
fragments through the PTX ISA's m16n8k32 layout, put each accumulator where
the kernel stores it, and hold the result equal to the plain versions and
to the reference's probes in interpret mode; they also hold the stage's
reads to 32 banks and the stores' coverage of every output once.
"""

import importlib

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu_torch.ops import probes

torch.set_num_threads(1)

NIB = 0x0F0F0F0F
BN, KT = 64, 64      # probes.cu's D_BN (columns a CTA owns), D_KT (K rows a stage)
MT = 2               # m16 tiles of a's rows (D_MAXM = 32)
MODES = ("swar_dot", "i8_dot", "unpack_dot")
ROWS = (1, 5, 16, 17, 32)


# -- the kernel's addressing --------------------------------------------------

def boff(r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row r in a stage (d_boff)."""
    return (r >> 1) * 128 + ((((r & 1) << 2) | c) ^ (((r >> 2) & 3) << 1)) * 16


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm / prmt: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(v)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * s)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose(v):
    """d_transpose: v[r] holds byte j of row r; f[j] gets byte r of column j."""
    lo01, hi01 = byte_perm(v[0], v[1], 0x5140), byte_perm(v[0], v[1], 0x7362)
    lo23, hi23 = byte_perm(v[2], v[3], 0x5140), byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def stage_bytes(b: np.ndarray, k0: int, kend: int, n0: int) -> np.ndarray:
    """The bytes of b's stage at rows k0.. of columns n0.. as the ring holds
    them (zeros past kend and N)."""
    N = b.shape[1]
    buf = np.zeros(KT * BN, np.uint8)
    for r in range(KT):
        k = k0 + r
        for c in range(4):
            n = n0 + 16 * c
            if k < kend and n < N:
                chunk = b[k, n:n + 16]
                buf[boff(r, c):boff(r, c) + len(chunk)] = chunk
    return buf


def stage_words(buf: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """The little-endian 32-bit words at byte offsets `offs`."""
    w = buf.astype(np.uint32)
    return w[offs] | w[offs + 1] << 8 | w[offs + 2] << 16 | w[offs + 3] << 24


def aoff(r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of a's row r in a stage's a half (d_aoff)."""
    return (r >> 1) * 128 + ((((r & 1) << 2) | c) ^ ((r >> 1) & 3)) * 16


def stage_a_bytes(a: np.ndarray, M: int, K: int, h: int, k0: int) -> np.ndarray:
    """a's half h (a[:, h K + k]) at k0..k0+63 as the stage holds it: rows
    0 .. 31, zeros past M and K."""
    buf = np.zeros(MT * 16 * KT, np.uint8)
    for row in range(min(M, 16 * MT)):
        for c in range(4):
            for e in range(16):
                k = k0 + 16 * c + e
                if k < K:
                    buf[aoff(row, c) + e] = np.uint8(a[row, h * K + k])
    return buf


def ldmatrix_a(buf: np.ndarray, mt: int, kh: int) -> np.ndarray:
    """ldmatrix.x4 as the kernel addresses it: lane l gives row 16 mt + 8 ((l
    >> 3) & 1) + l % 8 at chunk 2 kh + l // 16; register q of lane (g, t) is
    word t of the row lane 8q + g gave → [32 lanes, 4] uint32."""
    addr = [aoff(16 * mt + 8 * ((l >> 3) & 1) + (l & 7), 2 * kh + (l >> 4)) for l in range(32)]
    regs = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            regs[lane, q] = stage_words(buf, np.array([addr[8 * q + g] + 4 * t]))[0]
    return regs


def _s8(w: np.ndarray) -> np.ndarray:
    b = np.stack([(w >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)], -1)
    b = b.astype(np.int64)
    return np.where(b > 127, b - 256, b)


def a_matrix(regs: np.ndarray) -> np.ndarray:
    """PTX m16n8k32 .s8 A fragments → A [16, 32]: reg i of lane (g, t) is
    row g + 8 (i & 1), k = 4t + 16 (i >> 1) + byte."""
    A = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            k0 = 4 * t + 16 * (i >> 1)
            A[g + 8 * (i & 1), k0:k0 + 4] = _s8(regs[lane, i])
    return A


def b_matrix(b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """PTX m16n8k32 .s8 B fragments → B [32, 8]: column g, k = 4t + byte
    (b0) or 16 + 4t + byte (b1)."""
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        B[4 * t:4 * t + 4, g] = _s8(b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = _s8(b1[lane])
    return B


def lane_offsets(cg: int, kh: int) -> np.ndarray:
    """boff[h][r] of every lane of warp (cg, kh) → [2, 4, 32]."""
    out = np.zeros((2, 4, 32), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h in range(2):
            for r in range(4):
                row = 32 * kh + 16 * h + 4 * t + r
                out[h, r, lane] = boff(row, 2 * cg + (g >> 2)) + 4 * (g & 3)
    return out


def store_index(n0: int, cg: int, mt: int, lane: int, q: int) -> tuple[int, int]:
    """(row, first of four columns) where the kernel stores accumulator q of
    m16 tile mt of lane (g, t) of column half cg: row 16 mt + g + 8 (q >>
    1), columns n0 + 32 cg + 8t + 4 (q & 1) + j for the n8 tiles j."""
    g, t = lane >> 2, lane & 3
    return 16 * mt + g + 8 * (q >> 1), n0 + 32 * cg + 8 * t + 4 * (q & 1)


def emulate(mode: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's result, CTA by CTA: each warp's words, masks,
    transposes and fragments, D = A B per (m16 tile, n8 tile), the two k32
    warps added, each accumulator stored where the kernel stores it
    (store_index), rows past M and columns past N not stored."""
    K, N = b.shape
    M = a.shape[0]
    na = 2 if mode == "unpack_dot" else 1
    out = np.zeros((M, N), np.int64)
    for n0 in range(0, N, BN):
        acc = np.zeros((2, 2, MT, 4, 32, 4), np.int64)   # [cg][kh][mt][j][lane][q]
        for k0 in range(0, K, KT):
            buf = stage_bytes(b, k0, K, n0)
            abuf = [stage_a_bytes(a, M, K, h, k0) for h in range(na)]
            for cg in range(2):
                for kh in range(2):
                    v = stage_words(buf, lane_offsets(cg, kh))        # [2, 4, 32]
                    if mode == "unpack_dot":
                        planes = [v & NIB, (v >> 4) & NIB]
                    elif mode == "swar_dot":
                        planes = [(v & NIB) + ((v >> 4) & NIB)]
                    else:
                        planes = [v]
                    for h, p in enumerate(planes):
                        f = [transpose(list(p[0])), transpose(list(p[1]))]
                        for mt in range(MT):
                            A = a_matrix(ldmatrix_a(abuf[h], mt, kh))
                            for j in range(4):
                                D = A @ b_matrix(f[0][j], f[1][j])       # [16, 8]
                                for lane in range(32):
                                    g, t = lane >> 2, lane & 3
                                    for q in range(4):
                                        acc[cg, kh, mt, j, lane, q] += \
                                            D[g + 8 * (q >> 1), 2 * t + (q & 1)]
        for cg in range(2):
            tot = acc[cg, 0] + acc[cg, 1]
            for mt in range(MT):
                for lane in range(32):
                    for q in range(4):
                        row, col = store_index(n0, cg, mt, lane, q)
                        if row < M and col < N:
                            out[row, col:col + 4] += tot[mt, :, lane, q]
    return out


def _inputs(mode, M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (M, (2 if mode == "unpack_dot" else 1) * K), dtype=np.int8)
    b = (rng.integers(-128, 128, (K, N), dtype=np.int8).view(np.uint8) if mode == "i8_dot"
         else rng.integers(0, 256, (K, N), dtype=np.uint8))
    return a, b


def _plain(mode, a, b):
    bt = torch.from_numpy(b.view(np.int8) if mode == "i8_dot" else b)
    return getattr(probes, f"{mode}_plain")(torch.from_numpy(a), bt).numpy()


# -- the products ---------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", ROWS)
def test_fragments_give_the_plain_dot(mode, m):
    """K = 161 ends inside a stage and a k32 step, N = 132 inside the third
    64-column CTA (and its second warp's columns): every output equals the
    plain version, rows past M are not written."""
    a, b = _inputs(mode, m, 161, 132, seed=m)
    got = emulate(mode, a, b)
    assert np.array_equal(got, _plain(mode, a, b).astype(np.int64))


def test_swar_dot_is_one_product_of_the_byte_sums():
    """lo + hi per byte (<= 30) carries into no neighbouring byte, so the
    word sum is the byte sums, and the swar dot is a @ (lo + hi)."""
    rng = np.random.default_rng(4)
    c = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    w = torch.from_numpy(c).view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
    s = ((w & NIB) + ((w >> 4) & NIB)).astype(np.uint32)
    bytes_ = s.view(np.uint8).reshape(64, 64)
    assert np.array_equal(bytes_, (c & 15) + (c >> 4))
    a = rng.integers(-128, 128, (7, 64), dtype=np.int8)
    lo, hi = probes.swar_lo_hi_plain(torch.from_numpy(c))
    assert torch.equal(probes.swar_dot_plain(torch.from_numpy(a), torch.from_numpy(c)),
                       probes.i8_dot_plain(torch.from_numpy(a), lo + hi))


def test_transpose_selectors():
    """The eight prmt selectors turn four row words into four column words."""
    rng = np.random.default_rng(5)
    m = rng.integers(0, 256, (4, 4), dtype=np.uint8)           # [row r][column j]
    v = [np.array([int.from_bytes(m[r].tobytes(), "little")], np.uint32) for r in range(4)]
    f = transpose(v)
    for j in range(4):
        assert int(f[j][0]).to_bytes(4, "little") == m[:, j].tobytes()


# -- the stage's layout ---------------------------------------------------------

def test_stage_layout_is_a_permutation_of_chunks():
    offs = sorted(boff(r, c) for r in range(KT) for c in range(4))
    assert offs == list(range(0, KT * BN, 16))


@pytest.mark.parametrize("cg,kh", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_warp_reads_hit_32_banks(cg, kh):
    """Each of a warp's eight word reads of a stage touches 32 distinct
    banks (no conflict)."""
    offs = lane_offsets(cg, kh)
    for h in range(2):
        for r in range(4):
            assert len(set((offs[h, r] // 4 % 32).tolist())) == 32, (h, r)


def test_a_rows_layout_and_ldmatrix_reads_hit_32_banks():
    """a's stage rows: every chunk of 32 rows once, and each of ldmatrix's
    four 8-row phases reads 8 rows that fall in 8 distinct bank groups, at
    both k32 steps and both m16 tiles."""
    assert sorted(aoff(r, c) for r in range(32) for c in range(4)) == list(range(0, 2048, 16))
    for mt in range(2):
        for kh in range(2):
            addr = [aoff(16 * mt + 8 * ((l >> 3) & 1) + (l & 7), 2 * kh + (l >> 4))
                    for l in range(32)]
            for q in range(4):
                assert len({x // 16 % 8 for x in addr[8 * q:8 * q + 8]}) == 8, (mt, kh, q)


def test_stage_writes_fill_a_line_per_eight_threads():
    """dot_issue's 16-byte copies: thread i writes chunk i & 3 of row i >> 2;
    every 8 consecutive threads fill one 128-byte line (no conflict)."""
    for p in range(KT * 4 // 8):
        offs = [boff(i >> 2, i & 3) for i in range(8 * p, 8 * p + 8)]
        assert sorted(o % 128 for o in offs) == list(range(0, 128, 16))
        assert len({o // 128 for o in offs}) == 1


# -- the stores -----------------------------------------------------------------

@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("n", [4, 60, 132, 14336])
def test_stores_cover_every_output_once(m, n):
    """Over the grid's ceil(N / 64) CTAs, the stores of rows below M and
    columns below N (four int32 a store, one 16-byte word) write every
    output element exactly once."""
    seen = np.zeros((m, n), np.int64)
    for n0 in range(0, n, BN):
        for cg in range(2):
            for mt in range(MT):
                for lane in range(32):
                    for q in range(4):
                        row, col = store_index(n0, cg, mt, lane, q)
                        if row < m and col < n:
                            assert col % 4 == 0 and col + 4 <= n
                            seen[row, col:col + 4] += 1
    assert (seen == 1).all()


# -- against the reference's probes -----------------------------------------------

@pytest.fixture(scope="module")
def ref():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: jax.config.values[k] for k in keys}
    try:
        return {n: importlib.import_module(f"blama_tpu.tools.{n}")
                for n in ("probe_swar", "probe_mosaic")}
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("mode", MODES)
def test_fragments_equal_the_reference_probe(ref, mode):
    """At the reference's own draw (32 rows of a), its k_swar_dot, k_i8_dot
    and k_i8_from_unpack_dot in interpret mode give the emulated kernel's
    sums."""
    R, N = 64, 128
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (R, N), dtype=np.uint8)
    a = rng.integers(-127, 127, (32, R), dtype=np.int8)
    b8 = rng.integers(-8, 8, (R, N), dtype=np.int8)
    c8 = rng.integers(0, 255, (R // 2, N), dtype=np.uint8)
    kernel, lhs, rhs = {
        "swar_dot": (ref["probe_swar"].k_swar_dot, a, x),
        "i8_dot": (ref["probe_mosaic"].k_i8_dot, a, b8),
        "unpack_dot": (ref["probe_mosaic"].k_i8_from_unpack_dot, a, c8)}[mode]
    want = jpl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((32, N), jnp.int32),
                           interpret=True)(jnp.asarray(lhs), jnp.asarray(rhs))
    got = emulate(mode, lhs, rhs.view(np.uint8))
    assert np.array_equal(got, np.asarray(want).astype(np.int64))
