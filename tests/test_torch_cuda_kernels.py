"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with nvcc (the kernels build at first use); on a
machine without one every test skips. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -p no:randomly

Small, ragged shapes on purpose: the 8B shapes run in chip_smoke.py; here
the edges — row counts that are not powers of two, widths that do not fill
a block, a K that ends inside a staging chunk, batch > 1, a head dim of 64,
bf16, f32 and INT8 stores, pages of 32 slots on a scrambled pool — and
replay determinism (two launches give the same bits), for every kernel (A, B
with bf16 and f32 scales, C to F, G, H, I, the expert-bank kernels J and K,
the tp_blocks kernels L and M with their invariances, the decode-attention
modes' kernels N, O and P, the tools' kernels Q, R, S, T and U to Y, and rows_mm). The last tests drive each
engine, the MoE fixture, the tp_blocks mode and the scheduler on the card on
the tiny fixtures.
"""

import numpy as np
import pytest
import torch

from blama_tpu_torch.ops import decode_attention as da
from blama_tpu_torch.ops import paged_attention as pa
from blama_tpu_torch.ops import paged_kv as pkv
from blama_tpu_torch.ops import quant_matmul as qm

# tolerances as in chip_smoke.py: f32 sums in another order (matmuls);
# one bf16 rounding flip of the largest output (attention)
MATMUL_TOL = 1e-4
ATTN_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")
    return torch.device("cuda")


def _weights(n, k, seed, device):
    from blama_tpu_torch.gguf import GGMLType, quants

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return qm.repack_q4k_a8s(quants.quantize(w, GGMLType.Q4_K), n, k, device)


def _close(out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m,n,k,dtype", [
    (1, 320, 512, torch.bfloat16), (3, 320, 2560, torch.bfloat16),
    (16, 72, 256, torch.bfloat16), (1, 300, 768, torch.float32)])
def test_kernel_a(cuda, m, n, k, dtype):
    w = _weights(n, k, seed=m, device=cuda)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dtype).to(cuda)
    out, xq, xs, sxm = qm.w4a8_launch(x, w)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.w4a8_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.w4a8_launch(x, w)[0])


@pytest.mark.parametrize("m,n,k", [(17, 320, 512), (40, 72, 768), (130, 1000, 256)])
def test_kernel_b(cuda, m, n, k):
    w = _weights(n, k, seed=m, device=cuda)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)) \
        .to(torch.bfloat16).to(cuda)
    out = qm.q4k_pos(x, w)
    _close(out, qm.q4k_pos_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.q4k_pos(x, w))


def _bytes(n, k, seed, name):
    from blama_tpu_torch.gguf import GGMLType, quants

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return quants.quantize(w, GGMLType[name])


def _acts(m, k, dtype, device):
    return torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dtype).to(device)


# ragged edges of the exact kernels: one row (a thread per column) and 8 to
# 130 rows (64 x 64 tiles that rows and columns do not fill), a K of one
# superblock; a row must give the same bits through either
TILE_SHAPES = [(1, 320, 512), (17, 72, 768), (130, 1000, 256), (8, 300, 2560),
               (16, 200, 512)]


@pytest.mark.parametrize("m,n,k", TILE_SHAPES)
def test_kernel_b_f32_scales(cuda, m, n, k):
    """Kernel B on the exact engine's f32 scales, every row count; a row's
    result does not depend on the rows beside it."""
    w = qm.repack_q4k_exact(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    x = _acts(m, k, torch.bfloat16, cuda)
    out = qm.q4k_pos(x, w)
    _close(out, qm.q4k_pos_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.q4k_pos(x, w))
    assert torch.equal(out[-1:], qm.q4k_pos(x[-1:].contiguous(), w))
    _close(qm.q4k_matmul(x, w), x.float() @ qm.dequantize(w).t(), MATMUL_TOL)


@pytest.mark.parametrize("name", ["Q8_0", "Q6_K"])
@pytest.mark.parametrize("m,n,k", TILE_SHAPES)
def test_kernel_g(cuda, m, n, k, name):
    repack = qm.repack_q8_0 if name == "Q8_0" else qm.repack_q6_k_expanded
    w = repack(_bytes(n, k, m, name), n, k, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(m, k, dtype, cuda)
        out = qm.q8_0_matmul(x, w)
        _close(out, qm.q8_0_matmul_plain(x, w), MATMUL_TOL)
        assert torch.equal(out, qm.q8_0_matmul(x, w))
        assert torch.equal(out[-1:], qm.q8_0_matmul(x[-1:].contiguous(), w))


@pytest.mark.parametrize("m,n,k", TILE_SHAPES)
def test_kernel_h(cuda, m, n, k):
    w = qm.repack_q4k_native(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(m, k, dtype, cuda)
        out = qm.q4k_native_matmul(x, w)
        _close(out, qm.q4k_native_matmul_plain(x, w), MATMUL_TOL)
        _close(out, x.float() @ qm.dequantize(w).t(), MATMUL_TOL)
        assert torch.equal(out, qm.q4k_native_matmul(x, w))
        assert torch.equal(out[-1:], qm.q4k_native_matmul(x[-1:].contiguous(), w))


@pytest.mark.parametrize("m,n,k,dtype", [
    (1, 320, 512, torch.bfloat16), (3, 320, 2560, torch.bfloat16),
    (16, 72, 256, torch.bfloat16), (1, 300, 768, torch.float32),
    (8, 77, 4352, torch.bfloat16)])
def test_kernel_i(cuda, m, n, k, dtype):
    """Kernel I: activation codes equal the plain quantizer's bit for bit,
    K ends inside a staging chunk, and row 0 alone equals row 0 of m."""
    w = qm.repack_q4k_a8k4(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    x = _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.a8k4_launch(x, w)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.a8k4_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.a8k4_launch(x, w)[0])
    assert torch.equal(out[:1], qm.a8k4_launch(x[:1].contiguous(), w)[0])


def _bank(ne, n, k, seed, a8, device):
    """A stacked Q4_K bank of `ne` experts, each its own random weights."""
    return qm.repack_q4k_bank(_bytes(ne * n, k, seed, "Q4_K"), ne, n, k, a8, device)


@pytest.mark.parametrize("per_expert", [False, True], ids=["shared", "per_expert"])
@pytest.mark.parametrize("m,n,k,dtype", [
    (1, 320, 512, torch.bfloat16), (3, 72, 2560, torch.bfloat16),
    (16, 200, 256, torch.float32), (8, 77, 4352, torch.bfloat16)])
def test_kernel_j(cuda, m, n, k, dtype, per_expert):
    """Kernel J: selected experts read in place, in the order the ids give,
    each equal bit for bit to kernel A on that expert alone; its activation
    codes are the plain quantizer's."""
    bank = _bank(3, n, k, m, True, cuda)
    eids = torch.tensor([2, 0], dtype=torch.int32, device=cuda)
    x = torch.stack([_acts(m, k, dtype, cuda), _acts(m + 1, k, dtype, cuda)[:m]]) \
        if per_expert else _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.w4a8_bank_launch(x, bank, eids)
    pxq, pxs, psxm = qm.quant_acts(x.reshape(-1, k))
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.w4a8_bank_plain(x, bank, eids), MATMUL_TOL)
    for j, e in enumerate((2, 0)):
        xj = x[j] if per_expert else x
        assert torch.equal(out[j], qm.w4a8_launch(xj.contiguous(), bank.expert(e))[0])
    assert torch.equal(out, qm.w4a8_bank_launch(x, bank, eids)[0])


@pytest.mark.parametrize("a8", [False, True], ids=["f32_scales", "bf16_scales"])
@pytest.mark.parametrize("m,n,k", [(1, 320, 512), (17, 72, 768), (130, 1000, 256),
                                   (8, 300, 2560)])
def test_kernel_k(cuda, m, n, k, a8):
    """Kernel K on both scale types, shared and per-expert inputs: within
    the tolerance of its plain version, and a row gives the same bits at
    every row count (one row alone, two rows, all m) and in either form."""
    bank = _bank(4, n, k, m, a8, cuda)
    eids = torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda)
    x = _acts(m, k, torch.bfloat16, cuda)
    out = qm.q4k_bank_matmul(x, bank, eids)
    _close(out, qm.q4k_bank_plain(x, bank, eids), MATMUL_TOL)
    ref = x.float() @ torch.stack([qm.dequantize(bank.expert(e)) for e in (3, 1, 2)]) \
        .transpose(1, 2)
    _close(out, ref, MATMUL_TOL)
    assert torch.equal(out, qm.q4k_bank_matmul(x, bank, eids))
    assert torch.equal(out[:, -1:], qm.q4k_bank_matmul(x[-1:].contiguous(), bank, eids))
    assert torch.equal(out[:, :2], qm.q4k_bank_matmul(x[:2].contiguous(), bank, eids)[:, :2])
    per = qm.q4k_bank_matmul(x.expand(3, m, k).contiguous(), bank, eids)
    assert torch.equal(per, out)


# (m, n, k, nb): blocks of 1792 elements (7 superblocks: neither a multiple
# of kernel A's 2048-element staging chunk nor a power of two of groups),
# ragged widths, one row and the tiles
PARTS_SHAPES = [(1, 320, 3584, 2), (17, 72, 2048, 4), (130, 300, 2048, 8),
                (8, 200, 7168, 4), (1, 96, 14336, 8), (4, 136, 14336, 8)]


@pytest.mark.parametrize("a8", [False, True], ids=["f32_scales", "bf16_scales"])
@pytest.mark.parametrize("m,n,k,nb", PARTS_SHAPES)
def test_kernel_l(cuda, m, n, k, nb, a8):
    """Kernel L: each K-block's partial within the tolerance of its plain
    version; bit for bit, the partials equal those of the K-slices computed
    alone (tp = 2, 4, 8 devices), a row's partials do not depend on the row
    count (each of the first 16 rows and the last alone), and at one block a
    column shard of the weight gives its columns of the whole product."""
    repack = qm.repack_q4k_a8s if a8 else qm.repack_q4k_exact
    w = repack(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    x = _acts(m, k, torch.bfloat16, cuda)
    parts = qm.q4k_matmul_parts(x, w, nb)
    ref = qm.q4k_matmul_parts_plain(x, w, nb)
    for i in range(nb):
        _close(parts[i], ref[i], MATMUL_TOL)
    assert torch.equal(parts, qm.q4k_matmul_parts(x, w, nb))
    for tp in (2, 4, 8):
        if nb % tp:
            continue
        kb = k // tp
        shards = torch.cat([qm.q4k_matmul_parts(x[:, d * kb:(d + 1) * kb].contiguous(),
                                                qm.k_slice(w, d, tp, contiguous=True), nb // tp)
                            for d in range(tp)])
        assert torch.equal(shards, parts), tp
    for r in list(range(min(m, 16))) + [m - 1]:
        row = qm.q4k_matmul_parts(x[r:r + 1].contiguous(), w, nb)
        assert torch.equal(row, parts[:, r:r + 1]), r
    pinned = qm.q4k_matmul_pinned(x, w)
    _close(pinned, x.float() @ qm.dequantize(w).t(), MATMUL_TOL)
    half = n // 2
    assert torch.equal(qm.q4k_matmul_pinned(x, qm.column_slice(w, half, n)), pinned[:, half:])
    assert torch.equal(pinned[-1:], qm.q4k_matmul_pinned(x[-1:].contiguous(), w))


@pytest.mark.parametrize("m,n,k,nb", [(1, 320, 3584, 2), (2, 96, 3584, 2), (4, 136, 14336, 8),
                                      (5, 72, 2048, 4), (16, 300, 2048, 8),
                                      (8, 200, 14336, 8)])
def test_kernel_m(cuda, m, n, k, nb):
    """Kernel M: the plain quantizer's activation codes, each partial within
    the tolerance of its plain version, each equal bit for bit to kernel A
    on its K-slice alone (so at one block M is A), and each row alone equal
    to that row of m (the 1, 2, 4, 8 and 16-row builds)."""
    w = _weights(n, k, seed=m, device=cuda)
    x = _acts(m, k, torch.bfloat16, cuda)
    parts, xq, xs, sxm = qm.a8s_parts_launch(x, w, nb)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    ref = qm.a8s_matmul_parts_plain(x, w, nb)
    kb = k // nb
    for i in range(nb):
        _close(parts[i], ref[i], MATMUL_TOL)
        xi = x[:, i * kb:(i + 1) * kb].contiguous()
        wi = qm.k_slice(w, i, nb, contiguous=True)
        assert torch.equal(parts[i], qm.w4a8_launch(xi, wi)[0]), i
    assert torch.equal(qm.a8s_matmul_parts(x, w, 1)[0], qm.w4a8_launch(x, w)[0])
    assert torch.equal(parts, qm.a8s_matmul_parts(x, w, nb))
    for r in range(m):
        assert torch.equal(qm.a8s_matmul_parts(x[r:r + 1].contiguous(), w, nb),
                           parts[:, r:r + 1]), r


# kernels Q and T (the tools' W4A8 variants): ragged widths (a column tile
# that halves down to 1..8 columns), K whose slab kb clamps (768, 4352: kb 1;
# for T the whole K as one slab), every row-count template
SLAB_SHAPES = [(1, 320, 512, torch.bfloat16), (3, 300, 768, torch.bfloat16),
               (8, 72, 4352, torch.bfloat16), (16, 1000, 2048, torch.float32),
               (5, 256, 4096, torch.bfloat16)]


@pytest.mark.parametrize("kb", [1, 3, 4, 8])
@pytest.mark.parametrize("m,n,k,dtype", SLAB_SHAPES)
def test_kernel_q(cuda, m, n, k, dtype, kb):
    """Kernel Q: activation codes bit for bit, the positive part within
    tolerance of its plain version and the whole product of kernel A's (the
    same function in another grouping), two launches and row 0 alone equal."""
    w = _weights(n, k, seed=m + kb, device=cuda)
    x = _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.a8s_launch(x, w, 16, kb)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.a8s_pos_plain(x, w, kb), MATMUL_TOL)
    full = qm.w4a8_swar_matmul(x, w, 16, kb)
    _close(full, qm.w4a8_swar_matmul_plain(x, w, 16, kb), MATMUL_TOL)
    _close(full, qm.w4a8_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.a8s_launch(x, w, 16, kb)[0])
    assert torch.equal(out[:1], qm.a8s_launch(x[:1].contiguous(), w, 16, kb)[0])


@pytest.mark.parametrize("m,n,k", [(1, 4096, 1024), (8, 1000, 2048), (16, 384, 4352)])
def test_kernel_q_block_n_moves_no_bit(cuda, m, n, k):
    """block_n, the columns one CTA owns, is launch geometry only."""
    w = _weights(n, k, seed=m, device=cuda)
    x = _acts(m, k, torch.bfloat16, cuda)
    for kb in (1, 4):
        ref = qm.a8s_launch(x, w, 1, kb)[0]
        for bn in (2, 8, 16, 64, 256, 2048):
            assert torch.equal(qm.a8s_launch(x, w, bn, kb)[0], ref), (kb, bn)


@pytest.mark.parametrize("kb", [8, 16])
@pytest.mark.parametrize("m,n,k,dtype", SLAB_SHAPES)
def test_kernel_t(cuda, m, n, k, dtype, kb):
    """Kernel T: activation codes bit for bit, within tolerance of its plain
    version and of kernel I's (another grouping), two launches equal, row 0
    alone equal, bits equal across block_n."""
    w = qm.repack_q4k_a8k4(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    x = _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.x2_launch(x, w, 16, kb)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.x2_matmul_plain(x, w, 16, kb), MATMUL_TOL)
    _close(out, qm.a8k4_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.x2_launch(x, w, 16, kb)[0])
    assert torch.equal(out[:1], qm.x2_launch(x[:1].contiguous(), w, 16, kb)[0])
    for bn in (1, 8, 2048):
        assert torch.equal(qm.x2_launch(x, w, bn, kb)[0], out), bn


@pytest.mark.parametrize("r,n,bk,bn", [(64, 256, 16, 128), (100, 1024, 7, 48),
                                       (33, 160, 3, 32), (2048, 14336, 256, 14336),
                                       (512, 4096, 64, 16384 // 4)])
def test_kernel_r_reads_every_byte(cuda, r, n, bk, bn):
    """Kernel R: the first 8 rows of every block summed per column, exactly
    the plain version (columns past the grid 0), and every byte of every
    block staged: the per-column sum of what the CTAs brought on chip equals
    the blocks' own."""
    from blama_tpu_torch.ops import probes

    g = torch.Generator(device=cuda).manual_seed(r)
    codes = torch.randint(0, 256, (r, n), generator=g, dtype=torch.uint8, device=cuda)
    out, tot = probes.stream_launch(codes, bk, bn, total=True)
    assert torch.equal(out, probes.stream_plain(codes, bk, bn))
    covered = codes[:r // bk * bk, :n // bn * bn].to(torch.int32).sum(0).float()
    assert torch.equal(tot[0, :covered.shape[0]], covered)
    assert not tot[0, covered.shape[0]:].any()
    assert torch.equal(probes.stream(codes, bk, bn), out)


@pytest.mark.parametrize("shape", [(8, 128), (1000,), (3, 5)])
def test_kernel_s(cuda, shape):
    from blama_tpu_torch.ops import probes

    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    assert torch.equal(probes.add_one(x), probes.add_one_plain(x))


def _ubench_weights(n, k, seed, device):
    """Random element-order codes u8 [N, K], f32 scales and mins [N, K/32]."""
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 16, (n, k), generator=g, dtype=torch.uint8)
    scales = torch.rand((n, k // 32), generator=g) * 0.02 + 0.01
    mins = torch.rand((n, k // 32), generator=g) * 0.01
    return codes.to(device), scales.to(device), mins.to(device)


# ragged: N not a multiple of block_n (300, 1000: the clamp halves it), B =
# 3, an odd number of K-blocks (K = 3 or 5 blocks of kb tiles)
UV_SHAPES = [(1, 320, 3, 1), (3, 300, 3, 2), (8, 1000, 5, 1), (16, 72, 3, 4),
             (3, 256, 1, 8)]


@pytest.mark.parametrize("m,n,blocks,kb", UV_SHAPES)
def test_kernel_u(cuda, m, n, blocks, kb):
    """Kernel U: within tolerance of its plain version (positive part and the
    product with the min term), two launches equal, row 0 alone equal, bits
    equal across block_n."""
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    k = blocks * kb * 256
    codes, scales, mins = _ubench_weights(n, k, m + kb, cuda)
    paired = pack_pairs(codes)
    x = _acts(m, k, torch.float32, cuda)
    out = qm.twodot_launch(x, paired, scales, 16, kb)
    _close(out, qm.twodot_pos_plain(x, paired, scales, kb), MATMUL_TOL)
    full = qm.q4k_matmul_v1(x, paired, scales, mins, 16, kb)
    _close(full, qm.q4k_matmul_v1(x.cpu(), paired.cpu(), scales.cpu(), mins.cpu(), 16, kb)
           .to(cuda), MATMUL_TOL)
    assert torch.equal(out, qm.twodot_launch(x, paired, scales, 16, kb))
    assert torch.equal(out[:1], qm.twodot_launch(x[:1].contiguous(), paired, scales, 16, kb))
    for bn in (1, 8, 64, 4096):
        assert torch.equal(qm.twodot_launch(x, paired, scales, bn, kb), out), bn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,blocks,kb", UV_SHAPES)
def test_kernel_v(cuda, m, n, blocks, kb, dtype):
    """Kernel V: kernel A's activation codes bit for bit, within tolerance of
    its plain version, the int8 and the tile-paired loaders bit-equal, row 0
    alone equal, bits equal across block_n."""
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    k = blocks * kb * 256
    codes, scales, mins = _ubench_weights(n, k, m + kb + 1, cuda)
    i8, paired = codes.to(torch.int8), pack_pairs(codes)
    sb, mb = scales.to(torch.bfloat16), mins.to(torch.bfloat16)
    x = _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.plane_launch(x, i8, sb, False, 16, kb)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.plane_pos_plain(x, i8, sb, kb), MATMUL_TOL)
    _close(qm.w4a8_plane_matmul(x, i8, sb, mb, 16, kb),
           qm.w4a8_matmul_plain(x, qm.pack_a8s(codes, scales, mins)), MATMUL_TOL)
    assert torch.equal(qm.plane_launch(x, paired, sb, True, 16, kb)[0], out)
    assert torch.equal(out[:1], qm.plane_launch(x[:1].contiguous(), i8, sb, False, 16, kb)[0])
    for bn in (1, 8, 64, 2048):
        assert torch.equal(qm.plane_launch(x, i8, sb, False, bn, kb)[0], out), bn
        assert torch.equal(qm.plane_launch(x, paired, sb, True, bn, kb)[0], out), bn


# ragged byte arrays: rows and words that fill no CTA, N % 4 == 0 (whole words)
BYTE_SHAPES = [(256, 512), (100, 68), (33, 260), (1, 4)]


@pytest.mark.parametrize("r,n", BYTE_SHAPES)
def test_kernels_w_x_bytes(cuda, r, n):
    """Kernels W and X's byte ops equal their plain versions exactly."""
    from blama_tpu_torch.ops import probes

    g = torch.Generator(device=cuda).manual_seed(r + n)
    x = torch.randint(0, 256, (r, n), generator=g, dtype=torch.uint8, device=cuda)
    assert torch.equal(probes.swar_roundtrip(x), x)
    lo, hi = probes.swar_lo_hi(x)
    plo, phi = probes.swar_lo_hi_plain(x)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    assert torch.equal(probes.u8_bitops(x), probes.u8_bitops_plain(x))
    assert torch.equal(probes.i16_bitops(x), probes.i16_bitops_plain(x))
    with pytest.raises(ValueError):
        probes.swar_lo_hi(x[:, :n - 1] if n > 4 else x.t().contiguous()[:, :1])


@pytest.mark.parametrize("m,k,n", [(32, 256, 512), (5, 100, 68), (1, 33, 260), (32, 2048, 1024),
                                   (17, 64, 132)])
def test_kernels_w_x_int8_dots(cuda, m, k, n):
    """The three int8 dots equal their plain versions exactly (K not a whole
    staging tile, N not a whole CTA, M below 32), and the swar dot equals
    the int8 dot on the unpacked operand."""
    from blama_tpu_torch.ops import probes

    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randint(-127, 127, (m, k), generator=g, dtype=torch.int8, device=cuda)
    a2 = torch.randint(-127, 127, (m, 2 * k), generator=g, dtype=torch.int8, device=cuda)
    b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8, device=cuda)
    c = torch.randint(0, 256, (k, n), generator=g, dtype=torch.uint8, device=cuda)
    assert torch.equal(probes.i8_dot(a, b), probes.i8_dot_plain(a, b))
    sw = probes.swar_dot(a, c)
    assert torch.equal(sw, probes.swar_dot_plain(a, c))
    lo, hi = probes.swar_lo_hi_plain(c)
    assert torch.equal(sw, probes.i8_dot(a, (lo + hi).contiguous()))
    assert torch.equal(probes.unpack_dot(a2, c), probes.unpack_dot_plain(a2, c))
    assert torch.equal(probes.i8_dot(a, b), probes.i8_dot(a, b))


def test_kernel_y(cuda):
    """Every probe of kernel Y equals its plain version exactly on the
    probe's input (random normal, ones for the scratch store)."""
    from blama_tpu_torch.ops import probes
    from blama_tpu_torch.tools.probe_casts import probe_input

    for name, shape_in, shape_out, _ in probes.CASTS:
        x = torch.from_numpy(probe_input(name, shape_in)).to(cuda)
        out = probes.cast(name, x)
        assert tuple(out.shape) == shape_out
        assert torch.equal(out, probes.cast_plain(name, x)), name
        assert torch.equal(out.cpu(), probes.cast_plain(name, x.cpu())), name


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_tp_blocks_on_the_card(cuda, tmp_path, dtype):
    """The tp-eligible tiny fixture at tp_blocks = 4 on the card: kernels L
    (and M, A for q4k_a8) and no other matmul kernel, a same-backend replay
    of exactly 1.0, and the port on the CPU verifying the card's record
    within the cross-backend thresholds."""
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
    from blama_tpu_torch.testing import TP_TINY_SPEC, write_tiny_llama

    path = str(tmp_path / "tp.gguf")
    write_tiny_llama(path, spec=TP_TINY_SPEC)
    prompt = None

    def run(dev, preds=None):
        nonlocal prompt
        m = Model(path, ModelParams(dtype=dtype, tp_blocks=4, device=dev))
        inst = Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8"))
        s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
        # 20 prompt tokens: a chunk of more than 16 rows (kernel L for q4k_a8)
        prompt = prompt or m.vocab.tokenize("hello world the cat sat " * 4, True, True)[:20]
        s.set_initial_prompt(prompt)
        out = s.fill_ctx(preds) if preds else s.complete(CompleteParams(max_tokens=8))
        m.close()
        return out

    kernels.reset_launches()
    preds = run("cuda")
    want = {"q4k_parts_matmul"} | ({"w4a8_parts_gemv", "w4a8_gemv"} if dtype == "q4k_a8"
                                   else set())
    matmuls = {k for k, v in kernels.LAUNCHES.items() if v and "attention" not in k}
    assert matmuls == want, kernels.LAUNCHES
    for dev, exact in (("cuda", True), ("cpu", False)):
        agg, sims = MetricsAggregator(), []
        for a, b in zip(preds, run(dev, preds), strict=True):
            sc = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
            sims.append(LogitComparer.logit_similarity(a.logits, b.logits))
        if exact:
            assert (sc, min(sims)) == (1.0, 1.0)
        else:
            assert sc >= 0.95 and sum(sims) / len(sims) >= 0.98, (sc, sims)


def test_bank_id_outside_the_bank_gives_nan(cuda):
    bank = _bank(2, 64, 256, 1, True, cuda)
    eids = torch.tensor([1, 5], dtype=torch.int32, device=cuda)
    for rows in (1, 4, 20):
        x = _acts(rows, 256, torch.bfloat16, cuda)
        out = qm.bank_matmul(x, bank, eids)
        assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all(), rows


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_moe_on_the_card(cuda, tmp_path, dtype):
    """The Mixtral-family fixture on the card: a prover session replayed at
    exactly 1.0 through kernels J / K, and the routed decode step equal to
    the same token in a padded masked chunk where the kernels alone decide
    (the FFN of one layer)."""
    from blama_tpu_torch.models import moe
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.testing import synthesize_moe_gguf

    path = str(tmp_path / "m.gguf")
    synthesize_moe_gguf(path, "mixtral-debug")
    m = Model(path, ModelParams(dtype=dtype, attn="xla"))
    assert isinstance(m.weights["layers"][0]["w_gate_exps"], qm.QuantExperts)
    kernels.reset_launches()
    inst = Instance(m, InstanceInitParams(ctx_size=64, kv_dtype="int8"))
    runs = []
    for replay in (False, True):
        s = inst.start_session(SessionInitParams(seed=3, temperature=0.0))
        s.set_initial_prompt([1, 300, 301, 302, 303, 304, 305])
        runs.append(s.fill_ctx(runs[0]) if replay else s.complete(CompleteParams(max_tokens=8)))
        inst.stop_session()
    assert [[(t.token, t.logit) for t in p.logits] for p in runs[0]] == \
        [[(t.token, t.logit) for t in p.logits] for p in runs[1]]
    bank_kernels = ("w4a8_bank_gemv",) if dtype == "q4k_a8" else ("q4k_bank_matmul",)
    assert all(kernels.LAUNCHES[k] > 0 for k in bank_kernels), kernels.LAUNCHES
    st = moe.MoEStatic.of(m.config)
    h = _acts(8, m.config.n_embd, torch.bfloat16, cuda)[None]
    masked = moe.moe_ffn_quant(h, m.weights["layers"][1], st)
    for t in range(8):
        routed = moe.moe_ffn_quant(h[:, t:t + 1].contiguous(), m.weights["layers"][1], st)
        assert torch.equal(routed, masked[:, t:t + 1]), t
    # the whole layer stack: a token's logits decoded routed at one row equal
    # its row in a padded 4- and 8-row chunk, on an empty cache and after a
    # 5-token prefix, on bf16 and INT8 stores
    for kv in ("bfloat16", "int8"):
        for prefix in (0, 5):
            one = moe_token_logits(m, 1, kv, prefix)
            for T in (4, 8):
                assert torch.equal(moe_token_logits(m, T, kv, prefix), one), (kv, prefix, T)


def moe_token_logits(m, T, kv, prefix):
    """Logits of token 7 at position `prefix` after `prefix` prompt tokens,
    fed as row 0 of a T-row chunk whose other rows are pads (slot past the
    cache: dropped): at T = 1 the routed decode step, above it the masked
    chunk."""
    from blama_tpu_torch.models import moe
    from blama_tpu_torch.ops import kv_cache as kvc

    cfg, dev = m.config, m.device
    st = moe.MoEStatic.of(cfg)
    S = 64
    cache = kvc.KVCache.create(cfg.n_layer, 1, S, cfg.n_head_kv, cfg.head_dim_, kv, device=dev)
    if prefix:
        ids = torch.arange(prefix, dtype=torch.int32, device=dev)[None]
        moe.forward(m.weights, st, ids + 300, ids, ids, cache,
                    torch.tensor([prefix - 1], device=dev))
    toks = torch.zeros((1, T), dtype=torch.int32, device=dev)
    toks[0, 0] = 7
    pos = torch.zeros((1, T), dtype=torch.int32, device=dev)
    pos[0, 0] = prefix
    slots = torch.full((1, T), S, dtype=torch.int32, device=dev)
    slots[0, 0] = prefix
    return moe.forward(m.weights, st, toks, pos, slots, cache,
                       torch.zeros(1, dtype=torch.long, device=dev))[0]


@pytest.mark.parametrize("k,n", [(128, 4096), (448, 4096), (4096, 8), (128, 32000),
                                 (4096, 1024)])
def test_rows_mm_gives_a_row_its_bits_on_the_card(cuda, k, n):
    """rows_mm (the exact engines' min term, the MoE router): a row's bits do
    not depend on the row count or on its place among the rows, for a
    contiguous and a transposed weight."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randn((130, k), generator=g, device=cuda)
    for b in (torch.randn((k, n), generator=g, device=cuda),
              torch.randn((n, k), generator=g, device=cuda).t()):
        full = qm.rows_mm(a, b)
        for i in (0, 5, 16, 129):
            assert torch.equal(qm.rows_mm(a[i:i + 1], b), full[i:i + 1]), i
        for M in (1, 4, 8, 17):
            assert torch.equal(qm.rows_mm(a[:M], b), full[:M]), M


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_fused_k4", "q4k_a8_k4", "q4k_a8_xla",
                                   "q8_0_fused", "q6_k_fused"])
def test_engines_on_the_card(cuda, tmp_path, dtype):
    """Each engine on the tiny fixture on the card: a same-backend replay
    scores exactly 1.0 and the port on the CPU (plain versions) verifies the
    card's record within the cross-backend thresholds."""
    from blama_tpu_torch.gguf import GGMLType
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
    from blama_tpu_torch.testing import write_tiny_llama

    quant = {"q8_0_fused": GGMLType.Q8_0, "q6_k_fused": GGMLType.Q6_K}.get(dtype, GGMLType.Q4_K)
    path = str(tmp_path / "t.gguf")
    write_tiny_llama(path, quant)

    def session(dev):
        m = Model(path, ModelParams(dtype=dtype, device=dev))
        inst = Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8"))
        s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
        s.set_initial_prompt(m.vocab.tokenize("hello world the cat sat", True, True))
        return m, s

    def score(preds, replayed):
        agg, sc, sims = MetricsAggregator(), 0.0, []
        for a, b in zip(preds, replayed, strict=True):
            sc = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
            sims.append(LogitComparer.logit_similarity(a.logits, b.logits))
        return sc, sum(sims) / len(sims)

    m, s = session("cuda")
    preds = s.complete(CompleteParams(max_tokens=10))
    m.close()
    m, s = session("cuda")
    assert score(preds, s.fill_ctx(preds)) == (1.0, 1.0)
    m.close()
    m, s = session("cpu")
    sc, sim = score(preds, s.fill_ctx(preds))
    assert sc >= 0.95 and sim >= 0.98, (sc, sim)
    m.close()


def _cache(b, s, hkv, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(-127, 128, (b, s, hkv, d), generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (b, s, hkv, d), generator=g, dtype=torch.int8)
    ks = torch.rand((b, s, hkv), generator=g) * 0.02 + 1e-3
    vs = torch.rand((b, s, hkv), generator=g) * 0.02 + 1e-3
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    pos[:, 3::7] = -1
    pos[0, s // 2:] = -1                   # row 0 half empty
    pos[-1, 5] = 10 * s                    # a slot ahead of every query
    return [t.to(device) for t in (k, v, ks, vs, pos)]


@pytest.mark.parametrize("b,h,hkv,d,s", [(1, 4, 2, 64, 64), (2, 8, 2, 128, 96),
                                         (1, 32, 8, 128, 2048)])
def test_kernel_c(cuda, b, h, hkv, d, s):
    k, v, ks, vs, pos = _cache(b, s, hkv, d, seed=s, device=cuda)
    inv, _ = da.effective_inv_freq(d, d, 10000.0)
    inv = inv.to(cuda)
    q = torch.randn((b, 1, h, d), generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16).to(cuda)
    q_pos = torch.full((b,), s - 9, dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs)
    ref = da.flash_attention_plain(q, k, v, q_pos[:, None], pos, inv, ks, vs, d ** -0.5)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs))


@pytest.mark.parametrize("b,t,h,hkv,d,s", [(1, 8, 4, 2, 64, 64), (2, 16, 8, 2, 128, 96),
                                           (1, 24, 32, 8, 128, 256)])
def test_kernel_d(cuda, b, t, h, hkv, d, s):
    k, v, ks, vs, pos = _cache(b, s, hkv, d, seed=t, device=cuda)
    inv, _ = da.effective_inv_freq(d, d, 10000.0)
    inv = inv.to(cuda)
    q = torch.randn((b, t, h, d), generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16).to(cuda)
    qp = (torch.arange(t, dtype=torch.int32) + s // 3).repeat(b, 1).to(cuda)
    out = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs)
    ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, d ** -0.5)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, da.prefill_attention(q, k, v, qp, pos, inv, ks, vs))


def _bf16_cache(b, s, hkv, d, seed, device):
    k, v, _, _, pos = _cache(b, s, hkv, d, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    k, v = (torch.randn(k.shape, generator=g).to(torch.bfloat16).to(device) for _ in range(2))
    return k, v, pos


@pytest.mark.parametrize("b,t,h,hkv,d,s", [(1, 1, 4, 2, 64, 64), (3, 1, 8, 2, 128, 96),
                                           (2, 8, 8, 2, 256, 64), (1, 24, 32, 8, 128, 256)])
def test_kernels_c_d_bf16(cuda, b, t, h, hkv, d, s):
    k, v, pos = _bf16_cache(b, s, hkv, d, seed=s + t, device=cuda)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, t, h, d), generator=torch.Generator().manual_seed(3)) \
        .to(torch.bfloat16).to(cuda)
    qp = (torch.arange(t, dtype=torch.int32) + s // 3).repeat(b, 1).to(cuda)
    run = (lambda: da.decode_attention(q, k, v, qp[:, 0], pos, inv)) if t == 1 else \
        (lambda: da.prefill_attention(q, k, v, qp, pos, inv))
    out = run()
    _close(out, da.flash_attention_plain(q, k, v, qp, pos, inv, None, None, d ** -0.5),
           ATTN_TOL)
    assert torch.equal(out, run())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,g,d", [(1, 32, 64), (1, 128, 128), (8, 32, 128), (16, 64, 64)])
def test_kernels_e_f_equal_dense(cuda, int8, t, g, d):
    """Paged kernels on a scrambled pool: within tolerance of the plain
    version and bit-identical to the dense kernels over the gathered rows;
    an unmapped row gives zeros."""
    b, h, hkv, mp, p = 3, 8, 2, 4, 20
    gen = torch.Generator().manual_seed(t + g + d)
    if int8:
        kp, vp = (torch.randint(-127, 128, (p, g, hkv, d), generator=gen, dtype=torch.int8)
                  .to(cuda) for _ in range(2))
        ksp, vsp = ((torch.rand((p, g, hkv), generator=gen) * 0.02 + 1e-3).to(cuda)
                    for _ in range(2))
    else:
        kp, vp = (torch.randn((p, g, hkv, d), generator=gen).to(torch.bfloat16).to(cuda)
                  for _ in range(2))
        ksp = vsp = None
    lens = [3 * g + 5, 0, g - 1]
    perm = torch.randperm(p, generator=gen).tolist()
    table = torch.full((b, mp), -1, dtype=torch.int32)
    pool_pos = torch.randint(0, 50, (p, g), generator=gen, dtype=torch.int32)
    for r, n in enumerate(lens):
        for lp in range(-(-n // g)):
            page = perm.pop()
            table[r, lp] = page
            s = torch.arange(lp * g, (lp + 1) * g, dtype=torch.int32)
            pool_pos[page] = torch.where(s < n, s, -1)
    pool_pos[table[0, 1], 3:9] = -1
    table, pool_pos = table.to(cuda), pool_pos.to(cuda)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, t, h, d), generator=gen).to(torch.bfloat16).to(cuda)
    qp = torch.stack([torch.arange(t, dtype=torch.int32) + max(n - t, 0) for n in lens]).to(cuda)
    slot_map = pkv.view_slot_map(table, g)
    mapped = torch.repeat_interleave(table >= 0, g, dim=1)
    pos_v = torch.where(mapped, pool_pos.reshape(-1)[slot_map], -1).to(torch.int32).contiguous()
    gather = lambda a: None if a is None else \
        a.reshape(-1, *a.shape[2:])[slot_map].contiguous()   # noqa: E731
    kd, vd, ksd, vsd = gather(kp), gather(vp), gather(ksp), gather(vsp)
    if t == 1:
        out = pa.paged_decode_attention(q, kp, vp, pool_pos, table, qp[:, 0], inv, ksp, vsp)
        dense = da.decode_attention(q, kd, vd, qp[:, 0], pos_v, inv, ksd, vsd)
    else:
        out = pa.paged_prefill_attention(q, kp, vp, pool_pos, table, qp, inv, ksp, vsp)
        dense = da.prefill_attention(q, kd, vd, qp, pos_v, inv, ksd, vsd)
    _close(out, pa.paged_attention_plain(q, kp, vp, pool_pos, table, qp, inv, ksp, vsp,
                                         d ** -0.5), ATTN_TOL)
    assert torch.equal(out, dense)
    assert (out[1] == 0).all()


def _store(kv, b, s, hkv, d, seed, device):
    """A KVCache of one layer on `device` holding random rows of store type
    `kv` (int8 codes and scales, bf16 or f32 values) and _cache's positions."""
    from blama_tpu_torch.ops import kv_cache as kvc

    k, v, ks, vs, pos = _cache(b, s, hkv, d, seed, device)
    if kv != "int8":
        g = torch.Generator().manual_seed(seed + 1)
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[kv]
        k, v = (torch.randn(k.shape, generator=g).to(dt).to(device) for _ in range(2))
        ks = vs = None
    lift = lambda t: None if t is None else t[None]   # noqa: E731
    return kvc.KVCache(k[None], v[None], pos, lift(ks), lift(vs))


def _fresh_step(cache, slots, seed):
    """This step's bf16 K/V rows [B, Hkv, D] and query, each row's position
    written at its slot (a pad slot >= S writes the spare slot), and the
    query positions."""
    B, S, Hkv, D = cache.k.shape[1:]
    dev = cache.device
    g = torch.Generator().manual_seed(seed)
    kn, vn = (torch.randn((B, Hkv, D), generator=g).to(torch.bfloat16).to(dev)
              for _ in range(2))
    slot = torch.tensor(slots, dtype=torch.int32, device=dev)
    q_pos = torch.where(slot < S, slot, 0)
    cache.pos_store[cache.flat_slots(slot[:, None])] = q_pos
    return kn, vn, slot, q_pos


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b,h,hkv,d,s,slots", [
    (1, 32, 8, 128, 2048, [1700]), (3, 8, 2, 128, 96, [40, 96, 95]),
    (2, 4, 2, 64, 64, [0, 63]), (2, 16, 4, 256, 128, [127, 31])])
def test_kernels_n_p_equal_c_after_write(cuda, kv, b, h, hkv, d, s, slots):
    """N on the unwritten cache (the slot holding garbage) and P on it give
    kernel C's output after the cache write bit for bit, and P leaves the
    store the write leaves (the spare slot too, with one pad row)."""
    from blama_tpu_torch.ops import kernels

    ref_c = _store(kv, b, s, hkv, d, seed=s + d, device=cuda)
    kn, vn, slot, q_pos = _fresh_step(ref_c, slots, seed=b + d)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, 1, h, d), generator=torch.Generator().manual_seed(4)) \
        .to(torch.bfloat16).to(cuda)
    n_c, p_c = _store(kv, b, s, hkv, d, seed=s + d, device=cuda), \
        _store(kv, b, s, hkv, d, seed=s + d, device=cuda)
    for c in (n_c, p_c):
        c.pos_store.copy_(ref_c.pos_store)
    ref_c.write(0, ref_c.flat_slots(slot[:, None].long()), kn[:, None], vn[:, None])
    scales = lambda c: (c.k_scale[0], c.v_scale[0]) if c.quantized else (None, None)  # noqa
    ref = da.decode_attention(q, ref_c.k[0], ref_c.v[0], q_pos, ref_c.positions, inv,
                              *scales(ref_c))
    kernels.reset_launches()
    out_n = da.decode_attention(q, n_c.k[0], n_c.v[0], q_pos, n_c.positions, inv,
                                *scales(n_c), k_new=kn, v_new=vn, slot=slot)
    qs = lambda c: (c.k_scale_store[0], c.v_scale_store[0]) if c.quantized \
        else (None, None)                                           # noqa: E731
    out_p = da.decode_attention_write(q, p_c.k_store[0], p_c.v_store[0], q_pos,
                                      p_c.positions, inv, kn, vn, slot, *qs(p_c))
    assert kernels.LAUNCHES["decode_attention_fresh"] == 1
    assert kernels.LAUNCHES["decode_attention_write"] == 1
    assert kernels.LAUNCHES["decode_attention"] == 0
    assert torch.equal(out_n, ref) and torch.equal(out_p, ref)
    live = slice(None) if sum(x >= s for x in slots) <= 1 else slice(0, b * s)
    for a, r in ((p_c.k_store, ref_c.k_store), (p_c.v_store, ref_c.v_store),
                 (p_c.k_scale_store, ref_c.k_scale_store),
                 (p_c.v_scale_store, ref_c.v_scale_store)):
        assert a is None or torch.equal(a[:, live], r[:, live])
    _close(out_n, da.fresh_attention_plain(q, n_c.k[0], n_c.v[0], q_pos[:, None],
                                           n_c.positions, inv, kn, vn, slot, *scales(n_c),
                                           d ** -0.5), ATTN_TOL)


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b,h,hkv,d,s", [(1, 32, 8, 128, 2048), (2, 8, 2, 128, 256),
                                         (1, 16, 4, 256, 512), (1, 64, 8, 128, 1024)])
def test_kernel_o(cuda, monkeypatch, kv, b, h, hkv, d, s):
    """Head-batched decode (H > 32 heads loop over the warps) within the
    tolerance of its plain version; two launches give the same bits."""
    from blama_tpu_torch.ops import kernels

    monkeypatch.setattr(da, "_HB", True)
    c = _store(kv, b, s, hkv, d, seed=s + h, device=cuda)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, 1, h, d), generator=torch.Generator().manual_seed(5)) \
        .to(torch.bfloat16).to(cuda)
    q_pos = torch.full((b,), s - 9, dtype=torch.int32, device=cuda)
    sc = (c.k_scale[0], c.v_scale[0]) if c.quantized else (None, None)
    kernels.reset_launches()
    out = da.decode_attention(q, c.k[0], c.v[0], q_pos, c.positions, inv, *sc)
    assert kernels.LAUNCHES["decode_attention_hb"] == 1
    assert kernels.LAUNCHES["decode_attention"] == 0
    _close(out, da.flash_attention_plain(q, c.k[0], c.v[0], q_pos[:, None], c.positions,
                                         inv, *sc, d ** -0.5), ATTN_TOL)
    assert torch.equal(out, da.decode_attention(q, c.k[0], c.v[0], q_pos, c.positions,
                                                inv, *sc))


@pytest.mark.parametrize("t,g,d", [(1, 32, 64), (1, 128, 128), (8, 64, 256), (16, 32, 128)])
def test_kernels_c_to_f_on_f32(cuda, t, g, d):
    """An f32 store: C and D within tolerance of the plain version, E and F
    on a scrambled pool equal to C and D over the gathered rows."""
    b, h, hkv, mp, p = 2, 8, 2, 4, 12
    gen = torch.Generator().manual_seed(t * g + d)
    kp, vp = (torch.randn((p, g, hkv, d), generator=gen).to(cuda) for _ in range(2))
    table = torch.tensor([[7, 2, 9, -1], [4, 11, 0, 5]], dtype=torch.int32)
    pool_pos = torch.full((p, g), -1, dtype=torch.int32)
    lens = [2 * g + 3, 4 * g - 1]
    for r, n in enumerate(lens):
        for lp in range(-(-n // g)):
            s = torch.arange(lp * g, (lp + 1) * g, dtype=torch.int32)
            pool_pos[table[r, lp]] = torch.where(s < n, s, -1)
    table, pool_pos = table.to(cuda), pool_pos.to(cuda)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, t, h, d), generator=gen).to(torch.bfloat16).to(cuda)
    qp = torch.stack([torch.arange(t, dtype=torch.int32) + n - t for n in lens]).to(cuda)
    slot_map = pkv.view_slot_map(table, g)
    mapped = torch.repeat_interleave(table >= 0, g, dim=1)
    pos_v = torch.where(mapped, pool_pos.reshape(-1)[slot_map], -1).to(torch.int32).contiguous()
    kd, vd = (a.reshape(-1, hkv, d)[slot_map].contiguous() for a in (kp, vp))
    if t == 1:
        out = pa.paged_decode_attention(q, kp, vp, pool_pos, table, qp[:, 0], inv)
        dense = da.decode_attention(q, kd, vd, qp[:, 0], pos_v, inv)
    else:
        out = pa.paged_prefill_attention(q, kp, vp, pool_pos, table, qp, inv)
        dense = da.prefill_attention(q, kd, vd, qp, pos_v, inv)
    _close(dense, da.flash_attention_plain(q, kd, vd, qp, pos_v, inv, None, None, d ** -0.5),
           ATTN_TOL)
    assert torch.equal(out, dense)


def test_scheduler_on_the_card(cuda, tmp_path):
    """The tiny fixture through the paged horizon scheduler on the card: a
    row's tokens do not depend on its neighbours or on the layout, and a
    scheduler replay scores exactly 1.0."""
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                                  VerifyRequest)
    from blama_tpu_torch.testing import write_tiny_llama

    path = str(tmp_path / "t.gguf")
    write_tiny_llama(path)
    m = Model(path, ModelParams(dtype="q4k_a8", attn="fused"))
    prompts = [m.vocab.tokenize(t, True, True)
               for t in ("hello world the cat", "the cat sat on the", "president george bush")]

    def run(prompts, **kw):
        sched = ContinuousBatchingScheduler(m, max_batch=4, ctx_size=256, **kw)
        outs = {}
        for i, p in enumerate(prompts):
            sched.submit(GenRequest(prompt=p, max_tokens=8,
                                    sampler_params=SamplerParams(temp=0.0),
                                    on_done=lambda g, i=i: outs.__setitem__(i, g)))
        sched.run_until_idle()
        return sched, [outs[i] for i in range(len(prompts))]

    toks = lambda preds: [[p.token for p in ps] for ps in preds]   # noqa: E731
    sched, paged = run(prompts, paged=True, horizon=4)
    assert toks(run(prompts)[1]) == toks(paged)                     # dense, per token
    assert toks(run(prompts[1:2], paged=True)[1]) == toks(paged)[1:2]   # alone
    got = {}
    sched.submit(VerifyRequest(prompt=prompts[0], predictions=paged[0],
                               on_done=lambda s: got.__setitem__("s", s)))
    sched.run_until_idle()
    assert got["s"] == 1.0
    m.close()
