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
modes' kernels N, O and P, the tools' kernels Q, R, S, T and U to Y, rows_mm,
C to F at f32 queries and the dense engines' products). The last tests drive
each engine (the dense float32 / bfloat16 ones in both attention modes), the
MoE fixture, the tp_blocks mode and the scheduler on the card on the tiny
fixtures.
"""

import numpy as np
import pytest
import torch

from blama_tpu_torch.ops import decode_attention as da
from blama_tpu_torch.ops import paged_attention as pa
from blama_tpu_torch.ops import paged_kv as pkv
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.testing import random_q4k

# tolerances as in chip_smoke.py: f32 sums in another order (matmuls);
# one bf16 rounding flip of the largest output (attention)
MATMUL_TOL = 1e-4
ATTN_TOL = 2.0 ** -7
# x max|ref|: the f32-query instances (f32 q, f32 out, D and F's products on
# both halves of q), far below the bf16 instances' ATTN_TOL, which a kernel
# that rounded q or its output to bf16 would still meet
F32Q_TOL = 1e-4


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


# The W4A8 GEMV (A, I, J, M): one launch, x quantized in the kernel, the
# group dots on int8 tensor cores, one fixed sum order per output. K = 2560
# and 768 end inside a 1024-element stage and a 4096-element x phase, 14336
# takes four phases, N = 300 and 72 end inside a column tile of every split.
def _gemv_weights(kind, n, k, seed, device):
    if kind == "a":
        return _weights(n, k, seed, device)
    return qm.repack_q4k_a8k4(_bytes(n, k, seed, "Q4_K"), n, k, device)


@pytest.mark.parametrize("kind", ["a", "i"])
@pytest.mark.parametrize("n,k,dtype", [(300, 2560, torch.bfloat16), (72, 768, torch.float32)])
def test_w4a8_rows_alone_equal_the_batch(cuda, kind, n, k, dtype):
    """For every M from 1 to 16 each row of the batch equals the row alone
    bit for bit, and the codes the kernel writes when asked equal
    quant_acts' exactly; the main path's call (no codes) gives the same."""
    w = _gemv_weights(kind, n, k, 3, cuda)
    launch = qm.w4a8_launch if kind == "a" else qm.a8k4_launch
    main = qm.w4a8_matmul if kind == "a" else qm.a8k4_matmul
    x = torch.cat([_acts(r + 1, k, dtype, cuda)[-1:] for r in range(16)])
    alone = torch.cat([main(x[r:r + 1].contiguous(), w) for r in range(16)])
    for m in range(1, 17):
        out, xq, xs, sxm = launch(x[:m].contiguous(), w)
        assert torch.equal(out, alone[:m]), m
        assert torch.equal(main(x[:m].contiguous(), w), out), m
        pxq, pxs, psxm = qm.quant_acts(x[:m])
        assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm), m
    plain = qm.w4a8_matmul_plain if kind == "a" else qm.a8k4_matmul_plain
    _close(alone, plain(x, w), MATMUL_TOL)


@pytest.mark.parametrize("m,n,k,dtype", [(1, 300, 768, torch.bfloat16),
                                         (5, 72, 2560, torch.bfloat16),
                                         (9, 300, 14336, torch.bfloat16),
                                         (16, 1000, 4352, torch.float32)])
def test_w4a8_split_moves_no_bit(cuda, m, n, k, dtype):
    """Every residue split of the column plan (gemv_plan's rw) gives A's,
    I's, J's and M's outputs bit for bit, each within the tolerance of its
    plain version; J equals A per expert and M's blocks A on their slices."""
    x = _acts(m, k, dtype, cuda)
    w = _weights(n, k, seed=m, device=cuda)
    k4 = qm.repack_q4k_a8k4(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    bank = _bank(3, n, k, m, True, cuda)
    eids = torch.tensor([2, 0], dtype=torch.int32, device=cuda)
    nb = 2 if k % 512 == 0 else 1
    ref_a = qm.w4a8_matmul(x, w)
    ref_i = qm.a8k4_matmul(x, k4)
    ref_j = qm.w4a8_bank_matmul(x, bank, eids)
    ref_m = qm.a8s_matmul_parts(x, w, nb)
    _close(ref_a, qm.w4a8_matmul_plain(x, w), MATMUL_TOL)
    _close(ref_i, qm.a8k4_matmul_plain(x, k4), MATMUL_TOL)
    _close(ref_j, qm.w4a8_bank_plain(x, bank, eids), MATMUL_TOL)
    for j, e in enumerate((2, 0)):
        assert torch.equal(ref_j[j], qm.w4a8_matmul(x, bank.expert(e)))
    kb = k // nb
    for i in range(nb):
        xi = x[:, i * kb:(i + 1) * kb].contiguous()
        assert torch.equal(ref_m[i], qm.w4a8_matmul(xi, qm.k_slice(w, i, nb, True))), i
    for rw in qm.GEMV_SPLITS:
        assert torch.equal(qm.w4a8_launch(x, w, codes=False, rw=rw)[0], ref_a), rw
        assert torch.equal(qm.a8k4_launch(x, k4, codes=False, rw=rw)[0], ref_i), rw
        assert torch.equal(qm.w4a8_bank_launch(x, bank, eids, codes=False, rw=rw)[0],
                           ref_j), rw
        assert torch.equal(qm.a8s_parts_launch(x, w, nb, codes=False, rw=rw)[0], ref_m), rw


def test_w4a8_lm_head_width(cuda):
    """The 8B lm head's width on f32 x (a CTA walks ~16 column tiles with x
    kept): A and I within the tolerance of their plain versions, each row
    alone equal to its row of 8."""
    n, k = 128256, 4096
    data = random_q4k(np.random.default_rng(5), n, k, k ** -0.5)
    x = _acts(8, k, torch.float32, cuda)
    for w, main, plain in ((qm.repack_q4k_a8s(data, n, k, cuda), qm.w4a8_matmul,
                            qm.w4a8_matmul_plain),
                           (qm.repack_q4k_a8k4(data, n, k, cuda), qm.a8k4_matmul,
                            qm.a8k4_matmul_plain)):
        out = main(x, w)
        _close(out, plain(x, w), MATMUL_TOL)
        assert torch.equal(out[3:4], main(x[3:4].contiguous(), w))


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


# The tiles of B, G, H, K and L against each row computed alone (a one-row
# shape), which takes each output's f32 chain (k ascending from the block's
# first group, the min term after each group): row by row, bit for bit, at every row
# count, ragged and 8B widths, bf16 and f32 x, every tile shape the plan can
# pick (forced). K = 288 (9 groups) ends in a stage of one group and puts the
# bf16 scales of odd columns at 2-byte offsets.
CHAIN_ROWS = (2, 3, 8, 15, 16, 17, 64, 65, 128, 300)
# N = 1, and widths just under, at and over a one-row CTA (32 columns)
CHAIN_WIDTHS = (1, 31, 32, 33, 72, 1000, 1024, 4096)
CHAIN_LOADERS = ("b_bf16", "b_f32", "g32", "g16", "h", "k_shared", "k_per_expert",
                 "l1", "l2", "l8")


def _random_split(n, k, a8, seed, device, experts=0):
    """A split Q4_K weight (or a bank of `experts`) from random codes, scales
    and mins, at any K % 32 == 0."""
    g = torch.Generator().manual_seed(seed)
    lead = (experts,) if experts else ()
    codes = torch.randint(0, 256, (*lead, n, k // 2), generator=g, dtype=torch.uint8)
    dt = torch.bfloat16 if a8 else torch.float32
    scales = (torch.rand((*lead, n, k // 32), generator=g) * 0.02 + 1e-3).to(dt)
    mins = (torch.rand((*lead, n, k // 32), generator=g) * 0.02).to(dt)
    arrays = (codes.to(device), scales.to(device), mins.to(device))
    if experts:
        return qm.QuantExperts(*arrays, a8)
    return (qm.QuantTensorA8S if a8 else qm.QuantTensor)(*arrays)


def _random_q8(n, k, group, seed, device):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(-128, 128, (n, k), generator=g, dtype=torch.int8)
    scales = torch.rand((n, k // group), generator=g) * 0.01 + 1e-3
    return qm.QuantTensorQ8(codes.to(device), scales.to(device), group)


def _chain_case(name, n, device):
    """(K, fn(x, tile) → [n_mat, M, N], bank ids or None) of a loader."""
    if name in ("b_bf16", "b_f32"):
        w = _random_split(n, 288, name == "b_bf16", n, device)
        return 288, lambda x, t: qm.q4k_pos(x, w, tile=t)[None], None
    if name in ("g32", "g16"):
        w = _random_q8(n, 288, 32 if name == "g32" else 16, n, device)
        return 288, lambda x, t: qm.q8_0_matmul(x, w, tile=t)[None], None
    if name == "h":
        w = qm.repack_q4k_native(_bytes(n, 768, n, "Q4_K"), n, 768, device)
        return 768, lambda x, t: qm.q4k_native_matmul(x, w, tile=t)[None], None
    if name.startswith("k_"):
        per = name == "k_per_expert"
        bank = _random_split(n, 288, per, n, device, experts=4)
        eids = torch.tensor([3, 1, 7, 0], dtype=torch.int32, device=device)  # 7: outside

        def bank_fn(x, t):
            # per expert: expert j's own rows, x rolled by j along K
            xs = torch.stack([torch.roll(x, j, dims=1) for j in range(4)]) if per else x
            return qm.q4k_bank_matmul(xs, bank, eids, tile=t)
        return 288, bank_fn, eids
    nb = int(name[1:])
    k = {1: 768, 2: 1024, 8: 2048}[nb]
    w = _random_split(n, k, False, n, device)
    return k, lambda x, t: qm.q4k_matmul_parts(x, w, nb, tile=t), None


@pytest.mark.parametrize("n", CHAIN_WIDTHS)
@pytest.mark.parametrize("name", CHAIN_LOADERS)
def test_tiles_keep_the_one_row_chain(cuda, name, n):
    k, fn, eids = _chain_case(name, n, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(max(CHAIN_ROWS), k, dtype, cuda)
        rows = torch.cat([fn(x[r:r + 1].contiguous(), None) for r in range(x.shape[0])], dim=1)
        if eids is not None:    # the id outside the bank gives NaN, tiles and row alike
            assert torch.isnan(rows[2]).all()
            rows = rows[[0, 1, 3]]
        for m in CHAIN_ROWS:
            for t in range(len(qm.TILES)):
                out = fn(x[:m].contiguous(), t)
                if eids is not None:
                    assert torch.isnan(out[2]).all(), (m, t)
                    out = out[[0, 1, 3]]
                assert torch.equal(out, rows[:, :m]), (dtype, m, t)


@pytest.mark.parametrize("nb", [2, 8])
@pytest.mark.parametrize("n", [72, 1000])
def test_tile_parts_equal_shards(cuda, nb, n):
    """Kernel L's tiles: every K-block's partial equals the tiles on that
    K-slice alone (what a tp device holding it computes), at every tile."""
    k = 256 * nb
    w = _random_split(n, k, False, nb, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        for m in (2, 17, 130):
            x = _acts(m, k, dtype, cuda)
            kb = k // nb
            for t in range(len(qm.TILES)):
                parts = qm.q4k_matmul_parts(x, w, nb, tile=t)
                shards = torch.cat([qm.q4k_matmul_parts(
                    x[:, d * kb:(d + 1) * kb].contiguous(),
                    qm.k_slice(w, d, nb, contiguous=True), 1, tile=t) for d in range(nb)])
                assert torch.equal(shards, parts), (dtype, m, t)


def test_tile_shapes_match_the_plan(cuda):
    """The kernel's tile list and the plan's are one list."""
    import ctypes

    from blama_tpu_torch.ops import kernels

    lib = kernels.lib("quant_matmul")
    for t, shape in enumerate(qm.TILES):
        out = (ctypes.c_int * 2)()
        assert lib.dequant_tile_shape(t, ctypes.addressof(out)) == 0
        assert tuple(out) == shape, t
    assert lib.dequant_tile_shape(len(qm.TILES), ctypes.addressof((ctypes.c_int * 2)())) != 0


# The one-row shapes (ROW_TILES: the tiles' body at one row, a consumer
# warp of 32 chains) on their own: against the plain versions, at the full
# 8B down's K = 14336, with every shape forced (the shape moves no bit), and
# the K-block and expert invariances of L and K at one row.
ROW_CASES = ("b_bf16", "b_f32", "g32", "g16", "h", "k_shared", "k_per_expert", "l1", "l2",
             "l8")


def _row_case(name, n, k, device):
    """(fn(x, row_tile) → [n_mat, 1, N], plain(x) → the same, eids or
    None) of a loader at one row of K = k."""
    if name in ("b_bf16", "b_f32"):
        w = _random_split(n, k, name == "b_bf16", n, device)
        return (lambda x, r: qm.q4k_pos(x, w, row_tile=r)[None],
                lambda x: qm.q4k_pos_plain(x, w)[None], None)
    if name in ("g32", "g16"):
        w = _random_q8(n, k, 32 if name == "g32" else 16, n, device)
        return (lambda x, r: qm.q8_0_matmul(x, w, row_tile=r)[None],
                lambda x: qm.q8_0_matmul_plain(x, w)[None], None)
    if name == "h":
        w = qm.repack_q4k_native(_bytes(n, k, n, "Q4_K"), n, k, device)
        return (lambda x, r: qm.q4k_native_matmul(x, w, row_tile=r)[None],
                lambda x: qm.q4k_native_matmul_plain(x, w)[None], None)
    if name.startswith("k_"):
        per = name == "k_per_expert"
        bank = _random_split(n, k, per, n, device, experts=4)
        eids = torch.tensor([3, 1, 7, 0], dtype=torch.int32, device=device)  # 7: outside

        def xs(x):
            return torch.stack([torch.roll(x, j, dims=1) for j in range(4)]) if per else x
        live = [0, 1, 3]    # the plain version's experts: the ids inside the bank
        return (lambda x, r: qm.q4k_bank_matmul(xs(x), bank, eids, row_tile=r),
                lambda x: qm.q4k_bank_plain(xs(x)[live] if per else x, bank, eids[live]), eids)
    nb = int(name[1:])
    w = _random_split(n, k, False, n, device)
    return (lambda x, r: qm.q4k_matmul_parts(x, w, nb, row_tile=r),
            lambda x: qm.q4k_matmul_parts_plain(x, w, nb), None)


@pytest.mark.parametrize("k", [2048, 14336])
@pytest.mark.parametrize("name", ROW_CASES)
def test_one_row_against_plain(cuda, name, k):
    """Each loader's one row within MATMUL_TOL of its plain version, bf16 and
    f32 x, at K = 2048 and the 8B down's 14336 (the whole chain of a decode
    step's longest product); the id outside the bank gives NaN."""
    fn, plain, eids = _row_case(name, 300, k, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(1, k, dtype, cuda)
        out = fn(x, None)
        if eids is not None:
            assert torch.isnan(out[2]).all()
            out = out[[0, 1, 3]]
        _close(out, plain(x), MATMUL_TOL)
        again = fn(x, None)     # a replay gives the same bits
        assert torch.equal(out, again[[0, 1, 3]] if eids is not None else again)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("n", [1, 31, 33, 255, 257, 1000])
@pytest.mark.parametrize("name", ROW_CASES)
def test_one_row_shape_moves_no_bit(cuda, name, n, ragged):
    """Every one-row shape of ROW_TILES gives the plan's bits, at widths
    under and over a CTA's 32 columns and over several CTAs, on stages that
    K fills (K = 2048) and ragged ones (K = 288: a last stage of one group,
    bf16 scales at 2-byte offsets; H and L at their smallest K)."""
    k = {"h": 768, "l1": 768, "l2": 1024, "l8": 2048}.get(name, 288) if ragged else 2048
    fn, _, eids = _row_case(name, n, k, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(1, k, dtype, cuda)
        ref = fn(x, None)
        for r in range(len(qm.ROW_TILES)):
            out = fn(x, r)
            if eids is not None:
                assert torch.isnan(out[2]).all(), r
                out = out[[0, 1, 3]]
            assert torch.equal(out, ref[[0, 1, 3]] if eids is not None else ref), (dtype, r)


@pytest.mark.parametrize("nb", [2, 8])
@pytest.mark.parametrize("n", [72, 1000])
def test_row_parts_equal_shards(cuda, nb, n):
    """Kernel L at one row: every K-block's partial equals the one-row kernel
    on that K-slice alone (what a tp device holding it computes)."""
    k = 256 * nb * 2
    w = _random_split(n, k, False, nb + 1, cuda)
    kb = k // nb
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(1, k, dtype, cuda)
        parts = qm.q4k_matmul_parts(x, w, nb)
        shards = torch.cat([qm.q4k_matmul_parts(
            x[:, d * kb:(d + 1) * kb].contiguous(), qm.k_slice(w, d, nb, contiguous=True), 1)
            for d in range(nb)])
        assert torch.equal(shards, parts), dtype


@pytest.mark.parametrize("per", [False, True])
def test_row_bank_equals_each_expert_alone(cuda, per):
    """Kernel K at one row: each selected expert's output equals B with the
    min term inside (kernel L at one block) on that expert alone."""
    n, k = 1000, 2048
    bank = _random_split(n, k, False, 5, cuda, experts=4)
    eids = torch.tensor([2, 0, 3], dtype=torch.int32, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = _acts(3, k, dtype, cuda)[:, None] if per else _acts(1, k, dtype, cuda)
        out = qm.q4k_bank_matmul(x, bank, eids)
        for j, e in enumerate(eids.tolist()):
            xj = x[j] if per else x
            assert torch.equal(out[j], qm.q4k_matmul_pinned(xj.contiguous(), bank.expert(e))), \
                (dtype, j)


def test_row_shapes_match_the_plan(cuda):
    """The kernel's one-row shapes (columns, groups a stage, stages,
    producer warps, shared memory for each loader and x type) are the
    plan's; an unknown shape or loader is refused."""
    import ctypes

    from blama_tpu_torch.ops import kernels

    lib = kernels.lib("quant_matmul")
    for t, (bn, sg, stages, pw) in enumerate(qm.ROW_TILES):
        for li, loader in enumerate(qm.ROW_LOADERS):
            for xb in (0, 1):
                out = (ctypes.c_int * 5)()
                assert lib.dequant_row_shape(t, li, xb, ctypes.addressof(out)) == 0
                assert tuple(out) == (bn, sg, stages, pw, qm.row_smem(t, loader, bool(xb))), \
                    (t, loader, xb)
    bad = (ctypes.c_int * 5)()
    assert lib.dequant_row_shape(len(qm.ROW_TILES), 0, 1, ctypes.addressof(bad)) != 0
    assert lib.dequant_row_shape(0, len(qm.ROW_LOADERS), 1, ctypes.addressof(bad)) != 0


def test_row_tile_out_of_range_raises(cuda):
    w = _random_split(64, 256, False, 0, cuda)
    with pytest.raises(ValueError):
        qm.q4k_pos(_acts(1, 256, torch.bfloat16, cuda), w, row_tile=len(qm.ROW_TILES))


def test_tile_out_of_range_raises(cuda):
    w = _random_split(64, 256, False, 0, cuda)
    x = _acts(4, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        qm.q4k_pos(x, w, tile=len(qm.TILES))


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
    """Kernel T: activation codes bit for bit, its lane order bit for bit,
    within tolerance of its plain version and of kernel I's (another
    grouping), two launches equal, row 0 alone equal, bits equal across
    block_n."""
    from blama_tpu_torch import testing

    w = qm.repack_q4k_a8k4(_bytes(n, k, m, "Q4_K"), n, k, cuda)
    x = _acts(m, k, dtype, cuda)
    out, xq, xs, sxm = qm.x2_launch(x, w, 16, kb)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    codes, ws, wm = qm.decode_q4k_blocks(w.codes.view(-1, 144), n)
    order = testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, qm.x2_clamp(k, n, 16, kb)[1])
    assert torch.equal(out, order)
    _close(out, qm.x2_matmul_plain(x, w, 16, kb), MATMUL_TOL)
    _close(out, qm.a8k4_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.x2_launch(x, w, 16, kb)[0])
    assert torch.equal(out[:1], qm.x2_launch(x[:1].contiguous(), w, 16, kb)[0])
    for bn in (1, 8, 2048):
        assert torch.equal(qm.x2_launch(x, w, bn, kb)[0], out), bn


# and the ring's edges: more pieces than slots (the reference's 1024-row
# blocks, 128 pieces), bk below 8 and of 1, bn 16 (256-row slots) and 16384
@pytest.mark.parametrize("r,n,bk,bn", [(64, 256, 16, 128), (100, 1024, 7, 48),
                                       (33, 160, 3, 32), (2048, 14336, 256, 14336),
                                       (512, 4096, 64, 16384 // 4),
                                       (2048, 14336, 1024, 4096), (1024, 4096, 1024, 1024),
                                       (40, 256, 5, 32), (24, 64, 1, 16), (8192, 32, 4096, 16),
                                       (64, 16384, 16, 16384)])
def test_kernel_r_reads_every_byte(cuda, r, n, bk, bn):
    """Kernel R: the first 8 rows of every block summed per column, exactly
    the plain version (columns past the grid 0), and every byte of every
    block staged: the per-column sum of what the CTAs brought on chip equals
    the blocks' own. Under the plan's fill and under each forced one (the
    TMA ring of two slots, which comes round many times, and every thread's
    cp.async), with and without the total."""
    from blama_tpu_torch.ops import probes

    g = torch.Generator(device=cuda).manual_seed(r)
    codes = torch.randint(0, 256, (r, n), generator=g, dtype=torch.uint8, device=cuda)
    ref = probes.stream_plain(codes, bk, bn)
    covered = codes[:r // bk * bk, :n // bn * bn].to(torch.int32).sum(0).float()
    ring = (min(bk, 256, max(1, probes.R_SLOT // bn)), 2)
    for plan in (None, ring, (max(1, probes.R_PIECE // bn), 0)):
        out, tot = probes.stream_launch(codes, bk, bn, total=True, plan=plan)
        assert torch.equal(out, ref), plan
        assert torch.equal(tot[0, :covered.shape[0]], covered), plan
        assert not tot[0, covered.shape[0]:].any()
        assert torch.equal(probes.stream_launch(codes, bk, bn, plan=plan)[0], ref), plan
    assert torch.equal(probes.stream(codes, bk, bn), ref)


@pytest.mark.parametrize("shape", [(8, 128), (1000,), (3, 5), (1,), (3,), (1024,), (1025,),
                                   (1 << 20,)])
def test_kernel_s(cuda, shape):
    from blama_tpu_torch.ops import probes

    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    assert torch.equal(probes.add_one(x), probes.add_one_plain(x))


@pytest.mark.parametrize("n", [1, 3, 1024, 1025])
def test_kernel_s_unaligned(cuda, n):
    """A view that starts 4 bytes into its storage: the scalar path."""
    from blama_tpu_torch.ops import probes

    x = torch.randn(n + 1, generator=torch.Generator().manual_seed(n)).to(cuda)[1:]
    assert x.data_ptr() % 16
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


@pytest.fixture(scope="module")
def u_weights(cuda):
    """Kernel U's operands at K = 14336 for each width of the lane-order test."""
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    k, held = 14336, {}
    for n in (1024, 4096, 1000):
        codes, scales, _ = _ubench_weights(n, k, n, cuda)
        held[n] = pack_pairs(codes), scales
    return k, held


# widths: a wave of CTAs at four columns a warp pair, wk/wv's one column a
# pair, and a width that fills no CTA at either
@pytest.mark.parametrize("n", [1024, 4096, 1000])
@pytest.mark.parametrize("kb", [1, 2, 4, 8])
@pytest.mark.parametrize("m", range(1, 17))
def test_kernel_u_keeps_the_lane_order(cuda, u_weights, m, kb, n):
    """Kernel U at K = 14336 (56 tiles) equals its lane chains bit for bit
    (testing.twodot_lane_order: lane l of a column takes word l of each
    tile, each FMA rounded once, the xor butterfly, the blocks in K order);
    a forced plan (either column count a pair, every slot size that
    divides kb, a two-slot ring that comes round many times) moves no bit."""
    from blama_tpu_torch import testing

    k, held = u_weights
    paired, scales = held[n]
    x = _acts(m, k, torch.float32, cuda)
    out = qm.twodot_launch(x, paired, scales, 8, kb)
    assert torch.equal(out, testing.twodot_lane_order(x, paired, scales, kb))
    for c in (1, 4):
        for s in (t for t in (1, 2, 4) if kb % t == 0):
            assert torch.equal(qm.twodot_launch(x, paired, scales, 8, kb, plan=(c, s, 2)),
                               out), (c, s)


@pytest.mark.parametrize("kb", [4, 8])
def test_kernel_u_keeps_the_lane_order_at_extreme_scales(cuda, kb):
    """Scales of 2^100 and 2^110, inf, NaN, subnormal and -0: U equals its
    lane chains bit for bit (NaN where they are NaN)."""
    from blama_tpu_torch import testing
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    m, n, k = 3, 96, 2048
    codes, scales, _ = _ubench_weights(n, k, kb, cuda)
    scales[3, 5] = 2.0 ** 110
    scales[17, 0] = float("inf")
    scales[40, 9] = float("nan")
    scales[41, 2:6] = 1e-40
    scales[70, 1] = -0.0
    scales[90] = 2.0 ** 100
    paired = pack_pairs(codes)
    x = _acts(m, k, torch.float32, cuda)
    out = qm.twodot_launch(x, paired, scales, 8, kb)
    ref = testing.twodot_lane_order(x, paired, scales, kb)
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.nan_to_num(0.0, float("inf"), float("-inf")),
                       ref.nan_to_num(0.0, float("inf"), float("-inf")))
    assert out[:, 40].isnan().all() and not out[:, 17].isfinite().any()


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


@pytest.fixture(scope="module")
def slab_weights(cuda):
    """Kernels Q's and V's operands for each (N, K) of the lane-order test:
    element-order codes, Q's group-paired pack, V's int8 and tile-paired
    codes, bf16 scales (a third of them negative)."""
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    held = {}
    for n in (1024, 4096, 1000):
        for k in (4096, 14336):
            g = torch.Generator(device=cuda).manual_seed(n + k)
            codes = torch.randint(0, 16, (n, k), generator=g, dtype=torch.uint8, device=cuda)
            sc = torch.rand((n, k // 32), generator=g, device=cuda) * 0.02 + 0.01
            sc = torch.where(torch.rand(sc.shape, generator=g, device=cuda) < 0.3, -sc, sc)
            w = qm.pack_a8s(codes, sc, torch.zeros_like(sc))
            held[n, k] = codes, w, codes.to(torch.int8), pack_pairs(codes), w.scales
    return held


def _forced(monkeypatch, plan):
    """Kernels Q and V launched under `plan` (T, R, D) in place of
    slab_plan's."""
    monkeypatch.setattr(qm, "slab_plan", lambda *args, **kwargs: plan)


# widths: a wave of column groups, wk/wv's 64 tiles of 16 (one CTA of eight
# warps each), and a width that fills no tile
@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("n", [1024, 4096, 1000])
@pytest.mark.parametrize("kb", [1, 2, 4, 8])
@pytest.mark.parametrize("m", range(1, 17))
def test_kernels_q_v_keep_the_lane_order(cuda, slab_weights, monkeypatch, m, kb, n, k):
    """Kernel Q and both of V's loaders equal their lane order bit for bit
    (testing.slab_lane_order: lane l of a column takes groups l, l+32 of a
    slab, part = fmaf(dot * ws, xs, part), the xor butterfly, Q's lo + hi,
    the slabs in K order), under slab_plan's plan and forced ones (one warp,
    tiles of eight warps, four of two, eight of one; the fewest slots each
    takes, so the ring comes round many times)."""
    from blama_tpu_torch import testing

    codes, w, i8, paired, sb = slab_weights[n, k]
    x = _acts(m, k, torch.bfloat16 if m % 2 else torch.float32, cuda)
    out, xq, xs, _ = qm.a8s_launch(x, w, 8, kb)
    assert torch.equal(out, testing.slab_lane_order(xq, xs, codes, sb, kb, 4))
    v = qm.plane_launch(x, i8, sb, False, 8, kb)[0]
    assert torch.equal(v, testing.slab_lane_order(xq, xs, codes, sb, kb, 0))
    assert torch.equal(qm.plane_launch(x, paired, sb, True, 8, kb)[0], v)
    for plan in ((1, 1, 2), (1, 8, 16), (4, 2, 4), (8, 1, 2)):
        _forced(monkeypatch, plan)
        assert torch.equal(qm.a8s_launch(x, w, 8, kb)[0], out), plan
        assert torch.equal(qm.plane_launch(x, i8, sb, False, 8, kb)[0], v), plan
        assert torch.equal(qm.plane_launch(x, paired, sb, True, 8, kb)[0], v), plan


@pytest.mark.parametrize("m", [1, 8, 16])
def test_kernels_q_v_every_plan(cuda, monkeypatch, m):
    """Every plan slab_plan can return (1..8 tiles a CTA with the warps
    left, its slot count, and two slots) and one warp a tile give the same
    bits, kb 3 (three of four quads) and 6 (pairs and singles in one slab)
    included."""
    from blama_tpu_torch import testing
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    n, k = 1000, 6144
    g = torch.Generator(device=cuda).manual_seed(m)
    codes = torch.randint(0, 16, (n, k), generator=g, dtype=torch.uint8, device=cuda)
    sc = torch.rand((n, k // 32), generator=g, device=cuda) * 0.02 + 0.01
    w = qm.pack_a8s(codes, sc, torch.zeros_like(sc))
    x = _acts(m, k, torch.bfloat16, cuda)
    for kb in (3, 6):
        out, xq, xs, _ = qm.a8s_launch(x, w, 8, kb)
        assert torch.equal(out, testing.slab_lane_order(xq, xs, codes, w.scales, kb, 4)), kb
        v = qm.plane_launch(x, pack_pairs(codes), w.scales, True, 8, kb)[0]
        assert torch.equal(v, testing.slab_lane_order(xq, xs, codes, w.scales, kb, 0)), kb
        for int8 in (False, True):
            plans = [qm.slab_plan(m, 128 * 16 * nt, kb, int8, k)
                     for nt in range(1, qm.SG_MAX_WARPS + 1)]
            plans += [(t, r, 2 * r) for t, r, _ in plans] + [(t, 1, 3) for t, _, _ in plans]
            for plan in plans:
                _forced(monkeypatch, plan)
                got = (qm.plane_launch(x, codes.to(torch.int8), w.scales, False, 8, kb)[0]
                       if int8 else qm.a8s_launch(x, w, 8, kb)[0])
                assert torch.equal(got, v if int8 else out), (kb, plan)
            monkeypatch.undo()


@pytest.fixture(scope="module")
def x2_weights(cuda):
    """Kernel T's operands for each (N, K) of its lane-order test: the
    native superblocks (random codes, d, dmin and 6-bit scales and mins, a
    third of the d and dmin negative) and their decoded arrays."""
    from blama_tpu_torch.testing import random_q4k

    held = {}
    for n in (72, 300, 1000):
        for k in (4096, 768, 3072, 14336):
            rng = np.random.default_rng(n + k)
            data = random_q4k(rng, n, k, k ** -0.5).reshape(-1, 144)
            data[rng.random(data.shape[0]) < 0.3, 1] ^= 0x80
            data[rng.random(data.shape[0]) < 0.3, 3] ^= 0x80
            w = qm.repack_q4k_a8k4(data.reshape(-1), n, k, cuda)
            held[n, k] = (w, *qm.decode_q4k_blocks(w.codes.view(-1, 144), n))
    return held


# slabs of 8 and 16 superblocks, whole-K slabs of 3 and 12 (kb clamps to
# them) and a long K; widths that end inside a tile, a CTA and a wave
@pytest.mark.parametrize("k,kb", [(4096, 8), (4096, 16), (768, 8), (3072, 8), (14336, 8)])
@pytest.mark.parametrize("n", [72, 300, 1000])
@pytest.mark.parametrize("m", range(1, 17))
def test_kernel_t_keeps_the_lane_order(cuda, x2_weights, monkeypatch, m, n, k, kb):
    """Kernel T equals its lane order bit for bit (testing.x2_lane_order:
    the parent's lanes (tl, c), part += fma(dot * ws, xs, -(sxm * wm)), the
    xor butterfly over bits 0, 2, 3, 4, lo + hi, the slabs in K order),
    under slab_plan's plan and forced ones (one warp with two slots, a tile
    of eight warps, four of two, eight of one); its one-row output equals
    row 0 of a two-row call."""
    from blama_tpu_torch import testing

    w, codes, ws, wm = x2_weights[n, k]
    kbc = qm.x2_clamp(k, n, 8, kb)[1]
    x = _acts(m, k, torch.bfloat16 if m % 2 else torch.float32, cuda)
    out, xq, xs, sxm = qm.x2_launch(x, w, 8, kb)
    assert torch.equal(out, testing.x2_lane_order(xq, xs, sxm, codes, ws, wm, kbc))
    if m == 2:
        assert torch.equal(qm.x2_launch(x[:1].contiguous(), w, 8, kb)[0], out[:1])
    step = qm.x2_step_slots(kbc)
    for plan in ((1, 1, 2), (1, 8, 8 * step), (4, 2, 2 * step), (8, 1, 2)):
        _forced(monkeypatch, plan)
        assert torch.equal(qm.x2_launch(x, w, 8, kb)[0], out), plan


def test_kernel_t_refuses_a_ring_shorter_than_a_round(cuda, x2_weights, monkeypatch):
    w = x2_weights[300, 4096][0]
    x = _acts(4, 4096, torch.bfloat16, cuda)
    _forced(monkeypatch, (1, 4, 7))     # four warps take two slots each: 8 in a round
    with pytest.raises(RuntimeError):
        qm.x2_launch(x, w, 8, 8)


@pytest.mark.parametrize("m", range(1, 17))
def test_slab_sizes_are_the_kernels(cuda, m):
    """quant_matmul's slot and shared-memory sizes equal slab_gemv.cu's
    (slab_slot_size, slab_smem_size) for each layout (Q's group-paired
    codes, V's int8 and tile-paired ones, T's superblocks), every column
    count of a plan and every plan slab_plan returns at the tools' widths."""
    from blama_tpu_torch.ops import kernels

    lib = kernels.lib("slab_gemv")
    layouts = ((0, False, False), (1, True, False), (2, False, False), (3, False, True))
    for code, int8, x2 in layouts:
        for t in range(1, qm.SG_MAX_WARPS + 1):
            assert lib.slab_slot_size(m, code, 16 * t) == qm.slab_slot_bytes(m, 16 * t, int8, x2)
        for n in (72, 1000, 1024, 4096, 14336, 128256):
            for k, kbs in ((4096, (1, 4, 8, 16)), (14336, (8, 56)), (3072, (3, 12))):
                for kb in kbs:
                    if (x2 and (k // 256 % kb or kb % 8 and kb != k // 256)) or (
                            not x2 and kb > 8):
                        continue
                    plan = qm.slab_plan(m, n, kb, int8, k, x2)
                    assert lib.slab_smem_size(m, code, *plan, k) == qm.slab_smem(
                        m, plan, int8, k, x2), (code, n, k, kb, plan)


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
                                   (17, 64, 132), (32, 2048, 14336), (16, 2048, 1024),
                                   (17, 2048, 1024), (16, 161, 4), (32, 161, 4), (3, 257, 260)])
def test_kernels_w_x_int8_dots(cuda, m, k, n):
    """The three int8 dots equal their plain versions exactly: the 8B code
    plane (2048 x 14336), M = 16 (the second m16 tile all zero rows) and M
    = 17 and 32 (rows in both tiles), K = 32n + 1 (inside a k32 step and a
    stage), N = 4 and N not a whole CTA;
    the swar dot equals the int8 dot on the unpacked operand, and a second
    launch gives the same bits."""
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


@pytest.mark.parametrize("where", ["fresh", "reused", "unaligned"])
def test_kernel_y(cuda, where):
    """Every probe of kernel Y equals its plain version exactly on the
    probe's input (random normal, ones for the scratch store): through the
    wrapper into a fresh output, and through the launch itself into a reused
    output full of NaN (every element is written) and on input and output
    that are not 16-byte aligned (single-float loads)."""
    from blama_tpu_torch.ops import kernels, probes
    from blama_tpu_torch.tools.probe_casts import probe_input

    for probe, (name, shape_in, shape_out, _) in enumerate(probes.CASTS, start=1):
        x = torch.from_numpy(probe_input(name, shape_in)).to(cuda)
        if where == "fresh":
            got = probes.cast(name, x)
        else:
            n_out, pad = int(np.prod(shape_out)), int(where == "unaligned")
            if pad:
                xb = torch.empty(x.numel() + 1, device=cuda)
                xb[1:] = x.reshape(-1)
                x = xb[1:].view(shape_in)
            got = torch.full((n_out + pad,), float("nan"), device=cuda)[pad:].view(shape_out)
            rc = kernels.lib("probes").casts_launch(probe, x.data_ptr(), got.data_ptr(),
                                                    kernels.stream_ptr(x.device))
            kernels.check(rc, f"casts_{name}")
        assert tuple(got.shape) == shape_out
        assert torch.equal(got, probes.cast_plain(name, x)), name
        assert torch.equal(got.cpu(), probes.cast_plain(name, x.cpu())), name


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
@pytest.mark.parametrize("t,g,d", [(1, 32, 64), (1, 128, 128), (8, 32, 128), (16, 64, 64),
                                   (1, 128, 96), (1, 128, 100), (8, 128, 80)])
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
    (2, 4, 2, 64, 64, [0, 63]), (2, 16, 4, 256, 128, [127, 31]),
    (2, 66, 2, 128, 640, [300, 639]), (2, 64, 1, 256, 512, [511, 512])])
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


# kernel O's geometries: the 8B shape; D = 256 at H32 / Hkv8, where the
# first O's buffers cut the tile to 16 slots (hb_tile); 64 query heads over
# one kv head (sixteen CTAs of 4 heads); an int8 store at Hkv 1 takes
# 2048-slot blocks (64 tiles in series); 16 slots, a split shorter than a
# tile
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b,h,hkv,d,s", [(1, 32, 8, 128, 2048), (2, 8, 2, 128, 256),
                                         (1, 16, 4, 256, 512), (1, 64, 8, 128, 1024),
                                         (1, 32, 8, 256, 1024), (1, 64, 1, 128, 4096),
                                         (1, 32, 8, 128, 16)])
def test_kernel_o(cuda, monkeypatch, kv, b, h, hkv, d, s):
    """Head-batched decode within the tolerance of its plain version; two
    launches give the same bits."""
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


def _o_inputs(kv, b, h, hkv, d, s, cuda):
    c = _store(kv, b, s, hkv, d, seed=s + h + d, device=cuda)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    q = torch.randn((b, 1, h, d), generator=torch.Generator().manual_seed(6)) \
        .to(torch.bfloat16).to(cuda)
    q_pos = torch.tensor([s - 9 - 37 * r for r in range(b)], dtype=torch.int32, device=cuda)
    k, v = c.k[0], c.v[0]
    ks, vs = (c.k_scale[0], c.v_scale[0]) if c.quantized else (None, None)
    return q, k, v, ks, vs, c.positions, q_pos, inv


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("h,hkv,d,s", [(32, 8, 128, 2048), (32, 8, 256, 1024),
                                       (64, 1, 128, 1024), (64, 8, 128, 1024)])
def test_kernel_o_row_alone_equals_the_batch(cuda, monkeypatch, kv, h, hkv, d, s):
    """Kernel O's bits of a row depend on the row alone: each row of a batch
    of 4 equals the same row decoded alone, with torch.equal (at 64 query
    heads, a kv head's heads over 2 or 16 CTAs)."""
    monkeypatch.setattr(da, "_HB", True)
    q, k, v, ks, vs, pos, q_pos, inv = _o_inputs(kv, 4, h, hkv, d, s, cuda)
    out = da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs)
    for r in range(4):
        one = slice(r, r + 1)
        alone = da.decode_attention(q[one], k[one], v[one], q_pos[one], pos[one].contiguous(),
                                    inv, None if ks is None else ks[one],
                                    None if vs is None else vs[one])
        assert torch.equal(alone, out[one]), r


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("h,hkv,d,s", [(32, 8, 128, 2048), (32, 8, 256, 1024)])
def test_kernel_o_unseen_slots_are_not_read(cuda, monkeypatch, kv, h, hkv, d, s):
    """A block (split) with no visible slot, a tile with none and single
    slots the query cannot see: O within the tolerance of its plain version,
    and the same bits when every unseen slot holds NaN (values and
    scales), since such a slot is staged as zeros without being read."""
    monkeypatch.setattr(da, "_HB", True)
    q, k, v, ks, vs, pos, q_pos, inv = _o_inputs(kv, 2, h, hkv, d, s, cuda)
    chunk = da.hb_split(s, d, hkv, k.dtype, 2)
    ts = da.hb_tile(h, hkv, d)
    pos = pos.clone()
    pos[0, chunk:2 * chunk] = -1                   # row 0: its second block unseen
    pos[1, 3 * ts:5 * ts] = 10 * s                 # row 1: two tiles past the query
    out = da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs)
    _close(out, da.flash_attention_plain(q, k, v, q_pos[:, None], pos, inv, ks, vs,
                                         d ** -0.5), ATTN_TOL)
    unseen = (pos < 0) | (pos > q_pos[:, None])
    nan_of = lambda t: t.masked_fill(unseen[..., None, None], float("nan"))  # noqa: E731
    if kv == "int8":
        k2, v2 = k, v
        ks2, vs2 = (t.masked_fill(unseen[..., None], float("nan")) for t in (ks, vs))
    else:
        k2, v2, ks2, vs2 = nan_of(k), nan_of(v), None, None
    assert torch.equal(da.decode_attention(q, k2, v2, q_pos, pos, inv, ks2, vs2), out)


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


# the head geometries the reference's fused gates admit beyond the 8B one:
# head dims that are not a padded width (Phi-2's 80, Phi-3's 96,
# open_llama_3b's 100; and 98, whose int8 rows are aligned to a pair only)
# and more than 32 query heads per kv head (65: two head slices in prefill)
NEW_GEOMETRIES = [(32, 8, 80), (32, 8, 96), (32, 8, 100), (8, 2, 98), (33, 1, 128),
                  (64, 1, 128), (66, 2, 64), (65, 1, 64)]


def _pool_of(kd, vd, ksd, vsd, pos, gsz, seed):
    """The dense rows [B, S, ...] scattered over a pool of `gsz`-slot pages
    in a random order (unmapped pages past each row's length; the spare pages
    hold live-looking positions): (k, v, ks, vs, pool_pos, table) and the
    logical positions the pool gives."""
    b, s = pos.shape
    mp = s // gsz
    dev = kd.device
    n_pages = b * mp + 4
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(seed)).tolist()
    table = torch.full((b, mp), -1, dtype=torch.int32)
    kp, vp = (torch.zeros((n_pages, gsz, *kd.shape[2:]), dtype=kd.dtype, device=dev)
              for _ in range(2))
    ksp = vsp = None
    if ksd is not None:
        ksp, vsp = (torch.zeros((n_pages, gsz, kd.shape[2]), device=dev) for _ in range(2))
    pool_pos = torch.randint(0, s, (n_pages, gsz), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    for r in range(b):
        last = int((pos[r] >= 0).nonzero().max()) if (pos[r] >= 0).any() else -1
        for lp in range(last // gsz + 1):
            page = perm.pop()
            table[r, lp] = page
            sl = slice(lp * gsz, (lp + 1) * gsz)
            kp[page], vp[page], pool_pos[page] = kd[r, sl], vd[r, sl], pos[r, sl]
            if ksp is not None:
                ksp[page], vsp[page] = ksd[r, sl], vsd[r, sl]
    table = table.to(dev)
    mapped = torch.repeat_interleave(table >= 0, gsz, dim=1)
    return (kp, vp, ksp, vsp, pool_pos, table), torch.where(mapped, pos, -1).contiguous()


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("h,hkv,d", NEW_GEOMETRIES)
def test_kernels_c_to_f_at_new_head_geometries(cuda, kv, h, hkv, d):
    """C and D within ATTN_TOL of the plain version at every new head
    geometry, on each store; E and F on a scrambled pool equal C and D over
    the same logical rows bit for bit; two runs give the same bits."""
    b, s, gsz = 3, 768, 128
    lens = [700, 0, 300]
    k, v, ks, vs, pos = _prefill_store(kv, b, s, hkv, d, lens, seed=d + h, device=cuda)
    pool, pos = _pool_of(k, v, ks, vs, pos, gsz, seed=h)
    inv = da.effective_inv_freq(d, d, 10000.0)[0].to(cuda)
    for t in (1, 16):
        q, qp = _prefill_queries(b, t, h, d, lens, seed=t + d, device=cuda)
        ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, d ** -0.5)
        if t == 1:
            out = da.decode_attention(q, k, v, qp[:, 0], pos, inv, ks, vs)
            paged = pa.paged_decode_attention(q, *pool[:2], pool[4], pool[5], qp[:, 0], inv,
                                              *pool[2:4])
            again = da.decode_attention(q, k, v, qp[:, 0], pos, inv, ks, vs)
        else:
            out = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs)
            paged = pa.paged_prefill_attention(q, *pool[:2], pool[4], pool[5], qp, inv,
                                               *pool[2:4])
            again = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs)
        torch.cuda.synchronize()
        _close(out, ref, ATTN_TOL)
        assert torch.equal(out, paged) and torch.equal(out, again)
        assert (out[1] == 0).all()


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("h,hkv,d", [(32, 8, 128), (32, 8, 64), (16, 4, 256), (32, 8, 100),
                                     (66, 2, 128)])
def test_decode_row_invariance(cuda, kv, h, hkv, d):
    """Kernels C and E: a row decoded alone equals the same row among 8 rows
    bit for bit, and equals itself with S padded from 2048 to 4096 with empty
    (random) slots; within ATTN_TOL of the plain version."""
    s = 2048
    k, v, ks, vs, pos = _prefill_store(kv, 8, s, hkv, d, PREFILL_LENS, seed=d + 3, device=cuda)
    inv = da.effective_inv_freq(d, d, 500000.0)[0].to(cuda)
    q, qp = _prefill_queries(8, 1, h, d, PREFILL_LENS, seed=d + 4, device=cuda)
    qp = qp[:, 0].contiguous()
    out = da.decode_attention(q, k, v, qp, pos, inv, ks, vs)
    torch.cuda.synchronize()
    _close(out, da.flash_attention_plain(q, k, v, qp[:, None], pos, inv, ks, vs, d ** -0.5),
           ATTN_TOL)
    row = lambda a: None if a is None else a[5:6].contiguous()   # noqa: E731
    assert torch.equal(da.decode_attention(row(q), row(k), row(v), row(qp), row(pos), inv,
                                           row(ks), row(vs)), out[5:6])

    def padded(a):
        if a is None:
            return None
        extra = torch.full_like(a[5:6], -1) if a.dtype == torch.int32 else \
            (torch.rand_like(a[5:6].float()) * 100).to(a.dtype)
        return torch.cat([a[5:6], extra], dim=1).contiguous()

    assert torch.equal(da.decode_attention(row(q), padded(k), padded(v), row(qp), padded(pos),
                                           inv, padded(ks), padded(vs)), out[5:6])
    pool, pos_v = _pool_of(k, v, ks, vs, pos, 128, seed=d)
    paged = pa.paged_decode_attention(q, *pool[:2], pool[4], pool[5], qp, inv, *pool[2:4])
    assert torch.equal(paged, da.decode_attention(q, k, v, qp, pos_v, inv, ks, vs))
    one = pa.paged_decode_attention(row(q), *pool[:2], pool[4], row(pool[5]), row(qp), inv,
                                    *pool[2:4])
    assert torch.equal(one, paged[5:6])


@pytest.mark.parametrize("split", [64, 128, 512, 1024, 2048])
def test_decode_split_width_for_measuring(cuda, split):
    """The wrappers' `split=` (the split sweep's): every width within
    ATTN_TOL of the plain version and replayed bit for bit; E equals C at
    each width."""
    h, hkv, d, s = 32, 8, 128, 2048
    k, v, ks, vs, pos = _prefill_store("int8", 8, s, hkv, d, PREFILL_LENS, seed=9, device=cuda)
    inv = da.effective_inv_freq(d, d, 500000.0)[0].to(cuda)
    q, qp = _prefill_queries(8, 1, h, d, PREFILL_LENS, seed=10, device=cuda)
    qp = qp[:, 0].contiguous()
    out = da.decode_attention(q, k, v, qp, pos, inv, ks, vs, split=split)
    _close(out, da.flash_attention_plain(q, k, v, qp[:, None], pos, inv, ks, vs, d ** -0.5),
           ATTN_TOL)
    assert torch.equal(out, da.decode_attention(q, k, v, qp, pos, inv, ks, vs, split=split))
    pool, pos_v = _pool_of(k, v, ks, vs, pos, 128, seed=split)
    assert torch.equal(
        pa.paged_decode_attention(q, *pool[:2], pool[4], pool[5], qp, inv, *pool[2:4],
                                  split=split),
        da.decode_attention(q, k, v, qp, pos_v, inv, ks, vs, split=split))


def _prefill_store(kv, b, s, hkv, d, lens, seed, device):
    """Rows of a store of type `kv` at the given lengths, with holes, a run
    of empty slots wider than a tile between visible ones, and slots placed
    past every query; random K / V in the empty slots too."""
    g = torch.Generator().manual_seed(seed)
    if kv == "int8":
        k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = ((torch.rand((b, s, hkv), generator=g) * 0.02 + 1e-3) for _ in range(2))
    else:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[kv]
        k, v = (torch.randn((b, s, hkv, d), generator=g).to(dt) for _ in range(2))
        ks = vs = None
    pos = torch.full((b, s), -1, dtype=torch.int32)
    for r, n in enumerate(lens):
        pos[r, :n] = torch.arange(n, dtype=torch.int32)
    pos[:, 5::29] = -1
    pos[:, 300:450] = -1
    pos[:, 700:720] = 10 * s
    return [None if t is None else t.to(device) for t in (k, v, ks, vs, pos)]


def _prefill_queries(b, t, h, d, lens, seed, device, dtype=torch.bfloat16):
    q = torch.randn((b, t, h, d), generator=torch.Generator().manual_seed(seed)) \
        .to(dtype).to(device)
    qp = torch.stack([torch.arange(t, dtype=torch.int32) + max(n - t, 0) for n in lens])
    return q, qp.to(device)


PREFILL_LENS = [300, 0, 1500, 2047, 129, 1700, 256, 1000]


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_prefill_chunk_batch_and_length_invariance(cuda, kv, d):
    """Kernel D's contract at the 8B head geometry (H 32, Hkv 8, S 2048): a
    T = 128 chunk equals the same queries as 16 chunks of 8; a row alone
    equals the same row at place 5 of the 8-row batch; a row at S = 2048
    equals it padded to S = 4096 with empty (random) slots; two runs give the
    same bits; within ATTN_TOL of the plain version."""
    h, hkv, s, t = 32, 8, 2048, 128
    k, v, ks, vs, pos = _prefill_store(kv, 8, s, hkv, d, PREFILL_LENS, seed=d, device=cuda)
    inv = da.effective_inv_freq(d, d, 500000.0)[0].to(cuda)
    q, qp = _prefill_queries(8, t, h, d, PREFILL_LENS, seed=d + 1, device=cuda)
    out = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs)
    torch.cuda.synchronize()
    _close(out, da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, d ** -0.5), ATTN_TOL)
    assert torch.equal(out, da.prefill_attention(q, k, v, qp, pos, inv, ks, vs))
    chunks = [da.prefill_attention(q[:, i:i + 8].contiguous(), k, v,
                                   qp[:, i:i + 8].contiguous(), pos, inv, ks, vs)
              for i in range(0, t, 8)]
    assert torch.equal(torch.cat(chunks, dim=1), out)
    row = lambda a: None if a is None else a[5:6].contiguous()   # noqa: E731
    alone = da.prefill_attention(row(q), row(k), row(v), row(qp), row(pos), inv,
                                 row(ks), row(vs))
    assert torch.equal(alone, out[5:6])

    def padded(a, fill):
        if a is None:
            return None
        extra = fill(a[5:6]) if a.dtype != torch.int32 else torch.full_like(a[5:6], -1)
        return torch.cat([a[5:6], extra], dim=1).contiguous()

    rnd = lambda a: (torch.rand_like(a.float()) * 100).to(a.dtype)   # noqa: E731
    long = da.prefill_attention(row(q), padded(k, rnd), padded(v, rnd), row(qp),
                                padded(pos, None), inv, padded(ks, rnd), padded(vs, rnd))
    assert torch.equal(long, out[5:6])


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_prefill_paged_equals_dense(cuda, kv, d):
    """Kernel F on a scrambled pool of 128-slot pages equals kernel D over
    the gathered rows bit for bit at T = 8 and 128 (the idle row zero), and
    both stay within ATTN_TOL of the plain version."""
    h, hkv, gsz, mp = 32, 8, 128, 16
    s = mp * gsz
    lens = PREFILL_LENS
    kd, vd, ksd, vsd, pos = _prefill_store(kv, 8, s, hkv, d, lens, seed=d + 7, device=cuda)
    n_pages = 8 * mp + 8
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(d)).tolist()
    table = torch.full((8, mp), -1, dtype=torch.int32)
    kp, vp = (torch.zeros((n_pages, gsz, hkv, d), dtype=kd.dtype, device=cuda)
              for _ in range(2))
    ksp = vsp = None
    if ksd is not None:
        ksp, vsp = (torch.zeros((n_pages, gsz, hkv), device=cuda) for _ in range(2))
    pool_pos = torch.randint(0, s, (n_pages, gsz), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1)).to(cuda)
    for r, n in enumerate(lens):
        for lp in range(-(-n // gsz)):
            page = perm.pop()
            table[r, lp] = page
            sl = slice(lp * gsz, (lp + 1) * gsz)
            kp[page], vp[page], pool_pos[page] = kd[r, sl], vd[r, sl], pos[r, sl]
            if ksp is not None:
                ksp[page], vsp[page] = ksd[r, sl], vsd[r, sl]
    table = table.to(cuda)
    mapped = torch.repeat_interleave(table >= 0, gsz, dim=1)
    pos_v = torch.where(mapped, pos, -1).to(torch.int32).contiguous()
    inv = da.effective_inv_freq(d, d, 500000.0)[0].to(cuda)
    for t in (8, 128):
        q, qp = _prefill_queries(8, t, h, d, lens, seed=t + d, device=cuda)
        out = pa.paged_prefill_attention(q, kp, vp, pool_pos, table, qp, inv, ksp, vsp)
        dense = da.prefill_attention(q, kd, vd, qp, pos_v, inv, ksd, vsd)
        torch.cuda.synchronize()
        assert torch.equal(out, dense)
        assert (out[1] == 0).all()
        _close(out, pa.paged_attention_plain(q, kp, vp, pool_pos, table, qp, inv, ksp, vsp,
                                             d ** -0.5), ATTN_TOL)


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


# -- the step and the loops as CUDA graphs (ops/step_graph.py) ---------------------

GRAPH_PROMPT = [1, 77, 205, 219, 149, 164, 91, 162]
GRAPH_ENGINES = {"q4k_a8": "Q4_K", "q4k_fused": "Q4_K", "q4k_fused_k4": "Q4_K",
                 "q4k_a8_k4": "Q4_K", "q4k_a8_xla": "Q4_K", "q8_0_fused": "Q8_0",
                 "q6_k_fused": "Q6_K"}


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    from blama_tpu_torch.gguf import GGMLType
    from blama_tpu_torch.testing import TP_TINY_SPEC, synthesize_moe_gguf, write_tiny_llama

    d = tmp_path_factory.mktemp("graphs")
    out = {}
    for q in ("Q4_K", "Q8_0", "Q6_K"):
        out[q] = str(d / f"{q}.gguf")
        write_tiny_llama(out[q], GGMLType[q])
    out["d128"] = str(d / "d128.gguf")
    write_tiny_llama(out["d128"], GGMLType.Q4_K, spec=TP_TINY_SPEC)
    out["moe"] = str(d / "moe.gguf")
    synthesize_moe_gguf(out["moe"], "mixtral-debug")
    return out


@pytest.fixture
def graph_checks(monkeypatch):
    """Every loop's replays run under torch.cuda.set_sync_debug_mode("error"),
    in chunks of 4 steps (so a loop crosses the copy-out of a chunk)."""
    from blama_tpu_torch.ops import step_graph as sg

    monkeypatch.setattr(sg, "CHECK_SYNC", True)
    monkeypatch.setattr(sg, "LOOP_CHUNK", 4)


def _set_attn_mode(monkeypatch, mode):
    from blama_tpu_torch.ops import generate_loop as gl

    monkeypatch.setattr(gl, "_WRITE_IN_KERNEL", mode == "write")
    monkeypatch.setattr(gl, "_FRESH_OPERAND", mode == "fresh")
    monkeypatch.setattr(da, "_HB", mode == "hb")


def _graphs_equal_eager(m, kv):
    """Every logit, token, top-10 entry and stored bit of the graphed steps
    and loops equals the eager launches', with torch.equal, and the launch
    counters read the same (testing.graphs_equal_eager)."""
    from blama_tpu_torch.testing import graphs_equal_eager

    launches = graphs_equal_eager(m, kv, GRAPH_PROMPT, 6, ctx=64)
    assert sum(launches.values()) > 0


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("dtype", list(GRAPH_ENGINES))
def test_graphs_equal_eager_on_every_engine(cuda, graph_files, graph_checks, dtype, kv):
    """Every logit, token, top-10 entry and stored bit of the graphed step
    and loops equals the eager launches', with torch.equal, and the launch
    counters read the same."""
    from blama_tpu_torch.runtime.model import Model, ModelParams

    m = Model(graph_files[GRAPH_ENGINES[dtype]], ModelParams(dtype=dtype))
    _graphs_equal_eager(m, kv)
    m.close()


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["write", "fresh", "hb"])
def test_graphs_equal_eager_in_every_mode(cuda, graph_files, graph_checks, monkeypatch, mode, kv):
    from blama_tpu_torch.runtime.model import Model, ModelParams

    if mode == "fresh" and kv != "int8":
        pytest.skip("fresh mode reads an INT8 store only (the reference's gate)")
    _set_attn_mode(monkeypatch, mode)
    m = Model(graph_files["d128"], ModelParams(dtype="q4k_a8"))
    _graphs_equal_eager(m, kv)
    m.close()


@pytest.mark.parametrize("which", ["moe q4k_a8", "moe q4k_fused", "tp q4k_a8", "tp q4k_fused"])
def test_graphs_equal_eager_on_moe_and_tp_blocks(cuda, graph_files, graph_checks, which):
    from blama_tpu_torch.runtime.model import Model, ModelParams

    kind, dtype = which.split()
    if kind == "moe":
        m = Model(graph_files["moe"], ModelParams(dtype=dtype))
    else:
        m = Model(graph_files["d128"], ModelParams(dtype=dtype, tp_blocks=4))
    _graphs_equal_eager(m, "int8")
    m.close()


@pytest.mark.parametrize("horizon", [0, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("which", ["llama", "moe"])
def test_graphed_scheduler_equals_eager(cuda, graph_files, graph_checks, which, paged, horizon):
    """The scheduler's per-token step (a graph at (max_batch, 1)) and its
    horizon loop, on the llama and the MoE fixture: the eager scheduler's
    tokens and top-10 logits, and its launch counts; its verify rows score
    1.0."""
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                                  VerifyRequest)

    m = Model(graph_files["Q4_K" if which == "llama" else "moe"], ModelParams(dtype="q4k_a8"))
    prompts = [GRAPH_PROMPT, [1, 230, 17, 44, 231], [1, 9, 200, 280, 12, 13, 14, 15, 16, 17]]

    def run(graphs):
        kernels.reset_launches()
        sched = ContinuousBatchingScheduler(m, max_batch=4, ctx_size=128, paged=paged,
                                            page_size=16, horizon=horizon, graphs=graphs)
        outs, scores = {}, {}
        for i, p in enumerate(prompts):
            sched.submit(GenRequest(prompt=p, max_tokens=9, sampler_params=SamplerParams(temp=0.0),
                                    on_done=lambda g, i=i: outs.__setitem__(i, g)))
        sched.run_until_idle()
        for i, p in enumerate(prompts):
            sched.submit(VerifyRequest(prompt=p, predictions=outs[i],
                                       on_done=lambda s, i=i: scores.__setitem__(i, s)))
        sched.run_until_idle()
        torch.cuda.synchronize()
        recs = [[(q.token, [(t.token, t.logit) for t in q.logits]) for q in outs[i]]
                for i in range(len(prompts))]
        return recs, scores, dict(kernels.LAUNCHES)

    eager, graphed = run(False), run(True)
    assert eager[0] == graphed[0] and eager[2] == graphed[2]
    assert set(graphed[1].values()) == {1.0}
    m.close()


@pytest.mark.parametrize("edit", ["context-shift", "self-extend", "restore"])
def test_graphed_replays_after_cache_edits(cuda, graph_files, edit):
    """Context shift (kv_seq_rm / kv_seq_add) and Self-Extend (kv_seq_add /
    kv_seq_div) edit the positions in place between replays; restore_cache
    builds new stores, captured anew. Each run equals its eager twin."""
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams

    m = Model(graph_files["Q4_K"], ModelParams(dtype="q4k_a8"))

    def run(graphs):
        ctx, ga = (32, 1) if edit == "context-shift" else (64, 2 if edit == "self-extend" else 1)
        inst = Instance(m, InstanceInitParams(ctx_size=ctx, kv_dtype="int8", graphs=graphs,
                                              fast_greedy=edit == "restore"))
        s = inst.start_session(SessionInitParams(seed=3, temperature=0.0, ga_factor=ga,
                                                 ga_width=16))
        s.set_initial_prompt(GRAPH_PROMPT)
        preds = s.complete(CompleteParams(max_tokens=12))
        if edit == "restore":
            state = s.get_state()
            inst.stop_session()
            s = inst.start_session(SessionInitParams(seed=3, temperature=0.0))
            s.set_state(state)
            if graphs:
                assert inst.graphs.keys() == []     # the old stores' graphs dropped
        preds += s.complete(CompleteParams(max_tokens=30 if edit != "restore" else 8))
        inst.stop_session()
        return [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds]

    assert run(True) == run(False)
    m.close()


def test_capture_outlives_a_dropped_graph(cuda):
    """A capture while a dropped graph waits in a reference cycle, as a
    dropped Instance's StepGraphs does: a collection that frees that graph
    inside the capture breaks the capture, so none runs inside one. Inside
    the capture the collector's threshold is 1, so a collection of the
    young cycle comes due at once."""
    import gc

    from blama_tpu_torch.ops.step_graph import CudaBackend

    be = CudaBackend(cuda)
    x = torch.zeros(1024, device=cuda)
    dropped = be.capture(lambda: x.add_(1))
    gc.collect()
    cycle = {"graph": dropped}
    cycle["self"] = cycle
    del cycle, dropped
    out, inside = [], []
    threshold = gc.get_threshold()

    def fn():
        inside.append(gc.isenabled())
        gc.set_threshold(1)
        out.append([[] for _ in range(100)])
        out.append(x + 1)

    try:
        graph = be.capture(fn)
    finally:
        gc.set_threshold(*threshold)
    graph.replay()
    torch.cuda.synchronize()
    assert inside == [False] and gc.isenabled()
    assert torch.equal(out[1], torch.ones_like(x))


def test_sync_between_replays_raises(cuda, graph_checks):
    """The check the loops run their replays under does catch a host sync
    on this machine."""
    from blama_tpu_torch.ops import step_graph as sg

    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        with sg._no_sync(cuda):
            x.sum().item()
    x.sum().item()


# ---------------------------------------------------------------------------
# the float32 engine: C, D, E and F at f32 queries, the dense products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_query_kernels_c_to_f(cuda, kv, d):
    """The f32-query instances at the 8B head geometry (H 32, Hkv 8, S 2048):
    f32 in, f32 out, within F32Q_TOL of the plain version (f32 queries keep
    their low half in D and F's products), where the bf16 instance on the
    same queries rounded to bf16 falls outside it; a row alone equals the
    row in the 8-row batch (C and D), a T = 128 chunk equals 16 chunks of 8
    (D), E and F on a scrambled pool equal C and D bit for bit; each launch
    counts under its f32 name."""
    from blama_tpu_torch.ops import kernels

    h, hkv, s = 32, 8, 2048
    k, v, ks, vs, pos = _prefill_store(kv, 8, s, hkv, d, PREFILL_LENS, seed=d + 7, device=cuda)
    inv = da.effective_inv_freq(d, d, 500000.0)[0].to(cuda)
    row = lambda a: None if a is None else a[5:6].contiguous()   # noqa: E731
    pool, pos_v = _pool_of(k, v, ks, vs, pos, 128, seed=d + 1)
    kernels.reset_launches()
    refs = []
    for t in (1, 128):
        q, qp = _prefill_queries(8, t, h, d, PREFILL_LENS, seed=d + t, device=cuda,
                                 dtype=torch.float32)
        if t == 1:
            run = lambda q_, k_, v_, p_, pos_, ks_, vs_: da.decode_attention(  # noqa: E731
                q_, k_, v_, p_[:, 0].contiguous(), pos_, inv, ks_, vs_)
            paged = pa.paged_decode_attention(q, *pool[:2], pool[4], pool[5],
                                              qp[:, 0].contiguous(), inv, *pool[2:4])
        else:
            run = lambda q_, k_, v_, p_, pos_, ks_, vs_: da.prefill_attention(  # noqa: E731
                q_, k_, v_, p_, pos_, inv, ks_, vs_)
            paged = pa.paged_prefill_attention(q, *pool[:2], pool[4], pool[5], qp, inv,
                                               *pool[2:4])
        out = run(q, k, v, qp, pos, ks, vs)
        assert out.dtype == torch.float32 and paged.dtype == torch.float32
        ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, d ** -0.5)
        _close(out, ref, F32Q_TOL)
        refs.append((run, q, qp, ref))
        assert torch.equal(out, run(q, k, v, qp, pos, ks, vs))
        assert torch.equal(run(row(q), row(k), row(v), row(qp), row(pos), row(ks), row(vs)),
                           out[5:6])
        assert torch.equal(paged, run(q, k, v, qp, pos_v, ks, vs))
        if t > 1:
            chunks = [run(q[:, i:i + 8].contiguous(), k, v, qp[:, i:i + 8].contiguous(),
                          pos, ks, vs) for i in range(0, t, 8)]
            assert torch.equal(torch.cat(chunks, dim=1), out)
    counts = {n: kernels.LAUNCHES[n] for n in ("decode_attention_f32q", "prefill_attention_f32q",
                                               "paged_decode_attention_f32q",
                                               "paged_prefill_attention_f32q",
                                               "decode_attention", "prefill_attention")}
    assert counts["decode_attention"] == counts["prefill_attention"] == 0, counts
    assert all(counts[n] > 0 for n in counts if n.endswith("_f32q")), counts
    for run, q, qp, ref in refs:   # the control: a bf16-grade answer fails F32Q_TOL
        rounded = run(q.to(torch.bfloat16), k, v, qp, pos, ks, vs).float()
        assert (rounded - ref).abs().max().item() > F32Q_TOL * ref.abs().max().item()


def test_f32_queries_refused_by_n_p_o(cuda):
    """N, P and O have no f32-query instance: they raise, naming the item."""
    kv = _store("f32", 1, 128, 2, 128, seed=3, device=cuda)
    q = torch.randn((1, 1, 4, 128), device=cuda)
    inv = da.effective_inv_freq(128, 128, 10000.0)[0].to(cuda)
    kn = torch.zeros((1, 2, 128), dtype=torch.bfloat16, device=cuda)
    slot = torch.zeros((1,), dtype=torch.int32, device=cuda)
    qp = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="item 9"):
        da.decode_attention(q, kv.k[0], kv.v[0], qp, kv.positions, inv, k_new=kn, v_new=kn,
                            slot=slot)
    with pytest.raises(NotImplementedError, match="item 9"):
        da.decode_attention_write(q, kv.k_store[0], kv.v_store[0], qp, kv.positions, inv, kn,
                                  kn, slot)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 14336), (14336, 4096), (4096, 1000)])
def test_dense_products_row_count_invariance(cuda, dtype, k, n):
    """The dense engines' product (quant_matmul.rows_mm): a row's bits are
    the same at 1, 4, 8, 16 and 128 rows, so a decode step and the same
    row in a prompt chunk give the same logits."""
    g = torch.Generator().manual_seed(k + n)
    a = torch.randn((128, k), generator=g).to(dtype).to(cuda)
    w = (torch.randn((k, n), generator=g) / k ** 0.5).to(dtype).to(cuda)
    full = qm.rows_mm(a, w)
    for m in (1, 4, 8, 16):
        assert torch.equal(qm.rows_mm(a[:m], w), full[:m]), m
    assert torch.equal(qm.rows_mm(a[5:6], w), full[5:6])
    _close(full, a.double() @ w.double(), 1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_dense_products_sum_in_f32(cuda):
    """No TF32 for f32 operands: where the caller allows it, an f32 product
    (and the attention chain's) raises and leaves the setting as it was; and
    no bf16 reduction of split-K partials for bf16 operands, with cuBLAS
    allowed one (torch's default): both within f32 rounding of an f64
    product of the same operands, where TF32 or a bf16 reduction would be
    off by orders of magnitude more."""
    from blama_tpu_torch.ops.attention import attention

    g = torch.Generator().manual_seed(0)
    matmul = torch.backends.cuda.matmul
    held = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((16, 14336), generator=g).to(dtype).to(cuda)
        w = torch.randn((14336, 64), generator=g).to(dtype).to(cuda)
        ref = a.double() @ w.double()
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = True, True
        try:
            if dtype == torch.float32:
                with pytest.raises(RuntimeError, match="TF32"):
                    qm.rows_mm(a, w, out_dtype=torch.float32)
                kv = torch.zeros((1, 4, 1, 64), device=cuda)
                with pytest.raises(RuntimeError, match="TF32"):
                    attention(torch.zeros((1, 1, 1, 64), device=cuda), kv, kv,
                              torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                              torch.zeros((1, 4), dtype=torch.int32, device=cuda), 64, 1e4)
                assert matmul.allow_tf32
                matmul.allow_tf32 = False
            out = qm.rows_mm(a, w, out_dtype=torch.float32)
        finally:
            matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = held
        err = (out.double() - ref).abs().max().item() / ref.abs().max().item()
        assert err < 1e-5, (dtype, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["fused", "xla"])
def test_dense_engines_on_the_card(cuda, tmp_path, dtype, attn):
    """The dense engines on the tiny fixture at the reference's defaults
    (f32 KV rows): a prove and a same-backend replay at exactly 1.0; under
    attn="fused" the float32 engine runs the f32-query C and D and the
    bfloat16 engine the bf16 ones; under attn="xla" no attention kernel."""
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
    from blama_tpu_torch.testing import write_tiny_llama

    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama(path)
    m = Model(path, ModelParams(dtype=dtype, attn=attn))
    inst = Instance(m, InstanceInitParams(ctx_size=256))
    kernels.reset_launches()
    runs = []
    for replay in (False, True):
        s = inst.start_session(SessionInitParams(seed=3, temperature=0.0))
        s.set_initial_prompt(list(range(1, 21)))
        runs.append(s.fill_ctx(runs[0]) if replay else s.complete(CompleteParams(max_tokens=8)))
        inst.stop_session()
    agg = MetricsAggregator()
    for o, r in zip(*runs, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
    assert score == 1.0
    sfx = "_f32q" if dtype == "float32" else ""
    names = (f"decode_attention{sfx}", f"prefill_attention{sfx}")
    launched = {n: kernels.LAUNCHES[n] for n in names}
    if attn == "fused":
        assert all(launched.values()), launched
    else:
        assert not any(kernels.LAUNCHES[n] for n in kernels.LAUNCHES if "attention" in n)
    m.close()
