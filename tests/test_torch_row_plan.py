"""The one-row exact GEMV's plan (quant_matmul.row_plan), on the CPU.

At one row kernels B, G, H, K and L run the exact tiles' body at a one-row
shape of ROW_TILES: one consumer warp runs 32 columns' f32 chains, a thread
each, while producer warps stage and dequantize. The plan picks the shape
per (K-block, N, loader); the shape moves no bit (the card tests hold every
shape equal), so what it must get right is coverage, shared memory and
spread: each column exactly once, a CTA that fits the card's shared memory
for every loader, and a wave of CTAs on the card wherever N allows one.
"""

import inspect

import pytest

from blama_tpu_torch.ops import quant_matmul as qm

# (N, products per launch) of the Llama-3-8B projections and lm head, of
# Mixtral-8x7B's banks over the routed step's two experts and its lm head,
# and kernel L's partials at 8 K-blocks
SHAPES = {"wq/wo": (4096, 1), "wk/wv": (1024, 1), "gate/up": (14336, 1), "down": (4096, 1),
          "lm_head": (128256, 1), "moe gate/up": (14336, 2), "moe down": (4096, 2),
          "moe lm_head": (32000, 1), "parts wo": (4096, 8)}
WIDTHS = list(range(1, 301)) + [N for N, _ in SHAPES.values()]


def _cover(N, cols):
    return [(i * cols, min(N, (i + 1) * cols)) for i in range(-(-N // cols))]


@pytest.mark.parametrize("loader", qm.ROW_LOADERS)
def test_plan_covers_each_column_once(loader):
    for N in WIDTHS:
        for n_mat in (1, 2, 8):
            t = qm.row_plan(4096, N, loader, n_mat)
            spans = _cover(N, qm.ROW_TILES[t][0])
            assert spans[0][0] == 0 and spans[-1][1] == N
            assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:]))
            assert len(spans) * n_mat == qm.row_ctas(t, N, n_mat)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("loader", qm.ROW_LOADERS)
def test_plan_fits_shared_memory(loader, x_bf16):
    """Up to K = 14336 (the 8B and Mixtral down), at every width the plan
    takes, the CTA's ring and converted buffers fit one SM's 227 KB; and
    since x is staged with the weights, no K-block is too long."""
    for kb in range(32, 14337, 32):
        for N, n_mat in SHAPES.values():
            t = qm.row_plan(kb, N, loader, n_mat)
            assert 0 <= t < len(qm.ROW_TILES)
            assert qm.row_smem(t, loader, x_bf16) <= qm.SMEM_MAX, (kb, N, t)
    for t in range(len(qm.ROW_TILES)):
        assert qm.row_smem(t, loader, x_bf16) <= qm.SMEM_MAX


def test_plan_reads_no_row_count():
    """The plan is a function of the K-block, the width, the loader and the
    products: nothing in it can depend on how many rows a call has, so it
    cannot move a row's bits between calls."""
    params = set(inspect.signature(qm.row_plan).parameters)
    assert params == {"kb", "N", "loader", "n_mat"}
    for N, n_mat in SHAPES.values():
        assert qm.row_plan(4096, N, "b_f32", n_mat) == qm.row_plan(4096, N, "b_f32", n_mat)


@pytest.mark.parametrize("loader", qm.ROW_LOADERS)
def test_plan_spreads_a_wave_where_n_allows(loader):
    """Wherever 32-column CTAs give N_SMS of them, the plan launches at least
    N_SMS CTAs; every shape has 32-column CTAs, the most N allows."""
    for kb in (288, 768, 2048, 4096, 14336):
        for N in list(range(1, 9000, 37)) + [N for N, _ in SHAPES.values()]:
            for n_mat in (1, 2, 8):
                t = qm.row_plan(kb, N, loader, n_mat)
                most = -(-N // 32) * n_mat
                assert qm.row_ctas(t, N, n_mat) == most
                assert most < qm.N_SMS or qm.row_ctas(t, N, n_mat) >= qm.N_SMS


def test_plan_at_the_8b_shapes():
    """The deep ring where the CTAs fit two an SM in one wave (wq/wo, wk/wv,
    down, Mixtral's down over two experts), the light one where the columns
    are many (gate/up, the lm head, L's partials of wo at 8 blocks)."""
    for N, n_mat in ((4096, 1), (1024, 1), (4096, 2)):
        assert qm.row_plan(4096, N, "b_f32", n_mat) == 0
    for N, n_mat in ((14336, 1), (128256, 1), (4096, 8), (14336, 2)):
        assert qm.row_plan(4096, N, "min_f32", n_mat) == 1


def test_row_raw_bytes_hold_a_stage():
    """A column's stage holds its codes of SG groups and its scale and min
    words (16-byte units); H's a superblock's header and chunks."""
    codes = {"b_f32": 16, "b_bf16": 16, "min_f32": 16, "min_bf16": 16, "g32": 32, "g16": 32}
    small = {"b_f32": 4, "b_bf16": 2, "min_f32": 8, "min_bf16": 4, "g32": 4, "g16": 8}
    for _, sg, _, _ in qm.ROW_TILES:
        for loader in qm.ROW_LOADERS:
            b = qm.row_raw_bytes(loader, sg)
            assert b % 16 == 0, loader
            if loader == "h":
                assert b == 16 + 32 * ((sg + 1) // 2)
            else:
                assert b >= sg * (codes[loader] + small[loader]), loader


def test_forced_row_tile_is_checked():
    assert qm._plan(None, None, 1, 256, 4096, "b_f32") == qm.row_plan(256, 4096, "b_f32")
    assert qm._plan(None, 1, 1, 256, 4096, "b_f32") == 1
    assert qm._plan(3, None, 8, 256, 4096, "b_f32") == 3    # more rows: the tile
    for bad in (-1, len(qm.ROW_TILES)):
        with pytest.raises(ValueError):
            qm._plan(None, bad, 1, 256, 4096, "b_f32")
    with pytest.raises(ValueError):
        qm.row_plan(256, 4096, "q5_k")
