"""The exact dequant GEMM's tile plan (quant_matmul.tile_plan), on the CPU.

The plan picks the tile shape of kernels B, G, H, K and L for more than one
row; the shape moves no bit (the card tests hold every shape equal to the
one-row kernel), so what it must get right is coverage and occupancy: each
output exactly once, the whole K in every CTA, and a wave of CTAs on the
card wherever the output allows one.
"""

import pytest

from blama_tpu_torch.ops import quant_matmul as qm

# (N, products per launch) of the Llama-3-8B projections and lm head, and of
# Mixtral-8x7B's banks over all 8 experts; kernel L's partials at 8 K-blocks
SHAPES = {"wq/wo": (4096, 1), "wk/wv": (1024, 1), "gate/up": (14336, 1), "down": (4096, 1),
          "lm_head": (128256, 1), "moe gate/up": (14336, 8), "moe down": (4096, 8),
          "parts wo": (4096, 8)}
ROWS = range(2, 2049)
SMALLEST = min(range(len(qm.TILES)), key=lambda t: qm.TILES[t][0] * qm.TILES[t][1])


def _cover(M, bm):
    """The row (or column) ranges the grid's CTAs take along one axis."""
    return [(i * bm, min(M, (i + 1) * bm)) for i in range(-(-M // bm))]


@pytest.mark.parametrize("label", SHAPES)
def test_plan_covers_each_output_once(label):
    N, n_mat = SHAPES[label]
    for M in ROWS:
        bm, bn = qm.TILES[qm.tile_plan(M, N, n_mat)]
        for size, tile in ((M, bm), (N, bn)):
            spans = _cover(size, tile)
            assert spans[0][0] == 0 and spans[-1][1] == size
            assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("label", SHAPES)
def test_plan_fills_a_wave_where_the_output_allows(label):
    N, n_mat = SHAPES[label]
    for M in ROWS:
        t = qm.tile_plan(M, N, n_mat)
        allows = qm.tile_ctas(SMALLEST, M, N, n_mat) >= qm.N_SMS
        assert not allows or qm.tile_ctas(t, M, N, n_mat) >= qm.N_SMS, (M, qm.TILES[t])


@pytest.mark.parametrize("label", SHAPES)
def test_plan_never_splits_k(label):
    """A CTA's grid position names rows, columns and a product (K-block or
    expert), never a K range of its own: the launch's third grid dimension
    is n_mat, whatever the tile."""
    N, n_mat = SHAPES[label]
    for M in ROWS:
        t = qm.tile_plan(M, N, n_mat)
        bm, bn = qm.TILES[t]
        assert qm.tile_ctas(t, M, N, n_mat) == -(-M // bm) * -(-N // bn) * n_mat


def test_plan_keeps_tiles_no_taller_than_the_rows_need():
    """At 2..16 rows no 64-row tile computes rows of zeros."""
    for M in range(2, 17):
        for N, n_mat in SHAPES.values():
            assert qm.TILES[qm.tile_plan(M, N, n_mat)][0] <= 16


def test_plan_takes_the_large_tiles_at_the_joint_prefill():
    """2048 rows: 128-row tiles, 128 columns wherever they give a wave."""
    assert qm.TILES[qm.tile_plan(2048, 4096)] == (128, 128)
    assert qm.TILES[qm.tile_plan(2048, 14336)] == (128, 128)
    assert qm.TILES[qm.tile_plan(2048, 1024)] == (128, 64)


def test_forced_tile_is_checked():
    assert qm._tile(None, 8, 4096) == qm.tile_plan(8, 4096)
    assert qm._tile(3, 8, 4096) == 3
    for bad in (-1, len(qm.TILES)):
        with pytest.raises(ValueError):
            qm._tile(bad, 8, 4096)
