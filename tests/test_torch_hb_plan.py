"""Kernel O's plan (decode_attention.hb_tile, hb_plan), on the CPU.

Kernel O (the head-batched decode mode, BLAMA_ATTN_HB) has numerics of its
own: the reference's split (hb_split) and a tile of `ts` slots, one a lane,
at which each query head's online softmax folds. The tile is the port's
first O's: 32 slots, halved while that kernel's one block per (row, split),
over all kv heads, outgrew 227 KB. The redesigned kernel takes a CTA per
(row, kv head, chunk of query heads, split), which moves no bit, and must
keep that tile for every geometry. (The CTA picks its ring from its own
shared memory; the card tests run it at the geometries below.)
"""

import pytest
import torch

from blama_tpu_torch.ops import decode_attention as da

SMEM_MAX = 227 * 1024
STORES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def first_kernels_tile(H, Hkv, D):
    """The first O's tile, transcribed from its launcher (decode_hb_impl
    before the redesign): ts = 32, halved while HbSmem<D>::bytes(H, Hkv, ts)
    = 4 * (2 H D + Hkv ts (D + 1) + 32 H + 3 H + 2 Hkv ts + ts) exceeds 227
    KB; None where even one slot does not fit (it refused the call)."""
    def nbytes(ts):
        return 4 * (2 * H * D + Hkv * ts * (D + 1) + H * 32 + 3 * H + 2 * Hkv * ts + ts)

    ts = 32
    while ts > 1 and nbytes(ts) > SMEM_MAX:
        ts //= 2
    return ts if nbytes(ts) <= SMEM_MAX else None


# (H, Hkv, D) -> the first O's tile: the 8B shape; D = 256 at 32 / 8 heads
# (16); 64 and 33 query heads over one kv head; one query head a kv head at
# 32 kv heads (8); 128 query heads over 8 (16); the card tests' geometries
PINNED = {(32, 8, 128): 32, (32, 8, 256): 16, (64, 1, 128): 32, (33, 1, 128): 32,
          (32, 32, 128): 8, (128, 8, 128): 16, (16, 4, 256): 32, (8, 2, 128): 32,
          (64, 8, 128): 32, (64, 1, 256): 32, (32, 32, 256): 4, (8, 2, 64): 32}


@pytest.mark.parametrize("geom", list(PINNED))
def test_tile_is_the_first_kernels(geom):
    assert da.hb_tile(*geom) == PINNED[geom] == first_kernels_tile(*geom)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_tile_rule_over_head_counts(D):
    """hb_tile equals the first O's rule at every head count up to 256 and
    every kv head count that divides it, and raises where that kernel
    refused."""
    for H in range(1, 257):
        for Hkv in (h for h in range(1, H + 1) if H % h == 0):
            want = first_kernels_tile(H, Hkv, D)
            if want is None:
                with pytest.raises(ValueError):
                    da.hb_tile(H, Hkv, D)
            else:
                assert da.hb_tile(H, Hkv, D) == want, (H, Hkv, D)


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("B,S", [(1, 2048), (8, 2048), (1, 8192)])
def test_plan_at_the_8b_shape(store, B, S, monkeypatch):
    """H32 / Hkv8 / D128 (Llama-3-8B): 32-slot tiles, a CTA per (row, kv
    head, split) with all 4 query heads of the kv head, 512-slot splits:
    32 CTAs a row where the first O had 4."""
    monkeypatch.setattr(da, "_HB", True)
    chunk = da.hb_split(S, 128, 8, STORES[store], B)
    assert chunk == 512
    assert da.hb_plan(B, 32, 8, 128, S, chunk) == (32, 4, (B * 8, S // 512))


def _admitted(monkeypatch):
    """Every (B, S, H, Hkv, D, store, chunk) the reference's gate sends to
    kernel O over a spread of geometries."""
    monkeypatch.setattr(da, "_HB", True)
    for D in (64, 128, 256):
        for Hkv in (1, 2, 4, 8, 16, 32):
            for G in (1, 2, 4, 5, 8, 16, 33, 64):
                for store, dt in STORES.items():
                    for S in (64, 128, 384, 2048, 8192):
                        for B in (1, 8):
                            chunk = da.hb_split(S, D, Hkv, dt, B)
                            if chunk and first_kernels_tile(G * Hkv, Hkv, D):
                                yield B, S, G * Hkv, Hkv, D, store, chunk


def test_plan_covers_each_head_once_wherever_the_gate_admits(monkeypatch):
    """Wherever the gate takes O, the plan keeps the first O's tile, takes
    all of a kv head's query heads up to HB_HEADS a CTA, and its grid covers
    each query head of each row once and each slot in one split."""
    n = 0
    for B, S, H, Hkv, D, store, chunk in _admitted(monkeypatch):
        ts, heads, grid = da.hb_plan(B, H, Hkv, D, S, chunk)
        assert ts == first_kernels_tile(H, Hkv, D)
        assert heads == min(H // Hkv, da.HB_HEADS)
        chunks = grid[0] // (B * Hkv)
        assert chunks * B * Hkv == grid[0] and (chunks - 1) * heads < H // Hkv <= chunks * heads
        assert (grid[1] - 1) * chunk < S <= grid[1] * chunk
        n += 1
    assert n > 500


@pytest.mark.parametrize("geom", [(32, 8, 128), (32, 8, 256), (64, 1, 128)])
def test_plan_reads_no_row_count(geom, monkeypatch):
    """A row's split, tile and head chunks are the same alone and in a batch
    of 4 or 8 (S a multiple of 128): a row decoded alone equals the same
    row in the batch (the card tests hold it with torch.equal)."""
    monkeypatch.setattr(da, "_HB", True)
    H, Hkv, D = geom
    for store, dt in STORES.items():
        for S in (128, 1024, 4096):
            chunks = {da.hb_split(S, D, Hkv, dt, B) for B in (1, 4, 8)}
            assert len(chunks) == 1 and None not in chunks
            chunk = chunks.pop()
            plans = {da.hb_plan(B, H, Hkv, D, S, chunk)[:2] for B in (1, 4, 8)}
            assert len(plans) == 1, (store, S)
            assert da.hb_plan(4, H, Hkv, D, S, chunk).grid[0] == \
                4 * da.hb_plan(1, H, Hkv, D, S, chunk).grid[0]


@pytest.mark.parametrize("g,chunks", [(1, 1), (3, 1), (4, 1), (5, 2), (8, 2), (33, 9),
                                      (64, 16)])
def test_heads_chunk_the_group(g, chunks):
    """A kv head's G query heads go to ceil(G / HB_HEADS) CTAs of up to
    HB_HEADS heads, the last one short; the tile does not move."""
    plan = da.hb_plan(2, 2 * g, 2, 128, 1024, 512)
    assert (plan.ts, plan.heads) == (32, min(g, 4)) and plan.grid == (2 * 2 * chunks, 2)
