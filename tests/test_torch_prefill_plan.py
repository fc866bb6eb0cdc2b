"""Kernels D and F on the CPU: their launch plan, and a torch emulation of
the tensor-core body's roundings against the plain version.

The plan (ops/decode_attention.prefill_plan) packs `tq` query tokens times
the H / Hkv query heads of one kv head into a CTA's MMA rows (row r is token
tq0 + r // g, head hk * g + r % g, for r < min(tq, T - tq0) * g) and splits
each row's slots at multiples of one fixed width. The emulation repeats the
kernel's arithmetic in the order it takes it: K rotated in f32 and kept as
a high and a low bf16 half, V as bf16 (an f32 store's as two halves too),
f32 score sums of both halves, the scale and the K scale per column, online
softmax over 32-slot tiles fixed in logical slots, P times the V scale as a
high and a low bf16 half, splits combined in split order. That the emulation stays within ATTN_TOL of
flash_attention_plain at the 8B head geometry shows, before any card run,
that its bf16 operands fit the tolerance the card tests hold the kernel to;
with one bf16 K and P (`halves=False`) it does not at sharper scores.
"""

import numpy as np
import pytest
import torch

from blama_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

ATTN_TOL = 2.0 ** -7       # x max|ref|: bf16 outputs, as tests/test_torch_cuda_kernels.py


def _cover(B, T, H, Hkv, S):
    """Every (row, token, head) each split's CTAs own, from the plan and the
    kernel's row mapping; and the split boundaries."""
    tq, split, grid = da.prefill_plan(B, T, H, Hkv, S)
    g = H // Hkv
    assert 1 <= tq and tq * g <= da.PREFILL_ROWS
    assert grid[:2] == (B * Hkv, -(-T // tq))
    owned = np.zeros((grid[2], B, T, H), dtype=np.int64)
    for bh in range(grid[0]):
        b, hk = divmod(bh, Hkv)
        for ty in range(grid[1]):
            tq0 = ty * tq
            for r in range(min(tq, T - tq0) * g):
                owned[:, b, tq0 + r // g, hk * g + r % g] += 1
    starts = [sp * split for sp in range(grid[2])]
    return owned, starts, split


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("T", [8, 16, 24, 128, 256, 512])
@pytest.mark.parametrize("B", [1, 8])
def test_plan_covers_each_query_once(B, T, g):
    """Each (row, token, head) of the chunk falls in exactly one CTA of each
    split; split boundaries are multiples of one width, the same for every
    B, T and S, a whole number of tiles, and the splits cover S."""
    Hkv = 8 if g < 8 else 4
    for S in (64, 96, 2048, 4096):
        owned, starts, split = _cover(B, T, g * Hkv, Hkv, S)
        assert (owned == 1).all(), (B, T, g, S)
        assert split == da.PREFILL_SPLIT
        assert split % da.PREFILL_TILE == 0
        assert all(s % split == 0 for s in starts) and starts[0] == 0
        assert starts[-1] < S <= starts[-1] + split


def test_plan_splits_do_not_follow_t_b_or_s():
    """The boundaries a query's slots are cut at are the same logical slots
    in every chunk: a row of S = 2048 has the first four splits of the same
    row padded to S = 4096, at any T and B."""
    ref = _cover(1, 128, 32, 8, 2048)[1]
    for B, T, S in ((8, 8, 2048), (1, 512, 4096), (8, 256, 4096), (1, 24, 2048)):
        starts = _cover(B, T, 32, 8, S)[1]
        assert starts[:len(ref)] == ref[:len(starts)]


def test_plan_takes_only_whole_tiles_as_a_split():
    """A measuring split is a positive multiple of the tile; the plan
    refuses any other width rather than cut a tile."""
    assert da.prefill_plan(1, 128, 32, 8, 2048, split=2048)[2] == (8, 8, 1)
    for bad in (0, da.PREFILL_TILE // 2, da.PREFILL_SPLIT + 1):
        with pytest.raises(ValueError, match="multiple"):
            da.prefill_plan(1, 128, 32, 8, 2048, split=bad)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _halves(x, halves):
    """x as the kernel's bf16 operands: high + low half, or one bf16."""
    hi = _bf16(x)
    return hi + _bf16(x - hi) if halves else hi


def _emulate(q, k, v, q_pos, kv_pos, inv, ks, vs, scale, ts, split, halves=True):
    """The tensor-core body's function, in its roundings and its order."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    theta = kv_pos.float()[..., None] * inv                            # [B, S, D]
    even = torch.arange(D) % 2 == 0
    sin = torch.sin(theta)[:, :, None, :]
    kf = k.float()
    sw = kf.reshape(B, S, Hkv, D // 2, 2).flip(-1).reshape(kf.shape)
    krot = (kf * torch.cos(theta)[:, :, None, :] + sw * torch.where(even, -sin, sin))
    krot = _halves(krot, halves)                                        # staged K
    v_hi = _bf16(v.float())                                             # staged V
    v_lo = _bf16(v.float() - v_hi) if halves and v.dtype == torch.float32 else None
    qf = q.float().reshape(B, T, Hkv, g, D)
    sc = torch.einsum("bthgd,bshd->bhgts", qf, krot) * scale
    if ks is not None:
        sc = sc * ks.permute(0, 2, 1)[:, :, None, None, :]
    vsc = torch.ones((B, Hkv, S)) if vs is None else vs.permute(0, 2, 1)
    mask = (kv_pos[:, None, None, None, :] >= 0) & \
        (kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None])
    parts = []
    for s0 in range(0, S, split):
        m = torch.full((B, Hkv, g, T), da.NEG_INF)
        l = torch.zeros((B, Hkv, g, T))
        acc = torch.zeros((B, Hkv, g, T, D))
        for t0 in range(s0, min(S, s0 + split), ts):
            sl = slice(t0, min(S, t0 + ts))
            mk = mask[..., sl]
            s = torch.where(mk, sc[..., sl], da.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mk, torch.exp(s - m_new[..., None]), 0.0)
            l = alpha * l + p.sum(-1)
            pv = p * vsc[:, :, None, None, sl]
            p_hi = _bf16(pv)
            p_lo = _bf16(pv - p_hi) if halves else torch.zeros_like(pv)
            pvs = [(p_hi, v_hi), (p_lo, v_hi)] + ([] if v_lo is None else [(p_hi, v_lo)])
            acc = alpha[..., None] * acc
            for a_, b_ in pvs:
                acc = acc + torch.einsum("bhgts,bshd->bhgtd", a_, b_[:, sl])
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    lsum, a = torch.zeros_like(l), torch.zeros_like(acc)
    for m, l, acc in parts:
        seen = l > 0                # a split the query cannot see is passed over
        w = torch.where(seen, torch.exp(m - mx), 0.0)
        lsum = lsum + l * w
        a = a + acc * w[..., None]
    out = a / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(torch.bfloat16)


def _store(kv, B, S, Hkv, D, rng):
    if kv == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8))
        ks, vs = (torch.from_numpy(rng.uniform(1e-3, 0.03, (B, S, Hkv)).astype(np.float32))
                  for _ in range(2))
        return k, v, ks, vs
    dt = torch.bfloat16 if kv == "bf16" else torch.float32
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)).to(dt)
            for _ in range(2))
    return k, v, None, None


def _case(kv, sharp, pad=0):
    """The 8B head geometry (H 32, Hkv 8, D 128, rope theta 5e5), scores
    `sharp` times those of unit-variance q and k; row 1 has masked tiles
    between visible ones and slots placed past every query; `pad` empty
    slots after the 1024 (random K and V, position -1)."""
    rng = np.random.default_rng(11)
    B, T, H, Hkv, D, S = 2, 32, 32, 8, 128, 1024 + pad
    k, v, ks, vs = _store(kv, B, S, Hkv, D, rng)
    lens = [700, 1000]
    pos = np.full((B, S), -1, np.int32)
    for b, n in enumerate(lens):
        pos[b, :n] = np.arange(n)
    pos[:, 3:1024:41] = -1
    pos[1, 128:320] = -1                    # six whole tiles masked
    pos[1, 400:410] = 5 * S                 # past every query
    pos = torch.from_numpy(pos)
    q = torch.from_numpy(sharp * rng.standard_normal((B, T, H, D)).astype(np.float32))
    q = q.to(torch.bfloat16)
    qp = torch.from_numpy(np.stack([np.arange(T) + n - T for n in lens]).astype(np.int32))
    inv, _ = da.effective_inv_freq(D, D, 500000.0)
    return q, k, v, qp, pos, inv, ks, vs, D ** -0.5


def _err(out, ref):
    """max |out - ref| in units of ATTN_TOL x max |ref|."""
    return (out.float() - ref.float()).abs().max().item() / (
        ATTN_TOL * ref.float().abs().max().item())


@pytest.mark.parametrize("sharp,pad", [(1.0, 0), (4.0, 0), (1.0, 1024)],
                         ids=["model", "peaked", "padded"])
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
def test_bf16_operands_fit_the_tolerance(kv, sharp, pad):
    """With unit-variance scores, four times sharper ones, and the store
    padded to twice its slots with empty ones, the emulated kernel stays
    within ATTN_TOL of the plain version for every store, at the fixed
    split width and at twice it."""
    args = _case(kv, sharp, pad)
    ref = da.flash_attention_plain(*args)
    for split in (da.PREFILL_SPLIT, 2 * da.PREFILL_SPLIT):
        assert _err(_emulate(*args, da.PREFILL_TILE, split), ref) <= 1.0, split


def test_one_bf16_half_misses_the_tolerance_at_sharp_scores():
    """Why the kernel keeps two bf16 halves of K and P: with one, the same
    emulation leaves ATTN_TOL at four times sharper scores."""
    args = _case("int8", 4.0)
    ref = da.flash_attention_plain(*args)
    assert _err(_emulate(*args, da.PREFILL_TILE, da.PREFILL_SPLIT, halves=False), ref) > 1.0
    assert _err(_emulate(*args, da.PREFILL_TILE, da.PREFILL_SPLIT), ref) <= 1.0
