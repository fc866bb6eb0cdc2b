"""The port's fused attention (plain versions of kernels C and D) and the
two-pass chain against the JAX package, over an INT8 cache with empty
slots (-1) and slots whose positions lie ahead of the queries.

The JAX kernels run in Pallas interpret mode on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.ops import attention as jattn
from blama_tpu.ops import kv_cache as jkv
from blama_tpu.ops.pallas import decode_attention as jda
from blama_tpu_torch.ops import attention as pattn
from blama_tpu_torch.ops import decode_attention as pda
from blama_tpu_torch.ops import kv_cache as pkv
from blama_tpu_torch.ops import paged_attention as ppa

B, S, HKV, H, D = 1, 64, 2, 4, 64


@pytest.fixture(scope="module")
def cache():
    rng = np.random.default_rng(3)
    k = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, S, HKV)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, S, HKV)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None].copy()
    pos[0, 5] = -1            # an empty slot inside the prefix
    pos[0, 44:] = -1          # the unused tail
    pos[0, 30] = 200          # a slot positioned ahead of every query
    return k, v, ks, vs, pos


def _q(t, seed):
    x = np.random.default_rng(seed).standard_normal((B, t, H, D)).astype(np.float32)
    qb = jnp.asarray(x, jnp.bfloat16)
    return qb, torch.from_numpy(np.array(qb.astype(jnp.float32))).to(torch.bfloat16)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# Tolerance: both sides produce bf16 from f32 sums taken in another order
# (online blocks vs one pass), so an element may round to the neighbouring
# bf16 value: one bf16 ulp is 2^-8 of the element, bounded by 2^-8 of the
# largest output. A masking or rope error is a large fraction of it.
def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("q_pos", [35, 43])
def test_decode_plain_matches_jax(cache, q_pos):
    k, v, ks, vs, pos = cache
    qb, qt = _q(1, q_pos)
    inv, mscale = jda.effective_inv_freq(D, D, 10000.0)
    pinv, pmscale = pda.effective_inv_freq(D, D, 10000.0)
    qp = np.array([q_pos], np.int32)
    ref = jda.decode_attention(qb, jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
                               jnp.asarray(pos), inv, k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs), mscale=mscale)
    out = pda.decode_attention(qt, _t(k), _t(v), _t(qp), _t(pos), pinv,
                               k_scale=_t(ks), v_scale=_t(vs), mscale=pmscale)
    assert out.shape == (B, 1, H, D) and out.dtype == torch.bfloat16
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("t", [8, 16])
def test_prefill_plain_matches_jax(cache, t):
    k, v, ks, vs, pos = cache
    qb, qt = _q(t, 100 + t)
    inv, _ = jda.effective_inv_freq(D, D, 10000.0)
    pinv, _ = pda.effective_inv_freq(D, D, 10000.0)
    qp = np.arange(28, 28 + t, dtype=np.int32)[None]
    ref = jda.prefill_attention(qb, jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
                                jnp.asarray(pos), inv, k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs))
    out = pda.prefill_attention(qt, _t(k), _t(v), _t(qp), _t(pos), pinv,
                                k_scale=_t(ks), v_scale=_t(vs))
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_two_pass_chain_matches_jax(cache):
    """The T in {2, 4} route: dequantize, rotate on read, masked softmax."""
    k, v, ks, vs, pos = cache
    qb, qt = _q(4, 7)
    qp = np.arange(40, 44, dtype=np.int32)[None]
    kd = jkv.dequantize_kv(jnp.asarray(k), jnp.asarray(ks), jnp.bfloat16)
    vd = jkv.dequantize_kv(jnp.asarray(v), jnp.asarray(vs), jnp.bfloat16)
    ref = jattn.attention(qb, kd, vd, jnp.asarray(qp), jnp.asarray(pos),
                          rope_dim=D, freq_base=10000.0)
    pk = pkv.dequantize_kv(_t(k), _t(ks), torch.bfloat16)
    pv = pkv.dequantize_kv(_t(v), _t(vs), torch.bfloat16)
    out = pattn.attention(qt, pk, pv, _t(qp), _t(pos), rope_dim=D, freq_base=10000.0)
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_effective_inv_freq_exact():
    yarn = (1.0, 1.0, 32.0, 1.0, 4096)
    ff = (1.0 + np.arange(32, dtype=np.float32) / 8.0)  # llama-3.1 factors
    for args, kw in [((64, 64, 10000.0), {}), ((32, 64, 500000.0), {}),
                     ((64, 64, 10000.0, 0.25), {"yarn": yarn}),
                     ((64, 64, 500000.0), {"freq_factors": ff})]:
        jkw = {k: jnp.asarray(v) if k == "freq_factors" else v for k, v in kw.items()}
        pkw = {k: torch.from_numpy(v) if k == "freq_factors" else v for k, v in kw.items()}
        ref, ms = jda.effective_inv_freq(*args, **jkw)
        out, pms = pda.effective_inv_freq(*args, **pkw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert pms == ms


def test_route_gates_match_jax():
    """The same chunk length and cache geometry take the same route."""
    for s in (32, 48, 64, 192, 256, 2048):
        for d in (64, 128, 320):
            for b in (1, 4):
                assert pda.supports(s, d, torch.int8, b) == \
                    jda.supports(s, d, jnp.int8, b), (s, d, b)
                for t in (1, 2, 4, 8, 16, 24, 128, 512):
                    assert pda.prefill_supports(t, s, d, torch.int8, b) == \
                        jda.prefill_supports(t, s, d, jnp.int8, b), (t, s, d, b)


def test_decode_split_is_fixed_and_covers_cache():
    """The decode body's split is one width for every B, S and head
    geometry: its boundaries sit at the same logical slots (multiples of
    DECODE_SPLIT), whole grains, and the splits cover the cache."""
    for b, hkv, s in [(1, 8, 2048), (1, 2, 64), (4, 8, 4096), (1, 1, 32), (8, 8, 8192),
                      (3, 2, 1000)]:
        split, heads, grid = pda.decode_plan(b, 4 * hkv, hkv, s, 128)
        assert split == pda.DECODE_SPLIT and split % pda.DECODE_GRAIN == 0
        assert grid[1] == -(-s // split) and split * grid[1] >= s > split * (grid[1] - 1)
        assert (split, heads, grid) == pda.decode_plan(b, 4 * hkv, hkv, s, 128)


@pytest.mark.parametrize("b", [1, 2, 8, 64])
def test_decode_split_boundaries_are_fixed_logical_slots(b):
    """A row's split boundaries do not move with the batch or with empty
    slots appended: every S cuts at the same multiples of the width, so a
    longer S only adds splits past the shorter one's last slot."""
    bounds = {}
    for s in (64, 96, 2048, 2050, 4096, 8192):
        split, _, grid = pda.decode_plan(b, 32, 8, s, 128)
        assert grid[0] == b * 8   # one CTA per (row, kv head): 4 heads fit a chunk
        bounds[s] = [min(i * split, s) for i in range(grid[1] + 1)]
    for short, long in [(2048, 4096), (2048, 8192), (64, 2048), (96, 2050)]:
        cut = [x for x in bounds[long] if x < short] + [short]
        assert bounds[short] == cut, (short, long)


@pytest.mark.parametrize("h,hkv,d", [(32, 8, 128), (66, 2, 96), (64, 1, 128), (33, 1, 80),
                                     (8, 8, 100), (16, 2, 256), (4, 1, 2)])
def test_decode_plan_chunks_every_head_group(h, hkv, d):
    """Any number of query heads per kv head: the group is cut into chunks of
    at most `decode_heads` heads (one CTA each), which cover the group."""
    split, heads, grid = pda.decode_plan(2, h, hkv, 512, d)
    assert heads == pda.decode_heads(d, h // hkv) and heads in (4, 8)
    assert heads == 4 or (h // hkv > 4 and pda.padded_head_dim(d) <= 128)
    chunks = grid[0] // (2 * hkv)
    assert chunks * heads >= h // hkv > (chunks - 1) * heads


def test_padded_head_dims_cover_every_even_d():
    """Every head dim the fused gates admit (even, <= 256) has a body whose
    padded width holds it; the widths are the ones the bodies are built at,
    and nothing else is accepted."""
    for d in range(2, 257, 2):
        dp = pda.padded_head_dim(d)
        assert dp in pda.PADDED_HEAD_DIMS and d <= dp
        assert all(w < d for w in pda.PADDED_HEAD_DIMS if w < dp)
        assert pda.supports(2048, d, torch.int8)
    for d in (0, 3, 97, 258, 320):
        with pytest.raises(ValueError):
            pda.padded_head_dim(d)


def test_block_cap_rounds_to_whole_grains(monkeypatch):
    """A BLAMA_ATTN_BLOCK_CAP below one grain still leaves a grain;
    `split=` (measuring only) must be whole grains."""
    monkeypatch.setattr(pda, "_BLOCK_CAP", 10)
    assert pda.decode_plan(1, 32, 8, 2048, 128)[0] == pda.DECODE_GRAIN
    assert pda.decode_plan(1, 32, 8, 2048, 128, split=512)[0] == 512
    with pytest.raises(ValueError):
        pda.decode_plan(1, 32, 8, 2048, 128, split=100)


@pytest.mark.parametrize("g", [1, 4, 33, 64, 65, 130])
def test_prefill_plan_slices_large_head_groups(g):
    """Prefill packs tokens x heads into at most PREFILL_ROWS MMA rows; a
    group of more heads runs one token a CTA over slices of PREFILL_ROWS
    heads, and the grid covers every (token, head)."""
    T = 24
    tq, _, grid = pda.prefill_plan(2, T, 2 * g, 2, 2048)
    slices = -(-g // pda.PREFILL_ROWS)
    assert tq * min(g, pda.PREFILL_ROWS) <= pda.PREFILL_ROWS
    assert (g <= pda.PREFILL_ROWS) or tq == 1
    assert grid[1] == -(-T // tq) * slices and slices * pda.PREFILL_ROWS >= g


# -- bf16 cache (the scheduler's store): kernels C and D read values, no scales


@pytest.fixture(scope="module")
def bf16_cache():
    """Three rows of 128 slots (the smallest bf16 geometry the decode gate
    takes), with an empty slot, an unused tail, a slot ahead of every query
    and one row that holds nothing at all."""
    rng = np.random.default_rng(8)
    b, s = 3, 128
    k = jnp.asarray(rng.standard_normal((b, s, HKV, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, HKV, D)), jnp.bfloat16)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[0, 5] = -1
    pos[0, 100:] = -1
    pos[0, 30] = 500
    pos[1, 60:] = -1
    pos[2, :] = -1            # an idle row
    return k, v, pos


def _bt(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("t", [1, 8, 16])
def test_bf16_cache_plain_matches_jax(bf16_cache, t):
    k, v, pos = bf16_cache
    b = k.shape[0]
    assert jda.supports(128, D, jnp.bfloat16, b) and pda.supports(128, D, torch.bfloat16, b)
    x = np.random.default_rng(50 + t).standard_normal((b, t, H, D)).astype(np.float32)
    qb = jnp.asarray(x, jnp.bfloat16)
    qp = np.stack([np.arange(90 - t, 90), np.arange(60 - t, 60), np.arange(t)]).astype(np.int32)
    inv, ms = jda.effective_inv_freq(D, D, 10000.0)
    pinv, pms = pda.effective_inv_freq(D, D, 10000.0)
    if t == 1:
        ref = jda.decode_attention(qb, k, v, jnp.asarray(qp[:, 0]), jnp.asarray(pos), inv,
                                   mscale=ms)
        out = pda.decode_attention(_bt(qb), _bt(k), _bt(v), _t(qp[:, 0]), _t(pos), pinv,
                                   mscale=pms)
    else:
        ref = jda.prefill_attention(qb, k, v, jnp.asarray(qp), jnp.asarray(pos), inv,
                                    mscale=ms)
        out = pda.prefill_attention(_bt(qb), _bt(k), _bt(v), _t(qp), _t(pos), pinv,
                                    mscale=pms)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, t, H, D)
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert (out[2] == 0).all()      # the idle row attends to nothing


def test_route_gates_match_jax_float_caches():
    for s in (64, 128, 192, 512, 2048):
        for b in (1, 8):
            for jd, pd_ in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                assert pda.supports(s, 64, pd_, b) == jda.supports(s, 64, jd, b), (s, b)
                for t in (1, 4, 8, 256):
                    assert pda.prefill_supports(t, s, 64, pd_, b) == \
                        jda.prefill_supports(t, s, 64, jd, b), (t, s, b)


def test_cuda_wrappers_refuse_f32_cache():
    """The kernels' store types: an f32 cache is type 2 (it has kernels since
    the f32 store type of attention_common.cuh); a store the kernels do not
    read, an f16 cache, still raises in the store-type check (it runs before
    anything touches the card)."""
    k = torch.zeros((1, 128, HKV, D))
    assert pda.kv_type_of(k, k, None, None) == 2
    with pytest.raises(NotImplementedError):
        pda.kv_type_of(k.to(torch.float16), k.to(torch.float16), None, None)
    assert pda.kv_type_of(k.to(torch.bfloat16), k.to(torch.bfloat16), None, None) == 1
    assert pda.kv_type_of(k.to(torch.int8), k.to(torch.int8), k[..., 0], k[..., 0]) == 0


@pytest.mark.parametrize("case,ok", [
    (("cuda", 32, 8, 128, torch.bfloat16), True),
    (("cuda", 32, 8, 64, torch.int8), True),
    (("cuda", 32, 8, 96, torch.bfloat16), True),     # the gates admit D=96: served
    (("cuda", 32, 8, 128, torch.float32), True),     # the f32 store has kernels
    (("cuda", 66, 2, 128, torch.bfloat16), True),    # 33 query heads per KV head: served
    (("cpu", 4, 2, 16, torch.float32), True),        # the plain versions serve all
    (("cuda", 32, 8, 128, torch.float16), False),    # an f16 store has none
], ids=["bf16", "int8", "d96", "f32", "g33", "cpu", "f16"])
def test_kernel_geometry_refused_at_construction(case, ok):
    """Every geometry the route gates admit is served by kernels C-F on a
    card (D = 96 and 33 query heads per KV head among them); what no kernel
    takes, an f16 store, is refused where the cache is created, not inside a
    step."""
    assert ppa.supports(128, case[3], case[4]) and pda.supports(2048, case[3], case[4])
    if ok:
        pda.require_kernel_geometry(*case)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pda.require_kernel_geometry(*case)
