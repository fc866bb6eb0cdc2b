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
    for b, hkv, s in [(1, 8, 2048), (1, 2, 64), (4, 8, 4096), (1, 1, 32)]:
        chunk = pda.decode_split(b, hkv, s)
        assert chunk % pda.TILE_S == 0 and chunk * -(-s // chunk) >= s
        assert chunk == pda.decode_split(b, hkv, s)
