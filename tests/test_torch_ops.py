"""The port's small ops against the JAX package: rms_norm, rope, the INT8
KV quantizer and the KV position edits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.ops import kv_cache as jkv
from blama_tpu.ops import norms as jnorms
from blama_tpu.ops import rope as jrope
from blama_tpu_torch.ops import kv_cache as pkv
from blama_tpu_torch.ops import norms as pnorms
from blama_tpu_torch.ops import rope as prope


def _bf16_pair(x):
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = (1.0 + 0.01 * rng.standard_normal(256)).astype(np.float32)
    xb, xt = _bf16_pair(x)
    ref = np.asarray(jnorms.rms_norm(xb, jnp.asarray(w), 1e-5).astype(jnp.float32))
    out = pnorms.rms_norm(xt, torch.from_numpy(w), 1e-5)
    assert out.dtype == torch.bfloat16
    # the f32 mean is summed in another order; the bf16 result may then
    # round to the neighbouring value: one bf16 ulp (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("rope_dim,scaling", [
    (64, None), (32, None), (64, "yarn"), (64, "freq_factors")])
def test_rope_matches_jax(rope_dim, scaling):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 4, 64)).astype(np.float32)
    pos = np.array([[0, 1, 17, 300, 511]], np.int32)
    jkw, pkw = {}, {}
    if scaling == "yarn":
        jkw = pkw = {"scale": 0.25, "yarn": (1.0, 1.0, 32.0, 1.0, 4096)}
    elif scaling == "freq_factors":
        ff = 1.0 + np.arange(rope_dim // 2, dtype=np.float32) / 8.0
        jkw, pkw = {"freq_factors": jnp.asarray(ff)}, {"freq_factors": torch.from_numpy(ff)}
    ref_cs = jrope.rope_angles(jnp.asarray(pos), rope_dim, 10000.0, **jkw)
    cs = prope.rope_angles(torch.from_numpy(pos), rope_dim, 10000.0, **pkw)
    # cos/sin of the same f32 angle from two libm implementations: a few
    # f32 ulps apart; the angles themselves come from pow(), within an ulp
    for a, b in zip(cs, ref_cs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), rope_dim, 10000.0,
                           cos_sin=ref_cs)
    out = prope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rope_dim,
                           10000.0, cos_sin=cs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    # dims past rope_dim pass through untouched
    np.testing.assert_array_equal(out[..., rope_dim:].numpy(), x[..., rope_dim:])


def test_quantize_kv_codes_exact():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 7, 2, 64)).astype(np.float32)
    x[0, 3, 1] = 0.0                  # an all-zero head row: scale 0, codes 0
    x[0, 2, 0, :4] = [0.5, -0.5, 1.5, 127.0]   # exact halves round to even
    xb, xt = _bf16_pair(x)
    codes, scale = jkv.quantize_kv(xb)
    pcodes, pscale = pkv.quantize_kv(xt)
    assert pcodes.dtype == torch.int8
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(pscale.numpy(), np.asarray(scale))
    ref = jkv.dequantize_kv(codes, scale, jnp.float32)
    np.testing.assert_array_equal(pkv.dequantize_kv(pcodes, pscale).numpy(),
                                  np.asarray(ref))


def _cache(pos):
    jc = jkv.KVCache.create(1, 1, pos.shape[1], 1, 8, jnp.int8)
    jc = jkv.KVCache(jc.k, jc.v, jnp.asarray(pos), jc.k_scale, jc.v_scale)
    pc = pkv.KVCache.create(1, 1, pos.shape[1], 1, 8, "int8", device="cpu")
    pc.positions = torch.from_numpy(pos.copy())
    return jc, pc


@pytest.mark.parametrize("edit,args", [
    ("seq_rm", (3, 9)), ("seq_rm", (-1, 5)), ("seq_rm", (6, -1)),
    ("seq_add", (4, 12, -3)), ("seq_add", (0, -1, 7)), ("seq_add", (2, 8, -5)),
    ("seq_div", (4, 16, 2)), ("seq_div", (0, -1, 3)),
])
def test_position_edits_match_jax(edit, args):
    pos = np.array([[0, 1, 2, 3, 4, 5, -1, 7, 8, 9, 10, 11, 12, 13, -1, 15]], np.int32)
    jc, pc = _cache(pos)
    ref = getattr(jkv, edit)(jc, *[jnp.int32(a) for a in args]).positions
    out = getattr(pkv, edit)(pc, *args).positions
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_slot_allocator_matches_jax():
    ja, pa = jkv.SlotAllocator(16), pkv.SlotAllocator(16)
    for a in (ja, pa):
        s = a.allocate(10)
        a.record(s, np.arange(10))
        a.apply_rm(2, 5)
        a.apply_add(5, -1, -3)
    np.testing.assert_array_equal(pa.host_positions, ja.host_positions)
    np.testing.assert_array_equal(pa.allocate(6), ja.allocate(6))


def test_clear_keeps_data():
    pc = pkv.KVCache.create(2, 1, 8, 2, 4, "int8", device="cpu")
    pc.k.fill_(3)
    pc.positions[0, :4] = torch.arange(4, dtype=torch.int32)
    pkv.clear(pc)
    assert (pc.positions == -1).all() and (pc.k == 3).all()
