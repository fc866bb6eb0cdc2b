"""The port's Q4_K repack and W4A8 / exact matmuls against the JAX package.

Same numpy-seeded inputs through both; the JAX side runs its Pallas kernels
in interpret mode on the CPU, the port's wrappers run their plain PyTorch
versions (a CPU tensor never reaches a CUDA kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.gguf import GGMLType
from blama_tpu.gguf import quants as jquants
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as pqm
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.testing import write_tiny_llama

# N not a multiple of 256: exercises the reference's lane padding
N, K = 320, 512


@pytest.fixture(scope="module")
def q4k_bytes():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    return jquants.quantize(w, GGMLType.Q4_K)


def _acts(m, seed):
    """bf16-valued activations as (jax bf16, torch bf16) with equal values."""
    x = np.random.default_rng(seed).standard_normal((m, K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)


def _port_of_jax(data):
    """params_from_jax over a tree holding the reference's repack of `data`
    as both the lm head and the token embedding."""
    tree = jax.tree_util.tree_map(np.asarray, {
        "tok_emb": jqm.repack_q4k_embedding(data, N, K),
        "out_norm": np.zeros(1, np.float32), "layers": [],
        "output": jqm.repack_q4k_a8s(data, N, K)})
    return params_from_jax(tree, device="cpu")


def test_unpack_matches_host_unpack(q4k_bytes):
    codes, scales, mins = pqm.unpack_q4k(q4k_bytes, N, K, "cpu")
    jc, js, jm = jqm.unpack_q4k_arrays(q4k_bytes, N, K)
    np.testing.assert_array_equal(codes.numpy(), jc)
    np.testing.assert_array_equal(scales.numpy(), js)
    np.testing.assert_array_equal(mins.numpy(), jm)


def test_repack_equals_params_from_jax(q4k_bytes):
    port = pqm.repack_q4k_a8s(q4k_bytes, N, K, "cpu")
    port_emb = pqm.repack_q4k_embedding(q4k_bytes, N, K, "cpu")
    carried = _port_of_jax(q4k_bytes)
    for f in ("codes", "scales", "mins"):
        assert torch.equal(getattr(port, f), getattr(carried["output"], f)), f
        assert torch.equal(getattr(port_emb, f), getattr(carried["tok_emb"], f)), f
    assert port.shape == (K, N)


def test_model_weights_equal_params_from_jax(tmp_path):
    """Loading a GGUF in the port and carrying the JAX package's loaded tree
    across give identical weights, leaf for leaf."""
    p = str(tmp_path / "tiny.gguf")
    write_tiny_llama(p)
    jm = JModel(p, JModelParams(dtype="q4k_a8", attn="fused"))
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.weights),
                              device="cpu")
    pm = Model(p, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    loaded = pm.weights

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(a, b)
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("codes", "scales", "mins"))

    assert set(carried) == set(loaded)
    for key in ("tok_emb", "out_norm", "output"):
        assert same(carried[key], loaded[key]), key
    for lc, ll in zip(carried["layers"], loaded["layers"], strict=True):
        assert set(lc) == set(ll)
        for key in lc:
            assert same(lc[key], ll[key]), key
    jm.close()
    pm.close()


@pytest.mark.parametrize("m", [1, 4, 32])
def test_activation_codes_exact(m):
    xb, xt = _acts(m, seed=m)
    xq, xs, xsum = jqm._quant_acts(xb)
    pxq, pxs, psxm = pqm.quant_acts(xt)
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(pxs.numpy(), np.asarray(xs).T)
    np.testing.assert_array_equal(psxm.numpy(), np.asarray(xs * xsum).T)


# Float tolerance of the matmuls: both sides take exact int8 x 4-bit group
# dots (A) or exact f32 dequantized weights (B); only the order of the f32
# sums over K/32 group terms (A) or K products (B) differs. That moves the
# result by a few f32 ulps of the terms (measured < 3e-6 here); 1e-5 of the
# output's scale still catches a wrong code, scale or group (an O(1) error).
def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 4, 32])
def test_plain_kernels_match_jax(q4k_bytes, m):
    jw = jqm.repack_q4k_a8s(q4k_bytes, N, K)
    pw = pqm.repack_q4k_a8s(q4k_bytes, N, K, "cpu")
    xb, xt = _acts(m, seed=10 + m)
    if m == 1:    # kernel A at one row: _a8s_xin_kernel
        ref = jqm.w4a8_swar_xin(xb, jw)
        out = pqm.w4a8_matmul_plain(xt, pw)
    elif m == 4:  # kernel A at 2..16 rows: _a8s_pinned_kernel
        ref = jqm.w4a8_swar_fold(xb, jw)
        out = pqm.w4a8_matmul_plain(xt, pw)
    else:         # kernel B: _q4k_matmul_kernel plus the min term
        ref = jqm.q4k_matmul(xb, jw)
        out = pqm.q4k_matmul(xt, pw)
    _close(out.numpy(), np.asarray(ref)[:, :N])


@pytest.mark.parametrize("m", [1, 4, 16, 17, 32])
def test_qmm_routes_by_row_count(q4k_bytes, m):
    """Up to 16 flat rows take kernel A, more take kernel B — the
    reference's _quant_kernel_call split — and qmm casts to x's dtype."""
    pw = pqm.repack_q4k_a8s(q4k_bytes, N, K, "cpu")
    xt = torch.from_numpy(
        np.random.default_rng(m).standard_normal((m, K)).astype(np.float32))
    route = pqm.w4a8_matmul_plain if m <= 16 else pqm.q4k_matmul
    out = pqm.qmm(xt.to(torch.bfloat16)[None], pw)
    assert out.shape == (1, m, N) and out.dtype == torch.bfloat16
    assert torch.equal(out[0], route(xt.to(torch.bfloat16), pw).to(torch.bfloat16))


def test_embedding_lookup_matches_jax(q4k_bytes):
    jemb = jqm.repack_q4k_embedding(q4k_bytes, N, K)
    pemb = pqm.repack_q4k_embedding(q4k_bytes, N, K, "cpu")
    tokens = np.array([[0, 5, 319, 5]], np.int32)
    ref = np.asarray(jqm.emb_lookup(jemb, jnp.asarray(tokens)).astype(jnp.float32))
    out = pqm.emb_lookup(pemb, torch.from_numpy(tokens).long()).float().numpy()
    np.testing.assert_array_equal(out, ref)


def test_cuda_wrappers_refuse_cpu_fallback(q4k_bytes):
    """A CPU tensor runs the plain version; nothing else may: the launch
    path checks its inputs before it touches a library."""
    pw = pqm.repack_q4k_a8s(q4k_bytes, N, K, "cpu")
    with pytest.raises(ValueError):
        pqm.w4a8_launch(torch.zeros((17, K), dtype=torch.bfloat16), pw)
