"""The port's repacks and W4A8 / exact matmuls against the JAX package.

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
    x17 = torch.zeros((17, K), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pqm.w4a8_launch(x17, pw)
    k4 = pqm.repack_q4k_a8k4(q4k_bytes, N, K, "cpu")
    with pytest.raises(ValueError):
        pqm.a8k4_launch(x17, k4)
    # the launch paths take the checks first: a wrong dtype, a K that does
    # not match, a scale type of the other engine, a non-contiguous x
    bad = [
        (pqm.a8k4_launch, torch.zeros((1, K), dtype=torch.float16), k4, TypeError),
        (pqm.a8k4_launch, torch.zeros((1, K // 2), dtype=torch.bfloat16), k4, ValueError),
        (pqm.w4a8_launch, x17[:1], pqm.repack_q4k_exact(q4k_bytes, N, K, "cpu"), ValueError),
        (pqm.a8k4_launch, torch.zeros((K, 2), dtype=torch.bfloat16).t(), k4, ValueError),
    ]
    for fn, x, w, err in bad:
        with pytest.raises(err):
            fn(x, w)


# ---------------------------------------------------------------------------
# the other engines' weight classes: exact (f32 scales), native, int8 codes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gguf_bytes(q4k_bytes):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    return {"Q4_K": q4k_bytes, "Q8_0": jquants.quantize(w, GGMLType.Q8_0),
            "Q6_K": jquants.quantize(w, GGMLType.Q6_K)}


# name: (GGML type, JAX repack, port repack, JAX matmul, port matmul,
#        limit as a share of max|ref|)
# The limits are 1.5 x the largest gap measured over M in {1, 8, 17, 64} on
# this input (f32 sums in another order; every dequantized weight and every
# activation code is equal): exact 6.8e-7, native 1.13e-6, a8k4 1.9e-7,
# q8_0 4.7e-7, q6_k 3.8e-7, a8x 4.5e-7.
CLASSES = {
    "exact": ("Q4_K", jqm.repack_q4k_for_tpu, pqm.repack_q4k_exact,
              jqm.q4k_matmul, pqm.q4k_matmul, 1.1e-6),
    "native": ("Q4_K", jqm.repack_q4k_native, pqm.repack_q4k_native,
               jqm.q4k_native_matmul, pqm.q4k_native_matmul, 1.7e-6),
    "a8k4": ("Q4_K", jqm.repack_q4k_a8k4, pqm.repack_q4k_a8k4,
             jqm.a8k4_matmul, pqm.a8k4_matmul, 3e-7),
    "q8_0": ("Q8_0", jqm.repack_q8_0_for_tpu, pqm.repack_q8_0,
             jqm.q8_0_matmul, pqm.q8_0_matmul, 7.1e-7),
    "q6_k": ("Q6_K", jqm.repack_q6_k_expanded, pqm.repack_q6_k_expanded,
             jqm.q8_0_matmul, pqm.q8_0_matmul, 5.7e-7),
    "a8x": ("Q4_K", jqm.repack_q4k_w4a8, pqm.repack_q4k_w4a8,
            jqm.w4a8_matmul, pqm.w4a8_xla_matmul, 6.8e-7),
}


def _fields(w):
    return {f: v for f, v in vars(w).items()}


@pytest.mark.parametrize("name", list(CLASSES))
def test_class_repack_equals_params_from_jax(gguf_bytes, name):
    """The port's repack of GGUF bytes and the JAX package's repack of the
    same bytes carried over are equal array for array, class for class."""
    t, jrepack, prepack = CLASSES[name][:3]
    port = prepack(gguf_bytes[t], N, K, "cpu")
    tree = jax.tree_util.tree_map(np.asarray, {
        "tok_emb": jqm.repack_q4k_embedding(gguf_bytes["Q4_K"], N, K),
        "out_norm": np.zeros(1, np.float32), "layers": [],
        "output": jrepack(gguf_bytes[t], N, K)})
    carried = params_from_jax(tree, device="cpu")["output"]
    assert type(carried) is type(port) and port.shape == (K, N) and port.n_out == N
    for f, v in _fields(port).items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == getattr(carried, f).dtype, f
            assert torch.equal(v, getattr(carried, f)), f
        else:
            assert v == getattr(carried, f), f


@pytest.mark.parametrize("name", ["exact", "native", "q8_0", "q6_k"])
def test_exact_classes_reconstruct_host_dequant(gguf_bytes, name):
    """code · scale (− min) from the port's arrays equals
    gguf.quants.dequantize bitwise: what makes an engine verification
    grade. A bf16 or f16 cast of a scale anywhere would break it."""
    t, _, prepack = CLASSES[name][:3]
    w = prepack(gguf_bytes[t], N, K, "cpu")
    ref = jquants.dequantize(gguf_bytes[t], GGMLType[t], (N, K))
    if name == "q8_0" or name == "q6_k":
        assert w.group == (32 if name == "q8_0" else 16)
        assert w.scales.dtype == torch.float32 and w.codes.dtype == torch.int8
    elif name == "exact":
        assert w.scales.dtype == torch.float32 and w.mins.dtype == torch.float32
    np.testing.assert_array_equal(pqm.dequantize(w).numpy(), ref)


def test_native_class_keeps_the_gguf_bytes(gguf_bytes):
    w = pqm.repack_q4k_native(gguf_bytes["Q4_K"], N, K, "cpu")
    assert w.codes.shape == (N, K // 256 * 144)
    np.testing.assert_array_equal(w.codes.numpy().reshape(-1), gguf_bytes["Q4_K"])


@pytest.mark.parametrize("m", [1, 8, 17, 64])
@pytest.mark.parametrize("name", list(CLASSES))
def test_class_plain_versions_match_jax(gguf_bytes, name, m):
    """Each plain version against the JAX function it mirrors (its Pallas
    kernel in interpret mode), at a ragged N."""
    t, jrepack, prepack, jfn, pfn, limit = CLASSES[name]
    xb, xt = _acts(m, seed=10 + m)
    if name == "a8k4" and m > 16:
        # more than 16 rows of a QuantTensorA8K4 take the native exact kernel
        jfn, pfn, limit = CLASSES["native"][3:]
    if name in ("a8k4", "a8x") and jfn is not jqm.q4k_native_matmul:
        # XLA's CPU jit divides amax by 127 through a reciprocal, which moves
        # an activation scale by an ulp and now and then a code by one; the
        # function as written (IEEE division) is what the port mirrors
        with jax.disable_jit():
            ref = np.asarray(jfn(xb, jrepack(gguf_bytes[t], N, K)))[:, :N]
    else:
        ref = np.asarray(jfn(xb, jrepack(gguf_bytes[t], N, K)))[:, :N]
    out = pfn(xt, prepack(gguf_bytes[t], N, K, "cpu")).numpy()
    gap = np.abs(out - ref).max() / np.abs(ref).max()
    assert gap <= limit, gap


@pytest.mark.parametrize("m", [1, 16, 17])
def test_a8k4_activation_codes_exact(m):
    """Kernel I's prologue is kernel A's: codes, scales and scale·sum equal
    the reference quantizer's."""
    xb, xt = _acts(m, seed=40 + m)
    xq, xs, xsum = jqm._quant_acts(xb)
    pxq, pxs, psxm = pqm.quant_acts(xt)
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(pxs.numpy(), np.asarray(xs).T)
    np.testing.assert_array_equal(psxm.numpy(), np.asarray(xs * xsum).T)


@pytest.mark.parametrize("m", [1, 16, 17, 64])
@pytest.mark.parametrize("name", list(CLASSES) + ["a8s", "dense"])
def test_quant_kernel_call_routes_by_class_and_rows(gguf_bytes, monkeypatch, name, m):
    """_quant_kernel_call's routing (the reference's, by class and by the 16
    row cap of the W4A8 kernels), and qmm's cast to x's dtype; a dense
    weight takes rows_mm (each row alone, f32 sums), no kernel."""
    few = m <= 16
    expect = {"exact": "q4k_matmul", "native": "q4k_native_matmul",
              "a8k4": "a8k4_matmul" if few else "q4k_native_matmul",
              "q8_0": "q8_0_matmul", "q6_k": "q8_0_matmul", "a8x": "w4a8_xla_matmul",
              "a8s": "w4a8_matmul" if few else "q4k_matmul", "dense": None}[name]
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((1, m, K))
                         .astype(np.float32)).to(torch.bfloat16)
    if name == "dense":
        w = torch.from_numpy(np.random.default_rng(1).standard_normal((K, N))
                             .astype(np.float32)).to(torch.bfloat16)
    elif name == "a8s":
        w = pqm.repack_q4k_a8s(gguf_bytes["Q4_K"], N, K, "cpu")
    else:
        w = CLASSES[name][2](gguf_bytes[CLASSES[name][0]], N, K, "cpu")
    called = []
    for fn in ("q4k_matmul", "q4k_native_matmul", "a8k4_matmul", "q8_0_matmul",
               "w4a8_xla_matmul", "w4a8_matmul"):
        real = getattr(pqm, fn)
        monkeypatch.setattr(pqm, fn, lambda a, b, fn=fn, real=real:
                            (called.append(fn), real(a, b))[1])
    out = pqm.qmm(x, w)
    assert out.shape == (1, m, N) and out.dtype == torch.bfloat16
    assert called == ([expect] if expect else [])
    if expect:
        direct = getattr(pqm, expect)(x[0], w)
        assert torch.equal(out[0], direct.to(torch.bfloat16))
    else:
        assert torch.equal(out[0], pqm.rows_mm(x[0], w))
        assert torch.equal(out[0, -1:], pqm.rows_mm(x[0, -1:], w))
        ref = x[0].double() @ w.double()
        assert (out[0].double() - ref).abs().max() <= 2 ** -7 * ref.abs().max()


def test_dense_embedding_is_gathered(q4k_bytes):
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4).to(torch.bfloat16)
    tokens = torch.tensor([[3, 0, 9]])
    assert torch.equal(pqm.emb_lookup(table, tokens), table[tokens])
