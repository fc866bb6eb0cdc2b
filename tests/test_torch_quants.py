"""The port's GGML codecs and fixtures against the JAX package.

The port keeps its own copy of the numpy (de)quantizers and fixture writers;
the same seeded inputs must give the same bytes and values, exactly.
"""

import numpy as np
import pytest

from blama_tpu import testing as jtesting
from blama_tpu.gguf import GGMLType as JType
from blama_tpu.gguf import quants as jquants
from blama_tpu.gguf.reader import GGUFReader as JReader
from blama_tpu_torch import testing as ptesting
from blama_tpu_torch.gguf import GGMLType, quants
from blama_tpu_torch.gguf.reader import GGUFReader

TYPES = ["Q4_K", "Q8_0", "Q6_K"]


def _weights(seed, shape=(24, 512)):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
    w[3, :256] = 0.0          # an all-zero superblock: scale 0
    w[5, 40] = 3.0            # an outlier that sets its block's scale
    return w


@pytest.mark.parametrize("name", TYPES)
def test_quantize_bytes_equal_jax(name):
    w = _weights(1)
    np.testing.assert_array_equal(quants.quantize(w, GGMLType[name]),
                                  jquants.quantize(w, JType[name]))


@pytest.mark.parametrize("name", TYPES)
def test_dequantize_values_equal_jax(name):
    w = _weights(2)
    data = jquants.quantize(w, JType[name])
    out = quants.dequantize(data, GGMLType[name], w.shape)
    np.testing.assert_array_equal(out, jquants.dequantize(data, JType[name], w.shape))
    # a valid encoder: the round trip stays within the format's step
    step = {"Q4_K": 1 / 15, "Q8_0": 1 / 127, "Q6_K": 1 / 31}[name]
    assert np.abs(out - w).max() <= step * np.abs(w).max()


@pytest.mark.parametrize("name", ["Q5_K", "Q4_0", "Q2_K"])
def test_other_types_still_raise(name):
    """These types were refused until the dense engines came; now their
    codecs are the JAX package's, bit for bit (test_new_types_equal_jax has
    every one), and only the types the JAX package refuses too (IQ2_XXS
    here) still raise, in both."""
    w = _weights(3)
    data = quants.quantize(w, GGMLType[name])
    np.testing.assert_array_equal(data, jquants.quantize(w, JType[name]))
    np.testing.assert_array_equal(quants.dequantize(data, GGMLType[name], w.shape),
                                  jquants.dequantize(data, JType[name], w.shape))
    for pkg, t in ((quants, GGMLType), (jquants, JType)):
        with pytest.raises(NotImplementedError):
            pkg.quantize(w, t.IQ2_XXS)
        with pytest.raises(NotImplementedError):
            pkg.dequantize(np.zeros(66, np.uint8), t.IQ2_XXS, (1, 256))


@pytest.mark.parametrize("name", ["Q8_0", "Q6_K"])
def test_tiny_fixture_is_a_copy(tmp_path, name):
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    ptesting.write_tiny_llama(a, GGMLType[name])
    jtesting.write_tiny_llama(b, JType[name])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_q4_k_m_rule():
    """llama.cpp's use_more_bits over 32 layers: the first and last eighth
    and every third layer between."""
    more = [i for i in range(32)
            if ptesting.q4_k_m_type(f"blk.{i}.ffn_down.weight", 32) == GGMLType.Q6_K]
    assert more == [0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29, 30, 31]
    assert ptesting.q4_k_m_type("blk.0.attn_v.weight", 32) == GGMLType.Q6_K
    assert ptesting.q4_k_m_type("blk.4.attn_v.weight", 32) == GGMLType.Q4_K
    assert ptesting.q4_k_m_type("blk.0.attn_q.weight", 32) == GGMLType.Q4_K
    assert ptesting.q4_k_m_type("blk.0.ffn_gate.weight", 32) == GGMLType.Q4_K
    assert ptesting.q4_k_m_type("output.weight", 32) == GGMLType.Q6_K
    assert ptesting.q4_k_m_type("token_embd.weight", 32) == GGMLType.Q4_K


def test_mixed_fixture_reads_in_both_packages(tmp_path):
    """The Q4_K_M-pattern tiny file: the expected type per tensor, and the
    JAX package's reader sees the same types and float values."""
    p = str(tmp_path / "mixed.gguf")
    ptesting.write_tiny_llama(p, ptesting.Q4_K_M)
    pr, jr = GGUFReader(p), JReader(p)
    types = {n: t.ggml_type.name for n, t in pr.tensors.items()}
    assert types["output.weight"] == "Q6_K" and types["token_embd.weight"] == "Q4_K"
    assert types["blk.0.attn_v.weight"] == "Q4_K" and types["blk.1.attn_v.weight"] == "Q6_K"
    assert types["blk.0.ffn_down.weight"] == "Q4_K" and types["blk.1.ffn_down.weight"] == "Q6_K"
    assert types["blk.1.attn_q.weight"] == "Q4_K" and types["blk.1.attn_norm.weight"] == "F32"
    assert types == {n: t.ggml_type.name for n, t in jr.tensors.items()}
    for name in ("output.weight", "blk.1.ffn_down.weight", "blk.0.attn_q.weight"):
        np.testing.assert_array_equal(pr.tensor_float(name), jr.tensor_float(name))
    pr.close()
    jr.close()


@pytest.mark.parametrize("quant,name", [("Q8_0", "Q8_0"), ("Q6_K", "Q6_K"),
                                        ("Q4_K_M", "Q6_K")])
def test_direct_synthesis(tmp_path, quant, name):
    """The direct packers write decodable blocks of about the asked spread,
    with a scale per block that differs (Q6_K: signed), at a cut depth."""
    p = str(tmp_path / "synth.gguf")
    q = ptesting.Q4_K_M if quant == "Q4_K_M" else GGMLType[quant]
    spec = ptesting.synthesize_llama_gguf(p, "debug-0.3b", seed=3, quant=q, n_layer=1)
    assert spec["n_layer"] == 1
    r = JReader(p)
    assert r.tensors["output.weight"].ggml_type.name == name
    w = r.tensor_float("output.weight")
    assert w.shape == (32000, 1024) and np.isfinite(w).all()
    assert 0.8 / 32 < w.std() < 1.25 / 32
    if name == "Q6_K":
        blk = np.array(r.tensor_bytes("output.weight"), np.uint8).reshape(-1, 210)
        sc = blk[:64, 192:208].view(np.int8)
        del blk
        assert (sc < 0).any() and (sc > 0).any() and (np.abs(sc) >= 32).all()
    r.close()


# every type the JAX package's gguf/quants.py reads beyond Q4_K / Q8_0 / Q6_K
NEW_TYPES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q5_K", "Q8_K", "IQ4_NL",
             "IQ4_XS", "BF16"]


@pytest.mark.parametrize("name", NEW_TYPES)
def test_new_types_equal_jax(name):
    """Quantize bytes and dequantized values bit-equal to the JAX package's
    numpy codecs (its C++ fast path is bit-equal to them too), on weights
    with an all-zero superblock and an outlier, and on random bytes."""
    w = _weights(11)
    data = quants.quantize(w, GGMLType[name])
    np.testing.assert_array_equal(data, jquants.quantize(w, JType[name]))
    out = quants.dequantize(data, GGMLType[name], w.shape)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  jquants.dequantize(data, JType[name], w.shape).view(np.uint32))
    raw = np.random.default_rng(5).integers(0, 256, data.size, dtype=np.uint8)
    if name in ("BF16",):
        raw = quants.quantize(np.random.default_rng(5).standard_normal(w.shape), GGMLType[name])
    with np.errstate(all="ignore"):
        a = quants.dequantize(raw, GGMLType[name], w.shape)
        b = jquants.dequantize(raw, JType[name], w.shape)
    np.testing.assert_array_equal(np.nan_to_num(a).view(np.uint32),
                                  np.nan_to_num(b).view(np.uint32))


@pytest.mark.parametrize("name", ["F32", "F16", "BF16", "Q8_0", "Q4_0", "Q4_1", "Q5_0",
                                  "Q5_1", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K", "Q8_K",
                                  "IQ4_NL", "IQ4_XS"])
def test_device_dequant_equals_numpy(name):
    """ops/dequant (the dense engines' loader, on the tensor's device)
    gives the numpy function's values bit for bit for every type the numpy
    functions read, on quantized weights and on random bytes (every code,
    scale and min pattern); a type they refuse it refuses too."""
    import torch

    from blama_tpu_torch.ops import dequant

    w = _weights(13)
    t = GGMLType[name]
    datas = [quants.quantize(w, t)]
    if name not in ("F32", "F16", "BF16"):   # random bytes: every code, scale and min
        datas.append(np.random.default_rng(7).integers(0, 256, datas[0].size, dtype=np.uint8))
    for data in datas:
        with np.errstate(all="ignore"):
            ref = quants.dequantize(data, t, w.shape)
        out = dequant.dequantize(data, t, w.shape, "cpu").numpy()
        np.testing.assert_array_equal(np.nan_to_num(out).view(np.uint32),
                                      np.nan_to_num(ref).view(np.uint32))
    bf = dequant.dequantize(datas[0], t, w.shape, "cpu", torch.bfloat16)
    ref = torch.from_numpy(quants.dequantize(datas[0], t, w.shape))
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, ref.to(torch.bfloat16))
    with pytest.raises(NotImplementedError):
        dequant.dequantize(datas[0], GGMLType.IQ2_XXS, w.shape, "cpu")
