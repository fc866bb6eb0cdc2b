"""The port's Q8_0 / Q6_K codecs and fixtures against the JAX package.

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quants.quantize(_weights(3), GGMLType[name])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quants.dequantize(np.zeros(210, np.uint8), GGMLType[name], (1, 256))


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
