"""InstanceEmbedding and the bert encoder in the port, against the JAX
package, on the CPU (the reference's tests/test_embedding.py surface, its
embeddings golden t-integration.cpp:511-530).

The same tiny GGUFs load on both sides; prompts are token ids (the
reference has no WordPiece tokenizer). Tolerances: normalize_embedding is
host numpy, bit-equal to the reference's; a bert embedding under float32
within 1e-5 (absolute, on unit vectors: f32 sums in another order, measured
below 1e-6), under bfloat16 within 2e-2 (bf16 activations, one rounding
apart); the decoder path's embedding (the final normed hidden state) within
1e-5 under float32 and 3e-2 under q4k_a8 (bf16 activations and the kernels'
sum orders, as the logits of tests/test_torch_engines.py).
"""

import jax
import numpy as np
import pytest
import torch

from blama_tpu.runtime.embedding import InstanceEmbedding as JInstanceEmbedding
from blama_tpu.runtime.embedding import normalize_embedding as jnormalize
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.testing import write_tiny_gpt2
from blama_tpu_torch import testing
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models import bert as pbert
from blama_tpu_torch.models import llama as pllama
from blama_tpu_torch.ops import kv_cache as kvc
from blama_tpu_torch.runtime.embedding import (EmbeddingInitParams, InstanceEmbedding,
                                               normalize_embedding)
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

BERT_F32_TOL = 1e-5
BERT_BF16_TOL = 2e-2
DEC_F32_TOL = 1e-5
DEC_PACKED_TOL = 3e-2
LENGTHS = (1, 8, 9, 100)     # across the padding buckets 8, 16 and 128


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("embedding")
    out = {}
    for pooling in (0, 1, 2, 3):
        out[f"bert{pooling}"] = str(d / f"bert{pooling}.gguf")
        testing.write_tiny_bert(out[f"bert{pooling}"], pooling_type=pooling)
    out["llama"] = str(d / "llama.gguf")
    testing.write_tiny_llama(out["llama"], GGMLType.Q4_K)
    out["q8"] = str(d / "q8.gguf")
    testing.write_tiny_llama(out["q8"], GGMLType.Q8_0)
    out["moe"] = str(d / "moe.gguf")
    testing.synthesize_moe_gguf(out["moe"], "mixtral-debug")
    out["gpt2"] = str(d / "gpt2.gguf")
    write_tiny_gpt2(out["gpt2"])
    return out


def _prompt(n, seed=0, vocab=263):
    return np.random.default_rng(seed + n).integers(4, vocab, n).tolist()


@pytest.mark.parametrize("norm", [-1, 0, 1, 2, 3])
def test_normalize_embedding_is_the_references(norm):
    rng = np.random.default_rng(norm + 5)
    for v in (rng.standard_normal(384).astype(np.float32), np.zeros(8, np.float32),
              np.array([3.0, -4.0], np.float64)):
        a, b = normalize_embedding(v, norm), jnormalize(v, norm)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_normalize_modes():
    """The reference's own cases."""
    v = np.array([3.0, -4.0], np.float64)
    np.testing.assert_allclose(normalize_embedding(v, -1), v)
    np.testing.assert_allclose(normalize_embedding(v, 2), [0.6, -0.8])
    np.testing.assert_allclose(normalize_embedding(v, 0), v / (4.0 / 32760.0), rtol=1e-6)
    np.testing.assert_allclose(normalize_embedding(v, 1), v / 7.0)
    np.testing.assert_allclose(normalize_embedding(np.zeros(4), 2), np.zeros(4))


@pytest.mark.parametrize("pooling", [0, 1, 2, 3], ids=["none", "mean", "cls", "last"])
def test_bert_embeddings_match_the_reference(files, pooling):
    """Every pooling type at lengths that cross a padding bucket, each
    normalization, float32: within BERT_F32_TOL of the reference's. A
    file's pooling_type 0 (NONE) reads as CLS on both sides (the
    reference's `or 2`, ROADMAP.md §3), so NONE is set on the config."""
    path = files[f"bert{pooling}"]
    pm, jm = Model(path, ModelParams(device="cpu")), JModel(path)
    assert pm.config.pooling_type == jm.config.pooling_type == (pooling or 2)
    pm.config.pooling_type = jm.config.pooling_type = pooling
    pe, je = InstanceEmbedding(pm), JInstanceEmbedding(jm)
    for n in LENGTHS:
        prompt = _prompt(n)
        for norm in (2, -1):
            a, b = pe.get_embedding_vector(prompt, norm), je.get_embedding_vector(prompt, norm)
            assert a.shape == b.shape == (64,)
            scale = max(1.0, float(np.abs(b).max()))
            assert np.abs(a - b).max() <= BERT_F32_TOL * scale, (n, norm)
    pm.close()
    jm.close()


def test_bert_bf16_embeddings_match_the_reference(files):
    """The bfloat16 engine (and the packed engines' names, which load bert
    in bf16 as the reference does): within BERT_BF16_TOL."""
    path = files["bert2"]
    for dtype in ("bfloat16", "q4k_a8"):
        pm = Model(path, ModelParams(dtype=dtype, device="cpu"))
        jm = JModel(path, JModelParams(dtype=dtype))
        assert pm.weights["tok_emb"].dtype == torch.bfloat16
        assert all(w.dtype == torch.bfloat16 for w in pm.weights["layers"][0].values())
        pe, je = InstanceEmbedding(pm), JInstanceEmbedding(jm)
        for n in (1, 9, 100):
            a, b = pe.get_embedding_vector(_prompt(n)), je.get_embedding_vector(_prompt(n))
            assert np.abs(a - b).max() <= BERT_BF16_TOL, (dtype, n)
        pm.close()
        jm.close()


def test_bert_embedding_is_deterministic_and_distinguishes(files):
    pm = Model(files["bert2"], ModelParams(device="cpu"))
    e = InstanceEmbedding(pm, EmbeddingInitParams())
    assert e.embedding_dim() == 64
    toks = pm.vocab.tokenize("hello world", False, False)
    e1, e2 = e.get_embedding_vector(toks), e.get_embedding_vector(toks)
    assert e1.shape == (64,) and np.array_equal(e1, e2)
    np.testing.assert_allclose(np.linalg.norm(e1), 1.0, rtol=1e-5)
    other = e.get_embedding_vector(pm.vocab.tokenize("the the the", False, False))
    assert np.abs(e1 - other).max() > 1e-3
    raw = e.get_embedding_vector(toks, normalization=-1)
    assert abs(np.linalg.norm(raw) - 1.0) > 1e-3
    assert np.array_equal(e.get_embedding_vector([]), np.zeros(64, np.float32))
    pm.close()


def test_bert_forward_masks_the_padding(files):
    """A prompt's token embeddings do not depend on what the pads hold: the
    keys past n are masked."""
    pm = Model(files["bert2"], ModelParams(device="cpu"))
    st = pbert.BertStatic.of(pm.config)
    toks = torch.tensor([_prompt(5) + [0, 0, 0]])
    mask = torch.tensor([[True] * 5 + [False] * 3])
    a = pbert.bert_forward(st, pm.weights, toks, mask)[0, :5]
    toks[0, 5:] = torch.tensor([7, 8, 9])
    b = pbert.bert_forward(st, pm.weights, toks, mask)[0, :5]
    assert torch.equal(a, b)
    pm.close()


@pytest.mark.parametrize("dtype,file,attn", [("float32", "q8", "xla"), ("q4k_a8", "llama", "fused"),
                                             ("q4k_fused", "llama", "xla")])
def test_decoder_embedding_matches_the_reference(files, dtype, file, attn):
    """The decoder path (the final normed hidden state at the last token,
    over a fresh f32 store of T slots) at lengths across the buckets."""
    pm = Model(files[file], ModelParams(dtype=dtype, attn=attn, device="cpu"))
    jm = JModel(files[file], JModelParams(dtype=dtype, attn=attn))
    pe, je = InstanceEmbedding(pm), JInstanceEmbedding(jm)
    tol = DEC_F32_TOL if dtype == "float32" else DEC_PACKED_TOL
    for n in (1, 8, 9, 40):
        prompt = [1] + _prompt(n - 1, vocab=300)
        a = pe.get_embedding_vector(prompt)
        with jax.disable_jit(dtype == "q4k_a8"):
            b = je.get_embedding_vector(prompt)
        assert a.shape == b.shape == (pm.config.n_embd,)
        assert np.abs(a - b).max() <= tol, (n, np.abs(a - b).max())
    pm.close()
    jm.close()


def test_return_hidden_leaves_the_logits_path_alone(files):
    """forward(return_hidden=True) gives the lm head's input: through the
    head it is the step's logits bit for bit."""
    pm = Model(files["llama"], ModelParams(dtype="q4k_a8", device="cpu"))
    st = pllama.LlamaStatic.of(pm.config)
    c = pm.config
    toks = torch.tensor([[1] + _prompt(7)])
    pos = torch.arange(8)[None].int()

    def store():
        return kvc.KVCache.create(c.n_layer, 1, 16, c.n_head_kv, c.head_dim_, torch.float32,
                                  device="cpu")

    logits, _ = pllama.forward(pm.weights, st, toks, pos, pos, store())
    hidden = pllama.last_hidden(st, pm.weights, toks, pos, pos, store(), torch.tensor([7]))
    assert hidden.shape == (1, c.n_embd) and hidden.dtype == torch.bfloat16
    assert torch.equal(pllama._head_product(pm.weights["output"], hidden, 0), logits)
    pm.close()


def test_moe_and_gpt2_decoder_embeddings_are_refused(files):
    """The reference runs every non-bert file through LlamaStatic and the
    llama forward, which fails on a MoE's and on gpt2's layouts (shown on
    the reference); the port refuses with a message."""
    for file, dtype in (("moe", "q4k_fused"), ("gpt2", "float32")):
        jm = JModel(files[file], JModelParams(dtype=dtype))
        with pytest.raises(Exception):
            JInstanceEmbedding(jm).get_embedding_vector([1, 5, 6])
        pm = Model(files[file], ModelParams(dtype=dtype, device="cpu"))
        with pytest.raises(NotImplementedError, match="decoder path"):
            InstanceEmbedding(pm)
        pm.close()
        jm.close()


def test_bert_models_load_at_the_references_dtypes(files):
    """float32 (the default) loads f32, every other engine name bf16, a
    name that is no engine raises; a bert file has no decode step."""
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("q4k_fused", torch.bfloat16)):
        pm = Model(files["bert1"], ModelParams(dtype=dtype, device="cpu"))
        assert pm.weights["pos_emb"].dtype == pm.weights["layers"][1]["w_down"].dtype == want
        if dtype == "float32":
            with pytest.raises(NotImplementedError, match="InstanceEmbedding"):
                Instance(pm, InstanceInitParams(ctx_size=64))
        pm.close()
    with pytest.raises(NotImplementedError, match="item 9"):
        Model(files["bert1"], ModelParams(dtype="q5k_fused", device="cpu"))


def test_t5_is_still_refused_with_its_queue(tmp_path):
    from blama_tpu_torch.gguf import GGUFWriter

    p = str(tmp_path / "t5.gguf")
    w = GGUFWriter(p)
    w.add_kv("general.architecture", "t5")
    w.write()
    with pytest.raises(NotImplementedError, match="t5.*item 12"):
        Model(p, ModelParams(device="cpu"))
