"""GPT-2, the original blama's default family, on the port against the JAX
package on the CPU (the reference's tests/test_gpt2.py contract): the
reference's tiny BPE fixture and the GPT-2 117M widths (testing.
GPT2_PRESETS, Q6_K as blama's default file) cut to 2 layers, under the
reference's default engine (`float32`) and `bfloat16` (which every packed
engine's name loads, as there), on f32 and bf16 KV rows: logits within the
stated tolerance, a same-backend replay at exactly 1.0, a replay across the
two packages at the thresholds of tests/test_cross_engine_verify.py (score
>= 0.95, mean similarity >= 0.98) both ways; layer_norm against the
reference's; the solo server's four endpoints; the refusals (an INT8 store,
the scheduler).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu import testing as jtesting
from blama_tpu.ops.norms import layer_norm as jlayer_norm
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models.gpt2 import GPT2Static
from blama_tpu_torch.ops.generate_loop import static_of
from blama_tpu_torch.ops.norms import layer_norm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler
from blama_tpu_torch.server.server import (ChatCompleteRequestParams, ChatMessage,
                                           CompleteRequestParams, Server)
from blama_tpu_torch.testing import synthesize_gpt2_gguf

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world"
CASES = [(f, d, kv) for f in ("tiny", "117m") for d in ("float32", "bfloat16")
         for kv in ("float32", "bfloat16")]
IDS = ["-".join(c) for c in CASES]
# the port-vs-JAX logit gap per chunk as a share of the largest logit, by
# (engine, KV store): 1.5 x the largest reading on these files (float32 on
# f32 rows 2e-6, the f32 sums' order; on bf16 rows 1.8e-4, where that order
# flips a row's bf16 rounding; bfloat16 0.0071, the bf16 residual stream)
TOL = {("float32", "float32"): 1e-5, ("float32", "bfloat16"): 2.7e-4,
       ("bfloat16", "float32"): 0.011, ("bfloat16", "bfloat16"): 0.011}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2")
    out = {"tiny": str(d / "tiny.gguf"), "117m": str(d / "gpt2-117m-L2.gguf")}
    jtesting.write_tiny_gpt2(out["tiny"])
    synthesize_gpt2_gguf(out["117m"], n_layer=2)
    return out


@pytest.fixture(scope="module")
def models(files):
    cache = {}

    def get(side, name, dtype):
        key = (side, name, dtype)
        if key not in cache:
            cache[key] = (Model(files[name], ModelParams(dtype=dtype, device="cpu"))
                          if side == "port" else JModel(files[name], JModelParams(dtype=dtype)))
        return cache[key]

    yield get
    for m in cache.values():
        m.close()


def _generate(inst, vocab, sess_cls, cp_cls, n):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    preds = s.complete(cp_cls(max_tokens=n))
    inst.stop_session()
    return preds


def _verify(inst, vocab, sess_cls, preds):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    """f32 statistics, weight and bias, the result in x's dtype: within one
    f32 rounding of the reference's (f32), bit for bit after the rounding
    to bf16 but where a sum order moves one (bf16: at most 1 in 1000)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5, 768)).astype(np.float32) * 3 + 1
    w = 1 + 0.1 * rng.standard_normal(768).astype(np.float32)
    b = 0.1 * rng.standard_normal(768).astype(np.float32)
    want = np.asarray(jlayer_norm(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b), 1e-5))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b),
                     1e-5).float().numpy()
    want = want.astype(np.float32)
    if tdt == torch.float32:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert np.mean(got != want) <= 1e-3
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    none = layer_norm(torch.from_numpy(x), torch.from_numpy(w), None, 1e-5)
    assert torch.equal(none, layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.zeros(768), 1e-5))


@pytest.mark.parametrize("name,dtype,kv", CASES, ids=IDS)
def test_logits_match_jax(name, dtype, kv, models):
    pm, jm = models("port", name, dtype), models("jax", name, dtype)
    ji = JInstance(jm, JInstanceInitParams(ctx_size=64, kv_dtype=kv))
    pi = Instance(pm, InstanceInitParams(ctx_size=64, kv_dtype=kv))
    chunks = [pm.vocab.tokenize(PROMPT, True, True), [77], [5, 6, 7], list(range(50, 70))]
    nxt = 0
    for toks in chunks:
        pos = np.arange(nxt, nxt + len(toks))
        nxt += len(toks)
        ref, got = ji.decode(toks, pos), pi.decode(toks, pos)
        assert got.shape == ref.shape == (pm.config.n_vocab,)
        assert np.abs(got - ref).max() <= TOL[dtype, kv] * np.abs(ref).max(), len(toks)
        assert len(set(np.argsort(-ref)[:10]) & set(np.argsort(-got)[:10])) >= 8


@pytest.mark.parametrize("name,dtype,kv", CASES, ids=IDS)
def test_same_backend_replay_is_exact(name, dtype, kv, models):
    pm = models("port", name, dtype)
    pi = Instance(pm, InstanceInitParams(ctx_size=64, kv_dtype=kv))
    preds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 8)
    assert len(preds) == 8
    assert _verify(pi, pm.vocab, SessionInitParams, preds) == (1.0, 1.0)


@pytest.mark.parametrize("name,dtype", [("tiny", "float32"), ("tiny", "bfloat16"),
                                        ("117m", "float32"), ("117m", "bfloat16")])
def test_cross_backend_replay(name, dtype, models):
    """Port prover -> JAX verifier and JAX prover -> port verifier, both on
    the reference's default f32 KV rows."""
    pm, jm = models("port", name, dtype), models("jax", name, dtype)
    pi = Instance(pm, InstanceInitParams(ctx_size=64))
    ji = JInstance(jm, JInstanceInitParams(ctx_size=64))
    ppreds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 8)
    jpreds = _generate(ji, jm.vocab, JSessionInitParams, JCompleteParams, 8)
    for verifier, vocab, sess_cls, preds in ((ji, jm.vocab, JSessionInitParams, ppreds),
                                             (pi, pm.vocab, SessionInitParams, jpreds)):
        score, sim = _verify(verifier, vocab, sess_cls, preds)
        assert score >= 0.95 and sim >= 0.98, (score, sim)


def test_loaded_layout_and_dtypes(files):
    """Every engine name loads gpt2 dense, as the reference does: bf16 under
    `bfloat16` and the packed engines' names, f32 under `float32`; the head
    f32 of its dtype-rounded values (the reference casts it every step);
    the 117M preset at its published widths, its head tied."""
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("q4k_a8", torch.bfloat16), ("q4k_fused", torch.bfloat16)):
        m = Model(files["117m"], ModelParams(dtype=dtype, device="cpu"))
        cfg, w = m.config, m.weights
        assert (cfg.arch, cfg.n_embd, cfg.n_head, cfg.n_vocab, cfg.n_ctx_train) == \
            ("gpt2", 768, 12, 50257, 1024)
        assert isinstance(static_of(cfg), GPT2Static)
        assert w["tok_emb"].dtype == w["layers"][0]["wqkv"].dtype == want
        assert w["layers"][0]["wqkv"].shape == (768, 3 * 768)
        assert w["output"].dtype == torch.float32
        assert torch.equal(w["output"], w["tok_emb"].t().float())
        assert "output.weight" not in m.reader.tensors
        assert m.reader.tensors["blk.0.attn_qkv.weight"].ggml_type == GGMLType.Q6_K
        m.close()


def test_model_params_default_serves_the_four_endpoints(files):
    """ModelParams() (float32) and the solo Server at InstanceInitParams()'s
    f32 KV rows: /complete and /chat/completions, each verified over its
    endpoint at exactly 1.0."""
    m = Model(files["tiny"], ModelParams(device="cpu"))
    api = Server(m, InstanceInitParams())
    try:
        def call(fn, *args):
            done, out = threading.Event(), []
            fn(*args, lambda r: (out.append(r), done.set()))
            assert done.wait(120)
            return out[0]

        req = CompleteRequestParams(prompt=PROMPT, max_tokens=6, temperature=0.0)
        resp = call(api.complete_text, req)
        assert len(resp) == 6
        assert call(api.verify, req, resp) == 1.0
        chat = ChatCompleteRequestParams(messages=[ChatMessage("user", "hello world")],
                                         max_tokens=5, temperature=0.0)
        cresp = call(api.chat_complete, chat)
        assert len(cresp) >= 1
        assert call(api.chat_verify, chat, cresp) == 1.0
    finally:
        api.close()
        m.close()


def test_refusals(files):
    """An INT8 KV store (the reference would cast gpt2's float rows into the
    codes) and the scheduler (whose reference builds LlamaStatic for any
    non-MoE file) are refused with a message."""
    m = Model(files["tiny"], ModelParams(device="cpu"))
    with pytest.raises(NotImplementedError, match="INT8"):
        Instance(m, InstanceInitParams(ctx_size=64, kv_dtype="int8"))
    with pytest.raises(NotImplementedError, match="gpt2"):
        ContinuousBatchingScheduler(m, max_batch=2, ctx_size=64)
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(files["tiny"], ModelParams(dtype="q5k_fused", device="cpu"))
    m.close()
