"""The other llama-family architectures on the port (qwen2's q/k/v biases,
gemma / gemma2's scaled input, (1 + w) norms and exact GELU at a head dim
whose H·D is not the width, phi3's fused attn_qkv and stacked [gate; up]
ffn_up) against the JAX package's Model on the same tiny Q4_K files, on the
CPU, under the reference's default engine (`float32`), `bfloat16`, `q4k_a8`
and `q4k_fused`: logits within the stated tolerance, a same-backend replay
at exactly 1.0, and a replay across the two packages at the thresholds of
tests/test_cross_engine_verify.py (score >= 0.95, mean similarity >= 0.98)
in both directions. Both sides run the reference's default attention
(attn="xla") on f32 KV rows, and the packed engines also fused attention on
an INT8 cache; the JAX side runs its Pallas kernels in interpret mode, the
port its plain versions. The gemma fixture writes random norm weights
around 0, where the reference's own writes zeros: where w + 1 and √E round
shows only with weights that are not 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models import llama as pllama
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.ops.norms import rms_norm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.sampler import SamplerParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                              VerifyRequest)
from blama_tpu_torch.testing import FAMILIES, write_tiny_family

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"
ENGINES = ("float32", "bfloat16", "q4k_a8", "q4k_fused")
CASES = [(a, e) for a in FAMILIES for e in ENGINES]
IDS = [f"{a}-{e}" for a, e in CASES]
# the port-vs-JAX logit gap per chunk (6, 1, 3 and 20 tokens), as a share of
# the largest logit: 1.5 x the largest reading over the four architectures
# on these files (float32: 1e-6, the f32 sums' order; bfloat16: 0.0105 and
# q4k_fused 0.0125, bf16 rounding of the residual stream; q4k_a8 0.0287, the
# int8 activations moving with it; under fused attention on INT8 KV 0.0125
# and 0.0234)
TOL = {"float32": 1e-5, "bfloat16": 0.016, "q4k_fused": 0.019, "q4k_a8": 0.043}
PACKED = ("q4k_a8", "q4k_fused")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for arch in FAMILIES:
        out[arch] = str(d / f"{arch}.gguf")
        write_tiny_family(out[arch], arch)
    # gemma's tied head on a Q6_K token_embd: a dense table, a dense head
    out["gemma-q6emb"] = str(d / "gemma-q6emb.gguf")
    write_tiny_family(out["gemma-q6emb"], "gemma", emb_quant=GGMLType.Q6_K)
    # qwen2 at 4 / 4 heads: wk and wv are 256 wide, so the reference's fused
    # layouts take them (it fuses only whole 256-lane parts)
    out["qwen2-fusable"] = str(d / "qwen2-fusable.gguf")
    write_tiny_family(out["qwen2-fusable"], "qwen2", spec=dict(n_head_kv=4))
    return out


def _cached(files, build):
    cache = {}

    def get(name, dtype, attn="xla"):
        key = (name, dtype, attn)
        if key not in cache:
            cache[key] = build(files[name], dtype, attn)
        return cache[key]

    return cache, get


@pytest.fixture(scope="module")
def port_models(files):
    cache, get = _cached(files, lambda p, d, a: Model(p, ModelParams(dtype=d, attn=a,
                                                                     device="cpu")))
    yield get
    for m in cache.values():
        m.close()


@pytest.fixture(scope="module")
def jax_models(files):
    cache, get = _cached(files, lambda p, d, a: JModel(p, JModelParams(dtype=d, attn=a)))
    yield get
    for m in cache.values():
        m.close()


def _kv(attn):
    return "int8" if attn == "fused" else "float32"


def _generate(inst, vocab, sess_cls, cp_cls, n, prompt=PROMPT):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(prompt, True, True))
    preds = s.complete(cp_cls(max_tokens=n))
    inst.stop_session()
    return preds


def _verify(inst, vocab, sess_cls, preds, prompt=PROMPT):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(prompt, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims))


def _logit_gaps(pm, jm, attn):
    ji = JInstance(jm, JInstanceInitParams(ctx_size=64, kv_dtype=_kv(attn)))
    pi = Instance(pm, InstanceInitParams(ctx_size=64, kv_dtype=_kv(attn)))
    chunks = [pm.vocab.tokenize(PROMPT, True, True), [77], [5, 6, 7], list(range(50, 70))]
    nxt, out = 0, []
    for toks in chunks:
        pos = np.arange(nxt, nxt + len(toks))
        nxt += len(toks)
        ref, got = ji.decode(toks, pos), pi.decode(toks, pos)
        assert got.shape == ref.shape == (pm.config.n_vocab,)
        top = set(np.argsort(-ref)[:10]) & set(np.argsort(-got)[:10])
        out.append((np.abs(got - ref).max() / np.abs(ref).max(), len(top)))
    return out


def test_config_matches_jax(files):
    """The family keys of both packages' configs and forward statics agree:
    gemma's scale, (1 + w) norms, GELU and head dim from key_length; the
    port's static carries emb_scale and norm_plus_one as the reference's."""
    from blama_tpu.models.llama import LlamaStatic as JLlamaStatic

    for arch in FAMILIES:
        pm = Model(files[arch], ModelParams(vocab_only=True, device="cpu"))
        jm = JModel(files[arch], JModelParams(vocab_only=True))
        keys = ("arch", "n_embd", "n_head", "n_head_kv", "head_dim_", "rope_dim_", "act_fn",
                "emb_scale", "norm_plus_one", "rms_norm_eps", "rope_freq_base", "n_ff")
        assert {k: getattr(pm.config, k) for k in keys} == \
            {k: getattr(jm.config, k) for k in keys}, arch
        ps, js = pllama.LlamaStatic.of(pm.config), JLlamaStatic.of(jm.config)
        for k in ("n_head", "n_head_kv", "head_dim", "rope_dim", "act_fn", "emb_scale",
                  "norm_plus_one", "rms_eps", "freq_base"):
            assert getattr(ps, k) == getattr(js, k), (arch, k)
        if arch.startswith("gemma"):
            assert pm.config.act_fn == "gelu" and pm.config.norm_plus_one
            assert pm.config.head_dim_ == 128 and pm.config.n_head * 128 != pm.config.n_embd
        pm.close()
        jm.close()


@pytest.mark.parametrize("arch,dtype", CASES, ids=IDS)
def test_logits_match_jax(arch, dtype, port_models, jax_models):
    """Both Models at their default attention (attn="xla") on f32 KV rows:
    each chunk's logits within TOL of the reference's, 8 of the top 10 in
    common."""
    for gap, top in _logit_gaps(port_models(arch, dtype), jax_models(arch, dtype), "xla"):
        assert gap <= TOL[dtype] and top >= 8, (gap, top)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", PACKED)
def test_fused_attention_logits_match_jax(arch, dtype, port_models, jax_models):
    """The packed engines under attn="fused" on an INT8 cache (kernels C
    and D's plain versions against the reference's Pallas kernels)."""
    for gap, top in _logit_gaps(port_models(arch, dtype, "fused"),
                                jax_models(arch, dtype, "fused"), "fused"):
        assert gap <= TOL[dtype] and top >= 8, (gap, top)


@pytest.mark.parametrize("arch,dtype", CASES, ids=IDS)
def test_same_backend_replay_is_exact(arch, dtype, port_models):
    pm = port_models(arch, dtype)
    pi = Instance(pm, InstanceInitParams(ctx_size=64))
    preds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 8)
    assert len(preds) == 8
    assert _verify(pi, pm.vocab, SessionInitParams, preds) == (1.0, 1.0)


@pytest.mark.parametrize("arch,dtype", CASES, ids=IDS)
def test_cross_backend_replay(arch, dtype, port_models, jax_models):
    """Port prover -> JAX verifier and JAX prover -> port verifier."""
    pm, jm = port_models(arch, dtype), jax_models(arch, dtype)
    pi = Instance(pm, InstanceInitParams(ctx_size=64))
    ji = JInstance(jm, JInstanceInitParams(ctx_size=64))
    ppreds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 8)
    jpreds = _generate(ji, jm.vocab, JSessionInitParams, JCompleteParams, 8)
    for verifier, vocab, sess_cls, preds in ((ji, jm.vocab, JSessionInitParams, ppreds),
                                             (pi, pm.vocab, SessionInitParams, jpreds)):
        score, sim = _verify(verifier, vocab, sess_cls, preds)
        assert score >= 0.95 and sim >= 0.98, (score, sim)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", PACKED)
def test_weights_equal_carried_jax_tree(arch, dtype, port_models, jax_models):
    """The port's loaded tree equals the JAX package's tree carried across
    (params_from_jax), leaf for leaf: qwen2's bq / bk / bv (bf16, the
    engine's dtype), phi3's split parts (dense bf16 under every packed
    engine; only wo and w_down packed), gemma's tied packed head."""
    loaded = port_models(arch, dtype).weights
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jax_models(arch, dtype).weights),
                              device="cpu")
    assert set(loaded) == set(carried) - {"norm_stack"}
    for key in ("out_norm",):
        assert torch.equal(loaded[key], carried[key])
    assert type(loaded["output"]) is type(carried["output"])
    for lp, lc in zip(loaded["layers"], carried["layers"], strict=True):
        assert set(lp) == set(lc)
        for k in lp:
            a, b = lp[k], lc[k]
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), k
            else:
                assert type(a) is type(b) and torch.equal(a.codes, b.codes), k
    p0 = loaded["layers"][0]
    if arch == "qwen2":
        assert all(p0[k].dtype == torch.bfloat16 for k in ("bq", "bk", "bv"))
    if arch == "phi3":
        assert all(isinstance(p0[k], torch.Tensor) and p0[k].dtype == torch.bfloat16
                   for k in ("wq", "wk", "wv", "w_gate", "w_up"))
        assert not isinstance(p0["wo"], torch.Tensor)
        assert p0["wq"].shape == (256, 256) and p0["wk"].shape == (256, 128)
        assert p0["w_gate"].shape == p0["w_up"].shape == (256, 512)
    if arch.startswith("gemma"):
        assert isinstance(loaded["tok_emb"], qm.QuantEmbedding)
        assert loaded["output"].n_out == loaded["tok_emb"].shape[0]


def test_dense_engines_keep_the_reference_dtypes(port_models):
    """The dense engines hold the biases in their dtype, as the reference's
    dense tree, the norms as f32 of their dtype-rounded values; phi3's split
    parts take the engine's dtype. Gemma's (1 + w) rounds to bf16 under
    `bfloat16` only (the static's norm_bf16)."""
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q = port_models("qwen2", dtype).weights["layers"][0]
        assert all(q[k].dtype == want for k in ("bq", "bk", "bv"))
        assert q["attn_norm"].dtype == q["ffn_norm"].dtype == torch.float32
        p = port_models("phi3", dtype).weights["layers"][0]
        assert all(p[k].dtype == want for k in ("wq", "wk", "wv", "w_gate", "w_up"))
    for dtype in ENGINES:
        st = pllama.LlamaStatic.of(port_models("gemma", dtype).config)
        assert st.norm_plus_one and st.norm_bf16 == (dtype == "bfloat16"), dtype


@pytest.mark.parametrize("emb", ["gemma", "gemma-q6emb"])
def test_gemma_tied_head(emb, port_models, jax_models):
    """Gemma's tied head under `q4k_a8`: a Q4_K token_embd is a packed table
    and the head its bytes through the matmul repack; a Q6_K one a dense
    bf16 table and its transpose as the head (as the reference loads it),
    the logits within TOL of the reference's either way."""
    m = port_models(emb, "q4k_a8")
    if emb == "gemma":
        assert isinstance(m.weights["tok_emb"], qm.QuantEmbedding)
        assert isinstance(m.weights["output"], qm.QuantTensorA8S)
    else:
        assert m.weights["tok_emb"].dtype == torch.bfloat16
        assert torch.equal(m.weights["output"], m.weights["tok_emb"].t())
    for gap, top in _logit_gaps(m, jax_models(emb, "q4k_a8"), "xla"):
        assert gap <= TOL["q4k_a8"] and top >= 8, (gap, top)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scaled_embedding_bits_equal_jax(dtype, port_models, jax_models):
    """Gemma's input scaling: the scale rounded to the embedding's dtype
    first (√256 = 16 is exact; √3072 is 55.5 in bf16), the product equal to
    the reference's jnp expression bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 256)).astype(np.float32)
    for scale in (3072 ** 0.5, 256 ** 0.5, 3584 ** 0.5):
        xt = torch.from_numpy(x).to(dtype)
        got = pllama.scale_input(xt, scale)
        xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        want = np.asarray(xj * jnp.asarray(scale, xj.dtype)).astype(np.float32)
        assert np.array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    assert pllama.rounded_to(3072 ** 0.5, torch.bfloat16) == 55.5
    # the embedded rows of the gemma file through each engine's table
    m = port_models("gemma", "bfloat16" if dtype == torch.bfloat16 else "float32")
    j = jax_models("gemma", "bfloat16" if dtype == torch.bfloat16 else "float32")
    toks = np.array([[1, 77, 300, 5]], np.int32)
    got = pllama.scale_input(qm.emb_lookup(m.weights["tok_emb"], torch.from_numpy(toks).long()),
                             m.config.emb_scale)
    xj = j.weights["tok_emb"][toks]
    want = np.asarray(xj * jnp.asarray(j.config.emb_scale, xj.dtype)).astype(np.float32)
    assert np.array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", ENGINES)
def test_plus_one_norms_equal_jax(dtype, port_models, jax_models):
    """(1 + w) at every norm as the reference computes it: the weight
    rounded through the engine's dtype, 1 added in the dtype the reference
    stores it in (f32 under float32 and the packed engines, bf16 under
    bfloat16), the normed rows equal to the reference's rms_norm bit for
    bit."""
    from blama_tpu.ops.norms import rms_norm as jrms_norm

    m, j = port_models("gemma", dtype), jax_models("gemma", dtype)
    layers = j.weights["layers"]
    jw = [layers[0]["attn_norm"], layers[1]["ffn_norm"], j.weights["out_norm"]] \
        if isinstance(layers, list) else \
        [layers["attn_norm"][0], layers["ffn_norm"][1], j.weights["out_norm"]]
    pw = [m.weights["layers"][0]["attn_norm"], m.weights["layers"][1]["ffn_norm"],
          m.weights["out_norm"]]
    act = torch.bfloat16 if dtype != "float32" else torch.float32
    h = np.random.default_rng(3).standard_normal((2, 256)).astype(np.float32)
    ht = torch.from_numpy(h).to(act)
    hj = jnp.asarray(h, dtype=jnp.bfloat16 if act == torch.bfloat16 else jnp.float32)
    bf16 = pllama.LlamaStatic.of(m.config).norm_bf16
    for p, w in zip(pw, jw, strict=True):
        assert not torch.all(p == 0)
        got = rms_norm(ht, pllama._norm_weight(p, True, bf16), 1e-6).float().numpy()
        want = np.asarray(jrms_norm(hj, w + 1.0, 1e-6)).astype(np.float32)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", PACKED)
def test_qwen2_bias_layouts_give_the_unfused_bits(dtype, files, monkeypatch):
    """The biases sit at one point of the step whatever the layout: qwen2
    under BLAMA_FUSE_PROJ=1 (wqkv, wgu), BLAMA_FUSE_KV=1 (wkv) and
    tp_blocks=8 gives the unfused model's tokens and top-10 logits bit for
    bit, and its records replay on the unfused model at exactly 1.0."""
    path = files["qwen2-fusable"]

    def run(env=None, tp_blocks=-1):
        for e in ("BLAMA_FUSE_PROJ", "BLAMA_FUSE_KV"):
            monkeypatch.delenv(e, raising=False)
        if env:
            monkeypatch.setenv(env, "1")
        m = Model(path, ModelParams(dtype=dtype, attn="fused", tp_blocks=tp_blocks,
                                    device="cpu"))
        inst = Instance(m, InstanceInitParams(ctx_size=64, kv_dtype="int8"))
        preds = _generate(inst, m.vocab, SessionInitParams, CompleteParams, 6)
        return m, inst, [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds], preds

    base, binst, bits, _ = run()
    assert "bq" in base.weights["layers"][0]
    for env, keys in (("BLAMA_FUSE_PROJ", {"wqkv", "wgu"}), ("BLAMA_FUSE_KV", {"wkv"}),
                      (None, set())):
        m, _, got, preds = run(env, 8 if env is None else -1)
        assert keys <= set(m.weights["layers"][0]), env
        assert m.config.tp_blocks == (8 if env is None else 0)
        assert got == bits, env
        assert _verify(binst, base.vocab, SessionInitParams, preds) == (1.0, 1.0), env
        m.close()
    base.close()


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_params_default_serves(arch, files):
    """The reference's defaults reach every family: Model(path) with
    ModelParams() (float32, attn="xla") and Instance(InstanceInitParams())
    (f32 KV rows, the training context) open the file, prove and replay at
    exactly 1.0."""
    m = Model(files[arch], ModelParams(device="cpu"))
    assert m.params.dtype == "float32" and m.config.attn_fused is False
    inst = Instance(m, InstanceInitParams())
    preds = _generate(inst, m.vocab, SessionInitParams, CompleteParams, 5)
    assert len(preds) == 5
    assert _verify(inst, m.vocab, SessionInitParams, preds) == (1.0, 1.0)
    m.close()


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_scheduler_serves_the_families(arch, port_models):
    """The continuous-batching scheduler on the paged pool builds the
    family's static (biases, scale, (1 + w) norms in its steps): three
    greedy requests, each verified through the scheduler at exactly 1.0."""
    pm = port_models(arch, "q4k_a8", "fused")
    sched = ContinuousBatchingScheduler(pm, max_batch=4, ctx_size=128, paged=True, horizon=4)
    prompts = [pm.vocab.tokenize(t, True, True)
               for t in ("hello world the cat", "the cat sat on the", PROMPT)]
    gen, scores = {}, {}
    for i, p in enumerate(prompts):
        sched.submit(GenRequest(prompt=p, max_tokens=6, sampler_params=SamplerParams(temp=0.0),
                                on_done=lambda g, i=i: gen.__setitem__(i, g)))
    sched.run_until_idle()
    assert all(len(gen[i]) == 6 for i in range(3))
    for i, p in enumerate(prompts):
        sched.submit(VerifyRequest(prompt=p, predictions=gen[i],
                                   on_done=lambda s, i=i: scores.__setitem__(i, s)))
    sched.run_until_idle()
    assert scores == {0: 1.0, 1: 1.0, 2: 1.0}
