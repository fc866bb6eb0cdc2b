"""The dense engines (`ModelParams(dtype="float32" | "bfloat16")`, the
reference's defaults) on the CPU, against the JAX package: the forward at
both attention modes and every store type, the f32-query plain versions of
kernels C, D, E and F against the JAX kernels in interpret mode, the
perplexity path, mixed k-quant files read by both packages, replays, and
the instance's loud switch to the two-pass mode.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.gguf.reader import GGUFReader as JReader
from blama_tpu.ops.pallas import decode_attention as jda
from blama_tpu.ops.pallas import paged_attention as jpa
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.tools import perplexity as jppl
from blama_tpu_torch import testing
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.gguf.reader import GGUFReader
from blama_tpu_torch.models import llama
from blama_tpu_torch.ops import decode_attention as da
from blama_tpu_torch.ops import paged_attention as pa
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.tools import perplexity as pppl

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KV = ("float32", "bfloat16", "int8")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    out = {}
    for name, quant in (("q4k", GGMLType.Q4_K), ("q5km", testing.Q5_K_M)):
        out[name] = str(d / f"{name}.gguf")
        testing.write_tiny_llama(out[name], quant)
    return out


@pytest.fixture(scope="module")
def models(files):
    cache = {}

    def get(side, file, dtype, attn):
        key = (side, file, dtype, attn)
        if key not in cache:
            if side == "port":
                cache[key] = Model(files[file], ModelParams(dtype=dtype, attn=attn,
                                                            device="cpu"))
            else:
                cache[key] = JModel(files[file], JModelParams(dtype=dtype, attn=attn))
        return cache[key]

    yield get
    for m in cache.values():
        m.close()


def _generate(inst, vocab, n, prompt=PROMPT):
    s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(prompt, True, True))
    preds = s.complete(CompleteParams(max_tokens=n))
    inst.stop_session()
    return preds


def _score(inst, vocab, preds, prompt=PROMPT):
    s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(prompt, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg = MetricsAggregator()
    sims = []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims)), replayed


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_weights_equal_jax(files, models, dtype):
    """Every tensor as the reference's load_llama_params(fused_quant=False)
    leaves it: matmul weights (n_in, n_out) in `dtype`, equal value for
    value; the norms f32 of their dtype-rounded values; the tied-or-not head
    its (E, V) weight (the reference pads V to a multiple of 128)."""
    pm, jm = models("port", "q4k", dtype, "xla"), models("jax", "q4k", dtype, "xla")
    pw, jw = pm.weights, jm.weights
    dt = DTYPES[dtype]
    assert pw["tok_emb"].dtype == dt
    np.testing.assert_array_equal(pw["tok_emb"].float().numpy(),
                                  np.asarray(jw["tok_emb"].astype(jnp.float32)))
    V = pw["tok_emb"].shape[0]
    np.testing.assert_array_equal(pw["output"].float().numpy(),
                                  np.asarray(jw["output"].astype(jnp.float32))[:, :V])
    np.testing.assert_array_equal(pw["out_norm"].numpy(),
                                  np.asarray(jw["out_norm"].astype(jnp.float32)))
    for i, p in enumerate(pw["layers"]):
        for key, w in p.items():
            ref = np.asarray(jw["layers"][key][i].astype(jnp.float32))
            assert w.dtype == (torch.float32 if key.endswith("_norm") else dt), key
            np.testing.assert_array_equal(w.float().numpy(), ref, err_msg=key)


def test_mixed_k_quant_files_read_by_both_packages(files, tmp_path):
    """A tiny Q5_K_M file (Q5_K, Q6_K head, attn_v / ffn_down Q6_K where
    llama.cpp's recipe says so) and a Q3_K_M one: both packages' readers give
    the same types and the same dequantized values, tensor for tensor, and
    the port's device dequantizer (ops/dequant) the same again."""
    q3 = str(tmp_path / "q3km.gguf")
    testing.write_tiny_llama(q3, testing.Q3_K_M, spec=dict(n_layer=3))
    for path, recipe in ((files["q5km"], testing.Q5_K_M), (q3, testing.Q3_K_M)):
        pr, jr = GGUFReader(path), JReader(path)
        L = 3 if recipe == testing.Q3_K_M else 2
        types = set()
        for name in pr.tensor_names():
            info = pr.tensors[name]
            assert info.ggml_type.value == jr.tensors[name].ggml_type.value
            if name.endswith("norm.weight"):
                continue
            assert info.ggml_type == testing.mixed_type(recipe, name, L), name
            types.add(info.ggml_type)
            ref = jr.tensor_float(name)
            np.testing.assert_array_equal(pr.tensor_float(name), ref)
            np.testing.assert_array_equal(llama.tensor_values(pr, name, "cpu").numpy(), ref)
        want = ({GGMLType.Q5_K, GGMLType.Q6_K} if recipe == testing.Q5_K_M
                else {GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K})
        assert types == want
        pr.close()
        jr.close()


def test_synthesized_mixed_files_have_their_statistics(tmp_path):
    """The direct Q5_K and Q3_K packers (for 8B-width files in seconds):
    every tensor of a synthesized Q5_K_M / Q3_K_M file dequantizes to values
    centred on 0 with the std asked for, within 25%."""
    for recipe in (testing.Q5_K_M, testing.Q3_K_M):
        path = str(tmp_path / f"{recipe}.gguf")
        testing.synthesize_llama_gguf(path, "debug-0.3b", quant=recipe, n_layer=2)
        r = GGUFReader(path)
        for name in ("blk.0.attn_q.weight", "blk.1.ffn_down.weight", "output.weight"):
            w = r.tensor_float(name)
            sigma = 1.0 / np.sqrt(w.shape[1])
            assert abs(w.mean()) < 0.1 * sigma and 0.75 < w.std() / sigma < 1.25, (recipe, name)
        r.close()


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

# (dtype, attn) → the largest port-vs-JAX logit gap over the five chunks and
# the three stores, as a share of the largest logit, measured on the tiny
# fixture; each case is held to 1.5 x its reading. float32 agrees to f32
# rounding of sums taken in other orders (under "fused" a bf16 store may
# round a K element the other way: 4.6e-6); bfloat16 carries the bf16
# rounding of a residual stream whose sums differ in order, as the packed
# engines do.
FORWARD_GAPS = {
    ("float32", "xla"): 1.30e-6, ("float32", "fused"): 4.61e-6,
    ("bfloat16", "xla"): 1.45e-2, ("bfloat16", "fused"): 1.45e-2,
}


@pytest.mark.parametrize("file,kv", [("q4k", kv) for kv in KV] + [("q5km", "float32")])
@pytest.mark.parametrize("dtype,attn", list(FORWARD_GAPS), ids=[f"{d}-{a}" for d, a in FORWARD_GAPS])
def test_dense_forward_matches_jax(models, dtype, attn, file, kv):
    """Prefill of the prompt (the fused prefill route at T = 8 under
    attn="fused") and 4 decode steps, against the reference's forward, on
    the all-Q4_K fixture at every store and on the Q5_K_M one at the
    reference's default store (f32)."""
    pm, jm = models("port", file, dtype, attn), models("jax", file, dtype, attn)
    pi = Instance(pm, InstanceInitParams(ctx_size=64, kv_dtype=kv))
    ji = JInstance(jm, JInstanceInitParams(ctx_size=64, kv_dtype=kv))
    assert pi.step_config.attn_fused == (attn == "fused")
    chunks = [pm.vocab.tokenize(PROMPT, True, True), [77], [5], [6], [7]]
    nxt = 0
    for toks in chunks:
        pos = np.arange(nxt, nxt + len(toks))
        nxt += len(toks)
        ref = ji.decode(toks, pos)
        out = pi.decode(toks, pos)
        assert out.shape == ref.shape == (pm.config.n_vocab,) and out.dtype == np.float32
        gap = np.abs(out - ref).max() / np.abs(ref).max()
        assert gap <= 1.5 * FORWARD_GAPS[(dtype, attn)], (len(toks), gap)
        assert np.argmax(out) == np.argmax(ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_all_logits_match_jax(files, models, dtype):
    """Logits at every position (the perplexity path), against the
    reference's all_logits, within the forward's gap."""
    from blama_tpu.models import llama as jllama
    from blama_tpu.ops.kv_cache import KVCache as JKVCache
    from blama_tpu_torch.ops.kv_cache import KVCache

    pm, jm = models("port", "q4k", dtype, "fused"), models("jax", "q4k", dtype, "fused")
    cfg, T = pm.config, 16
    toks = np.arange(3, 3 + T, dtype=np.int32)[None]
    pos = np.arange(T, dtype=np.int32)[None]
    ref = jllama.all_logits(jllama.LlamaStatic.of(jm.config), jm.weights, jnp.asarray(toks),
                            jnp.asarray(pos), jnp.asarray(pos),
                            JKVCache.create(cfg.n_layer, 1, T, cfg.n_head_kv, cfg.head_dim_,
                                            jnp.float32))[0]
    out = llama.all_logits(llama.LlamaStatic.of(cfg), pm.weights, torch.from_numpy(toks),
                           torch.from_numpy(pos), torch.from_numpy(pos),
                           KVCache.create(cfg.n_layer, 1, T, cfg.n_head_kv, cfg.head_dim_,
                                          torch.float32, device="cpu"))
    ref = np.asarray(ref)[..., :cfg.n_vocab]
    assert out.shape == ref.shape == (1, T, cfg.n_vocab)
    gap = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert gap <= 1.5 * FORWARD_GAPS[(dtype, "fused")], gap


def test_perplexity_matches_jax(files, models):
    """The perplexity tool over two windows of a pseudo-token corpus, the
    port's against the reference's, on the float32 engine."""
    pm, jm = models("port", "q4k", "float32", "fused"), models("jax", "q4k", "float32", "fused")
    tokens = np.random.default_rng(42).integers(3, pm.config.n_vocab - 1, 2 * 16 + 1).tolist()
    ref = jppl.perplexity(jm, tokens, ctx=16)
    out = pppl.perplexity(pm, tokens, ctx=16)
    assert out["count"] == ref["count"] == 24
    assert abs(out["nll"] - ref["nll"]) <= 1e-5 * abs(ref["nll"])
    assert abs(out["ppl"] - ref["ppl"]) <= 1e-4 * ref["ppl"]


# ---------------------------------------------------------------------------
# the f32-query plain versions of C, D, E and F against the JAX kernels
# ---------------------------------------------------------------------------

B, S, HKV, H, D = 2, 128, 2, 4, 64
G = 32


def _store(kv, seed):
    rng = np.random.default_rng(seed)
    if kv == "int8":
        k, v = (rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.02, (B, S, HKV)).astype(np.float32) for _ in range(2))
    else:
        dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        k, v = (np.asarray(jnp.asarray(rng.standard_normal((B, S, HKV, D)), dt))
                for _ in range(2))
        ks = vs = None
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, 7::13] = -1
    pos[1, 90:] = -1
    pos[0, 40] = 10 * S
    return k, v, ks, vs, pos


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else llama._to_torch(a, "cpu")


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("kernel", ["C", "D", "E", "F"])
def test_f32_query_plain_versions_match_jax(kernel, kv):
    """f32 queries in, f32 out, as the reference's kernels take the model's
    dtype: each plain version within f32 rounding of sums in another order
    (online vs one-pass softmax) of the JAX kernel in interpret mode."""
    k, v, ks, vs, pos = _store(kv, seed=len(kernel + kv))
    T = 1 if kernel in "CE" else 16
    q = np.random.default_rng(5).standard_normal((B, T, H, D)).astype(np.float32)
    qp = np.stack([np.arange(T) + 80 - T, np.arange(T) + 85 - T]).astype(np.int32)
    inv, ms = jda.effective_inv_freq(D, D, 10000.0)
    pinv, pms = da.effective_inv_freq(D, D, 10000.0)
    jargs = dict(k_scale=_j(ks), v_scale=_j(vs), mscale=ms)
    pargs = dict(k_scale=_t(ks), v_scale=_t(vs), mscale=pms)
    if kernel in "CD":
        if kernel == "C":
            ref = jda.decode_attention(_j(q), _j(k), _j(v), _j(qp[:, 0]), _j(pos), inv, **jargs)
            out = da.decode_attention(_t(q), _t(k), _t(v), _t(qp[:, 0]), _t(pos), pinv, **pargs)
        else:
            ref = jda.prefill_attention(_j(q), _j(k), _j(v), _j(qp), _j(pos), inv, **jargs)
            out = da.prefill_attention(_t(q), _t(k), _t(v), _t(qp), _t(pos), pinv, **pargs)
    else:
        # the rows on pages of G slots, row 1's pages first (a scrambled pool)
        mp = S // G
        table = np.concatenate([np.arange(mp, 2 * mp), np.arange(mp)]).reshape(B, mp)
        table = table[::-1].astype(np.int32).copy()
        pool = lambda a: None if a is None else \
            a[::-1].reshape(B * mp, G, *a.shape[2:]).copy()   # noqa: E731
        pk, pv, pks, pvs, ppos = (pool(a) for a in (k, v, ks, vs, pos))
        jargs.update(k_scale=_j(pks), v_scale=_j(pvs))
        pargs.update(k_scale=_t(pks), v_scale=_t(pvs))
        if kernel == "E":
            ref = jpa.paged_decode_attention(_j(q), _j(pk), _j(pv), _j(ppos), _j(table),
                                             _j(qp[:, 0]), inv, **jargs)
            out = pa.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(ppos), _t(table),
                                            _t(qp[:, 0]), pinv, **pargs)
        else:
            ref = jpa.paged_prefill_attention(_j(q), _j(pk), _j(pv), _j(ppos), _j(table),
                                              _j(qp), inv, **jargs)
            out = pa.paged_prefill_attention(_t(q), _t(pk), _t(pv), _t(ppos), _t(table),
                                             _t(qp), pinv, **pargs)
    ref = np.asarray(ref)
    assert ref.dtype == np.float32 and out.dtype == torch.float32
    assert tuple(out.shape) == ref.shape == (B, T, H, D)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


# ---------------------------------------------------------------------------
# replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", ["xla", "fused"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_same_backend_replay_is_exact(models, dtype, attn):
    """Prove, then replay in one chunk (fill_ctx): exactly 1.0, logit for
    logit, on each dense engine in each mode, on the reference's default
    store (f32 rows)."""
    pm = models("port", "q4k", dtype, attn)
    inst = Instance(pm, InstanceInitParams(ctx_size=64))
    preds = _generate(inst, pm.vocab, 8)
    score, sim, replayed = _score(inst, pm.vocab, preds)
    assert len(preds) == 8 and score == 1.0 and sim == 1.0
    for o, r in zip(preds, replayed, strict=True):
        assert [(t.token, t.logit) for t in o.logits] == [(t.token, t.logit) for t in r.logits]


@pytest.mark.parametrize("prover,verifier", [("bfloat16", "q4k_fused"),
                                             ("float32", "bfloat16")])
def test_cross_engine_replay_passes_the_reference_gates(models, prover, verifier):
    """A prover on one engine replayed by a verifier on another (the
    reference's cross-engine gates: score >= 0.95, similarity >= 0.98)."""
    pm, vm = models("port", "q4k", prover, "fused"), models("port", "q4k", verifier, "fused")
    preds = _generate(Instance(pm, InstanceInitParams(ctx_size=64)), pm.vocab, 10)
    score, sim, _ = _score(Instance(vm, InstanceInitParams(ctx_size=64)), vm.vocab, preds)
    assert score >= 0.95 and sim >= 0.98, (score, sim)


@pytest.mark.parametrize("attn", ["xla", "fused"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_q5_k_m_file_replays_on_the_dense_engine(models, dtype, attn):
    pm = models("port", "q5km", dtype, attn)
    inst = Instance(pm, InstanceInitParams(ctx_size=64))
    preds = _generate(inst, pm.vocab, 6)
    assert _score(inst, pm.vocab, preds)[:2] == (1.0, 1.0)


# ---------------------------------------------------------------------------
# the instance's mode switch, the dense product
# ---------------------------------------------------------------------------

def test_instance_switches_to_the_chain_loudly(models, caplog):
    """Where the fused gates reject the geometry (ctx_size = 60 fits no
    block of the fused route), the instance warns, as the reference does,
    and its step config records attn_fused=False; the session then runs the
    chain, and its records replay at 1.0 in that mode."""
    pm = models("port", "q4k", "float32", "fused")
    with caplog.at_level(logging.WARNING, logger="blama_tpu_torch"):
        inst = Instance(pm, InstanceInitParams(ctx_size=60, kv_dtype="int8"))
    assert "fused kernel rejects this geometry" in caplog.text
    assert "ctx_size=60" in caplog.text
    assert inst.step_config.attn_fused is False and inst._st.attn_fused is False
    assert pm.config.attn_fused is True      # the model keeps its own mode
    preds = _generate(inst, pm.vocab, 4)
    assert _score(inst, pm.vocab, preds)[0] == 1.0
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="blama_tpu_torch"):
        inst = Instance(pm, InstanceInitParams(ctx_size=64, kv_dtype="int8"))
    assert inst.step_config.attn_fused is True and not caplog.text


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_products_give_each_row_its_bits(dtype):
    """quant_matmul.rows_mm on the CPU: a row alone, in a batch of 5 or of
    17 rows gives the same bits; products and sums in f32 (bf16 operands
    exact there), the result in the caller's dtype."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn((17, 96), generator=g).to(dtype)
    w = torch.randn((96, 40), generator=g).to(dtype)
    full = qm.rows_mm(a, w)
    assert full.dtype == dtype
    assert torch.equal(qm.rows_mm(a[:5], w), full[:5])
    assert torch.equal(qm.rows_mm(a[3:4], w), full[3:4])
    f32 = qm.rows_mm(a, w, out_dtype=torch.float32)
    ref = a.double() @ w.double()
    assert (f32.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_ppl_compare_runs_every_engine_on_the_cpu(monkeypatch, tmp_path):
    """tools/ppl_compare on a synthesized checkpoint cut to one layer: the
    perplexity under `bfloat16`, `q4k_fused` and `q4k_a8` over the same
    pseudo-tokens, and each packed engine's delta against `bfloat16`; the
    exact engine's values are the bf16 engine's up to bf16 rounding, so its
    delta is the smaller."""
    from blama_tpu_torch.tools import ppl_compare

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    out = ppl_compare.main(["debug-0.3b", "16", "2", "--layers", "1", "--device", "cpu"])
    assert set(out["ppl"]) == set(ppl_compare.ENGINES)
    assert all(np.isfinite(v) and v > 1.0 for v in out["ppl"].values())
    d = out["delta_vs_bf16_pct"]
    # measured: q4k_fused +0.014%, q4k_a8 -0.161% (random weights, 24 tokens)
    assert set(d) == {"q4k_fused", "q4k_a8"} and abs(d["q4k_fused"]) < abs(d["q4k_a8"]) < 1.0
