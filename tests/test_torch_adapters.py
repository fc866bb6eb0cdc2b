"""LoRA adapters and control vectors in the port, against the JAX package,
on the CPU (the reference's surface: LoraAdapter.cpp, ControlVector.cpp,
Instance.cpp:52-84; its tests/test_adapters.py).

Both packages load the same tiny GGUFs and the same adapter files (made from
a seed with numpy). The dense engines fold an adapter into the weights; the
packed engines add a runtime low-rank term beside the kernels
(quant_matmul.LoraWrapped), so a cleared packed model gives its bare bits
back, and a fused projection layout (BLAMA_FUSE_PROJ / BLAMA_FUSE_KV) keeps
the unfused bits with an adapter too. Tolerances: the float32 engine's
logits within 1e-5 of the largest (f32 sums in another order; measured
1.6e-6), a packed engine's within 3% (bf16 activations and the kernels' sum
orders, the gaps of tests/test_torch_engines.py: measured 0.9-1.8% with an
adapter), each far below what the adapter moves (~50-100% of the largest
logit); a replay on the same backend exactly 1.0; across backends the
reference's thresholds, 0.95 aggregate and 0.98 mean similarity. The JAX
W4A8 engine runs under jax.disable_jit() (ROADMAP.md §3 hazards).
"""

import jax
import numpy as np
import pytest
import torch

from blama_tpu.ops.pallas.quant_matmul import LoraWrapped as JLoraWrapped
from blama_tpu.runtime.control_vector import ControlVector as JControlVector
from blama_tpu.runtime.control_vector import ControlVectorLoadInfo as JControlVectorLoadInfo
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.lora import LoraAdapter as JLoraAdapter
from blama_tpu.runtime.lora import lora_deltas as jlora_deltas
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu.testing import write_tiny_gpt2
from blama_tpu_torch import testing
from blama_tpu_torch.gguf import GGMLType, GGUFWriter
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.ops import step_graph as sg
from blama_tpu_torch.runtime.control_vector import (ControlVector, ControlVectorLoadInfo,
                                                    write_control_vector)
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.lora import LoraAdapter, lora_deltas
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"
CTX = 64
F32_TOL = 1e-5      # x max|ref|, the float32 engine
PACKED_TOL = 0.03   # x max|ref|, a packed engine
FUSE_SPEC = dict(n_head_kv=4)   # every part of a fused layout unpadded (test_torch_fuse_proj)


def _shapes(spec=None):
    s = {**testing.TINY_LLAMA_SPEC, **(spec or {})}
    return testing.lora_shapes(s["n_embd"], s["n_head"], s["n_head_kv"], s["n_ff"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("adapters")
    out = {}
    for name, quant, spec in (("q4k", GGMLType.Q4_K, None), ("q8", GGMLType.Q8_0, None),
                              ("tp", GGMLType.Q4_K, testing.TP_TINY_SPEC),
                              ("fuse", GGMLType.Q4_K, FUSE_SPEC)):
        out[name] = str(d / f"{name}.gguf")
        testing.write_tiny_llama(out[name], quant, spec=spec)
    out["moe"] = str(d / "moe.gguf")
    testing.synthesize_moe_gguf(out["moe"], "mixtral-debug")
    out["phi3"] = str(d / "phi3.gguf")
    testing.write_tiny_family(out["phi3"], "phi3")
    out["gpt2"] = str(d / "gpt2.gguf")
    write_tiny_gpt2(out["gpt2"])
    # adapters: the reference's fixture (attn_q, r 4) and a second one (r 2),
    # every projection (r 4) at the tiny, tp and fused widths, q / v and k / v
    for name, kw in (("q", dict(seed=11)), ("q2", dict(seed=22, r=2)),
                     ("all", dict(seed=21, targets=testing.LORA_TARGETS, shapes=_shapes())),
                     ("all_tp", dict(seed=21, targets=testing.LORA_TARGETS,
                                     shapes=_shapes(testing.TP_TINY_SPEC))),
                     ("all_fuse", dict(seed=23, targets=testing.LORA_TARGETS,
                                       shapes=_shapes(FUSE_SPEC))),
                     ("qv_fuse", dict(seed=24, targets=("attn_q", "attn_v"),
                                      shapes=_shapes(FUSE_SPEC))),
                     ("kv_fuse", dict(seed=25, targets=("attn_k", "attn_v"),
                                      shapes=_shapes(FUSE_SPEC))),
                     ("qkv", dict(seed=26, targets=("attn_qkv",),
                                  shapes={"attn_qkv": (512, 256)}))):
        out["lora_" + name] = str(d / f"lora-{name}.gguf")
        testing.write_tiny_lora(out["lora_" + name], **{"a_scale": None, **kw}
                                if name not in ("q", "q2") else kw)
    rng = np.random.default_rng(3)
    out["cvec"] = str(d / "cvec.gguf")
    write_control_vector(out["cvec"], {1: rng.standard_normal(256).astype(np.float32) * 2.0,
                                       2: rng.standard_normal(256).astype(np.float32) * 2.0})
    return out


def _port(path, dtype="q4k_fused", monkeypatch=None, switch=None, **kw):
    if switch:
        monkeypatch.setenv(switch, "1")
    m = Model(path, ModelParams(dtype=dtype, device="cpu", **kw))
    if switch:
        monkeypatch.delenv(switch)
    return m


def _jax(path, dtype="q4k_fused", monkeypatch=None, switch=None, **kw):
    if switch:
        monkeypatch.setenv(switch, "1")
    m = JModel(path, JModelParams(dtype=dtype, **kw))
    if switch:
        monkeypatch.delenv(switch)
    return m


def _chunks(vocab, n=4):
    return [vocab.tokenize(PROMPT, True, True), [77], [5, 6, 7], list(range(50, 70))][:n]


def _decode(inst, chunks, w4a8=False):
    """Each chunk's last-token logits on a cleared store, one after another."""
    inst.clear_cache()
    out, nxt = [], 0
    for toks in chunks:
        with jax.disable_jit(w4a8):
            out.append(inst.decode(toks, np.arange(nxt, nxt + len(toks))))
        nxt += len(toks)
    return out


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _generate(inst, vocab, sess=SessionInitParams, cp=CompleteParams, n=8):
    s = inst.start_session(sess(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    preds = s.complete(cp(max_tokens=n))
    inst.stop_session()
    return preds


def _verify(inst, vocab, preds, sess=SessionInitParams):
    s = inst.start_session(sess(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims)), replayed


def _top10(preds):
    return [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds]


def _inst(m, **kw):
    return Instance(m, InstanceInitParams(ctx_size=CTX, **kw))


def _jinst(m, **kw):
    return JInstance(m, JInstanceInitParams(ctx_size=CTX, **kw))


# -- load and scale --------------------------------------------------------------

def test_lora_load_metadata_and_scale(files):
    """The reference's test: rank, alpha, alpha/r and the tensor names; the
    port's arrays and deltas equal the JAX package's bit for bit."""
    ad, jad = LoraAdapter(files["lora_q"]), JLoraAdapter(files["lora_q"])
    assert ad.rank() == 4 and ad.alpha == 8.0
    assert ad.effective_scale(1.0) == pytest.approx(2.0) == jad.effective_scale(1.0)
    assert set(ad.tensors) == set(jad.tensors) == {"blk.0.attn_q.weight", "blk.1.attn_q.weight"}
    for k, t in ad.tensors.items():
        assert np.array_equal(t.a, jad.tensors[k].a) and np.array_equal(t.b, jad.tensors[k].b)
    pd, jd = lora_deltas(ad, 2, 3.0), jlora_deltas(jad, 2, 3.0)
    assert pd.keys() == jd.keys() == {"wq"}
    for layer in (0, 1):
        assert np.array_equal(pd["wq"][layer], jd["wq"][layer])
    every = LoraAdapter(files["lora_all"])
    assert {k.split(".", 2)[2] for k in every.tensors} == {
        f"{t}.weight" for t in testing.LORA_TARGETS}


def test_lora_rejects_a_broken_file(tmp_path):
    p = str(tmp_path / "half.gguf")
    w = GGUFWriter(p)
    w.add_kv("adapter.type", "lora")
    w.add_tensor("blk.0.attn_q.weight.lora_a", np.ones((2, 8), np.float32), GGMLType.F32)
    w.write()
    with pytest.raises(ValueError, match="incomplete lora pair"):
        LoraAdapter(p)
    p2 = str(tmp_path / "cv.gguf")
    w = GGUFWriter(p2)
    w.add_kv("adapter.type", "control_vector")
    w.write()
    with pytest.raises(ValueError, match="not a lora adapter"):
        LoraAdapter(p2)


def test_adapters_stack_in_segments(files):
    """Two adapters stack along the rank axis of one segment, (tag, rank)
    pieces in order, with the reference's stacked a and b; detaching strips
    one piece and leaves the other's arrays as they were."""
    pm, jm = _port(files["q4k"]), _jax(files["q4k"])
    pi, ji = _inst(pm), _jinst(jm)
    bare = pm.weights["layers"][0]["wq"]
    for inst in (pi, ji):
        inst.add_lora(LoraAdapter(files["lora_q"]) if inst is pi
                      else JLoraAdapter(files["lora_q"]), scale=4.0)
        inst.add_lora(LoraAdapter(files["lora_q2"]) if inst is pi
                      else JLoraAdapter(files["lora_q2"]), scale=4.0)
    w, jw = pm.weights["layers"][0]["wq"], jm.weights["layers"][0]["wq"]
    assert isinstance(w, qm.LoraWrapped) and isinstance(jw, JLoraWrapped)
    (seg,) = w.segments
    assert seg.off == 0 and seg.a.shape == (256, 6) and seg.b.shape == (6, 256)
    assert [r for _, r in seg.tags] == [r for _, r in jw.tags] == [4, 2]
    assert np.array_equal(seg.a.numpy(), np.asarray(jw.a))
    assert np.array_equal(seg.b.numpy(), np.asarray(jw.b))
    assert w.base is bare
    first = pi._loras[0]
    pi._loras.pop(0)
    from blama_tpu_torch.runtime.lora import apply_lora

    pm.weights = apply_lora(pm.weights, first[0], first[1], -1.0)
    (seg,) = pm.weights["layers"][0]["wq"].segments
    assert seg.a.shape == (256, 2) and np.array_equal(seg.a.numpy(), np.asarray(jw.a)[:, 4:])
    pi.clear_lora_state()
    assert pm.weights["layers"][0]["wq"] is bare
    pm.close()
    jm.close()


# -- parity with the reference ----------------------------------------------------

# (file, engine, tp_blocks, attention, adapter): the float32 fold on the
# tiny Q8_0 llama, the packed runtime term on q4k_fused and q4k_a8, and the
# tp_blocks mode at 8 blocks (pinned and K-blocked products)
PARITY = [("q8", "float32", -1, "xla", "lora_all"), ("q4k", "q4k_fused", -1, "fused", "lora_all"),
          ("q4k", "q4k_a8", -1, "fused", "lora_all"), ("tp", "q4k_fused", 8, "xla", "lora_all_tp")]


@pytest.mark.parametrize("file,dtype,tpb,attn,lora", PARITY,
                         ids=[f"{d}-tp{t}" for _, d, t, _, _ in PARITY])
def test_lora_logits_match_the_reference(files, file, dtype, tpb, attn, lora):
    """The same adapter on both sides: the logits of a prompt chunk and the
    chunks after it agree within the engine's tolerance, and the adapter
    moves them far beyond it (a side that dropped it would fail)."""
    tol = F32_TOL if dtype == "float32" else PACKED_TOL
    w4a8 = dtype == "q4k_a8"
    pm = _port(files[file], dtype, tp_blocks=tpb, attn=attn)
    jm = _jax(files[file], dtype, tp_blocks=tpb, attn=attn)
    pi, ji = _inst(pm), _jinst(jm)
    chunks = _chunks(pm.vocab, 2 if w4a8 else 4)
    bare = _decode(pi, chunks)
    pi.add_lora(LoraAdapter(files[lora]), scale=1.0)
    ji.add_lora(JLoraAdapter(files[lora]), scale=1.0)
    if dtype != "float32":
        wrapped = {k for k, w in pm.weights["layers"][0].items()
                   if isinstance(w, qm.LoraWrapped)}
        assert wrapped == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    got, ref = _decode(pi, chunks), _decode(ji, chunks, w4a8)
    for i, (g, r, b) in enumerate(zip(got, ref, bare, strict=True)):
        assert _gap(g, r) <= tol, (i, _gap(g, r))
        assert _gap(b, r) > 10 * tol, (i, _gap(b, r))
    pm.close()
    jm.close()


@pytest.mark.parametrize("dtype", ["float32", "q4k_fused", "q4k_a8"])
def test_same_backend_replay_with_an_adapter_is_exact(files, dtype):
    """Prefill chunks against decode rows with an adapter attached: a
    replay scores exactly 1.0 with equal logits, and the adapter changes
    the generation."""
    pm = _port(files["q8" if dtype == "float32" else "q4k"], dtype)
    pi = _inst(pm)
    bare = _generate(pi, pm.vocab)
    pi.add_lora(LoraAdapter(files["lora_all"]), scale=1.0)
    preds = _generate(pi, pm.vocab)
    assert [p.token for p in preds] != [p.token for p in bare]
    score, sim, replayed = _verify(pi, pm.vocab, preds)
    assert score == 1.0 and sim == 1.0 and _top10(replayed) == _top10(preds)
    pm.close()


@pytest.mark.parametrize("dtype", ["float32", "q4k_fused"])
def test_cross_backend_replay_with_an_adapter(files, dtype):
    """A port prover and a JAX verifier, then a JAX prover and a port
    verifier, each side with the same adapter attached: the reference's
    thresholds both ways."""
    file = "q8" if dtype == "float32" else "q4k"
    pm, jm = _port(files[file], dtype), _jax(files[file], dtype)
    pi, ji = _inst(pm), _jinst(jm)
    pi.add_lora(LoraAdapter(files["lora_all"]), scale=1.0)
    ji.add_lora(JLoraAdapter(files["lora_all"]), scale=1.0)
    ppreds = _generate(pi, pm.vocab, n=10)
    jpreds = _generate(ji, jm.vocab, JSessionInitParams, JCompleteParams, n=10)
    for inst, vocab, sess, preds in ((ji, jm.vocab, JSessionInitParams, ppreds),
                                     (pi, pm.vocab, SessionInitParams, jpreds)):
        score, sim, _ = _verify(inst, vocab, preds, sess)
        assert score >= 0.95 and sim >= 0.98, (dtype, score, sim)
    pm.close()
    jm.close()


# -- restore --------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tpb", [("q4k_fused", -1), ("q4k_a8", -1), ("q4k_a8_k4", -1),
                                       ("q4k_fused", 4), ("q4k_a8", 4)])
def test_clearing_a_packed_model_gives_its_bare_bits(files, dtype, tpb):
    """Attach two adapters, clear: every weight is the bare object again and
    the logits equal the bare model's bit for bit."""
    pm = _port(files["tp" if tpb > 0 else "q4k"], dtype, tp_blocks=tpb)
    lora = "lora_all_tp" if tpb > 0 else "lora_all"
    pi = _inst(pm)
    chunks = _chunks(pm.vocab)
    before = [dict(p) for p in pm.weights["layers"]]
    bare = _decode(pi, chunks)
    pi.add_lora(LoraAdapter(files[lora]), scale=1.0)
    pi.add_lora(LoraAdapter(files[lora]), scale=0.5)
    with_lora = _decode(pi, chunks)
    assert all(_gap(a, b) > 0.1 for a, b in zip(with_lora, bare))
    pi.clear_lora_state()
    for p, q in zip(pm.weights["layers"], before, strict=True):
        assert p.keys() == q.keys() and all(p[k] is q[k] for k in p)
    for a, b in zip(_decode(pi, chunks), bare, strict=True):
        assert np.array_equal(a, b)
    pm.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clearing_a_dense_model_restores_within_rounding(files, dtype):
    """The dense engines fold and unfold by subtraction, as the reference:
    w' = dtype(dtype(w + d) - d) comes back within one rounding of the
    weight's dtype, not bit for bit (ROADMAP.md §3). Both sides, on the
    same file and adapter, give back weights equal to each other, and
    some differ from the originals (in f32 too, on this adapter)."""
    pm, jm = _port(files["q8"], dtype), _jax(files["q8"], dtype)
    orig = pm.weights["layers"][0]["wq"].clone()
    pi, ji = _inst(pm), _jinst(jm)
    pi.add_lora(LoraAdapter(files["lora_q"]), scale=8.0)
    ji.add_lora(JLoraAdapter(files["lora_q"]), scale=8.0)
    folded = pm.weights["layers"][0]["wq"].float().numpy()
    jfolded = np.asarray(jm.weights["layers"]["wq"][0]).astype(np.float32)
    assert np.array_equal(folded, jfolded)
    pi.clear_lora_state()
    ji.clear_lora_state()
    back = pm.weights["layers"][0]["wq"]
    jback = np.asarray(jm.weights["layers"]["wq"][0]).astype(np.float32)
    assert np.array_equal(back.float().numpy(), jback)
    # two roundings to the dtype, each within half a unit of |w| + |delta|
    delta = torch.from_numpy(lora_deltas(LoraAdapter(files["lora_q"]), 2, 8.0)["wq"][0])
    diff = (back.float() - orig.float()).abs()
    unit = 2.0 ** (-8 if dtype == "bfloat16" else -24)
    assert (diff <= 2 * unit * (orig.float().abs() + delta.abs())).all()
    assert (diff > 0).any()
    pm.close()
    jm.close()


# -- fused layouts ----------------------------------------------------------------

@pytest.mark.parametrize("lora", ["lora_all_fuse", "lora_qv_fuse", "lora_kv_fuse"])
@pytest.mark.parametrize("switch", ["BLAMA_FUSE_PROJ", "BLAMA_FUSE_KV"])
@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_fused_layout_with_an_adapter_keeps_the_unfused_bits(files, monkeypatch, dtype,
                                                              switch, lora):
    """A fused model with an adapter gives the unfused model's tokens,
    top-10 and logits with the same adapter, bit for bit (each part's term
    is computed at the unfused shapes), on the fused kernels over an INT8
    store; and the adapter moves them."""
    fm = _port(files["fuse"], dtype, monkeypatch, switch, attn="fused")
    um = _port(files["fuse"], dtype, attn="fused")
    assert {"wqkv", "wkv"} & set(fm.weights["layers"][0])
    params = dict(flash_attn=True, kv_dtype="int8")
    fi, ui = _inst(fm, **params), _inst(um, **params)
    bare = _generate(ui, um.vocab)
    for inst in (fi, ui):
        inst.add_lora(LoraAdapter(files[lora]), scale=1.0)
    fused, plain = _generate(fi, fm.vocab), _generate(ui, um.vocab)
    assert _top10(fused) == _top10(plain) != _top10(bare)
    score, _, replayed = _verify(ui, um.vocab, fused)
    assert score == 1.0 and _top10(replayed) == _top10(fused)
    fi.clear_lora_state()
    assert _top10(_generate(fi, fm.vocab)) == _top10(bare)
    fm.close()
    um.close()


def test_fuse_kv_applies_what_the_reference_drops(files, monkeypatch):
    """Under BLAMA_FUSE_KV the reference finds no wk / wv (they are wkv) and
    silently drops an adapter on attn_k / attn_v: its logits stay the bare
    model's. The port applies it to wkv's halves (ROADMAP.md §3)."""
    jm = _jax(files["fuse"], "q4k_fused", monkeypatch, "BLAMA_FUSE_KV", attn="fused")
    ji = _jinst(jm)
    chunks = _chunks(jm.vocab, 2)
    jbare = _decode(ji, chunks)
    ji.add_lora(JLoraAdapter(files["lora_kv_fuse"]), scale=1.0)
    assert not isinstance(jm.weights["layers"][0]["wkv"], JLoraWrapped)
    assert all(np.array_equal(a, b) for a, b in zip(_decode(ji, chunks), jbare))
    pm = _port(files["fuse"], "q4k_fused", monkeypatch, "BLAMA_FUSE_KV", attn="fused")
    pi = _inst(pm)
    pbare = _decode(pi, chunks)
    pi.add_lora(LoraAdapter(files["lora_kv_fuse"]), scale=1.0)
    w = pm.weights["layers"][0]["wkv"]
    assert [s.off for s in w.segments] == [0, w.n_out // 2]
    assert all(_gap(a, b) > 10 * PACKED_TOL for a, b in zip(_decode(pi, chunks), pbare))
    pm.close()
    jm.close()


# -- graphs -----------------------------------------------------------------------

def _stub():
    return sg.StepGraphs("cpu", backend=sg.StubBackend())


def _step_and_loop(inst, m):
    """A prompt step, a decode step and a greedy session's tokens and
    top-10 (the device loops) through the instance's graphs."""
    toks = m.vocab.tokenize(PROMPT, True, True)
    inst.clear_cache()
    a = inst.decode(toks, np.arange(len(toks)))
    b = inst.decode([77], np.array([len(toks)]))
    return [a, b], _top10(_generate(inst, m.vocab))


def _same_outputs(x, y):
    return all(np.array_equal(a, b) for a, b in zip(x[0], y[0], strict=True)) and x[1] == y[1]


@pytest.mark.parametrize("what", ["lora", "cvec"])
def test_graphs_captured_before_an_attach_never_replay_stale_weights(files, what):
    """StubBackend graphs (a replay reruns the captured function) on an
    Instance: capture the steps and loops, attach an adapter or a control
    vector, step again: the outputs equal an eager instance's with it and
    differ from the bare ones; detach: the bare bits come back. The graphs
    of the old weights dict are dropped (retain_params)."""
    pm = _port(files["q4k"], "q4k_a8", attn="fused")
    gi, ei = _inst(pm, flash_attn=True), _inst(pm, flash_attn=True, graphs=False)
    gi.graphs = _stub()
    gi.warmup()
    bare = _step_and_loop(gi, pm)
    assert gi.graphs.keys()
    old = pm.weights
    if what == "lora":
        gi.add_lora(LoraAdapter(files["lora_all"]), scale=1.0)
    else:
        gi.apply_control_vector(ControlVector(ControlVectorLoadInfo(files["cvec"], 3.0)))
    assert pm.weights is not old
    attached = _step_and_loop(gi, pm)
    assert {k[-2] for k in gi.graphs.keys()} == {id(pm.weights)}
    assert _same_outputs(attached, _step_and_loop(ei, pm))
    assert not _same_outputs(attached, bare)
    if what == "lora":
        gi.clear_lora_state()
    else:
        gi.apply_control_vector(None)
    assert _same_outputs(_step_and_loop(gi, pm), bare)
    pm.close()


def test_a_dense_fold_keeps_the_weights_dict_and_its_pointers(files):
    """The dense engines fold in place: the weights dict and each tensor's
    storage stay, so a graph captured before the attach replays the folded
    weights (StubBackend), equal to an eager instance's."""
    pm = _port(files["q8"], "float32")
    gi, ei = _inst(pm), _inst(pm, graphs=False)
    gi.graphs = _stub()
    bare = _step_and_loop(gi, pm)
    keys, w0 = gi.graphs.keys(), pm.weights
    ptr = pm.weights["layers"][0]["wq"].data_ptr()
    gi.add_lora(LoraAdapter(files["lora_all"]), scale=1.0)
    assert pm.weights is w0 and pm.weights["layers"][0]["wq"].data_ptr() == ptr
    attached = _step_and_loop(gi, pm)
    assert set(keys) <= set(gi.graphs.keys())
    assert _same_outputs(attached, _step_and_loop(ei, pm))
    assert not _same_outputs(attached, bare)
    pm.close()


# -- control vectors --------------------------------------------------------------

def test_control_vector_parse_and_sum(files, tmp_path):
    p1, p2 = str(tmp_path / "cv1.gguf"), str(tmp_path / "cv2.gguf")
    v1 = np.arange(256, dtype=np.float32) * 0.01
    v2 = np.ones(256, np.float32)
    write_control_vector(p1, {1: v1, 2: v2})
    write_control_vector(p2, {2: v2})
    infos = [ControlVectorLoadInfo(p1, strength=2.0), ControlVectorLoadInfo(p2, strength=-1.0)]
    cv = ControlVector(infos)
    jcv = JControlVector([JControlVectorLoadInfo(i.gguf_path, i.strength) for i in infos])
    np.testing.assert_allclose(cv.directions[1], v1 * 2.0)
    np.testing.assert_allclose(cv.directions[2], v2 * 2.0 - v2)
    for args in ((2, 1, 2), (2, 2, 2), (3, 1, 3)):
        assert np.array_equal(cv.as_layer_bias(*args), jcv.as_layer_bias(*args))
    assert np.all(cv.as_layer_bias(2, 2, 2)[0] == 0.0)


def test_control_vector_bad_files(tmp_path):
    p = str(tmp_path / "bad.gguf")
    w = GGUFWriter(p)
    w.add_tensor("not_direction.1", np.ones(8, np.float32), GGMLType.F32)
    w.write()
    with pytest.raises(ValueError, match="invalid control vector tensor name"):
        ControlVector(ControlVectorLoadInfo(p))
    p0 = str(tmp_path / "zero.gguf")
    write_control_vector(p0, {0: np.ones(8, np.float32)})
    with pytest.raises(ValueError, match="must be > 0"):
        ControlVector(ControlVectorLoadInfo(p0))


@pytest.mark.parametrize("dtype", ["float32", "q4k_fused"])
def test_control_vector_steers_matches_and_detaches(files, dtype):
    """A control vector steers the generation; the bias is in the
    embedding table's dtype (f32 under float32, bf16 for the packed table),
    the logits match the reference's with the same vector within the
    engine's tolerance, a replay is exactly 1.0, and cvec=None gives the
    bare bits back."""
    file = "q8" if dtype == "float32" else "q4k"
    pm, jm = _port(files[file], dtype), _jax(files[file], dtype)
    pi, ji = _inst(pm), _jinst(jm)
    chunks = _chunks(pm.vocab)
    bare, bare_gen = _decode(pi, chunks), _generate(pi, pm.vocab)
    cv = ControlVector(ControlVectorLoadInfo(files["cvec"], strength=3.0))
    pi.apply_control_vector(cv)
    ji.apply_control_vector(JControlVector(JControlVectorLoadInfo(files["cvec"], 3.0)))
    bias = pm.weights["layers"][0]["cvec"]
    assert bias.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else PACKED_TOL
    for g, r, b in zip(_decode(pi, chunks), _decode(ji, chunks), bare, strict=True):
        assert _gap(g, r) <= tol and _gap(b, r) > 10 * tol
    steered = _generate(pi, pm.vocab)
    assert [p.token for p in steered] != [p.token for p in bare_gen]
    score, sim, _ = _verify(pi, pm.vocab, steered)
    assert score == 1.0 and sim == 1.0
    pi.apply_control_vector(None)
    assert "cvec" not in pm.weights["layers"][0]
    assert all(np.array_equal(a, b) for a, b in zip(_decode(pi, chunks), bare))
    pm.close()
    jm.close()


def test_control_vector_layer_range(files):
    """layer_start / layer_end (1-based) pick the layers that take a bias:
    a range past the model's layers leaves every bias zero and the bits
    bare."""
    pm = _port(files["q4k"])
    pi = _inst(pm)
    chunks = _chunks(pm.vocab, 2)
    bare = _decode(pi, chunks)
    pi.apply_control_vector(ControlVector(ControlVectorLoadInfo(files["cvec"], 3.0)), 2, 2)
    assert torch.all(pm.weights["layers"][0]["cvec"].float() == 0)
    assert torch.any(pm.weights["layers"][1]["cvec"].float() != 0)
    pi.apply_control_vector(ControlVector(ControlVectorLoadInfo(files["cvec"], 3.0)), 3, 9)
    assert all(np.array_equal(a, b) for a, b in zip(_decode(pi, chunks), bare))
    pm.close()


# -- families and refusals --------------------------------------------------------

def test_control_vector_on_moe_and_gpt2_is_refused(files):
    """The reference's MoE and gpt2 forwards never read the bias: a vector
    applied there leaves the logits bare (shown below on the reference), so
    the port refuses rather than serve the model unsteered."""
    for file, dtype in (("moe", "q4k_fused"), ("gpt2", "float32")):
        jm = _jax(files[file], dtype)
        ji = _jinst(jm)
        chunks = [[1, 77, 205, 219, 149], [91]]
        bare = _decode(ji, chunks)
        n_embd = jm.config.n_embd
        path = files["cvec"] if n_embd == 256 else None
        if path is None:
            path = files["cvec"] + f".{n_embd}.gguf"
            write_control_vector(path, {1: np.full(n_embd, 2.0, np.float32)})
        ji.apply_control_vector(JControlVector(JControlVectorLoadInfo(path, 3.0)))
        assert all(np.array_equal(a, b) for a, b in zip(_decode(ji, chunks), bare)), file
        pm = _port(files[file], dtype)
        pi = _inst(pm)
        with pytest.raises(NotImplementedError, match="never reads the bias"):
            pi.apply_control_vector(ControlVector(ControlVectorLoadInfo(path, 3.0)))
        pi.apply_control_vector(None)
        pm.close()
        jm.close()


def test_lora_on_gpt2_is_refused(files):
    """The reference's fold looks up the stacked 'wq', which gpt2's
    attn_qkv layout lacks: KeyError. The port refuses with a message."""
    jm = _jax(files["gpt2"], "float32")
    with pytest.raises(KeyError):
        _jinst(jm).add_lora(JLoraAdapter(files["lora_q"]), 1.0)
    pm = _port(files["gpt2"], "float32")
    with pytest.raises(NotImplementedError, match="gpt2"):
        _inst(pm).add_lora(LoraAdapter(files["lora_q"]), 1.0)
    pm.close()
    jm.close()


def test_lora_on_moe_wraps_the_attention_only(files):
    """On a MoE file the adapter lands on wq, wk, wv and wo; its FFN
    tensors find no ffn_gate / ffn_up / ffn_down (the expert banks) and are
    skipped, as in the reference, whose wrapped keys are the same. The
    adapter moves the logits and a replay is exactly 1.0; cleared, the bare
    bits come back."""
    jm = _jax(files["moe"], "q4k_fused")
    _jinst(jm).add_lora(JLoraAdapter(files["lora_all"]), 1.0)
    jwrapped = {k for k, w in jm.weights["layers"][0].items() if isinstance(w, JLoraWrapped)}
    pm = _port(files["moe"], "q4k_fused")
    pi = _inst(pm)
    chunks = [[1, 77, 205, 219, 149], [91]]
    bare = _decode(pi, chunks)
    pi.add_lora(LoraAdapter(files["lora_all"]), 1.0)
    wrapped = {k for k, w in pm.weights["layers"][0].items() if isinstance(w, qm.LoraWrapped)}
    assert wrapped == jwrapped == {"wq", "wk", "wv", "wo"}
    assert all(_gap(a, b) > 0.1 for a, b in zip(_decode(pi, chunks), bare))
    score, sim, _ = _verify(pi, pm.vocab, _generate(pi, pm.vocab))
    assert score == 1.0 and sim == 1.0
    pi.clear_lora_state()
    assert all(np.array_equal(a, b) for a, b in zip(_decode(pi, chunks), bare))
    pm.close()
    jm.close()


@pytest.mark.parametrize("dtype", ["q4k_fused", "float32"])
def test_lora_on_phi3_split_parts(files, dtype):
    """phi3's attn_qkv and [gate; up] ffn_up are split at load into wq, wk,
    wv, w_gate and w_up (dense parts under a packed engine): an adapter in
    llama.cpp's per-projection names lands on them on both sides and the
    logits agree; one named after the fused attn_qkv matches no projection
    and is skipped on both sides (the bare bits)."""
    pm, jm = _port(files["phi3"], dtype), _jax(files["phi3"], dtype)
    pi, ji = _inst(pm), _jinst(jm)
    chunks = _chunks(pm.vocab, 2)
    bare = _decode(pi, chunks)
    pi.add_lora(LoraAdapter(files["lora_qkv"]), 1.0)
    assert all(np.array_equal(a, b) for a, b in zip(_decode(pi, chunks), bare))
    pi.clear_lora_state()
    pi.add_lora(LoraAdapter(files["lora_all"]), 1.0)
    ji.add_lora(JLoraAdapter(files["lora_all"]), 1.0)
    tol = F32_TOL if dtype == "float32" else PACKED_TOL
    for g, r, b in zip(_decode(pi, chunks), _decode(ji, chunks), bare, strict=True):
        assert _gap(g, r) <= tol and _gap(b, r) > 10 * tol
    pm.close()
    jm.close()
