"""The fixed-topology tp_blocks mode of the port against the JAX package, on
the CPU: the partials and pinned products of kernels L and M (their plain
versions) against the reference's Pallas kernels in interpret mode, the
invariances a sharded prover's replay rests on, the dispatch, the forward,
and replay across the two packages with the JAX prover sharded over tp = 4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from blama_tpu.gguf import GGMLType as JGGMLType
from blama_tpu.gguf import quants as jquants
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu.parallel.mesh import make_mesh
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.sampler import SamplerParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler, GenRequest
from blama_tpu_torch.testing import TP_TINY_SPEC, synthesize_moe_gguf, write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

N = 512
# the matmul tolerance of PERF.md §6, per partial: f32 sums in another order
TOL = 1e-4
PROMPT = "hello world the cat sat"
TPB = 4


def _q4k_bytes(k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, k)) / np.sqrt(k)).astype(np.float32)
    return jquants.quantize(w, JGGMLType.Q4_K)


def _acts(m, k, seed):
    """bf16-valued activations as (jax bf16, torch bf16) with equal values."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)


def _close_parts(out, ref):
    """Each partial within TOL x its own largest magnitude."""
    assert out.shape == ref.shape
    for o, r in zip(out, ref, strict=True):
        assert np.abs(o - r).max() <= TOL * np.abs(r).max()


@pytest.fixture(scope="module")
def weights():
    """(K, a8) → (the JAX weight, the port's weight) of one Q4_K tensor
    [N, K]: f32 scales (QuantTensor) or bf16 (QuantTensorA8S)."""
    out = {}
    for k in (1024, 2048):
        data = _q4k_bytes(k, k)
        out[k, False] = (jqm.repack_q4k_for_tpu(data, N, k), qm.repack_q4k_exact(data, N, k, "cpu"))
        out[k, True] = (jqm.repack_q4k_a8s(data, N, k), qm.repack_q4k_a8s(data, N, k, "cpu"))
    return out


@pytest.mark.parametrize("a8", [False, True], ids=["f32_scales", "bf16_scales"])
@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("k", [1024, 2048])
def test_exact_parts_match_jax(weights, k, nb, a8):
    """Kernel L's plain version against q4k_matmul_parts (and, at one block,
    q4k_matmul_pinned) at 1, 5, 16 and 33 rows."""
    jw, pw = weights[k, a8]
    for m in (1, 5, 16, 33):
        xb, xt = _acts(m, k, seed=100 * nb + m)
        with jax.disable_jit():
            ref = np.asarray(jqm.q4k_matmul_parts(xb, jw, nb))[..., :N]
            pinned = np.asarray(jqm.q4k_matmul_pinned(xb, jw))[:, :N] if nb == 1 else None
        out = qm.q4k_matmul_parts_plain(xt, pw, nb).numpy()
        _close_parts(out, ref)
        if pinned is not None:
            _close_parts(qm.q4k_matmul_pinned_plain(xt, pw).numpy()[None], pinned[None])


@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("k", [1024, 2048])
def test_w4a8_parts_match_jax(weights, k, nb):
    """Kernel M's plain version against a8s_matmul_parts (and, at one block,
    kernel A's against w4a8_swar_pinned) at 1, 5 and 16 rows, on equal
    activation codes. Un-jitted: under jit the reference's CPU backend
    divides amax/127 through a reciprocal (ROADMAP.md §3)."""
    jw, pw = weights[k, True]
    for m in (1, 5, 16):
        xb, xt = _acts(m, k, seed=200 * nb + m)
        with jax.disable_jit():
            xq, xs, xsum = jqm._quant_acts(xb)
            ref = np.asarray(jqm.a8s_matmul_parts(xb, jw, nb))[..., :N]
            pinned = np.asarray(jqm.w4a8_swar_pinned(xb, jw))[:, :N] if nb == 1 else None
        pxq, pxs, psxm = qm.quant_acts(xt)
        np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(pxs.numpy(), np.asarray(xs).T)
        np.testing.assert_array_equal(psxm.numpy(), np.asarray(xs * xsum).T)
        _close_parts(qm.a8s_matmul_parts_plain(xt, pw, nb).numpy(), ref)
        if pinned is not None:
            _close_parts(qm.w4a8_matmul(xt, pw).numpy()[None], pinned[None])


@pytest.mark.parametrize("kernel", ["L", "M"])
def test_parts_equal_shards_bit_for_bit(weights, kernel):
    """A tp device holding K-slice d computes nb/tp partials of its slice
    alone; concatenated over the devices and combined by the same tree they
    give the one-dispatch partials' result, bit for bit."""
    k, nb = 2048, 4
    _, pw = weights[k, kernel == "M"]
    fn = qm.q4k_matmul_parts if kernel == "L" else qm.a8s_matmul_parts
    m = 33 if kernel == "L" else 5
    xt = _acts(m, k, seed=7)[1]
    whole = qm.tree_combine(fn(xt, pw, nb))
    for tp in (2, 4):
        kb = k // tp
        shards = torch.cat([fn(xt[:, d * kb:(d + 1) * kb].contiguous(),
                               qm.k_slice(pw, d, tp, contiguous=True), nb // tp)
                            for d in range(tp)])
        assert torch.equal(qm.tree_combine(shards), whole), tp


@pytest.mark.parametrize("a8", [False, True], ids=["L", "A"])
def test_pinned_equals_column_shard_bit_for_bit(weights, a8):
    """Output columns computed on a column shard of the weight equal those
    columns of the whole product (L at one block; kernel A at <= 16 rows)."""
    _, pw = weights[2048, a8]
    fn = qm.w4a8_matmul if a8 else qm.q4k_matmul_pinned
    xt = _acts(5, 2048, seed=8)[1]
    whole = fn(xt, pw)
    for tp in (2, 4, 8):
        n = N // tp
        for d in range(tp):
            assert torch.equal(fn(xt, qm.column_slice(pw, d * n, (d + 1) * n)),
                               whole[:, d * n:(d + 1) * n]), (tp, d)


def test_rows_do_not_depend_on_the_row_count(weights):
    """Kernel L: a row's partials are the same at 1, 8 and 33 rows; kernel
    M: row 7 of 8 equals the row alone."""
    k, nb = 2048, 4
    _, pw = weights[k, False]
    xt = _acts(33, k, seed=9)[1]
    parts = qm.q4k_matmul_parts(xt, pw, nb)
    for m in (1, 8):
        assert torch.equal(qm.q4k_matmul_parts(xt[-m:], pw, nb), parts[:, -m:]), m
    _, pa = weights[k, True]
    p8 = qm.a8s_matmul_parts(xt[:8], pa, nb)
    assert torch.equal(qm.a8s_matmul_parts(xt[7:8], pa, nb), p8[:, 7:])


@pytest.fixture(scope="module")
def ineligible():
    """Each packed class the tp_blocks dispatch must leave to qmm, with K."""
    k = 1024
    data = _q4k_bytes(k, 3)
    return {"k4": qm.repack_q4k_native(data, N, k, "cpu"),
            "a8k4": qm.repack_q4k_a8k4(data, N, k, "cpu"),
            "q8": qm.repack_q8_0(jquants.quantize(
                np.random.default_rng(4).standard_normal((N, k)).astype(np.float32),
                JGGMLType.Q8_0), N, k, "cpu")}


def _spy(monkeypatch):
    calls = []
    for name in ("qmm", "_quant_parts_call", "_quant_kernel_call_pinned"):
        real = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    return calls


@pytest.mark.parametrize("case", ["k4", "a8k4", "q8", "nb3", "k_short"])
def test_ineligible_weights_take_plain_qmm(weights, ineligible, monkeypatch, case):
    """The native-layout classes, Q8_0, a non-power-of-two nb and a K that
    does not split into nb superblock multiples fall through to qmm, as in
    the reference; so do the pinned products of those classes."""
    w = ineligible.get(case) or weights[1024, False][1]
    nb = {"nb3": 3, "k_short": 8}.get(case, 4)     # 1024 % (8 · 256) != 0
    x = _acts(5, 1024, seed=10)[1][None]
    calls = _spy(monkeypatch)
    out = qm.qmm_blocked(x, w, nb)
    assert calls == ["qmm"] and torch.equal(out, qm.qmm(x, w))
    if case in ("k4", "a8k4", "q8"):
        calls.clear()
        assert torch.equal(qm.qmm_nblocked(x, w, nb), qm.qmm(x, w))
        assert calls[0] == "qmm" and "_quant_kernel_call_pinned" not in calls


@pytest.mark.parametrize("a8", [False, True], ids=["QuantTensor", "QuantTensorA8S"])
def test_eligible_weights_take_the_blocked_kernels(weights, monkeypatch, a8):
    """The exact split classes take the partials and the pinned product, in
    x's dtype, the partials combined by the tree; nb = 0 is plain qmm."""
    _, w = weights[2048, a8]
    xt = _acts(5, 2048, seed=11)[1]
    calls = _spy(monkeypatch)
    out = qm.qmm_blocked(xt[None], w, 4)
    parts = (qm.a8s_matmul_parts_plain if a8 else qm.q4k_matmul_parts_plain)(xt, w, 4)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 5, N)
    assert torch.equal(out[0], qm.tree_combine(parts).to(torch.bfloat16))
    pinned = qm.qmm_nblocked(xt[None], w, 4, out_dtype=torch.float32)
    assert pinned.dtype == torch.float32
    assert torch.equal(pinned[0], qm.w4a8_matmul_plain(xt, w) if a8
                       else qm.q4k_matmul_pinned_plain(xt, w))
    assert calls == ["_quant_parts_call", "_quant_kernel_call_pinned"]
    calls.clear()
    qm.qmm_blocked(xt, w, 0), qm.qmm_nblocked(xt, w, 0)
    assert calls == ["qmm", "qmm"]


def test_dense_weights_take_blocked_matmuls():
    """A dense [K, N] weight: nb K-blocks of f32 products combined by the
    tree, or nb column blocks of N/nb; a K that does not split, or nb = 0,
    is plain x @ w."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 3, 256)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32)).to(torch.bfloat16)
    xf, wf = x.reshape(6, 256).float(), w.float()
    parts = torch.stack([qm.rows_mm(xf[:, 64 * i:64 * (i + 1)], wf[64 * i:64 * (i + 1)])
                         for i in range(4)])
    out = qm.qmm_blocked(x, w, 4)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 96)
    assert torch.equal(out.reshape(6, 96), ((parts[0] + parts[1]) + (parts[2] + parts[3]))
                       .to(torch.bfloat16))
    cols = qm.qmm_nblocked(x, w, 4, out_dtype=torch.float32)
    assert torch.equal(cols.reshape(6, 96), torch.cat(
        [qm.rows_mm(xf, wf[:, 24 * i:24 * (i + 1)]) for i in range(4)], dim=1))
    for out in (qm.qmm_blocked(x, w, 3), qm.qmm_blocked(x, w, 0), qm.qmm_nblocked(x, w, 5)):
        assert torch.equal(out, x @ w)


# ---------------------------------------------------------------------------
# the model: forward, replay, scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tp") / "tp.gguf")
    write_tiny_llama(p, GGMLType.Q4_K, spec=TP_TINY_SPEC)
    return p


@pytest.fixture(scope="module")
def port_models(tp_file):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = Model(tp_file, ModelParams(dtype=dtype, tp_blocks=TPB, attn="fused",
                                                      device="cpu"))
        return cache[dtype]

    yield get
    for m in cache.values():
        m.close()


@pytest.fixture(scope="module")
def jax_models(tp_file):
    """(engine, sharded) → the JAX model at tp_blocks = 4, solo or on a
    tp = 4 mesh of CPU devices."""
    cache = {}

    def get(dtype, sharded=False):
        if (dtype, sharded) not in cache:
            cache[dtype, sharded] = JModel(tp_file, JModelParams(
                dtype=dtype, attn="fused", tp_blocks=TPB,
                mesh=make_mesh(1, 4) if sharded else None))
        return cache[dtype, sharded]

    yield get
    for m in cache.values():
        m.close()


def _inst(model, cls=Instance, params=InstanceInitParams):
    # the JAX sessions step by step, as the reference's sharded tests run them
    return cls(model, params(ctx_size=64, flash_attn=True, kv_dtype="int8",
                             fast_greedy=cls is Instance))


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
    agg = MetricsAggregator()
    score, sims = 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims)), replayed


def test_model_mode_and_refusals(tp_file, port_models):
    """tp_blocks reaches the config and the forward's static; -1 resolves to
    0; meshes and sharding rules still raise; the ragged MoE switch is taken
    and changes nothing on a llama file, as in the reference, whose llama
    forward never reads it: the logits of a prompt equal those without it."""
    from blama_tpu_torch.ops.generate_loop import static_of

    m = port_models("q4k_fused")
    assert m.config.tp_blocks == TPB and static_of(m.config).tp_blocks == TPB
    plain = Model(tp_file, ModelParams(dtype="q4k_fused", device="cpu", vocab_only=True))
    assert plain.config.tp_blocks == 0
    for bad in (dict(mesh=object()), dict(sharding_rules=object())):
        with pytest.raises(NotImplementedError, match="item 13"):
            Model(tp_file, ModelParams(dtype="q4k_fused", tp_blocks=8, device="cpu", **bad))
    ragged = Model(tp_file, ModelParams(dtype="q4k_fused", tp_blocks=8, device="cpu",
                                        moe_ragged=True))
    toks = m.vocab.tokenize(PROMPT, True, True)
    pos = np.arange(len(toks))
    assert np.array_equal(_inst(ragged).decode(toks, pos), _inst(m).decode(toks, pos))
    ragged.close()


# the port-vs-JAX logit gap of a 7-token prefill and a one-token decode step,
# held to the looser of the engines' tolerances in tests/test_torch_engines.py
# (1.5 x the q4k_a8 gap on the mixed file, 0.0205 and 0.0182 of the largest
# logit): bf16 rounding of the residual stream and the INT8 cache
GAP = 1.5 * 0.0205


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_forward_logits_match_jax(dtype, port_models, jax_models):
    pm, jm = port_models(dtype), jax_models(dtype)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.weights), device="cpu")
    for key in ("codes", "scales", "mins"):
        assert torch.equal(getattr(carried["layers"][1]["wo"], key),
                           getattr(pm.weights["layers"][1]["wo"], key))
    pi, ji = _inst(pm), _inst(jm, JInstance, JInstanceInitParams)
    toks = pm.vocab.tokenize(PROMPT, True, True)
    for chunk, pos in ((toks, np.arange(len(toks))), ([77], np.array([len(toks)]))):
        ref, out = ji.decode(chunk, pos), pi.decode(chunk, pos)
        assert out.shape == ref.shape == (pm.config.n_vocab,)
        assert np.abs(out - ref).max() <= GAP * np.abs(ref).max(), len(chunk)
        assert len(set(np.argsort(-ref)[:10]) & set(np.argsort(-out)[:10])) >= 8


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_same_backend_replay_is_exact(dtype, port_models):
    pm = port_models(dtype)
    pi = _inst(pm)
    preds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 8)
    score, sim, replayed = _verify(pi, pm.vocab, SessionInitParams, preds)
    assert len(preds) == 8 and score == 1.0 and sim == 1.0
    for o, r in zip(preds, replayed, strict=True):
        assert [(t.token, t.logit) for t in o.logits] == [(t.token, t.logit) for t in r.logits]


@pytest.mark.parametrize("dtype", ["q4k_fused", "q4k_a8"])
def test_jax_sharded_prover_replayed_by_the_port(dtype, port_models, jax_models):
    """A JAX prover sharded over tp = 4 CPU devices, replayed by a port
    verifier at the prover's tp_blocks, and a port prover replayed by a solo
    JAX verifier: both at the reference's cross-backend thresholds."""
    pm, jsh, jsolo = port_models(dtype), jax_models(dtype, True), jax_models(dtype)
    preds = _generate(_inst(jsh, JInstance, JInstanceInitParams), jsh.vocab,
                      JSessionInitParams, JCompleteParams, 8)
    score, sim, _ = _verify(_inst(pm), pm.vocab, SessionInitParams, preds)
    assert len(preds) == 8 and score >= 0.95 and sim >= 0.98, (score, sim)
    preds = _generate(_inst(pm), pm.vocab, SessionInitParams, CompleteParams, 8)
    score, sim, _ = _verify(_inst(jsolo, JInstance, JInstanceInitParams), jsolo.vocab,
                            JSessionInitParams, preds)
    assert score >= 0.95 and sim >= 0.98, (score, sim)


def test_scheduler_gives_the_solo_tokens(port_models):
    """Continuous batching over a tp_blocks model: the batched greedy streams
    equal solo sessions' (the reference's test_scheduler_on_tp_mesh_matches_solo
    on one device)."""
    pm = port_models("q4k_a8")
    prompts = ["hello world", "the cat sat", "president george"]
    sched = ContinuousBatchingScheduler(pm, max_batch=4, ctx_size=64)
    outs = {}
    for i, p in enumerate(prompts):
        sched.submit(GenRequest(prompt=pm.vocab.tokenize(p, True, True), max_tokens=6,
                                sampler_params=SamplerParams(temp=0.0),
                                on_done=lambda preds, i=i: outs.__setitem__(
                                    i, [pr.token for pr in preds])))
    sched.run_until_idle()
    pi = _inst(pm)
    for i, p in enumerate(prompts):
        solo = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 6, prompt=p)
        assert outs[i] == [pr.token for pr in solo], p


def test_moe_replay_and_fall_through(tmp_path, monkeypatch):
    """The tiny Mixtral fixture (width 256) at tp_blocks = 1: the attention
    projections and the lm head take kernel L, the replay is exact; at
    tp_blocks = 4 its wo (K = 256) cannot split into 4 superblock blocks and
    falls through to plain qmm."""
    path = str(tmp_path / "m.gguf")
    synthesize_moe_gguf(path, "mixtral-debug")
    m = Model(path, ModelParams(dtype="q4k_fused", attn="xla", tp_blocks=1, device="cpu"))
    seen = []
    real = qm.q4k_matmul_parts
    monkeypatch.setattr(qm, "q4k_matmul_parts",
                        lambda x, w, nb: seen.append((w.n_out, nb)) or real(x, w, nb))
    inst = Instance(m, InstanceInitParams(ctx_size=64, kv_dtype="int8"))
    preds = _generate(inst, m.vocab, SessionInitParams, CompleteParams, 6)
    score, sim, _ = _verify(inst, m.vocab, SessionInitParams, preds)
    assert len(preds) == 6 and score == 1.0 and sim == 1.0
    E = m.config.n_embd
    assert {(E, 1), (m.config.n_vocab, 1)} <= set(seen)
    calls = _spy(monkeypatch)
    x = torch.zeros((1, 2, E), dtype=torch.bfloat16)
    qm.qmm_blocked(x, m.weights["layers"][0]["wo"], 4)
    assert calls == ["qmm"]
    m.close()
