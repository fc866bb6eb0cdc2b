"""The port end to end on the tiny llama GGUF, `q4k_a8` + fused attention +
INT8 KV: forward logits against the JAX package, same-backend replay on the
port (exact), and cross-backend replay in both directions (reference
thresholds of tests/test_cross_engine_verify.py)."""

import numpy as np
import pytest
import torch

from blama_tpu import testing as jtesting
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.ops import generate_loop
from blama_tpu_torch.models.llama import LlamaStatic
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.testing import write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("port") / "tiny.gguf")
    write_tiny_llama(p)
    return p


def _port(path):
    m = Model(path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    return m, Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True,
                                             kv_dtype="int8"))


def _jax(path):
    m = JModel(path, JModelParams(dtype="q4k_a8", attn="fused"))
    return m, JInstance(m, JInstanceInitParams(ctx_size=64, flash_attn=True,
                                               kv_dtype="int8"))


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
    agg = MetricsAggregator()
    score, sims = 0.0, []
    for o, r in zip(preds, replayed):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims)), replayed


def test_fixture_writer_is_a_copy(gguf_path, tmp_path):
    p = str(tmp_path / "jax.gguf")
    jtesting.write_tiny_llama(p)
    assert open(p, "rb").read() == open(gguf_path, "rb").read()


def test_forward_logits_match_jax(gguf_path):
    """Chunks of 6 (T=8 bucket: kernel D, kernel A at 8 rows), 1 (kernel C,
    kernel A at one row), 3 (T=4: two-pass chain) and 20 tokens (T=32:
    kernel B) through both instances, cache state carried along."""
    jm, ji = _jax(gguf_path)
    pm, pi = _port(gguf_path)
    # W4A8 re-quantizes every activation to int8, so a bf16 rounding flip
    # on either side moves whole int8 codes. The port-vs-JAX gap, as a share
    # of the largest logit, measured on this model for each chunk: 0.0178
    # (6 tokens), 0.0251 (1), 0.0173 (3), 0.0122 (20). Each chunk is held to
    # about 1.5x its own reading, and to the same top-10 set up to one
    # near-tie.
    chunks = [(pm.vocab.tokenize(PROMPT, True, True), 0.027), ([77], 0.038),
              ([5, 6, 7], 0.026), (list(range(50, 70)), 0.019)]
    nxt = 0
    for toks, limit in chunks:
        pos = np.arange(nxt, nxt + len(toks))
        nxt += len(toks)
        ref = ji.decode(toks, pos)
        out = pi.decode(toks, pos)
        assert np.abs(out - ref).max() <= limit * np.abs(ref).max(), len(toks)
        top = set(np.argsort(-ref)[:10]) & set(np.argsort(-out)[:10])
        assert len(top) >= 9, len(toks)
    jm.close()
    pm.close()


def test_only_fused_attention_is_served(gguf_path, caplog):
    """Both of the reference's attention modes are served now: attn="xla"
    loads and runs the two-pass chain at every chunk, and a context the
    fused kernels reject switches the instance to that chain with a
    warning, recorded on its step config (attn_fused=False), as the
    reference does; neither raises any more."""
    import logging

    xm = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="xla", device="cpu"))
    assert xm.config.attn_fused is False
    assert Instance(xm, InstanceInitParams(ctx_size=64)).step_config.attn_fused is False
    xm.close()
    pm = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    with caplog.at_level(logging.WARNING, logger="blama_tpu_torch"):
        inst = Instance(pm, InstanceInitParams(ctx_size=60, kv_dtype="int8"))
    assert "using XLA attention" in caplog.text
    assert inst.step_config.attn_fused is False
    pm.close()


def test_same_backend_replay_is_exact(gguf_path):
    pm, pi = _port(gguf_path)
    preds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 12)
    assert len(preds) == 12
    score, sim, replayed = _verify(pi, pm.vocab, SessionInitParams, preds)
    assert score == 1.0 and sim == 1.0
    for o, r in zip(preds, replayed):
        assert [(t.token, t.logit) for t in o.logits] == \
            [(t.token, t.logit) for t in r.logits]
    pm.close()


def test_fast_and_slow_paths_agree(gguf_path):
    """The device-loop prover and the step-by-step path decode the same
    tokens with the same captured logits."""
    pm = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    out = []
    for fast in (True, False):
        inst = Instance(pm, InstanceInitParams(ctx_size=64, flash_attn=True,
                                               kv_dtype="int8", fast_greedy=fast))
        preds = _generate(inst, pm.vocab, SessionInitParams, CompleteParams, 6)
        out.append([(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds])
    assert out[0] == out[1]
    pm.close()


def test_greedy_generate_matches_session(gguf_path):
    """An 8-token prompt runs at T=8 in both (the session's bucket equals the
    prompt), so the one-call loop reproduces the session's tokens."""
    pm, pi = _port(gguf_path)
    toks = [1, 77, 205, 219, 149, 164, 91, 162]
    s = pi.start_session(SessionInitParams(seed=11, temperature=0.0))
    s.set_initial_prompt(toks)
    preds = s.complete(CompleteParams(max_tokens=5))
    pi.stop_session()
    cache = Instance(pm, InstanceInitParams(ctx_size=64, flash_attn=True,
                                            kv_dtype="int8")).cache
    gen, ids, vals, _ = generate_loop.greedy_generate(
        LlamaStatic.of(pi.step_config), pm.weights,
        torch.tensor([toks], dtype=torch.int32), cache, len(toks), 5)
    assert gen[0].tolist() == [p.token for p in preds]
    assert ids.shape == (1, 5, 10) and vals.shape == (1, 5, 10)
    assert ids[0, :, 0].tolist()[:-1] == gen[0].tolist()[1:]
    pm.close()


# reference acceptance thresholds (tests/test_cross_engine_verify.py)
@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_cross_backend_replay_meets_thresholds(gguf_path, direction):
    pm, pi = _port(gguf_path)
    jm, ji = _jax(gguf_path)
    if direction == "port->jax":
        preds = _generate(pi, pm.vocab, SessionInitParams, CompleteParams, 10)
        score, sim, _ = _verify(ji, jm.vocab, JSessionInitParams, preds)
    else:
        preds = _generate(ji, jm.vocab, JSessionInitParams, JCompleteParams, 10)
        score, sim, _ = _verify(pi, pm.vocab, SessionInitParams, preds)
    assert len(preds) == 10
    assert score >= 0.95, f"{direction}: score {score}"
    assert sim >= 0.98, f"{direction}: similarity {sim}"
    pm.close()
    jm.close()


def test_context_shift_and_state_restore(gguf_path):
    """The host-side Session logic over the port's ops: generation past a
    32-slot context shifts the cache (kv_seq_rm/add) and keeps going, and a
    saved state restores into a fresh session that continues identically."""
    pm = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    inst = Instance(pm, InstanceInitParams(ctx_size=32, flash_attn=True,
                                           kv_dtype="int8", fast_greedy=False))
    s = inst.start_session(SessionInitParams(seed=3, temperature=0.0))
    s.set_initial_prompt(pm.vocab.tokenize(PROMPT, True, True))
    first = s.complete(CompleteParams(max_tokens=20))
    state = s.get_state()
    rest = s.complete(CompleteParams(max_tokens=16))   # crosses 32 slots
    inst.stop_session()
    assert len(first) == 20 and len(rest) == 16
    hp = inst.allocator.host_positions        # 6 + 20 + 16 tokens decoded
    assert (hp >= 0).sum() <= 32 and hp.max() < 6 + 20 + 16 - 1
    s2 = inst.start_session(SessionInitParams(seed=3, temperature=0.0))
    assert s2.set_state(state)
    again = s2.complete(CompleteParams(max_tokens=16))
    assert [p.token for p in again] == [p.token for p in rest]
    pm.close()


def test_sampling_path_is_seeded(gguf_path):
    """temperature > 0 takes the host sampler step by step; one seed gives
    one stream."""
    pm, pi = _port(gguf_path)
    streams = []
    for _ in range(2):
        s = pi.start_session(SessionInitParams(seed=5, temperature=0.8))
        s.set_initial_prompt(pm.vocab.tokenize(PROMPT, True, True))
        streams.append([p.token for p in s.complete(CompleteParams(max_tokens=8))])
        pi.stop_session()
    assert streams[0] == streams[1] and len(streams[0]) > 0
    pm.close()


@pytest.mark.parametrize("arch", ["gemma", "phi3", "gpt2", "qwen2"])
def test_fast_path_gate_follows_the_reference(arch, tmp_path, monkeypatch):
    """The device loops serve llama, mistral and qwen2 sessions only, as the
    reference's gate says (its session.py:264, :363): gemma, phi3 and gpt2
    sessions take the step-by-step path with fast_greedy on, entering no
    loop, and give the records of fast_greedy off; a qwen2 session enters
    both loops."""
    from blama_tpu import testing as jt
    from blama_tpu_torch.testing import write_tiny_family

    path = str(tmp_path / f"{arch}.gguf")
    if arch == "gpt2":
        jt.write_tiny_gpt2(path)
    else:
        write_tiny_family(path, arch)
    pm = Model(path, ModelParams(device="cpu"))
    entered = []
    for name in ("continue_greedy", "teacher_forced"):
        real = getattr(generate_loop, name)

        def spy(*a, _real=real, _name=name, **k):
            entered.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(generate_loop, name, spy)
    out = []
    for fast in (True, False):
        inst = Instance(pm, InstanceInitParams(ctx_size=64, fast_greedy=fast))
        preds = _generate(inst, pm.vocab, SessionInitParams, CompleteParams, 5)
        s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
        s.set_initial_prompt(pm.vocab.tokenize(PROMPT, True, True))
        replayed = s.fill_ctx(preds)
        inst.stop_session()
        out.append([[(p.token, [(t.token, t.logit) for t in p.logits]) for p in ps]
                    for ps in (preds, replayed)])
        if fast:
            want = ["continue_greedy", "teacher_forced"] if arch == "qwen2" else []
            assert entered == want, entered
    assert out[0] == out[1]
    pm.close()
