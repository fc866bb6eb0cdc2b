"""The port's ModelParams defaults to the reference's attention mode,
attn="xla" (the two-pass chain), so a model built with defaults on either
side runs the same mode: a default-built port verifier replays a
default-built JAX prover, and back, at the reference's thresholds of
tests/test_cross_engine_verify.py (score >= 0.95, mean similarity >= 0.98).
Both sides on the CPU, the tiny llama fixture, Instance defaults (f32 KV).
"""

import numpy as np
import pytest
import torch

from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.testing import write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"


def test_attn_defaults_to_xla_on_both_sides():
    assert ModelParams().attn == JModelParams().attn == "xla"


@pytest.fixture(scope="module")
def default_models(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("attn_default") / "tiny.gguf")
    write_tiny_llama(p)
    pm, jm = Model(p, ModelParams(device="cpu")), JModel(p)
    yield pm, jm
    pm.close()
    jm.close()


def _prove(inst, vocab, sess_cls, cp_cls):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    preds = s.complete(cp_cls(max_tokens=12))
    inst.stop_session()
    return preds


def _replay(inst, vocab, sess_cls, preds):
    s = inst.start_session(sess_cls(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims))


def test_default_models_verify_each_other(default_models):
    """Port prover -> JAX verifier and JAX prover -> port verifier, both
    built with every default: float32 weights, attn="xla", f32 KV rows."""
    pm, jm = default_models
    assert pm.params.dtype == jm.params.dtype == "float32"
    assert pm.config.attn_fused is False
    pinst, jinst = Instance(pm, InstanceInitParams()), JInstance(jm, JInstanceInitParams())
    assert pinst.step_config.attn_fused is False
    ppreds = _prove(pinst, pm.vocab, SessionInitParams, CompleteParams)
    jpreds = _prove(jinst, jm.vocab, JSessionInitParams, JCompleteParams)
    assert len(ppreds) == len(jpreds) == 12
    for verifier, vocab, sess_cls, preds in ((jinst, jm.vocab, JSessionInitParams, ppreds),
                                             (pinst, pm.vocab, SessionInitParams, jpreds)):
        score, sim = _replay(verifier, vocab, sess_cls, preds)
        assert score >= 0.95 and sim >= 0.98, (score, sim)
    assert _replay(pinst, pm.vocab, SessionInitParams, ppreds) == (1.0, 1.0)
