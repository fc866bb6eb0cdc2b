"""The port's HTTP server started with every default (`python -m
blama_tpu_torch.server.http` with BLAMA_DTYPE unset) builds the model the
reference's single-process server builds, Model(path): the `float32` engine
with attn="xla", on the solo Instance's f32 KV rows. So a default-started
port server and a default-built reference Model replay each other's records
at the thresholds of tests/test_cross_engine_verify.py (score >= 0.95, mean
similarity >= 0.98), in both directions. Both sides on the CPU, the tiny
llama fixture.
"""

import numpy as np
import pytest
import torch

from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.server import http as phttp
from blama_tpu_torch.server.server import Server
from blama_tpu_torch.testing import write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

PROMPT = "hello world the cat sat"


class _Started(Exception):
    pass


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The solo Server that `main` builds with BLAMA_DTYPE, BLAMA_SCHEDULER
    and the attention unset (captured before it listens), and a reference
    Model(path) on the same file."""
    p = str(tmp_path_factory.mktemp("http_default") / "tiny.gguf")
    write_tiny_llama(p)
    mp = pytest.MonkeyPatch()
    seen = {}

    def recording_server(model, params):
        seen["api"] = Server(model, params)
        raise _Started

    mp.setenv("BLAMA_MODEL", p)
    mp.setenv("BLAMA_DEVICE", "cpu")
    for var in ("BLAMA_DTYPE", "BLAMA_SCHEDULER", "BLAMA_MULTIHOST", "BLAMA_PORT",
                "BLAMA_FUSE_PROJ", "BLAMA_FUSE_KV"):
        mp.delenv(var, raising=False)
    mp.setattr(phttp, "Server", recording_server)
    try:
        with pytest.raises(_Started):
            phttp.main()
    finally:
        mp.undo()
    api, jm = seen["api"], JModel(p)
    yield api, jm
    api.close()
    api._model.close()
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


def test_default_server_loads_the_reference_engine(servers):
    api, jm = servers
    pm = api._model
    assert pm.params.dtype == jm.params.dtype == "float32"
    assert pm.params.attn == jm.params.attn == "xla"
    assert pm.weights["tok_emb"].dtype == torch.float32
    assert api._instance.cache.k_store.dtype == torch.float32


def test_default_server_and_reference_verify_each_other(servers):
    """Port server prover -> reference verifier, and reference prover ->
    port server verifier, both built with every default."""
    api, jm = servers
    pinst, pm = api._instance, api._model
    jinst = JInstance(jm, JInstanceInitParams())
    ppreds = _prove(pinst, pm.vocab, SessionInitParams, CompleteParams)
    jpreds = _prove(jinst, jm.vocab, JSessionInitParams, JCompleteParams)
    assert len(ppreds) == len(jpreds) == 12
    for verifier, vocab, sess_cls, preds in ((jinst, jm.vocab, JSessionInitParams, ppreds),
                                             (pinst, pm.vocab, SessionInitParams, jpreds)):
        score, sim = _replay(verifier, vocab, sess_cls, preds)
        assert score >= 0.95 and sim >= 0.98, (score, sim)
    assert _replay(pinst, pm.vocab, SessionInitParams, ppreds) == (1.0, 1.0)
