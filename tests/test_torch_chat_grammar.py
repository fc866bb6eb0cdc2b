"""The port's host-only copies (runtime/chat.py, grammar.py, antiprompt.py)
pass the JAX package's own cases: every test function of
tests/test_chat_format.py, tests/test_grammar.py and tests/test_antiprompt.py
is run again with that module's names bound to the port's classes, so the
cases live in one place. The grammar also constrains a port Session end to
end, as it does in the JAX package."""

import inspect

import pytest
import torch

import test_antiprompt
import test_chat_format
import test_grammar
from blama_tpu.runtime import antiprompt as jantiprompt
from blama_tpu.runtime import chat as jchat
from blama_tpu.runtime import grammar as jgrammar
from blama_tpu_torch.runtime import antiprompt, chat, grammar

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

# reference test module -> (the JAX module it tests, the port's copy)
SUITES = {
    test_chat_format: (jchat, chat),
    test_grammar: (jgrammar, grammar),
    test_antiprompt: (jantiprompt, antiprompt),
}
# builds a JAX-package model inside the function; its port counterpart is
# test_grammar_constrains_port_session below
OWN_VERSION = {"test_grammar_constrained_session"}


def _cases():
    out = []
    for mod in SUITES:
        for name, fn in sorted(vars(mod).items()):
            if not name.startswith("test_") or not inspect.isfunction(fn) \
                    or name in OWN_VERSION:
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                out.append(pytest.param(mod, name, (), id=f"{mod.__name__}.{name}"))
                continue
            (mark,) = marks
            ids = mark.kwargs.get("ids") or range(len(mark.args[1]))
            for case_id, values in zip(ids, mark.args[1], strict=True):
                out.append(pytest.param(mod, name, tuple(values),
                                        id=f"{mod.__name__}.{name}[{case_id}]"))
    return out


@pytest.mark.parametrize("mod,name,args", _cases())
def test_port_copy_passes_the_jax_package_case(monkeypatch, mod, name, args):
    jmod, pmod = SUITES[mod]
    for attr, value in vars(mod).items():
        # every name the test module took from the JAX module -> the port's
        if getattr(jmod, attr, None) is value and not attr.startswith("__"):
            monkeypatch.setattr(mod, attr, getattr(pmod, attr))
    getattr(mod, name)(*args)


def test_every_public_name_is_copied():
    for jmod, pmod in SUITES.values():
        public = {n for n, v in vars(jmod).items()
                  if not n.startswith("_") and getattr(v, "__module__", None) == jmod.__name__}
        assert public and public <= set(vars(pmod)), public - set(vars(pmod))


def test_grammar_constrains_port_session(tmp_path):
    """End to end: a grammar forcing lowercase words constrains generation."""
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.testing import write_tiny_llama

    p = str(tmp_path / "t.gguf")
    write_tiny_llama(p)
    m = Model(p, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    inst = Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8"))
    s = inst.start_session(
        SessionInitParams(seed=3, temperature=0.0, grammar="root ::= [ a-z]+"))
    s.set_initial_prompt(m.vocab.tokenize("hello", True, True))
    preds = s.complete(CompleteParams(max_tokens=8))
    text = m.vocab.detokenize([pr.token for pr in preds])
    assert preds and all(c.islower() or c == " " for c in text), text
    inst.stop_session()
    m.close()


def test_grammar_constrains_scheduler_row(tmp_path):
    """A grammar row is not device-greedy: it takes the per-token path, and
    its output obeys the grammar beside an unconstrained row."""
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler, GenRequest
    from blama_tpu_torch.testing import write_tiny_llama

    p = str(tmp_path / "t.gguf")
    write_tiny_llama(p)
    m = Model(p, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    sched = ContinuousBatchingScheduler(m, max_batch=2, ctx_size=128, horizon=4)
    outs = {}
    for name, sp in (("g", SamplerParams(temp=0.0, grammar="root ::= [ a-z]+")),
                     ("free", SamplerParams(temp=0.0))):
        sched.submit(GenRequest(prompt=m.vocab.tokenize("hello", True, True), max_tokens=8,
                                sampler_params=sp,
                                on_done=lambda g, name=name: outs.__setitem__(name, g)))
    sched.run_until_idle()
    text = m.vocab.detokenize([pr.token for pr in outs["g"]])
    assert outs["g"] and all(c.islower() or c == " " for c in text), text
    assert len(outs["free"]) == 8
    m.close()
