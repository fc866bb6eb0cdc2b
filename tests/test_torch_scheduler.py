"""The port's continuous-batching scheduler on the tiny llama GGUF
(`q4k_a8`, fused attention, bf16 KV, CPU): against the port's solo Session,
across its own modes (per-token / horizon, dense rows / paged pool, tight
pools), and against the JAX package's scheduler on the same requests."""

import threading
import time

import numpy as np
import pytest
import torch

from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.sampler import SamplerParams as JSamplerParams
from blama_tpu.server import scheduler as jsched
from blama_tpu_torch.models.llama import (LlamaStatic, cache_from_jax, forward,
                                          paged_cache_from_jax)
from blama_tpu_torch.ops import kv_cache as kvc
from blama_tpu_torch.ops import paged_kv as pkv
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.sampler import SamplerParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.token_data import TokenData, TokenPrediction
from blama_tpu_torch.runtime.verify import LogitComparer
from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                              VerifyRequest)
from blama_tpu_torch.testing import write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

CTX = 128     # the smallest bf16 row the fused decode gate takes
PROMPTS = ["hello world the cat", "the cat sat on the", "president george bush sat"]


@pytest.fixture(autouse=True)
def _fresh_jax_compiles():
    """Each JAX scheduler builds a fresh jitted step; loading such programs
    from the persistent compile cache late in a long test process has
    crashed XLA:CPU, so these tests compile them anew (as the JAX package's
    own scheduler tests do)."""
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sched") / "tiny.gguf")
    write_tiny_llama(p)
    return p


@pytest.fixture(scope="module")
def model(gguf_path):
    m = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    yield m
    m.close()


@pytest.fixture(scope="module")
def jmodel(gguf_path):
    m = JModel(gguf_path, JModelParams(dtype="q4k_a8", attn="fused"))
    yield m
    m.close()


def greedy():
    return SamplerParams(temp=0.0)


def _solo(model, text, n):
    inst = Instance(model, InstanceInitParams(ctx_size=CTX, flash_attn=True,
                                              kv_dtype="bfloat16"))
    s = inst.start_session(SessionInitParams(seed=0, temperature=0.0))
    s.set_initial_prompt(model.vocab.tokenize(text, True, True))
    preds = s.complete(CompleteParams(max_tokens=n))
    inst.stop_session()
    return [p.token for p in preds]


def _run(model, prompts, n, sched_cls=ContinuousBatchingScheduler, req_cls=GenRequest,
         params=None, **kw):
    """Greedy predictions per prompt, through one scheduler run."""
    kw.setdefault("max_batch", 4)
    kw.setdefault("ctx_size", CTX)
    sched = sched_cls(model, **kw)
    outs = {}
    for i, p in enumerate(prompts):
        toks = model.vocab.tokenize(p, True, True) if isinstance(p, str) else p
        sched.submit(req_cls(prompt=toks, max_tokens=n,
                             sampler_params=params or greedy(),
                             on_done=lambda g, i=i: outs.__setitem__(i, g)))
    sched.run_until_idle()
    return [outs[i] for i in range(len(prompts))]


def _tokens(preds_list):
    return [[p.token for p in preds] for preds in preds_list]


MODES = [dict(), dict(horizon=4), dict(paged=True), dict(paged=True, horizon=4)]
MODE_IDS = ["dense", "dense_horizon", "paged", "paged_horizon"]


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_scheduler_matches_solo_session(model, kw):
    """Batched decode of concurrent prompts gives the solo Session's greedy
    tokens in every mode (rows are independent). Two rows of an 8-token
    bucket are 16 flattened rows, so both sides prefill through kernel A's
    function; with more rows the scheduler's prefill takes kernel B's
    (see the cross-engine test below)."""
    got = _tokens(_run(model, PROMPTS, 8, max_batch=2, **kw))
    for text, toks in zip(PROMPTS, got, strict=True):
        assert toks == _solo(model, text, 8), text


def test_solo_prover_scheduler_verifier_thresholds(model):
    """Solo-Session prover -> 4-row scheduler verifier: the prefill kernels
    differ (A solo, B at 32 flattened rows), so the replay holds at the
    cross-backend thresholds rather than bit for bit."""
    inst = Instance(model, InstanceInitParams(ctx_size=CTX, flash_attn=True,
                                              kv_dtype="bfloat16", fast_greedy=False))
    for text in PROMPTS:
        s = inst.start_session(SessionInitParams(seed=0, temperature=0.0))
        s.set_initial_prompt(model.vocab.tokenize(text, True, True))
        preds = s.complete(CompleteParams(max_tokens=6))
        inst.stop_session()
        score, sim = _cross_verify(model, ContinuousBatchingScheduler, VerifyRequest,
                                   text, preds, paged=True, horizon=4)
        assert score >= 0.95 and sim >= 0.98, (text, score, sim)


def test_more_requests_than_rows(model):
    outs = _tokens(_run(model, ["hello"] * 5, 3, max_batch=2))
    assert len(outs) == 5 and all(o == outs[0] and len(o) == 3 for o in outs)


def test_per_request_seeds(model):
    sched = ContinuousBatchingScheduler(model, max_batch=4, ctx_size=CTX, horizon=4)
    res = {}
    for name, seed in [("a", 1), ("b", 1), ("c", 2)]:
        sched.submit(GenRequest(
            prompt=model.vocab.tokenize("hello", True, True), max_tokens=8,
            sampler_params=SamplerParams(temp=1.5, top_p=1.0, rng_seed=seed),
            on_done=lambda p, n=name: res.__setitem__(n, [t.token for t in p])))
    sched.run_until_idle()
    assert res["a"] == res["b"] and res["a"] != res["c"]


def _verify(model, sched, prompt, preds, noise=0):
    out = {}
    for i in range(noise):
        sched.submit(GenRequest(prompt=model.vocab.tokenize(f"the cat {i} sat", True, True),
                                max_tokens=8, sampler_params=greedy(),
                                on_done=lambda _: None))
    sched.submit(VerifyRequest(prompt=model.vocab.tokenize(prompt, True, True),
                               predictions=preds,
                               on_done=lambda s: out.setdefault("score", s),
                               on_replayed=lambda r: out.setdefault("rep", r)))
    sched.run_until_idle()
    return out["score"], out["rep"]


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_batched_verify_exact_and_batch_invariant(model, kw):
    """Scheduler prover -> scheduler verifier scores exactly 1.0 with
    bit-identical logits, alone or beside other rows."""
    prompt = "hello world the cat sat"
    sched = ContinuousBatchingScheduler(model, max_batch=4, ctx_size=CTX, **kw)
    preds = _run(model, [prompt], 6, **kw)[0]
    s_alone, r_alone = _verify(model, sched, prompt, preds)
    s_noisy, r_noisy = _verify(model, sched, prompt, preds, noise=3)
    assert s_alone == s_noisy == 1.0
    for o, a, b in zip(preds, r_alone, r_noisy, strict=True):
        assert [(l.token, l.logit) for l in o.logits] == [(l.token, l.logit) for l in a.logits]
        assert [l.logit for l in a.logits] == [l.logit for l in b.logits]


def test_verify_flags_tampered_response(model):
    prompt = "the cat sat"
    preds = _run(model, [prompt], 6)[0]
    bad = [TokenPrediction(p.token, [TokenData(td.token, td.logit + 7.5) for td in p.logits])
           for p in preds]
    sched = ContinuousBatchingScheduler(model, max_batch=2, ctx_size=CTX)
    assert _verify(model, sched, prompt, bad)[0] < 0.95


def test_horizon_mode_transition(model):
    """A sampled request arriving mid-flight drops the scheduler to the
    per-token path; the stale-logits sync keeps the greedy row correct."""
    ref = _solo(model, "the cat sat on the", 10)
    sched = ContinuousBatchingScheduler(model, max_batch=2, ctx_size=CTX, horizon=4)
    outs = {}
    sched.submit(GenRequest(prompt=model.vocab.tokenize("the cat sat on the", True, True),
                            max_tokens=10, sampler_params=greedy(),
                            on_done=lambda p: outs.__setitem__("a", [x.token for x in p])))
    sched._iteration()
    sched.submit(GenRequest(prompt=model.vocab.tokenize("hello world", True, True),
                            max_tokens=4, sampler_params=SamplerParams(temp=0.7, rng_seed=3),
                            on_done=lambda p: outs.__setitem__("b", [x.token for x in p])))
    sched.run_until_idle()
    assert outs["a"] == ref and len(outs["b"]) == 4
    timers = sched.metrics.snapshot()["timers"]
    # horizon loops and per-token steps are timed apart
    assert timers["decode_horizon"]["count"] >= 1 and timers["decode_step"]["count"] >= 4
    assert sched.metrics.tokens_per_sec() > 0


LONG = [[1] + list(range(5 + 7 * i, 5 + 7 * i + 110)) for i in range(3)]


def test_tight_pool_recycles_and_preempts(model):
    """A pool smaller than the rows' demand still serves every request:
    pages recycle across requests, and a row starved at its page boundary is
    preempted, requeued and resumed, with the uncontended run's tokens."""
    for horizon in (0, 4):
        ref = _run(model, LONG, 24, ctx_size=256, paged=True, horizon=horizon)
        sched = ContinuousBatchingScheduler(model, max_batch=4, ctx_size=256, paged=True,
                                            horizon=horizon, n_pages=3)
        outs, reqs = {}, []
        for i, p in enumerate(LONG):
            reqs.append(GenRequest(prompt=p, max_tokens=24, sampler_params=greedy(),
                                   on_done=lambda g, i=i: outs.__setitem__(i, g)))
            sched.submit(reqs[-1])
        sched.run_until_idle()
        # something was prefilled twice: a preemption happened
        assert sched.metrics.tokens_prefilled > sum(len(p) for p in LONG)
        assert all(r.finish_reason == "length" for r in reqs)
        assert _tokens([outs[i] for i in range(3)]) == _tokens(ref)
        assert sched._alloc.free_pages == 3 and (sched.cache.positions == -1).all()


def test_oversized_prompt_rejected_and_pool_dry_evicts(model):
    sched = ContinuousBatchingScheduler(model, max_batch=1, ctx_size=512, paged=True,
                                        n_pages=2)
    holder = {}
    rejected = GenRequest(prompt=list(range(5, 300)), max_tokens=4, sampler_params=greedy(),
                          on_done=lambda g: holder.__setitem__("r", g))
    sched.submit(rejected)
    sched.run_until_idle()
    assert rejected.finish_reason == "rejected" and holder["r"] == []
    rej_v = {}
    sched.submit(VerifyRequest(prompt=list(range(5, 300)), predictions=[],
                               on_done=lambda s: rej_v.__setitem__("s", s)))
    sched.run_until_idle()
    assert rej_v["s"] == 0.0
    starved = GenRequest(prompt=model.vocab.tokenize("hello world", True, True),
                         max_tokens=10_000, sampler_params=greedy(),
                         on_done=lambda g: holder.__setitem__("e", g))
    sched.submit(starved)
    sched.run_until_idle()
    assert starved.finish_reason == "evicted"
    assert 0 < len(holder["e"]) <= 256


def test_finish_reasons(model):
    sched = ContinuousBatchingScheduler(model, max_batch=2, ctx_size=CTX)
    r1 = GenRequest(prompt=model.vocab.tokenize("hello world", True, True), max_tokens=3,
                    sampler_params=greedy())
    r2 = GenRequest(prompt=model.vocab.tokenize("the cat", True, True), max_tokens=64,
                    sampler_params=greedy())
    ContinuousBatchingScheduler.cancel(r2)
    # every token but EOS is biased away: the first sample is EOG -> "stop"
    r3 = GenRequest(prompt=model.vocab.tokenize("hello", True, True), max_tokens=8,
                    sampler_params=SamplerParams(temp=0.0,
                                                 logit_bias={model.vocab.eos(): 1e9}))
    done = {}
    for name, r in (("len", r1), ("cancel", r2), ("stop", r3)):
        r.on_done = lambda g, name=name: done.__setitem__(name, g)
        sched.submit(r)
    sched.run_until_idle()
    assert (r1.finish_reason, len(done["len"])) == ("length", 3)
    assert r2.finish_reason == "cancelled"
    assert (r3.finish_reason, done["stop"]) == ("stop", [])
    snap = sched.metrics.snapshot()
    assert snap["tokens_decoded"] >= 3 and snap["tokens_prefilled"] > 0
    assert "decode_step" in snap["timers"] and "prefill" in snap["timers"]


def test_thread_stress_submit_and_cancel(model):
    """Producer threads submit while the worker decodes and a saboteur
    cancels at random: every on_done fires exactly once and all rows,
    pages and the queue drain."""
    import random
    import sys

    sched = ContinuousBatchingScheduler(model, max_batch=4, ctx_size=CTX, paged=True,
                                        horizon=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    sched.start()
    try:
        n_threads, n_req = 4, 5
        lock = threading.Lock()
        counts, requests = {}, []

        def mark(key):
            with lock:
                counts[key] += 1

        def producer(t):
            rng = random.Random(t)
            for i in range(n_req):
                key = (t, i)
                req = GenRequest(prompt=model.vocab.tokenize(f"the cat {t} {i}", True, True),
                                 max_tokens=6, sampler_params=greedy(),
                                 on_done=lambda g, key=key: mark(key))
                with lock:
                    counts[key] = 0
                    requests.append(req)
                sched.submit(req)
                time.sleep(rng.random() * 0.01)

        threads = [threading.Thread(target=producer, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        saboteur = random.Random(99)
        deadline = time.time() + 90
        while time.time() < deadline:
            with lock:
                for req in requests:
                    if saboteur.random() < 0.3:
                        ContinuousBatchingScheduler.cancel(req)
                if len(counts) == n_threads * n_req and all(v == 1 for v in counts.values()):
                    break
            time.sleep(0.05)
        with lock:
            assert len(counts) == n_threads * n_req
            assert all(v == 1 for v in counts.values()), counts
    finally:
        sched.stop()
        sys.setswitchinterval(old)
    assert not sched._thread.is_alive()
    assert all(s.request is None and s.verify is None for s in sched._slots)
    assert sched._queue.empty() and sched._head is None
    assert sched._alloc.free_pages == sched._alloc.n_pages


# -- the all-pad row repair ---------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("T", [1, 8])
def test_idle_row_between_live_rows(model, paged, T):
    """A row whose every token is a pad (an idle scheduler row) writes
    nothing that any view exposes and leaves its neighbours' logits
    unchanged."""
    cfg = model.config
    st = LlamaStatic.of(cfg)
    rng = np.random.default_rng(T)
    toks = rng.integers(3, 200, (3, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (3, 1))

    def run(rows, idle=True):
        n = len(rows)
        if paged:
            cache = pkv.PagedKVCache.create(cfg.n_layer, n, 4, 128, 1, cfg.n_head_kv,
                                            cfg.head_dim_, "bfloat16", device="cpu")
            table = np.full((n, 1), -1, np.int64)
            slots = np.full((n, T), cache.n_slots, np.int32)
            for j, r in enumerate(rows):
                if r != 1 or not idle:
                    table[j, 0] = r                      # row r lives on page r
                    slots[j] = r * 128 + np.arange(T)
            cache.with_table(table)
        else:
            cache = kvc.KVCache.create(cfg.n_layer, n, CTX, cfg.n_head_kv, cfg.head_dim_,
                                       "bfloat16", device="cpu")
            slots = np.stack([np.arange(T) if r != 1 or not idle else np.full(T, CTX)
                              for r in rows]).astype(np.int32)
        logits, cache = forward(model.weights, st, torch.from_numpy(toks[rows]),
                                torch.from_numpy(pos[rows]), torch.from_numpy(slots), cache,
                                torch.full((n,), T - 1))
        return logits, cache

    with_idle, cache = run([0, 1, 2])
    assert torch.isfinite(with_idle).all()
    # the same three-row step with a LIVE middle row: rows 0 and 2 must not
    # notice the difference
    with_live, _ = run([0, 1, 2], idle=False)
    assert torch.equal(with_idle[[0, 2]], with_live[[0, 2]])
    written = int((cache.positions >= 0).sum())
    assert written == 2 * T                      # the idle row wrote no visible slot
    if not paged:
        assert (cache.positions[1] == -1).all() and (cache.k[:, 1] == 0).all()


# -- against the JAX package's scheduler ---------------------------------------


def _jrun(jmodel, prompts, n, **kw):
    return _run(jmodel, prompts, n, sched_cls=jsched.ContinuousBatchingScheduler,
                req_cls=jsched.GenRequest, params=JSamplerParams(temp=0.0), **kw)


def _cross_verify(model, sched_cls, verify_cls, prompt, preds, **kw):
    sched = sched_cls(model, max_batch=4, ctx_size=CTX, **kw)
    out = {}
    sched.submit(verify_cls(prompt=model.vocab.tokenize(prompt, True, True),
                            predictions=preds,
                            on_done=lambda s: out.setdefault("score", s),
                            on_replayed=lambda r: out.setdefault("rep", r)))
    sched.run_until_idle()
    sims = [LogitComparer.logit_similarity(a.logits, b.logits)
            for a, b in zip(preds, out["rep"], strict=True)]
    return out["score"], float(np.mean(sims))


@pytest.mark.parametrize("kw", [dict(horizon=4), dict(paged=True, horizon=4), dict(paged=True)],
                         ids=["dense_horizon", "paged_horizon", "paged"])
def test_scheduler_matches_jax_scheduler(model, jmodel, kw):
    """The same requests through both packages' schedulers: the same greedy
    tokens, and each side's claim replays on the other above the
    cross-backend thresholds (score >= 0.95, mean similarity >= 0.98)."""
    ours = _run(model, PROMPTS, 6, **kw)
    theirs = _jrun(jmodel, PROMPTS, 6, **kw)
    assert _tokens(ours) == _tokens(theirs)
    for prompt, mine, ref in zip(PROMPTS[:2], ours, theirs):
        ref_as_port = [TokenPrediction(p.token, [TokenData(t.token, t.logit) for t in p.logits])
                       for p in ref]
        score, sim = _cross_verify(model, ContinuousBatchingScheduler, VerifyRequest,
                                   prompt, ref_as_port, **kw)
        assert score >= 0.95 and sim >= 0.98, ("jax prover -> port verifier", score, sim)
        score, sim = _cross_verify(jmodel, jsched.ContinuousBatchingScheduler,
                                   jsched.VerifyRequest, prompt, mine, **kw)
        assert score >= 0.95 and sim >= 0.98, ("port prover -> jax verifier", score, sim)


def _first_drift(got, ref):
    """Index of the first prediction whose top-10 logits are not the
    reference's bit for bit (the length when none differs)."""
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        if [(t.token, t.logit) for t in a.logits] != [(t.token, t.logit) for t in b.logits]:
            return i
    return len(ref)


def test_resume_guarantee_matches_jax_scheduler(model, jmodel):
    """What a preempted-and-resumed row guarantees is the reference's: the
    request completes; every prediction made before the preemption is the
    uncontended run's bit for bit; from there on the row continues from a
    re-prefill of prompt + generated (other kernels than it decoded with),
    so its logits drift in both packages, from the same token on. Whether
    the tokens after it stay equal is a matter of argmax margins: on this
    fixture they do in the port, and one row's do not in the reference, so
    only the tokens before the cut are held there."""
    kw = dict(ctx_size=256, paged=True)
    ref = _run(model, LONG, 24, **kw)
    sched = ContinuousBatchingScheduler(model, max_batch=4, n_pages=3, **kw)
    outs, reqs = {}, []
    for i, p in enumerate(LONG):
        reqs.append(GenRequest(prompt=p, max_tokens=24, sampler_params=greedy(),
                               on_done=lambda g, i=i: outs.__setitem__(i, g)))
        sched.submit(reqs[-1])
    sched.run_until_idle()
    cut = [r.preempted_at[0] if r.preempted_at else 24 for r in reqs]
    assert any(r.preempted_at for r in reqs) and all(r.finish_reason == "length" for r in reqs)
    assert [_first_drift(outs[i], ref[i]) for i in range(3)] == cut
    assert _tokens([outs[i] for i in range(3)]) == _tokens(ref)
    snap = sched.metrics.snapshot()["timers"]
    assert snap["queue_wait"]["count"] == 3 + sum(len(r.preempted_at) for r in reqs)
    assert snap["iteration"]["total_s"] >= snap["prefill"]["total_s"] + \
        snap["sample"]["total_s"] + snap["decode_step"]["total_s"] - 1e-2

    jref = _jrun(jmodel, LONG, 24, **kw)
    jtight = _jrun(jmodel, LONG, 24, n_pages=3, **kw)
    assert [_first_drift(jtight[i], jref[i]) for i in range(3)] == cut
    for got, want, k in zip(_tokens(jtight), _tokens(jref), cut, strict=True):
        assert len(got) == 24 and got[:k] == want[:k]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_step_from_the_same_cache_state(model, jmodel, paged):
    """The JAX scheduler prefills three prompts; its cache (pool, positions,
    page table) is carried over, and one batched decode step with an idle
    fourth row runs on both sides: the position maps end up equal and the
    logits agree within the W4A8 tolerance of tests/test_torch_session.py
    (0.038 of the largest logit for a one-token step, same top-10 up to one
    near-tie)."""
    js = jsched.ContinuousBatchingScheduler(jmodel, max_batch=4, ctx_size=CTX, paged=paged)
    for p in PROMPTS:
        js.submit(jsched.GenRequest(prompt=jmodel.vocab.tokenize(p, True, True),
                                    max_tokens=4, sampler_params=JSamplerParams(temp=0.0)))
    js._admit()
    c = js.cache
    arrays = dict(k=np.asarray(c.k), v=np.asarray(c.v), positions=np.asarray(c.positions))
    if paged:
        arrays["page_table"] = np.asarray(c.page_table)
        pc = paged_cache_from_jax(arrays, device="cpu")
    else:
        pc = cache_from_jax(arrays, device="cpu")
    toks = np.array([[40], [50], [60], [0]], np.int32)
    pos = np.array([[js._slots[b].num_past] for b in range(3)] + [[0]], np.int32)
    sl = np.full((4, 1), js._pad_slot, np.int32)
    for b in range(3):
        sl[b, 0] = js._alloc.allocate_slots(b, 1)[0] if paged else pos[b, 0]
    if paged:
        js.cache = js.cache.with_table(js._alloc.tables)
        pc.with_table(js._alloc.tables)
    li = np.zeros(4, np.int32)
    ref, jc = js._step(jmodel.weights, toks, pos, sl, js.cache, li)
    out, pc = forward(model.weights, LlamaStatic.of(model.config), torch.from_numpy(toks),
                      torch.from_numpy(pos), torch.from_numpy(sl), pc, torch.from_numpy(li))
    np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(jc.positions))
    ref, out = np.asarray(ref)[:3], out.numpy()[:3]
    assert np.abs(out - ref).max() <= 0.038 * np.abs(ref).max()
    for r, o in zip(ref, out, strict=True):
        assert len(set(np.argsort(-r)[:10]) & set(np.argsort(-o)[:10])) >= 9


def test_sharded_model_refused(model):
    class Sharded:
        config, weights, device, vocab = model.config, model.weights, model.device, model.vocab
        params = type("P", (), {"mesh": object()})()

    with pytest.raises(NotImplementedError, match="item 13"):
        ContinuousBatchingScheduler(Sharded(), max_batch=2, ctx_size=CTX)
