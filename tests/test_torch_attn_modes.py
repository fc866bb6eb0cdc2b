"""The opt-in decode-attention modes and the f32 KV store, on the CPU.

The port's plain versions of kernels N (fresh operand), O (head-batched) and
P (in-kernel write) against the JAX package's Pallas kernels in interpret
mode; the modes' gates against the reference's; each mode through the
port's Session (device loop and host path) against the same requests with
the mode off; and each mode on both sides of a cross-backend replay. The
fixture is the reference's own for these modes: a Q4_K tiny llama at head
dim 128 (n_layer 2, width 1024, 8 / 4 heads), ctx 256. Flags are set
through the module attributes, as the reference's tests set them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.ops import generate_loop as jgl
from blama_tpu.ops.pallas import decode_attention as jda
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models.llama import LlamaStatic
from blama_tpu_torch.ops import decode_attention as pda
from blama_tpu_torch.ops import generate_loop as pgl
from blama_tpu_torch.ops import kv_cache as kvc
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.testing import TP_TINY_SPEC, write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

H, HKV, D, S = 4, 2, 128, 128
JDT = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}
PDT = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
PROMPT = "hello world this is"
CTX = 256


def _t(a, dtype=None):
    """A JAX or numpy array as a torch tensor (bf16 through f32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


def _close(out, ref):
    """Both sides round f32 sums taken in another order to bf16: one bf16
    flip of the largest output, 2^-8 of it, is within 2^-7."""
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -7 * np.abs(ref).max())


def _inputs(kv, B, seed):
    """A cache of B rows (empty slots, slots ahead of the query), the step's
    query, K/V rows and slots (row 1 of two is a pad row, slot S), each
    row's position written at its slot, as the forward writes it first."""
    rng = np.random.default_rng(seed)
    if kv == "int8":
        k = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (B, S, HKV)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (B, S, HKV)).astype(np.float32)
    else:
        k, v = (np.asarray(jnp.asarray(rng.standard_normal((B, S, HKV, D)), JDT[kv]))
                for _ in range(2))
        ks = vs = None
    slot = np.array([90, S][:B], np.int32)
    q_pos = np.array([90, 60][:B], np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, 5] = -1
    pos[:, 100:] = -1
    pos[:, 40] = 500
    pos[0, 90] = 90
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)
    kn, vn = (jnp.asarray(rng.standard_normal((B, HKV, D)) * 3, jnp.bfloat16)
              for _ in range(2))
    return k, v, ks, vs, pos, slot, q_pos, q, kn, vn


def _port_cache(k, v, ks, vs, pos, kv):
    lift = lambda a: None if a is None else _t(a)[None]   # noqa: E731
    return kvc.KVCache(_t(k, PDT[kv])[None], _t(v, PDT[kv])[None], _t(pos),
                       lift(ks), lift(vs))


def _jax_scales_t(a):
    return None if a is None else jnp.swapaxes(jnp.asarray(a), 1, 2)[None]


STORES = ["int8", "bfloat16", "float32"]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kv", STORES)
def test_fresh_plain_matches_jax(kv, B):
    """N's plain version against the reference's fresh-operand kernel (the
    grouped stacked carry with its transposed scales), the slot holding
    garbage: the patch, not the stored row, is what both read."""
    k, v, ks, vs, pos, slot, q_pos, q, kn, vn = _inputs(kv, B, seed=B)
    inv, ms = jda.effective_inv_freq(D, D, 10000.0)
    grouped = lambda a: jnp.asarray(a).reshape(1, B, S // 32, 32, HKV * D)  # noqa: E731
    ref = jda.decode_attention(q, grouped(k), grouped(v), jnp.asarray(q_pos),
                               jnp.asarray(pos), inv, _jax_scales_t(ks), _jax_scales_t(vs),
                               mscale=ms, layer=0, scales_t=ks is not None,
                               k_new=kn.reshape(B, HKV * D), v_new=vn.reshape(B, HKV * D),
                               slot=jnp.asarray(slot))
    c = _port_cache(k, v, ks, vs, pos, kv)
    pinv, pms = pda.effective_inv_freq(D, D, 10000.0)
    out = pda.decode_attention(_t(q, torch.bfloat16), c.k[0], c.v[0], _t(q_pos), c.positions,
                               pinv, *((c.k_scale[0], c.v_scale[0]) if c.quantized
                                       else (None, None)), mscale=pms,
                               k_new=_t(kn, torch.bfloat16), v_new=_t(vn, torch.bfloat16),
                               slot=_t(slot))
    _close(out, ref)
    assert torch.equal(c.k, _port_cache(k, v, ks, vs, pos, kv).k)   # N writes nothing


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kv", STORES)
def test_write_plain_matches_jax(kv, B):
    """P's plain version against the reference's write kernel: outputs within
    the tolerance, the rows it does not write untouched, and the written
    codes and scales (or values) exactly the reference's quantize_kv of the
    fresh rows, run eagerly. The reference kernel's own written row agrees
    up to one hazard: in interpret mode XLA's CPU backend divides amax / 127
    through a reciprocal (ROADMAP.md §3), so a scale may sit one ulp off and
    a code one step; its other rows are the port's exactly. A pad row
    writes the port's spare slot and nothing the rows hold."""
    from blama_tpu.ops import kv_cache as jkvc

    k, v, ks, vs, pos, slot, q_pos, q, kn, vn = _inputs(kv, B, seed=10 + B)
    inv, ms = jda.effective_inv_freq(D, D, 10000.0)
    merged = lambda a: jnp.asarray(a).reshape(1, B, S, HKV * D)   # noqa: E731
    ref, k2, v2, ks2, vs2 = jda.decode_attention_write(
        q, merged(k), merged(v), jnp.asarray(q_pos), jnp.asarray(pos), inv,
        kn.reshape(B, HKV * D), vn.reshape(B, HKV * D), jnp.asarray(slot), 0,
        k_scale=_jax_scales_t(ks), v_scale=_jax_scales_t(vs), mscale=ms)
    c = _port_cache(k, v, ks, vs, pos, kv)
    pinv, pms = pda.effective_inv_freq(D, D, 10000.0)
    sc = (c.k_scale_store[0], c.v_scale_store[0]) if c.quantized else (None, None)
    out = pda.decode_attention_write(_t(q, torch.bfloat16), c.k_store[0], c.v_store[0],
                                     _t(q_pos), c.positions, pinv, _t(kn, torch.bfloat16),
                                     _t(vn, torch.bfloat16), _t(slot), *sc, mscale=pms)
    _close(out, ref)
    live = [(b, int(s_)) for b, s_ in enumerate(slot) if s_ < S]
    kept = np.ones((B, S), bool)
    for b, s_ in live:
        kept[b, s_] = False
    pairs = [(c.k[0], k2, kn), (c.v[0], v2, vn)]
    if c.quantized:
        pairs = [(c.k[0], k2, kn, c.k_scale[0], ks2), (c.v[0], v2, vn, c.v_scale[0], vs2)]
    for got, want, new, *scales in pairs:
        want = _t(np.asarray(want).reshape(B, S, HKV, D), PDT[kv])
        assert torch.equal(got[kept], want[kept])
        with jax.disable_jit():   # IEEE amax / 127 (ROADMAP.md §3 hazard)
            codes, scale = jkvc.quantize_kv(new) if c.quantized else (new, None)
        for b, s_ in live:
            assert torch.equal(got[b, s_], _t(np.asarray(codes)[b], PDT[kv]))
            if scales:
                assert torch.equal(scales[0][b, s_], _t(np.asarray(scale)[b]))
                kern = np.swapaxes(np.asarray(scales[1]), 2, 3)[0, b, s_]
                np.testing.assert_allclose(kern, np.asarray(scale)[b], rtol=2.0 ** -22)
                assert (got[b, s_].int() - want[b, s_].int()).abs().max() <= 1
            else:
                assert torch.equal(got[b, s_], want[b, s_])
        if scales:
            kern_t = _t(np.swapaxes(np.asarray(scales[1]), 2, 3)[0])
            assert torch.equal(scales[0][kept], kern_t[kept])
    if B == 2:   # the pad row's write: the spare slot, not row 1
        assert not torch.equal(c.k_store[0, -1], torch.zeros_like(c.k_store[0, -1]))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kv", STORES)
def test_hb_plain_matches_jax(kv, B, monkeypatch):
    """O's plain version (C's function) against the reference's head-batched
    kernel, which `_call` takes with BLAMA_ATTN_HB set; its jit cache is
    cleared around the flag, which is read while tracing."""
    k, v, ks, vs, pos, slot, q_pos, q, kn, vn = _inputs(kv, B, seed=20 + B)
    pos[0, 90] = 90
    inv, ms = jda.effective_inv_freq(D, D, 10000.0)
    monkeypatch.setattr(jda, "_HB", True)
    monkeypatch.setattr(pda, "_HB", True)
    jda._call.clear_cache()
    try:
        ref = jda.decode_attention(q, jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                                   jnp.asarray(pos), inv,
                                   None if ks is None else jnp.asarray(ks),
                                   None if vs is None else jnp.asarray(vs), mscale=ms)
    finally:
        jda._call.clear_cache()
    assert pda.hb_split(S, D, HKV, PDT[kv], B) is not None
    c = _port_cache(k, v, ks, vs, pos, kv)
    pinv, pms = pda.effective_inv_freq(D, D, 10000.0)
    out = pda.decode_attention(_t(q, torch.bfloat16), c.k[0], c.v[0], _t(q_pos), c.positions,
                               pinv, *((c.k_scale[0], c.v_scale[0]) if c.quantized
                                       else (None, None)), mscale=pms)
    _close(out, ref)


def test_gates_match_jax(monkeypatch):
    """write_supports, fresh_supports and O's route (the reference's inline
    choice in `_call`: D % 128 == 0, the flag, no transposed scales or fresh
    row, a block under max(128, 4096 / Hkv)) over S, B, head dims and every
    store type."""
    monkeypatch.setattr(pda, "_HB", True)
    for s in (64, 128, 192, 256, 2048):
        for b in (1, 8):
            for name in STORES:
                jd, pd_ = JDT[name], PDT[name]
                for d in (64, 128, 256):
                    assert pda.write_supports(s, d, pd_, b) == jda.write_supports(s, d, jd, b)
                    assert pda.fresh_supports(s, d, pd_, b) == jda.fresh_supports(s, d, jd, b)
                    for hkv in (2, 8):
                        want = jda._pick_block_s(s, jnp.dtype(jd).itemsize, b,
                                                 cap=max(128, 4096 // hkv)) \
                            if d % 128 == 0 else None
                        assert pda.hb_split(s, d, hkv, pd_, b) == want, (s, b, name, d)
                        assert pda.hb_split(s, d, hkv, pd_, b, scales_t=True) is None
                        assert pda.hb_split(s, d, hkv, pd_, b, fresh=True) is None
    monkeypatch.setattr(pda, "_HB", False)
    assert pda.hb_split(2048, 128, 8, torch.bfloat16) is None


def test_block_cap_caps_the_split(monkeypatch):
    """BLAMA_ATTN_BLOCK_CAP caps the decode kernels' slots per split in
    whole grains; at its default the split is DECODE_SPLIT at every batch."""
    assert pda.decode_plan(1, 32, 8, 2048, 128)[0] == pda.DECODE_SPLIT
    assert pda.decode_plan(64, 32, 8, 2048, 128)[0] == pda.DECODE_SPLIT
    monkeypatch.setattr(pda, "_BLOCK_CAP", 100)
    assert pda.decode_plan(64, 32, 8, 2048, 128)[0] == 64
    assert pda.decode_plan(1, 32, 8, 2048, 128)[0] == 64


# -- the slice: the modes through the port's entry points ----------------------

@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("modes") / "tiny-d128.gguf")
    write_tiny_llama(p, GGMLType.Q4_K, spec=TP_TINY_SPEC)
    return p


@pytest.fixture(scope="module")
def port_model(gguf_path):
    m = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    yield m
    m.close()


def _set_port_mode(monkeypatch, mode):
    monkeypatch.setattr(pgl, "_WRITE_IN_KERNEL", mode == "write")
    monkeypatch.setattr(pgl, "_FRESH_OPERAND", mode == "fresh")
    monkeypatch.setattr(pda, "_HB", mode == "hb")


def _stores(cache):
    n = cache.batch * cache.n_slots
    out = [cache.k_store[:, :n], cache.v_store[:, :n], cache.pos_store[:n]]
    if cache.quantized:
        out += [cache.k_scale_store[:, :n], cache.v_scale_store[:, :n]]
    return out


def _port_run(model, kv, fast, n=6):
    inst = Instance(model, InstanceInitParams(ctx_size=CTX, kv_dtype=kv, flash_attn=True,
                                              fast_greedy=fast))
    s = inst.start_session(SessionInitParams(seed=5, temperature=0.0))
    s.set_initial_prompt(model.vocab.tokenize(PROMPT, True, True))
    preds = s.complete(CompleteParams(max_tokens=n))
    inst.stop_session()
    return preds, _stores(inst.cache), inst


def _top10(preds):
    return [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds]


def _replay(inst, vocab, sess_cls, preds):
    s = inst.start_session(sess_cls(seed=5, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims))


MODE_CASES = [("write", "int8"), ("write", "bfloat16"), ("write", "float32"),
              ("fresh", "int8"), ("hb", "bfloat16"), ("hb", "float32")]


@pytest.mark.parametrize("mode,kv", MODE_CASES, ids=[f"{m}-{k}" for m, k in MODE_CASES])
def test_mode_session_equals_host_path_and_mode_off(mode, kv, port_model, monkeypatch):
    """A mode through Session.complete's device loop, the host path (which
    no mode reaches but O) and the same requests with the mode off: tokens,
    top-10 and the final cache (codes, scales, positions) bit for bit; and
    fill_ctx (the teacher-forced loop) in the mode replays at exactly 1.0."""
    _set_port_mode(monkeypatch, mode)
    fast, fast_c, inst = _port_run(port_model, kv, True)
    host, host_c, _ = _port_run(port_model, kv, False)
    assert _replay(inst, port_model.vocab, SessionInitParams, fast) == (1.0, 1.0)
    _set_port_mode(monkeypatch, None)
    off, off_c, _ = _port_run(port_model, kv, True)
    assert _top10(fast) == _top10(host) == _top10(off)
    for a, b, c in zip(fast_c, host_c, off_c, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("mode", ["write", "fresh"])
def test_step_reads_the_fresh_row_not_the_store(mode, port_model):
    """Garbage in the step's slot of every layer: the fresh-operand step
    (N runs before the write) and the write step give the logits and the
    cache of the plain step, which writes the slot before reading it."""
    st = LlamaStatic.of(port_model.config)
    mode_st = {"write": dict(attn_write=True),
               "fresh": dict(attn_fresh=True, attn_scales_t=True)}[mode]
    import dataclasses

    caches = []
    for s in (st, dataclasses.replace(st, **mode_st)):
        c = kvc.KVCache.create(2, 1, CTX, st.n_head_kv, st.head_dim, "int8", device="cpu")
        toks = torch.tensor([[1, 100, 101, 102, 103, 104, 105, 106]])
        pos = torch.arange(8, dtype=torch.int32)[None]
        s.step(port_model.weights, toks, pos, pos, c, torch.tensor([7]))
        g = torch.Generator().manual_seed(9)
        c.k[:, 0, 8] = torch.randint(-127, 128, c.k[:, 0, 8].shape, generator=g,
                                     dtype=torch.int8)
        c.v[:, 0, 8] = torch.randint(-127, 128, c.v[:, 0, 8].shape, generator=g,
                                     dtype=torch.int8)
        c.k_scale[:, 0, 8] = 7.0
        logits, c = s.step(port_model.weights, torch.tensor([[77]]),
                           torch.tensor([[8]], dtype=torch.int32),
                           torch.tensor([[8]], dtype=torch.int32), c, torch.tensor([0]))
        caches.append((logits, _stores(c)))
    assert torch.equal(caches[0][0], caches[1][0])
    assert all(torch.equal(a, b) for a, b in zip(caches[0][1], caches[1][1], strict=True))


def test_horizon_write_mode_idle_rows(port_model, monkeypatch):
    """Dense horizon scheduling in write mode (the reference's
    test_horizon_write_kernel_idle_rows): row 0 goes idle while row 1 keeps
    decoding; the idle row's write lands in the store's spare slot (kernel P
    gets a pad slot, the reference's clamp to row S-1 has no counterpart),
    and the streams equal the per-token scheduler's."""
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler, GenRequest

    pad_slots = []
    real = pda.decode_attention_write

    def spy(*a, **kw):
        slot, kv_pos = a[8], a[4]
        pad_slots.append(int((slot >= kv_pos.shape[1]).sum()))
        return real(*a, **kw)

    monkeypatch.setattr(pda, "decode_attention_write", spy)
    _set_port_mode(monkeypatch, "write")

    def run(horizon):
        sched = ContinuousBatchingScheduler(port_model, max_batch=2, ctx_size=CTX,
                                            horizon=horizon)
        outs = {}
        for i, (pr, n) in enumerate([("hello world", 3), ("the cat sat on", 9)]):
            sched.submit(GenRequest(prompt=port_model.vocab.tokenize(pr, True, True),
                                    max_tokens=n, sampler_params=SamplerParams(temp=0.0),
                                    on_done=lambda g, i=i: outs.__setitem__(
                                        i, [x.token for x in g])))
        sched.run_until_idle()
        return [outs[i] for i in range(2)], sched.cache

    per_token, _ = run(0)
    assert not pad_slots                     # the per-token path takes kernel C
    horizon, cache = run(4)
    assert horizon == per_token and len(horizon[1]) == 9
    assert pad_slots and max(pad_slots) >= 1   # an idle row wrote, through P
    assert cache.k_store[:, cache.pad_slot].abs().sum() > 0


# -- each mode on both sides of a cross-backend replay --------------------------

@pytest.fixture(scope="module")
def jax_model(gguf_path):
    m = JModel(gguf_path, JModelParams(dtype="q4k_a8", attn="fused"))
    yield m
    m.close()


def _set_jax_mode(monkeypatch, mode):
    monkeypatch.setattr(jgl, "_WRITE_IN_KERNEL", mode == "write")
    monkeypatch.setattr(jgl, "_FRESH_OPERAND", mode == "fresh")
    monkeypatch.setattr(jda, "_HB", mode == "hb")
    for fn in (jgl.continue_greedy, jgl.teacher_forced, jgl.greedy_generate, jda._call):
        fn.clear_cache()


# the JAX side's store per mode: INT8 for write and fresh (fresh serves
# INT8 only), bf16 for O (the INT8 loops carry transposed scales, which
# keep O off in the reference)
CROSS = {"write": "int8", "fresh": "int8", "hb": "bfloat16"}


@pytest.mark.parametrize("mode", sorted(CROSS))
def test_cross_backend_replay_in_the_same_mode(mode, port_model, jax_model, monkeypatch):
    """The mode on both sides, port prover → JAX verifier and JAX prover →
    port verifier, each at the reference's thresholds (score >= 0.95, mean
    similarity >= 0.98)."""
    kv = CROSS[mode]
    _set_port_mode(monkeypatch, mode)
    _set_jax_mode(monkeypatch, mode)
    try:
        jinst = JInstance(jax_model, JInstanceInitParams(ctx_size=CTX, kv_dtype=kv,
                                                         flash_attn=True))
        js = jinst.start_session(JSessionInitParams(seed=5, temperature=0.0))
        js.set_initial_prompt(jax_model.vocab.tokenize(PROMPT, True, True))
        jpreds = js.complete(JCompleteParams(max_tokens=6))
        jinst.stop_session()
        ppreds, _, pinst = _port_run(port_model, kv, True)
        for verifier, vocab, sess_cls, preds in (
                (pinst, port_model.vocab, SessionInitParams, jpreds),
                (jinst, jax_model.vocab, JSessionInitParams, ppreds)):
            score, sim = _replay(verifier, vocab, sess_cls, preds)
            assert score >= 0.95 and sim >= 0.98, (mode, score, sim)
    finally:
        _set_jax_mode(monkeypatch, None)
