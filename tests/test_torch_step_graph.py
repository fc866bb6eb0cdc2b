"""The forward step and the decode loops as captured graphs, on the CPU.

There is no CUDA graph here, so these tests hold what a capture needs and
what the graphs' bookkeeping does:

  * capture safety: `step_graph.capture_guard` makes the host reads a
    capture forbids raise (Tensor.item, tolist, cpu, numpy, a tensor's
    bool / int / float; torch.tensor, as_tensor, from_numpy), and a decode
    step (T = 1) and a prompt chunk (T = 8) run under it for every engine,
    KV store, decode-attention mode, the paged pool, MoE, tp_blocks and a
    llama-3.1 `rope_freqs` file (the plain versions that stand in for
    kernels on the CPU, kernels.plain_version, are outside it);
  * the graphed loops, steps, Instance, Session and scheduler through
    `step_graph.StubBackend` (a stand-in for the CUDA graph whose replay
    reruns the captured function, guarded) give the eager run's tokens,
    logits and store bits, with torch.equal, across loop chunks, context
    shift and Self-Extend edits, state restores and paged tables;
  * the graph cache's keys and the launch accounting of a replay;
  * the repaired rope and a graphed loop against the JAX package.

The card's own graphs are held equal to eager launches by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from blama_tpu.models import llama as jllama
from blama_tpu.ops import generate_loop as jgl
from blama_tpu.ops import rope as jrope
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu_torch import testing
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.ops import decode_attention as pda
from blama_tpu_torch.ops import generate_loop as gl
from blama_tpu_torch.ops import kernels
from blama_tpu_torch.ops import kv_cache as kvc
from blama_tpu_torch.ops import paged_kv as pkv
from blama_tpu_torch.ops import rope as prope
from blama_tpu_torch.ops import step_graph as sg
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.sampler import SamplerParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                              VerifyRequest)

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

CTX = 64
PROMPT = [1, 77, 205, 219, 149, 164, 91, 162]
# every llama engine and the tensor type of its tiny file
ENGINES = {"q4k_a8": GGMLType.Q4_K, "q4k_fused": GGMLType.Q4_K,
           "q4k_fused_k4": GGMLType.Q4_K, "q4k_a8_k4": GGMLType.Q4_K,
           "q4k_a8_xla": GGMLType.Q4_K, "q8_0_fused": GGMLType.Q8_0,
           "q6_k_fused": GGMLType.Q6_K}
KVS = ("int8", "bfloat16", "float32")
# the decode-attention modes need head dim 128 (the modes tests' fixture)
MODE_SPEC = testing.TP_TINY_SPEC
MODES = ("write", "fresh", "hb")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    out = {}
    for quant in (GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K):
        out[quant] = str(d / f"tiny-{quant.name}.gguf")
        testing.write_tiny_llama(out[quant], quant)
    out["modes"] = str(d / "tiny-d128.gguf")
    testing.write_tiny_llama(out["modes"], GGMLType.Q4_K, spec=MODE_SPEC)
    out["moe"] = str(d / "mixtral-debug.gguf")
    testing.synthesize_moe_gguf(out["moe"], "mixtral-debug")
    return out


_models: dict = {}


@pytest.fixture(scope="module")
def model(files):
    """model(dtype, file=None, tp_blocks=-1): one CPU Model per argument set."""
    def get(dtype, file=None, tp_blocks=-1):
        key = (dtype, file, tp_blocks)
        if key not in _models:
            path = files[file] if file else files[ENGINES[dtype]]
            _models[key] = Model(path, ModelParams(
                dtype=dtype, device="cpu", tp_blocks=tp_blocks,
                attn="xla" if file == "moe" else "fused"))
        return _models[key]
    yield get
    for m in _models.values():
        m.close()
    _models.clear()


def _set_mode(monkeypatch, mode):
    monkeypatch.setattr(gl, "_WRITE_IN_KERNEL", mode == "write")
    monkeypatch.setattr(gl, "_FRESH_OPERAND", mode == "fresh")
    monkeypatch.setattr(pda, "_HB", mode == "hb")


def _stub():
    return sg.StepGraphs("cpu", backend=sg.StubBackend())


def _store(cfg, kv, paged, ctx=CTX, batch=1):
    """An empty dense row store, or a pool of 16-slot pages whose table
    holds each row's pages in scrambled order."""
    L, Hkv, D = cfg.n_layer, cfg.n_head_kv, cfg.head_dim_
    if not paged:
        return kvc.KVCache.create(L, batch, ctx, Hkv, D, kv, device="cpu")
    mp = ctx // 16
    cache = pkv.PagedKVCache.create(L, batch, batch * mp, 16, mp, Hkv, D, kv, device="cpu")
    perm = np.random.default_rng(5).permutation(batch * mp).astype(np.int32)
    return cache.with_table(perm.reshape(batch, mp))


def _flat(cache, pos):
    """Store slots of positions [B, T] (the row's page for a pool)."""
    if isinstance(cache, pkv.PagedKVCache):
        table = cache.page_table.numpy()
        return np.stack([table[b][pos[b] // 16] * 16 + pos[b] % 16
                         for b in range(pos.shape[0])]).astype(np.int32)
    return pos.astype(np.int32)


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


# -- the guard -----------------------------------------------------------------

GUARDED = {"item": lambda t: t.item(), "tolist": lambda t: t.tolist(),
           "cpu": lambda t: t.cpu(), "numpy": lambda t: t.numpy(),
           "__bool__": lambda t: bool(t), "__int__": lambda t: int(t),
           "__float__": lambda t: float(t), "tensor": lambda t: torch.tensor([1.0]),
           "as_tensor": lambda t: torch.as_tensor([1.0]),
           "from_numpy": lambda t: torch.from_numpy(np.ones(2))}


@pytest.mark.parametrize("name", list(GUARDED))
def test_guard_raises_on_host_reads_and_host_data(name):
    assert set(GUARDED) == set(sg.HOST_READS) | set(sg.HOST_DATA)
    t = torch.ones(())
    GUARDED[name](t)
    with sg.capture_guard():
        with pytest.raises(sg.HostAccess, match=name):
            GUARDED[name](t)
        kernels.plain_version(GUARDED[name])(t)    # a plain version is outside it
    GUARDED[name](t)                                # and the guard is gone after it


def test_guard_catches_a_host_copy_per_step(model, monkeypatch):
    """A rope that builds its frequencies from a host scalar every call (a
    host-to-device copy on the card) fails under the guard."""
    def per_call(rope_dim, freq_base, device):
        exponents = torch.arange(rope_dim // 2, dtype=torch.float32, device=device) \
            * (2.0 / rope_dim)
        return torch.pow(torch.tensor(freq_base, dtype=torch.float32, device=device),
                         -exponents)
    monkeypatch.setattr(prope, "_inv_freq", per_call)
    m = model("q4k_a8")
    with pytest.raises(sg.HostAccess, match="torch.tensor"):
        _guarded_steps(m, "int8", False)


def _guarded_steps(m, kv, paged, mode_of=False, weights=None):
    """A prompt chunk (T = 8) and a decode step (T = 1) on a fresh store,
    each run once as a capture's warm-up does and then under capture_guard,
    as the capture calls it (the inputs are made before); the decode step
    takes the loops' mode for the store when `mode_of`."""
    st = gl.static_of(m.config)
    cache = _store(m.config, kv, paged)
    pos = np.arange(9, dtype=np.int32)[None]
    args = [(torch.tensor([PROMPT], dtype=torch.int32), torch.from_numpy(pos[:, :8]),
             torch.from_numpy(_flat(cache, pos[:, :8])), torch.tensor([7])),
            (torch.tensor([[77]], dtype=torch.int32), torch.from_numpy(pos[:, 8:]),
             torch.from_numpy(_flat(cache, pos[:, 8:])), torch.tensor([0]))]
    w = weights or m.weights
    for step_st, (tok, pos, slot, li) in ((st, args[0]), (
            gl._mode_for(st, cache) if mode_of else st, args[1])):
        step_st.step(w, tok, pos, slot, cache, li)
        with sg.capture_guard():
            logits, _ = step_st.step(w, tok, pos, slot, cache, li)
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", list(ENGINES))
def test_steps_are_capture_safe_on_every_engine(dtype, kv, model):
    _guarded_steps(model(dtype), kv, False, mode_of=True)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("mode", MODES)
def test_steps_are_capture_safe_in_every_mode(mode, kv, model, monkeypatch):
    if mode == "fresh" and kv != "int8":
        pytest.skip("fresh mode reads an INT8 store only (the reference's gate)")
    _set_mode(monkeypatch, mode)
    _guarded_steps(model("q4k_a8", "modes"), kv, False, mode_of=True)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_steps_are_capture_safe_on_the_paged_pool(dtype, kv, model):
    _guarded_steps(model(dtype), kv, True)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_steps_are_capture_safe_on_moe(dtype, paged, model):
    """The routed one-row path (its expert ids stay on the device) and the
    masked chunk; the bank kernels' plain versions read the ids on the host,
    outside the guard."""
    _guarded_steps(model(dtype, "moe"), "int8", paged)


@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_steps_are_capture_safe_in_tp_blocks_mode(dtype, model):
    m = model(dtype, "modes", tp_blocks=4)
    assert m.config.tp_blocks == 4
    _guarded_steps(m, "int8", False)


def _rope_freqs(m):
    """The model's weights with llama-3.1 per-dim rope divisors added."""
    half = m.config.rope_dim_ // 2
    ff = (1.0 + np.arange(half, dtype=np.float32) / half * 7.0)
    w = dict(m.weights)
    w["rope_freqs"] = torch.from_numpy(ff).to(torch.bfloat16).float()
    return w, ff


@pytest.mark.parametrize("kv", KVS)
def test_steps_are_capture_safe_with_rope_freqs(kv, model):
    """The kernels' frequency vector is made once per rope_freqs tensor, not
    copied to the device every step."""
    m = model("q4k_a8")
    w, _ = _rope_freqs(m)
    _guarded_steps(m, kv, False, mode_of=True, weights=w)


# -- graphed = eager (StubBackend) ---------------------------------------------

def _loops(m, kv, graphs, n=5):
    """greedy_generate over an 8-token prompt, continue_greedy from its last
    logits, teacher_forced over the continued tokens, on one store of dense
    rows (the pool's loop is the scheduler's); every output, then the
    store's bits."""
    st = gl.static_of(m.config)
    cache = _store(m.config, kv, False)
    toks, ids, vals, cache = gl.greedy_generate(
        st, m.weights, torch.tensor([PROMPT], dtype=torch.int32), cache, len(PROMPT), n,
        graphs=graphs)
    last = cache.positions.clone()
    c_toks, full, cache = gl.continue_greedy(
        st, m.weights, cache, torch.zeros((1, sg.n_vocab(m.weights))),
        torch.tensor([len(PROMPT) + n], dtype=torch.int32), n, graphs=graphs)
    forced, cache = gl.teacher_forced(
        st, m.weights, cache, c_toks, torch.tensor([len(PROMPT) + 2 * n], dtype=torch.int32),
        graphs=graphs)
    return [toks, ids, vals, last, c_toks, full, forced] + testing.store_bits(cache)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", list(ENGINES))
def test_graphed_loops_equal_eager_on_every_engine(dtype, kv, model):
    m = model(dtype)
    _equal(_loops(m, kv, False), _loops(m, kv, _stub()))


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("mode", MODES)
def test_graphed_loops_equal_eager_in_every_mode(mode, kv, model, monkeypatch):
    if mode == "fresh" and kv != "int8":
        pytest.skip("fresh mode reads an INT8 store only (the reference's gate)")
    _set_mode(monkeypatch, mode)
    m = model("q4k_a8", "modes")
    _equal(_loops(m, kv, False, n=3), _loops(m, kv, _stub(), n=3))


@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_graphed_loops_equal_eager_on_moe(dtype, model):
    m = model(dtype, "moe")
    _equal(_loops(m, "int8", False, n=3), _loops(m, "int8", _stub(), n=3))


@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_graphed_loops_equal_eager_in_tp_blocks_mode(dtype, model):
    m = model(dtype, "modes", tp_blocks=4)
    _equal(_loops(m, "int8", False, n=3), _loops(m, "int8", _stub(), n=3))


def test_loop_chunks_carry_across_boundaries(model, monkeypatch):
    """Outputs copied out once a chunk of LOOP_CHUNK steps, the step index
    reset and the carries kept: 7 steps over chunks of 3."""
    monkeypatch.setattr(sg, "LOOP_CHUNK", 3)
    m = model("q4k_a8")
    _equal(_loops(m, "int8", False, n=7), _loops(m, "int8", _stub(), n=7))


def _scheduler_loop(m, kv, paged, graphs):
    """Two horizons of scheduler_loop over three rows: a greedy row, a
    forced row with claimed ids, and an idle one, after an 8-token prefill
    of each active row."""
    st = gl.static_of(m.config)
    cache = _store(m.config, kv, paged, batch=3)
    pos = np.tile(np.arange(8, dtype=np.int32), (3, 1))
    slots = _flat(cache, pos)
    slots[2] = cache.n_slots                      # row 2 idles: pads throughout
    logits, cache = st.step(m.weights, torch.tensor([PROMPT] * 3, dtype=torch.int32),
                            torch.from_numpy(pos), torch.from_numpy(slots), cache,
                            torch.tensor([7, 7, 7]))
    rng = np.random.default_rng(3)
    out = []
    for h in range(2):
        forced = np.full((3, 4), -2, np.int32)
        forced[0] = -1
        forced[1] = rng.integers(3, 200, 4)
        cids = torch.from_numpy(rng.integers(0, 200, (3, 4, 10)).astype(np.int32))
        start = torch.tensor([8 + 4 * h] * 3, dtype=torch.int32)
        *res, logits, cache = gl.scheduler_loop(st, m.weights, cache, logits, start,
                                                torch.from_numpy(forced), cids, 4,
                                                graphs=graphs)
        out += res + [logits]
    return out + testing.store_bits(cache)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", KVS)
def test_graphed_scheduler_loop_equals_eager(kv, paged, model):
    m = model("q4k_a8")
    _equal(_scheduler_loop(m, kv, paged, False), _scheduler_loop(m, kv, paged, _stub()))


@pytest.mark.parametrize("dtype", ["q4k_a8", "q4k_fused"])
def test_graphed_scheduler_loop_equals_eager_on_moe(dtype, model):
    m = model(dtype, "moe")
    _equal(_scheduler_loop(m, "int8", True, False), _scheduler_loop(m, "int8", True, _stub()))


def _session(m, graphs, kv="int8", ctx=CTX, fast=True, ga=1, n=12):
    inst = Instance(m, InstanceInitParams(ctx_size=ctx, kv_dtype=kv, fast_greedy=fast))
    if graphs:
        inst.graphs = _stub()
    inst.warmup()
    s = inst.start_session(SessionInitParams(seed=3, temperature=0.0, ga_factor=ga,
                                             ga_width=16))
    s.set_initial_prompt(PROMPT)
    preds = s.complete(CompleteParams(max_tokens=n))
    replayed = s.fill_ctx(preds[:6])
    inst.stop_session()
    rec = [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds + replayed]
    return inst, rec


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("fast", [True, False], ids=["device-loop", "per-token"])
def test_graphed_session_equals_eager(kv, fast, model):
    m = model("q4k_a8")
    assert _session(m, False, kv, fast=fast)[1] == _session(m, True, kv, fast=fast)[1]


@pytest.mark.parametrize("edit", ["context-shift", "self-extend"])
def test_replays_read_the_edited_positions(edit, model):
    """Context shift (kv_seq_rm / kv_seq_add) and Self-Extend (kv_seq_add /
    kv_seq_div) edit the positions in place between replays; a replay reads
    the edited map, as the eager step does."""
    m = model("q4k_a8")
    kw = dict(ctx=32, n=40) if edit == "context-shift" else dict(ga=2, n=30)
    inst, graphed = _session(m, True, fast=False, **kw)
    assert inst.allocator.host_positions.max() < len(PROMPT) + kw["n"] - 1   # edited
    keys = inst.graphs.keys()
    assert len({k[-1] for k in keys}) == 1                   # one store throughout
    assert graphed == _session(m, False, fast=False, **kw)[1]


@pytest.mark.parametrize("horizon", [0, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graphed_scheduler_equals_eager(paged, horizon, model):
    """Generation and verification rows through the scheduler's per-token
    step (a graph at (max_batch, 1)) or its horizon loop."""
    m = model("q4k_a8")
    prompts = [PROMPT, [1, 230, 17, 44, 231], [1, 9, 200, 280, 12, 13, 14, 15, 16, 17]]

    def run(graphs):
        sched = ContinuousBatchingScheduler(m, max_batch=4, ctx_size=128, paged=paged,
                                            page_size=16, horizon=horizon)
        if graphs:
            sched._graphs = _stub()
        outs, scores = {}, {}
        for i, p in enumerate(prompts):
            sched.submit(GenRequest(prompt=p, max_tokens=9,
                                    sampler_params=SamplerParams(temp=0.0),
                                    on_done=lambda g, i=i: outs.__setitem__(i, g)))
        sched.run_until_idle()
        for i, p in enumerate(prompts):
            sched.submit(VerifyRequest(prompt=p, predictions=outs[i],
                                       on_done=lambda s, i=i: scores.__setitem__(i, s)))
        sched.run_until_idle()
        if graphs:
            assert sched._graphs.keys()
        return [[(q.token, [(t.token, t.logit) for t in q.logits]) for q in outs[i]]
                for i in range(len(prompts))], scores

    eager, graphed = run(False), run(True)
    assert eager == graphed
    assert set(graphed[1].values()) == {1.0}


# -- keys and accounting ---------------------------------------------------------

def test_graph_keys(model):
    """One graph per (config, store, B, T): the same key across steps and
    cache edits, a new one when restore_cache builds a new store, and the
    old store's graphs dropped."""
    m = model("q4k_a8")
    inst = Instance(m, InstanceInitParams(ctx_size=CTX, kv_dtype="int8"))
    inst.graphs = _stub()
    inst.warmup()
    keys = inst.graphs.keys()
    assert sorted(k[3] for k in keys) == [1, 2]              # T = 1 and the warm-up's bucket
    inst.decode(PROMPT, np.arange(8))
    for i in range(3):
        inst.decode([5 + i], np.array([8 + i]))
    inst.kv_seq_rm(2, 4)
    inst.kv_seq_add(4, -1, -2)
    inst.decode([9], np.array([9]))
    assert sorted(k[3] for k in inst.graphs.keys()) == [1, 2, 8]
    old = sg.store_key(inst.cache)
    inst.restore_cache(*inst.cache_host())
    assert sg.store_key(inst.cache) != old and inst.graphs.keys() == []
    inst.decode([10], np.array([10]))
    assert [k[-1] for k in inst.graphs.keys()] == [sg.store_key(inst.cache)]
    assert [c["graph"] for c in inst.graphs.captures] == [
        "step B=1 T=2", "step B=1 T=1", "step B=1 T=8", "step B=1 T=1"]


def test_paged_table_install_keeps_the_key(model):
    m = model("q4k_a8")
    cache = _store(m.config, "int8", True, batch=2)
    key = sg.store_key(cache)
    cache.with_table(np.arange(8, dtype=np.int32).reshape(2, 4)[:, ::-1].copy())
    assert sg.store_key(cache) == key


class _CountingStatic:
    """A step that launches two kernels: what a capture records."""

    def step(self, params, tokens, positions, slots, cache, logits_index):
        kernels.count("w4a8_gemv")
        kernels.count("decode_attention")
        return torch.zeros((tokens.shape[0], sg.n_vocab(params))), cache


def test_replays_add_what_the_capture_recorded():
    """The warm-up and the capture count nothing; each replay adds the
    capture's launches once; an eager launch beside them counts as ever."""
    cache = kvc.KVCache.create(1, 2, 16, 1, 8, "int8", device="cpu")
    params = {"output": torch.zeros((4, 11))}
    graphs, st = _stub(), _CountingStatic()
    kernels.reset_launches()
    args = (torch.zeros((2, 1), dtype=torch.int32),) * 3 + (torch.zeros(2),)
    graphs.step(st, params, cache, *args)
    assert (kernels.LAUNCHES["w4a8_gemv"], kernels.LAUNCHES["decode_attention"]) == (1, 1)
    graphs.step(st, params, cache, *args)
    graphs.loop(st, params, cache, torch.zeros((2, 11)), torch.zeros(2, dtype=torch.int32), 5)
    assert kernels.LAUNCHES["w4a8_gemv"] == 7 and kernels.LAUNCHES["decode_attention"] == 7
    assert [g.launches for g in graphs._graphs.values()] == [
        {"w4a8_gemv": 1, "decode_attention": 1}] * 2
    kernels.count("w4a8_gemv")
    assert kernels.LAUNCHES["w4a8_gemv"] == 8
    kernels.reset_launches()


def test_cpu_runs_eagerly_unless_given_graphs(model):
    """On the CPU no graph is made: the Instance and the scheduler keep
    graphs=False, the loops run eagerly with graphs=None."""
    m = model("q4k_a8")
    assert Instance(m, InstanceInitParams(ctx_size=CTX)).graphs is False
    assert ContinuousBatchingScheduler(m, max_batch=2, ctx_size=CTX)._graphs is False
    assert sg.graphs_for(None, torch.device("cpu")) is None
    g = _stub()
    assert sg.graphs_for(g, torch.device("cpu")) is g


# -- against the JAX package -------------------------------------------------------

@pytest.mark.parametrize("freq_factors", [False, True], ids=["plain", "rope_freqs"])
@pytest.mark.parametrize("yarn", [None, (1.0, 1.0, 32.0, 1.0, 4096)], ids=["linear", "yarn"])
def test_cached_rope_angles_equal_jax(freq_factors, yarn):
    pos = np.array([[0, 1, 5, 700, 4095]], np.int32)
    ff = (1.0 + np.arange(32, dtype=np.float32) / 4.0) if freq_factors else None
    out = prope.rope_angles(torch.from_numpy(pos), 64, 500000.0, 0.25, yarn=yarn,
                            freq_factors=None if ff is None else torch.from_numpy(ff))
    ref = jrope.rope_angles(pos, 64, 500000.0, 0.25, yarn=yarn, freq_factors=ff)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)


def test_rope_freqs_forward_matches_jax(files):
    """A llama-3.1 rope_freqs vector in both packages' weights: the fused
    forward's logits agree as the plain file's do (tests/test_torch_session.py)."""
    pm = Model(files[GGMLType.Q4_K], ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    jm = JModel(files[GGMLType.Q4_K], JModelParams(dtype="q4k_a8", attn="fused"))
    w, ff = _rope_freqs(pm)
    pm.weights = w
    jm.weights = dict(jm.weights, rope_freqs=np.asarray(w["rope_freqs"].numpy()))
    pi = Instance(pm, InstanceInitParams(ctx_size=CTX, kv_dtype="int8"))
    pi.graphs = _stub()
    ji = JInstance(jm, JInstanceInitParams(ctx_size=CTX, flash_attn=True, kv_dtype="int8"))
    for toks, start, limit in ((PROMPT, 0, 0.027), ([77], 8, 0.038)):
        pos = np.arange(start, start + len(toks))
        ref, out = ji.decode(toks, pos), pi.decode(toks, pos)
        assert np.abs(out - ref).max() <= limit * np.abs(ref).max()
    pm.close()
    jm.close()


def test_graphed_greedy_generate_matches_jax(files):
    """The graphed loop's tokens are the JAX package's greedy_generate's on
    the tiny file (q4k_a8, INT8 store, fused attention)."""
    pm = Model(files[GGMLType.Q4_K], ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    jm = JModel(files[GGMLType.Q4_K], JModelParams(dtype="q4k_a8", attn="fused"))
    ji = JInstance(jm, JInstanceInitParams(ctx_size=CTX, flash_attn=True, kv_dtype="int8"))
    jst = jllama.LlamaStatic.of(ji.step_config)
    jtoks, jids, _, _ = jgl.greedy_generate(jst, jm.weights, np.array([PROMPT], np.int32),
                                           ji.cache, len(PROMPT), 5)
    cache = kvc.KVCache.create(pm.config.n_layer, 1, CTX, pm.config.n_head_kv,
                               pm.config.head_dim_, "int8", device="cpu")
    toks, ids, _, _ = gl.greedy_generate(gl.static_of(pm.config), pm.weights,
                                         torch.tensor([PROMPT], dtype=torch.int32), cache,
                                         len(PROMPT), 5, graphs=_stub())
    assert toks[0].tolist() == np.asarray(jtoks)[0].tolist()
    for a, b in zip(ids[0].tolist(), np.asarray(jids)[0].tolist()):
        assert len(set(a) & set(b)) >= 9
    pm.close()
    jm.close()
