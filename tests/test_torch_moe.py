"""The port's Mixtral-family MoE path against the JAX package's, on the CPU.

The fixture is the JAX package's `mixtral-debug` preset (2 layers, width 256,
4 experts, 2 per token, every matmul tensor Q4_K), written by the port's copy
of the synthesizer; `write_tiny_moe` (F32 tensors) serves the refusals. Both
engines the port serves for MoE, `q4k_fused` (exact) and `q4k_a8` (W4A8), run
against the JAX engine of the same name: the JAX side runs its Pallas bank
kernels in interpret mode, the port the plain versions of kernels J and K.
Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu import testing as jtesting
from blama_tpu.models import moe as jmoe
from blama_tpu.ops import kv_cache as jkvc
from blama_tpu.ops import paged_kv as jpkv
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu.runtime.instance import Instance as JInstance
from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.runtime.session import CompleteParams as JCompleteParams
from blama_tpu.runtime.session import SessionInitParams as JSessionInitParams
from blama_tpu_torch import testing
from blama_tpu_torch.models import moe
from blama_tpu_torch.ops import kv_cache as kvc
from blama_tpu_torch.ops import paged_kv as pkv
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import MOE_ENGINES, Model, ModelParams
from blama_tpu_torch.runtime.sampler import SamplerParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.server import http as phttp
from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                              VerifyRequest)

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

ENGINE_NAMES = ["q4k_fused", "q4k_a8"]
PROMPT = [1, 300, 301, 302, 303, 304, 305]
CTX = 64


@pytest.fixture(scope="module")
def moe_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("moe") / "mixtral-debug.gguf")
    testing.synthesize_moe_gguf(p, "mixtral-debug")
    return p


@pytest.fixture(scope="module")
def port_models(moe_file):
    models = {dt: Model(moe_file, ModelParams(dtype=dt, attn="xla", device="cpu"))
              for dt in ENGINE_NAMES}
    yield models
    for m in models.values():
        m.close()


@pytest.fixture(scope="module")
def jax_models(moe_file):
    models = {dt: JModel(moe_file, JModelParams(dtype=dt)) for dt in ENGINE_NAMES}
    yield models
    for m in models.values():
        m.close()


def _inst(model, kv="int8", cls=Instance, params=InstanceInitParams):
    return cls(model, params(ctx_size=CTX, kv_dtype=kv))


def _generate(inst, sess_cls, cp_cls, n=6, prompt=PROMPT):
    s = inst.start_session(sess_cls(seed=3, temperature=0.0))
    s.set_initial_prompt(prompt)
    preds = s.complete(cp_cls(max_tokens=n))
    inst.stop_session()
    return preds


def _verify(inst, sess_cls, preds, prompt=PROMPT):
    s = inst.start_session(sess_cls(seed=3, temperature=0.0))
    s.set_initial_prompt(prompt)
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score, sims = MetricsAggregator(), 0.0, []
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        sims.append(LogitComparer.logit_similarity(o.logits, r.logits))
    return score, float(np.mean(sims)), replayed


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# -- fixtures and weights -------------------------------------------------------

@pytest.mark.parametrize("which", ["mixtral-debug", "write_tiny_moe"])
def test_fixture_bytes_equal_the_jax_fixture(which, tmp_path):
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    if which == "mixtral-debug":
        testing.synthesize_moe_gguf(a, which)
        jtesting.synthesize_moe_gguf(b, which)
    else:
        testing.write_tiny_moe(a)
        jtesting.write_tiny_moe(b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_moe_preset_cut_keeps_the_first_layers(tmp_path):
    """`n_layer` cuts depth only: the cut file's tensors are the uncut file's."""
    from blama_tpu_torch.gguf.reader import GGUFReader

    a, b = str(tmp_path / "full.gguf"), str(tmp_path / "cut.gguf")
    testing.synthesize_moe_gguf(a, "mixtral-debug")
    spec = testing.synthesize_moe_gguf(b, "mixtral-debug", n_layer=1)
    assert spec["n_layer"] == 1 and testing.MOE_PRESETS["mixtral-debug"]["n_layer"] == 2
    with GGUFReader(a) as full, GGUFReader(b) as cut:
        assert cut.metadata["llama.block_count"] == 1
        assert "blk.1.attn_q.weight" not in cut.tensors
        for name in ("token_embd.weight", "output.weight", "blk.0.ffn_down_exps.weight",
                     "blk.0.ffn_gate_inp.weight"):
            assert np.array_equal(full.tensor_bytes(name), cut.tensor_bytes(name)), name
    w = testing.MOE_PRESETS["mixtral-8x7b"]
    assert (w["n_embd"], w["n_ff"], w["n_head"], w["n_head_kv"], w["n_vocab"],
            w["n_expert"], w["n_expert_used"]) == (4096, 14336, 32, 8, 32000, 8, 2)


def test_reader_splits_a_bank_by_expert(moe_file):
    """A 3-D bank reads as ne = (K, N, Ne); expert e owns bytes
    [e·N·K/256·144, (e+1)·N·K/256·144), and tensor_float gives (Ne, N, K)."""
    from blama_tpu_torch.gguf import quants
    from blama_tpu_torch.gguf.constants import GGMLType
    from blama_tpu_torch.gguf.reader import GGUFReader

    with GGUFReader(moe_file) as r:
        info = r.tensors["blk.1.ffn_down_exps.weight"]
        K, N, Ne = info.ne
        assert (K, N, Ne) == (512, 256, 4) and info.shape == (4, 256, 512)
        raw, whole = r.tensor_bytes(info.name).copy(), r.tensor_float(info.name)
        assert whole.shape == (Ne, N, K)
        per = N * K // 256 * 144
        for e in range(Ne):
            one = quants.dequantize(raw[e * per:(e + 1) * per], GGMLType.Q4_K, (N, K))
            assert np.array_equal(whole[e], one)


@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_bank_repack_equals_the_jax_repack(dt, port_models, jax_models):
    """Per expert: codes exactly; scales and mins bitwise (f32 or bf16)."""
    bank = port_models[dt].weights["layers"][1]["w_up_exps"]
    jbank = jax_models[dt].weights["layers"][1]["w_up_exps"]
    assert isinstance(bank, qm.QuantExperts) and bank.a8 == (dt == "q4k_a8")
    carried = moe._bank_from_jax(jax.tree_util.tree_map(np.asarray, jbank), "cpu")
    sdt = torch.bfloat16 if bank.a8 else torch.float32
    assert bank.codes.shape == (4, 512, 128) and bank.scales.dtype == sdt
    for e in range(bank.n_expert):
        for f in ("codes", "scales", "mins"):
            a, b = getattr(bank, f)[e], getattr(carried, f)[e]
            assert a.dtype == b.dtype and torch.equal(a, b), (e, f)
        # and the expert view is the repack of its slice of the GGUF bytes
        w = bank.expert(e)
        assert type(w) is (qm.QuantTensorA8S if bank.a8 else qm.QuantTensor)


@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_params_from_jax_carry_the_moe_tree(dt, port_models, jax_models):
    """The JAX package's loaded tree carried across equals the port's load,
    leaf for leaf, class for class."""
    loaded = port_models[dt].weights
    carried = moe.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jax_models[dt].weights), "cpu")
    assert set(carried) == set(loaded)
    for key in ("tok_emb", "out_norm"):
        assert torch.equal(carried[key], loaded[key]) and carried[key].dtype == loaded[key].dtype
    assert loaded["tok_emb"].dtype == torch.bfloat16    # a dense table, not packed
    for lc, ll in zip(carried["layers"] + [{"output": carried["output"]}],
                      loaded["layers"] + [{"output": loaded["output"]}], strict=True):
        assert set(lc) == set(ll)
        for key, a in lc.items():
            b = ll[key]
            assert type(a) is type(b), key
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), key
            else:
                for f in dataclasses.fields(a):
                    x, y = getattr(a, f.name), getattr(b, f.name)
                    assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, key
    want = qm.QuantTensorA8S if dt == "q4k_a8" else qm.QuantTensor
    assert type(loaded["output"]) is want and type(loaded["layers"][0]["wq"]) is want
    assert loaded["layers"][0]["router"].dtype == torch.bfloat16


# -- the bank products (kernels J and K, plain versions) ------------------------

@pytest.mark.parametrize("rows", [2, 20], ids=["2rows", "20rows"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_bank_matmul_matches_jax(dt, rows, port_models, jax_models):
    """Unsorted ids, read in place. W4A8 at 2 rows (kernel J: JAX un-jitted,
    so its activation codes are the port's) and the exact product elsewhere
    (kernel K, bf16 scales for the W4A8 bank above 16 rows). Tolerance 2e-6
    x max|ref|: the same f32 products summed in another order."""
    bank = port_models[dt].weights["layers"][0]["w_gate_exps"]
    jbank = jax_models[dt].weights["layers"][0]["w_gate_exps"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((rows, bank.shape[0])).astype(np.float32)
    ids = [3, 1, 2]
    with jax.disable_jit(dt == "q4k_a8"):
        ref = np.asarray(jqm.bank_matmul(jnp.asarray(x), jbank.codes, jbank.scales,
                                         jbank.mins, jnp.asarray(ids, jnp.int32),
                                         jbank.a8))[..., :jbank.n_out]
    eids = torch.tensor(ids, dtype=torch.int32)
    out = qm.bank_matmul(torch.from_numpy(x), bank, eids).numpy()
    assert out.shape == ref.shape == (3, rows, bank.n_out)
    assert np.abs(out - ref).max() <= 2e-6 * np.abs(ref).max()
    if dt == "q4k_a8" and rows <= qm.A8S_MAX_BATCH:
        # J is A against each selected expert, bit for bit
        for j, e in enumerate(ids):
            assert torch.equal(torch.from_numpy(out[j]),
                               qm.w4a8_matmul(torch.from_numpy(x), bank.expert(e)))


@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_bank_inputs_per_expert_and_row_invariance(dt, port_models):
    """One input per expert (the routed down bank) gives what each expert's
    own call gives, and a row's bits do not depend on the rows beside it."""
    bank = port_models[dt].weights["layers"][0]["w_down_exps"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, bank.shape[0])).astype(np.float32))
    eids = torch.tensor([2, 0], dtype=torch.int32)
    both = qm.bank_matmul(x, bank, eids)
    for j in range(2):
        alone = qm.bank_matmul(x[j], bank, eids[j:j + 1])[0]
        assert torch.equal(both[j], alone)
        one_row = qm.bank_matmul(x[j, 3:4], bank, eids[j:j + 1])[0]
        assert torch.equal(both[j, 3:4], one_row)


@pytest.mark.parametrize("threads", [1, 4])
def test_rows_mm_gives_a_row_its_bits_at_any_row_count(threads):
    """The exact plain versions' product (rows_mm): a row's result is the row
    alone, bit for bit, at 5 to 64 rows and on one or four torch threads."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 256)).astype(np.float32)).t()
    torch.set_num_threads(threads)
    try:
        alone = qm.rows_mm(a[63:].clone(), b)
        for M in (5, 16, 17, 64):
            assert torch.equal(qm.rows_mm(a[64 - M:], b)[-1:], alone), M
    finally:
        torch.set_num_threads(1)


def test_router_ties_break_as_lax_top_k():
    """Tied router logits (two equal columns, and equal values after the
    bf16 snap) pick the lower expert id, as lax.top_k does."""
    rng = np.random.default_rng(5)
    E, Ne, k = 64, 8, 2
    h = rng.standard_normal((16, E)).astype(np.float32)
    w = rng.standard_normal((E, Ne)).astype(np.float32) * 0.1
    w[:, 5] = w[:, 2]                            # exact ties between experts 2 and 5
    w[:, 6] = w[:, 1] * (1 + 2 ** -12)           # equal once snapped to bf16
    h[3] = 0.0                                   # a row where all eight tie
    h[4, :] = 0.0
    h[4, 0] = 1.0
    w[0, :] = 0.25                               # another all-tie row
    router = torch.from_numpy(w).to(torch.bfloat16)
    gate, idx = moe.route(torch.from_numpy(h).to(torch.bfloat16), router, k)
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    logits = jnp.dot(hb.astype(jnp.float32), jnp.asarray(router.float().numpy())
                     ).astype(jnp.bfloat16).astype(jnp.float32)
    vals, jidx = jax.lax.top_k(logits, k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[3].tolist() == [0, 1] and idx[4].tolist() == [0, 1]
    ties = (np.asarray(logits)[:, 2] == np.asarray(logits)[:, 5]).sum()
    assert ties == 16
    np.testing.assert_allclose(gate.numpy(), np.asarray(jax.nn.softmax(vals, axis=-1)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("R", [1, 8], ids=["routed", "masked"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_moe_ffn_quant_matches_jax(dt, R, port_models, jax_models):
    """The expert FFN of layer 0 on the same bf16 rows: the same routing, and
    the outputs within 2^-7 x max|ref| (bf16 outputs: one rounding flip)."""
    pm, jm = port_models[dt], jax_models[dt]
    rng = np.random.default_rng(11 + R)
    h = rng.standard_normal((1, R, pm.config.n_embd)).astype(np.float32)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    p, jp = pm.weights["layers"][0], jm.weights["layers"][0]
    with jax.disable_jit(dt == "q4k_a8"):
        ref = _np(jmoe.moe_ffn_quant(jnp.asarray(h).astype(jnp.bfloat16), jp,
                                     jmoe.MoEStatic.of(jm.config)))
    out = moe.moe_ffn_quant(hb, p, moe.MoEStatic.of(pm.config)).float().numpy()
    assert out.shape == ref.shape == h.shape
    assert np.abs(out - ref).max() <= 2 ** -7 * np.abs(ref).max()
    _, idx = moe.route(hb.reshape(R, -1), p["router"], 2)
    _, jidx = jax.lax.top_k(jnp.dot(jnp.asarray(h.reshape(R, -1)).astype(jnp.bfloat16)
                                    .astype(jnp.float32), jp["router"].astype(jnp.float32))
                            .astype(jnp.bfloat16).astype(jnp.float32), 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


# -- the forward -------------------------------------------------------------------

def _caches(cfg, kv, paged):
    """An empty store in each package: dense rows of CTX slots, or a pool of
    4 pages of 16 slots that the row holds in scrambled order."""
    L, Hkv, D = cfg.n_layer, cfg.n_head_kv, cfg.head_dim_
    jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}[kv]
    if not paged:
        return (jkvc.KVCache.create(L, 1, CTX, Hkv, D, jdt),
                kvc.KVCache.create(L, 1, CTX, Hkv, D, kv, device="cpu"), None)
    table = np.array([[2, 0, 3, 1]], np.int32)
    jc = jpkv.PagedKVCache.create(L, 1, 4, 16, 4, Hkv, D, jdt)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(table))
    pc = pkv.PagedKVCache.create(L, 1, 4, 16, 4, Hkv, D, kv, device="cpu")
    pc.with_table(table)
    return jc, pc, table


# port-vs-JAX logit gap of the 8-token chunk and the 1-token step after it, as a
# share of the largest logit, measured on this fixture (dense and paged read
# the same): bf16 rounding of the residual stream, the INT8 or bf16 cache
# rounding K and V that differ by such a flip, and for W4A8 an activation code
# that jitted XLA moves (its amax/127 through a reciprocal), as for the llama
# engines in tests/test_torch_engines.py. Held to 1.5 x.
GAP = {("q4k_fused", "int8"): (0.0057, 0.0110), ("q4k_fused", "bfloat16"): (0.0065, 0.0061),
       ("q4k_a8", "int8"): (0.0165, 0.0202), ("q4k_a8", "bfloat16"): (0.0118, 0.0202)}


CHUNKS = [np.array([[1, 300, 17, 44, 301, 9, 200, 400]], np.int32), np.array([[77]], np.int32)]


def _chunk_args(table):
    """(tokens, positions, slots, logits index) of each chunk in turn."""
    nxt = 0
    for toks in CHUNKS:
        T = toks.shape[1]
        pos = np.arange(nxt, nxt + T, dtype=np.int32)[None]
        slots = pos if table is None else (table[0][pos // 16] * 16 + pos % 16).astype(np.int32)
        nxt += T
        yield toks, pos, slots, np.array([T - 1], np.int32)


def _port_chunks(pm, cache, table):
    st, out = moe.MoEStatic.of(pm.config), []
    for toks, pos, slots, li in _chunk_args(table):
        lg, cache = moe.forward(pm.weights, st, torch.from_numpy(toks), torch.from_numpy(pos),
                                torch.from_numpy(slots), cache, torch.from_numpy(li))
        out.append(lg)
    return out, cache


# every engine, store type and layout once against JAX (each case compiles
# the JAX forward twice); paged == dense for all of them below
@pytest.mark.parametrize("dt,kv,paged", [("q4k_fused", "int8", False),
                                         ("q4k_fused", "bfloat16", True),
                                         ("q4k_a8", "int8", True),
                                         ("q4k_a8", "bfloat16", False)],
                         ids=["fused-int8-dense", "fused-bf16-paged", "a8-int8-paged",
                              "a8-bf16-dense"])
def test_forward_logits_match_jax(dt, kv, paged, port_models, jax_models):
    """T = 8 then T = 1 (masked, then routed), against the JAX forward."""
    pm, jm = port_models[dt], jax_models[dt]
    jst = jmoe.MoEStatic.of(jm.config)
    step = jax.jit(lambda p, t, q, s, c, li: jmoe.forward(p, jst, t, q, s, c, li))
    jc, pc, table = _caches(pm.config, kv, paged)
    outs, pc = _port_chunks(pm, pc, table)
    for (toks, pos, slots, li), out, gap in zip(_chunk_args(table), outs, GAP[dt, kv],
                                                strict=True):
        ref, jc = step(jm.weights, *map(jnp.asarray, (toks, pos, slots)), jc, jnp.asarray(li))
        ref, out = np.asarray(ref)[0], out.numpy()[0]
        assert out.shape == ref.shape == (pm.config.n_vocab,)
        assert np.abs(out - ref).max() <= 1.5 * gap * np.abs(ref).max(), toks.shape
        assert len(set(np.argsort(-ref)[:10]) & set(np.argsort(-out)[:10])) >= 8, toks.shape
    np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(jc.positions))


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_paged_forward_equals_dense(dt, kv, port_models):
    """The same chunks on dense rows and on scrambled pages: equal logits."""
    pm = port_models[dt]
    dense = _port_chunks(pm, _caches(pm.config, kv, False)[1], None)[0]
    _, pc, table = _caches(pm.config, kv, True)
    paged = _port_chunks(pm, pc, table)[0]
    assert all(torch.equal(a, b) for a, b in zip(dense, paged, strict=True))


def test_mixtral_arch_file_loads_in_both_packages(moe_file, port_models, tmp_path):
    """llama.cpp writes Mixtral checkpoints as `general.architecture =
    "mixtral"` with `mixtral.*` keys. Such a file (the fixture's tensors
    under that name) loads in the port as in the JAX package, as the
    llama file does, and the 8-token chunk's logits agree with the JAX
    package's within the forward test's tolerance (GAP above)."""
    path = str(tmp_path / "mixtral-arch.gguf")
    testing.synthesize_moe_gguf(path, "mixtral-debug", arch="mixtral")
    pm = Model(path, ModelParams(dtype="q4k_fused", device="cpu"))
    jm = JModel(path, JModelParams(dtype="q4k_fused"))
    assert pm.config.arch == jm.config.arch == "mixtral" and pm.config.is_moe
    assert dataclasses.replace(pm.config, arch="llama") == port_models["q4k_fused"].config
    jc, pc, _ = _caches(pm.config, "int8", False)
    toks, pos, slots, li = next(_chunk_args(None))
    out = _port_chunks(pm, pc, None)[0][0].numpy()[0]
    jst = jmoe.MoEStatic.of(jm.config)
    ref, _ = jax.jit(lambda p, t, q, s, c, i: jmoe.forward(p, jst, t, q, s, c, i))(
        jm.weights, *map(jnp.asarray, (toks, pos, slots)), jc, jnp.asarray(li))
    ref = np.asarray(ref)[0]
    assert np.abs(out - ref).max() <= 1.5 * GAP["q4k_fused", "int8"][0] * np.abs(ref).max()
    pm.close()
    jm.close()


@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_moe_ragged_changes_nothing_on_packed_banks(dt, moe_file, port_models):
    """The reference sends packed Q4_K banks to moe_ffn_quant before it reads
    the ragged switch (blama_tpu/models/moe.py:374-377): with either value
    the port loads, and the logits of the two chunks equal those without."""
    ref = _port_chunks(port_models[dt], _caches(port_models[dt].config, "int8", False)[1],
                       None)[0]
    for ragged in (True, False):
        m = Model(moe_file, ModelParams(dtype=dt, device="cpu", moe_ragged=ragged))
        out = _port_chunks(m, _caches(m.config, "int8", False)[1], None)[0]
        assert all(torch.equal(a, b) for a, b in zip(ref, out, strict=True))
        m.close()


# (engine, chunk length, torch threads): W4A8 keeps kernel A's rows up to 16
# (above, B takes the projections: other numerics than the decode step's A);
# the exact engine also at 32 rows on four threads, where the CPU's BLAS
# would pick another kernel and split the work
@pytest.mark.parametrize("dt,T,threads", [("q4k_fused", 8, 1), ("q4k_a8", 8, 1),
                                          ("q4k_fused", 32, 4)],
                         ids=["q4k_fused", "q4k_a8", "q4k_fused-T32-4threads"])
def test_routed_decode_equals_padded_masked_chunk(dt, T, threads, port_models):
    """One token decoded alone (routed: the selected experts only) and the
    same token inside a padded chunk (masked: every expert, unrouted weights
    0) give the same logits bit for bit (the reference's
    test_moe_quant_routed_matches_padded_masked)."""
    pm = port_models[dt]
    st = moe.MoEStatic.of(pm.config)

    def run(T):
        cache = kvc.KVCache.create(pm.config.n_layer, 1, CTX, pm.config.n_head_kv,
                                   pm.config.head_dim_, "bfloat16", device="cpu")
        toks = np.zeros((1, T), np.int32)
        toks[0, 0] = 7
        slots = np.full((1, T), CTX, np.int32)
        slots[0, 0] = 0
        lg, _ = moe.forward(pm.weights, st, torch.from_numpy(toks),
                            torch.zeros((1, T), dtype=torch.int32),
                            torch.from_numpy(slots), cache, torch.zeros(1, dtype=torch.long))
        return lg

    torch.set_num_threads(threads)
    try:
        assert torch.equal(run(1), run(T))
    finally:
        torch.set_num_threads(1)


# -- sessions, replay, serving ------------------------------------------------------

@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_same_backend_replay_is_exact(dt, kv, port_models):
    """A prover session (prompt chunk, then routed decode steps through the
    device loop) replayed by fill_ctx: every captured logit equal."""
    pm = port_models[dt]
    pi = _inst(pm, kv)
    preds = _generate(pi, SessionInitParams, CompleteParams, 8)
    assert len(preds) == 8
    score, sim, replayed = _verify(pi, SessionInitParams, preds)
    assert score == 1.0 and sim == 1.0
    for o, r in zip(preds, replayed, strict=True):
        assert [(t.token, t.logit) for t in o.logits] == [(t.token, t.logit) for t in r.logits]


@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_fast_and_slow_paths_agree(dt, port_models):
    """The device loop (generate_loop with MoEStatic) and the step-by-step
    session path give the same tokens and top-10 logits."""
    pm = port_models[dt]

    def run(fast):
        inst = Instance(pm, InstanceInitParams(ctx_size=CTX, kv_dtype="int8",
                                               fast_greedy=fast))
        return _generate(inst, SessionInitParams, CompleteParams)

    slow, fast = run(False), run(True)
    assert [(p.token, [(t.token, t.logit) for t in p.logits]) for p in slow] == \
        [(p.token, [(t.token, t.logit) for t in p.logits]) for p in fast]


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_cross_backend_replay_meets_thresholds(dt, direction, port_models, jax_models):
    """The reference's acceptance thresholds: score >= 0.95, mean similarity
    >= 0.98, in both directions."""
    port = (_inst(port_models[dt]), SessionInitParams, CompleteParams)
    jx = (_inst(jax_models[dt], cls=JInstance, params=JInstanceInitParams),
          JSessionInitParams, JCompleteParams)
    prover, verifier = (port, jx) if direction == "port->jax" else (jx, port)
    preds = _generate(*prover, n=10)
    assert len(preds) == 10
    score, sim, _ = _verify(verifier[0], verifier[1], preds)
    assert score >= 0.95 and sim >= 0.98, (score, sim)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dt", ENGINE_NAMES)
def test_scheduler_verifies_exactly(dt, paged, port_models):
    """Continuous batching on a MoE model (masked path at every step): three
    requests generated together, each replayed by the scheduler to 1.0."""
    pm = port_models[dt]
    sched = ContinuousBatchingScheduler(pm, max_batch=4, ctx_size=128, paged=paged,
                                        horizon=4)
    prompts = [PROMPT, [1, 40, 41], [1] + list(range(50, 62))]
    gen, scores = {}, {}
    for i, p in enumerate(prompts):
        sched.submit(GenRequest(prompt=p, max_tokens=6, sampler_params=SamplerParams(temp=0.0),
                                on_done=lambda g, i=i: gen.__setitem__(i, g)))
    sched.run_until_idle()
    assert all(len(gen[i]) == 6 for i in range(3))
    for i, p in enumerate(prompts):
        sched.submit(VerifyRequest(prompt=p, predictions=gen[i],
                                   on_done=lambda s, i=i: scores.__setitem__(i, s)))
    sched.run_until_idle()
    assert scores == {0: 1.0, 1: 1.0, 2: 1.0}


def test_http_serves_and_verifies_a_moe_model(port_models):
    """The HTTP server over SchedulerServer on the paged pool: two concurrent
    completions, each verified at exactly 1.0 over /verify_completion."""
    import json
    import threading
    import urllib.request

    from blama_tpu_torch.server.http import HttpServer
    from blama_tpu_torch.server.scheduler_server import SchedulerServer

    api = SchedulerServer(port_models["q4k_a8"], InstanceInitParams(ctx_size=128),
                          max_batch=2, paged=True, horizon=4)
    srv = HttpServer(("127.0.0.1", 0), api)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        bodies = [{"prompt": t, "max_tokens": 5, "seed": 1, "temp": 0.0}
                  for t in ("hello world", "the cat sat")]
        out = [None, None]
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, post("/complete",
                                                                               bodies[i])))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for body, resp in zip(bodies, out, strict=True):
            assert resp is not None and len(resp["tokenData"]) == 5
            v = post("/verify_completion",
                     {"request": body, "response": {"tokenData": resp["tokenData"]}})
            assert v == {"result": 1.0}
    finally:
        srv.shutdown()
        srv.server_close()
        api.close()


def test_http_main_picks_xla_attention_for_moe(moe_file, monkeypatch):
    """The server builds ModelParams as the reference's does, attn left at
    its default, "xla": the two-pass chain for a MoE file and for a llama
    file alike; BLAMA_DTYPE still names the engine."""
    seen = {}

    class Stop(Exception):
        pass

    import blama_tpu_torch.runtime.model as pmodel

    real = pmodel.Model

    def recording_model(path, params, progress_cb=None):
        m = real(path, params, progress_cb)
        seen["model"] = (params.dtype, params.attn, m.config.attn_fused, m.device.type)
        m.close()
        raise Stop

    llama = str(moe_file).replace("mixtral-debug", "llama")
    testing.write_tiny_llama(llama)
    monkeypatch.setenv("BLAMA_DEVICE", "cpu")
    monkeypatch.setenv("BLAMA_DTYPE", "q4k_fused")
    monkeypatch.delenv("BLAMA_MULTIHOST", raising=False)
    monkeypatch.setattr(pmodel, "Model", recording_model)
    for path in (moe_file, llama):
        monkeypatch.setenv("BLAMA_MODEL", path)
        with pytest.raises(Stop):
            phttp.main()
        assert seen["model"] == ("q4k_fused", "xla", False, "cpu")


# -- refusals ---------------------------------------------------------------------

def test_fused_attention_is_refused_for_moe(moe_file):
    with pytest.raises(ValueError, match="attn='fused' is unsupported with a MoE model"):
        Model(moe_file, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))


@pytest.mark.parametrize("dtype", ["q4k_fused_k4", "q4k_a8_k4", "q4k_a8_xla", "q8_0_fused",
                                   "float32"])
def test_other_engines_are_refused_for_moe(moe_file, dtype):
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 9"):
        Model(moe_file, ModelParams(dtype=dtype, attn="xla", device="cpu"))


def test_moe_ragged_is_refused_for_dense_moe_engines(moe_file):
    """The switch picks the mixture of dense expert banks, which no engine of
    the port loads yet: refused there, with the MoE item."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 10"):
        Model(moe_file, ModelParams(dtype="float32", device="cpu", moe_ragged=True))


def test_non_q4k_bank_is_refused(tmp_path):
    """write_tiny_moe's banks are F32: the reference would load them dense and
    fail in its bank kernel; the port refuses at load."""
    p = str(tmp_path / "tiny-moe.gguf")
    testing.write_tiny_moe(p)
    with pytest.raises(NotImplementedError, match="expert banks of another type"):
        Model(p, ModelParams(dtype="q4k_fused", attn="xla", device="cpu"))


def test_moe_engines_want_the_card_by_default(moe_file):
    assert sorted(MOE_ENGINES) == sorted(ENGINE_NAMES)
    for dtype in MOE_ENGINES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(moe_file, ModelParams(dtype=dtype, attn="xla"))
