"""The reference's fused projection layouts (BLAMA_FUSE_PROJ=1: wq|wk|wv as
"wqkv" and w_gate|w_up as "wgu"; BLAMA_FUSE_KV=1: wk|wv as "wkv") in the
port, on the CPU. For every packed engine and a Q4_K_M-pattern file:
the port loads the reference's fused layout leaf for leaf (none where the
parts' types differ, none under tp_blocks or a dense engine), its wide
product agrees with the JAX package's on the same weights within the
matmul tolerance, and the fused model's tokens, top-10 and logits equal the
unfused model's bit for bit (each column is summed alone), so a fused
prover replays on an unfused verifier at exactly 1.0. The switches are read
at Model load, set here through monkeypatch.setenv before each Model.
The fixture is the tiny llama at 4 / 4 heads of dim 64, so every part is a
whole number of the reference's 256-lane tiles (it fuses only unpadded
parts).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu_torch.gguf import GGMLType
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
from blama_tpu_torch.testing import Q4_K_M, write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

SPEC = dict(n_head_kv=4)   # E 256, 4 / 4 heads of 64: wq, wk, wv 256 wide, gate/up 512
FILES = {"q4k": GGMLType.Q4_K, "q8": GGMLType.Q8_0, "q6": GGMLType.Q6_K, "mixed": Q4_K_M}
CASES = [("q4k", "q4k_fused"), ("q4k", "q4k_fused_k4"), ("q4k", "q4k_a8"),
         ("q4k", "q4k_a8_k4"), ("q4k", "q4k_a8_xla"), ("q8", "q8_0_fused"),
         ("q6", "q6_k_fused"), ("mixed", "q4k_a8")]
IDS = [f"{f}-{d}" for f, d in CASES]
SWITCHES = {"proj": "BLAMA_FUSE_PROJ", "kv": "BLAMA_FUSE_KV"}
PROMPT = "hello world the cat sat"
UNFUSED = {"wq", "wk", "wv", "w_gate", "w_up"}


def _layout(path, switch, layer=0):
    """The fused keys of a layer as the reference's `_fusable` picks them:
    a group fuses where its parts share one GGML type, so in a Q4_K_M file
    a layer whose wv is Q6_K keeps wq, wk and wv apart."""
    from blama_tpu_torch.gguf.reader import GGUFReader

    r = GGUFReader(path)
    t = {k: r.tensors[f"blk.{layer}.{n}.weight"].ggml_type for k, n in (
        ("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"), ("w_gate", "ffn_gate"),
        ("w_up", "ffn_up"))}
    r.close()
    groups = {"kv": {"wkv": ("wk", "wv")},
              "proj": {"wqkv": ("wq", "wk", "wv"), "wgu": ("w_gate", "w_up")}}[switch]
    return {key: parts for key, parts in groups.items() if len({t[k] for k in parts}) == 1}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuse")
    out = {}
    for name, quant in FILES.items():
        out[name] = str(d / f"{name}.gguf")
        write_tiny_llama(out[name], quant, spec=SPEC)
    return out


def _port(path, dtype, monkeypatch, switch=None, **kw):
    for env in SWITCHES.values():
        monkeypatch.delenv(env, raising=False)
    if switch:
        monkeypatch.setenv(SWITCHES[switch], "1")
    m = Model(path, ModelParams(dtype=dtype, attn="fused", device="cpu", **kw))
    for env in SWITCHES.values():
        monkeypatch.delenv(env, raising=False)
    return m


def _jax(path, dtype, monkeypatch, switch):
    monkeypatch.setenv(SWITCHES[switch], "1")
    m = JModel(path, JModelParams(dtype=dtype, attn="fused"))
    monkeypatch.delenv(SWITCHES[switch])
    return m


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if not dataclasses.is_dataclass(a):
        return a == b
    return type(a) is type(b) and all(
        _equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("file,dtype", CASES, ids=IDS)
def test_fused_layout_equals_the_reference(files, file, dtype, switch, monkeypatch):
    """The port's fused layers hold the keys the reference's hold, and each
    weight equals the reference's (concat_quant of its parts) carried over
    by params_from_jax, leaf for leaf."""
    pm = _port(files[file], dtype, monkeypatch, switch)
    jm = _jax(files[file], dtype, monkeypatch, switch)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.weights), device="cpu")
    n_fused = 0
    for i, (p, c) in enumerate(zip(pm.weights["layers"], carried["layers"], strict=True)):
        want = _layout(files[file], switch, i)
        fused = set(p) - UNFUSED - {"attn_norm", "ffn_norm", "wo", "w_down"}
        assert fused == set(want) and set(p) == set(c), (i, set(p), set(c))
        for key in want:
            assert _equal(p[key], c[key]), key
        n_fused += len(want)
    assert n_fused
    if file == "mixed":   # layer 1's wv is Q6_K: its k / v stay apart from the Q4_K parts
        assert "wv" in pm.weights["layers"][1] and "wv" in carried["layers"][1]
    pm.close()
    jm.close()


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("file,dtype", CASES, ids=IDS)
def test_fused_product_agrees_with_the_reference(files, file, dtype, switch, monkeypatch):
    """Layer 0's wide products at 1 and 8 rows against the JAX package's
    qmm on its fused weight (Pallas kernels in interpret mode): both round
    f32 sums taken in another order to bf16, so within one bf16 step of the
    largest output (2^-7 of it); and each column equal, bit for bit, to the
    same column of the port's product on the part it came from."""
    want = _layout(files[file], switch)
    if not want:
        pytest.skip("layer 0 fuses nothing here (test_fused_layout_equals_the_reference)")
    pm = _port(files[file], dtype, monkeypatch, switch)
    um = _port(files[file], dtype, monkeypatch)
    jm = _jax(files[file], dtype, monkeypatch, switch)
    p, u, jp = pm.weights["layers"][0], um.weights["layers"][0], jm.weights["layers"][0]
    for m in (1, 8):
        x = np.random.default_rng(m).standard_normal((m, 256)).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        xp = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
        for key, parts in want.items():
            out = qm.qmm(xp, p[key])
            ref = np.asarray(jqm.qmm(xj, jp[key]).astype(jnp.float32))[:, :out.shape[1]]
            np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                       atol=2.0 ** -7 * np.abs(ref).max(), err_msg=key)
            alone = torch.cat([qm.qmm(xp, u[k]) for k in parts], dim=-1)
            assert torch.equal(out, alone), key
    for mm in (pm, um, jm):
        mm.close()


def _prove(inst, vocab, n=8):
    s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    preds = s.complete(CompleteParams(max_tokens=n))
    inst.stop_session()
    return preds


def _replay(inst, vocab, preds):
    s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
    s.set_initial_prompt(vocab.tokenize(PROMPT, True, True))
    replayed = s.fill_ctx(preds)
    inst.stop_session()
    agg, score = MetricsAggregator(), 0.0
    for o, r in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
    return score, replayed


def _top10(preds):
    return [(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds]


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("file,dtype", CASES, ids=IDS)
def test_fused_equals_unfused_bit_for_bit(files, file, dtype, switch, monkeypatch):
    """The fused model's tokens and top-10 equal the unfused model's, on the
    fused kernels' paths over an INT8 store (the prompt's chunks and the
    one-row decode steps), and each replays the other's records at exactly
    1.0 with equal logits."""
    pm = _port(files[file], dtype, monkeypatch, switch)
    um = _port(files[file], dtype, monkeypatch)
    params = InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8")
    pi, ui = Instance(pm, params), Instance(um, params)
    fused, plain = _prove(pi, pm.vocab), _prove(ui, um.vocab)
    assert _top10(fused) == _top10(plain)
    for verifier, vocab, preds in ((ui, um.vocab, fused), (pi, pm.vocab, plain)):
        score, replayed = _replay(verifier, vocab, preds)
        assert score == 1.0 and _top10(replayed) == _top10(preds)
    pm.close()
    um.close()


def test_no_fusion_under_tp_blocks_or_a_dense_engine(files, monkeypatch):
    """The reference fuses a packed engine without tp_blocks only: tp_blocks
    (a verification mode whose solo and sharded engines share arithmetic)
    and the dense engines keep every projection apart, switch or not."""
    for kw in (dict(dtype="q4k_fused", tp_blocks=4), dict(dtype="float32"),
               dict(dtype="bfloat16")):
        for switch in SWITCHES:
            dtype = kw.pop("dtype")
            m = _port(files["q4k"], dtype, monkeypatch, switch, **kw)
            kw["dtype"] = dtype
            assert all(UNFUSED <= set(p) for p in m.weights["layers"]), (kw, switch)
            m.close()


def test_fusable_follows_the_reference():
    """quant_matmul.fusable: one packed class, widths the reference leaves
    unpadded (256-lane tiles; past 4096 a 4096 or 2048 multiple within 5%),
    one Q8 scale group; and the 8B fused widths (6144, 2048, 28672) fuse."""
    def q8(n, group=32):
        return qm.QuantTensorQ8(torch.zeros((n, 64), dtype=torch.int8),
                                torch.zeros((n, 64 // group)), group)

    def k4(n):
        return qm.QuantTensorK4(torch.zeros((n, 144), dtype=torch.uint8))

    assert qm.fusable([q8(256), q8(512)])
    assert not qm.fusable([q8(256), q8(128)])              # padded to 256 there
    assert not qm.fusable([q8(256), q8(256, 16)])          # Q8_0 beside Q6_K
    assert not qm.fusable([q8(256), k4(256)])              # two classes
    assert not qm.fusable([qm.QuantTensorA8K4(k4(256).codes), k4(256)])
    assert qm.fusable([k4(4096), k4(1024), k4(1024)]) and qm.fusable([k4(14336), k4(14336)])
    assert not qm.fusable([torch.zeros(256, 256), torch.zeros(256, 256)])
    for n in (256, 4096, 6144, 14336, 28672, 128256, 4352):
        ref = jqm._widen_target(-(-n // 256) * 256)
        assert qm.reference_lane_width(n) == ref, n
    fused = qm.concat_quant([q8(256), q8(512)])
    assert fused.n_out == 768 and fused.group == 32
