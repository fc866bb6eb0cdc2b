"""Llama-family transformer: GGUF weight loading and the forward pass.

Counterpart of blama_tpu/models/llama.py for the slice the port serves: the
llama-family architectures of ARCHS (qwen2's q/k/v biases, gemma's scaled
input and (1 + w) norms with the exact GELU, phi3's fused attn_qkv and
stacked [gate; up] ffn_up, split at load as the reference splits them), the
dense engines (`fused_quant=False`: every tensor dequantized to float32 or
bfloat16, the reference's defaults) and the packed weight engines
(`fused_quant` True, "k4", "a8", "a8k4", "a8x": Q4_K tensors packed as the
engine says, Q8_0 and Q6_K tensors packed for the exact int8-code kernel
under every engine, anything else a dense bf16 weight), q/k/v and gate/up
projections unfused or, under the reference's BLAMA_FUSE_PROJ /
BLAMA_FUSE_KV, fused into one wide product (fuse_projections), dense KV
rows or the scheduler's paged pool, INT8, bf16 or f32 KV, and either attention mode: fused (LlamaStatic.attn_fused;
the two-pass chain still serves the chunks and geometries the fused gates
refuse, T in {2, 4}, as in the reference) or the two-pass chain at every
chunk (attn="xla"), with the reference's opt-in decode-attention modes on
dense rows (LlamaStatic.attn_write / attn_fresh, set by ops/generate_loop).
A layer dict may carry a control vector's bias ("cvec", added after the
layer's residual) and LoRA-wrapped projections (quant_matmul.LoraWrapped,
through the same dispatch); `forward(..., return_hidden=True)` and
last_hidden give the lm head's input, the embeddings path of a
decoder-only model.

Weights are a plain dict: {"tok_emb", "out_norm", "output", "layers": [one
dict per layer], optional "rope_freqs"}. The forward keeps the reference's
arithmetic order wherever the logits depend on it: the residual stream in
the activation dtype (the embedding table's: bf16 for the packed engines
and the bfloat16 engine, f32 for the float32 engine), rms_norm in f32 with
f32 (dtype-rounded) weights, every matmul accumulated in f32 and cast to
the activation dtype, a packed lm head fed f32 and a dense one the weight's
dtype with f32 sums. In the fixed-topology tp_blocks mode
(LlamaStatic.tp_blocks > 0) the projections take the reference's
qmm_nblocked / qmm_blocked at its sites.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops import decode_attention as dattn
from ..ops import dequant
from ..ops import paged_attention as pattn
from ..ops import kv_cache as kvc
from ..ops import paged_kv as pkv
from ..ops.attention import attention
from ..ops.kernels import resolve_device
from ..ops.kv_cache import SlotStore, dequantize_kv
from ..ops.norms import rms_norm
from ..ops import quant_matmul as qm
from ..ops.quant_matmul import (QuantEmbedding, emb_lookup, qmm_blocked, qmm_nblocked,
                                rows_mm)
from ..ops.rope import apply_rope, rope_angles
from .config import ModelConfig

# llama-family architectures whose GGUFs the forward below serves (the
# reference's list, blama_tpu/runtime/model.py:109)
ARCHS = ("llama", "mistral", "qwen2", "mixtral", "gemma", "gemma2", "phi3")

_LAYER_TENSORS = {
    "attn_norm": "blk.{i}.attn_norm.weight",
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "ffn_norm": "blk.{i}.ffn_norm.weight",
    "w_gate": "blk.{i}.ffn_gate.weight",
    "w_up": "blk.{i}.ffn_up.weight",
    "w_down": "blk.{i}.ffn_down.weight",
}

# qwen2's projection biases: loaded when every layer has attn_q.bias
_OPTIONAL_BIASES = {
    "bq": "blk.{i}.attn_q.bias",
    "bk": "blk.{i}.attn_k.bias",
    "bv": "blk.{i}.attn_v.bias",
}


def _bf16_rounded(a, device) -> torch.Tensor:
    """f32 tensor whose values went through bf16, as the reference stores
    its norm weights (bf16 storage upcast once at load)."""
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device) \
        .to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------

# fused_quant → the repack of a Q4_K matmul tensor (reference load_llama_params)
Q4K_REPACKS = {True: qm.repack_q4k_exact, "k4": qm.repack_q4k_native,
               "a8": qm.repack_q4k_a8s, "a8k4": qm.repack_q4k_a8k4,
               "a8x": qm.repack_q4k_w4a8}


def tensor_values(reader, name: str, device, dtype=torch.float32) -> torch.Tensor:
    """reader.tensor_float(name) on `device` in `dtype`: the GGUF bytes go to
    the device and are dequantized there (ops/dequant, bit-equal to the
    host's numpy functions), so host memory holds one tensor's bytes at a
    time."""
    info = reader.tensors[name]
    return dequant.dequantize(reader.tensor_bytes(name), info.ggml_type, info.shape,
                              device, dtype)


def _layout(reader, cfg: ModelConfig) -> tuple[bool, bool, bool]:
    """(has_bias, fused_qkv, fused_gate_up) of a llama-family file, as the
    reference's load_llama_params tells them: q/k/v biases in every layer
    (qwen2), phi3's fused attn_qkv, and its ffn_up holding [gate; up] with
    no ffn_gate."""
    t = reader.tensors
    L = cfg.n_layer
    has_bias = L > 0 and all(_OPTIONAL_BIASES["bq"].format(i=i) in t for i in range(L))
    fused_qkv = L > 0 and "blk.0.attn_qkv.weight" in t
    fused_gate_up = L > 0 and "blk.0.ffn_gate.weight" not in t and "blk.0.ffn_up.weight" in t
    return has_bias, fused_qkv, fused_gate_up


def _split_parts(reader, cfg: ModelConfig, i: int, fused_qkv: bool, fused_gate_up: bool,
                 device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Layer i's projections cut from phi3's fused tensors, dense (n_in,
    n_out) in `dtype`, as the reference splits them (through tensor_float,
    under every engine): attn_qkv's rows into wq | wk | wv of H·D, Hkv·D and
    Hkv·D, ffn_up's into w_gate | w_up halves. The GGUF bytes are
    dequantized on `device` (tensor_values) and cut there."""
    out = {}
    if fused_qkv:
        qkv = tensor_values(reader, f"blk.{i}.attn_qkv.weight", device)   # [N, E]
        hd, kvd = cfg.n_head * cfg.head_dim_, cfg.n_head_kv * cfg.head_dim_
        for key, lo, hi in (("wq", 0, hd), ("wk", hd, hd + kvd),
                            ("wv", hd + kvd, hd + 2 * kvd)):
            out[key] = qkv[lo:hi].to(dtype).t().contiguous()
    if fused_gate_up:
        gu = tensor_values(reader, f"blk.{i}.ffn_up.weight", device)      # [2F, E]
        half = gu.shape[0] // 2
        out["w_gate"] = gu[:half].to(dtype).t().contiguous()
        out["w_up"] = gu[half:].to(dtype).t().contiguous()
    return out


def _layer_keys(fused_qkv: bool, fused_gate_up: bool):
    """The (key, tensor name pattern) pairs a layer reads one by one: the
    parts a fused tensor carries are cut by _split_parts instead."""
    skip = ({"wq", "wk", "wv"} if fused_qkv else set()) | (
        {"w_gate", "w_up"} if fused_gate_up else set())
    return [(k, pat) for k, pat in _LAYER_TENSORS.items() if k not in skip]


def load_dense_params(reader, cfg: ModelConfig, dtype: torch.dtype,
                      device="cuda", progress_cb=None) -> dict[str, Any]:
    """The reference's load_llama_params with fused_quant=False: every
    tensor `reader.tensor_float(...)` converted to `dtype` (float32 or
    bfloat16), matmul weights transposed to (n_in, n_out), the q/k/v biases
    in `dtype`, the norms (and rope_freqs) kept as f32 of their
    `dtype`-rounded values (gemma's w + 1 then rounds to `dtype` where the
    reference's does: LlamaStatic.norm_bf16), a tied head the embedding's
    transpose. Each tensor is dequantized on `device` (tensor_values) and
    converted as soon as it is read."""
    device = resolve_device(device)
    has_bias, fused_qkv, fused_gate_up = _layout(reader, cfg)

    def get_t(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(dtype).t().contiguous()

    def get_b(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(dtype)

    def get_v(name: str) -> torch.Tensor:
        return get_b(name).float()

    n_total = cfg.n_layer + 2
    layers = []
    keys = _layer_keys(fused_qkv, fused_gate_up)
    for i in range(cfg.n_layer):
        p = {key: get_v(pat.format(i=i)) if key.endswith("_norm")
             else get_t(pat.format(i=i)) for key, pat in keys}
        p.update(_split_parts(reader, cfg, i, fused_qkv, fused_gate_up, device, dtype))
        if has_bias:
            p.update({k: get_b(pat.format(i=i)) for k, pat in _OPTIONAL_BIASES.items()})
        layers.append(p)
        if progress_cb:
            progress_cb((i + 1) / n_total)
    tok_emb = tensor_values(reader, "token_embd.weight", device).to(dtype)   # (V, E)
    params = {
        "tok_emb": tok_emb,
        "out_norm": get_v("output_norm.weight"),
        "layers": layers,
        "output": (get_t("output.weight") if "output.weight" in reader.tensors
                   else tok_emb.t().contiguous()),                          # (E, V)
    }
    if "rope_freqs.weight" in reader.tensors:
        params["rope_freqs"] = get_v("rope_freqs.weight")
    return params


def fuse_projections(p: dict, fuse_proj: bool | str) -> None:
    """The reference's BLAMA_FUSE_PROJ / BLAMA_FUSE_KV layouts of one layer,
    in place: fuse_proj=True concatenates wq|wk|wv into "wqkv" and
    w_gate|w_up into "wgu", "kv" only wk|wv into "wkv", each where the parts
    fuse (quant_matmul.fusable: one packed class, as the reference's
    `_fusable`; so a Q4_K_M file's Q6_K wv stays apart)."""
    if fuse_proj == "kv":
        if qm.fusable([p["wk"], p["wv"]]):
            p["wkv"] = qm.concat_quant([p.pop("wk"), p.pop("wv")])
        return
    if qm.fusable([p["wq"], p["wk"], p["wv"]]):
        p["wqkv"] = qm.concat_quant([p.pop("wq"), p.pop("wk"), p.pop("wv")])
    if qm.fusable([p["w_gate"], p["w_up"]]):
        p["wgu"] = qm.concat_quant([p.pop("w_gate"), p.pop("w_up")])


def load_llama_params(reader, cfg: ModelConfig, fused_quant: bool | str = "a8",
                      device="cuda", progress_cb=None,
                      dtype: torch.dtype = torch.bfloat16,
                      fuse_proj: bool | str = False) -> dict[str, Any]:
    """Load llama-family weights onto `device`.

    `fused_quant=False`: the dense engine of `dtype` (load_dense_params).
    Else per tensor, as in the reference: a Q8_0 or Q6_K tensor is packed
    for the exact int8-code kernel whatever the engine, a Q4_K tensor is
    packed as `fused_quant` says, any other type becomes a dense bf16
    (n_in, n_out) weight; phi3's fused tensors are split into dense bf16
    parts (_split_parts), as the reference reads them through tensor_float
    under every engine, and qwen2's biases are bf16, the engine's dtype;
    `fuse_proj` (True or "kv") then fuses the projections as
    fuse_projections says (dense parts stay apart). Every tensor is
    repacked on the device and uploaded as soon as it is read, so host
    memory holds one tensor's GGUF bytes at a time.
    """
    from ..gguf.constants import GGMLType

    device = resolve_device(device)
    if fused_quant is False:
        return load_dense_params(reader, cfg, dtype, device, progress_cb)
    if fused_quant not in Q4K_REPACKS:
        raise NotImplementedError(
            f"fused_quant={fused_quant!r} is not an engine of the port "
            "(ROADMAP.md §1 item 9, other engines)")
    repacks = {GGMLType.Q4_K: Q4K_REPACKS[fused_quant], GGMLType.Q8_0: qm.repack_q8_0,
               GGMLType.Q6_K: qm.repack_q6_k_expanded}

    def dense(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(torch.bfloat16)

    def get_t(name: str):
        info = reader.tensors[name]
        if info.ggml_type in repacks:
            return repacks[info.ggml_type](reader.tensor_bytes(name), info.ne[1],
                                           info.ne[0], device)
        return dense(name).t().contiguous()            # (n_in, n_out)

    def get_v(name: str) -> np.ndarray:
        return reader.tensor_float(name)

    has_bias, fused_qkv, fused_gate_up = _layout(reader, cfg)
    n_total = cfg.n_layer + 2
    layers = []
    for i in range(cfg.n_layer):
        p = {}
        for key, pat in _layer_keys(fused_qkv, fused_gate_up):
            name = pat.format(i=i)
            if key in ("attn_norm", "ffn_norm"):
                p[key] = _bf16_rounded(get_v(name), device)
            else:
                p[key] = get_t(name)
        p.update(_split_parts(reader, cfg, i, fused_qkv, fused_gate_up, device,
                              torch.bfloat16))
        if has_bias:
            p.update({k: dense(pat.format(i=i)) for k, pat in _OPTIONAL_BIASES.items()})
        if fuse_proj:
            fuse_projections(p, fuse_proj)
        layers.append(p)
        if progress_cb:
            progress_cb((i + 1) / n_total)

    emb_info = reader.tensors["token_embd.weight"]
    if emb_info.ggml_type == GGMLType.Q4_K:
        tok_emb = qm.repack_q4k_embedding(reader.tensor_bytes("token_embd.weight"),
                                          emb_info.ne[1], emb_info.ne[0], device)
    else:
        tok_emb = dense("token_embd.weight")            # (V, E) bf16, gathered
    if "output.weight" in reader.tensors:
        output = get_t("output.weight")
    elif isinstance(tok_emb, QuantEmbedding):
        # tied embeddings, packed table: the lm head reads the token_embd
        # bytes through the matmul repack
        output = get_t("token_embd.weight")
    else:
        output = tok_emb.t().contiguous()
    params = {
        "tok_emb": tok_emb,
        "out_norm": _bf16_rounded(get_v("output_norm.weight"), device),
        "layers": layers,
        "output": output,
    }
    if "rope_freqs.weight" in reader.tensors:
        params["rope_freqs"] = _bf16_rounded(get_v("rope_freqs.weight"), device)
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from the JAX tree
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _cols(a, n_out: int, device) -> torch.Tensor:
    """A reference array [rows, N_pad] → [N, rows] on `device`, lane padding
    dropped."""
    return _to_torch(np.asarray(a)[:, :n_out].T, device)


def _q4k_elements(codes: np.ndarray, n_out: int) -> np.ndarray:
    """The reference's paired codes u8 [K/2, N_pad] (rows (j, j+128) of each
    256-row superblock in one byte) → element-order codes [N, K]."""
    K = codes.shape[0] * 2
    ct = codes.reshape(K // 256, 128, -1)
    return np.concatenate([ct & 0x0F, ct >> 4], axis=1).reshape(K, -1)[:, :n_out].T


def _q4k_blocks_from_jax(w) -> np.ndarray:
    """The reference's native-layout arrays (paired codes, ddm i32 [K/256,
    N_pad], scmn i32 [3K/256, N_pad]) → the GGUF superblock bytes [N, K/256 ·
    144] they were cut from."""
    q = _q4k_elements(np.asarray(w.codes), w.n_out)              # [N, K]
    N, K = q.shape
    nsb = K // 256
    blk = np.empty((N, nsb, 144), np.uint8)
    ddm = np.ascontiguousarray(np.asarray(w.ddm)[:, :N].T)        # [N, nsb] i32
    blk[:, :, 0:4] = ddm.view(np.uint8).reshape(N, nsb, 4)
    scmn = np.asarray(w.scmn)[:, :N].reshape(nsb, 3, N).transpose(2, 0, 1)
    blk[:, :, 4:16] = np.ascontiguousarray(scmn).view(np.uint8).reshape(N, nsb, 12)
    ch = q.reshape(N, nsb, 4, 2, 32)                               # chunk, low | high
    blk[:, :, 16:] = (ch[:, :, :, 0] | (ch[:, :, :, 1] << 4)).reshape(N, nsb, 128)
    return blk.reshape(N, -1)


def _weight_from_jax(w, device, n_vocab: int | None = None):
    """One matmul weight of the JAX tree (a packed class with numpy leaves,
    or a dense array) → the port's class and layout. Classes are told apart
    by name: the port imports nothing of the JAX package."""
    kind = type(w).__name__
    if kind in ("QuantTensor", "QuantTensorA8S"):
        pack = qm.pack_a8s if kind == "QuantTensorA8S" else qm.pack_exact
        return pack(_to_torch(_q4k_elements(np.asarray(w.codes), w.n_out), device),
                    _cols(w.scales, w.n_out, device).float(),
                    _cols(w.mins, w.n_out, device).float())
    if kind in ("QuantTensorK4", "QuantTensorA8K4"):
        cls = qm.QuantTensorA8K4 if kind == "QuantTensorA8K4" else qm.QuantTensorK4
        return cls(_to_torch(_q4k_blocks_from_jax(w), device))
    if kind == "QuantTensorQ8":
        return qm.QuantTensorQ8(_cols(w.codes, w.n_out, device),
                                _cols(w.scales, w.n_out, device), w.group)
    if kind == "QuantTensorA8":
        return qm.QuantTensorA8(_cols(w.codes, w.n_out, device),
                                _cols(w.scales, w.n_out, device),
                                _cols(w.mins, w.n_out, device))
    dense = _to_torch(w, device)              # (n_in, n_out) bf16
    # the reference pads a dense lm head's vocabulary to a multiple of 128
    return dense if n_vocab is None else dense[:, :n_vocab].contiguous()


def params_from_jax(tree: dict, device="cuda") -> dict[str, Any]:
    """Carry a packed engine's parameter tree of the JAX package (leaves as
    numpy arrays: QuantTensor, QuantTensorA8S, QuantTensorK4, QuantTensorA8K4,
    QuantTensorQ8 or QuantTensorA8 weights, dense bf16 leaves such as phi3's
    split parts and qwen2's bq / bk / bv biases, a packed or dense
    embedding, the f32 norms) over to the port's layouts."""
    device = resolve_device(device)
    emb = tree["tok_emb"]
    if type(emb).__name__ == "QuantEmbedding":
        tok_emb = QuantEmbedding(_to_torch(emb.codes, device),
                                 _to_torch(emb.scales, device).float(),
                                 _to_torch(emb.mins, device).float())
    else:
        tok_emb = _to_torch(emb, device)
    layers = []
    for p in tree["layers"]:   # the fused layouts' wqkv / wkv / wgu as they come
        layers.append({k: _to_torch(v, device).float() if k.endswith("_norm")
                       else _weight_from_jax(v, device) for k, v in p.items()})
    out = {"tok_emb": tok_emb, "out_norm": _to_torch(tree["out_norm"], device).float(),
           "layers": layers,
           "output": _weight_from_jax(tree["output"], device, tok_emb.shape[0])}
    if "rope_freqs" in tree:
        out["rope_freqs"] = _to_torch(tree["rope_freqs"], device).float()
    return out


def _opt(a, device):
    return None if a is None else _to_torch(a, device)


def cache_from_jax(arrays: dict, device="cuda") -> kvc.KVCache:
    """Carry a JAX KVCache (numpy arrays k, v, positions and, in INT8 mode,
    k_scale, v_scale; float caches as ml_dtypes bf16 or f32) over to the
    port's dense store."""
    device = resolve_device(device)
    return kvc.KVCache(_to_torch(arrays["k"], device), _to_torch(arrays["v"], device),
                       _to_torch(arrays["positions"], device),
                       _opt(arrays.get("k_scale"), device),
                       _opt(arrays.get("v_scale"), device))


def paged_cache_from_jax(arrays: dict, device="cuda") -> pkv.PagedKVCache:
    """Carry a JAX PagedKVCache (numpy arrays k, v [L, P, G, Hkv, D],
    positions [P, G], page_table [B, MP] and optional k_scale, v_scale) over
    to the port's pool, so both packages start a step from the same pool,
    positions and page table."""
    device = resolve_device(device)
    k = _to_torch(arrays["k"], device)
    L, P, G, Hkv, D = k.shape
    table = np.asarray(arrays["page_table"])
    cache = pkv.PagedKVCache.create(L, table.shape[0], P, G, table.shape[1], Hkv, D,
                                    k.dtype, device=device)
    cache.k.copy_(k)
    cache.v.copy_(_to_torch(arrays["v"], device))
    cache.positions.copy_(_to_torch(arrays["positions"], device))
    if arrays.get("k_scale") is not None:
        cache.k_scale.copy_(_to_torch(arrays["k_scale"], device))
        cache.v_scale.copy_(_to_torch(arrays["v_scale"], device))
    return cache.with_table(table)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LlamaStatic:
    """Static subset of ModelConfig the forward reads."""

    n_head: int
    n_head_kv: int
    head_dim: int
    rope_dim: int
    freq_base: float
    rms_eps: float
    act_fn: str
    causal: bool
    # gemma: the embedded input times sqrt(E) (rounded to the activation
    # dtype first), and every norm's weight applied as (1 + w), the sum
    # rounded to bf16 under the dense bfloat16 engine (norm_bf16)
    emb_scale: float = 1.0
    norm_plus_one: bool = False
    norm_bf16: bool = False
    rope_scale: float = 1.0   # 1/factor for linear/yarn rope scaling
    # fixed-topology blocks (tp_blocks mode, ops/quant_matmul qmm_blocked /
    # qmm_nblocked): the logits of a prover sharded over tp | tp_blocks
    # devices; 0 = the plain products
    tp_blocks: int = 0
    # YaRN NTK-by-parts (None unless rope.scaling.type == "yarn"):
    # (ext_factor, attn_factor, beta_fast, beta_slow, orig_ctx)
    yarn: tuple | None = None
    # the reference's decode-attention modes (its models/llama.py:323-337),
    # set by the loops (ops/generate_loop._mode_for) for dense rows only:
    # attn_write: kernel P quantizes and stores the token's K/V row and
    # attends in one launch, in place of the cache write and kernel C;
    # attn_fresh (INT8 KV): kernel N attends with the fresh row as an
    # operand, before the cache write; attn_scales_t: the reference's
    # transposed scale carry (a TPU layout the port has no need of), which
    # here only keeps the head-batched kernel O off, as it does there
    attn_write: bool = False
    attn_scales_t: bool = False
    attn_fresh: bool = False
    # the attention mode (ModelParams.attn): True, attn="fused", the fused
    # kernels where their gates admit the chunk; False, attn="xla" (the
    # reference's default), the two-pass chain at every chunk
    attn_fused: bool = True

    @classmethod
    def of(cls, cfg: ModelConfig) -> "LlamaStatic":
        rope_scale = 1.0
        yarn = None
        if cfg.rope_scaling_type in ("linear", "yarn") and cfg.rope_scale_factor:
            rope_scale = 1.0 / cfg.rope_scale_factor
        if cfg.rope_scaling_type == "yarn":
            yarn = (1.0, cfg.rope_attn_factor, 32.0, 1.0,
                    cfg.rope_orig_ctx or cfg.n_ctx_train)
        return cls(cfg.n_head, cfg.n_head_kv, cfg.head_dim_, cfg.rope_dim_,
                   cfg.rope_freq_base, cfg.rms_norm_eps, cfg.act_fn, cfg.causal,
                   cfg.emb_scale, cfg.norm_plus_one, cfg.norm_bf16, rope_scale,
                   tp_blocks=cfg.tp_blocks, yarn=yarn, attn_fused=cfg.attn_fused)

    def step(self, params, tokens, positions, slots, cache, logits_index=None):
        """forward under this config (every loop calls its static's step)."""
        return forward(params, self, tokens, positions, slots, cache, logits_index)


@functools.lru_cache(maxsize=16)
def _inv_freq_on(rope_dim, head_dim, freq_base, scale, yarn, device, freq_factors=None):
    """The kernels' per-lane inverse frequencies on `device`, made once per
    model (keyed by the `rope_freqs` tensor itself where the file has one):
    a step makes no host copy, so it can be captured in a graph."""
    inv, mscale = dattn.effective_inv_freq(rope_dim, head_dim, freq_base, scale,
                                           yarn=yarn, freq_factors=freq_factors)
    return inv.to(device), mscale


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)   # x·sigmoid(x) in x's dtype, as jax.nn.silu


@functools.lru_cache(maxsize=64)
def rounded_to(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (f32 or bf16, to nearest even), as a
    Python float: a constant a step can fold in without making a tensor
    (no host work inside a captured graph)."""
    bits = int(np.float32(value).view(np.uint32))
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    elif dtype != torch.float32:
        raise ValueError(f"no rounding to {dtype}")
    return float(np.uint32(bits).view(np.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU in x's dtype, op by op as
    jax.nn.gelu(approximate=False): 0.5·x·erfc(-x·√½), √½ rounded to x's
    dtype and each product rounded there."""
    return 0.5 * x * torch.special.erfc(-x * rounded_to(0.5 ** 0.5, x.dtype))


ACTS = {"silu": _silu, "gelu": gelu}


def _norm_weight(w: torch.Tensor, plus_one: bool, bf16: bool = False) -> torch.Tensor:
    """A norm's weight (f32, rounded through the engine's dtype at load) as
    the reference applies it: gemma's (1 + w), the sum rounded to bf16 where
    the reference stores the weight in bf16 (the dense bfloat16 engine:
    `bf16`), else kept in f32 (float32 and the packed engines, whose norms
    the reference upcasts at load)."""
    if not plus_one:
        return w
    return (w + 1.0).to(torch.bfloat16).float() if bf16 else w + 1.0


def scale_input(x: torch.Tensor, emb_scale: float) -> torch.Tensor:
    """Gemma's input scaling: x times the scale rounded to x's dtype first
    (the reference's jnp.asarray(emb_scale, x.dtype): √3072 is 55.5 in
    bf16), one rounding of the product."""
    if emb_scale == 1.0:
        return x
    return x * rounded_to(emb_scale, x.dtype)


def _dense_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits through a dense lm head [E, V]: operands in the weight's
    dtype, products and sums in f32, as the reference's dot with
    preferred_element_type=float32 (quant_matmul.rows_mm: no upcast copy
    of the head, each row's bits its own)."""
    return rows_mm(h.to(w.dtype), w, out_dtype=torch.float32)


def _place(params, tokens, positions, slots, cache):
    """The forward's prologue: the tokens embedded ([B, T, E] in the
    activation dtype: a dense table's own, bf16 for a packed one) and each
    token's position written to its store slot (pads to the spare slot).
    Returns (x, positions int32 on the store's device, flat slots [B*T])."""
    dev = cache.device
    positions = positions.to(dev, torch.int32)
    flat = cache.flat_slots(slots.to(dev).long())
    cache.pos_store[flat] = positions.reshape(-1)
    return emb_lookup(params["tok_emb"], tokens.to(dev).long()), positions, flat


def _head(params, x, logits_index, eps, tpb=0, all_positions=False, plus_one=(False, False),
          return_hidden=False):
    """The forward's epilogue: each row's logit token (the last when
    logits_index is None; every position with `all_positions`), the final
    norm ((1 + w) as _norm_weight's `plus_one`, `bf16` say) and the lm head
    → [B, V] (or [B, T, V]) f32; with `return_hidden` the normed rows
    themselves, the lm head's input (the reference's return_hidden). A
    packed head takes f32 rows (pinned under tp_blocks); a dense one
    operands in its dtype and f32 sums, in tpb column blocks under
    tp_blocks."""
    B, T = x.shape[:2]
    w = _norm_weight(params["out_norm"], *plus_one)
    if all_positions:
        last_h = rms_norm(x, w, eps)                                      # [B, T, E]
        if return_hidden:
            return last_h
        return _head_product(params["output"], last_h.reshape(B * T, -1), tpb).reshape(B, T, -1)
    if logits_index is None:
        logits_index = torch.full((B,), T - 1, dtype=torch.long, device=x.device)
    last_h = x[torch.arange(B, device=x.device), logits_index.to(x.device).long()]
    last_h = rms_norm(last_h, w, eps)                                     # [B, E]
    if return_hidden:
        return last_h
    return _head_product(params["output"], last_h, tpb)


def _head_product(out, last_h: torch.Tensor, tpb: int) -> torch.Tensor:
    if not isinstance(out, torch.Tensor):
        return qmm_nblocked(last_h.float(), out, tpb)
    if tpb:
        return qmm_nblocked(last_h.to(out.dtype), out, tpb, out_dtype=torch.float32)
    return _dense_head(last_h, out)


@torch.no_grad()
def forward(
    params: dict[str, Any],
    cfg: ModelConfig | LlamaStatic,
    tokens: torch.Tensor,      # [B, T] int32 (padded)
    positions: torch.Tensor,   # [B, T] int32 position of each token
    slots: torch.Tensor,       # [B, T] int32 cache slot; >= n_slots → dropped (pad)
    cache: SlotStore,
    logits_index: torch.Tensor | None = None,  # [B] index into T of the logit token
    all_positions: bool = False,  # logits for every position (perplexity path)
    return_hidden: bool = False,  # the final normed hidden state, not the logits
) -> tuple[torch.Tensor, SlotStore]:
    """One decode/prefill step. Returns (logits [B, V] f32, or [B, T, V]
    with `all_positions`; with `return_hidden` the final normed hidden
    state [B, E] (or [B, T, E]) in the activation dtype, the lm head's
    input; cache); the cache
    (dense KVCache rows, or the scheduler's PagedKVCache pool, where `slots`
    are FLAT pool indices and reads go through the row's page table) is
    updated in place. A pad token (slot >= n_slots) writes to the store's
    spare slot, which nothing reads, so a row may be all pads.

    Deterministic: fixed kernel shapes and reduction orders, sequential slot
    writes — replaying the same token stream gives bit-identical logits."""
    st = cfg if isinstance(cfg, LlamaStatic) else LlamaStatic.of(cfg)
    H, Hkv, D = st.n_head, st.n_head_kv, st.head_dim
    rope_dim, freq_base = st.rope_dim, st.freq_base
    act = ACTS[st.act_fn]
    B, T = tokens.shape
    dev = cache.device
    paged = isinstance(cache, pkv.PagedKVCache)
    x, positions, flat = _place(params, tokens, positions, slots, cache)
    x = scale_input(x, st.emb_scale)
    new_positions = cache.positions
    kv_dtype = cache.k_store.dtype

    eps = st.rms_eps
    rs, yarn = st.rope_scale, st.yarn
    ff = params.get("rope_freqs")
    q_rope = rope_angles(positions, rope_dim, freq_base, rs, yarn=yarn,
                         freq_factors=ff)
    # the reference's routes (its attn="fused" mode): kernel C/E at T == 1,
    # kernel D/F for T % 8 == 0 chunks, the two-pass chain for the rest
    # (T in {2, 4} buckets) and for geometries the gates refuse
    fused_ok = st.attn_fused and st.causal and not (yarn is not None and rope_dim < D)
    if paged:
        G = cache.page_size
        use_fused_attn = fused_ok and T == 1 and pattn.supports(G, D, kv_dtype)
        use_fused_prefill = fused_ok and pattn.prefill_supports(T, G, D, kv_dtype)
    else:
        S = cache.n_slots
        use_fused_attn = fused_ok and T == 1 and dattn.supports(S, D, kv_dtype, B)
        use_fused_prefill = fused_ok and dattn.prefill_supports(T, S, D, kv_dtype, B)
    # the loops' modes (reference forward :477-482, layer_fn_stacked)
    use_write = (use_fused_attn and not paged and st.attn_write
                 and dattn.write_supports(S, D, kv_dtype, B))
    use_fresh = use_fused_attn and not paged and st.attn_fresh and cache.quantized
    row_slot = slots.to(dev, torch.int32)[:, 0] if use_write or use_fresh else None
    if use_fused_attn or use_fused_prefill:
        inv_freq_e, mscale = _inv_freq_on(rope_dim, D, freq_base, rs, yarn, dev, ff)
        kv_rope = pos_view = None
    else:
        pos_view = pkv.view_positions(cache) if paged else new_positions
        kv_rope = rope_angles(torch.clamp(pos_view, min=0), rope_dim,
                              freq_base, rs, yarn=yarn, freq_factors=ff)

    tpb = st.tp_blocks
    npo = (st.norm_plus_one, st.norm_bf16)
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, _norm_weight(p["attn_norm"], *npo), eps)
        if "wqkv" in p:
            # the fused layout (BLAMA_FUSE_PROJ): one wide product, split
            # after; each column's bits are its part's
            q, k, v = (t.contiguous() for t in torch.split(
                qmm_nblocked(h, p["wqkv"], tpb), [H * D, Hkv * D, Hkv * D], dim=-1))
        elif "wkv" in p:
            # k and v fused only (BLAMA_FUSE_KV)
            q = qmm_nblocked(h, p["wq"], tpb)
            k, v = (t.contiguous() for t in qmm_nblocked(h, p["wkv"], tpb).chunk(2, dim=-1))
        else:
            q = qmm_nblocked(h, p["wq"], tpb)
            k = qmm_nblocked(h, p["wk"], tpb)
            v = qmm_nblocked(h, p["wv"], tpb)
        if "bq" in p:
            # qwen2's biases: one point of the step, after every layout's
            # products (and their split), whatever the rows or the graph
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
        q = apply_rope(q, positions, rope_dim, freq_base, True, cos_sin=q_rope)

        k_l, v_l = cache.k[li], cache.v[li]     # [B, S, Hkv, D] or [P, G, Hkv, D]
        ks_l = vs_l = None
        if cache.quantized:
            ks_l, vs_l = cache.k_scale[li], cache.v_scale[li]
        if use_write:
            # kernel P: the token's K/V row stored and attended in one launch
            attn = dattn.decode_attention_write(
                q, cache.k_store[li], cache.v_store[li], positions[:, 0], new_positions,
                inv_freq_e, k.reshape(B, Hkv, D), v.reshape(B, Hkv, D), row_slot,
                k_scale=cache.k_scale_store[li] if cache.quantized else None,
                v_scale=cache.v_scale_store[li] if cache.quantized else None,
                mscale=mscale)
        elif use_fresh:
            # kernel N takes the fresh row as an operand, before the write:
            # nothing in the step reads the stored row
            attn = dattn.decode_attention(
                q, k_l, v_l, positions[:, 0], new_positions, inv_freq_e, k_scale=ks_l,
                v_scale=vs_l, mscale=mscale, scales_t=st.attn_scales_t,
                k_new=k.reshape(B, Hkv, D), v_new=v.reshape(B, Hkv, D), slot=row_slot)
            cache.write(li, flat, k, v)
        else:
            # write unrotated K and V into their store slots, in place
            cache.write(li, flat, k, v)
            if use_fused_attn or use_fused_prefill:
                q_pos = positions[:, 0] if use_fused_attn else positions
                if paged:
                    fn = (pattn.paged_decode_attention if use_fused_attn
                          else pattn.paged_prefill_attention)
                    attn = fn(q, k_l, v_l, new_positions, cache.page_table, q_pos,
                              inv_freq_e, k_scale=ks_l, v_scale=vs_l, mscale=mscale)
                elif use_fused_attn:
                    attn = dattn.decode_attention(q, k_l, v_l, q_pos, new_positions,
                                                  inv_freq_e, k_scale=ks_l, v_scale=vs_l,
                                                  mscale=mscale, scales_t=st.attn_scales_t)
                else:
                    attn = dattn.prefill_attention(q, k_l, v_l, q_pos, new_positions,
                                                   inv_freq_e, k_scale=ks_l, v_scale=vs_l,
                                                   mscale=mscale)
            else:
                if paged:
                    # gather the logical row view (element-identical to a dense
                    # row, ops/paged_kv.py) and run the dense chain
                    k_l, v_l, ks_l, vs_l = pkv.gather_view(cache, k_l, v_l, ks_l, vs_l)
                if ks_l is not None:
                    k_l = dequantize_kv(k_l, ks_l, x.dtype)
                    v_l = dequantize_kv(v_l, vs_l, x.dtype)
                attn = attention(q, k_l, v_l, positions, pos_view,
                                 rope_dim=rope_dim, freq_base=freq_base,
                                 interleaved=True, causal=st.causal, kv_rope=kv_rope)
        x = x + qmm_blocked(attn.reshape(B, T, H * D), p["wo"], tpb)

        h2 = rms_norm(x, _norm_weight(p["ffn_norm"], *npo), eps)
        if "wgu" in p:
            gate, up = qmm_nblocked(h2, p["wgu"], tpb).chunk(2, dim=-1)
            x = x + qmm_blocked(act(gate) * up, p["w_down"], tpb)
        else:
            gate = act(qmm_nblocked(h2, p["w_gate"], tpb))
            x = x + qmm_blocked(gate * qmm_nblocked(h2, p["w_up"], tpb), p["w_down"], tpb)
        if "cvec" in p:
            # a control vector's bias after the layer's residual (the
            # reference's site; Instance.apply_control_vector)
            x = x + p["cvec"]

    return _head(params, x, logits_index, eps, tpb, all_positions, npo, return_hidden), cache


def all_logits(st: LlamaStatic, params, tokens, positions, slots, cache) -> torch.Tensor:
    """Logits at every position, [B, T, V] f32 (the perplexity path; the
    reference's all_logits). The cache is updated in place, as by a step."""
    return forward(params, st, tokens, positions, slots, cache, all_positions=True)[0]


def last_hidden(st: LlamaStatic, params, tokens, positions, slots, cache,
                logits_index) -> torch.Tensor:
    """The final normed hidden state [B, E] at logits_index, in the
    activation dtype (the embeddings path of a decoder-only model,
    InstanceEmbedding.cpp:129-157; the reference's last_hidden). The cache
    is updated in place, as by a step."""
    return forward(params, st, tokens, positions, slots, cache, logits_index,
                   return_hidden=True)[0]


def make_step_fn(cfg: ModelConfig):
    """Step function bound to the architecture's static config."""
    return LlamaStatic.of(cfg).step
