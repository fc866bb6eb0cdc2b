"""Llama-family transformer: GGUF weight loading and the forward pass.

Counterpart of blama_tpu/models/llama.py for the slice the port serves: the
dense engines (`fused_quant=False`: every tensor dequantized to float32 or
bfloat16, the reference's defaults) and the packed weight engines
(`fused_quant` True, "k4", "a8", "a8k4", "a8x": Q4_K tensors packed as the
engine says, Q8_0 and Q6_K tensors packed for the exact int8-code kernel
under every engine, anything else a dense bf16 weight), unfused q/k/v and
gate/up projections, dense KV rows or the scheduler's paged pool, INT8,
bf16 or f32 KV, and either attention mode: fused (LlamaStatic.attn_fused;
the two-pass chain still serves the chunks and geometries the fused gates
refuse, T in {2, 4}, as in the reference) or the two-pass chain at every
chunk (attn="xla"), with the reference's opt-in decode-attention modes on
dense rows (LlamaStatic.attn_write / attn_fresh, set by ops/generate_loop).

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

# llama-family architectures whose GGUFs the dense forward below serves
ARCHS = ("llama", "mistral", "mixtral")

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


def load_dense_params(reader, cfg: ModelConfig, dtype: torch.dtype,
                      device="cuda", progress_cb=None) -> dict[str, Any]:
    """The reference's load_llama_params with fused_quant=False: every
    tensor `reader.tensor_float(...)` converted to `dtype` (float32 or
    bfloat16), matmul weights transposed to (n_in, n_out), the norms (and
    rope_freqs) kept as f32 of their `dtype`-rounded values, a tied head the
    embedding's transpose. Each tensor is dequantized on `device`
    (tensor_values) and converted as soon as it is read."""
    device = resolve_device(device)

    def get_t(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(dtype).t().contiguous()

    def get_v(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(dtype).float()

    n_total = cfg.n_layer + 2
    layers = []
    for i in range(cfg.n_layer):
        layers.append({key: get_v(pat.format(i=i)) if key.endswith("_norm")
                       else get_t(pat.format(i=i)) for key, pat in _LAYER_TENSORS.items()})
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


def load_llama_params(reader, cfg: ModelConfig, fused_quant: bool | str = "a8",
                      device="cuda", progress_cb=None,
                      dtype: torch.dtype = torch.bfloat16) -> dict[str, Any]:
    """Load llama-family weights onto `device`.

    `fused_quant=False`: the dense engine of `dtype` (load_dense_params).
    Else per tensor, as in the reference: a Q8_0 or Q6_K tensor is packed
    for the exact int8-code kernel whatever the engine, a Q4_K tensor is
    packed as `fused_quant` says, any other type becomes a dense bf16
    (n_in, n_out) weight. Every tensor is repacked on the device and
    uploaded as soon as it is read, so host memory holds one tensor's GGUF
    bytes at a time.
    """
    from ..gguf.constants import GGMLType

    device = resolve_device(device)
    if cfg.n_layer and ("blk.0.attn_qkv.weight" in reader.tensors
                        or "blk.0.ffn_gate.weight" not in reader.tensors
                        or "blk.0.attn_q.bias" in reader.tensors):
        raise NotImplementedError(
            "fused qkv / gate-up tensors (phi3) and q/k/v biases (qwen2) are "
            "not ported (ROADMAP.md §1 item 12, other families)")
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

    n_total = cfg.n_layer + 2
    layers = []
    for i in range(cfg.n_layer):
        p = {}
        for key, pat in _LAYER_TENSORS.items():
            name = pat.format(i=i)
            if key in ("attn_norm", "ffn_norm"):
                p[key] = _bf16_rounded(get_v(name), device)
            else:
                p[key] = get_t(name)
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
    QuantTensorQ8 or QuantTensorA8 weights, dense bf16 leaves, a packed or
    dense embedding, the f32 norms) over to the port's layouts."""
    device = resolve_device(device)
    emb = tree["tok_emb"]
    if type(emb).__name__ == "QuantEmbedding":
        tok_emb = QuantEmbedding(_to_torch(emb.codes, device),
                                 _to_torch(emb.scales, device).float(),
                                 _to_torch(emb.mins, device).float())
    else:
        tok_emb = _to_torch(emb, device)
    layers = []
    for p in tree["layers"]:
        layers.append({k: _to_torch(p[k], device).float() if k.endswith("_norm")
                       else _weight_from_jax(p[k], device) for k in _LAYER_TENSORS})
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
    # the attention mode (ModelParams.attn): True, the fused kernels where
    # their gates admit the chunk (the port's default for a llama file);
    # False, the reference's attn="xla", the two-pass chain at every chunk
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
                   rope_scale, tp_blocks=cfg.tp_blocks, yarn=yarn,
                   attn_fused=cfg.attn_fused)

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


def _head(params, x, logits_index, eps, tpb=0, all_positions=False):
    """The forward's epilogue: each row's logit token (the last when
    logits_index is None; every position with `all_positions`), the final
    norm and the lm head → [B, V] (or [B, T, V]) f32. A packed head takes
    f32 rows (pinned under tp_blocks); a dense one operands in its dtype and
    f32 sums, in tpb column blocks under tp_blocks."""
    B, T = x.shape[:2]
    if all_positions:
        last_h = rms_norm(x, params["out_norm"], eps).reshape(B * T, -1)
        return _head_product(params["output"], last_h, tpb).reshape(B, T, -1)
    if logits_index is None:
        logits_index = torch.full((B,), T - 1, dtype=torch.long, device=x.device)
    last_h = x[torch.arange(B, device=x.device), logits_index.to(x.device).long()]
    last_h = rms_norm(last_h, params["out_norm"], eps)                    # [B, E]
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
) -> tuple[torch.Tensor, SlotStore]:
    """One decode/prefill step. Returns (logits [B, V] f32, or [B, T, V]
    with `all_positions`, cache); the cache
    (dense KVCache rows, or the scheduler's PagedKVCache pool, where `slots`
    are FLAT pool indices and reads go through the row's page table) is
    updated in place. A pad token (slot >= n_slots) writes to the store's
    spare slot, which nothing reads, so a row may be all pads.

    Deterministic: fixed kernel shapes and reduction orders, sequential slot
    writes — replaying the same token stream gives bit-identical logits."""
    st = cfg if isinstance(cfg, LlamaStatic) else LlamaStatic.of(cfg)
    H, Hkv, D = st.n_head, st.n_head_kv, st.head_dim
    rope_dim, freq_base = st.rope_dim, st.freq_base
    if st.act_fn != "silu":
        raise NotImplementedError(f"act_fn={st.act_fn!r} (ROADMAP.md §1 item 12)")
    B, T = tokens.shape
    dev = cache.device
    paged = isinstance(cache, pkv.PagedKVCache)
    x, positions, flat = _place(params, tokens, positions, slots, cache)
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
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["attn_norm"], eps)
        q = qmm_nblocked(h, p["wq"], tpb)
        k = qmm_nblocked(h, p["wk"], tpb)
        v = qmm_nblocked(h, p["wv"], tpb)
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

        h2 = rms_norm(x, p["ffn_norm"], eps)
        gate = _silu(qmm_nblocked(h2, p["w_gate"], tpb))
        x = x + qmm_blocked(gate * qmm_nblocked(h2, p["w_up"], tpb), p["w_down"], tpb)

    return _head(params, x, logits_index, eps, tpb, all_positions), cache


def all_logits(st: LlamaStatic, params, tokens, positions, slots, cache) -> torch.Tensor:
    """Logits at every position, [B, T, V] f32 (the perplexity path; the
    reference's all_logits). The cache is updated in place, as by a step."""
    return forward(params, st, tokens, positions, slots, cache, all_positions=True)[0]


def make_step_fn(cfg: ModelConfig):
    """Step function bound to the architecture's static config."""
    return LlamaStatic.of(cfg).step
