"""Llama-family transformer: GGUF weight loading and the forward pass.

Counterpart of blama_tpu/models/llama.py for the slice the port serves: the
`q4k_a8` engine (packed Q4_K weights, W4A8 matmuls for up to 16 rows, exact
dequant matmuls above), unfused q/k/v and gate/up projections, dense (not
paged) KV rows, INT8 KV and fused attention (the two-pass chain serves the
chunks the fused gates refuse, T in {2, 4}, as in the reference).

Weights are a plain dict: {"tok_emb", "out_norm", "output", "layers": [one
dict per layer], optional "rope_freqs"}. The forward keeps the reference's
arithmetic order wherever the logits depend on it: the residual stream in
bf16, rms_norm in f32 with f32 (bf16-rounded) weights, every matmul
accumulated in f32 and cast to the activation dtype, the lm head fed f32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops import decode_attention as dattn
from ..ops.attention import attention
from ..ops.kernels import resolve_device
from ..ops.kv_cache import KVCache, dequantize_kv, quantize_kv
from ..ops.norms import rms_norm
from ..ops.quant_matmul import (
    QuantEmbedding, QuantTensorA8S, emb_lookup, pack_a8s, qmm, repack_q4k_a8s,
    repack_q4k_embedding,
)
from ..ops.rope import apply_rope, rope_angles
from .config import ModelConfig

# llama-family architectures whose GGUFs the dense forward below serves
ARCHS = ("llama", "mistral")

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

def load_llama_params(reader, cfg: ModelConfig, fused_quant="a8",
                      device="cuda", progress_cb=None) -> dict[str, Any]:
    """Load llama-family weights for the `q4k_a8` engine onto `device`.

    Every Q4_K matmul weight is repacked on the device and uploaded as soon
    as it is read, so host memory holds one tensor's GGUF bytes at a time.
    """
    from ..gguf.constants import GGMLType

    device = resolve_device(device)
    if fused_quant != "a8":
        raise NotImplementedError(
            f"fused_quant={fused_quant!r}: only the q4k_a8 engine is ported "
            "(ROADMAP.md §1 item 9, other engines)")
    if cfg.n_layer and ("blk.0.attn_qkv.weight" in reader.tensors
                        or "blk.0.ffn_gate.weight" not in reader.tensors
                        or "blk.0.attn_q.bias" in reader.tensors):
        raise NotImplementedError(
            "fused qkv / gate-up tensors (phi3) and q/k/v biases (qwen2) are "
            "not ported (ROADMAP.md §1 item 12, other families)")

    def get_t(name: str) -> QuantTensorA8S:
        info = reader.tensors[name]
        if info.ggml_type != GGMLType.Q4_K:
            raise NotImplementedError(
                f"{name}: {info.ggml_type!r} matmul weights need another engine "
                "(ROADMAP.md §1 item 9, other engines)")
        return repack_q4k_a8s(reader.tensor_bytes(name), info.ne[1], info.ne[0],
                              device)

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
    if emb_info.ggml_type != GGMLType.Q4_K:
        raise NotImplementedError(
            f"token_embd.weight: {emb_info.ggml_type!r} embeddings need another "
            "engine (ROADMAP.md §1 item 9, other engines)")
    tok_emb = repack_q4k_embedding(reader.tensor_bytes("token_embd.weight"),
                                   emb_info.ne[1], emb_info.ne[0], device)
    params = {
        "tok_emb": tok_emb,
        "out_norm": _bf16_rounded(get_v("output_norm.weight"), device),
        "layers": layers,
        # tied embeddings read the token_embd bytes through the matmul repack
        "output": get_t("output.weight" if "output.weight" in reader.tensors
                        else "token_embd.weight"),
    }
    if "rope_freqs.weight" in reader.tensors:
        params["rope_freqs"] = _bf16_rounded(get_v("rope_freqs.weight"), device)
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from the JAX tree
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _a8s_from_jax(w, device) -> QuantTensorA8S:
    """The reference's QuantTensorA8S (codes u8 [K/2, N_pad], rows (j, j+128)
    of each 256-row superblock paired in one byte; bf16 scales/mins
    [K/32, N_pad]) → the port's layout."""
    codes = np.asarray(w.codes)
    K = codes.shape[0] * 2
    ct = codes.reshape(K // 256, 128, -1)
    full = np.concatenate([ct & 0x0F, ct >> 4], axis=1).reshape(K, -1)[:, :w.n_out]
    return pack_a8s(_to_torch(full.T, device),
                    _to_torch(np.asarray(w.scales)[:, :w.n_out].T, device),
                    _to_torch(np.asarray(w.mins)[:, :w.n_out].T, device))


def params_from_jax(tree: dict, device="cuda") -> dict[str, Any]:
    """Carry the JAX package's `q4k_a8` parameter tree (leaves as numpy
    arrays: each QuantTensorA8S's codes/scales/mins/n_out, the
    QuantEmbedding arrays, the f32 norms) over to the port's layout."""
    device = resolve_device(device)
    emb = tree["tok_emb"]
    tok_emb = QuantEmbedding(_to_torch(emb.codes, device),
                             _to_torch(emb.scales, device).float(),
                             _to_torch(emb.mins, device).float())
    layers = []
    for p in tree["layers"]:
        layers.append({k: _to_torch(p[k], device).float() if k.endswith("_norm")
                       else _a8s_from_jax(p[k], device) for k in _LAYER_TENSORS})
    out = {"tok_emb": tok_emb, "out_norm": _to_torch(tree["out_norm"], device).float(),
           "layers": layers, "output": _a8s_from_jax(tree["output"], device)}
    if "rope_freqs" in tree:
        out["rope_freqs"] = _to_torch(tree["rope_freqs"], device).float()
    return out


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
    # YaRN NTK-by-parts (None unless rope.scaling.type == "yarn"):
    # (ext_factor, attn_factor, beta_fast, beta_slow, orig_ctx)
    yarn: tuple | None = None

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
                   rope_scale, yarn=yarn)


@functools.lru_cache(maxsize=16)
def _inv_freq_on(rope_dim, head_dim, freq_base, scale, yarn, device):
    inv, mscale = dattn.effective_inv_freq(rope_dim, head_dim, freq_base, scale,
                                           yarn=yarn)
    return inv.to(device), mscale


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)   # x·sigmoid(x) in x's dtype, as jax.nn.silu


@torch.no_grad()
def forward(
    params: dict[str, Any],
    cfg: ModelConfig | LlamaStatic,
    tokens: torch.Tensor,      # [B, T] int32 (padded)
    positions: torch.Tensor,   # [B, T] int32 position of each token
    slots: torch.Tensor,       # [B, T] int32 cache slot; >= n_slots → dropped (pad)
    cache: KVCache,
    logits_index: torch.Tensor | None = None,  # [B] index into T of the logit token
) -> tuple[torch.Tensor, KVCache]:
    """One decode/prefill step. Returns (logits [B, V] f32, cache); the cache
    is updated in place. Pad tokens (slot >= n_slots) must follow the real
    ones of their row, and every row's first token must be real.

    Deterministic: fixed kernel shapes and reduction orders, sequential slot
    writes — replaying the same token stream gives bit-identical logits."""
    st = cfg if isinstance(cfg, LlamaStatic) else LlamaStatic.of(cfg)
    H, Hkv, D = st.n_head, st.n_head_kv, st.head_dim
    rope_dim, freq_base = st.rope_dim, st.freq_base
    if st.act_fn != "silu":
        raise NotImplementedError(f"act_fn={st.act_fn!r} (ROADMAP.md §1 item 12)")
    if not cache.quantized:
        raise NotImplementedError(
            "float KV caches are not ported (ROADMAP.md §1 item 9, other engines)")
    B, T = tokens.shape
    S = cache.n_slots
    dev = cache.k.device
    tokens = tokens.to(dev).long()
    positions = positions.to(dev, torch.int32)
    slots = slots.to(dev).long()

    x = emb_lookup(params["tok_emb"], tokens)                    # [B, T, E] bf16

    # pad tokens write nothing: redirect each pad to its row's first token,
    # rewriting that token's own values (duplicate index_put of equal values
    # is order-free, and no host sync is needed to find the pads)
    valid = slots < S
    w_slots = torch.where(valid, slots, slots[:, :1])
    w_rows = torch.arange(B, device=dev)[:, None].expand(B, T)

    def pick(a):
        shp = (B, T) + (1,) * (a.dim() - 2)
        return torch.where(valid.reshape(shp), a, a[:, :1])

    cache.positions[w_rows, w_slots] = pick(positions)
    new_positions = cache.positions

    eps = st.rms_eps
    rs, yarn = st.rope_scale, st.yarn
    ff = params.get("rope_freqs")
    q_rope = rope_angles(positions, rope_dim, freq_base, rs, yarn=yarn,
                         freq_factors=ff)
    if not st.causal or (yarn is not None and rope_dim < D) \
            or not dattn.supports(S, D, cache.k.dtype, B):
        raise NotImplementedError(
            "the fused attention kernels do not serve this model or cache "
            f"geometry (causal={st.causal}, rope_dim={rope_dim}, head_dim={D}, "
            f"slots={S}); the two-pass mode is not ported (ROADMAP.md §1 item 9)")
    # the reference's routes: kernel C at T == 1, kernel D for T % 8 == 0
    # chunks, the two-pass chain for the rest (T in {2, 4} buckets)
    use_fused_attn = T == 1
    use_fused_prefill = dattn.prefill_supports(T, S, D, cache.k.dtype, B)
    if use_fused_attn or use_fused_prefill:
        if ff is None:
            inv_freq_e, mscale = _inv_freq_on(rope_dim, D, freq_base, rs, yarn, dev)
        else:
            inv_freq_e, mscale = dattn.effective_inv_freq(
                rope_dim, D, freq_base, rs, yarn=yarn, freq_factors=ff)
            inv_freq_e = inv_freq_e.to(dev)
        kv_rope = None
    else:
        kv_rope = rope_angles(torch.clamp(new_positions, min=0), rope_dim,
                              freq_base, rs, yarn=yarn, freq_factors=ff)

    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["attn_norm"], eps)
        q = qmm(h, p["wq"])
        k = qmm(h, p["wk"])
        v = qmm(h, p["wv"])
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
        q = apply_rope(q, positions, rope_dim, freq_base, True, cos_sin=q_rope)

        # write unrotated K and V into their cache slots
        k_l, v_l = cache.k[li], cache.v[li]                       # [B, S, Hkv, D]
        ks_l, vs_l = cache.k_scale[li], cache.v_scale[li]         # [B, S, Hkv]
        k_codes, k_sc = quantize_kv(k)
        v_codes, v_sc = quantize_kv(v)
        k_l[w_rows, w_slots] = pick(k_codes)
        v_l[w_rows, w_slots] = pick(v_codes)
        ks_l[w_rows, w_slots] = pick(k_sc)
        vs_l[w_rows, w_slots] = pick(v_sc)

        if use_fused_attn:
            attn = dattn.decode_attention(
                q, k_l, v_l, positions[:, 0], new_positions, inv_freq_e,
                k_scale=ks_l, v_scale=vs_l, mscale=mscale)
        elif use_fused_prefill:
            attn = dattn.prefill_attention(
                q, k_l, v_l, positions, new_positions, inv_freq_e,
                k_scale=ks_l, v_scale=vs_l, mscale=mscale)
        else:
            k_use = dequantize_kv(k_l, ks_l, x.dtype)
            v_use = dequantize_kv(v_l, vs_l, x.dtype)
            attn = attention(q, k_use, v_use, positions, new_positions,
                             rope_dim=rope_dim, freq_base=freq_base,
                             interleaved=True, causal=st.causal, kv_rope=kv_rope)
        x = x + qmm(attn.reshape(B, T, H * D), p["wo"])

        h2 = rms_norm(x, p["ffn_norm"], eps)
        gate = _silu(qmm(h2, p["w_gate"]))
        x = x + qmm(gate * qmm(h2, p["w_up"]), p["w_down"])

    if logits_index is None:
        logits_index = torch.full((B,), T - 1, dtype=torch.long, device=dev)
    last_h = x[torch.arange(B, device=dev), logits_index.to(dev).long()]   # [B, E]
    last_h = rms_norm(last_h, params["out_norm"], eps)
    return qmm(last_h.float(), params["output"]), cache


def make_step_fn(cfg: ModelConfig):
    """Step function bound to the architecture's static config."""
    st = LlamaStatic.of(cfg)

    def step(params, tokens, positions, slots, cache, logits_index):
        return forward(params, st, tokens, positions, slots, cache, logits_index)

    return step
