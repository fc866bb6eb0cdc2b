"""GPT-2: GGUF loading and the forward pass.

Counterpart of blama_tpu/models/gpt2.py. GPT-2 117M at Q6_K is the original
blama's default and test model. Learned position embeddings, pre-LN blocks
with biases, a fused QKV product, an exact-GELU MLP, and a tied or separate
head. It runs no fused kernel, as in the reference: its products are dense
(quant_matmul.rows_mm: f32 sums, each row's bits its own) and its attention
is the two-pass chain without rope (ops/attention.py, rope_dim=0), on the
Instance's dense KV rows.

Weights are dense, as the reference loads them: bf16 under the bfloat16
engine and every packed engine's name, f32 under the rest
(runtime/model.py). Each tensor is dequantized on its device
(models/llama.tensor_values). The KV store is f32 or bf16. The reference
casts its float rows into whatever store it is given, so an INT8 store
would hold a bare cast there; the port's Instance refuses one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops.attention import attention
from ..ops.kernels import resolve_device
from ..ops.norms import layer_norm
from ..ops.quant_matmul import rows_mm
from .config import ModelConfig
from .llama import _place, gelu, tensor_values

_LAYER_TENSORS = {
    "attn_norm": "blk.{i}.attn_norm.weight",
    "attn_norm_b": "blk.{i}.attn_norm.bias",
    "wqkv": "blk.{i}.attn_qkv.weight",
    "bqkv": "blk.{i}.attn_qkv.bias",
    "wo": "blk.{i}.attn_output.weight",
    "bo": "blk.{i}.attn_output.bias",
    "ffn_norm": "blk.{i}.ffn_norm.weight",
    "ffn_norm_b": "blk.{i}.ffn_norm.bias",
    "w_up": "blk.{i}.ffn_up.weight",
    "b_up": "blk.{i}.ffn_up.bias",
    "w_down": "blk.{i}.ffn_down.weight",
    "b_down": "blk.{i}.ffn_down.bias",
}
_MATMULS = ("wqkv", "wo", "w_up", "w_down")


def load_gpt2_params(reader, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                     device="cuda", progress_cb=None) -> dict[str, Any]:
    """The reference's load_gpt2_params: every tensor in `dtype`, matmul
    weights transposed to (n_in, n_out). The head (output.weight, or the
    embedding's transpose when the file ties them) is kept as f32 of its
    `dtype`-rounded values: the reference casts it to f32 at every step,
    the port once."""
    device = resolve_device(device)

    def get_v(name: str) -> torch.Tensor:
        return tensor_values(reader, name, device).to(dtype)

    def get_t(name: str) -> torch.Tensor:
        return get_v(name).t().contiguous()

    n_total = cfg.n_layer + 2
    layers = []
    for i in range(cfg.n_layer):
        layers.append({key: (get_t if key in _MATMULS else get_v)(pat.format(i=i))
                       for key, pat in _LAYER_TENSORS.items()})
        if progress_cb:
            progress_cb((i + 1) / n_total)
    tok_emb = get_v("token_embd.weight")                                    # (V, E)
    head = get_t("output.weight") if "output.weight" in reader.tensors else tok_emb.t()
    return {
        "tok_emb": tok_emb,
        "pos_emb": get_v("position_embd.weight"),                           # (n_ctx, E)
        "out_norm": get_v("output_norm.weight"),
        "out_norm_b": get_v("output_norm.bias"),
        "layers": layers,
        "output": head.float().contiguous(),                                # (E, V) f32
    }


@dataclass(frozen=True)
class GPT2Static:
    """Static subset of ModelConfig the forward reads."""

    n_head: int
    head_dim: int
    ln_eps: float

    @classmethod
    def of(cls, cfg: ModelConfig) -> "GPT2Static":
        return cls(cfg.n_head, cfg.head_dim_, cfg.layer_norm_eps)

    def step(self, params, tokens, positions, slots, cache, logits_index=None):
        """forward under this config (every caller takes its static's step)."""
        return forward(params, self, tokens, positions, slots, cache, logits_index)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, K] @ w [K, N] in w's dtype with f32 sums (rows_mm)."""
    B, T, K = x.shape
    return rows_mm(x.reshape(B * T, K), w).reshape(B, T, -1)


@torch.no_grad()
def forward(params, st: GPT2Static, tokens, positions, slots, cache,
            logits_index=None) -> tuple[torch.Tensor, Any]:
    """One decode/prefill step on dense KV rows (the reference's gpt2
    forward, in its order of operations): returns (logits [B, V] f32,
    cache), the cache updated in place."""
    H, D, eps = st.n_head, st.head_dim, st.ln_eps
    B, T = tokens.shape
    x, q_pos, flat = _place(params, tokens, positions, slots, cache)
    x = x + params["pos_emb"][q_pos.long()]
    kv_pos = cache.positions
    for li, p in enumerate(params["layers"]):
        h = layer_norm(x, p["attn_norm"], p["attn_norm_b"], eps)
        qkv = _mm(h, p["wqkv"]) + p["bqkv"]
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.chunk(3, dim=-1))
        cache.write(li, flat, k, v)
        attn = attention(q, cache.k[li], cache.v[li], q_pos, kv_pos,
                         rope_dim=0, freq_base=10000.0, causal=True)
        x = x + _mm(attn.reshape(B, T, H * D), p["wo"]) + p["bo"]
        h2 = layer_norm(x, p["ffn_norm"], p["ffn_norm_b"], eps)
        up = gelu(_mm(h2, p["w_up"]) + p["b_up"])
        x = x + _mm(up, p["w_down"]) + p["b_down"]
    if logits_index is None:
        logits_index = torch.full((B,), T - 1, dtype=torch.long, device=x.device)
    last_h = x[torch.arange(B, device=x.device), logits_index.to(x.device).long()]
    last_h = layer_norm(last_h, params["out_norm"], params["out_norm_b"], eps)
    return rows_mm(last_h.float(), params["output"]), cache


def make_step_fn(cfg: ModelConfig):
    """Step function bound to the architecture's static config."""
    return GPT2Static.of(cfg).step
