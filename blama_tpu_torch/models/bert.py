"""BERT-family encoder (bge-small class models) for embeddings.

Counterpart of blama_tpu/models/bert.py: the reference serves embeddings
from a bge-small-en-v1.5 GGUF through InstanceEmbedding
(InstanceEmbedding.cpp; test golden t-integration.cpp:511-530). Tensor
names follow llama.cpp's bert arch: token, token-type and absolute position
embeddings with a post-embedding layer norm, post-norm encoder blocks with
biases, the exact GELU FFN and bidirectional attention over a key mask.

Every tensor is dequantized on the device and converted to the model's
dtype (f32 under `float32`, bf16 under `bfloat16` and the packed engines'
names, as the reference loads it). The projections are `rows_mm` products
(operands in the weight's dtype, f32 sums, the result in the activation
dtype, as the reference's dots). The attention is plain torch in f32 (the
scores, the softmax and the value product, as the reference's XLA einsums;
no Pallas kernel there, so none here): scaled_dot_product_attention would
pick its own algorithm and sum order per backend and shape, and its fused
kernels take bf16 operands; f32 products on the card refuse TF32
(require_ieee_f32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops.kernels import resolve_device
from ..ops.norms import layer_norm
from ..ops.quant_matmul import require_ieee_f32, rows_mm
from .config import ModelConfig
from .llama import gelu, tensor_values

POOLING_NONE = 0
POOLING_MEAN = 1
POOLING_CLS = 2
POOLING_LAST = 3

_LAYER_TENSORS = {
    "wq": ("blk.{i}.attn_q.weight", True),
    "bq": ("blk.{i}.attn_q.bias", False),
    "wk": ("blk.{i}.attn_k.weight", True),
    "bk": ("blk.{i}.attn_k.bias", False),
    "wv": ("blk.{i}.attn_v.weight", True),
    "bv": ("blk.{i}.attn_v.bias", False),
    "wo": ("blk.{i}.attn_output.weight", True),
    "bo": ("blk.{i}.attn_output.bias", False),
    "attn_out_norm": ("blk.{i}.attn_output_norm.weight", False),
    "attn_out_norm_b": ("blk.{i}.attn_output_norm.bias", False),
    "w_up": ("blk.{i}.ffn_up.weight", True),
    "b_up": ("blk.{i}.ffn_up.bias", False),
    "w_down": ("blk.{i}.ffn_down.weight", True),
    "b_down": ("blk.{i}.ffn_down.bias", False),
    "out_norm": ("blk.{i}.layer_output_norm.weight", False),
    "out_norm_b": ("blk.{i}.layer_output_norm.bias", False),
}


def load_bert_params(reader, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                     device="cuda", progress_cb=None) -> dict[str, Any]:
    """Every tensor `reader.tensor_float(...)` (dequantized on `device`) in
    `dtype`, matmul weights transposed to (n_in, n_out); one dict per layer."""
    device = resolve_device(device)

    def get(name: str, transpose: bool) -> torch.Tensor:
        t = tensor_values(reader, name, device).to(dtype)
        return t.t().contiguous() if transpose else t

    layers = []
    for i in range(cfg.n_layer):
        layers.append({key: get(pat.format(i=i), tr) for key, (pat, tr) in _LAYER_TENSORS.items()})
        if progress_cb:
            progress_cb((i + 1) / (cfg.n_layer + 1))
    return {
        "tok_emb": get("token_embd.weight", False),
        "type_emb": get("token_types.weight", False),
        "pos_emb": get("position_embd.weight", False),
        "emb_norm": get("token_embd_norm.weight", False),
        "emb_norm_b": get("token_embd_norm.bias", False),
        "layers": layers,
    }


@dataclass(frozen=True)
class BertStatic:
    n_head: int
    head_dim: int
    ln_eps: float

    @classmethod
    def of(cls, cfg: ModelConfig) -> "BertStatic":
        return cls(cfg.n_head, cfg.head_dim_, cfg.layer_norm_eps)


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, T, K] @ w + b in x's dtype: the product rounded, then the bias
    added (the reference's `x @ w + b`)."""
    B, T, K = x.shape
    return rows_mm(x.reshape(B * T, K), w).reshape(B, T, -1) + b


@torch.no_grad()
def bert_forward(st: BertStatic, params, tokens: torch.Tensor,
                 valid_mask: torch.Tensor) -> torch.Tensor:
    """tokens [B, T], valid_mask [B, T] bool → token embeddings [B, T, E] in
    the model's dtype. Padded keys are masked (a -1e30 bias); padded query
    rows are computed and left to the caller."""
    H, D = st.n_head, st.head_dim
    eps = st.ln_eps
    dev = params["tok_emb"].device
    tokens = tokens.to(dev).long()
    B, T = tokens.shape
    positions = torch.arange(T, device=dev)
    x = params["tok_emb"][tokens] + params["type_emb"][0] + params["pos_emb"][positions]
    x = layer_norm(x, params["emb_norm"], params["emb_norm_b"], eps)
    bias = torch.zeros((B, 1, 1, T), dtype=torch.float32, device=dev).masked_fill(
        ~valid_mask.to(dev)[:, None, None, :], -1e30)
    for p in params["layers"]:
        q = _proj(x, p["wq"], p["bq"]).reshape(B, T, H, D).float()
        k = _proj(x, p["wk"], p["bk"]).reshape(B, T, H, D).float()
        v = _proj(x, p["wv"], p["bv"]).reshape(B, T, H, D).float()
        require_ieee_f32(q)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / (D ** 0.5) + bias
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd", probs, v).to(x.dtype)
        x = x + rows_mm(attn.reshape(B * T, H * D), p["wo"]).reshape(B, T, -1) + p["bo"]
        x = layer_norm(x, p["attn_out_norm"], p["attn_out_norm_b"], eps)
        h = gelu(_proj(x, p["w_up"], p["b_up"]))
        x = x + rows_mm(h.reshape(B * T, -1), p["w_down"]).reshape(B, T, -1) + p["b_down"]
        x = layer_norm(x, p["out_norm"], p["out_norm_b"], eps)
    return x
