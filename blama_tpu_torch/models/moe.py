"""Mixture-of-Experts (Mixtral-family) transformer on packed Q4_K expert banks.

Counterpart of blama_tpu/models/moe.py for its packed engines: `q4k_fused`
(exact, f32 scales) and `q4k_a8` (W4A8, bf16 scales). A Mixtral GGUF is the
llama architecture plus, per layer, a router (blk.N.ffn_gate_inp.weight) and
three 3-D expert banks (blk.N.ffn_{gate,up,down}_exps.weight). Routing is
top-k of the router logits, softmax-renormalized over the selected experts.

The expert FFN runs on the banks' packed bytes in place (ops/quant_matmul
bank_matmul: kernel J, the W4A8 GEMV over selected experts, for up to 16 rows
of a `q4k_a8` bank; kernel K, the exact dequant GEMM with the min term
inside, for the rest):

* routed (B·T == 1, a solo decode step): the k selected experts only, one
  bank launch per projection; the down bank gets one input row per expert.
* masked (B·T > 1, prompt chunks and every scheduler step): every expert over
  every row, one bank launch per projection over all Ne experts, the outputs
  weighted by the routing mixture (0 for an unrouted expert).

Both accumulate the experts' outputs into f32 zeros in ascending expert order
and K gives a row the same bits at any row count, so a token's logits are the
same whether it was decoded routed or replayed inside a padded chunk
(0·d = ±0 and y + ±0 == y): the fill_ctx verification contract.

Attention is always the two-pass chain (ops/attention.py) over the dense rows
or the scheduler's paged pool, with plain rope; the attention projections and
the lm head go through qmm (kernels A and B), or under tp_blocks through
qmm_nblocked / qmm_blocked (A, L and M) while the packed FFN stays as it is,
as in the reference. Not ported: the dense engines (moe_ffn,
moe_ffn_ragged), the fixed-topology dense mixture (_moe_ffn_tpb, which only
the dense engines reach) and the expert-sharded mesh (moe_param_specs); MoE
under the k4 / a8k4 / a8x engines; expert banks of another type than Q4_K
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops import paged_kv as pkv
from ..ops import quant_matmul as qm
from ..ops.attention import attention
from ..ops.kernels import resolve_device
from ..ops.kv_cache import SlotStore, dequantize_kv
from ..ops.norms import rms_norm
from ..ops.quant_matmul import QuantExperts, bank_matmul, qmm_blocked, qmm_nblocked, rows_mm
from ..ops.rope import apply_rope, rope_angles
from .config import ModelConfig
from .llama import (_bf16_rounded, _cols, _head, _place, _q4k_elements, _silu, _to_torch,
                    _weight_from_jax, cache_from_jax, paged_cache_from_jax)

__all__ = ["MoEStatic", "QuantExperts", "bank_matmul", "cache_from_jax", "forward",
           "load_moe_params", "make_step_fn", "moe_ffn_quant", "paged_cache_from_jax",
           "params_from_jax", "route"]

# fused_quant values the MoE loader serves (the reference packs expert banks
# for these two only): the exact engine and W4A8
MOE_FUSED = (True, "a8")

_ATTN_TENSORS = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output"}
_BANKS = ("w_gate_exps", "w_up_exps", "w_down_exps")


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------

def load_moe_params(reader, cfg: ModelConfig, fused_quant: bool | str = "a8",
                    device="cuda", progress_cb=None) -> dict[str, Any]:
    """Load a Mixtral-family GGUF for the packed engine `fused_quant` (True:
    exact, "a8": W4A8) onto `device`; the reference's _load_moe_fused.

    Per tensor, as the reference's MoE rule (not the llama loader's): a Q4_K
    attention projection or lm head is repacked for the engine, any other
    type becomes a dense bf16 (n_in, n_out) weight; the embedding is a dense
    bf16 table; the router a dense bf16 (E, Ne) weight; a Q4_K expert bank is
    repacked whole into a QuantExperts, and a bank of another type raises."""
    from ..gguf.constants import GGMLType

    device = resolve_device(device)
    if fused_quant not in MOE_FUSED:
        raise NotImplementedError(
            f"fused_quant={fused_quant!r}: MoE expert banks are served by the "
            "q4k_fused and q4k_a8 engines only (ROADMAP.md §1 item 9, other engines)")
    a8 = fused_quant == "a8"
    repack = qm.repack_q4k_a8s if a8 else qm.repack_q4k_exact

    def dense_t(name: str) -> torch.Tensor:
        w = torch.from_numpy(reader.tensor_float(name)).to(device).to(torch.bfloat16)
        return w.t().contiguous()                       # (n_in, n_out)

    def get_q(name: str):
        info = reader.tensors[name]
        if info.ggml_type != GGMLType.Q4_K:
            return dense_t(name)
        return repack(reader.tensor_bytes(name), info.ne[1], info.ne[0], device)

    def get_bank(name: str) -> QuantExperts:
        info = reader.tensors[name]
        if info.ggml_type != GGMLType.Q4_K:
            raise NotImplementedError(
                f"{name} is {info.ggml_type.name}: expert banks of another type than "
                "Q4_K are not ported (ROADMAP.md §1 item 10; the reference cannot "
                "serve them either)")
        K, N, Ne = info.ne            # ggml order: (n_in, out per expert, n_expert)
        return qm.repack_q4k_bank(reader.tensor_bytes(name), Ne, N, K, a8, device)

    n_total = cfg.n_layer + 2
    layers = []
    for i in range(cfg.n_layer):
        p: dict[str, Any] = {
            "attn_norm": _bf16_rounded(reader.tensor_float(f"blk.{i}.attn_norm.weight"), device),
            "ffn_norm": _bf16_rounded(reader.tensor_float(f"blk.{i}.ffn_norm.weight"), device),
            "router": dense_t(f"blk.{i}.ffn_gate_inp.weight"),
        }
        for key, stem in _ATTN_TENSORS.items():
            p[key] = get_q(f"blk.{i}.{stem}.weight")
        for key in _BANKS:
            p[key] = get_bank(f"blk.{i}.ffn_{key[2:-5]}_exps.weight")
        layers.append(p)
        if progress_cb:
            progress_cb((i + 1) / n_total)

    tok_emb = torch.from_numpy(reader.tensor_float("token_embd.weight")).to(device) \
        .to(torch.bfloat16)                             # (V, E), gathered
    output = (get_q("output.weight") if "output.weight" in reader.tensors
              else tok_emb.t().contiguous())
    return {"tok_emb": tok_emb,
            "out_norm": _bf16_rounded(reader.tensor_float("output_norm.weight"), device),
            "layers": layers, "output": output}


def _bank_from_jax(b, device) -> QuantExperts:
    """A reference QuantExperts with numpy leaves (codes [Ne, K/2, N_pad]
    paired (j, j+128), scales / mins [Ne, K/32, N_pad]) → the port's bank:
    each expert unpaired and its lane padding dropped, as for one tensor."""
    pack = qm.pack_a8s if b.a8 else qm.pack_exact
    parts = [pack(_to_torch(_q4k_elements(np.asarray(b.codes[e]), b.n_out), device),
                  _cols(b.scales[e], b.n_out, device).float(),
                  _cols(b.mins[e], b.n_out, device).float())
             for e in range(np.asarray(b.codes).shape[0])]
    return QuantExperts(*(torch.stack([getattr(w, f) for w in parts])
                          for f in ("codes", "scales", "mins")), a8=bool(b.a8))


def params_from_jax(tree: dict, device="cuda") -> dict[str, Any]:
    """Carry the JAX package's packed MoE parameter tree (leaves as numpy
    arrays: QuantExperts banks, QuantTensor / QuantTensorA8S or dense bf16
    projections and lm head, the dense bf16 embedding and router, the norms)
    over to the port's layouts."""
    device = resolve_device(device)
    tok_emb = _to_torch(tree["tok_emb"], device)
    layers = []
    for p in tree["layers"]:
        q = {k: _to_torch(p[k], device).float() for k in ("attn_norm", "ffn_norm")}
        q["router"] = _to_torch(p["router"], device)
        q.update({k: _weight_from_jax(p[k], device) for k in _ATTN_TENSORS})
        q.update({k: _bank_from_jax(p[k], device) for k in _BANKS})
        layers.append(q)
    return {"tok_emb": tok_emb, "out_norm": _to_torch(tree["out_norm"], device).float(),
            "layers": layers,
            "output": _weight_from_jax(tree["output"], device, tok_emb.shape[0])}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEStatic:
    """Static subset of ModelConfig the MoE forward reads."""

    n_head: int
    n_head_kv: int
    head_dim: int
    rope_dim: int
    freq_base: float
    rms_eps: float
    act_fn: str
    n_expert: int
    n_expert_used: int
    # fixed-topology blocks of the attention projections and the lm head
    # (tp_blocks mode, as LlamaStatic); the packed expert FFN does not read it
    tp_blocks: int = 0

    @classmethod
    def of(cls, cfg: ModelConfig) -> "MoEStatic":
        return cls(cfg.n_head, cfg.n_head_kv, cfg.head_dim_, cfg.rope_dim_,
                   cfg.rope_freq_base, cfg.rms_norm_eps, cfg.act_fn,
                   cfg.n_expert, cfg.n_expert_used, cfg.tp_blocks)

    def step(self, params, tokens, positions, slots, cache, logits_index=None):
        """forward under this config (every loop calls its static's step)."""
        return forward(params, self, tokens, positions, slots, cache, logits_index)


def route(h: torch.Tensor, router: torch.Tensor, k: int):
    """Router of rows h [R, E] → (gate weights f32 [R, k], expert ids [R, k]).

    The reference's arithmetic: an f32 dot snapped to the bf16 grid, so a
    row's choice does not hang on sub-ulp noise of the dot (rows_mm keeps it
    row-count invariant on the CPU too); top-k with ties broken toward the
    lower index as lax.top_k does (a stable descending sort: ties are likely
    on the bf16 grid and torch.topk makes no such promise on CUDA); then a
    softmax over the k values in f32."""
    logits = rows_mm(h.float(), router.float()).to(torch.bfloat16).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


def moe_ffn_quant(h: torch.Tensor, p: dict, st: MoEStatic) -> torch.Tensor:
    """Routed FFN over packed expert banks: h [B, T, E] → [B, T, E] in h's
    dtype. g and u are f32 bank outputs; silu(g)·u is taken in f32 and cast
    to h's dtype once; expert outputs are weighted and summed in f32 in
    ascending expert order (module docstring)."""
    B, T, E = h.shape
    R = B * T
    hf = h.reshape(R, E)
    gate_w, top_idx = route(hf, p["router"], st.n_expert_used)
    y = torch.zeros((R, E), dtype=torch.float32, device=h.device)

    if R == 1:
        # the k routed experts, ids ascending (the masked path's order)
        ids, order = torch.sort(top_idx[0])
        eids, gw = ids.to(torch.int32), gate_w[0][order]
        g = bank_matmul(hf, p["w_gate_exps"], eids)          # [k, 1, F]
        u = bank_matmul(hf, p["w_up_exps"], eids)
        mid = (_silu(g) * u).to(h.dtype)
        d = bank_matmul(mid, p["w_down_exps"], eids)         # [k, 1, E]: expert j, row j
        for j in range(st.n_expert_used):
            y = y + gw[j] * d[j]
        return y.reshape(B, T, E).to(h.dtype)

    # every expert over every row, one launch per bank; unrouted weights are 0
    eids = torch.arange(st.n_expert, dtype=torch.int32, device=h.device)
    g = bank_matmul(hf, p["w_gate_exps"], eids)              # [Ne, R, F]
    u = bank_matmul(hf, p["w_up_exps"], eids)
    mid = (_silu(g) * u).to(h.dtype)
    d = bank_matmul(mid, p["w_down_exps"], eids)             # [Ne, R, E]
    mix = torch.zeros((R, st.n_expert), dtype=torch.float32, device=h.device)
    mix.scatter_(1, top_idx, gate_w)
    for e in range(st.n_expert):
        y = y + mix[:, e:e + 1] * d[e]
    return y.reshape(B, T, E).to(h.dtype)


@torch.no_grad()
def forward(
    params: dict[str, Any],
    st: MoEStatic,
    tokens: torch.Tensor,      # [B, T] int32 (padded)
    positions: torch.Tensor,   # [B, T] int32 position of each token
    slots: torch.Tensor,       # [B, T] int32 cache slot; >= n_slots → dropped (pad)
    cache: SlotStore,
    logits_index: torch.Tensor | None = None,  # [B] index into T of the logit token
) -> tuple[torch.Tensor, SlotStore]:
    """One decode/prefill step, as models/llama.forward (the same cache
    contract: dense rows or the paged pool, updated in place, pads to the
    spare slot) with the two-pass attention chain at every T and the routed
    expert FFN. Returns (logits [B, V] f32, cache)."""
    H, Hkv, D = st.n_head, st.n_head_kv, st.head_dim
    rope_dim, freq_base, eps = st.rope_dim, st.freq_base, st.rms_eps
    if st.act_fn != "silu":
        raise NotImplementedError(f"act_fn={st.act_fn!r} (ROADMAP.md §1 item 12)")
    B, T = tokens.shape
    paged = isinstance(cache, pkv.PagedKVCache)
    x, positions, flat = _place(params, tokens, positions, slots, cache)
    pos_view = pkv.view_positions(cache) if paged else cache.positions
    q_rope = rope_angles(positions, rope_dim, freq_base)
    kv_rope = rope_angles(torch.clamp(pos_view, min=0), rope_dim, freq_base)

    tpb = st.tp_blocks
    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["attn_norm"], eps)
        q = qmm_nblocked(h, p["wq"], tpb).reshape(B, T, H, D)
        k = qmm_nblocked(h, p["wk"], tpb).reshape(B, T, Hkv, D)
        v = qmm_nblocked(h, p["wv"], tpb).reshape(B, T, Hkv, D)
        q = apply_rope(q, positions, rope_dim, freq_base, True, cos_sin=q_rope)
        cache.write(li, flat, k, v)
        k_l, v_l = cache.k[li], cache.v[li]
        ks_l = vs_l = None
        if cache.quantized:
            ks_l, vs_l = cache.k_scale[li], cache.v_scale[li]
        if paged:
            k_l, v_l, ks_l, vs_l = pkv.gather_view(cache, k_l, v_l, ks_l, vs_l)
        if ks_l is not None:      # INT8: the whole row dequantized, as the reference
            k_l = dequantize_kv(k_l, ks_l, x.dtype)
            v_l = dequantize_kv(v_l, vs_l, x.dtype)
        attn = attention(q, k_l, v_l, positions, pos_view, rope_dim=rope_dim,
                         freq_base=freq_base, kv_rope=kv_rope)
        x = x + qmm_blocked(attn.reshape(B, T, H * D), p["wo"], tpb)
        x = x + moe_ffn_quant(rms_norm(x, p["ffn_norm"], eps), p, st)

    return _head(params, x, logits_index, eps, tpb), cache


def make_step_fn(cfg: ModelConfig):
    """Step function bound to the MoE model's static config."""
    return MoEStatic.of(cfg).step
